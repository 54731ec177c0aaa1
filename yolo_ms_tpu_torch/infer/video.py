"""Video / webcam streaming inference.

Port of ``yolo_ms_tpu/infer/video.py``: frames are resized to the
predictor's input size and served ``batch_size`` per ``predict_batch`` call
(normalize -> forward -> the fused post-process with its one ``select``
launch), the last batch ragged; each frame's detections come back in
original-frame pixels, and an annotated mp4v video is written when an
output path is given. A writer that cannot open raises.
"""

from __future__ import annotations

import numpy as np

from yolo_ms_tpu_torch.infer.predictor import Predictor, draw_detections


def predict_video(
    predictor: Predictor,
    source: str | int,
    output_path: str | None = None,
    max_frames: int | None = None,
    verbose: bool = True,
):
    """Run detection over a video file or webcam index.

    Returns a list of per-frame detection lists (reference JSON schema).
    """
    import cv2

    cap = cv2.VideoCapture(int(source) if str(source).isdigit() else source)
    if not cap.isOpened():
        raise FileNotFoundError(f"Cannot open video source: {source}")
    fps = cap.get(cv2.CAP_PROP_FPS) or 30.0
    writer = None

    ih, iw = predictor.input_size
    bs = predictor.batch_size
    all_dets: list[list[dict]] = []
    frames_rgb: list[np.ndarray] = []
    batch = np.zeros((bs, ih, iw, 3), np.uint8)

    def flush(n):
        nonlocal writer
        if n == 0:
            return
        out = predictor.predict_batch(batch[:n])
        for i in range(n):
            orig = frames_rgb[i]
            oh2, ow2 = orig.shape[:2]
            meta = (ow2 / iw, oh2 / ih, 0, 0, ow2, oh2)
            dets = predictor._to_detections(out, i, meta)
            all_dets.append(dets)
            if output_path:
                drawn = draw_detections(orig, dets)
                if writer is None:
                    writer = cv2.VideoWriter(
                        output_path,
                        cv2.VideoWriter_fourcc(*"mp4v"),
                        fps,
                        (orig.shape[1], orig.shape[0]),
                    )
                    if not writer.isOpened():
                        raise RuntimeError(f"cannot write an mp4v video to {output_path}")
                writer.write(cv2.cvtColor(drawn, cv2.COLOR_RGB2BGR))
        frames_rgb.clear()

    n_in_batch = 0
    total = 0
    try:
        while True:
            ok, frame_bgr = cap.read()
            if not ok or (max_frames is not None and total >= max_frames):
                break
            rgb = cv2.cvtColor(frame_bgr, cv2.COLOR_BGR2RGB)
            frames_rgb.append(rgb)
            batch[n_in_batch] = cv2.resize(rgb, (iw, ih), interpolation=cv2.INTER_LINEAR)
            n_in_batch += 1
            total += 1
            if n_in_batch == bs:
                flush(n_in_batch)
                n_in_batch = 0
        flush(n_in_batch)
    finally:
        cap.release()
        if writer is not None:
            writer.release()
    if verbose:
        print(f"Processed {total} frames from {source}"
              + (f" -> {output_path}" if output_path else ""))
    return all_dets
