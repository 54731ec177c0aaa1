"""Inference CLI: ``python -m yolo_ms_tpu_torch.tools.test --config ...
--checkpoint ... --source ...``.

The CLI of ``yolo_ms_tpu/tools/test.py``: an annotated ``*_detected.jpg``
and a ``*_detections.json`` per input image, or, for a video file or a
webcam index, ``detected.mp4`` in the output directory. The checkpoint may
be a reference ``.pt`` (mapped on load), a flax-layout ``.npz``, a port
train checkpoint (its EMA model preferred) or an export of
``tools/export.py``. Inference runs on the card unless the config says
``device: "cpu"`` or ``device="cpu"`` is passed.
"""

from __future__ import annotations

import argparse
import os
import traceback

VIDEO_EXTENSIONS = (".mp4", ".avi", ".mov", ".mkv", ".webm")


def run(
    config_path: str,
    checkpoint_path: str,
    source_path: str,
    output_dir: str = "runs/detect/exp",
    conf_thresh: float = 0.25,
    iou_thresh_nms: float = 0.45,
    batch_size: int = 1,
    device=None,
):
    from yolo_ms_tpu_torch.infer.predictor import Predictor
    from yolo_ms_tpu_torch.utils.checkpoint import load_serving_state_dict
    from yolo_ms_tpu_torch.utils.config import load_config
    from yolo_ms_tpu_torch.utils.device import config_device

    cfg = load_config(config_path)
    predictor = Predictor(
        cfg.model.architecture,
        load_serving_state_dict(checkpoint_path),
        num_classes=cfg.dataset.num_classes,
        class_names=cfg.dataset.resolved_class_names(),
        input_size=tuple(cfg.model.input_size),
        conf_thresh=conf_thresh,
        iou_thresh=iou_thresh_nms,
        batch_size=batch_size,
        reg_max=cfg.model.reg_max,
        device=config_device(cfg, device),
    )
    # video / webcam source ('0' = webcam, coco_yolov8.yaml:71)
    if str(source_path).isdigit() or str(source_path).lower().endswith(VIDEO_EXTENSIONS):
        from yolo_ms_tpu_torch.infer.video import predict_video

        os.makedirs(output_dir, exist_ok=True)
        return predict_video(predictor, source_path, os.path.join(output_dir, "detected.mp4"))
    return predictor.predict_paths(source_path, output_dir)


def main(argv: list[str] | None = None) -> None:
    parser = argparse.ArgumentParser(description="Run detector inference on images.")
    parser.add_argument("--config", type=str, default="yolo_ms_tpu_torch/configs/coco_yolov8.yaml")
    parser.add_argument("--checkpoint", type=str, required=True)
    parser.add_argument("--source", type=str, required=True)
    parser.add_argument("--output_dir", type=str, default="runs/detect/exp")
    parser.add_argument("--conf_thresh", type=float, default=0.25)
    parser.add_argument("--iou_thresh_nms", type=float, default=0.45)
    parser.add_argument("--batch_size", type=int, default=1)
    args = parser.parse_args(argv)
    try:
        run(
            args.config,
            args.checkpoint,
            args.source,
            args.output_dir,
            args.conf_thresh,
            args.iou_thresh_nms,
            args.batch_size,
        )
    except FileNotFoundError as e:
        print(f"Error: {e}. Please check file paths.")
        raise SystemExit(1)
    except Exception:
        traceback.print_exc()
        raise SystemExit(1)


if __name__ == "__main__":
    main()
