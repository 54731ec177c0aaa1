"""Inference pipeline: preprocess -> forward + fused post-process -> outputs.

Port of ``yolo_ms_tpu/infer/predictor.py``. One call covers normalize ->
BN-folded forward (split head) -> ``fused_postprocess`` (the CUDA select
kernel, top-K, decode, NMS) on the device; only the fixed-size [max_det]
detection tensors come back to the host. Host work is the JAX package's:
plain resize (or letterbox), box rescale to the original image, drawing and
per-image JSON with the reference record schema.

``Predictor`` takes NHWC uint8 batches, as the JAX one does. With
``entry_layouts="auto"`` (the default, as in JAX) the network runs
channels-last on the card (``infer/layouts.py``), so the batch enters it
without a relayout; with ``"default"``, and on the CPU, it runs contiguous
NCHW. It runs on the card unless ``device="cpu"`` is passed.
``predict_paths`` overlaps the host's decode and write with the device's
batch, as the JAX package's does.
"""

from __future__ import annotations

import contextlib
import glob
import json
import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from yolo_ms_tpu_torch.data.augment import letterbox
from yolo_ms_tpu_torch.data.decode import decode_and_resize, decode_image
from yolo_ms_tpu_torch.infer.layouts import AutoLayoutInfer, check_entry_layouts
from yolo_ms_tpu_torch.infer.program import ServingProgram
from yolo_ms_tpu_torch.models.deploy import fold_batchnorm, is_deploy_variables
from yolo_ms_tpu_torch.models.registry import build_model
from yolo_ms_tpu_torch.utils.device import full_f32, resolve_device
from yolo_ms_tpu_torch.utils.profiler import span

IMAGE_EXTENSIONS = (".jpg", ".jpeg", ".png", ".bmp", ".tif", ".tiff")


class Predictor:
    """Serve a zoo model from a port state_dict (``utils/convert.py`` turns
    flax variables or a golden ``weights.npz`` into one).

    ``deploy`` (the JAX semantics): a folded state_dict is served as it
    is; a train-structure one is folded (``deploy=True``) or served
    unfolded, BatchNorm in eval mode (``deploy=False``). ``self.deploy``
    says which structure serves.

    ``entry_layouts``: ``"auto"`` serves through ``AutoLayoutInfer``
    (channels-last on the card, the default layout elsewhere);
    ``"default"`` serves the contiguous NCHW layout everywhere.

    f32 serving pins full-f32 convs and matmuls (no TF32); bf16 serving
    runs in bf16.
    """

    def __init__(
        self,
        architecture: str,
        state_dict: dict,
        num_classes: int,
        class_names: list[str] | None = None,
        input_size: tuple[int, int] = (640, 640),
        conf_thresh: float = 0.25,
        iou_thresh: float = 0.45,
        max_det: int = 300,
        batch_size: int = 1,
        reg_max: int = 16,
        letterbox: bool = False,
        dtype: torch.dtype = torch.float32,
        pre_nms_topk: int = 1024,
        deploy: bool = True,
        entry_layouts: str = "auto",
        device=None,
    ):
        check_entry_layouts(entry_layouts)
        self.device = resolve_device(device)
        folded = is_deploy_variables(state_dict)
        self.deploy = folded or deploy
        if self.deploy and not folded:
            state_dict = fold_batchnorm(state_dict)
        self.model = build_model(
            architecture,
            num_classes=num_classes,
            reg_max=reg_max,
            dtype=dtype,
            device=self.device,
            deploy=self.deploy,
        )
        self.model.load_state_dict(state_dict, strict=True)
        self.dtype = dtype
        self.num_classes = num_classes
        self.class_names = class_names or [f"class_{i}" for i in range(num_classes)]
        self.input_size = tuple(input_size)
        self.conf_thresh = conf_thresh
        self.iou_thresh = iou_thresh
        self.max_det = max_det
        self.batch_size = batch_size
        self.reg_max = reg_max
        self.letterbox = letterbox
        self.entry_layouts = entry_layouts
        self.pre_nms_topk = pre_nms_topk
        self.serve = ServingProgram(
            self.model,
            num_classes,
            reg_max,
            conf_thresh=conf_thresh,
            iou_thresh=iou_thresh,
            max_det=max_det,
            pre_nms_topk=pre_nms_topk,
            dtype=dtype,
        )
        self._infer = AutoLayoutInfer(self.serve) if entry_layouts == "auto" else self.serve

    def infer(self, images_u8: torch.Tensor) -> dict:
        """[B, H, W, 3] uint8 on the predictor's device -> post-process dict
        of device tensors (``ServingProgram``, the function that
        ``tools.export --program`` exports, in the entry layout). Normalization
        runs on the device, so only uint8 pixels cross from the host."""
        precision = full_f32() if self.dtype == torch.float32 else contextlib.nullcontext()
        with span("serve/infer"), torch.inference_mode(), precision:
            return self._infer(images_u8)

    def predict_batch(self, images_u8: np.ndarray) -> dict:
        """images_u8: [B, H, W, 3] uint8 at input_size. Returns host numpy.
        The spans ``serve/upload``, ``serve/infer`` and ``serve/download``
        (``utils/profiler.py``) nest in ``serve/predict_batch``."""
        with span("serve/predict_batch", images=len(images_u8)):
            with span("serve/upload", bytes=images_u8.nbytes):
                x = torch.from_numpy(np.ascontiguousarray(images_u8)).to(self.device)
            out = self.infer(x)
            with span("serve/download", bytes=sum(v.nbytes for v in out.values())):
                return {k: v.cpu().numpy() for k, v in out.items()}

    def _preprocess(self, image_rgb: np.ndarray):
        """Original-size RGB -> (model-input uint8, unmap meta): plain
        resize (the reference's semantics) or, with ``letterbox=True``,
        aspect-preserving resize + gray padding."""
        import cv2

        oh, ow = image_rgb.shape[:2]
        ih, iw = self.input_size
        if self.letterbox:
            canvas, _, r, (px, py) = letterbox(
                image_rgb, np.zeros((0, 4), np.float32), ih, iw
            )
            return canvas, (1.0 / r, 1.0 / r, px, py, ow, oh)
        resized = cv2.resize(image_rgb, (iw, ih), interpolation=cv2.INTER_LINEAR)
        return resized, (ow / iw, oh / ih, 0, 0, ow, oh)

    def predict_image(self, image_rgb: np.ndarray):
        """One original-size RGB image -> list of detection dicts (boxes in
        original pixels, reference JSON schema)."""
        inp, meta = self._preprocess(image_rgb)
        out = self.predict_batch(inp[None])
        return self._to_detections(out, 0, meta)

    def _to_detections(self, out, i: int, meta):
        sx, sy, px, py, ow, oh = meta
        dets = []
        for j in np.nonzero(out["valid"][i])[0]:
            x1, y1, x2, y2 = out["boxes"][i, j]
            cid = int(out["classes"][i, j])
            bx = [
                float(np.clip((x1 - px) * sx, 0, ow)),
                float(np.clip((y1 - py) * sy, 0, oh)),
                float(np.clip((x2 - px) * sx, 0, ow)),
                float(np.clip((y2 - py) * sy, 0, oh)),
            ]
            dets.append(
                {
                    "box_xyxy": [round(c, 2) for c in bx],
                    "score": round(float(out["scores"][i, j]), 4),
                    "class_id": cid,
                    "class_name": self.class_names[cid]
                    if cid < len(self.class_names)
                    else f"class_{cid}",
                }
            )
        return dets

    def export_coco_json(self, results: dict, path: str,
                         label2cat: dict | None = None) -> None:
        """Write detections in COCO results format (image_id is the file
        stem, as an int when it is all digits)."""
        records = []
        for img_path, dets in results.items():
            stem = os.path.splitext(os.path.basename(img_path))[0]
            image_id = int(stem) if stem.isdigit() else stem
            for d in dets:
                x1, y1, x2, y2 = d["box_xyxy"]
                cid = d["class_id"]
                records.append(
                    {
                        "image_id": image_id,
                        "category_id": label2cat.get(cid, cid) if label2cat else cid,
                        "bbox": [x1, y1, round(x2 - x1, 2), round(y2 - y1, 2)],
                        "score": d["score"],
                    }
                )
        with open(path, "w") as f:
            json.dump(records, f)

    def predict_paths(self, source_path: str, output_dir: str | None = None,
                      save_images: bool = True, save_json: bool = True,
                      verbose: bool = True):
        """File or directory -> {image_path: [detections]}, in fixed-size
        batches; with ``output_dir``, a drawn JPEG and a JSON per image.

        Pipelined, as the JAX predictor is: batch i runs on the main thread
        while a decode thread fills batch i+1 into the other of two host
        buffers (pinned on the card, where it also queues the copy to the
        card on a side stream, which the compute stream waits for) and a
        writer thread converts, draws and writes batch i-1. An exception in
        either thread is raised here. ``_predict_paths_sequential`` is the
        plain version: the same steps one after another, with the same
        results and the same files.
        """
        chunks, results = self._chunks(source_path, output_dir), {}
        bs, (ih, iw) = self.batch_size, self.input_size
        on_card = self.device.type == "cuda"
        buffers = [torch.zeros((bs, ih, iw, 3), dtype=torch.uint8, pin_memory=on_card)
                   for _ in range(2)]
        copy_stream = torch.cuda.Stream(self.device) if on_card else None

        def load(i):
            # buffer i % 2 was last read by batch i - 2, whose results the
            # main thread has already taken
            buf = buffers[i % 2]
            metas = self._decode_batch(chunks[i], buf.numpy())
            if not on_card:
                return buf, None, metas
            with torch.cuda.stream(copy_stream):
                x = buf.to(self.device, non_blocking=True)
            return x, copy_stream.record_event(), metas

        def write(out, metas):
            self._write_batch(results, out, metas, output_dir, save_images, save_json, verbose)

        with ThreadPoolExecutor(1, "predict-decode") as decoder, \
                ThreadPoolExecutor(1, "predict-write") as writer:
            loading = decoder.submit(load, 0)  # find_images found at least one
            writing = None
            for i in range(len(chunks)):
                x, copied, metas = loading.result()
                if i + 1 < len(chunks):
                    loading = decoder.submit(load, i + 1)
                if copied is not None:
                    compute = torch.cuda.current_stream(self.device)
                    compute.wait_event(copied)
                    x.record_stream(compute)
                out = {k: v.cpu().numpy() for k, v in self.infer(x).items()}
                if writing is not None:
                    writing.result()
                writing = writer.submit(write, out, metas)
            writing.result()
        return results

    def _predict_paths_sequential(self, source_path: str, output_dir: str | None = None,
                                  save_images: bool = True, save_json: bool = True,
                                  verbose: bool = True):
        """The plain version of ``predict_paths``: decode, serve and write
        each batch in turn on this thread."""
        results = {}
        for chunk in self._chunks(source_path, output_dir):
            batch = np.zeros((self.batch_size, *self.input_size, 3), np.uint8)
            metas = self._decode_batch(chunk, batch)
            self._write_batch(results, self.predict_batch(batch), metas, output_dir,
                              save_images, save_json, verbose)
        return results

    def _chunks(self, source_path: str, output_dir: str | None) -> list:
        """The image paths under ``source_path`` in batches of
        ``batch_size``; makes ``output_dir``."""
        paths = find_images(source_path)
        if output_dir:
            os.makedirs(output_dir, exist_ok=True)
        bs = self.batch_size
        return [paths[s : s + bs] for s in range(0, len(paths), bs)]

    def _write_batch(self, results, out, metas, output_dir, save_images, save_json,
                     verbose) -> None:
        """One batch's host outputs -> ``results`` and, with ``output_dir``,
        the drawn JPEG and the JSON of each image."""
        for k, (p, orig, meta) in enumerate(metas):
            dets = self._to_detections(out, k, meta)
            results[p] = dets
            if verbose:
                print(f"{p}: {len(dets)} detections")
            if output_dir:
                self._write_outputs(output_dir, p, orig, dets, save_images, save_json)

    def _decode_batch(self, chunk: list, batch: np.ndarray) -> list:
        """Decode and resize ``chunk``'s images into the rows of ``batch``
        (the rows after them zeroed); returns (path, original, unmap meta)
        per image."""
        ih, iw = self.input_size
        metas = []
        for k, p in enumerate(chunk):
            orig = decode_image(p)
            if self.letterbox:
                inp, meta = self._preprocess(orig)
            else:
                inp = decode_and_resize(p, ih, iw)
                oh, ow = orig.shape[:2]
                meta = (ow / iw, oh / ih, 0, 0, ow, oh)
            batch[k] = inp
            metas.append((p, orig, meta))
        batch[len(chunk):] = 0
        return metas

    @staticmethod
    def _write_outputs(output_dir, path, orig, dets, save_images, save_json):
        base = os.path.splitext(os.path.basename(path))[0]
        if save_images:
            import cv2

            cv2.imwrite(
                os.path.join(output_dir, f"{base}_detected.jpg"),
                cv2.cvtColor(draw_detections(orig, dets), cv2.COLOR_RGB2BGR),
            )
        if save_json:
            with open(os.path.join(output_dir, f"{base}_detections.json"), "w") as f:
                json.dump(dets, f, indent=4)


def find_images(source_path: str) -> list[str]:
    """File or directory -> sorted image paths."""
    if os.path.isdir(source_path):
        paths = []
        for ext in IMAGE_EXTENSIONS:
            paths.extend(glob.glob(os.path.join(source_path, f"*{ext}")))
            paths.extend(glob.glob(os.path.join(source_path, f"*{ext.upper()}")))
        if not paths:
            raise FileNotFoundError(f"No images found in directory: {source_path}")
        return sorted(set(paths))
    if os.path.isfile(source_path):
        return [source_path]
    raise FileNotFoundError(
        f"Source path not found or not a file/directory: {source_path}"
    )


def draw_detections(
    image_rgb: np.ndarray, detections: list[dict], conf_thresh: float = 0.0
) -> np.ndarray:
    """Green boxes + filled label tags on a copy of an RGB image; detections
    scored below ``conf_thresh`` are not drawn."""
    import cv2

    img = image_rgb.copy()
    for det in detections:
        if det["score"] < conf_thresh:
            continue
        x1, y1, x2, y2 = map(int, det["box_xyxy"])
        label = f"{det['class_name']}: {det['score']:.2f}"
        cv2.rectangle(img, (x1, y1), (x2, y2), (0, 255, 0), 2)
        (lw, lh), baseline = cv2.getTextSize(label, cv2.FONT_HERSHEY_SIMPLEX, 0.5, 1)
        cv2.rectangle(img, (x1, y1 - lh - baseline), (x1 + lw, y1), (0, 255, 0), -1)
        cv2.putText(
            img, label, (x1, y1 - baseline), cv2.FONT_HERSHEY_SIMPLEX, 0.5, (0, 0, 0), 1
        )
    return img
