"""Standalone validation CLI: ``python -m yolo_ms_tpu_torch.tools.val``.

The CLI of ``yolo_ms_tpu/tools/val.py``: a checkpoint's mAP on the config's
validation set without a ``Trainer``. Any checkpoint flavour works: a port
train checkpoint (its EMA model preferred), a BN-folded export, a
flax-layout ``.npz`` or a reference ``.pt``.

The loop is ``Trainer.validate``'s: uint8 batches of
``DetectionLoader(is_train=False, drop_last=False)`` -> ``Predictor``
(normalize, BN-folded forward, the fused post-process with one ``select``
launch per batch) -> COCO-protocol mAP on the host over the ``num_valid``
rows of each batch. ``evaluation.map_iou_thresholds = "coco"`` reports
AP@[.50:.05:.95] too. It runs on the card unless the config says
``device: "cpu"`` or ``device="cpu"`` is passed.
"""

from __future__ import annotations

import argparse
import time

from yolo_ms_tpu_torch.data.coco import CocoDetectionDataset
from yolo_ms_tpu_torch.data.loader import DetectionLoader
from yolo_ms_tpu_torch.eval.coco_map import (
    MeanAveragePrecision,
    map_iou_thresholds,
    update_from_batch,
)
from yolo_ms_tpu_torch.infer.predictor import Predictor
from yolo_ms_tpu_torch.utils.checkpoint import load_serving_state_dict
from yolo_ms_tpu_torch.utils.config import load_config
from yolo_ms_tpu_torch.utils.device import config_device


def run(config_path: str, checkpoint_path: str, verbose: bool = True, device=None) -> dict:
    """The metric's result dict (``map``, ``map_50``, ...), plus
    ``images``, ``detections`` and ``batch_ms`` (host ms of each
    ``predict_batch`` call, the copy back of the detections included)."""
    cfg = load_config(config_path)
    dcfg, ecfg = cfg.dataset, cfg.evaluation
    if not dcfg.val_annotations_path:
        raise ValueError("config has no validation dataset")

    img_size = tuple(ecfg.img_size or cfg.model.input_size)
    predictor = Predictor(
        cfg.model.architecture,
        load_serving_state_dict(checkpoint_path),
        num_classes=dcfg.num_classes,
        class_names=dcfg.resolved_class_names(),
        input_size=img_size,
        conf_thresh=ecfg.confidence_threshold,
        iou_thresh=ecfg.iou_threshold,
        batch_size=ecfg.batch_size,
        reg_max=cfg.model.reg_max,
        device=config_device(cfg, device),
    )
    ds = CocoDetectionDataset(
        dcfg.val_images_path,
        dcfg.val_annotations_path,
        num_classes=dcfg.num_classes,
        verbose=verbose,
    )
    loader = DetectionLoader(
        ds,
        batch_size=ecfg.batch_size,
        img_size=img_size,
        max_gt=dcfg.max_gt,
        is_train=False,
        seed=0,
        num_workers=cfg.workers,
        drop_last=False,
        device_normalize=True,
    )

    thresholds = map_iou_thresholds(ecfg.map_iou_thresholds)
    metric = MeanAveragePrecision(iou_thresholds=thresholds)
    n_images = n_dets = 0
    batch_ms = []
    for batch in loader.epoch(0):
        t0 = time.perf_counter()
        out = predictor.predict_batch(batch["images"])
        batch_ms.append((time.perf_counter() - t0) * 1e3)
        n_dets += update_from_batch(metric, out, batch, img_size)
        n_images += batch["num_valid"]

    result = metric.compute()
    map50 = result.get("map_50", result["map"])
    if verbose:
        extra = f", AP@[.5:.95] = {result['map']:.4f}" if len(thresholds) > 1 else ""
        print(f"Validation: {n_images} images, {n_dets} detections, "
              f"mAP@0.5 = {map50:.4f}{extra}")
    return {**result, "images": n_images, "detections": n_dets, "batch_ms": batch_ms}


def main(argv: list[str] | None = None) -> None:
    p = argparse.ArgumentParser(
        description="Evaluate a checkpoint's mAP on the config's val dataset"
    )
    p.add_argument("--config", required=True)
    p.add_argument("--checkpoint", required=True,
                   help=".ckpt (train checkpoint or export), .npz or reference .pt")
    args = p.parse_args(argv)
    run(args.config, args.checkpoint)


if __name__ == "__main__":
    main()
