"""Model zoo registry — build any supported detector by name.

Port of ``yolo_ms_tpu/models/registry.py``: the same 20 names.
``build_model`` returns the module in eval mode on the requested device
(the card unless ``device="cpu"``), in train structure or, with
``deploy=True``, in BN-folded deploy structure.
"""

from __future__ import annotations

from typing import Any

import torch
from torch import nn

from yolo_ms_tpu_torch.models.deploy import to_deploy_structure
from yolo_ms_tpu_torch.models.ms import YOLOMS, YOLOv8MS
from yolo_ms_tpu_torch.models.yolo import YOLOv8
from yolo_ms_tpu_torch.utils.device import resolve_device

# name -> (builder class, version arg, extra constructor kwargs)
MODEL_ZOO: dict[str, tuple[Any, str, dict]] = {
    "n": (YOLOv8, "n", {}),
    "s": (YOLOv8, "s", {}),
    "m": (YOLOv8, "m", {}),
    "l": (YOLOv8, "l", {}),
    "x": (YOLOv8, "x", {}),
    "yolov8-n": (YOLOv8, "n", {}),
    "yolov8-s": (YOLOv8, "s", {}),
    "yolov8-m": (YOLOv8, "m", {}),
    "yolov8-l": (YOLOv8, "l", {}),
    "yolov8-x": (YOLOv8, "x", {}),
    "yolo-ms-xs": (YOLOMS, "xs", {}),
    "yolo-ms-s": (YOLOMS, "s", {}),
    "yolo-ms": (YOLOMS, "m", {}),
    "yolo-ms-m": (YOLOMS, "m", {}),
    "yolo-ms-xs-se": (YOLOMS, "xs", {"use_se": True}),
    "yolo-ms-s-se": (YOLOMS, "s", {"use_se": True}),
    "yolo-ms-m-se": (YOLOMS, "m", {"use_se": True}),
    "yolov8-ms-n": (YOLOv8MS, "n", {}),
    "yolov8-ms-s": (YOLOv8MS, "s", {}),
    "yolov8-ms-m": (YOLOv8MS, "m", {}),
}


def build_model(
    architecture: str,
    num_classes: int = 80,
    reg_max: int = 16,
    dtype: torch.dtype = torch.float32,
    device=None,
    deploy: bool = False,
) -> nn.Module:
    """Instantiate a model by zoo name (case-insensitive), in eval mode."""
    key = architecture.lower()
    if key not in MODEL_ZOO:
        raise ValueError(
            f"Unknown architecture '{architecture}'. Available: {sorted(MODEL_ZOO)}"
        )
    dev = resolve_device(device)
    cls, version, kwargs = MODEL_ZOO[key]
    model = cls(version, num_classes=num_classes, reg_max=reg_max, **kwargs)
    if deploy:
        to_deploy_structure(model)
    return model.to(device=dev, dtype=dtype).eval()


def count_params(model: nn.Module) -> int:
    """Total trainable parameter count (BN running stats excluded)."""
    return sum(p.numel() for p in model.parameters())
