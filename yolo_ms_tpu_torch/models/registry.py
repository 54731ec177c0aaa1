"""Model zoo registry — build any supported detector by name.

Port of ``yolo_ms_tpu/models/registry.py``: the same 20 names.
``build_model`` returns the module in eval mode on the requested device
(the card unless ``device="cpu"``), in train structure or, with
``deploy=True``, in BN-folded deploy structure. ``init_model`` draws fresh
weights as flax's initializers do, for training from scratch.
"""

from __future__ import annotations

import math
from typing import Any

import torch
from torch import nn

from yolo_ms_tpu_torch.models.deploy import to_deploy_structure
from yolo_ms_tpu_torch.models.ms import YOLOMS, YOLOv8MS
from yolo_ms_tpu_torch.models.yolo import YOLOv8, _HeadBranch
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


# flax's variance_scaling truncated-normal correction: the std of a unit
# normal truncated to [-2, 2]
_TRUNC_STD = 0.87962566103423978


@torch.no_grad()
def init_model(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Fresh weights drawn as the JAX package's flax init draws them:

    - conv kernels: ``lecun_normal``, a normal truncated at 2 sigma with
      sigma = 1/sqrt(fan_in)/0.8796 so the draw has std 1/sqrt(fan_in);
      fan_in = (in_channels / groups) * kh * kw, so a depthwise [k, k, 1, C]
      kernel has fan_in k*k;
    - conv biases: zeros, except the head's ``pred`` convs, which start at
      their detection prior (box 1.0, cls log(5/nc/cells));
    - BatchNorm: scale 1, bias 0, running mean 0, running var 1.

    The draws come from ``generator`` (on the parameters' device), in
    module order; they are not flax's PRNG stream. Returns ``model``.
    """
    for mod in model.modules():
        if isinstance(mod, nn.Conv2d):
            w = mod.weight
            fan_in = w.shape[1] * w.shape[2] * w.shape[3]
            std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
            nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std, generator=generator)
            if mod.bias is not None:
                mod.bias.zero_()
        elif isinstance(mod, nn.BatchNorm2d):
            mod.reset_parameters()
    for mod in model.modules():
        if isinstance(mod, _HeadBranch):
            mod.pred.bias.fill_(mod.bias_prior)
    return model
