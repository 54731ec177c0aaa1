"""YOLOv8 family — backbone / PAFPN neck / decoupled anchor-free head.

Port of ``yolo_ms_tpu/models/yolo.py``, NCHW inside. The head returns the
three raw per-scale maps ([B, 4*reg_max+nc, H, W], or (box, cls) pairs with
``split_head=True``); decode is ``models/decode.py`` and the serving tail
``ops/postprocess.py``, both of which take NHWC views of these maps.

The JAX neck's deploy-only ``up_cat`` split form (upsampled rows contracted
at the small resolution) is plain upsample + concat here.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
from torch import nn

from yolo_ms_tpu_torch.models.decode import DEFAULT_STRIDES
from yolo_ms_tpu_torch.nn.blocks import (
    C2f,
    SPPF,
    ConvBnSiLU,
    upsample2x,
    yolo_params,
)


def _widths(width: float, ratio: float) -> tuple[int, int, int, int, int]:
    """(c64, c128, c256, c512, c512r) of the v8 channel schedule."""
    return (
        int(64 * width),
        int(128 * width),
        int(256 * width),
        int(512 * width),
        int(512 * width * ratio),
    )


class Backbone(nn.Module):
    """5 stride-2 convs + 4 C2f + SPPF; returns (P3, P4, P5)."""

    def __init__(self, version: str):
        super().__init__()
        depth, width, ratio = yolo_params(version)
        c64, c128, c256, c512, c512r = _widths(width, ratio)
        d3, d6 = int(3 * depth), int(6 * depth)
        self.out_channels = (c256, c512, c512r)
        self.conv0 = ConvBnSiLU(3, c64, 3, 2)
        self.conv1 = ConvBnSiLU(c64, c128, 3, 2)
        self.c2f_2 = C2f(c128, c128, d3, shortcut=True)
        self.conv3 = ConvBnSiLU(c128, c256, 3, 2)
        self.c2f_4 = C2f(c256, c256, d6, shortcut=True)
        self.conv5 = ConvBnSiLU(c256, c512, 3, 2)
        self.c2f_6 = C2f(c512, c512, d6, shortcut=True)
        self.conv7 = ConvBnSiLU(c512, c512r, 3, 2)
        self.c2f_8 = C2f(c512r, c512r, d3, shortcut=True)
        self.sppf = SPPF(c512r, c512r, 5)

    def forward(self, x):
        x = self.c2f_2(self.conv1(self.conv0(x)))
        out1 = self.c2f_4(self.conv3(x))
        out2 = self.c2f_6(self.conv5(out1))
        x = self.c2f_8(self.conv7(out2))
        return out1, out2, self.sppf(x)


class Neck(nn.Module):
    """PAFPN: top-down FPN + bottom-up PAN."""

    def __init__(self, version: str):
        super().__init__()
        depth, width, ratio = yolo_params(version)
        _, _, c256, c512, c512r = _widths(width, ratio)
        d3 = int(3 * depth)
        self.out_channels = (c256, c512, c512r)
        self.c2f_1 = C2f(c512r + c512, c512, d3, shortcut=False)
        self.c2f_2 = C2f(c512 + c256, c256, d3, shortcut=False)
        self.conv1 = ConvBnSiLU(c256, c256, 3, 2)
        self.c2f_3 = C2f(c256 + c512, c512, d3, shortcut=False)
        self.conv2 = ConvBnSiLU(c512, c512, 3, 2)
        self.c2f_4 = C2f(c512 + c512r, c512r, d3, shortcut=False)

    def forward(self, p3, p4, p5):
        res_1 = p5
        res_2 = self.c2f_1(torch.cat([upsample2x(p5), p4], dim=1))
        out1 = self.c2f_2(torch.cat([upsample2x(res_2), p3], dim=1))
        out2 = self.c2f_3(torch.cat([self.conv1(out1), res_2], dim=1))
        out3 = self.c2f_4(torch.cat([self.conv2(out2), res_1], dim=1))
        return out1, out2, out3


class _HeadBranch(nn.Module):
    """ConvBnSiLU 3x3 -> ConvBnSiLU 3x3 -> 1x1 conv with bias ``pred``,
    whose bias starts at the detection prior."""

    def __init__(self, c_in: int, mid: int, out: int, bias_prior: float = 0.0):
        super().__init__()
        self.conv1 = ConvBnSiLU(c_in, mid, 3)
        self.conv2 = ConvBnSiLU(mid, mid, 3)
        self.pred = nn.Conv2d(mid, out, 1)
        self.bias_prior = bias_prior
        nn.init.constant_(self.pred.bias, bias_prior)

    def forward(self, x):
        return self.pred(self.conv2(self.conv1(x)))


class DetectHead(nn.Module):
    """Decoupled anchor-free head: per scale a box branch to 4*reg_max
    channels and a class branch to nc channels. Its widths follow the
    input features (the JAX head's ``version`` field is unused there)."""

    def __init__(self, in_channels: Sequence[int], num_classes: int = 80,
                 reg_max: int = 16):
        super().__init__()
        self.num_classes = num_classes
        self.reg_max = reg_max
        coords = 4 * reg_max
        for i, c in enumerate(in_channels):
            # box distributions start near bin 1; class logits at ~5
            # objects per image over the level's grid cells at 640 px
            cls_prior = math.log(5 / num_classes / (640 / DEFAULT_STRIDES[i]) ** 2)
            self.add_module(f"box_{i}", _HeadBranch(c, coords, coords, 1.0))
            self.add_module(
                f"cls_{i}", _HeadBranch(c, num_classes, num_classes, cls_prior)
            )

    def forward(self, feats, split: bool = False):
        outs = []
        for i, f in enumerate(feats):
            box = getattr(self, f"box_{i}")(f)
            cls = getattr(self, f"cls_{i}")(f)
            outs.append((box, cls) if split else torch.cat([box, cls], dim=1))
        return tuple(outs)


class YOLOv8(nn.Module):
    """backbone -> neck -> head; NCHW float input, raw NCHW maps out."""

    def __init__(self, version: str, num_classes: int = 80, reg_max: int = 16):
        super().__init__()
        self.num_classes = num_classes
        self.reg_max = reg_max
        self.backbone = Backbone(version)
        self.neck = Neck(version)
        self.head = DetectHead(self.neck.out_channels, num_classes, reg_max)

    def forward(self, x, split_head: bool = False):
        p3, p4, p5 = self.backbone(x)
        return self.head(self.neck(p3, p4, p5), split=split_head)
