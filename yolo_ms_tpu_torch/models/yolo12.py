"""YOLOv12-L: R-ELAN area attention at P4 and P5, C3k2 elsewhere.

From Ultralytics' ``yolo12.yaml`` at scale l (depth 1.0, width 1.0, max
channels 512) and arXiv 2502.12524; the JAX package has no YOLOv12, and
only scale l is built. NCHW inside, the same raw per-scale maps out as
``models/yolo.py``'s YOLOv8, so decode, ``fused_postprocess``, the
``Predictor`` and its CUDA graphs take it unchanged. Layers 1 and 3 are
plain stride-2 convs (some copies of the yaml group them): 26.45 M
parameters, as the paper's 26.4 M for YOLOv12-L.
"""

from __future__ import annotations

import torch
from torch import nn

from yolo_ms_tpu_torch.models.yolo import DetectHead
from yolo_ms_tpu_torch.nn.blocks import A2C2f, C3k2, ConvBnSiLU, sharded_rows, upsample2x

AREAS = (4, 1)  # area attention's runs of tokens at P4 and at P5
MLP_RATIO = 1.2


class Backbone(nn.Module):
    """5 stride-2 convs, two C3k2 and two A2C2f with attention; returns
    (P3, P4, P5). No SPPF."""

    def __init__(self):
        super().__init__()
        self.conv0 = ConvBnSiLU(3, 64, 3, 2)
        self.conv1 = ConvBnSiLU(64, 128, 3, 2)
        self.c3k2_2 = C3k2(128, 256, 2, e=0.25)
        self.conv3 = ConvBnSiLU(256, 256, 3, 2)
        self.c3k2_4 = C3k2(256, 512, 2, e=0.25)
        self.conv5 = ConvBnSiLU(512, 512, 3, 2)
        self.a2c2f_6 = A2C2f(512, 512, 4, AREAS[0], MLP_RATIO)
        self.conv7 = ConvBnSiLU(512, 512, 3, 2)
        self.a2c2f_8 = A2C2f(512, 512, 4, AREAS[1], MLP_RATIO)

    def forward(self, x):
        x = self.c3k2_2(self.conv1(self.conv0(x)))
        p3 = self.c3k2_4(self.conv3(x))
        p4 = self.a2c2f_6(self.conv5(p3))
        return p3, p4, self.a2c2f_8(self.conv7(p4))


class Neck(nn.Module):
    """Top-down then bottom-up, as YOLOv8's PAFPN, with A2C2f stages
    without attention and a C3k2 at P5."""

    spatial_rows = None
    out_channels = (256, 512, 512)

    def __init__(self):
        super().__init__()
        self.a2c2f_1 = A2C2f(1024, 512, 2)
        self.a2c2f_2 = A2C2f(1024, 256, 2)
        self.conv1 = ConvBnSiLU(256, 256, 3, 2)
        self.a2c2f_3 = A2C2f(768, 512, 2)
        self.conv2 = ConvBnSiLU(512, 512, 3, 2)
        self.c3k2_4 = C3k2(1024, 512, 2)

    def forward(self, p3, p4, p5):
        mid = self.a2c2f_1(torch.cat([upsample2x(p5, sharded_rows(self, 2)), p4], dim=1))
        out1 = self.a2c2f_2(torch.cat([upsample2x(mid, sharded_rows(self, 1)), p3], dim=1))
        out2 = self.a2c2f_3(torch.cat([self.conv1(out1), mid], dim=1))
        out3 = self.c3k2_4(torch.cat([self.conv2(out2), p5], dim=1))
        return out1, out2, out3


class _SeparableBranch(nn.Module):
    """The class branch: 3x3 depthwise ConvBnSiLU ``dw1`` -> 1x1 ``conv1``
    -> 3x3 depthwise ``dw2`` -> 1x1 ``conv2`` -> 1x1 conv with bias
    ``pred``, whose bias starts at the detection prior."""

    def __init__(self, c_in: int, mid: int, out: int, bias_prior: float):
        super().__init__()
        self.dw1 = ConvBnSiLU(c_in, c_in, 3, groups=c_in)
        self.conv1 = ConvBnSiLU(c_in, mid, 1)
        self.dw2 = ConvBnSiLU(mid, mid, 3, groups=mid)
        self.conv2 = ConvBnSiLU(mid, mid, 1)
        self.pred = nn.Conv2d(mid, out, 1)
        self.bias_prior = bias_prior
        nn.init.constant_(self.pred.bias, bias_prior)

    def forward(self, x):
        return self.pred(self.conv2(self.dw2(self.conv1(self.dw1(x)))))


class YOLOv12(nn.Module):
    """backbone -> neck -> head with the depthwise-separable class branch,
    max(c0, min(nc, 100)) wide, c0 = 256 the first scale's width; NCHW
    float input, raw NCHW maps out."""

    def __init__(self, version: str = "l", num_classes: int = 80, reg_max: int = 16):
        super().__init__()
        if version != "l":
            raise ValueError(f"YOLOv12 is built at scale l only, not {version!r}")
        self.num_classes = num_classes
        self.reg_max = reg_max
        self.backbone = Backbone()
        self.neck = Neck()
        cls_mid = max(Neck.out_channels[0], min(num_classes, 100))
        self.head = DetectHead(
            Neck.out_channels, num_classes, reg_max,
            cls_branch=lambda c, prior: _SeparableBranch(c, cls_mid, num_classes, prior),
        )

    def forward(self, x, split_head: bool = False):
        p3, p4, p5 = self.backbone(x)
        return self.head(self.neck(p3, p4, p5), split=split_head)
