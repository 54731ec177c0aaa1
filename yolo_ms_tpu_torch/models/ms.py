"""YOLO-MS (XS / S / M) and YOLOv8-MS (N / S / M) families.

Port of ``yolo_ms_tpu/models/ms.py``, NCHW inside: the v8 skeleton with
MSBlock stages under the heterogeneous-kernel-size protocol, MS-SPPF and
MSFusion (YOLO-MS), or v8 SPPF and plain concats (YOLOv8-MS); the v8
detect head on top. The JAX package's deploy-only split upsample-concat
contraction and dw-isolation barriers are plain ops here.
"""

from __future__ import annotations

import torch
from torch import nn

from yolo_ms_tpu_torch.models.yolo import DetectHead, _widths
from yolo_ms_tpu_torch.nn.blocks import (
    MSSPPF,
    SPPF,
    ConvBnSiLU,
    MSBlock,
    MSFusion,
    sharded_rows,
    upsample2x,
    yolo_params,
)

# (depth, width, ratio) per YOLO-MS variant.
MS_PARAMS: dict[str, tuple[float, float, float]] = {
    "xs": (1 / 3, 0.375, 2.0),
    "s": (1 / 3, 0.53, 2.0),
    "m": (2 / 3, 0.9, 1.5),
}

# Kernel size per backbone stage (shallow -> deep).
HKS_KERNELS: tuple[int, ...] = (3, 5, 7, 9)
# Neck kernels per feature stride (8, 16, 32).
NECK_KERNELS: tuple[int, int, int] = (5, 7, 9)

# (branch_ratio, expansion) of every MS stage per YOLOv8-MS version.
V8MS_BLOCK: dict[str, tuple[float, float]] = {
    "n": (1.25, 3.0),
    "s": (1.5, 2.0),
    "m": (1.5, 3.0),
}

def ms_params(version: str) -> tuple[float, float, float]:
    if version not in MS_PARAMS:
        raise ValueError(f"Unknown YOLO-MS version: {version} (xs/s/m)")
    return MS_PARAMS[version]


class _MSStage(nn.Module):
    """Chained MSBlocks with one kernel size; ``num_blocks`` defaults to
    max(1, round(3*depth))."""

    def __init__(self, c_in: int, features: int, kernel_size: int, depth: float,
                 num_blocks: int | None = None, use_se: bool = False,
                 branch_ratio: float = 1.0, expansion: float = 2.0):
        super().__init__()
        self.n = num_blocks if num_blocks else max(1, round(3 * depth))
        for i in range(self.n):
            self.add_module(
                f"block_{i}",
                MSBlock(
                    c_in if i == 0 else features,
                    features,
                    kernel_size=kernel_size,
                    branch_ratio=branch_ratio,
                    expansion=expansion,
                    use_se=use_se,
                ),
            )

    def forward(self, x):
        for i in range(self.n):
            x = getattr(self, f"block_{i}")(x)
        return x


class MSBackbone(nn.Module):
    """5 stride-2 convs + 4 MSBlock stages (kernels 3/5/7/9) + MS-SPPF."""

    def __init__(self, version: str, use_se: bool = False):
        super().__init__()
        depth, width, ratio = ms_params(version)
        c64, c128, c256, c512, c512r = _widths(width, ratio)
        k1, k2, k3, k4 = HKS_KERNELS
        self.out_channels = (c256, c512, c512r)
        self.conv0 = ConvBnSiLU(3, c64, 3, 2)
        self.conv1 = ConvBnSiLU(c64, c128, 3, 2)
        self.stage_2 = _MSStage(c128, c128, k1, depth, use_se=use_se)
        self.conv3 = ConvBnSiLU(c128, c256, 3, 2)
        self.stage_4 = _MSStage(c256, c256, k2, depth, use_se=use_se)
        self.conv5 = ConvBnSiLU(c256, c512, 3, 2)
        self.stage_6 = _MSStage(c512, c512, k3, depth, use_se=use_se)
        self.conv7 = ConvBnSiLU(c512, c512r, 3, 2)
        self.stage_8 = _MSStage(c512r, c512r, k4, depth, use_se=use_se)
        self.ms_sppf = MSSPPF(c512r, c512r, 5)

    def forward(self, x):
        x = self.stage_2(self.conv1(self.conv0(x)))
        out1 = self.stage_4(self.conv3(x))
        out2 = self.stage_6(self.conv5(out1))
        x = self.stage_8(self.conv7(out2))
        return out1, out2, self.ms_sppf(x)


class MSNeck(nn.Module):
    """PAFPN with MSFusion + MSBlock stages, kernels matched to stride."""

    def __init__(self, version: str, use_se: bool = False):
        super().__init__()
        depth, width, ratio = ms_params(version)
        _, _, c256, c512, c512r = _widths(width, ratio)
        k8, k16, k32 = NECK_KERNELS
        self.out_channels = (c256, c512, c512r)
        self.fuse_1 = MSFusion(c512r + c512, c512)
        self.stage_1 = _MSStage(c512, c512, k16, depth, use_se=use_se)
        self.fuse_2 = MSFusion(c512 + c256, c256)
        self.stage_2 = _MSStage(c256, c256, k8, depth, use_se=use_se)
        self.conv1 = ConvBnSiLU(c256, c256, 3, 2)
        self.fuse_3 = MSFusion(c256 + c512, c512)
        self.stage_3 = _MSStage(c512, c512, k16, depth, use_se=use_se)
        self.conv2 = ConvBnSiLU(c512, c512, 3, 2)
        self.fuse_4 = MSFusion(c512 + c512r, c512r)
        self.stage_4 = _MSStage(c512r, c512r, k32, depth, use_se=use_se)

    def forward(self, p3, p4, p5):
        res_1 = p5
        res_2 = self.stage_1(self.fuse_1(p5, p4, upsample_a=True))
        out1 = self.stage_2(self.fuse_2(res_2, p3, upsample_a=True))
        out2 = self.stage_3(self.fuse_3(self.conv1(out1), res_2))
        out3 = self.stage_4(self.fuse_4(self.conv2(out2), res_1))
        return out1, out2, out3


class YOLOMS(nn.Module):
    """MS backbone -> MS neck -> v8 detect head."""

    def __init__(self, version: str, num_classes: int = 80, reg_max: int = 16,
                 use_se: bool = False):
        super().__init__()
        self.num_classes = num_classes
        self.reg_max = reg_max
        self.backbone = MSBackbone(version, use_se=use_se)
        self.neck = MSNeck(version, use_se=use_se)
        self.head = DetectHead(self.neck.out_channels, num_classes, reg_max)

    def forward(self, x, split_head: bool = False):
        p3, p4, p5 = self.backbone(x)
        return self.head(self.neck(p3, p4, p5), split=split_head)


class V8MSBackbone(nn.Module):
    """v8 backbone with MSBlock stages (depth schedule 3d/6d/6d/3d) + SPPF."""

    def __init__(self, version: str, use_se: bool = False):
        super().__init__()
        depth, width, ratio = yolo_params(version)
        c64, c128, c256, c512, c512r = _widths(width, ratio)
        d3, d6 = max(1, int(3 * depth)), max(1, int(6 * depth))
        k1, k2, k3, k4 = HKS_KERNELS
        br, ex = V8MS_BLOCK[version]

        def stage(c_in, feats, k, n):
            return _MSStage(c_in, feats, k, depth, num_blocks=n, use_se=use_se,
                            branch_ratio=br, expansion=ex)

        self.out_channels = (c256, c512, c512r)
        self.conv0 = ConvBnSiLU(3, c64, 3, 2)
        self.conv1 = ConvBnSiLU(c64, c128, 3, 2)
        self.stage_2 = stage(c128, c128, k1, d3)
        self.conv3 = ConvBnSiLU(c128, c256, 3, 2)
        self.stage_4 = stage(c256, c256, k2, d6)
        self.conv5 = ConvBnSiLU(c256, c512, 3, 2)
        self.stage_6 = stage(c512, c512, k3, d6)
        self.conv7 = ConvBnSiLU(c512, c512r, 3, 2)
        self.stage_8 = stage(c512r, c512r, k4, d3)
        self.sppf = SPPF(c512r, c512r, 5)

    def forward(self, x):
        x = self.stage_2(self.conv1(self.conv0(x)))
        out1 = self.stage_4(self.conv3(x))
        out2 = self.stage_6(self.conv5(out1))
        x = self.stage_8(self.conv7(out2))
        return out1, out2, self.sppf(x)


class V8MSNeck(nn.Module):
    """v8 PAFPN (plain concats) with MSBlock stages."""

    spatial_rows = None

    def __init__(self, version: str, use_se: bool = False):
        super().__init__()
        depth, width, ratio = yolo_params(version)
        _, _, c256, c512, c512r = _widths(width, ratio)
        d3 = max(1, int(3 * depth))
        k8, k16, k32 = NECK_KERNELS
        br, ex = V8MS_BLOCK[version]

        def stage(c_in, feats, k):
            return _MSStage(c_in, feats, k, depth, num_blocks=d3, use_se=use_se,
                            branch_ratio=br, expansion=ex)

        self.out_channels = (c256, c512, c512r)
        self.stage_1 = stage(c512r + c512, c512, k16)
        self.stage_2 = stage(c512 + c256, c256, k8)
        self.conv1 = ConvBnSiLU(c256, c256, 3, 2)
        self.stage_3 = stage(c256 + c512, c512, k16)
        self.conv2 = ConvBnSiLU(c512, c512, 3, 2)
        self.stage_4 = stage(c512 + c512r, c512r, k32)

    def forward(self, p3, p4, p5):
        res_1 = p5
        res_2 = self.stage_1(torch.cat([upsample2x(p5, sharded_rows(self, 2)), p4], dim=1))
        out1 = self.stage_2(torch.cat([upsample2x(res_2, sharded_rows(self, 1)), p3], dim=1))
        out2 = self.stage_3(torch.cat([self.conv1(out1), res_2], dim=1))
        out3 = self.stage_4(torch.cat([self.conv2(out2), res_1], dim=1))
        return out1, out2, out3


class YOLOv8MS(nn.Module):
    """v8 skeleton with MSBlock stages -> v8 detect head."""

    def __init__(self, version: str, num_classes: int = 80, reg_max: int = 16,
                 use_se: bool = False):
        super().__init__()
        self.num_classes = num_classes
        self.reg_max = reg_max
        self.backbone = V8MSBackbone(version, use_se=use_se)
        self.neck = V8MSNeck(version, use_se=use_se)
        self.head = DetectHead(self.neck.out_channels, num_classes, reg_max)

    def forward(self, x, split_head: bool = False):
        p3, p4, p5 = self.backbone(x)
        return self.head(self.neck(p3, p4, p5), split=split_head)
