"""YOLO-MS in float32, as this repository reconstructs it from the paper
(arXiv 2308.05480): MSBlock stages with the heterogeneous kernel sizes
3/5/7/9 on YOLOv8's strided backbone, MS-SPPF (a 3x3 depthwise mixer before
the pools), the MSFusion neck of MS stages, and YOLOv8's head. Names follow
the program's state_dicts (``block_{i}``/``branch_{i}`` in the MS stages).
"""

from __future__ import annotations

import torch
from torch import nn

from portbench.reference.model import SPPF, ConvBnSiLU, Head, Net, stage_blocks, up, widths


class InvertedBottleneck(nn.Module):
    def __init__(self, c_in, c_out, k, expansion):
        super().__init__()
        hidden = int(c_out * expansion)
        self.expand = ConvBnSiLU(c_in, hidden, 1)
        self.dw = ConvBnSiLU(hidden, hidden, k, groups=hidden)
        self.project = ConvBnSiLU(hidden, c_out, 1)

    def forward(self, x):
        return self.project(self.dw(self.expand(x)))


class MSBlock(nn.Module):
    def __init__(self, c_in, c_out, k, branches, branch_ratio, expansion):
        super().__init__()
        self.bc = max(8, int(c_out * branch_ratio / branches))
        self.branches = branches
        self.in_conv = ConvBnSiLU(c_in, self.bc * branches, 1)
        for i in range(1, branches):
            self.add_module(f"branch_{i}", InvertedBottleneck(self.bc, self.bc, k, expansion))
        self.out_conv = ConvBnSiLU(self.bc * branches, c_out, 1)

    def forward(self, x):
        x = self.in_conv(x)
        bc = self.bc
        prev = x[:, :bc]
        outs = [prev]
        for i in range(1, self.branches):
            prev = getattr(self, f"branch_{i}")(x[:, i * bc : (i + 1) * bc] + prev)
            outs.append(prev)
        return self.out_conv(torch.cat(outs, dim=1))


class MSStage(nn.Module):
    def __init__(self, c_in, c_out, k, n, ms):
        super().__init__()
        self.n = n
        for i in range(n):
            self.add_module(f"block_{i}", MSBlock(c_in if i == 0 else c_out, c_out, k,
                                                  ms["branches"], ms["branch_ratio"],
                                                  ms["expansion"]))

    def forward(self, x):
        for i in range(self.n):
            x = getattr(self, f"block_{i}")(x)
        return x


class MSFusion(nn.Module):
    def __init__(self, c_in, c_out):
        super().__init__()
        self.fuse = ConvBnSiLU(c_in, c_out, 1)

    def forward(self, a, b, upsample=False):
        if upsample:
            a = up(a)
        return self.fuse(torch.cat([a, b], dim=1))


class Backbone(nn.Module):
    def __init__(self, cfg):
        super().__init__()
        c64, c128, c256, c512, c512r = widths(cfg)
        ms, n = cfg["ms_block"], stage_blocks(3, cfg["depth_multiple"])
        k2, k4, k6, k8 = ms["backbone_kernels"]
        self.conv0 = ConvBnSiLU(3, c64, 3, 2)
        self.conv1 = ConvBnSiLU(c64, c128, 3, 2)
        self.conv3 = ConvBnSiLU(c128, c256, 3, 2)
        self.conv5 = ConvBnSiLU(c256, c512, 3, 2)
        self.conv7 = ConvBnSiLU(c512, c512r, 3, 2)
        self.stage_2 = MSStage(c128, c128, k2, n, ms)
        self.stage_4 = MSStage(c256, c256, k4, n, ms)
        self.stage_6 = MSStage(c512, c512, k6, n, ms)
        self.stage_8 = MSStage(c512r, c512r, k8, n, ms)
        self.ms_sppf = SPPF(c512r, c512r, 5, dw=True)

    def forward(self, x):
        x = self.stage_2(self.conv1(self.conv0(x)))
        p3 = self.stage_4(self.conv3(x))
        p4 = self.stage_6(self.conv5(p3))
        return p3, p4, self.ms_sppf(self.stage_8(self.conv7(p4)))


class Neck(nn.Module):
    def __init__(self, cfg):
        super().__init__()
        _, _, c256, c512, c512r = widths(cfg)
        ms, n = cfg["ms_block"], stage_blocks(3, cfg["depth_multiple"])
        k8, k16, k32 = ms["neck_kernels"]
        self.conv1 = ConvBnSiLU(c256, c256, 3, 2)
        self.conv2 = ConvBnSiLU(c512, c512, 3, 2)
        self.fuse_1 = MSFusion(c512r + c512, c512)
        self.stage_1 = MSStage(c512, c512, k16, n, ms)
        self.fuse_2 = MSFusion(c512 + c256, c256)
        self.stage_2 = MSStage(c256, c256, k8, n, ms)
        self.fuse_3 = MSFusion(c256 + c512, c512)
        self.stage_3 = MSStage(c512, c512, k16, n, ms)
        self.fuse_4 = MSFusion(c512 + c512r, c512r)
        self.stage_4 = MSStage(c512r, c512r, k32, n, ms)

    def forward(self, p3, p4, p5):
        mid = self.stage_1(self.fuse_1(p5, p4, upsample=True))
        out1 = self.stage_2(self.fuse_2(mid, p3, upsample=True))
        out2 = self.stage_3(self.fuse_3(self.conv1(out1), mid))
        out3 = self.stage_4(self.fuse_4(self.conv2(out2), p5))
        return out1, out2, out3


def build(cfg) -> nn.Module:
    _, _, c256, c512, c512r = widths(cfg)
    return Net(cfg, Backbone(cfg), Neck(cfg),
               Head((c256, c512, c512r), cfg["num_classes"], cfg["reg_max"]))
