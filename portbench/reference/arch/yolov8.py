"""YOLOv8 in float32: the C2f backbone with SPPF, the PAFPN neck of C2f
blocks and the decoupled anchor-free head, from Ultralytics' ``yolov8.yaml``
(https://github.com/ultralytics/ultralytics/blob/main/ultralytics/cfg/models/v8/yolov8.yaml).
Names follow the program's state_dicts (``m_{i}`` in C2f).

A departure from the published model, which the program shares: C2f
concatenates its chunks in reverse insertion order ([y_n, ..., y_1, x1, x2]).
"""

from __future__ import annotations

import torch
from torch import nn

from portbench.reference.model import SPPF, ConvBnSiLU, Head, Net, stage_blocks, up, widths


class Bottleneck(nn.Module):
    def __init__(self, c, shortcut):
        super().__init__()
        self.conv1 = ConvBnSiLU(c, c, 3)
        self.conv2 = ConvBnSiLU(c, c, 3)
        self.shortcut = shortcut

    def forward(self, x):
        y = self.conv2(self.conv1(x))
        return y + x if self.shortcut else y


class C2f(nn.Module):
    def __init__(self, c_in, c_out, n, shortcut):
        super().__init__()
        self.mid, self.n = c_out // 2, n
        self.conv1 = ConvBnSiLU(c_in, c_out, 1)
        for i in range(n):
            self.add_module(f"m_{i}", Bottleneck(self.mid, shortcut))
        self.conv2 = ConvBnSiLU(c_out + n * self.mid, c_out, 1)

    def forward(self, x):
        x = self.conv1(x)
        x1, x2 = x[:, : self.mid], x[:, self.mid :]
        outs = [x1, x2]
        for i in range(self.n):
            x1 = getattr(self, f"m_{i}")(x1)
            outs.insert(0, x1)
        return self.conv2(torch.cat(outs, dim=1))


class Backbone(nn.Module):
    def __init__(self, cfg):
        super().__init__()
        c64, c128, c256, c512, c512r = widths(cfg)
        d = cfg["depth_multiple"]
        self.conv0 = ConvBnSiLU(3, c64, 3, 2)
        self.conv1 = ConvBnSiLU(c64, c128, 3, 2)
        self.conv3 = ConvBnSiLU(c128, c256, 3, 2)
        self.conv5 = ConvBnSiLU(c256, c512, 3, 2)
        self.conv7 = ConvBnSiLU(c512, c512r, 3, 2)
        self.c2f_2 = C2f(c128, c128, stage_blocks(3, d), True)
        self.c2f_4 = C2f(c256, c256, stage_blocks(6, d), True)
        self.c2f_6 = C2f(c512, c512, stage_blocks(6, d), True)
        self.c2f_8 = C2f(c512r, c512r, stage_blocks(3, d), True)
        self.sppf = SPPF(c512r, c512r, 5)

    def forward(self, x):
        x = self.c2f_2(self.conv1(self.conv0(x)))
        p3 = self.c2f_4(self.conv3(x))
        p4 = self.c2f_6(self.conv5(p3))
        return p3, p4, self.sppf(self.c2f_8(self.conv7(p4)))


class Neck(nn.Module):
    def __init__(self, cfg):
        super().__init__()
        _, _, c256, c512, c512r = widths(cfg)
        n = stage_blocks(3, cfg["depth_multiple"])
        self.conv1 = ConvBnSiLU(c256, c256, 3, 2)
        self.conv2 = ConvBnSiLU(c512, c512, 3, 2)
        self.c2f_1 = C2f(c512r + c512, c512, n, False)
        self.c2f_2 = C2f(c512 + c256, c256, n, False)
        self.c2f_3 = C2f(c256 + c512, c512, n, False)
        self.c2f_4 = C2f(c512 + c512r, c512r, n, False)

    def forward(self, p3, p4, p5):
        mid = self.c2f_1(torch.cat([up(p5), p4], dim=1))
        out1 = self.c2f_2(torch.cat([up(mid), p3], dim=1))
        out2 = self.c2f_3(torch.cat([self.conv1(out1), mid], dim=1))
        out3 = self.c2f_4(torch.cat([self.conv2(out2), p5], dim=1))
        return out1, out2, out3


def build(cfg) -> nn.Module:
    _, _, c256, c512, c512r = widths(cfg)
    return Net(cfg, Backbone(cfg), Neck(cfg),
               Head((c256, c512, c512r), cfg["num_classes"], cfg["reg_max"]))
