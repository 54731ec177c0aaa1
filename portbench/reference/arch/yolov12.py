"""YOLOv12 in float32: the C3k2 backbone with R-ELAN area-attention stages
(A2C2f), a neck of A2C2f and C3k2 blocks, and the head with the
depthwise-separable class branch, from Ultralytics' ``yolo12.yaml``
(https://github.com/ultralytics/ultralytics/blob/main/ultralytics/cfg/models/12/yolo12.yaml)
at the configuration's scale, and arXiv 2502.12524. Names follow the
program's state_dicts (``yolo_ms_tpu_torch/models/yolo12.py``).

Attention is written as Ultralytics' ``AAttn.forward`` writes it, with
explicit matmuls and a softmax (``forward_flops`` counts them): the tokens
are flattened row-major and cut into ``area`` contiguous runs; the channels
of a token read as ``[heads, (q | k | v), head_dim]``; per (image, area,
head) ``softmax(q k^T * head_dim**-0.5) v``; the output and ``v`` go back to
[B, C, H, W] with channel ``head * head_dim + d``, a 7x7 depthwise conv
``pe`` of ``v`` is added, and ``proj`` follows.

The class branch is depthwise-separable, DW 3x3 (c) -> 1x1 -> DW 3x3 -> 1x1
-> ``pred``, ``max(c0, min(nc, 100))`` wide, c0 the first level's input
width (Ultralytics' ``Detect`` with ``legacy=False``); the box branch is
YOLOv8's.

A departure from some copies of the yaml, which the program shares: layers
1 and 3 are plain convs. Grouped there (2 and 4 groups), YOLOv12-L counts
25.97 M parameters and 81.33 GFLOPs, not the paper's 26.4 M / 88.9 G.

``LEAVES`` draws each A2C2f's ``gamma`` 0.01 x U(0.5, 1.5): Ultralytics'
initial 0.01, spread per channel as the shared rules spread a BatchNorm
scale. Not U(0.5, 1.5): under the shared rules every ABlock's branches are
about as large as its input, so the residual stream doubles in variance at
each of the 16 residual adds of an attention stage; with gamma near 1 the
P5 stage starts from P4's scale and ends near 1e3, its softmaxes are argmax
with near-ties, and float32 rounding alone (the port against this file, or
the port's train against its deploy structure) moves the head's maps by
half their spread. At 0.01 x U(0.5, 1.5) float32 agrees to 2e-6 and a
wrong attention (area 1 at P4) moves the maps by 4e-4 to 7e-3 on the CPU,
under bf16's rounding on the card: the judge of a serving cell does not see
the attention stages. ``tests/test_torch_cuda.py`` holds the port's bf16
R-ELAN branch, before ``gamma``, to this file's on the card instead.
"""

from __future__ import annotations

import torch
from torch import nn

from portbench.reference.model import Branch, Conv, ConvBnSiLU, Net, stage_blocks, up

LEAVES = ((".gamma", lambda flat, gen: flat.uniform_(0.005, 0.015, generator=gen)),)


def channels(cfg, c: int) -> int:
    """A published width at the scale: min(c, max_channels) x width."""
    return int(min(c, cfg["max_channels"]) * cfg["width_multiple"])


class ConvBn(ConvBnSiLU):
    """A conv with BatchNorm and no activation."""

    def forward(self, x):
        return self.bn(self.conv(x))


class Bottleneck(nn.Module):
    def __init__(self, c):
        super().__init__()
        self.conv1 = ConvBnSiLU(c, c, 3)
        self.conv2 = ConvBnSiLU(c, c, 3)

    def forward(self, x):
        return x + self.conv2(self.conv1(x))


class C3k(nn.Module):
    """C3 with two 3x3/3x3 residual bottlenecks at the half width."""

    def __init__(self, c_in, c_out):
        super().__init__()
        mid = c_out // 2
        self.conv1 = ConvBnSiLU(c_in, mid, 1)
        self.conv2 = ConvBnSiLU(c_in, mid, 1)
        self.conv3 = ConvBnSiLU(2 * mid, c_out, 1)
        self.m_0 = Bottleneck(mid)
        self.m_1 = Bottleneck(mid)

    def forward(self, x):
        y = self.m_1(self.m_0(self.conv1(x)))
        return self.conv3(torch.cat([y, self.conv2(x)], dim=1))


class C3k2(nn.Module):
    """C2f's split with C3k blocks: [a, b, m_0(b), m_1(m_0(b)), ...] -> 1x1."""

    def __init__(self, c_in, c_out, n, e=0.5):
        super().__init__()
        self.mid, self.n = int(c_out * e), n
        self.conv1 = ConvBnSiLU(c_in, 2 * self.mid, 1)
        for i in range(n):
            self.add_module(f"m_{i}", C3k(self.mid, self.mid))
        self.conv2 = ConvBnSiLU((2 + n) * self.mid, c_out, 1)

    def forward(self, x):
        y = list(self.conv1(x).split(self.mid, dim=1))
        for i in range(self.n):
            y.append(getattr(self, f"m_{i}")(y[-1]))
        return self.conv2(torch.cat(y, dim=1))


class AAttn(nn.Module):
    def __init__(self, dim, heads, area):
        super().__init__()
        self.heads, self.head_dim, self.area = heads, dim // heads, area
        self.qkv = ConvBn(dim, 3 * dim, 1)
        self.proj = ConvBn(dim, dim, 1)
        self.pe = ConvBn(dim, dim, 7, groups=dim)

    def forward(self, x):
        b, c, h, w = x.shape
        n, d = h * w, self.head_dim
        qkv = self.qkv(x).flatten(2).transpose(1, 2)  # [B, N, 3C], tokens row-major
        if self.area > 1:
            qkv = qkv.reshape(b * self.area, n // self.area, 3 * c)
        s, m, _ = qkv.shape
        q, k, v = qkv.view(s, m, self.heads, 3 * d).permute(0, 2, 3, 1).split(d, dim=2)
        attn = ((q.transpose(-2, -1) @ k) * d**-0.5).softmax(dim=-1)  # [S, heads, m, m]
        out = v @ attn.transpose(-2, -1)  # [S, heads, d, m]
        out = out.permute(0, 3, 1, 2).reshape(b, h, w, c).permute(0, 3, 1, 2)
        v = v.permute(0, 3, 1, 2).reshape(b, h, w, c).permute(0, 3, 1, 2)
        return self.proj(out + self.pe(v))


class ABlock(nn.Module):
    def __init__(self, dim, heads, mlp_ratio, area):
        super().__init__()
        hidden = int(dim * mlp_ratio)
        self.attn = AAttn(dim, heads, area)
        self.mlp_in = ConvBnSiLU(dim, hidden, 1)
        self.mlp_out = ConvBn(hidden, dim, 1)

    def forward(self, x):
        x = x + self.attn(x)
        return x + self.mlp_out(self.mlp_in(x))


class A2C2f(nn.Module):
    """R-ELAN: 1x1 to c_out/2, n stages (two ABlocks each, or one C3k
    without attention), 1x1 over the concat of every stage's output; with
    attention and ``residual``, ``x + gamma * out``."""

    def __init__(self, c_in, c_out, n, attention, area=1, residual=False, mlp_ratio=2.0):
        super().__init__()
        mid = c_out // 2
        self.n = n
        self.conv1 = ConvBnSiLU(c_in, mid, 1)
        for i in range(n):
            stage = (nn.Sequential(*(ABlock(mid, mid // 32, mlp_ratio, area) for _ in range(2)))
                     if attention else C3k(mid, mid))
            self.add_module(f"m_{i}", stage)
        self.conv2 = ConvBnSiLU((1 + n) * mid, c_out, 1)
        self.gamma = nn.Parameter(torch.empty(c_out)) if attention and residual else None

    def forward(self, x):
        y = [self.conv1(x)]
        for i in range(self.n):
            y.append(getattr(self, f"m_{i}")(y[-1]))
        y = self.conv2(torch.cat(y, dim=1))
        return y if self.gamma is None else x + self.gamma[None, :, None, None] * y


class Backbone(nn.Module):
    def __init__(self, cfg):
        super().__init__()
        c64, c128, c256, c512, c1024 = (channels(cfg, c) for c in (64, 128, 256, 512, 1024))
        d = cfg["depth_multiple"]
        area4, area5 = cfg["area"]
        kw = {"residual": cfg["residual"], "mlp_ratio": cfg["mlp_ratio"]}
        self.conv0 = ConvBnSiLU(3, c64, 3, 2)
        self.conv1 = ConvBnSiLU(c64, c128, 3, 2)
        self.c3k2_2 = C3k2(c128, c256, stage_blocks(2, d), e=0.25)
        self.conv3 = ConvBnSiLU(c256, c256, 3, 2)
        self.c3k2_4 = C3k2(c256, c512, stage_blocks(2, d), e=0.25)
        self.conv5 = ConvBnSiLU(c512, c512, 3, 2)
        self.a2c2f_6 = A2C2f(c512, c512, stage_blocks(4, d), True, area4, **kw)
        self.conv7 = ConvBnSiLU(c512, c1024, 3, 2)
        self.a2c2f_8 = A2C2f(c1024, c1024, stage_blocks(4, d), True, area5, **kw)

    def forward(self, x):
        x = self.c3k2_2(self.conv1(self.conv0(x)))
        p3 = self.c3k2_4(self.conv3(x))
        p4 = self.a2c2f_6(self.conv5(p3))
        return p3, p4, self.a2c2f_8(self.conv7(p4))


class Neck(nn.Module):
    def __init__(self, cfg):
        super().__init__()
        c256, c512, c1024 = (channels(cfg, c) for c in (256, 512, 1024))
        n = stage_blocks(2, cfg["depth_multiple"])
        self.a2c2f_1 = A2C2f(c1024 + c512, c512, n, False)
        self.a2c2f_2 = A2C2f(c512 + c512, c256, n, False)
        self.conv1 = ConvBnSiLU(c256, c256, 3, 2)
        self.a2c2f_3 = A2C2f(c256 + c512, c512, n, False)
        self.conv2 = ConvBnSiLU(c512, c512, 3, 2)
        self.c3k2_4 = C3k2(c512 + c1024, c1024, n)

    def forward(self, p3, p4, p5):
        mid = self.a2c2f_1(torch.cat([up(p5), p4], dim=1))
        out1 = self.a2c2f_2(torch.cat([up(mid), p3], dim=1))
        out2 = self.a2c2f_3(torch.cat([self.conv1(out1), mid], dim=1))
        out3 = self.c3k2_4(torch.cat([self.conv2(out2), p5], dim=1))
        return out1, out2, out3


class SeparableBranch(nn.Module):
    """DW 3x3 -> 1x1 -> DW 3x3 -> 1x1, each with BatchNorm and SiLU, then
    the 1x1 ``pred``."""

    def __init__(self, c_in, mid, out):
        super().__init__()
        self.dw1 = ConvBnSiLU(c_in, c_in, 3, groups=c_in)
        self.conv1 = ConvBnSiLU(c_in, mid, 1)
        self.dw2 = ConvBnSiLU(mid, mid, 3, groups=mid)
        self.conv2 = ConvBnSiLU(mid, mid, 1)
        self.pred = Conv(mid, out, 1)

    def forward(self, x):
        return self.pred(self.conv2(self.dw2(self.conv1(self.dw1(x)))))


class Head(nn.Module):
    """Per level a box branch (``box_{i}``, YOLOv8's, 4 * reg_max wide) and
    the separable class branch (``cls_{i}``, max(c0, min(nc, 100)) wide)."""

    def __init__(self, chans, nc, reg_max):
        super().__init__()
        mid = max(chans[0], min(nc, 100))
        for i, c in enumerate(chans):
            self.add_module(f"box_{i}", Branch(c, 4 * reg_max, 4 * reg_max))
            self.add_module(f"cls_{i}", SeparableBranch(c, mid, nc))

    def forward(self, feats):
        return [(getattr(self, f"box_{i}")(f), getattr(self, f"cls_{i}")(f))
                for i, f in enumerate(feats)]


def build(cfg) -> nn.Module:
    chans = tuple(channels(cfg, c) for c in (256, 512, 1024))
    return Net(cfg, Backbone(cfg), Neck(cfg), Head(chans, cfg["num_classes"], cfg["reg_max"]))
