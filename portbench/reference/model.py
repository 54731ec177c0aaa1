"""The plain reference of the two benchmark architectures, in float32.

YOLOv8 (backbone, PAFPN neck, decoupled anchor-free head) and YOLO-MS
(MSBlock stages with the heterogeneous kernel sizes 3/5/7/9, MS-SPPF and
MSFusion neck, the same head), written from the published descriptions in
plain ``torch`` operations. The module and parameter names are those of the
benchmarked program's state_dicts (``conv``/``bn`` under every conv block,
``m_{i}`` in C2f, ``block_{i}``/``branch_{i}`` in the MS stages,
``box_{i}``/``cls_{i}`` in the head), so one seeded state_dict loads into
both. Nothing here imports the program.

BatchNorm stays a BatchNorm: in eval mode it reads the running statistics,
which is the folded conv of a deploy model worked out again. In train mode
it normalizes with the batch mean and biased variance and moves the running
statistics by 0.03 of the biased batch variance (flax's rule, eps 1e-3).

``precision = "fp8"`` (set by ``set_precision``) computes every conv in
float8 e4m3: its input and its weight are rounded to it before the float32
conv, and its output after it (per tensor for input and output, per output
channel for the weight, each scaled so that its largest magnitude is 448),
as a network that keeps its activations in fp8 does, down to the maps the
head returns. The gradient passes the rounding unchanged. This is the
control that a correct comparison has to fail.

Departures from the published models, which the program shares: the class
branch of the head is ``num_classes`` wide (Ultralytics takes
``max(c3, min(nc, 100))``), and C2f concatenates its chunks in reverse
insertion order ([y_n, ..., y_1, x1, x2]).
"""

from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F
from torch import nn

BN_EPS = 1e-3
BN_MOMENTUM = 0.03
STRIDES = (8, 16, 32)
FP8_MAX = 448.0


def _fp8(x: torch.Tensor, dims) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 at a scale that maps its largest
    magnitude over ``dims`` to 448; the gradient passes unchanged."""
    amax = x.detach().abs().amax(dim=dims, keepdim=True).clamp(min=1e-12)
    scale = FP8_MAX / amax
    q = (x.detach() * scale).to(torch.float8_e4m3fn).float() / scale
    return x + (q - x).detach()


class Conv(nn.Conv2d):
    """``nn.Conv2d`` whose input, weight and output round to fp8 under the
    fp8 control."""

    precision = "f32"

    def forward(self, x):
        w = self.weight
        if self.precision == "fp8":
            x = _fp8(x, None)
            w = _fp8(w, (1, 2, 3))
        y = F.conv2d(x, w, self.bias, self.stride, self.padding, 1, self.groups)
        return _fp8(y, None) if self.precision == "fp8" else y


class BatchNorm(nn.BatchNorm2d):
    def forward(self, x):
        if not self.training:
            return F.batch_norm(x, self.running_mean, self.running_var, self.weight,
                                self.bias, False, 0.0, self.eps)
        mean = x.mean(dim=(0, 2, 3))
        var = x.var(dim=(0, 2, 3), unbiased=False)
        with torch.no_grad():
            self.running_mean.mul_(1 - BN_MOMENTUM).add_(mean, alpha=BN_MOMENTUM)
            self.running_var.mul_(1 - BN_MOMENTUM).add_(var, alpha=BN_MOMENTUM)
        inv = torch.rsqrt(var + self.eps)
        return ((x - mean[None, :, None, None]) * (inv * self.weight)[None, :, None, None]
                + self.bias[None, :, None, None])


class ConvBnSiLU(nn.Module):
    def __init__(self, c_in, c_out, k=3, s=1, groups=1):
        super().__init__()
        self.conv = Conv(c_in, c_out, k, s, k // 2, groups=groups, bias=False)
        self.bn = BatchNorm(c_out, eps=BN_EPS)

    def forward(self, x):
        return F.silu(self.bn(self.conv(x)))


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


def _pools(x, k):
    x1 = F.max_pool2d(x, k, 1, k // 2)
    x2 = F.max_pool2d(x1, k, 1, k // 2)
    return [x, x1, x2, F.max_pool2d(x2, k, 1, k // 2)]


class SPPF(nn.Module):
    def __init__(self, c_in, c_out, k=5, dw=False):
        super().__init__()
        hidden = c_in // 2
        self.k = k
        self.conv1 = ConvBnSiLU(c_in, hidden, 1)
        if dw:  # MS-SPPF: a 3x3 depthwise mixer before the pools
            self.dw = ConvBnSiLU(hidden, hidden, 3, groups=hidden)
        self.conv2 = ConvBnSiLU(4 * hidden, c_out, 1)

    def forward(self, x):
        x = self.conv1(x)
        if hasattr(self, "dw"):
            x = self.dw(x)
        return self.conv2(torch.cat(_pools(x, self.k), dim=1))


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

    def forward(self, a, b, up=False):
        if up:
            a = F.interpolate(a, scale_factor=2, mode="nearest")
        return self.fuse(torch.cat([a, b], dim=1))


def _up(x):
    return F.interpolate(x, scale_factor=2, mode="nearest")


def _blocks(n: int, depth: float) -> int:
    """Blocks of a stage of ``n`` at the depth multiple (Ultralytics' rule)."""
    return max(round(n * depth), 1)


def _widths(cfg):
    w, r = cfg["width_multiple"], cfg["last_stage_ratio"]
    return int(64 * w), int(128 * w), int(256 * w), int(512 * w), int(512 * w * r)


class Backbone(nn.Module):
    def __init__(self, cfg):
        super().__init__()
        c64, c128, c256, c512, c512r = _widths(cfg)
        d = cfg["depth_multiple"]
        self.conv0 = ConvBnSiLU(3, c64, 3, 2)
        self.conv1 = ConvBnSiLU(c64, c128, 3, 2)
        self.conv3 = ConvBnSiLU(c128, c256, 3, 2)
        self.conv5 = ConvBnSiLU(c256, c512, 3, 2)
        self.conv7 = ConvBnSiLU(c512, c512r, 3, 2)
        if cfg["family"] == "yolov8":
            self.stages = ("c2f_2", "c2f_4", "c2f_6", "c2f_8")
            for name, c, n in zip(self.stages, (c128, c256, c512, c512r), (3, 6, 6, 3)):
                self.add_module(name, C2f(c, c, _blocks(n, d), True))
            self.sppf = SPPF(c512r, c512r, 5)
        else:
            ms = cfg["ms_block"]
            self.stages = ("stage_2", "stage_4", "stage_6", "stage_8")
            for name, c, k in zip(self.stages, (c128, c256, c512, c512r), ms["backbone_kernels"]):
                self.add_module(name, MSStage(c, c, k, _blocks(3, d), ms))
            self.ms_sppf = SPPF(c512r, c512r, 5, dw=True)

    def forward(self, x):
        s2, s4, s6, s8 = (getattr(self, n) for n in self.stages)
        x = s2(self.conv1(self.conv0(x)))
        p3 = s4(self.conv3(x))
        p4 = s6(self.conv5(p3))
        x = s8(self.conv7(p4))
        top = self.sppf if hasattr(self, "sppf") else self.ms_sppf
        return p3, p4, top(x)


class Neck(nn.Module):
    def __init__(self, cfg):
        super().__init__()
        _, _, c256, c512, c512r = _widths(cfg)
        d = cfg["depth_multiple"]
        self.v8 = cfg["family"] == "yolov8"
        self.conv1 = ConvBnSiLU(c256, c256, 3, 2)
        self.conv2 = ConvBnSiLU(c512, c512, 3, 2)
        if self.v8:
            n = _blocks(3, d)
            self.c2f_1 = C2f(c512r + c512, c512, n, False)
            self.c2f_2 = C2f(c512 + c256, c256, n, False)
            self.c2f_3 = C2f(c256 + c512, c512, n, False)
            self.c2f_4 = C2f(c512 + c512r, c512r, n, False)
        else:
            ms = cfg["ms_block"]
            k8, k16, k32 = ms["neck_kernels"]
            n = _blocks(3, d)
            self.fuse_1 = MSFusion(c512r + c512, c512)
            self.stage_1 = MSStage(c512, c512, k16, n, ms)
            self.fuse_2 = MSFusion(c512 + c256, c256)
            self.stage_2 = MSStage(c256, c256, k8, n, ms)
            self.fuse_3 = MSFusion(c256 + c512, c512)
            self.stage_3 = MSStage(c512, c512, k16, n, ms)
            self.fuse_4 = MSFusion(c512 + c512r, c512r)
            self.stage_4 = MSStage(c512r, c512r, k32, n, ms)

    def forward(self, p3, p4, p5):
        if self.v8:
            mid = self.c2f_1(torch.cat([_up(p5), p4], dim=1))
            out1 = self.c2f_2(torch.cat([_up(mid), p3], dim=1))
            out2 = self.c2f_3(torch.cat([self.conv1(out1), mid], dim=1))
            out3 = self.c2f_4(torch.cat([self.conv2(out2), p5], dim=1))
            return out1, out2, out3
        mid = self.stage_1(self.fuse_1(p5, p4, up=True))
        out1 = self.stage_2(self.fuse_2(mid, p3, up=True))
        out2 = self.stage_3(self.fuse_3(self.conv1(out1), mid))
        out3 = self.stage_4(self.fuse_4(self.conv2(out2), p5))
        return out1, out2, out3


class Branch(nn.Module):
    def __init__(self, c_in, mid, out):
        super().__init__()
        self.conv1 = ConvBnSiLU(c_in, mid, 3)
        self.conv2 = ConvBnSiLU(mid, mid, 3)
        self.pred = Conv(mid, out, 1)

    def forward(self, x):
        return self.pred(self.conv2(self.conv1(x)))


class Detector(nn.Module):
    """image [B, 3, H, W] f32 (normalized) -> per scale (box logits [B,
    4*reg_max, H, W], class logits [B, nc, H, W])."""

    def __init__(self, cfg):
        super().__init__()
        self.nc, self.reg_max = cfg["num_classes"], cfg["reg_max"]
        self.backbone = Backbone(cfg)
        self.neck = Neck(cfg)
        _, _, c256, c512, c512r = _widths(cfg)
        self.head = nn.Module()
        for i, c in enumerate((c256, c512, c512r)):
            self.head.add_module(f"box_{i}", Branch(c, 4 * self.reg_max, 4 * self.reg_max))
            self.head.add_module(f"cls_{i}", Branch(c, self.nc, self.nc))

    def forward(self, x):
        feats = self.neck(*self.backbone(x))
        return [(getattr(self.head, f"box_{i}")(f), getattr(self.head, f"cls_{i}")(f))
                for i, f in enumerate(feats)]


@contextlib.contextmanager
def ieee_f32():
    """Convs and matmuls in IEEE float32 (no TF32) inside the block; the
    previous settings come back on exit."""
    switches = (torch.backends.cuda.matmul, torch.backends.cudnn.conv)
    before = [s.fp32_precision for s in switches]
    try:
        for s in switches:
            s.fp32_precision = "ieee"
        yield
    finally:
        for s, v in zip(switches, before):
            s.fp32_precision = v


def set_precision(model: nn.Module, precision: str) -> nn.Module:
    """``"f32"`` or ``"fp8"`` (the control) for every conv of ``model``."""
    if precision not in ("f32", "fp8"):
        raise ValueError(f"precision must be 'f32' or 'fp8', not {precision!r}")
    for m in model.modules():
        if isinstance(m, Conv):
            m.precision = precision
    return model


def head_prior(cfg, level: int) -> float:
    """The class logits' starting bias at a level: about 5 objects per
    image over the level's cells at 640 px."""
    return math.log(5 / cfg["num_classes"] / (640 / STRIDES[level]) ** 2)


def forward_flops(cfg, image_hw) -> int:
    """Forward FLOPs of one image (2 x the multiply-adds of every conv),
    counted from the architecture on the meta device."""
    from torch.utils.flop_counter import FlopCounterMode

    with torch.device("meta"):
        model = Detector(cfg).eval()
        x = torch.empty(1, 3, *image_hw)
    counter = FlopCounterMode(display=False)
    with counter, torch.no_grad():
        model(x)
    return counter.get_total_flops()
