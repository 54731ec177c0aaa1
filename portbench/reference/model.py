"""The plain float32 reference of the benchmark's detectors: the pieces every
model family shares, and ``Detector``, which builds a configuration's network
from its family's own file.

A family's architecture lives in ``portbench/reference/arch/<family>.py``,
chosen by the configuration's ``family`` key (``yolov8``, ``yolo-ms``). The
file exposes ``build(cfg) -> nn.Module``, a network that takes normalized
float32 images [B, 3, H, W] and returns, per level at strides 8/16/32, (box
logits [B, 4*reg_max, H, W], class logits [B, nc, H, W]), with the
attributes ``nc`` and ``reg_max``; ``Net`` assembles one. Its module and
parameter names are those of the benchmarked program's state_dicts
(``conv``/``bn`` under every conv block, ``box_{i}``/``cls_{i}`` in the
head), so one seeded state_dict loads into both. A file may also declare
``LEAVES``, the kinds of leaf that ``portbench/weights.py``'s shared rules do
not draw: ``(match, fill)`` pairs, where ``match`` is a name suffix or a
predicate ``(name, shape) -> bool`` and ``fill(flat, generator)`` fills, in
place, one flat tensor that holds every leaf of the kind. A file writes
attention as explicit matmuls and a softmax, never
``F.scaled_dot_product_attention``, which ``forward_flops`` cannot count
(torch's FLOP counter reads it as 0 on the CPU). Nothing here or in a family
file imports the program.

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

A departure from the published models, which the program shares: the class
branch of the head is ``num_classes`` wide (Ultralytics takes
``max(c3, min(nc, 100))``).
"""

from __future__ import annotations

import contextlib
import functools
import importlib.util
import math
import os

import torch
import torch.nn.functional as F
from torch import nn

ARCH = os.path.join(os.path.dirname(os.path.abspath(__file__)), "arch")
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


def up(x):
    return F.interpolate(x, scale_factor=2, mode="nearest")


def stage_blocks(n: int, depth: float) -> int:
    """Blocks of a stage of ``n`` at the depth multiple (Ultralytics' rule)."""
    return max(round(n * depth), 1)


def widths(cfg):
    """The five stage widths of the YOLOv8 plan at the configuration's
    width multiple, the last one scaled by ``last_stage_ratio``."""
    w, r = cfg["width_multiple"], cfg["last_stage_ratio"]
    return int(64 * w), int(128 * w), int(256 * w), int(512 * w), int(512 * w * r)


class Branch(nn.Module):
    def __init__(self, c_in, mid, out):
        super().__init__()
        self.conv1 = ConvBnSiLU(c_in, mid, 3)
        self.conv2 = ConvBnSiLU(mid, mid, 3)
        self.pred = Conv(mid, out, 1)

    def forward(self, x):
        return self.pred(self.conv2(self.conv1(x)))


class Head(nn.Module):
    """YOLOv8's decoupled head over the neck's levels: per level a box branch
    (``box_{i}``, 4 * reg_max wide) and a class branch (``cls_{i}``, nc
    wide), each two 3x3 ConvBnSiLU and a 1x1 conv."""

    def __init__(self, channels, nc, reg_max):
        super().__init__()
        for i, c in enumerate(channels):
            self.add_module(f"box_{i}", Branch(c, 4 * reg_max, 4 * reg_max))
            self.add_module(f"cls_{i}", Branch(c, nc, nc))

    def forward(self, feats):
        return [(getattr(self, f"box_{i}")(f), getattr(self, f"cls_{i}")(f))
                for i, f in enumerate(feats)]


class Net(nn.Module):
    """backbone -> neck -> head under the names of the program's
    state_dicts: image [B, 3, H, W] f32 (normalized) -> per level (box
    logits [B, 4*reg_max, H, W], class logits [B, nc, H, W])."""

    def __init__(self, cfg, backbone, neck, head):
        super().__init__()
        self.nc, self.reg_max = cfg["num_classes"], cfg["reg_max"]
        self.backbone, self.neck, self.head = backbone, neck, head

    def forward(self, x):
        return self.head(self.neck(*self.backbone(x)))


def families() -> list[str]:
    """The families that have a reference file."""
    return sorted(f[:-3] for f in os.listdir(ARCH) if f.endswith(".py"))


@functools.cache
def family(name: str):
    """``portbench/reference/arch/<name>.py`` as a module (names may hold
    hyphens)."""
    if name not in families():
        raise ValueError(f"no reference for the family {name!r}; "
                         f"portbench/reference/arch has {families()}")
    spec = importlib.util.spec_from_file_location(f"portbench_arch_{name.replace('-', '_')}",
                                                  os.path.join(ARCH, f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def Detector(cfg) -> nn.Module:  # noqa: N802 -- the name the drivers import
    """The float32 reference network of ``cfg``, built by its family's file."""
    return family(cfg["family"]).build(cfg)


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
    """Forward FLOPs of one image, counted from the architecture on the meta
    device: 2 x the multiply-adds of every conv and of every matmul
    (``mm``, ``bmm``, ``addmm``), as torch's FLOP counter sees them.
    Elementwise work, pooling, normalization and softmax count nothing. A
    network that calls ``F.scaled_dot_product_attention`` raises, since
    the counter reads it as 0 on the CPU."""
    from torch.utils.flop_counter import FlopCounterMode

    with torch.device("meta"):
        model = Detector(cfg).eval()
        x = torch.empty(1, 3, *image_hw)
    counter = FlopCounterMode(display=False)
    with counter, _NoSdpa(), torch.no_grad():
        model(x)
    return counter.get_total_flops()


class _NoSdpa(torch.overrides.TorchFunctionMode):
    def __torch_function__(self, func, types, args=(), kwargs=None):
        if func is F.scaled_dot_product_attention:
            raise ValueError("forward_flops cannot count F.scaled_dot_product_attention; "
                             "write attention as explicit matmuls and a softmax")
        return func(*args, **(kwargs or {}))
