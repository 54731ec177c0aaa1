"""Primitive blocks as torch ``nn.Module``s, NCHW inside the network.

Port of ``yolo_ms_tpu/nn/blocks.py``. Same math and the same parameter
names: every submodule is named after its flax path, so a flax variable
tree maps onto a state_dict by renaming and transposing alone
(``utils/convert.py``). Unlike flax, torch convs need their input width, so
every block takes ``c_in`` first.

Train mode follows flax: ``BatchNorm2d`` normalizes with the biased batch
variance (as torch does) and also updates ``running_var`` with it (torch's
``nn.BatchNorm2d`` would use the unbiased one), with flax's decay 0.97.

Deploy structure (BN folded into the conv) is a property of the module,
not a global context: ``ConvBnSiLU.to_deploy()`` gives the conv a bias and
drops its BatchNorm (``models/deploy.py`` folds the state_dict to match).

XLA-only constructs of the JAX package are not ported:
- ``optimization_barrier`` / ``dw_isolation`` (fusion fences for XLA) are
  the identity here;
- the deploy-only ``_UpsampleConcatConv1x1`` split contraction is plain
  upsample + concat + 1x1 conv, with the same parameter layout (exact up to
  rounding).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

# BatchNorm constants of the reference (components.py:73).
BN_EPS = 1e-3
BN_MOMENTUM = 0.03  # torch momentum; flax decay 0.97


def yolo_params(version: str) -> tuple[float, float, float]:
    """(depth, width, ratio) multipliers per YOLOv8 version."""
    table = {
        "n": (1 / 3, 1 / 4, 2.0),
        "s": (1 / 3, 1 / 2, 2.0),
        "m": (2 / 3, 3 / 4, 1.5),
        "l": (1.0, 1.0, 1.0),
        "x": (1.0, 1.25, 1.0),
    }
    if version not in table:
        raise ValueError(f"Unknown YOLOv8 version: {version}")
    return table[version]


class BatchNorm2d(nn.BatchNorm2d):
    """``nn.BatchNorm2d`` (same state_dict) with flax's train-mode update.

    In train mode the output is normalized with the batch mean and biased
    variance, and the running statistics move by
    ``stat = 0.97 * stat + 0.03 * batch_stat`` with the BIASED batch
    variance, as flax's ``nn.BatchNorm`` does. Eval mode reads the running
    statistics. ``num_batches_tracked`` is not used (the momentum is fixed).
    """

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return super().forward(x)
        y, mean, invstd = torch.native_batch_norm(
            x, self.weight, self.bias, None, None, True, 0.0, self.eps
        )
        with torch.no_grad():
            var = invstd.pow(-2) - self.eps  # the biased batch variance
            m = self.momentum
            self.running_mean.mul_(1.0 - m).add_(mean, alpha=m)
            self.running_var.mul_(1.0 - m).add_(var, alpha=m)
        return y


class ConvBnSiLU(nn.Module):
    """Conv2d(bias=False) -> BatchNorm2d(eps 1e-3) -> SiLU (optional).

    Grouped and depthwise convs are plain ``groups=``; padding is k//2 on
    every side, stride 1 or 2, as in the JAX block. After ``to_deploy()``
    the conv carries a bias and there is no BatchNorm.
    """

    def __init__(
        self,
        c_in: int,
        features: int,
        kernel_size: int = 3,
        stride: int = 1,
        groups: int = 1,
        act: bool = True,
    ):
        super().__init__()
        self.conv = nn.Conv2d(
            c_in,
            features,
            kernel_size,
            stride,
            kernel_size // 2,
            groups=groups,
            bias=False,
        )
        self.bn = BatchNorm2d(features, eps=BN_EPS, momentum=BN_MOMENTUM)
        self.act = act

    def to_deploy(self) -> None:
        """Switch to deploy structure: conv with bias, no BatchNorm."""
        if self.bn is None:
            return
        conv = self.conv
        conv.bias = nn.Parameter(
            torch.zeros(
                conv.out_channels, dtype=conv.weight.dtype, device=conv.weight.device
            )
        )
        self.bn = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.conv(x)
        if self.bn is not None:
            x = self.bn(x)
        return F.silu(x) if self.act else x


class Bottleneck(nn.Module):
    """Two 3x3 ConvBnSiLU with optional residual add."""

    def __init__(self, features: int, shortcut: bool = True):
        super().__init__()
        self.conv1 = ConvBnSiLU(features, features, 3)
        self.conv2 = ConvBnSiLU(features, features, 3)
        self.shortcut = shortcut

    def forward(self, x):
        y = self.conv2(self.conv1(x))
        return y + x if self.shortcut else y


class C2f(nn.Module):
    """CSP block with two convs; concat in the reference's REVERSE-INSERT
    order [y_n, ..., y_1, x1, x2] (components.py:118)."""

    def __init__(self, c_in: int, features: int, num_bottlenecks: int,
                 shortcut: bool = True):
        super().__init__()
        self.mid = features // 2
        self.n = num_bottlenecks
        self.conv1 = ConvBnSiLU(c_in, features, 1)
        for i in range(num_bottlenecks):
            self.add_module(f"m_{i}", Bottleneck(self.mid, shortcut))
        self.conv2 = ConvBnSiLU(features + num_bottlenecks * self.mid, features, 1)

    def forward(self, x):
        x = self.conv1(x)
        x1, x2 = x[:, : self.mid], x[:, self.mid :]
        outputs = [x1, x2]
        for i in range(self.n):
            x1 = getattr(self, f"m_{i}")(x1)
            outputs.insert(0, x1)
        return self.conv2(torch.cat(outputs, dim=1))


def maxpool_same(x: torch.Tensor, window: int) -> torch.Tensor:
    """Stride-1 same-padded max pool; the padding is -inf (max_pool2d's
    implicit padding), as the JAX reduce_window."""
    return F.max_pool2d(x, window, stride=1, padding=window // 2)


class SPPF(nn.Module):
    """1x1 reduce -> 3 chained kxk/s1 max pools -> concat -> 1x1."""

    def __init__(self, c_in: int, features: int, kernel_size: int = 5):
        super().__init__()
        hidden = c_in // 2
        self.kernel_size = kernel_size
        self.conv1 = ConvBnSiLU(c_in, hidden, 1)
        self.conv2 = ConvBnSiLU(4 * hidden, features, 1)

    def forward(self, x):
        x = self.conv1(x)
        x1 = maxpool_same(x, self.kernel_size)
        x2 = maxpool_same(x1, self.kernel_size)
        x3 = maxpool_same(x2, self.kernel_size)
        return self.conv2(torch.cat([x, x1, x2, x3], dim=1))


def upsample2x(x: torch.Tensor) -> torch.Tensor:
    """Nearest-neighbour 2x upsample (pixel duplication), NCHW."""
    return F.interpolate(x, scale_factor=2, mode="nearest")


def dfl_expectation(dist: torch.Tensor) -> torch.Tensor:
    """[..., 4, reg_max] bin logits -> [..., 4] f32 expectation sum_i(i*p_i).

    The shift is the row max over ALL 4*reg_max logits (softmax is
    shift-invariant per side), and the shifted logits are clamped at -60 so
    no side underflows to 0/0 — exactly the JAX function, which is not a
    per-side softmax where one side trails another by more than 60. The JAX
    [4*reg_max, 8] HIGHEST-precision matmul becomes two f32 sums here.
    """
    *lead, k, reg_max = dist.shape
    x = dist.float().reshape(*lead, k * reg_max)
    c = x.amax(dim=-1, keepdim=True)
    e = torch.exp(torch.clamp(x - c, min=-60.0)).reshape(*lead, k, reg_max)
    bins = torch.arange(reg_max, dtype=torch.float32, device=dist.device)
    return (e * bins).sum(-1) / e.sum(-1)


# --------------------------------------------------------------------------
# YOLO-MS family blocks
# --------------------------------------------------------------------------


class SqueezeExcite(nn.Module):
    """Global-average squeeze -> 1x1 reduce (SiLU) -> 1x1 expand -> sigmoid
    gate. Plain biased convs, so BN folding passes through unchanged."""

    def __init__(self, features: int, ratio: float = 0.25):
        super().__init__()
        hidden = max(8, int(features * ratio))
        self.reduce = nn.Conv2d(features, hidden, 1)
        self.expand = nn.Conv2d(hidden, features, 1)

    def forward(self, x):
        s = x.mean(dim=(2, 3), keepdim=True)
        s = self.expand(F.silu(self.reduce(s)))
        return x * torch.sigmoid(s)


class InvertedBottleneck(nn.Module):
    """1x1 expand -> kxk depthwise -> (optional SE) -> 1x1 project.

    The JAX block's optional optimization barrier around the depthwise conv
    (an XLA fusion fence) is the identity here."""

    def __init__(self, c_in: int, features: int, kernel_size: int,
                 expansion: float = 2.0, use_se: bool = False):
        super().__init__()
        hidden = int(features * expansion)
        self.expand = ConvBnSiLU(c_in, hidden, 1)
        self.dw = ConvBnSiLU(hidden, hidden, kernel_size, groups=hidden)
        self.se = SqueezeExcite(hidden) if use_se else None
        self.project = ConvBnSiLU(hidden, features, 1)

    def forward(self, x):
        y = self.dw(self.expand(x))
        if self.se is not None:
            y = self.se(y)
        return self.project(y)


class MSBlock(nn.Module):
    """Multi-scale block: in 1x1 -> ``num_branches`` channel groups (group 0
    passes through; group i adds the previous branch's output and runs an
    inverted depthwise bottleneck) -> concat -> out 1x1."""

    def __init__(self, c_in: int, features: int, kernel_size: int = 3,
                 num_branches: int = 3, branch_ratio: float = 1.0,
                 expansion: float = 2.0, use_se: bool = False):
        super().__init__()
        bc = max(8, int(features * branch_ratio / num_branches))
        self.bc = bc
        self.num_branches = num_branches
        self.in_conv = ConvBnSiLU(c_in, bc * num_branches, 1)
        for i in range(1, num_branches):
            self.add_module(
                f"branch_{i}",
                InvertedBottleneck(bc, bc, kernel_size, expansion, use_se),
            )
        self.out_conv = ConvBnSiLU(bc * num_branches, features, 1)

    def forward(self, x):
        x = self.in_conv(x)
        bc = self.bc
        chunks = [x[:, i * bc : (i + 1) * bc] for i in range(self.num_branches)]
        outs = [chunks[0]]
        prev = chunks[0]
        for i in range(1, self.num_branches):
            prev = getattr(self, f"branch_{i}")(chunks[i] + prev)
            outs.append(prev)
        return self.out_conv(torch.cat(outs, dim=1))


class MSSPPF(nn.Module):
    """SPPF with a 3x3 depthwise mixer ahead of the pooling chain."""

    def __init__(self, c_in: int, features: int, kernel_size: int = 5):
        super().__init__()
        hidden = c_in // 2
        self.kernel_size = kernel_size
        self.conv1 = ConvBnSiLU(c_in, hidden, 1)
        self.dw = ConvBnSiLU(hidden, hidden, 3, groups=hidden)
        self.conv2 = ConvBnSiLU(4 * hidden, features, 1)

    def forward(self, x):
        x = self.dw(self.conv1(x))
        x1 = maxpool_same(x, self.kernel_size)
        x2 = maxpool_same(x1, self.kernel_size)
        x3 = maxpool_same(x2, self.kernel_size)
        return self.conv2(torch.cat([x, x1, x2, x3], dim=1))


class MSFusion(nn.Module):
    """concat([a, b]) -> 1x1 ConvBnSiLU; ``upsample_a`` first doubles ``a``.

    The JAX deploy graph contracts the ``a`` rows at the small resolution
    (``_UpsampleConcatConv1x1``); here it is the plain upsample + concat +
    conv on the same parameters."""

    def __init__(self, c_in: int, features: int):
        super().__init__()
        self.fuse = ConvBnSiLU(c_in, features, 1)

    def forward(self, a, b, upsample_a: bool = False):
        if upsample_a:
            a = upsample2x(a)
        return self.fuse(torch.cat([a, b], dim=1))
