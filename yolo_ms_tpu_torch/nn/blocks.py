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
On the card a deploy ``ConvBnSiLU`` runs its conv without the bias and
adds the bias and SiLU in one pass, in place (``ops/kernels/epilogue.py``;
it has no backward); off the card it runs torch's conv with its bias, then
``F.silu``. Inside ``utils/profiler.py:counted()`` it counts
``conv_biased`` (deploy convs run) and ``conv_epilogues`` (those whose
epilogue ran in the kernel).

Height sharding (``set_spatial_group``): the JAX package splits the image
height over a mesh axis and GSPMD inserts the halo exchanges. Here every
module that reads rows beyond its own (a conv of kernel > 1, a max pool, an
upsample, the ``SqueezeExcite`` mean, the head's maps), or that cannot take
the empty shard of a level with fewer rows than ranks (every conv), holds a
``spatial_rows`` handle per input (``parallel/spatial.py:Rows``), None by
default; it exchanges rows only inside a sharded forward and runs its plain
op otherwise.

The YOLOv12 blocks at the end (``C3k``, ``C3k2``, ``AAttn``, ``ABlock``,
``A2C2f``) have no JAX counterpart; they follow Ultralytics' modules.

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

from yolo_ms_tpu_torch.ops.attention import area_attention
from yolo_ms_tpu_torch.ops.kernels.epilogue import conv_epilogue
from yolo_ms_tpu_torch.parallel.distributed import all_reduce_sum
from yolo_ms_tpu_torch.parallel.spatial import Rows
from yolo_ms_tpu_torch.utils.profiler import add_counts

# BatchNorm constants of the reference (components.py:73).
BN_EPS = 1e-3
BN_MOMENTUM = 0.03  # torch momentum; flax decay 0.97
DEFAULT_STRIDES: tuple[int, ...] = (8, 16, 32)  # the head's three scales


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

    With ``process_group`` set (a group of more than one rank, set by
    ``set_batch_norm_group``; None by default) the train-mode statistics
    are those of the GLOBAL batch, as under the JAX package's data-parallel
    mesh: per channel the f32 sum, sum of squares and count are summed over
    the ranks by one differentiable all-reduce (its backward sums the
    statistics' gradients over the ranks), and the variance is flax's fast
    one, ``max(E[x^2] - E[x]^2, 0)``, biased. ``nn.SyncBatchNorm`` is not
    used: it moves ``running_var`` with the unbiased variance.
    """

    process_group = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return super().forward(x)
        if self.process_group is not None:
            return self._global_batch_forward(x, self.process_group)
        y, mean, invstd = torch.native_batch_norm(
            x, self.weight, self.bias, None, None, True, 0.0, self.eps
        )
        with torch.no_grad():
            var = invstd.pow(-2) - self.eps  # the biased batch variance
            m = self.momentum
            self.running_mean.mul_(1.0 - m).add_(mean, alpha=m)
            self.running_var.mul_(1.0 - m).add_(var, alpha=m)
        return y

    def _global_batch_forward(self, x: torch.Tensor, group) -> torch.Tensor:
        c = x.shape[1]
        xf = x.to(torch.promote_types(x.dtype, torch.float32))  # f32 for bf16 input
        local = torch.cat([
            xf.sum((0, 2, 3)),
            (xf * xf).sum((0, 2, 3)),
            xf.new_full((1,), x.numel() // c),
        ])
        total = all_reduce_sum(local, group)
        n = total[2 * c]
        mean = total[:c] / n
        var = (total[c : 2 * c] / n - mean * mean).clamp(min=0.0)
        scale = self.weight * torch.rsqrt(var + self.eps)
        shift = self.bias - mean * scale
        y = xf * scale[None, :, None, None] + shift[None, :, None, None]
        with torch.no_grad():
            m = self.momentum
            self.running_mean.mul_(1.0 - m).add_(mean, alpha=m)
            self.running_var.mul_(1.0 - m).add_(var, alpha=m)
        return y.to(x.dtype)


def set_batch_norm_group(model: nn.Module, group) -> nn.Module:
    """Set ``process_group`` on every ``BatchNorm2d`` of ``model``: the
    group whose global batch its train-mode statistics are taken over, or
    None for this process's batch alone. Returns ``model``."""
    for m in model.modules():
        if isinstance(m, BatchNorm2d):
            m.process_group = group
    return model


# the height of the probe image through which ``set_spatial_group`` finds
# each site's stride: every model's five stride-2 levels divide it
SPATIAL_PROBE = 64


def set_spatial_group(model: nn.Module, mesh) -> nn.Module:
    """Make ``model`` run height-sharded over the spatial group of
    ``mesh`` (``parallel/mesh.py:make_mesh_2d``) inside
    ``mesh.shards.rows(image_h)``, and plain outside it; a mesh whose
    spatial axis is 1, or None, makes it plain everywhere. Returns
    ``model``.

    Each site learns the stride of its inputs (image rows per map row) from
    one no-grad eval forward of a ``SPATIAL_PROBE``-high image, run plain;
    during a sharded forward its level is ``image_h // stride`` rows high.
    The BatchNorm statistics need no site: under ``set_batch_norm_group``
    with the world group, they are sums and counts over both axes, and an
    empty shard adds 0 to each."""
    sites = [m for m in model.modules() if hasattr(m, "spatial_rows")]
    for m in sites:
        m.spatial_rows = None
    if mesh is None or mesh.spatial == 1:
        return model
    heights = {}

    def record(module, args):
        flat = [a for x in args for a in (x if isinstance(x, (tuple, list)) else (x,))]
        heights.setdefault(module, [a.shape[2] for a in flat if isinstance(a, torch.Tensor)])

    hooks = [m.register_forward_pre_hook(record) for m in sites]
    p = next(model.parameters())
    was_training = model.training
    try:
        with torch.no_grad():
            model.eval()(torch.zeros(1, 3, SPATIAL_PROBE, SPATIAL_PROBE, dtype=p.dtype,
                                     device=p.device))
    finally:
        model.train(was_training)
        for h in hooks:
            h.remove()
    for m in sites:
        m.spatial_rows = [Rows(mesh.shards, SPATIAL_PROBE // h) for h in heights[m]]
    return model


def sharded_rows(module: nn.Module, i: int = 0) -> Rows | None:
    """The ``Rows`` of input ``i`` of ``module`` inside a sharded forward,
    else None."""
    rows = module.spatial_rows
    return rows[i] if rows is not None and rows[i].active else None


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` whose call can leave its bias out (``bias=False``), for
    a caller that adds it in its own epilogue; hooks fire either way."""

    def forward(self, x: torch.Tensor, bias: bool = True) -> torch.Tensor:
        return self._conv_forward(x, self.weight, self.bias if bias else None)


class ConvBnSiLU(nn.Module):
    """Conv2d(bias=False) -> BatchNorm2d(eps 1e-3) -> SiLU (optional).

    Grouped and depthwise convs are plain ``groups=``; padding is k//2 on
    every side, stride 1 or 2, as in the JAX block. After ``to_deploy()``
    the conv carries a bias and there is no BatchNorm; the module docstring
    says where its bias and SiLU run.
    """

    spatial_rows = None

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
        self.conv = Conv2d(
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
        rows = sharded_rows(self)
        if self.bn is None and self.conv.bias is not None:  # deploy structure
            add_counts(conv_biased=1, conv_epilogues=int(x.is_cuda))
            if x.is_cuda:
                y = rows.conv2d(self.conv, x, bias=False) if rows else self.conv(x, bias=False)
                return conv_epilogue(y, self.conv.bias, self.act)
        x = rows.conv2d(self.conv, x) if rows else self.conv(x)
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


def maxpool_same(x: torch.Tensor, window: int, rows: Rows | None = None) -> torch.Tensor:
    """Stride-1 same-padded max pool; the padding is -inf (max_pool2d's
    implicit padding), as the JAX reduce_window. ``rows``: height-sharded."""
    if rows is not None:
        return rows.max_pool(x, window)
    return F.max_pool2d(x, window, stride=1, padding=window // 2)


class SPPF(nn.Module):
    """1x1 reduce -> 3 chained kxk/s1 max pools -> concat -> 1x1."""

    spatial_rows = None

    def __init__(self, c_in: int, features: int, kernel_size: int = 5):
        super().__init__()
        hidden = c_in // 2
        self.kernel_size = kernel_size
        self.conv1 = ConvBnSiLU(c_in, hidden, 1)
        self.conv2 = ConvBnSiLU(4 * hidden, features, 1)

    def forward(self, x):
        rows = sharded_rows(self)
        x = self.conv1(x)
        x1 = maxpool_same(x, self.kernel_size, rows)
        x2 = maxpool_same(x1, self.kernel_size, rows)
        x3 = maxpool_same(x2, self.kernel_size, rows)
        return self.conv2(torch.cat([x, x1, x2, x3], dim=1))


def upsample2x(x: torch.Tensor, rows: Rows | None = None) -> torch.Tensor:
    """Nearest-neighbour 2x upsample (pixel duplication), NCHW. ``rows``:
    height-sharded."""
    if rows is not None:
        return rows.upsample2x(x)
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

    spatial_rows = None

    def __init__(self, features: int, ratio: float = 0.25):
        super().__init__()
        hidden = max(8, int(features * ratio))
        self.reduce = nn.Conv2d(features, hidden, 1)
        self.expand = nn.Conv2d(hidden, features, 1)

    def forward(self, x):
        rows = sharded_rows(self)
        s = rows.mean(x) if rows else x.mean(dim=(2, 3), keepdim=True)
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

    spatial_rows = None

    def __init__(self, c_in: int, features: int, kernel_size: int = 5):
        super().__init__()
        hidden = c_in // 2
        self.kernel_size = kernel_size
        self.conv1 = ConvBnSiLU(c_in, hidden, 1)
        self.dw = ConvBnSiLU(hidden, hidden, 3, groups=hidden)
        self.conv2 = ConvBnSiLU(4 * hidden, features, 1)

    def forward(self, x):
        rows = sharded_rows(self)
        x = self.dw(self.conv1(x))
        x1 = maxpool_same(x, self.kernel_size, rows)
        x2 = maxpool_same(x1, self.kernel_size, rows)
        x3 = maxpool_same(x2, self.kernel_size, rows)
        return self.conv2(torch.cat([x, x1, x2, x3], dim=1))


class MSFusion(nn.Module):
    """concat([a, b]) -> 1x1 ConvBnSiLU; ``upsample_a`` first doubles ``a``.

    The JAX deploy graph contracts the ``a`` rows at the small resolution
    (``_UpsampleConcatConv1x1``); here it is the plain upsample + concat +
    conv on the same parameters."""

    spatial_rows = None

    def __init__(self, c_in: int, features: int):
        super().__init__()
        self.fuse = ConvBnSiLU(c_in, features, 1)

    def forward(self, a, b, upsample_a: bool = False):
        if upsample_a:
            a = upsample2x(a, sharded_rows(self))
        return self.fuse(torch.cat([a, b], dim=1))


# --------------------------------------------------------------------------
# YOLOv12 family blocks (no JAX counterpart)
# --------------------------------------------------------------------------


class C3k(nn.Module):
    """C3 with two 3x3/3x3 residual bottlenecks at half width: 1x1 ``conv1``
    -> ``m_0`` -> ``m_1``, concatenated with 1x1 ``conv2`` of the input ->
    1x1 ``conv3``."""

    def __init__(self, c_in: int, features: int):
        super().__init__()
        mid = features // 2
        self.conv1 = ConvBnSiLU(c_in, mid, 1)
        self.conv2 = ConvBnSiLU(c_in, mid, 1)
        self.conv3 = ConvBnSiLU(2 * mid, features, 1)
        self.m_0 = Bottleneck(mid)
        self.m_1 = Bottleneck(mid)

    def forward(self, x):
        y = self.m_1(self.m_0(self.conv1(x)))
        return self.conv3(torch.cat([y, self.conv2(x)], dim=1))


class C3k2(nn.Module):
    """C2f's split with ``C3k`` blocks (YOLOv12 at scales m, l, x): 1x1 to
    two halves of ``int(features * e)``, each block on the last output,
    concat in Ultralytics' order [a, b, m_0(b), m_1(m_0(b)), ...] -> 1x1."""

    def __init__(self, c_in: int, features: int, n: int, e: float = 0.5):
        super().__init__()
        self.mid = int(features * e)
        self.n = n
        self.conv1 = ConvBnSiLU(c_in, 2 * self.mid, 1)
        for i in range(n):
            self.add_module(f"m_{i}", C3k(self.mid, self.mid))
        self.conv2 = ConvBnSiLU((2 + n) * self.mid, features, 1)

    def forward(self, x):
        y = list(self.conv1(x).split(self.mid, dim=1))
        for i in range(self.n):
            y.append(getattr(self, f"m_{i}")(y[-1]))
        return self.conv2(torch.cat(y, dim=1))


class AAttn(nn.Module):
    """Area attention: ``qkv`` 1x1 (BN, no activation) -> softmax attention
    per (image, area, head) over row-major runs of tokens
    (``ops/attention.py``) -> + ``pe``, a 7x7 depthwise conv of v (BN, no
    activation) -> ``proj`` 1x1 (BN, no activation). Height sharding does
    not split it: a sharded forward raises."""

    spatial_rows = None

    def __init__(self, dim: int, heads: int, area: int = 1):
        super().__init__()
        self.heads = heads
        self.area = area
        self.qkv = ConvBnSiLU(dim, 3 * dim, 1, act=False)
        self.proj = ConvBnSiLU(dim, dim, 1, act=False)
        self.pe = ConvBnSiLU(dim, dim, 7, groups=dim, act=False)

    def forward(self, x):
        if sharded_rows(self):
            raise RuntimeError("area attention reads every row of its map: it cannot run "
                               "height-sharded")
        out, v = area_attention(self.qkv(x), self.heads, self.area)
        return self.proj(out + self.pe(v))


class ABlock(nn.Module):
    """``x + attn(x)``, then ``x + mlp(x)``: 1x1 to ``int(dim * mlp_ratio)``
    with SiLU, 1x1 back with BN and no activation."""

    def __init__(self, dim: int, heads: int, mlp_ratio: float = 1.2, area: int = 1):
        super().__init__()
        self.attn = AAttn(dim, heads, area)
        self.mlp_in = ConvBnSiLU(dim, int(dim * mlp_ratio), 1)
        self.mlp_out = ConvBnSiLU(int(dim * mlp_ratio), dim, 1, act=False)

    def forward(self, x):
        x = x + self.attn(x)
        return x + self.mlp_out(self.mlp_in(x))


class A2C2f(nn.Module):
    """R-ELAN (YOLOv12): 1x1 ``conv1`` to ``features // 2``, ``n`` stages
    on the last output, 1x1 ``conv2`` over the concat of ``conv1``'s output
    and every stage's. With an ``area`` a stage is two ``ABlock`` of heads
    of 32 channels, and the block returns ``x + gamma * conv2(...)``,
    ``gamma`` a per-channel parameter (initially 0.01) that BN folding
    leaves as it is; without, a stage is one ``C3k``."""

    def __init__(self, c_in: int, features: int, n: int, area: int | None = None,
                 mlp_ratio: float = 1.2):
        super().__init__()
        mid = features // 2
        self.n = n
        self.conv1 = ConvBnSiLU(c_in, mid, 1)
        for i in range(n):
            stage = (C3k(mid, mid) if area is None else
                     nn.Sequential(*(ABlock(mid, mid // 32, mlp_ratio, area) for _ in range(2))))
            self.add_module(f"m_{i}", stage)
        self.conv2 = ConvBnSiLU((1 + n) * mid, features, 1)
        self.gamma = None if area is None else nn.Parameter(torch.full((features,), 0.01))

    def forward(self, x):
        y = [self.conv1(x)]
        for i in range(self.n):
            y.append(getattr(self, f"m_{i}")(y[-1]))
        y = self.conv2(torch.cat(y, dim=1))
        return y if self.gamma is None else x + self.gamma[None, :, None, None] * y
