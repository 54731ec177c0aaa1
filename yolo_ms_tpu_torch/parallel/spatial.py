"""Height (spatial) sharding written by hand: the halo exchange around every
conv and pool, the spatial mean, and the gather of the head's maps.

The JAX package shards the image height over the ``"spatial"`` axis of its
2-D mesh and lets GSPMD insert the halo exchanges, the spatial reductions
and the cross-axis collectives (``yolo_ms_tpu/parallel/mesh.py:56-101``).
torch has no GSPMD, so this module does that work with explicit messages
between the ranks of one spatial group (``parallel/mesh.py``):

- **Row partition.** A map of global height ``h`` at one level is split
  over the ``S`` ranks of the group: shard ``s`` owns rows
  ``[floor(s*h/S), floor((s+1)*h/S))``. Every height is covered, uneven
  splits and empty shards (``h < S``) included; each level is partitioned
  on its own, so a strided conv's output partition is the output level's,
  not half of the input's.
- **gather_rows** returns global rows ``[lo, hi)`` of a partitioned map,
  each from whichever rank owns it (not only a neighbour), and rows outside
  ``[0, h)`` filled (0 for a conv, ``-inf`` for a max pool). Its backward
  sends each received row's gradient back to the row's owner, which adds
  it.
- **gather_maps** is the all-gather of a head map to full height. Its
  backward returns this rank's rows of the incoming gradient, NOT summed
  over the group: every rank of the group computes the same loss from the
  same full maps, and a sum would count the gradient ``S`` times.
- A conv (kernel ``k``, stride ``t``, padding ``p``) gathers the input rows
  ``[o0*t - p, (o1-1)*t - p + k)`` of its output rows ``[o0, o1)`` and pads
  only the width; a same-padded max pool does the same with ``-inf``; the
  nearest 2x upsample maps output row ``o`` to input row ``o // 2``; the
  ``SqueezeExcite`` mean is the local f32 sum, one all-reduce over the
  group, then a division by the global ``h * w``.

Under gloo, each message is staged through the host in its own dtype
(bf16 included; ``parallel/distributed.py:exchange``). Nothing falls back:
a failed message raises. Messages travel as contiguous NCHW; the gathered
rows keep the memory format of the map they extend, so a channels-last
network (``infer/layouts.py``) stays channels-last and its head's maps
reach ``select`` as contiguous NHWC rows.

The model's modules reach this through ``nn/blocks.py:set_spatial_group``,
which gives each site (conv, pool, upsample, mean, head) a ``Rows`` handle
of its level; a handle acts only inside ``HeightShards.rows(image_h)``, the
sharded forward, and the plain ops run otherwise.
"""

from __future__ import annotations

import contextlib
from typing import Callable

import torch
import torch.nn.functional as F
from torch import nn

from yolo_ms_tpu_torch.parallel.distributed import all_reduce_sum, exchange


def row_partition(h: int, shards: int) -> list[tuple[int, int]]:
    """The rows ``[lo, hi)`` that each of ``shards`` ranks owns of height ``h``."""
    return [(s * h // shards, (s + 1) * h // shards) for s in range(shards)]


def conv_rows(out: tuple[int, int], kernel: int, stride: int, pad: int) -> tuple[int, int]:
    """The input rows that output rows ``[o0, o1)`` of a conv or pool read;
    ``(0, 0)`` for no output rows."""
    o0, o1 = out
    if o1 <= o0:
        return (0, 0)
    return (o0 * stride - pad, (o1 - 1) * stride - pad + kernel)


def _overlap(a: tuple[int, int], b: tuple[int, int]) -> tuple[int, int]:
    return max(a[0], b[0]), min(a[1], b[1])


class HeightShards:
    """The spatial group of a mesh: its ranks in order (``ranks``, global),
    this rank's index in it, the row partitions and the exchanges.

    ``image_h`` is the global image height of the sharded forward running
    now (set by ``rows``), None outside one. ``exchanges`` counts the
    exchanges this rank took part in, forward and backward."""

    def __init__(self, group, ranks: list[int], index: int):
        self.group = group
        self.ranks = list(ranks)
        self.size = len(self.ranks)
        self.index = index
        self.image_h: int | None = None
        self.exchanges = 0

    @contextlib.contextmanager
    def rows(self, image_h: int):
        """The sharded forward of images ``image_h`` rows high, whose rows
        ``own(image_h)`` this rank holds."""
        if self.image_h is not None:
            raise RuntimeError("a sharded forward is already running")
        self.image_h = int(image_h)
        try:
            yield self
        finally:
            self.image_h = None

    def own(self, h: int) -> tuple[int, int]:
        """The rows of height ``h`` that this rank owns."""
        return row_partition(h, self.size)[self.index]

    def own_rows(self, x: torch.Tensor, dim: int):
        """This rank's rows of ``x`` (global height ``x.shape[dim]``)."""
        lo, hi = self.own(x.shape[dim])
        return x[(slice(None),) * dim + (slice(lo, hi),)]

    def gather_rows(self, x: torch.Tensor, h: int, needs: list, fill: float) -> torch.Tensor:
        """Global rows ``needs[self.index]`` of the NCHW map ``x`` (this
        rank's rows of height ``h``), where ``needs`` lists the rows that
        every rank of the group asks for in this same call."""
        return _GatherRows.apply(x, self, h, tuple(needs), fill)

    def gather_maps(self, x: torch.Tensor, h: int) -> torch.Tensor:
        """The whole NCHW map of height ``h`` on every rank of the group."""
        return _GatherMaps.apply(x, self, h)

    # --------------------------------------------------------- the exchange

    def _plan(self, h: int, needs: tuple) -> tuple[dict, dict]:
        """``sends[r]`` / ``recvs[r]``: the global rows this rank sends to /
        receives from group index ``r`` for ``needs``."""
        part = row_partition(h, self.size)
        own, want = part[self.index], needs[self.index]
        sends, recvs = {}, {}
        for r in range(self.size):
            if r == self.index:
                continue
            out, got = _overlap(needs[r], own), _overlap(want, part[r])
            if out[0] < out[1]:
                sends[r] = out
            if got[0] < got[1]:
                recvs[r] = got
        return sends, recvs

    def _send_recv(self, sends: dict, recvs: dict) -> dict:
        """Send ``sends[r]`` to group index ``r`` and receive into the empty
        tensors ``recvs[r]``; counts one exchange."""
        exchange({self.ranks[r]: t for r, t in sends.items()},
                 {self.ranks[r]: t for r, t in recvs.items()}, self.group)
        self.exchanges += 1
        return recvs


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, shards: HeightShards, h: int, needs: tuple, fill: float):
        ctx.shards, ctx.h, ctx.needs, ctx.own_rows = shards, h, needs, x.shape[2]
        own = shards.own(h)
        if x.shape[2] != own[1] - own[0]:
            raise ValueError(f"rank {shards.index} holds {x.shape[2]} rows of a map {h} "
                             f"rows high; it owns rows {own}")
        lo, hi = needs[shards.index]
        b, c, _, w = x.shape
        send, recv = shards._plan(h, needs)
        got = shards._send_recv(
            {r: x[:, :, a - own[0] : e - own[0]] for r, (a, e) in send.items()},
            {r: x.new_empty(b, c, e - a, w) for r, (a, e) in recv.items()})
        if hi <= lo:
            return x.new_empty(b, c, 0, w)
        # a channel stride of 1 is channels-last memory: the rows from other
        # ranks and the fill take it too, so that the concatenation keeps it
        fmt = torch.channels_last if x.stride(1) == 1 and c > 1 else torch.contiguous_format
        pieces = []
        if lo < 0:
            pieces.append(x.new_full((b, c, min(hi, 0) - lo, w), fill).contiguous(
                memory_format=fmt))
        for r, span in enumerate(row_partition(h, shards.size)):
            a, e = _overlap((lo, hi), span)
            if a < e:
                pieces.append(x[:, :, a - own[0] : e - own[0]] if r == shards.index
                              else got[r].contiguous(memory_format=fmt))
        if hi > h:
            pieces.append(x.new_full((b, c, hi - max(lo, h), w), fill).contiguous(
                memory_format=fmt))
        return torch.cat(pieces, dim=2)

    @staticmethod
    def backward(ctx, grad):
        shards, h, needs = ctx.shards, ctx.h, ctx.needs
        own, (lo, _) = shards.own(h), needs[shards.index]
        send, recv = shards._plan(h, needs)
        b, c, _, w = grad.shape
        # the transpose: the gradient of every row received goes back to
        # its owner, which adds the gradients of the rows it sent
        back = shards._send_recv(
            {r: grad[:, :, a - lo : e - lo] for r, (a, e) in recv.items()},
            {r: grad.new_empty(b, c, e - a, w) for r, (a, e) in send.items()})
        gx = grad.new_zeros(b, c, ctx.own_rows, w)
        a, e = _overlap((lo, lo + grad.shape[2]), own)
        if a < e:
            gx[:, :, a - own[0] : e - own[0]] += grad[:, :, a - lo : e - lo]
        for r, (a, e) in send.items():
            gx[:, :, a - own[0] : e - own[0]] += back[r]
        return gx, None, None, None, None


class _GatherMaps(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, shards: HeightShards, h: int):
        ctx.own = shards.own(h)
        return _GatherRows.forward(ctx, x, shards, h, ((0, h),) * shards.size, 0.0)

    @staticmethod
    def backward(ctx, grad):
        # every rank of the group holds the same loss of the same full map:
        # this rank's rows of its gradient are this rank's share, unsummed
        lo, hi = ctx.own
        return grad[:, :, lo:hi], None, None


def _min_rows(fn: Callable, x: torch.Tensor, rows: int) -> torch.Tensor:
    """``fn(x)``; where ``x`` has fewer than ``rows`` rows (an empty shard)
    ``fn`` runs on zero rows padded up to ``rows`` and keeps none of its
    output, so that the output stays in the autograd graph of ``x`` and of
    the weights: the exchange that produced ``x`` must take part in the
    backward on every rank."""
    if x.shape[2] >= rows:
        return fn(x)
    return fn(F.pad(x, (0, 0, 0, rows - x.shape[2])))[:, :, :0]


class Rows:
    """A site of a height-sharded forward: a map ``stride`` image rows per
    row. Its height is ``image_h // stride`` while ``shards.rows`` runs;
    ``active`` is False outside, where the module runs its plain op."""

    def __init__(self, shards: HeightShards, stride: int):
        self.shards = shards
        self.stride = stride

    @property
    def active(self) -> bool:
        return self.shards.image_h is not None

    @property
    def height(self) -> int:
        image_h = self.shards.image_h
        if image_h % self.stride:
            raise ValueError(f"an image {image_h} rows high has no level at stride "
                             f"{self.stride}")
        return image_h // self.stride

    def _gather_for(self, x, h_out: int, kernel: int, stride: int, pad: int, fill: float):
        needs = [conv_rows(o, kernel, stride, pad) for o in row_partition(h_out, self.shards.size)]
        return self.shards.gather_rows(x, self.height, needs, fill)

    def conv2d(self, conv: nn.Conv2d, x: torch.Tensor, bias: bool = True) -> torch.Tensor:
        """``conv(x)`` on this rank's rows of the output level (a 1x1
        stride-1 conv reads only its own rows, and exchanges none); with
        ``bias=False`` without the conv's bias."""
        (k, kw), (t, tw), (p, pw) = conv.kernel_size, conv.stride, conv.padding
        xe = x
        if (k, t) != (1, 1):
            h_out = (self.height + 2 * p - k) // t + 1
            xe = self._gather_for(x, h_out, k, t, p, 0.0)
        b = conv.bias if bias else None
        return _min_rows(lambda z: F.conv2d(z, conv.weight, b, (t, tw), (0, pw),
                                            conv.dilation, conv.groups), xe, k)

    def max_pool(self, x: torch.Tensor, window: int) -> torch.Tensor:
        """The stride-1 same-padded max pool, its padding ``-inf``."""
        p = window // 2
        xe = self._gather_for(x, self.height, window, 1, p, float("-inf"))
        return _min_rows(lambda z: F.max_pool2d(z, window, stride=1, padding=(0, p)), xe, window)

    def upsample2x(self, x: torch.Tensor) -> torch.Tensor:
        """The nearest 2x upsample: output row ``o`` is input row ``o // 2``."""
        o0, o1 = self.shards.own(2 * self.height)
        needs = [(a // 2, (e - 1) // 2 + 1) if e > a else (0, 0)
                 for a, e in row_partition(2 * self.height, self.shards.size)]
        xe = self.shards.gather_rows(x, self.height, needs, 0.0)
        up = _min_rows(lambda z: F.interpolate(z, scale_factor=2, mode="nearest"), xe, 1)
        lo = 2 * needs[self.shards.index][0]
        return up[:, :, o0 - lo : o1 - lo]

    def mean(self, x: torch.Tensor) -> torch.Tensor:
        """The mean over the global height and the width, [B, C, 1, 1]."""
        total = all_reduce_sum(x.float().sum((2, 3), keepdim=True), self.shards.group)
        return (total / (self.height * x.shape[3])).to(x.dtype)

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        """The whole map on every rank of the group."""
        return self.shards.gather_maps(x, self.height)


def serve_height_sharded(serve: Callable, images: torch.Tensor, mesh) -> dict:
    """Serve a batch split by image height over the spatial group of
    ``mesh``, the counterpart of the JAX package's ``spatial_sharding``
    serving (``tests/test_spatial_sharding.py:21``).

    ``serve`` maps NHWC images to the detection dict (``Predictor.infer``
    or a ``ServingProgram``) and its model was given
    ``set_spatial_group(model, mesh)``; ``images`` [B, H, W, 3] is the whole
    batch, the same on every rank of the group. Each rank runs the forward
    on its rows, the head's maps are gathered to full height, and every rank
    runs the post-process on them (one ``select`` launch each) and returns
    the same detections."""
    shards = mesh.shards
    with shards.rows(images.shape[1]):
        return serve(shards.own_rows(images, 1))
