"""The benchmark's frozen yardsticks: peaks, the kernels' work, the inputs.

Copied from the program's tools so that a later change of the program moves
none of them:

- ``PEAK_RATES``, ``peak_rates``, ``select_bound``, ``nms_bound``,
  ``bound_of`` and the ``NMS_*_OPS`` counts: ``chip_smoke.py`` (the
  operation and byte arithmetic of the ``select`` and NMS kernels from their
  input shapes, and the H100 data-sheet rates);
- ``nms_sweeps``: the sweeps of the exact greedy fixed point for given
  inputs, from ``ops/kernels/nms.py``'s ``nms_fixed_plain``, so that the NMS
  bound counts the sweeps these inputs need whatever the kernel reports;
- ``serving_batch``: ``tools/benchmark.py``'s ``_inputs`` for the ``e2e``
  mode (uint8 pixels from a numpy generator), drawn from the run's seed.

``BF16_DENSE_PEAK`` is the H100 SXM's dense bf16 tensor rate, the
denominator of every MFU.
"""

from __future__ import annotations

import numpy as np
import torch

BF16_DENSE_PEAK = 989e12
# Device memory rate (bytes/s) and f32 rate outside the tensor cores
# (operations/s) by card name, from NVIDIA's data sheets (dense, full power).
PEAK_RATES = (
    ("H100 PCIe", 2.0e12, 51e12),
    ("H100 NVL", 3.9e12, 60e12),
    ("H100", 3.35e12, 67e12),
    ("H200", 4.8e12, 67e12),
)
# f32 operations of the NMS fixed point: per pair j < i of valid boxes (four
# max / min, two widths, two clamps and the product of the intersection, the
# two adds and a subtract of the union, the quotient, the compare), per valid
# box (its area: two widths and a product), and per overlap word of a valid
# row in a sweep (an AND and a test)
NMS_PAIR_OPS, NMS_BOX_OPS, NMS_WORD_OPS = 14, 3, 2


def peak_rates(name: str) -> tuple[float, float]:
    for key, mem, f32 in PEAK_RATES:
        if key in name:
            return mem, f32
    raise RuntimeError(f"no peak rates on record for {name!r}")


def select_bound(shapes, name: str) -> tuple[float, float]:
    """The two least times (ms) the card could take for one ``select_scales``
    call over (box, cls) maps of ``shapes``: per scale ((B, HW, box
    channels, box element bytes), (cls channels, cls element bytes)). Each
    input element read once and 24 B written per anchor (mx, cid, ltrb) over
    the memory rate, and the f32 operations (one compare per class logit; a
    max, subtract, clamp, exp, multiply and two adds per box logit) over the
    f32 rate. The bound is the larger."""
    mem_rate, f32_rate = peak_rates(name)
    nbytes = ops = 0
    for (b, hw, nbox, box_bytes), (ncls, cls_bytes) in shapes:
        n_anchor = b * hw
        nbytes += n_anchor * (nbox * box_bytes + ncls * cls_bytes + 24)
        ops += n_anchor * (ncls + 7 * nbox)
    return nbytes / mem_rate * 1e3, ops / f32_rate * 1e3


def bound_of(bytes_ms: float, ops_ms: float) -> tuple[float, str]:
    return (bytes_ms, "bytes") if bytes_ms >= ops_ms else (ops_ms, "operations")


def nms_bound(scores: torch.Tensor, sweeps: list, name: str) -> tuple[float, float]:
    """The two least times (ms) the card could take for one NMS call over
    boxes [B, K, 4] and scores [B, K] that ran ``sweeps`` per image: 16 B
    of box and 4 B of score read and 1 B of keep written per box, 4 B of
    sweeps per image, over the memory rate; and the operations these inputs
    need (``NMS_*_OPS``, over the valid boxes of each image only: an invalid
    box suppresses nothing and is never kept) over the f32 rate."""
    mem_rate, f32_rate = peak_rates(name)
    b, k = scores.shape
    ops = 0
    for v, n_sweeps in zip((scores > 0).sum(dim=1).tolist(), sweeps):
        words = sum(-(-i // 32) for i in range(v))
        ops += v * (v - 1) // 2 * NMS_PAIR_OPS + v * NMS_BOX_OPS + n_sweeps * words * NMS_WORD_OPS
    return b * (21 * k + 4) / mem_rate * 1e3, ops / f32_rate * 1e3


def _pairwise_iou(boxes: torch.Tensor, eps: float = 1e-7) -> torch.Tensor:
    a, b = boxes[..., :, None, :], boxes[..., None, :, :]
    ix1 = torch.maximum(a[..., 0], b[..., 0])
    iy1 = torch.maximum(a[..., 1], b[..., 1])
    ix2 = torch.minimum(a[..., 2], b[..., 2])
    iy2 = torch.minimum(a[..., 3], b[..., 3])
    inter = (ix2 - ix1).clamp(min=0) * (iy2 - iy1).clamp(min=0)
    a1 = (a[..., 2] - a[..., 0]) * (a[..., 3] - a[..., 1])
    a2 = (b[..., 2] - b[..., 0]) * (b[..., 3] - b[..., 1])
    return inter / (a1 + a2 - inter + eps)


@torch.no_grad()
def nms_sweeps(boxes: torch.Tensor, scores: torch.Tensor, iou_thresh: float) -> list:
    """Sweeps per image of the greedy fixed point keep[i] <- valid[i] and no
    kept j < i overlaps i, from keep = valid, its final unchanged sweep
    included, for boxes [B, K, 4] sorted by falling score and scores [B, K]
    (<= 0 marks invalid rows)."""
    b, n = scores.shape
    tri = torch.ones(n, n, dtype=torch.bool, device=boxes.device).tril(-1)
    overlap = ((_pairwise_iou(boxes) > iou_thresh) & tri).float()
    valid = scores > 0.0
    keep = valid
    sweeps = torch.zeros(b, dtype=torch.int32, device=scores.device)
    settled = torch.zeros(b, dtype=torch.bool, device=scores.device)
    for _ in range(n):
        suppressed = torch.bmm(overlap, keep.float().unsqueeze(-1)).squeeze(-1) > 0.0
        new = valid & ~suppressed
        sweeps += (~settled).int()
        settled |= (new == keep).all(dim=-1)
        keep = new
        if bool(settled.all()):
            break
    return sweeps.tolist()


def serving_batch(rng: np.random.Generator, batch: int, hw) -> np.ndarray:
    """uint8 NHWC pixels [batch, H, W, 3], uniform over 0..255."""
    return rng.integers(0, 256, (batch, *hw, 3), dtype=np.uint8)

