"""Area attention (YOLOv12's ``AAttn``) on the output of its qkv conv.

``area_attention(qkv, heads, area)`` takes the qkv conv's map [B, 3C, H, W]
and returns (the attention's output, ``v``), each [B, C, H, W]. The tokens
are the map's pixels flattened row-major, cut into ``area`` contiguous runs
of H*W/area tokens; a token's 3C channels read as ``[heads, (q | k | v),
C/heads]``; each (image, run, head) is one softmax attention with scale
``(C/heads)**-0.5``, ``F.scaled_dot_product_attention`` on [B*area, heads,
tokens, C/heads] views. Output and ``v`` come back with channel
``head * C/heads + d``, in the layout of the qkv map.

Channels-last (``infer/layouts.py``), the qkv map is NHWC memory, and each
run of tokens is a contiguous block of it: q, k and v are strided views,
and the attention's output, [B*area, tokens, heads, C/heads] memory, is the
channels-last output map without a copy. ``v`` is copied once, into the
layout of the 7x7 depthwise conv that reads it. In the default layout the
qkv map is copied into NHWC first, and both results back into NCHW.

SDPA runs with FlashAttention alone (``sdpa_kernel``), so that the card
runs one known kernel a call: ``KERNEL`` matches it (FlashAttention-2's
forward; split over the keys, as small batches may be, a second kernel,
also matched by ``KERNELS``, combines the splits).

Each call is counted inside ``utils/profiler.py:counted()``, as the span
``serve/model`` carries the counts (``infer/graphs.py``): ``attn_calls``;
``attn_rows``, the sum over calls of sequences x tokens, where sequences =
images x runs x heads; ``attn_scores``, the sum of sequences x tokens**2;
and ``attn_head_dim``.
"""

from __future__ import annotations

import re

import torch
import torch.nn.functional as F
from torch.nn.attention import SDPBackend, sdpa_kernel

from yolo_ms_tpu_torch.utils.profiler import add_counts, open_counts

# the kernel that one call launches on the card, once, and every kernel of a call
KERNEL = re.compile(r"\bflash_fwd(_splitkv)?_kernel\b")
KERNELS = re.compile(r"\bflash_fwd")

def _count(sequences: int, tokens: int, head_dim: int) -> None:
    counts = open_counts()
    if counts is None:
        return
    counts["attn_head_dim"] = head_dim  # one width in every YOLOv12 block
    add_counts(attn_calls=1, attn_rows=sequences * tokens,
               attn_scores=sequences * tokens * tokens)


def area_attention(qkv: torch.Tensor, heads: int, area: int) -> tuple[torch.Tensor, torch.Tensor]:
    """qkv [B, 3C, H, W] -> (attention output, v), each [B, C, H, W],
    channels-last from a channels-last map, else contiguous NCHW."""
    b, c3, h, w = qkv.shape
    c = c3 // 3
    d, n = c // heads, h * w
    # NHWC memory: a view of a channels-last map, a copy of any other
    tokens = qkv.permute(0, 2, 3, 1).contiguous().view(b * area, n // area, heads, 3, d)
    q, k, v = (t.transpose(1, 2) for t in tokens.unbind(3))  # [B*area, heads, tokens, d]
    _count(b * area * heads, n // area, d)
    with sdpa_kernel(SDPBackend.FLASH_ATTENTION):
        out = F.scaled_dot_product_attention(q, k, v)
    out = out.transpose(1, 2).reshape(b, h, w, c).permute(0, 3, 1, 2)
    v = v.transpose(1, 2).reshape(b, h, w, c).permute(0, 3, 1, 2)
    if qkv.is_contiguous(memory_format=torch.channels_last):
        return out, v
    return out.contiguous(), v.contiguous()
