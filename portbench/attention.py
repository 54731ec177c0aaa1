"""What the attention metrics read: the counts of the forward's attention on
the program's ``serve/model`` spans, and the attention kernels of the trace.

The program (``yolo_ms_tpu_torch/ops/attention.py``) states the names of
the kernels its attention launches (``KERNEL``, once a call; ``KERNELS``,
every kernel of a call) and counts its calls on ``serve/model``:
``attn_calls``, ``attn_rows`` (sequences x tokens), ``attn_scores``
(sequences x tokens**2) and ``attn_head_dim``. A program or a model
without them gives nothing to read, and the readers return None; so does a
trace without device operations (the CPU rehearsal).
"""

from __future__ import annotations

import torch

from portbench.spans import stretch_spans
from portbench.yardstick import BF16_DENSE_PEAK, peak_rates

BF16_BYTES = 2


def counts(trace) -> list:
    """The attention counts of each ``serve/model`` span in the stretch."""
    return [s.counts for s in stretch_spans(trace)
            if s.name == "serve/model" and s.counts.get("attn_calls")]


def attention_bound_ms(found: dict, card: str) -> float:
    """The least time (ms) the card could take for one forward's attention
    calls: 4 x head_dim x scores FLOPs (q k^T and the product with v) over
    the dense bf16 peak, or bf16 q, k, v and the output, read or written
    once (2 B x 4 x head_dim x rows), over the memory rate; the larger."""
    mem_rate, _ = peak_rates(card)
    d = found["attn_head_dim"]
    flops = 4 * d * found["attn_scores"]
    nbytes = BF16_BYTES * 4 * d * found["attn_rows"]
    return max(flops / BF16_DENSE_PEAK, nbytes / mem_rate) * 1e3


def attn_ms(trace):
    """Device ms of the attention kernels per call; raises where the
    profile holds another number of attention launches than the spans
    counted calls."""
    found = counts(trace)
    if not found or not trace.ops:
        return None
    from yolo_ms_tpu_torch.ops import attention

    launched = sum(bool(attention.KERNEL.search(o.name)) for o in trace.ops)
    calls = sum(c["attn_calls"] for c in found)
    if launched != calls:
        raise RuntimeError(f"the profile holds {launched} attention kernels, but the spans "
                           f"counted {calls} attention calls: it lost events, or another "
                           "backend ran")
    return trace.per_call_ms([o for o in trace.ops if attention.KERNELS.search(o.name)])


def attn_roofline(trace):
    """The attention's bound over its measured time (%)."""
    ms = attn_ms(trace)
    if not ms:
        return None
    card = torch.cuda.get_device_name(0)
    bound = sum(attention_bound_ms(c, card) for c in counts(trace)) / trace.calls
    return bound / ms * 100.0
