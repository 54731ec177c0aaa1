"""What the per-layer metrics read from a ``Trace`` (``trace.py``).

Each metric file under ``metrics/`` binds one of these to its name. A
reader that finds nothing to read returns None, and the metric is left out
of the run's line; a share of a roofline or of a peak is never 0.
"""

from __future__ import annotations

import re

from portbench.yardstick import BF16_DENSE_PEAK

SELECT_KERNEL = re.compile(r"\bselect(_wide)?_kernel\b")
NMS_KERNEL = re.compile(r"\bnms_kernel\b")


def _share(numerator: float, denominator: float):
    return numerator / denominator * 100.0 if numerator > 0 and denominator > 0 else None


def copy_ms(trace):
    """Device time of the host-to-device and device-to-host copies of one
    ``predict_batch`` call (ms)."""
    ops = [o for o in trace.ops if o.kind == "memcpy" and trace.within(o, "portbench/predict_batch")]
    return trace.per_call_ms(ops) if ops else None


def ops_per_call(trace):
    """Device operations (kernels, copies, memsets) per call or step."""
    return len(trace.ops) / trace.calls if trace.ops else None


def range_ms(trace, name: str):
    """Device time of the operations enqueued inside the range ``name``,
    per call or step (ms)."""
    ops = [o for o in trace.ops if trace.within(o, name)]
    return trace.per_call_ms(ops) if ops else None


def forward_ms(trace):
    """Device time of the kernels enqueued inside the model call, per
    ``predict_batch`` call (ms)."""
    ops = [o for o in trace.ops if o.kind == "kernel" and trace.within(o, "portbench/model")]
    return trace.per_call_ms(ops) if ops else None


def postprocess_ms(trace):
    """Device time of the kernels enqueued inside ``infer`` after the model
    call returned, per call (ms): the serving tail."""
    ends = sorted(e for _, e in trace.ranges.get("portbench/model", ()))
    infers = trace.ranges.get("portbench/infer", ())
    ops = []
    for o in trace.ops:
        if o.kind != "kernel":
            continue
        for s, e in infers:
            if s <= o.launch_ns <= e and any(s <= m < o.launch_ns for m in ends):
                ops.append(o)
                break
    return trace.per_call_ms(ops) if ops else None


def _roofline(trace, pattern, bound_key):
    ops = [o for o in trace.ops if pattern.search(o.name)]
    if not ops:
        return None
    return _share(trace.extra[bound_key], trace.per_call_ms(ops))


def select_roofline(trace):
    """The frozen ``select_bound`` over the ``select`` kernel's time (%)."""
    return _roofline(trace, SELECT_KERNEL, "select_bound_ms")


def nms_roofline(trace):
    """The frozen ``nms_bound`` (the sweeps these inputs need) over the NMS
    kernel's time (%)."""
    return _roofline(trace, NMS_KERNEL, "nms_bound_ms")


def mfu(trace, passes: int):
    """``passes`` x the reference architecture's forward FLOPs per image x
    the stretch's images per second, over the dense bf16 peak (%)."""
    flops = passes * trace.extra["flops_per_image"] * trace.images / trace.window_s
    return _share(flops, BF16_DENSE_PEAK)


def device_idle_pct(trace):
    """Share of the stretch in which no kernel, copy or memset ran (%)."""
    return (1.0 - trace.busy_ns / trace.window_ns) * 100.0 if trace.window_ns else None
