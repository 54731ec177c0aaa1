"""``serve.epilogue_fused_pct`` and ``serve.epilogue_ms`` on synthetic spans
and traces, on the CPU.

Run from the root of the repository:
``python -m pytest portbench/tests/test_portbench_epilogue_metrics.py -q``.
"""

from __future__ import annotations

import threading
from types import SimpleNamespace

import pytest

from portbench import run
from portbench.trace import STRETCH, Op
from yolo_ms_tpu_torch.utils import profiler

STRETCH_NS = (1_000, 9_000)
KERNEL_NAME = ("void (anonymous namespace)::conv_epilogue_kernel<__nv_bfloat16, __nv_bfloat16, "
               "true, 0, true>((anonymous namespace)::Params)")


def _span(start, counts, name="serve/model"):
    return SimpleNamespace(name=name, counts=counts, start_ns=start, end_ns=start + 10,
                           thread=threading.main_thread().ident)


def _trace(ops=(), calls=2):
    return SimpleNamespace(ranges={STRETCH: [STRETCH_NS]}, calls=calls, ops=list(ops),
                           per_call_ms=lambda found: sum(o.dur_ns for o in found) / 1e6 / calls)


def _read(monkeypatch, metric, recorded, trace):
    monkeypatch.setattr(profiler, "spans", lambda: recorded)
    return run.load_module("metrics", metric).read(trace)


def _op(name, dur_ns):
    return Op(name=name, kind="kernel", start_ns=2_000, dur_ns=dur_ns, launch_ns=2_000)


@pytest.mark.parametrize("counts,want", [
    ([(57, 57), (57, 57)], 100.0),
    ([(205, 205), (205, 0)], 50.0),
    ([(90, 0)], 0.0),  # a forward off the card: every conv took torch's bias add
])
def test_fused_share_over_the_model_spans(monkeypatch, counts, want):
    recorded = [_span(2_000 + 100 * i, {"replayed": 1, "conv_biased": b, "conv_epilogues": e})
                for i, (b, e) in enumerate(counts)]
    recorded.append(_span(500, {"conv_biased": 10, "conv_epilogues": 0}))  # before the stretch
    assert _read(monkeypatch, "serve.epilogue_fused_pct", recorded, _trace()) == want


EPILOGUE_OPS = [_op(KERNEL_NAME, 1_500_000),
                _op(KERNEL_NAME.replace("0, true", "1, false"), 500_000),
                _op("void at::native::vectorized_elementwise_kernel<8, silu>", 9_000_000)]


def test_epilogue_ms_sums_the_kernel_per_call(monkeypatch):
    recorded = [_span(2_000, {"replayed": 1, "conv_biased": 3, "conv_epilogues": 1}),
                _span(2_100, {"replayed": 1, "conv_biased": 3, "conv_epilogues": 1}),
                _span(500, {"conv_biased": 3, "conv_epilogues": 3})]  # before the stretch
    got = _read(monkeypatch, "serve.epilogue_ms", recorded, _trace(EPILOGUE_OPS))
    assert got == pytest.approx(1.0)


@pytest.mark.parametrize("epilogues", [1, 3])
def test_epilogue_ms_raises_where_the_profile_and_the_spans_differ(monkeypatch, epilogues):
    """Two epilogue kernels in the profile against another number counted
    on the spans (events lost, a renamed kernel, a replay that launched
    fewer): an error, not a plausible number."""
    recorded = [_span(2_000, {"replayed": 1, "conv_biased": 3, "conv_epilogues": epilogues})]
    with pytest.raises(RuntimeError, match="epilogue kernels"):
        _read(monkeypatch, "serve.epilogue_ms", recorded, _trace(EPILOGUE_OPS))


@pytest.mark.parametrize("metric", ["serve.epilogue_fused_pct", "serve.epilogue_ms"])
def test_none_where_the_program_counts_no_epilogues(monkeypatch, metric):
    """The parent commit's spans carry no conv counts: both metrics are left
    out (None), whatever the trace holds, and neither raises."""
    ops = [_op(KERNEL_NAME, 1_000_000)]
    for recorded in ([], [_span(2_000, {"replayed": 1})],
                     [_span(2_000, {"replayed": 1, "attn_calls": 16})]):
        assert _read(monkeypatch, metric, recorded, _trace(ops)) is None
    monkeypatch.delattr(profiler, "spans")
    assert run.load_module("metrics", metric).read(_trace(ops)) is None


def test_epilogue_ms_none_without_device_operations(monkeypatch):
    recorded = [_span(2_000, {"replayed": 0, "conv_biased": 57, "conv_epilogues": 0})]
    assert _read(monkeypatch, "serve.epilogue_ms", recorded, _trace()) is None
    recorded = [_span(2_000, {"replayed": 1, "conv_biased": 57, "conv_epilogues": 57})]
    assert _read(monkeypatch, "serve.epilogue_ms", recorded, _trace()) is None  # CPU rehearsal
