"""``serve.model_replay_pct`` on synthetic spans, on the CPU.

Run from the root of the repository:
``python -m pytest portbench/tests/test_portbench_replay_metric.py -q``.
"""

from __future__ import annotations

import threading
from types import SimpleNamespace

import pytest

from portbench import run
from portbench.trace import STRETCH
from yolo_ms_tpu_torch.utils import profiler

STRETCH_NS = (1_000, 9_000)


def _span(name, start, counts, thread=None):
    return SimpleNamespace(name=name, counts=counts, start_ns=start, end_ns=start + 10,
                           thread=thread or threading.main_thread().ident)


def _read(monkeypatch, recorded):
    monkeypatch.setattr(profiler, "spans", lambda: recorded)
    trace = SimpleNamespace(ranges={STRETCH: [STRETCH_NS]}, calls=4)
    return run.load_module("metrics", "serve.model_replay_pct").read(trace)


@pytest.mark.parametrize("replayed,want", [([1, 1, 1, 1], 100.0), ([0, 1, 1, 1], 75.0),
                                           ([0, 0, 0, 0], 0.0)])
def test_share_of_model_spans_that_replayed(monkeypatch, replayed, want):
    recorded = []
    for i, r in enumerate(replayed):
        recorded += [_span("serve/normalize", 2_000 + 100 * i, {}),
                     _span("serve/model", 2_020 + 100 * i, {"replayed": r}),
                     _span("serve/postprocess", 2_040 + 100 * i, {})]
    assert _read(monkeypatch, recorded) == want


def test_only_main_thread_spans_inside_the_stretch_count(monkeypatch):
    recorded = [_span("serve/model", 2_000, {"replayed": 1}),
                _span("serve/model", 500, {"replayed": 0}),  # before the stretch
                _span("serve/model", 9_500, {"replayed": 0}),  # after it
                _span("serve/model", 3_000, {"replayed": 0}, thread=-1)]  # another thread
    assert _read(monkeypatch, recorded) == 100.0


@pytest.mark.parametrize("recorded", [
    [],
    [_span("serve/model", 2_000, {}), _span("serve/model", 3_000, {})],  # a parent: no count
    [_span("serve/postprocess", 2_000, {"replayed": 1})],
])
def test_none_without_a_counted_model_span(monkeypatch, recorded):
    assert _read(monkeypatch, recorded) is None


def test_none_without_the_recorder(monkeypatch):
    monkeypatch.delattr(profiler, "spans")
    trace = SimpleNamespace(ranges={STRETCH: [STRETCH_NS]}, calls=1)
    assert run.load_module("metrics", "serve.model_replay_pct").read(trace) is None
