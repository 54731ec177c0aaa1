"""The program's span recorder (``yolo_ms_tpu_torch/utils/profiler.py``) on
the serving path, on the CPU: off, a call records nothing and every span is
the one shared no-op; on, ``predict_batch`` records its seven spans as one
call; under ``torch.profiler`` the spans are on without the switch, lie on
the profiler's clock and never reach its events; the buffer is bounded.
"""

import os

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from yolo_ms_tpu_torch.infer.predictor import Predictor
from yolo_ms_tpu_torch.ops.nms import nms_fixed
from yolo_ms_tpu_torch.utils import profiler
from yolo_ms_tpu_torch.utils.convert import load_npz

GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "trained", "weights.npz")
B, HW = 2, 64
PARENTS = {
    "serve/predict_batch": None,
    "serve/upload": "serve/predict_batch",
    "serve/infer": "serve/predict_batch",
    "serve/normalize": "serve/infer",
    "serve/model": "serve/infer",
    "serve/postprocess": "serve/infer",
    "serve/download": "serve/predict_batch",
}
SLACK_NS = 100_000  # the profiler's clock against time.time_ns()


@pytest.fixture(scope="module")
def pred():
    return Predictor("n", load_npz(GOLDEN), num_classes=3, input_size=(HW, HW), device="cpu")


@pytest.fixture()
def images():
    return np.random.default_rng(0).integers(0, 256, (B, HW, HW, 3), dtype=np.uint8)


@pytest.fixture(autouse=True)
def empty_buffer():
    profiler.clear()
    yield
    profiler.clear()


def test_off_a_call_records_nothing(pred, images):
    nms_fixed.sweeps = 0
    pred.predict_batch(images)
    assert profiler.spans() == []
    assert not profiler.spans_on()
    assert profiler.span("serve/model") is profiler.span("other", bytes=1)
    assert nms_fixed.sweeps == 0  # the tally enqueues nothing


def test_predict_batch_records_its_seven_spans_as_one_call(pred, images):
    with profiler.recording():
        out = pred.predict_batch(images)
    got = profiler.spans()
    assert sorted(s.name for s in got) == sorted(PARENTS)
    by_id = {s.id: s for s in got}
    assert len({s.call for s in got}) == 1
    for s in got:
        parent = by_id.get(s.parent)
        assert (parent.name if parent else None) == PARENTS[s.name]
        if parent:
            assert parent.start_ns <= s.start_ns <= s.end_ns <= parent.end_ns
        assert s.call == got[0].id
    counts = {s.name: s.counts for s in got}
    assert counts["serve/predict_batch"] == {"images": B}
    assert counts["serve/model"] == {"replayed": 0}  # the CPU forward runs eagerly
    assert counts["serve/upload"] == {"bytes": B * HW * HW * 3}
    assert counts["serve/download"] == {"bytes": sum(v.nbytes for v in out.values())}

    # infer called alone is the root of its own call
    profiler.clear()
    with profiler.recording():
        pred.infer(torch.from_numpy(images))
    got = profiler.spans()
    assert [s.name for s in got] == ["serve/infer", "serve/normalize", "serve/model",
                                     "serve/postprocess"]
    assert got[0].parent is None and {s.call for s in got} == {got[0].id}


def test_under_the_profiler_spans_lie_on_its_clock_and_never_in_its_events(pred, images):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert profiler.spans_on()
        for i in range(3):
            with record_function(f"call_{i}"):
                pred.predict_batch(images)
    assert not profiler.spans_on()
    got = profiler.spans()
    assert len(got) == 3 * len(PARENTS)
    events = prof.profiler.kineto_results.events()
    assert not [e.name() for e in events if e.name().startswith("serve/")]
    ranges = [(e.start_ns(), e.start_ns() + e.duration_ns()) for e in events
              if e.name().startswith("call_")]
    assert len(ranges) == 3
    for s in got:
        assert any(a - SLACK_NS <= s.start_ns <= s.end_ns <= b + SLACK_NS for a, b in ranges), s


def test_the_buffer_keeps_the_last_spans():
    with profiler.recording():
        for _ in range(profiler.MAX_SPANS + 3):
            with profiler.span("x"):
                pass
    got = profiler.spans()
    assert len(got) == profiler.MAX_SPANS
    assert got[-1].id - got[0].id == profiler.MAX_SPANS - 1


def test_annotate_sets_counts_on_the_innermost_span_of_its_name():
    profiler.annotate("b", replayed=1)  # off: nothing to set, nothing recorded
    assert profiler.spans() == []
    with profiler.recording():
        with profiler.span("a", n=0):
            with profiler.span("b", replayed=0):
                profiler.annotate("b", replayed=1)
                profiler.annotate("a", n=5)  # not the innermost span
            profiler.annotate("b", replayed=2)  # closed
    counts = {s.name: s.counts for s in profiler.spans()}
    assert counts == {"a": {"n": 0}, "b": {"replayed": 1}}
