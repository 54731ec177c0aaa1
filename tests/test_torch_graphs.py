"""The serving forward's CUDA graphs (``infer/graphs.py``) on the CPU, where
the rule keeps the forward eager: ``Predictor.serve.model`` is the
``GraphedForward`` over ``Predictor.model``, fires forward hooks around each
call, captures nothing off the card and records ``replayed=0``; a spatial
group or a call outside ``torch.inference_mode()`` stays eager before any
capture is tried, a capture that fails raises with its key, a conversion of
the weights drops the graphs; ``export_program``'s graph holds no trace of
the wrapper; ``fused_postprocess`` returns new tensors, never views of the
maps a replay overwrites. The card's side is in ``tests/test_torch_cuda.py``.
"""

import os
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from yolo_ms_tpu_torch.infer import graphs
from yolo_ms_tpu_torch.infer.graphs import GraphedForward
from yolo_ms_tpu_torch.infer.predictor import Predictor
from yolo_ms_tpu_torch.models.deploy import fold_batchnorm
from yolo_ms_tpu_torch.models.registry import build_model
from yolo_ms_tpu_torch.nn.blocks import set_spatial_group
from yolo_ms_tpu_torch.ops.postprocess import fused_postprocess
from yolo_ms_tpu_torch.parallel.spatial import HeightShards
from yolo_ms_tpu_torch.utils import profiler
from yolo_ms_tpu_torch.utils.convert import load_npz

GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "trained", "weights.npz")
B, HW = 2, 64


def _predictor(**kw):
    return Predictor("n", load_npz(GOLDEN), num_classes=3, input_size=(HW, HW), device="cpu",
                     **kw)


@pytest.fixture(scope="module")
def pred():
    return _predictor()


@pytest.fixture()
def images():
    return np.random.default_rng(0).integers(0, 256, (B, HW, HW, 3), dtype=np.uint8)


def _same(got, want):
    return got.keys() == want.keys() and all(torch.equal(got[k], want[k]) for k in want)


def test_the_cpu_forward_is_never_captured(pred, images):
    before = dict(graphs.tally)
    profiler.clear()
    with profiler.recording():
        for _ in range(3):
            pred.predict_batch(images)
    model_spans = [s for s in profiler.spans() if s.name == "serve/model"]
    profiler.clear()
    assert [s.counts for s in model_spans] == [{"replayed": 0}] * 3
    assert graphs.tally == before
    assert pred.serve.model._graphs == {}


def test_serve_model_fires_forward_hooks_around_each_call(pred, images):
    seen = []
    hooks = [pred.serve.model.register_forward_pre_hook(lambda m, a: seen.append("enter")),
             pred.model.register_forward_hook(lambda m, a, o: seen.append("model")),
             pred.serve.model.register_forward_hook(lambda m, a, o: seen.append("leave"))]
    try:
        for _ in range(2):
            pred.predict_batch(images)
    finally:
        for h in hooks:
            h.remove()
    assert seen == ["enter", "model", "leave"] * 2


def test_the_models_state_dict_keys_are_unchanged(pred):
    plain = build_model("n", num_classes=3, device="cpu", deploy=True)
    assert list(pred.model.state_dict()) == list(plain.state_dict())
    assert isinstance(pred.serve.model, GraphedForward)
    assert pred.serve.model.model is pred.model


def test_the_rule_keeps_the_forward_eager_before_any_capture(monkeypatch, images):
    """Widened to the CPU, where a capture would fail: a call outside
    ``torch.inference_mode()`` and a model with a spatial group stay
    eager and give the eager results."""
    p = _predictor()
    x = torch.from_numpy(images)
    want = p.infer(x)
    monkeypatch.setattr(graphs, "CAPTURED_ON", ("cuda", "cpu"))
    before = dict(graphs.tally)
    with torch.no_grad():
        net_in = p.serve.network_input(x)
        eager = p.model(net_in, split_head=True)
        for got, ref in zip(p.serve.model(net_in, split_head=True), eager):
            assert all(torch.equal(g, r) for g, r in zip(got, ref))
    set_spatial_group(p.model, SimpleNamespace(spatial=2, shards=HeightShards(None, [0, 1], 0)))
    assert _same(p.infer(x), want)
    assert graphs.tally == before and p.serve.model._graphs == {}


def test_a_failed_capture_raises_with_its_key(monkeypatch, images):
    p = _predictor()
    monkeypatch.setattr(graphs, "CAPTURED_ON", ("cuda", "cpu"))
    before = dict(graphs.tally)
    with pytest.raises(RuntimeError, match=r"capture of the forward failed for input "
                                           r"\[2, 3, 64, 64\] strides \[12288, 4096, 64, 1\] "
                                           r"torch.float32 on cpu \(split_head=True\)"):
        p.infer(torch.from_numpy(images))
    assert graphs.tally == before and p.serve.model._graphs == {}


def test_a_conversion_of_the_weights_drops_the_graphs(images):
    """Forcing the entry layouts on after construction converts the weights
    at the next call (``AutoLayoutInfer``); the graphs captured before are
    dropped, as by any ``.to()`` through the module."""
    p = _predictor()
    x = torch.from_numpy(images)
    want = p.infer(x)
    p.serve.model._graphs["stale"] = None
    p._infer._disabled = False
    got = p.infer(x)
    assert p.serve.memory_format == torch.channels_last
    assert p.serve.model._graphs == {}
    assert torch.equal(got["valid"], want["valid"])
    p.serve.model._graphs["stale"] = None
    p.serve.to(torch.float32)
    assert p.serve.model._graphs == {}


def test_export_program_holds_no_trace_of_the_wrapper(tmp_path):
    from yolo_ms_tpu_torch.tools.export import export_program

    path = str(tmp_path / "serve.pt2")
    export_program(fold_batchnorm(load_npz(GOLDEN)), "n", 3, path, batch=1, img_size=(HW, HW),
                   device="cpu")
    program = torch.export.load(path)
    stacks = [str(n.meta.get("nn_module_stack", "")) for n in program.graph.nodes]
    text = "\n".join([program.graph_module.code, str(program.graph), *stacks])
    assert "GraphedForward" not in text and "graphs" not in text
    assert "replay" not in text and "CUDAGraph" not in text
    assert not [k for k in program.state_dict if k.startswith("model.model.")]


@pytest.mark.parametrize("conf", [0.25, 1.1])
@pytest.mark.parametrize("split", [True, False])
def test_fused_postprocess_returns_new_tensors(split, conf):
    """None of the results shares memory with the maps it read: a replay
    may overwrite those while the caller still holds the results."""
    gen = torch.Generator().manual_seed(0)
    maps = []
    for s in (8, 4, 2):
        m = torch.randn(B, 64 + 3, s, s, generator=gen).permute(0, 2, 3, 1)
        maps.append((m[..., :64], m[..., 64:]) if split else m)
    out = fused_postprocess(maps, 3, conf_thresh=conf)
    flat = [t for m in maps for t in (m if split else (m,))]
    held = {t.untyped_storage().data_ptr() for t in flat}
    assert out["valid"].any() == (conf < 1)
    for k, v in out.items():
        assert v.untyped_storage().data_ptr() not in held, k
