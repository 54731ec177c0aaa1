"""The port's serving tail (``fused_postprocess``, NMS) against the JAX one.

Random f32 maps go to both implementations as split pairs and as unsplit
maps, with the assertions of tests/test_pallas_select.py: ``valid`` and
``classes`` equal, scores rtol 1e-5, boxes atol 1e-3. Plus the confidence
edges, a tie case compared as sets (``torch.topk`` may order exact ties
differently from ``approx_max_k``), and ``nms_fixed`` against the
sequential scan and the JAX ``nms_fixed``; the fixed point exported by
``torch.export`` (one node of the ``nms_fixed`` op) against the eager call,
bit for bit and sweep for sweep; and ``class_aware=False`` against the JAX
functions.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tests.torch_policy  # noqa: F401 - the port's thread policy
from yolo_ms_tpu.ops.nms import batched_nms as jax_batched_nms
from yolo_ms_tpu.ops.nms import nms_fixed as jax_nms_fixed
from yolo_ms_tpu.ops.postprocess import fused_postprocess as jax_fused
from yolo_ms_tpu_torch.ops.kernels.nms import nms
from yolo_ms_tpu_torch.ops.nms import (
    CLASS_OFFSET,
    batched_nms,
    nms_fixed,
    nms_greedy_scan,
)
from yolo_ms_tpu_torch.ops.postprocess import fused_postprocess
from yolo_ms_tpu_torch.utils import profiler

NC, REG_MAX = 80, 16
NB = 4 * REG_MAX
SHAPES = [(8, 8), (4, 4), (2, 8)]  # as tests/test_pallas_select.py


def _maps(seed, nc=NC, scale=1.5):
    rng = np.random.default_rng(seed)
    return [
        (rng.standard_normal((2, h, w, NB + nc)) * scale).astype(np.float32)
        for h, w in SHAPES
    ]


def _as_inputs(maps, split, framework):
    conv = jnp.asarray if framework == "jax" else torch.from_numpy
    if split:
        return [(conv(m[..., :NB].copy()), conv(m[..., NB:].copy())) for m in maps]
    return [conv(m) for m in maps]


def _assert_same(got, want):
    got = {k: v.numpy() for k, v in got.items()}
    want = jax.device_get(want)
    np.testing.assert_array_equal(got["valid"], want["valid"])
    v = want["valid"]
    np.testing.assert_array_equal(got["classes"][v], want["classes"][v])
    np.testing.assert_allclose(got["scores"][v], want["scores"][v], rtol=1e-5)
    np.testing.assert_allclose(got["boxes"][v], want["boxes"][v], atol=1e-3)
    # invalid slots are canonical zeros in both
    for key in ("boxes", "scores", "classes"):
        assert not got[key][~got["valid"]].any()
    return v


@pytest.mark.parametrize("split", [True, False], ids=["split", "unsplit"])
def test_fused_postprocess_matches_jax(split):
    maps = _maps(3)
    kw = dict(pre_nms_topk=64, max_det=20)
    want = jax_fused(_as_inputs(maps, split, "jax"), NC, **kw)
    got = fused_postprocess(_as_inputs(maps, split, "torch"), NC, **kw)
    v = _assert_same(got, want)
    assert v.sum() > 0
    assert got["classes"].dtype == torch.int32 and got["boxes"].shape == (2, 20, 4)


def test_fused_postprocess_lvis_classes_match_jax():
    """LVIS v1's 1,203 classes at a 64 px input (HW 64 / 16 / 4), f32: on
    the card these maps take ``select``'s wide route. Class offsets past
    2**23 / 8192 (about 1,024 classes) leave the offset boxes of the NMS
    without sub-pixel bits, in both packages alike."""
    nc = 1203
    rng = np.random.default_rng(6)
    maps = [(rng.standard_normal((2, s, s, NB + nc)) * 1.5).astype(np.float32)
            for s in (8, 4, 2)]
    kw = dict(pre_nms_topk=64, max_det=20)
    want = jax_fused(_as_inputs(maps, True, "jax"), nc, **kw)
    got = fused_postprocess(_as_inputs(maps, True, "torch"), nc, **kw)
    v = _assert_same(got, want)
    assert v.sum() > 0 and (got["classes"].numpy()[v] >= 1024).any()


def test_fused_postprocess_reads_nchw_permute_views():
    maps = _maps(4)
    views = []
    for m in maps:
        nchw = torch.from_numpy(m).permute(0, 3, 1, 2).contiguous()
        views.append((nchw[:, :NB].permute(0, 2, 3, 1), nchw[:, NB:].permute(0, 2, 3, 1)))
    want = fused_postprocess(_as_inputs(maps, True, "torch"), NC, pre_nms_topk=64, max_det=20)
    got = fused_postprocess(views, NC, pre_nms_topk=64, max_det=20)
    for key in ("valid", "classes", "scores"):
        assert torch.equal(got[key], want[key]), key
    # the DFL sums may run in another order on strided input: last-bit only
    torch.testing.assert_close(got["boxes"], want["boxes"], rtol=0, atol=1e-4)


@pytest.mark.parametrize("conf", [0.0, -0.5, 1.0, 1.5])
def test_confidence_edges_match_jax(conf):
    maps = _maps(5, nc=8, scale=3.0)
    kw = dict(conf_thresh=conf, pre_nms_topk=64, max_det=20)
    want = jax_fused(_as_inputs(maps, True, "jax"), 8, **kw)
    got = fused_postprocess(_as_inputs(maps, True, "torch"), 8, **kw)
    v = _assert_same(got, want)
    if conf >= 1.0:
        assert not v.any()
    else:
        assert v.sum() > 0


def test_ties_compare_as_sets():
    """Ten anchors tie exactly on score; their boxes are points (DFL pinned
    to bin 0), so nothing suppresses and only the order may differ."""
    nc = 4
    rng = np.random.default_rng(9)
    maps = []
    for h, w in [(4, 4), (2, 2)]:
        m = np.full((1, h, w, NB + nc), -5.0, np.float32)
        m[..., :NB] = 0.0
        m[..., [0, 16, 32, 48]] = 40.0  # every side at bin 0
        maps.append(m)
    flat = [m.reshape(1, -1, NB + nc) for m in maps]
    picks = rng.choice(20, size=10, replace=False)
    for a in picks:
        level, local = (0, a) if a < 16 else (1, a - 16)
        flat[level][0, local, NB + rng.integers(nc)] = 3.0
    kw = dict(pre_nms_topk=64, max_det=16)
    want = jax.device_get(jax_fused([jnp.asarray(m) for m in maps], nc, **kw))
    got = {k: v.numpy() for k, v in fused_postprocess(
        [torch.from_numpy(m) for m in maps], nc, **kw).items()}

    def as_set(out):
        v = out["valid"][0]
        return {
            (int(c), tuple(np.round(b, 3)), round(float(s), 6))
            for c, b, s in zip(out["classes"][0][v], out["boxes"][0][v], out["scores"][0][v])
        }

    assert int(got["valid"].sum()) == 10
    assert as_set(got) == as_set(want)


def _nms_case(seed, b=3, n=48):
    rng = np.random.default_rng(seed)
    centers = rng.uniform(0, 60, (b, n, 2))
    sizes = rng.uniform(8, 30, (b, n, 2))
    boxes = np.concatenate([centers - sizes / 2, centers + sizes / 2], -1).astype(np.float32)
    scores = np.sort(rng.uniform(0.05, 1.0, (b, n)), axis=1)[:, ::-1].astype(np.float32).copy()
    scores[:, -5:] = -1.0  # padding rows
    return boxes, scores


@pytest.mark.parametrize("iou", [0.3, 0.45, 0.7])
def test_nms_fixed_matches_scan_and_jax(iou):
    boxes, scores = _nms_case(int(iou * 100))
    before = nms_fixed.sweeps
    with profiler.recording():  # the sweeps tally counts while spans are on
        got = nms_fixed(torch.from_numpy(boxes), torch.from_numpy(scores), iou)
    assert nms_fixed.sweeps > before
    scan = nms_greedy_scan(torch.from_numpy(boxes), torch.from_numpy(scores), iou)
    want = jax.vmap(jax_nms_fixed, in_axes=(0, 0, None))(
        jnp.asarray(boxes), jnp.asarray(scores), iou
    )
    assert torch.equal(got, scan)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert 0 < got.sum() < (scores > 0).sum()  # some suppression happened
    assert not got[:, -5:].any()


def test_batched_nms_matches_jax():
    rng = np.random.default_rng(11)
    b, a, nc = 2, 120, 5
    xy = rng.uniform(0, 100, (b, a, 2))
    wh = rng.uniform(5, 40, (b, a, 2))
    cls = rng.uniform(0, 1, (b, a, nc))
    preds = np.concatenate([xy, wh, cls], -1).astype(np.float32)
    kw = dict(conf_thresh=0.5, iou_thresh=0.45, pre_nms_topk=64, max_det=30)
    want = jax.device_get(jax_batched_nms(jnp.asarray(preds), **kw))
    got = {k: v.numpy() for k, v in batched_nms(torch.from_numpy(preds), **kw).items()}
    np.testing.assert_array_equal(got["valid"], want["valid"])
    v = want["valid"]
    np.testing.assert_array_equal(got["classes"][v], want["classes"][v])
    np.testing.assert_allclose(got["scores"], want["scores"], rtol=1e-6)
    np.testing.assert_allclose(got["boxes"][v], want["boxes"][v], atol=1e-4)
    assert CLASS_OFFSET == 8192.0


def _chain(n, iou, width=20.0):
    """n boxes in a row, each overlapping the next above ``iou`` and the one
    after that below it: greedy keeps every other box, and the fixed point
    settles one link per sweep."""
    r = (1.0 - iou) / (1.0 + iou)  # the IoU of two boxes shifted by r * width
    x = np.arange(n) * 0.75 * r * width
    boxes = np.stack([x, np.zeros(n), x + width, np.full(n, 10.0)], -1)
    return boxes.astype(np.float32), np.linspace(1.0, 0.5, n).astype(np.float32)


class _TracedNms(torch.nn.Module):
    def __init__(self, iou):
        super().__init__()
        self.iou = iou

    def forward(self, boxes, scores):
        keep, sweeps = nms(boxes, scores, self.iou)
        return nms_fixed(boxes, scores, self.iou), keep, sweeps


@pytest.mark.parametrize("iou", [0.3, 0.45, 0.7])
def test_traced_fixed_point_equals_eager(iou):
    """Rows: random boxes with padding, all padding, and a chain of 24 (23
    links) padded to 48. ``torch.export`` records the fixed point as nodes
    of the ``nms_fixed`` op, with no ``while_loop``; the exported program
    gives the eager keep mask bit for bit, its sweeps per image top out at
    the eager loop's count, and it adds nothing to ``nms_fixed.sweeps``."""
    boxes, scores = _nms_case(int(iou * 100), b=3)
    scores[1] = -1.0
    cb, cs = _chain(24, iou)
    boxes[2, :24], scores[2, :24], scores[2, 24:] = cb, cs, -1.0
    boxes, scores = torch.from_numpy(boxes), torch.from_numpy(scores)
    program = torch.export.export(_TracedNms(iou), (boxes, scores), strict=False).module()
    nodes = [str(n.target) for n in program.graph.nodes if n.op == "call_function"]
    assert nodes.count("yolo_ms_tpu_torch.nms_fixed.default") == 2
    assert not any("while_loop" in n for n in nodes)

    before = nms_fixed.sweeps
    with profiler.recording():  # the sweeps tally counts while spans are on
        want = nms_fixed(boxes, scores, iou)
        eager_sweeps = int(nms_fixed.sweeps - before)
        tally = int(nms_fixed.sweeps)
        got, keep, sweeps = program(boxes, scores)
    assert int(nms_fixed.sweeps) == tally  # the program counts none
    assert torch.equal(got, want) and torch.equal(keep, want)
    assert sweeps.dtype == torch.int32 and sweeps.shape == (3,)
    assert int(sweeps.max()) == eager_sweeps > 10
    assert sweeps[1] == 1  # all padding: one unchanged sweep
    assert torch.equal(want, nms_greedy_scan(boxes, scores, iou))
    assert not want[1].any()
    assert want[2, :24].tolist() == [k % 2 == 0 for k in range(24)]


@pytest.mark.parametrize("fn", ["fused_postprocess", "batched_nms"])
def test_class_agnostic_matches_jax(fn):
    """``class_aware=False``: one NMS over all classes, as the JAX
    functions; fewer boxes survive than class-aware on the same input."""
    if fn == "fused_postprocess":
        maps = _maps(3, nc=8)
        kw = dict(pre_nms_topk=64, max_det=20)
        want = jax_fused(_as_inputs(maps, True, "jax"), 8, class_aware=False, **kw)
        got = fused_postprocess(_as_inputs(maps, True, "torch"), 8, class_aware=False, **kw)
        aware = fused_postprocess(_as_inputs(maps, True, "torch"), 8, **kw)
        v = _assert_same(got, want)
    else:
        rng = np.random.default_rng(12)
        b, a, nc = 2, 120, 5
        preds = np.concatenate([
            rng.uniform(0, 100, (b, a, 2)), rng.uniform(5, 40, (b, a, 2)),
            rng.uniform(0, 1, (b, a, nc)),
        ], -1).astype(np.float32)
        kw = dict(conf_thresh=0.5, iou_thresh=0.45, pre_nms_topk=64, max_det=64)
        want = jax.device_get(jax_batched_nms(jnp.asarray(preds), class_aware=False, **kw))
        got = batched_nms(torch.from_numpy(preds), class_aware=False, **kw)
        aware = batched_nms(torch.from_numpy(preds), **kw)
        got = {k: t.numpy() for k, t in got.items()}
        np.testing.assert_array_equal(got["valid"], want["valid"])
        v = want["valid"]
        np.testing.assert_array_equal(got["classes"][v], want["classes"][v])
        np.testing.assert_allclose(got["scores"], want["scores"], rtol=1e-6)
        np.testing.assert_allclose(got["boxes"][v], want["boxes"][v], atol=1e-4)
    assert 0 < v.sum() < int(aware["valid"].sum()), (v.sum(), aware["valid"].sum())
