"""The port's serving tail (``fused_postprocess``, NMS) against the JAX one.

Random f32 maps go to both implementations as split pairs and as unsplit
maps, with the assertions of tests/test_pallas_select.py: ``valid`` and
``classes`` equal, scores rtol 1e-5, boxes atol 1e-3. Plus the confidence
edges, a tie case compared as sets (``torch.topk`` may order exact ties
differently from ``approx_max_k``), and ``nms_fixed`` against the
sequential scan and the JAX ``nms_fixed``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yolo_ms_tpu.ops.nms import batched_nms as jax_batched_nms
from yolo_ms_tpu.ops.nms import nms_fixed as jax_nms_fixed
from yolo_ms_tpu.ops.postprocess import fused_postprocess as jax_fused
from yolo_ms_tpu_torch.ops.nms import (
    CLASS_OFFSET,
    batched_nms,
    nms_fixed,
    nms_greedy_scan,
)
from yolo_ms_tpu_torch.ops.postprocess import fused_postprocess

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
