"""The NMS op's CPU path against the JAX fixed point and greedy scan.

``yolo_ms_tpu_torch::nms_fixed`` on CPU tensors runs ``nms_fixed_plain``;
on CUDA tensors it launches ``csrc/nms.cu`` (held against the plain version
in ``tests/test_torch_cuda.py`` and ``chip_smoke.py``). Here the same seeded
numpy inputs go through the op and through the JAX package's ``nms_fixed``
and ``nms_greedy_scan`` under ``jax.vmap``: the keep masks must be equal
bit for bit. The sweeps per image must equal a count made apart: JAX's
overlap matrix (``_pairwise_iou_xyxy``) iterated in numpy, counted as the
eager loop counts. Cases: random boxes with padding rows, an all-padding
row, a chain of 24 boxes, K = 525 (the goldens' 160 px anchors), boxes
shifted by class as the serving tail shifts them, and IoUs exactly at the
threshold (compared in f32, as the tensor compare does).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tests.torch_policy  # noqa: F401 - the port's thread policy
from yolo_ms_tpu.ops.nms import _pairwise_iou_xyxy
from yolo_ms_tpu.ops.nms import nms_fixed as jax_nms_fixed
from yolo_ms_tpu.ops.nms import nms_greedy_scan as jax_greedy_scan
from yolo_ms_tpu_torch.ops.kernels import nms as nms_kernels
from yolo_ms_tpu_torch.ops.nms import CLASS_OFFSET, nms_fixed
from yolo_ms_tpu_torch.utils import profiler


def _random(rng, b, n, span=60.0, pad=5):
    centers = rng.uniform(0, span, (b, n, 2))
    sizes = rng.uniform(8, 30, (b, n, 2))
    boxes = np.concatenate([centers - sizes / 2, centers + sizes / 2], -1).astype(np.float32)
    scores = np.sort(rng.uniform(0.05, 1.0, (b, n)), axis=1)[:, ::-1].astype(np.float32).copy()
    if pad:
        scores[:, -pad:] = -1.0
    return boxes, scores


def _chain(n, iou, width=20.0):
    """n boxes in a row, each overlapping the next above ``iou`` and the one
    after that below it: greedy keeps every other box, and the fixed point
    settles one link per sweep."""
    r = (1.0 - iou) / (1.0 + iou)
    x = np.arange(n) * 0.75 * r * width
    boxes = np.stack([x, np.zeros(n), x + width, np.full(n, 10.0)], -1)
    return boxes.astype(np.float32), np.linspace(1.0, 0.5, n).astype(np.float32)


def _case(name, iou):
    rng = np.random.default_rng(int(iou * 100) + len(name))
    if name == "random_padded":
        return _random(rng, 3, 48)
    if name == "all_padding_row":
        boxes, scores = _random(rng, 2, 40)
        scores[1] = -1.0
        return boxes, scores
    if name == "chain":
        boxes, scores = _random(rng, 2, 48)
        cb, cs = _chain(24, iou)
        boxes[1, :24], scores[1, :24], scores[1, 24:] = cb, cs, -1.0
        return boxes, scores
    if name == "k525":
        return _random(rng, 2, 525, span=400.0, pad=60)
    if name == "class_shifted":
        boxes, scores = _random(rng, 2, 300, span=200.0, pad=20)
        classes = rng.choice([0, 41, 79], (2, 300))  # COCO's last class at 79 * 8192
        return (boxes + (classes[..., None] * CLASS_OFFSET).astype(np.float32)), scores
    raise ValueError(name)


def _reference_sweeps(boxes, scores, iou):
    """Per image: JAX's IoU matrix, compared with the threshold in f32, and
    the fixed point run in numpy from keep = valid, counting sweeps until
    one changes nothing (that one included), at most N."""
    over = np.asarray(jax.vmap(_pairwise_iou_xyxy)(jnp.asarray(boxes))) > np.float32(iou)
    n = boxes.shape[1]
    over &= np.tril(np.ones((n, n), bool), -1)
    counts = []
    for o, s in zip(over, scores):
        valid = s > 0
        keep, count = valid, 0
        for _ in range(n):
            new = valid & ~(o & keep[None, :]).any(-1)
            count += 1
            if np.array_equal(new, keep):
                break
            keep = new
        counts.append(count)
    return np.asarray(counts, np.int32)


def _assert_matches_jax(boxes, scores, iou):
    keep, sweeps = torch.ops.yolo_ms_tpu_torch.nms_fixed(
        torch.from_numpy(boxes), torch.from_numpy(scores), iou)
    jb, js = jnp.asarray(boxes), jnp.asarray(scores)
    want = np.asarray(jax.vmap(jax_nms_fixed, in_axes=(0, 0, None))(jb, js, iou))
    scan = np.asarray(jax.vmap(jax_greedy_scan, in_axes=(0, 0, None))(jb, js, iou))
    assert keep.dtype == torch.bool and sweeps.dtype == torch.int32
    np.testing.assert_array_equal(keep.numpy(), want)
    np.testing.assert_array_equal(keep.numpy(), scan)
    np.testing.assert_array_equal(sweeps.numpy(), _reference_sweeps(boxes, scores, iou))
    return keep, sweeps


@pytest.mark.parametrize("iou", [0.3, 0.45, 0.7])
@pytest.mark.parametrize("name", ["random_padded", "all_padding_row", "chain"])
def test_op_matches_jax(name, iou):
    boxes, scores = _case(name, iou)
    keep, sweeps = _assert_matches_jax(boxes, scores, iou)
    assert not keep[:, -5:].any()  # padding rows
    if name == "all_padding_row":
        assert not keep[1].any() and int(sweeps[1]) == 1
    if name == "chain":
        assert keep[1, :24].tolist() == [k % 2 == 0 for k in range(24)]
        assert int(sweeps[1]) > 10


@pytest.mark.parametrize("name", ["k525", "class_shifted"])
def test_op_matches_jax_at_serving_sizes(name):
    """K = 525 (not a multiple of 32) and class-shifted coordinates up to
    79 * 8192 + 640, at the serving IoU 0.45."""
    boxes, scores = _case(name, 0.45)
    keep, _ = _assert_matches_jax(boxes, scores, 0.45)
    assert 0 < int(keep.sum()) < int((scores > 0).sum())  # some suppression happened


@pytest.mark.parametrize("iou", [0.5, 0.3])
def test_iou_exactly_at_the_threshold(iou):
    """[0, 0, 10, 10] against [0, 0, 10, 5] has IoU 50 / 100 = 0.5, and
    against [0, 0, 10, 3] 30 / 100, the f32 nearest 0.3: neither is above
    its threshold once the threshold is rounded to f32 (0.3 rounds up), so
    nothing is suppressed; a hair below the threshold, the second box goes."""
    small = {0.5: 5.0, 0.3: 3.0}[iou]
    boxes = np.asarray([[[0, 0, 10, 10], [0, 0, 10, small]]], np.float32)
    scores = np.asarray([[0.9, 0.8]], np.float32)
    keep, _ = _assert_matches_jax(boxes, scores, iou)
    assert keep.tolist() == [[True, True]]
    below = float(np.nextafter(np.float32(iou), np.float32(0)))
    keep, _ = _assert_matches_jax(boxes, scores, below)
    assert keep.tolist() == [[True, False]]


def test_sweeps_tally_is_the_batch_max():
    """While spans are on, ``nms_fixed.sweeps`` adds each call's max over
    images, as a tensor (on the card it stays on the device);
    ``use_kernel=False`` runs the plain version and tallies the same. With
    spans off it tallies nothing."""
    boxes, scores = _case("chain", 0.45)
    b, s = torch.from_numpy(boxes), torch.from_numpy(scores)
    _, per_image = nms_kernels.nms(b, s, 0.45)
    nms_fixed.sweeps = 0
    nms_fixed(b, s, 0.45)
    assert nms_fixed.sweeps == 0
    with profiler.recording():
        nms_fixed(b, s, 0.45)
        nms_fixed(b, s, 0.45, use_kernel=False)
    assert isinstance(nms_fixed.sweeps, torch.Tensor)
    assert int(nms_fixed.sweeps) == 2 * int(per_image.max())
    assert int(per_image[1]) > int(per_image[0])


def test_fake_and_route_rule():
    """The op answers meta tensors with shapes (what ``torch.export``
    traces); the route is shared memory up to K = 1,288 (the main path's
    1,024 included) and a global scratch above (``pre_nms_topk`` 4096)."""
    keep, sweeps = torch.ops.yolo_ms_tpu_torch.nms_fixed(
        torch.empty(3, 70, 4, device="meta"), torch.empty(3, 70, device="meta"), 0.45)
    assert keep.shape == (3, 70) and keep.dtype == torch.bool
    assert sweeps.shape == (3,) and sweeps.dtype == torch.int32
    assert [nms_kernels.route(k) for k in (1, 525, 1024, 1288, 1289, 4096)] == (
        ["shared"] * 4 + ["global"] * 2)
    assert nms_kernels.words(525) == 17 and nms_kernels.words(1024) == 32
    with pytest.raises(ValueError):
        nms_kernels.nms(torch.zeros(2, 5, 4), torch.zeros(2, 6), 0.45)
