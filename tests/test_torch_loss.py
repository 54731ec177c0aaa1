"""The port's loss side against the JAX package's, on the same numpy inputs.

- ``bbox_iou`` (IoU / GIoU / DIoU / CIoU, broadcasting): values atol 1e-6,
  gradients w.r.t. both boxes rtol 1e-5 (CIoU's alpha detached on both sides);
- ``task_aligned_assign`` on seeded inputs with exact ties of the bf16
  metric, conflicts and exhausted rows: ``fg_mask``, labels and boxes exactly
  equal, target scores atol 1e-6;
- the DFL helpers, and ``DetectionLoss`` on random raw maps (BCE and focal,
  every box-loss IoU, f32 and bf16 maps): the loss terms rtol 1e-5, num_fg
  equal, and the gradients w.r.t. the raw maps rtol 1e-4 (atol 1e-4 of the
  largest gradient).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tests.torch_policy  # noqa: F401 - the port's thread policy
from yolo_ms_tpu.models.decode import make_anchors as jax_make_anchors
from yolo_ms_tpu.ops.iou import bbox_iou as jax_bbox_iou
from yolo_ms_tpu.ops.iou import ciou as jax_ciou
from yolo_ms_tpu.train import loss as jloss
from yolo_ms_tpu.train.assigner import task_aligned_assign as jax_assign
from yolo_ms_tpu_torch.ops.iou import bbox_iou, ciou
from yolo_ms_tpu_torch.train import loss as tloss
from yolo_ms_tpu_torch.train.assigner import task_aligned_assign

IOU_KINDS = ("iou", "giou", "diou", "ciou")


def _flags(kind):
    return dict(GIoU=kind == "giou", DIoU=kind == "diou", CIoU=kind == "ciou")


def _boxes(rng, n, xywh):
    c = rng.uniform(10, 90, (n, 2))
    wh = rng.uniform(2, 60, (n, 2))
    if xywh:
        return np.concatenate([c, wh], -1).astype(np.float32)
    return np.concatenate([c - wh / 2, c + wh / 2], -1).astype(np.float32)


@pytest.mark.parametrize("xywh", [True, False])
@pytest.mark.parametrize("kind", IOU_KINDS)
def test_bbox_iou_values_and_gradients(kind, xywh):
    rng = np.random.default_rng(1)
    b1 = _boxes(rng, 48, xywh)[:, None, :]  # [48, 1, 4] x [1, 32, 4] broadcast
    b2 = _boxes(rng, 32, xywh)[None, :, :]

    def jfn(a, b):
        return jax_bbox_iou(a, b, xywh=xywh, **_flags(kind))

    want = np.asarray(jfn(jnp.asarray(b1), jnp.asarray(b2)))
    jg1, jg2 = jax.grad(lambda a, b: jfn(a, b).sum(), argnums=(0, 1))(
        jnp.asarray(b1), jnp.asarray(b2)
    )
    t1 = torch.from_numpy(b1).requires_grad_(True)
    t2 = torch.from_numpy(b2).requires_grad_(True)
    got = bbox_iou(t1, t2, xywh=xywh, **_flags(kind))
    got.sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0, atol=1e-6)
    assert (want > 0.05).sum() > 20  # overlapping pairs are in the sample
    for g, jg in ((t1.grad, jg1), (t2.grad, jg2)):
        jg = np.asarray(jg)
        np.testing.assert_allclose(g.numpy(), jg, rtol=1e-5, atol=1e-5 * np.abs(jg).max())


def test_ciou_alias():
    rng = np.random.default_rng(2)
    a, b = _boxes(rng, 16, False), _boxes(rng, 16, False)
    want = np.asarray(jax_ciou(jnp.asarray(a), jnp.asarray(b)))
    got = ciou(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


# --------------------------------------------------------------- assigner

IMG = 64
SHAPES = [(IMG // s, IMG // s) for s in (8, 16, 32)]


def _assign_inputs(seed, nc=4, b=2, m=6):
    """Predictions scattered around the anchors, GT boxes over the image,
    padding rows, and a run of 14 anchors with identical predictions inside
    the first GT box: exact metric ties, more of them than top-k picks, so
    the picks depend on the first-index order."""
    rng = np.random.default_rng(seed)
    anchors, strides = jax_make_anchors(SHAPES)
    anchors_px = np.asarray(anchors * strides)  # [A, 2]
    a = anchors_px.shape[0]
    stride = np.asarray(strides)[:, 0]
    ltrb = rng.uniform(0.3, 4.0, (b, a, 4)) * stride[None, :, None]
    pd_boxes = np.concatenate(
        [anchors_px[None] - ltrb[..., :2], anchors_px[None] + ltrb[..., 2:]], -1
    ).astype(np.float32)
    pd_scores = (1 / (1 + np.exp(-rng.normal(0, 2, (b, a, nc))))).astype(np.float32)
    c = rng.uniform(12, 52, (b, m, 2))
    wh = rng.uniform(12, 40, (b, m, 2))
    gt = np.concatenate([c - wh / 2, c + wh / 2], -1).astype(np.float32)
    gt[0, 1] = gt[0, 0] + 2.0  # an overlapping pair: conflicts to resolve
    gt[:, 0] = [8.0, 8.0, 56.0, 56.0]  # a big box holding the tie run
    labels = rng.integers(0, nc, (b, m)).astype(np.int32)
    mask = np.ones((b, m), bool)
    mask[1, -2:] = False
    gt[1, -2:] = 0.0
    # ties: the first stride-8 anchors inside GT 0 share one prediction
    inside = np.flatnonzero(
        (anchors_px[:64, 0] > 12) & (anchors_px[:64, 0] < 52)
        & (anchors_px[:64, 1] > 12) & (anchors_px[:64, 1] < 52)
    )[:14]
    pd_boxes[:, inside] = pd_boxes[:, inside[:1]]  # the same box: the same IoU
    pd_scores[:, inside] = pd_scores[:, inside[:1]]
    return pd_scores, pd_boxes, anchors_px.astype(np.float32), labels, gt, mask


@pytest.mark.parametrize("topk", [10, 3, 200])
@pytest.mark.parametrize("seed", [0, 1])
def test_assigner_matches_jax(seed, topk):
    nc = 4
    inputs = _assign_inputs(seed, nc)
    want = jax.device_get(
        jax_assign(*[jnp.asarray(x) for x in inputs], num_classes=nc, topk=topk)
    )
    got = task_aligned_assign(*[torch.from_numpy(x) for x in inputs], num_classes=nc,
                              topk=topk)
    labels, boxes, scores, fg = (t.numpy() for t in got)
    np.testing.assert_array_equal(fg, want[3])
    np.testing.assert_array_equal(labels, want[0])
    np.testing.assert_array_equal(boxes, want[1])
    np.testing.assert_allclose(scores, want[2], rtol=0, atol=1e-6)
    assert fg.sum() > 5


def test_assigner_outputs_carry_no_gradient():
    inputs = [torch.from_numpy(x) for x in _assign_inputs(0)]
    inputs[0].requires_grad_(True)
    inputs[1].requires_grad_(True)
    out = task_aligned_assign(*inputs, num_classes=4)
    assert not any(t.requires_grad for t in out)
    assert out[0].dtype == torch.int32 and out[3].dtype == torch.bool


# ------------------------------------------------------------------- loss

NC = 3
NO = 4 * 16 + NC


def _raw_maps(seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal((2, h, w, NO)) * 1.5).astype(dtype) for h, w in SHAPES]


def _targets(seed):
    rng = np.random.default_rng(seed + 100)
    m = 5
    c = rng.uniform(0.3, 0.7, (2, m, 2))
    wh = rng.uniform(0.3, 0.8, (2, m, 2))
    boxes = np.concatenate([c, wh], -1).astype(np.float32)
    labels = rng.integers(0, NC, (2, m)).astype(np.int32)
    mask = np.ones((2, m), bool)
    mask[0, 3:] = False
    mask[1, 4:] = False
    return boxes, labels, mask


def test_dfl_helpers_match_jax():
    rng = np.random.default_rng(3)
    dist = (rng.standard_normal((2, 20, 4, 16)) * 3).astype(np.float32)
    dist[0, 0, 0, 5] = 90.0  # a side far below the row max: the -60 clamp
    target = rng.uniform(-1, 16, (2, 20, 4)).astype(np.float32)
    jl, jz = jloss._dfl_expectation_logz(jnp.asarray(dist))
    tl, tz = tloss._dfl_expectation_logz(torch.from_numpy(dist))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(tz.numpy(), np.asarray(jz), rtol=1e-6, atol=1e-6)
    jce = jloss._dfl_ce_from_logz(jnp.asarray(dist), jz, jnp.asarray(target), 16)
    tce = tloss._dfl_ce_from_logz(torch.from_numpy(dist), tz, torch.from_numpy(target), 16)
    np.testing.assert_allclose(tce.numpy(), np.asarray(jce), rtol=1e-5, atol=1e-5)
    logits = torch.from_numpy(dist[..., 0])
    tgt = torch.from_numpy(rng.uniform(0, 1, logits.shape).astype(np.float32))
    np.testing.assert_allclose(
        tloss._bce_logits(logits, tgt).numpy(),
        np.asarray(jloss._bce_logits(jnp.asarray(logits.numpy()), jnp.asarray(tgt.numpy()))),
        rtol=1e-6, atol=1e-6,
    )


LOSSES = {
    "ciou_bce": {},
    "focal": {"use_focal": True},
    "giou": {"iou_type": "giou"},
    "diou": {"iou_type": "diou"},
    "iou": {"iou_type": "iou"},
}


@pytest.mark.parametrize("name", sorted(LOSSES))
def test_detection_loss_terms_and_gradients(name):
    kw = LOSSES[name]
    maps = _raw_maps(0)
    boxes, labels, mask = _targets(0)
    jfn = jloss.DetectionLoss(num_classes=NC, **kw)
    tfn = tloss.DetectionLoss(num_classes=NC, **kw)
    gt = (jnp.asarray(boxes), jnp.asarray(labels), jnp.asarray(mask))

    (jtotal, jm), jgrads = jax.jit(
        jax.value_and_grad(lambda ms: jfn(ms, *gt), has_aux=True)
    )([jnp.asarray(m) for m in maps])
    nchw = [torch.from_numpy(m).permute(0, 3, 1, 2).contiguous().requires_grad_(True)
            for m in maps]
    total, metrics = tfn(nchw, *(torch.from_numpy(x) for x in (boxes, labels, mask)))
    total.backward()

    assert int(metrics["num_fg"]) == int(jm["num_fg"]) > 0
    for k in ("loss_box", "loss_cls", "loss_dfl", "total_loss"):
        np.testing.assert_allclose(metrics[k].item(), float(jm[k]), rtol=1e-5, err_msg=k)
    np.testing.assert_allclose(total.item(), float(jtotal), rtol=1e-5)
    for t, jg in zip(nchw, jgrads):
        jg = np.asarray(jg)
        g = t.grad.permute(0, 2, 3, 1).numpy()
        np.testing.assert_allclose(g, jg, rtol=1e-4, atol=1e-4 * np.abs(jg).max())


def test_detection_loss_on_bf16_maps():
    """The training path feeds bf16 maps (autocast); both losses compute in
    f32 from the same bf16 values."""
    maps32 = _raw_maps(1)
    boxes, labels, mask = _targets(1)
    jmaps = [jnp.asarray(m, jnp.bfloat16) for m in maps32]
    tmaps = [torch.from_numpy(np.asarray(m, np.float32)).to(torch.bfloat16)
             .permute(0, 3, 1, 2) for m in jax.device_get(jmaps)]
    _, jm = jloss.DetectionLoss(num_classes=NC)(jmaps, boxes, labels, mask)
    _, tm = tloss.DetectionLoss(num_classes=NC)(
        tmaps, *(torch.from_numpy(x) for x in (boxes, labels, mask)))
    assert int(tm["num_fg"]) == int(jm["num_fg"]) > 0
    for k in ("loss_box", "loss_cls", "loss_dfl", "total_loss"):
        assert tm[k].dtype == torch.float32
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-5, err_msg=k)


def test_unknown_iou_type_raises():
    maps = [torch.from_numpy(m).permute(0, 3, 1, 2) for m in _raw_maps(0)]
    boxes, labels, mask = (torch.from_numpy(x) for x in _targets(0))
    with pytest.raises(ValueError):
        tloss.DetectionLoss(num_classes=NC, iou_type="siou")(maps, boxes, labels, mask)
