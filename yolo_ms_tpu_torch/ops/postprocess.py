"""Fused serving post-process: raw head maps -> final detections.

Port of ``yolo_ms_tpu/ops/postprocess.py:fused_postprocess``, with the
structure of its ``use_pallas=True`` branch: one ``select_scales`` launch
yields (max logit, class id, ltrb) for every anchor of every scale, written
straight into the concatenated outputs; the top ``pre_nms_topk`` anchors are
taken with ``torch.topk``,
gated by confidence (strict ``sigmoid > conf_thresh``), their ltrb and class
ids gathered, their anchors computed arithmetically from the flat index,
then greedy NMS (``nms_fixed``, one launch of the NMS kernel on the card;
class-offset unless ``class_aware=False``),
the top ``max_det``, and the invalid slots zeroed.

What differs from the JAX function, by design:
- ``approx_max_k(recall_target=1.0)`` is ``torch.topk``; the order of
  anchors whose keys tie exactly may differ;
- the ``prefix_widths`` tiers (``lax.cond``) are not ported: the dense
  width-K tail is the one the JAX docstring documents as output-identical;
- the TPU one-hot matmul gathers are ``torch.gather`` (exact either way).
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F

from yolo_ms_tpu_torch.nn.blocks import DEFAULT_STRIDES
from yolo_ms_tpu_torch.ops.kernels.select import select_scales, select_scales_plain
from yolo_ms_tpu_torch.ops.nms import CLASS_OFFSET, gather_rows, nms_fixed


def fused_postprocess(
    raw_maps: Sequence,
    num_classes: int,
    reg_max: int = 16,
    strides: Sequence[int] = DEFAULT_STRIDES,
    conf_thresh: float = 0.25,
    iou_thresh: float = 0.45,
    pre_nms_topk: int = 1024,
    max_det: int = 300,
    class_aware: bool = True,
    use_kernel: bool = True,
):
    """Per-scale NHWC maps [B, H, W, 4*reg_max+nc], or (box [B, H, W,
    4*reg_max], cls [B, H, W, nc]) pairs, -> dict of 'boxes' [B, max_det, 4]
    xyxy f32 px, 'scores' [B, max_det] f32, 'classes' [B, max_det] i32 and
    'valid' [B, max_det] bool. Invalid slots are all zero.

    The maps may be views with any strides (a ``permute(0, 2, 3, 1)`` of the
    NCHW head output is read in place). NMS is per class unless
    ``class_aware=False`` or there is one class (the JAX rule).
    ``use_kernel=False`` runs the plain torch versions of ``select_scales``
    and of the NMS fixed point on any device.

    It traces for ``torch.export`` as it is: every shape is static, the
    constants below are built from those shapes, and the select kernel and
    the NMS kernel are ``torch.library`` ops. On the card it reads nothing
    back on the host.
    """
    split = isinstance(raw_maps[0], (tuple, list))
    nb = 4 * reg_max
    pairs, shapes = [], []
    for m in raw_maps:
        if split:
            box_m, cls_m = m
            box, cls = box_m.flatten(1, 2), cls_m.flatten(1, 2)
            h, w = box_m.shape[1:3]
        else:
            flat = m.flatten(1, 2)
            box, cls = flat[..., :nb], flat[..., nb:]
            h, w = m.shape[1:3]
        if cls.shape[-1] != num_classes:
            raise ValueError(f"expected {num_classes} class channels, got {cls.shape[-1]}")
        pairs.append((box, cls))
        shapes.append((h, w))
    # [B, A] f32, [B, A] i32, [B, A, 4] f32: one launch writes all scales
    select_fn = select_scales if use_kernel else select_scales_plain
    max_logit, cls_id, ltrb_all = select_fn(pairs, reg_max)
    dev = max_logit.device
    a = max_logit.shape[1]
    k = min(pre_nms_topk, a)

    top_logit, idx = torch.topk(max_logit, k, dim=1)
    # confidence gate (the reference uses strict >); sigmoid only on the K
    scores = torch.sigmoid(top_logit)
    scores = torch.where(scores > conf_thresh, scores, -1.0)
    ltrb = gather_rows(ltrb_all, idx)
    classes = gather_rows(cls_id, idx)

    # anchors and strides from the flat index: level bounds are static, so
    # each level's width, first index and stride enter as Python scalars,
    # with no copy from the host
    offs = np.cumsum([0] + [h * w for h, w in shapes])
    width_t = torch.full_like(idx, shapes[0][1])
    base_t = torch.zeros_like(idx)
    stride_k = torch.full(idx.shape, float(strides[0]), dtype=torch.float32, device=dev)
    for i in range(1, len(shapes)):
        upper = idx >= int(offs[i])
        width_t = torch.where(upper, shapes[i][1], width_t)
        base_t = torch.where(upper, int(offs[i]), base_t)
        stride_k = torch.where(upper, float(strides[i]), stride_k)
    stride_k = stride_k[..., None]
    local = idx - base_t
    ax = (local % width_t).float() + 0.5
    ay = torch.div(local, width_t, rounding_mode="floor").float() + 0.5
    anchors_k = torch.stack([ax, ay], dim=-1)  # [B, K, 2] grid units

    x1y1 = (anchors_k - ltrb[..., :2]) * stride_k
    x2y2 = (anchors_k + ltrb[..., 2:]) * stride_k
    boxes = torch.cat([x1y1, x2y2], dim=-1)  # xyxy px

    # class-aware: boxes of different classes never overlap after the shift
    shifted = boxes
    if class_aware and num_classes > 1:
        shifted = boxes + classes[..., None].float() * CLASS_OFFSET
    keep = nms_fixed(shifted, scores, iou_thresh, use_kernel=use_kernel)
    kept = torch.where(keep, scores, -1.0)

    kd = min(max_det, k)
    out_scores, out_idx = torch.topk(kept, kd, dim=1)
    valid = out_scores > 0.0
    # invalid slots are canonical zeros, whatever candidate topk put there
    out_boxes = torch.where(valid[..., None], gather_rows(boxes, out_idx), 0.0)
    out_classes = torch.where(valid, gather_rows(classes, out_idx), 0)
    out_scores = out_scores.clamp(min=0.0)
    pad = max_det - kd
    if pad:
        out_boxes = F.pad(out_boxes, (0, 0, 0, pad))
        out_scores = F.pad(out_scores, (0, pad))
        out_classes = F.pad(out_classes, (0, pad))
        valid = F.pad(valid, (0, pad))
    return {
        "boxes": out_boxes,
        "scores": out_scores,
        "classes": out_classes.to(torch.int32),
        "valid": valid,
    }
