"""Fused serving post-process: raw head maps -> final detections.

Port of ``yolo_ms_tpu/ops/postprocess.py:fused_postprocess``, with the
structure of its ``use_pallas=True`` branch: per scale the ``select`` kernel
yields (max logit, class id, ltrb) for every anchor; the scales are
concatenated, the top ``pre_nms_topk`` anchors are taken with ``torch.topk``,
gated by confidence (strict ``sigmoid > conf_thresh``), their ltrb and class
ids gathered, their anchors computed arithmetically from the flat index,
then class-offset greedy NMS (``nms_fixed``), the top ``max_det``, and the
invalid slots zeroed.

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

from yolo_ms_tpu_torch.models.decode import DEFAULT_STRIDES
from yolo_ms_tpu_torch.ops.kernels.select import select, select_plain
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
    use_kernel: bool = True,
):
    """Per-scale NHWC maps [B, H, W, 4*reg_max+nc], or (box [B, H, W,
    4*reg_max], cls [B, H, W, nc]) pairs, -> dict of 'boxes' [B, max_det, 4]
    xyxy f32 px, 'scores' [B, max_det] f32, 'classes' [B, max_det] i32 and
    'valid' [B, max_det] bool. Invalid slots are all zero.

    The maps may be views with any strides (a ``permute(0, 2, 3, 1)`` of the
    NCHW head output is read in place). ``use_kernel=False`` runs the plain
    torch version of ``select`` on any device.
    """
    select_fn = select if use_kernel else select_plain
    split = isinstance(raw_maps[0], (tuple, list))
    nb = 4 * reg_max
    mx_l, cid_l, ltrb_l, shapes = [], [], [], []
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
        mx, cid, ltrb = select_fn(box, cls, reg_max)
        mx_l.append(mx)
        cid_l.append(cid)
        ltrb_l.append(ltrb)
        shapes.append((h, w))
    max_logit = torch.cat(mx_l, dim=1)  # [B, A] f32
    cls_id = torch.cat(cid_l, dim=1)  # [B, A] i32
    ltrb_all = torch.cat(ltrb_l, dim=1)  # [B, A, 4] f32
    dev = max_logit.device
    a = max_logit.shape[1]
    k = min(pre_nms_topk, a)

    top_logit, idx = torch.topk(max_logit, k, dim=1)
    # confidence gate (the reference uses strict >); sigmoid only on the K
    scores = torch.sigmoid(top_logit)
    scores = torch.where(scores > conf_thresh, scores, -1.0)
    ltrb = gather_rows(ltrb_all, idx)
    classes = gather_rows(cls_id, idx)

    # anchors and strides from the flat index: level bounds are static
    offs = np.cumsum([0] + [h * w for h, w in shapes])
    lvl = torch.zeros_like(idx)
    for i in range(1, len(shapes)):
        lvl += (idx >= int(offs[i])).long()
    width_t = torch.tensor([w for _, w in shapes], dtype=idx.dtype, device=dev)[lvl]
    base_t = torch.tensor(offs[:-1].tolist(), dtype=idx.dtype, device=dev)[lvl]
    stride_k = torch.tensor(
        [float(s) for s in strides[: len(shapes)]], dtype=torch.float32, device=dev
    )[lvl][..., None]
    local = idx - base_t
    ax = (local % width_t).float() + 0.5
    ay = torch.div(local, width_t, rounding_mode="floor").float() + 0.5
    anchors_k = torch.stack([ax, ay], dim=-1)  # [B, K, 2] grid units

    x1y1 = (anchors_k - ltrb[..., :2]) * stride_k
    x2y2 = (anchors_k + ltrb[..., 2:]) * stride_k
    boxes = torch.cat([x1y1, x2y2], dim=-1)  # xyxy px

    # class-aware: boxes of different classes never overlap after the shift
    shifted = boxes + classes[..., None].float() * CLASS_OFFSET
    keep = nms_fixed(shifted, scores, iou_thresh)
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
