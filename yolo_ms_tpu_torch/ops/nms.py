"""Batched class-aware NMS with fixed shapes.

Port of ``yolo_ms_tpu/ops/nms.py``. The batch dimension is written out
(``bmm``) where the JAX package vmaps a per-image function: every function
here takes [B, N, ...] tensors.
"""

from __future__ import annotations

import torch

from yolo_ms_tpu_torch.ops.iou import pairwise_iou_xyxy, xywh_to_xyxy

# Class-offset stride: larger than any coordinate the model can produce, so
# boxes of different classes never overlap after the shift.
CLASS_OFFSET = 8192.0


def nms_greedy_scan(boxes, scores, iou_thresh: float) -> torch.Tensor:
    """Reference: the sequential greedy scan, one step per box.

    boxes [B, N, 4] xyxy sorted by descending score; scores [B, N] (< 0
    marks padding). Returns keep [B, N] bool."""
    n = boxes.shape[-2]
    overlap = pairwise_iou_xyxy(boxes) > iou_thresh
    keep = (scores > 0.0).clone()
    for i in range(n):
        suppressed = (overlap[:, i, :i] & keep[:, :i]).any(dim=-1)
        keep[:, i] &= ~suppressed
    return keep


def nms_fixed(boxes, scores, iou_thresh: float) -> torch.Tensor:
    """Exact greedy NMS as a fixed point of matrix sweeps.

    Greedy keep is the fixed point of
        keep[i] <- valid[i] and not any_{j<i}(overlap[i, j] and keep[j])
    starting from keep = valid; each sweep is one batched [N, N] x [N]
    product. The loop stops when a sweep changes nothing (at most N sweeps,
    where the result equals the sequential scan by induction). Each stop
    test reads one flag on the host; ``nms_fixed.sweeps`` counts the sweeps
    run, over all calls.

    boxes [B, N, 4] xyxy sorted by descending score; scores [B, N] (< 0
    marks padding). Returns keep [B, N] bool.
    """
    n = boxes.shape[-2]
    iou = pairwise_iou_xyxy(boxes)
    # strictly lower triangle: a higher-scored j < i may suppress i
    tri = torch.ones(n, n, dtype=torch.bool, device=boxes.device).tril(-1)
    # 0/1 entries: the product is an exact count in f32 (or TF32)
    overlap = ((iou > iou_thresh) & tri).float()
    valid = scores > 0.0
    keep = valid
    for _ in range(n):
        suppressed = torch.bmm(overlap, keep.float().unsqueeze(-1)).squeeze(-1) > 0.0
        new = valid & ~suppressed
        nms_fixed.sweeps += 1
        if torch.equal(new, keep):
            break
        keep = new
    return keep


nms_fixed.sweeps = 0


def gather_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x [B, N, ...] rows at idx [B, K] -> [B, K, ...]."""
    if x.dim() == 2:
        return torch.gather(x, 1, idx)
    return torch.gather(x, 1, idx[..., None].expand(-1, -1, x.shape[-1]))


def batched_nms(
    preds: torch.Tensor,
    conf_thresh: float = 0.25,
    iou_thresh: float = 0.45,
    pre_nms_topk: int = 1024,
    max_det: int = 300,
):
    """Class-aware NMS of decoded predictions [B, A, 4+nc] ((cx, cy, w, h)
    px, then sigmoid scores) -> dict of 'boxes' [B, max_det, 4] xyxy,
    'scores', 'classes' (int32), 'valid' (bool). Invalid rows have score -1."""
    b, a, _ = preds.shape
    boxes = xywh_to_xyxy(preds[..., :4])
    cls_scores = preds[..., 4:]
    scores = cls_scores.amax(dim=-1)
    classes = cls_scores.argmax(dim=-1).to(torch.int32)
    # confidence gate (the reference uses strict >)
    scores = torch.where(scores > conf_thresh, scores, -1.0)

    k = min(pre_nms_topk, a)
    top_scores, top_idx = torch.topk(scores, k, dim=1)
    top_boxes = gather_rows(boxes, top_idx)
    top_classes = gather_rows(classes, top_idx)
    shifted = top_boxes + top_classes[..., None].to(top_boxes.dtype) * CLASS_OFFSET
    keep = nms_fixed(shifted, top_scores, iou_thresh)
    kept = torch.where(keep, top_scores, -1.0)

    kd = min(max_det, k)
    out_scores, out_idx = torch.topk(kept, kd, dim=1)
    out_boxes = gather_rows(top_boxes, out_idx)
    out_classes = gather_rows(top_classes, out_idx)
    valid = out_scores > 0.0
    pad = max_det - kd
    if pad:
        out_boxes = torch.nn.functional.pad(out_boxes, (0, 0, 0, pad))
        out_scores = torch.nn.functional.pad(out_scores, (0, pad), value=-1.0)
        out_classes = torch.nn.functional.pad(out_classes, (0, pad))
        valid = torch.nn.functional.pad(valid, (0, pad))
    return {
        "boxes": out_boxes,
        "scores": out_scores,
        "classes": out_classes,
        "valid": valid,
    }
