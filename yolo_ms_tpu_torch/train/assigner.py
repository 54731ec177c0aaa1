"""Task-Aligned assigner — dense and vectorized over padded ground truth.

Port of ``yolo_ms_tpu/train/assigner.py:task_aligned_assign`` in its default
lowering (``_VARIANT_CLS="einsum"``, ``_VARIANT_TOPK="argmax"``); the A/B
variants of the JAX module are not ported.

Algorithm (task-aligned learning):
  1. alignment metric  t = score^alpha * iou^beta  per (gt, anchor)
  2. candidate anchors = centers inside the gt box
  3. top-k candidates per gt by metric
  4. conflicts (anchor claimed by >1 gt) resolved to the gt with highest IoU
  5. targets: assigned gt box/label per anchor; target scores are the one-hot
     class scaled by the normalized alignment metric (TAL soft labels)

The JAX function stores its [B, M, A] ranking tensors in bf16, and where it
rounds is part of the result: near-ties pick other anchors if the rounding
moves. The same points round here: the clipped IoUs, the gathered class
scores, and the masked metric (computed in f32 from those two, then rounded).
The top-k is k passes of first-index argmax on the bf16 metric, never
``torch.topk``, whose order among equal values is not defined. The soft-label
normalization stays in bf16 and rounds after every operation, as the JAX
function's bf16 arithmetic does. The HIGHEST-precision einsum that gathers
targets is an exact gather by the assigned index.

Shapes: B batch, M max_gt (padded; mask_gt marks real rows), A anchors.
"""

from __future__ import annotations

import torch

from yolo_ms_tpu_torch.ops.iou import bbox_iou


@torch.no_grad()
def task_aligned_assign(
    pd_scores: torch.Tensor,  # [B, A, nc] sigmoid class scores
    pd_bboxes: torch.Tensor,  # [B, A, 4] decoded boxes, xyxy, pixels
    anchor_points: torch.Tensor,  # [A, 2] anchor centers, pixels
    gt_labels: torch.Tensor,  # [B, M] int class ids (padding rows arbitrary)
    gt_bboxes: torch.Tensor,  # [B, M, 4] xyxy pixels (padding rows zeros)
    mask_gt: torch.Tensor,  # [B, M] bool validity of gt rows
    num_classes: int,
    topk: int = 10,
    alpha: float = 0.5,
    beta: float = 6.0,
    eps: float = 1e-9,
):
    """Returns (target_labels [B,A] i32, target_bboxes [B,A,4] f32,
    target_scores [B,A,nc] f32, fg_mask [B,A] bool). Gradients do not flow
    through the assignment (the JAX loss detaches its inputs)."""
    bf16 = torch.bfloat16
    a = pd_scores.shape[1]
    m = gt_bboxes.shape[1]

    # --- candidate mask: anchor center strictly inside gt box [B, M, A] ---
    ax = anchor_points[None, None, :, 0]
    ay = anchor_points[None, None, :, 1]
    in_gts = (
        (ax - gt_bboxes[..., None, 0] > eps)
        & (ay - gt_bboxes[..., None, 1] > eps)
        & (gt_bboxes[..., None, 2] - ax > eps)
        & (gt_bboxes[..., None, 3] - ay > eps)
    )
    mask_in = in_gts & mask_gt[..., None]

    # --- alignment metric [B, M, A], stored bf16 ---
    ious = bbox_iou(
        gt_bboxes[:, :, None, :], pd_bboxes[:, None, :, :], xywh=False, CIoU=True
    )
    ious = ious.clamp(min=0.0).to(bf16)
    gt_cls = gt_labels.clamp(0, num_classes - 1).long()  # [B, M]
    # the one-hot contraction of the JAX function picks one score per
    # (gt, anchor): a gather, rounded to bf16 as its bf16 output is
    cls_scores = torch.gather(
        pd_scores.transpose(1, 2), 1, gt_cls[:, :, None].expand(-1, -1, a)
    ).to(bf16)
    metric = cls_scores.float().pow(alpha) * ious.float().pow(beta)
    metric = torch.where(mask_in, metric, 0.0).to(bf16)

    # --- top-k per gt: k first-index argmax passes on the bf16 metric ---
    k = min(topk, a)
    work = metric.clone()
    for _ in range(k):
        pick = work.argmax(dim=-1, keepdim=True)  # [B, M, 1]
        work.scatter_(-1, pick, -1.0)
    # picked <=> masked to -1 (metric >= 0 elsewhere); (> eps) drops picks
    # made after a row ran out of positive metrics
    mask_pos = (work < 0) & (metric > eps) & mask_in

    # --- conflict resolution: the claiming gt with the highest IoU ---
    ious_masked = torch.where(mask_pos, ious, torch.tensor(-1.0, dtype=bf16))
    best_gt = ious_masked.argmax(dim=1)  # [B, A], first index on ties
    row = torch.arange(m, device=gt_bboxes.device)[None, :, None]
    mask_pos = mask_pos & (row == best_gt[:, None, :])
    fg_mask = mask_pos.any(dim=1)  # [B, A]

    # --- targets: an exact gather by the assigned gt ---
    idx = best_gt[..., None]
    target_bboxes = torch.gather(gt_bboxes, 1, idx.expand(-1, -1, 4))
    target_bboxes = torch.where(fg_mask[..., None], target_bboxes, 0.0)
    assigned_cls = torch.gather(gt_cls, 1, best_gt)
    target_labels = torch.where(fg_mask, assigned_cls, 0).to(torch.int32)

    # --- TAL soft scores: one-hot * normalized metric, in bf16 op by op ---
    zero = torch.tensor(0.0, dtype=bf16)
    metric_pos = torch.where(mask_pos, metric, zero)
    iou_pos = torch.where(mask_pos, ious, zero)
    gt_max_metric = metric_pos.amax(dim=2, keepdim=True)  # [B, M, 1]
    gt_max_iou = iou_pos.amax(dim=2, keepdim=True)
    norm_metric = metric_pos * gt_max_iou / (gt_max_metric + eps)
    anchor_score = norm_metric.amax(dim=1).float()  # [B, A]

    label_onehot = torch.nn.functional.one_hot(
        target_labels.long(), num_classes
    ).to(pd_scores.dtype) * fg_mask[..., None]
    target_scores = label_onehot * anchor_score[..., None]
    target_scores = torch.where(fg_mask[..., None], target_scores, 0.0)
    return target_labels, target_bboxes, target_scores, fg_mask
