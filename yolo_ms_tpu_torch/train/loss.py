"""Detection loss: TAL assignment + CIoU box + BCE cls + DFL losses.

Port of ``yolo_ms_tpu/train/loss.py``. It takes the head's raw per-scale
maps as the port's network emits them, NCHW [B, 4*reg_max+nc, H, W], reads
them through NHWC views with the port's ``flatten_maps`` / ``make_anchors``,
and computes in f32 whatever the maps' dtype, as the JAX loss does:

- TAL assignment over padded GT [B, M, 4] + mask, on detached predictions;
- box loss: (1 - CIoU) weighted by target scores, normalized by the total
  target score (floored at 1), the global batch's under data parallelism;
- cls loss: BCE-with-logits over all anchors vs TAL soft labels, or the
  focal variant with the (alpha, gamma) knobs;
- DFL loss: two-bin soft-label cross-entropy on stride-normalized ltrb
  distances, with the log-normalizer shared with the box decode.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Sequence

import torch
import torch.distributed as dist

from yolo_ms_tpu_torch.models.decode import DEFAULT_STRIDES, flatten_maps, make_anchors
from yolo_ms_tpu_torch.ops.iou import bbox_iou, xywh_to_xyxy
from yolo_ms_tpu_torch.train.assigner import task_aligned_assign


@dataclasses.dataclass(frozen=True)
class DetectionLoss:
    """Loss configuration (config schema parity: loss + training sections)."""

    num_classes: int
    reg_max: int = 16
    strides: Sequence[int] = DEFAULT_STRIDES
    box_weight: float = 7.5
    cls_weight: float = 0.5
    dfl_weight: float = 1.5
    use_focal: bool = False
    alpha: float = 0.25
    gamma: float = 1.5
    tal_topk: int = 10
    tal_alpha: float = 0.5
    tal_beta: float = 6.0
    iou_type: str = "ciou"
    # the data-parallel process group (None: this process's batch alone)
    group: Any = None

    def __call__(self, raw_maps, gt_boxes, gt_labels, gt_mask):
        """NCHW raw maps -> (total loss, metrics dict), all device tensors."""
        nhwc = [m.permute(0, 2, 3, 1) for m in raw_maps]
        return detection_loss(
            nhwc,
            gt_boxes,
            gt_labels,
            gt_mask,
            num_classes=self.num_classes,
            reg_max=self.reg_max,
            strides=tuple(self.strides),
            box_weight=self.box_weight,
            cls_weight=self.cls_weight,
            dfl_weight=self.dfl_weight,
            use_focal=self.use_focal,
            alpha=self.alpha,
            gamma=self.gamma,
            tal_topk=self.tal_topk,
            tal_alpha=self.tal_alpha,
            tal_beta=self.tal_beta,
            iou_type=self.iou_type,
            group=self.group,
        )


def _bce_logits(logits, targets):
    """Elementwise BCE with logits (stable form)."""
    return logits.clamp(min=0) - logits * targets + torch.log1p(torch.exp(-logits.abs()))


def _dfl_expectation_logz(dist: torch.Tensor):
    """One pass over [B, A, 4, reg_max]: the DFL expectation and the per-side
    log-normalizer, from the same shifted exponentials
    e = exp(max(x - c, -60)) with c the max over all 4*reg_max logits:

        expectation_i = sum_j j*e_ij / sum_j e_ij
        logZ_i        = log(sum_j e_ij) + c

    The JAX function's [4*reg_max, 8] HIGHEST contraction is two f32 sums.
    Returns (ltrb [B,A,4] f32, logz [B,A,4] f32).
    """
    *lead, k, reg_max = dist.shape
    x = dist.float().reshape(*lead, k * reg_max)
    c = x.amax(dim=-1, keepdim=True)
    e = torch.exp(torch.clamp(x - c, min=-60.0)).reshape(*lead, k, reg_max)
    bins = torch.arange(reg_max, dtype=torch.float32, device=dist.device)
    den = e.sum(-1)
    ltrb = (e * bins).sum(-1) / den
    logz = torch.log(den) + c
    return ltrb, logz


def _dfl_ce_from_logz(dist_logits, logz, target, reg_max):
    """Two-bin soft-label CE from the log-normalizer:
    CE = logZ - wl*x[tl] - wr*x[tl+1]."""
    target = target.clamp(0.0, reg_max - 1 - 1e-3)
    tl = torch.floor(target)
    wr = target - tl
    wl = 1.0 - wr
    bins = torch.arange(reg_max, dtype=torch.float32, device=target.device)
    two_hot = wl[..., None] * (bins == tl[..., None]) + wr[..., None] * (
        bins == tl[..., None] + 1.0
    )
    picked = (two_hot * dist_logits.float()).sum(-1)
    return logz - picked


def detection_loss(
    raw_maps: Sequence[torch.Tensor],
    gt_boxes: torch.Tensor,  # [B, M, 4] (cx,cy,w,h) normalized 0-1
    gt_labels: torch.Tensor,  # [B, M] int
    gt_mask: torch.Tensor,  # [B, M] bool
    *,
    num_classes: int,
    reg_max: int = 16,
    strides: tuple = DEFAULT_STRIDES,
    box_weight: float = 7.5,
    cls_weight: float = 0.5,
    dfl_weight: float = 1.5,
    use_focal: bool = False,
    alpha: float = 0.25,
    gamma: float = 1.5,
    tal_topk: int = 10,
    tal_alpha: float = 0.5,
    tal_beta: float = 6.0,
    iou_type: str = "ciou",
    group=None,
):
    """NHWC raw maps -> (total_loss, metrics dict with loss_box / loss_cls /
    loss_dfl / total_loss / num_fg). GT boxes are normalized (cx, cy, w, h)
    and are scaled to input pixels from the strides and map shapes. With a
    data-parallel ``group`` the maps hold this rank's rows; see below."""
    kind = iou_type.lower()
    if kind not in ("iou", "giou", "diou", "ciou"):
        raise ValueError(f"Unsupported iou_type: {iou_type}")
    shapes = [(m.shape[1], m.shape[2]) for m in raw_maps]
    img_h = shapes[0][0] * strides[0]
    img_w = shapes[0][1] * strides[0]
    dev = raw_maps[0].device

    anchors, stride_t = make_anchors(shapes, strides, device=dev)
    box_dist, cls_logits = flatten_maps(raw_maps, num_classes, reg_max)
    cls_logits = cls_logits.float()
    anchors_px = anchors * stride_t

    pd_scores = torch.sigmoid(cls_logits)
    ltrb_px, dfl_logz = _dfl_expectation_logz(box_dist)
    x1y1 = anchors[None] - ltrb_px[..., :2]
    x2y2 = anchors[None] + ltrb_px[..., 2:]
    pd_boxes_px = torch.cat([x1y1, x2y2], dim=-1) * stride_t[None]

    scale = torch.tensor([img_w, img_h, img_w, img_h], dtype=torch.float32, device=dev)
    gt_xyxy = xywh_to_xyxy(gt_boxes.float() * scale)

    # assignment is label generation, not part of the differentiable graph
    _, target_bboxes, target_scores, fg_mask = task_aligned_assign(
        pd_scores.detach(),
        pd_boxes_px.detach(),
        anchors_px,
        gt_labels,
        gt_xyxy,
        gt_mask,
        num_classes=num_classes,
        topk=tal_topk,
        alpha=tal_alpha,
        beta=tal_beta,
    )
    # the normalizer is that of the GLOBAL batch: under data parallelism each
    # rank divides its own sums by max(sum over the ranks, 1), so that the
    # ranks' losses (and their gradients) add up to the global batch's. The
    # target scores come from the assigner and carry no gradient.
    target_scores_sum = target_scores.sum()
    if group is not None:
        dist.all_reduce(target_scores_sum, group=group)
    target_scores_sum = target_scores_sum.clamp(min=1.0)

    if use_focal:
        p = torch.sigmoid(cls_logits)
        ce = _bce_logits(cls_logits, target_scores)
        p_t = p * target_scores + (1 - p) * (1 - target_scores)
        alpha_t = alpha * target_scores + (1 - alpha) * (1 - target_scores)
        loss_cls = (alpha_t * (1 - p_t) ** gamma * ce).sum() / target_scores_sum
    else:
        loss_cls = _bce_logits(cls_logits, target_scores).sum() / target_scores_sum

    weight = target_scores.sum(-1) * fg_mask  # [B, A]
    iou = bbox_iou(
        pd_boxes_px,
        target_bboxes,
        xywh=False,
        GIoU=kind == "giou",
        DIoU=kind == "diou",
        CIoU=kind == "ciou",
    )
    loss_box = ((1.0 - iou) * weight).sum() / target_scores_sum

    tb = target_bboxes / stride_t[None]
    ap = anchors[None]
    t_ltrb = torch.stack(
        [
            ap[..., 0] - tb[..., 0],
            ap[..., 1] - tb[..., 1],
            tb[..., 2] - ap[..., 0],
            tb[..., 3] - ap[..., 1],
        ],
        dim=-1,
    )
    dfl = _dfl_ce_from_logz(box_dist, dfl_logz, t_ltrb, reg_max).mean(-1)
    loss_dfl = (dfl * weight).sum() / target_scores_sum

    total = box_weight * loss_box + cls_weight * loss_cls + dfl_weight * loss_dfl
    metrics = {
        "loss_box": loss_box,
        "loss_cls": loss_cls,
        "loss_dfl": loss_dfl,
        "total_loss": total,
        "num_fg": fg_mask.sum(),
    }
    if group is not None:
        # the reported terms and num_fg are global sums, as the JAX metrics
        # of the global batch are; ``total`` stays this rank's share
        names, fg_dtype = list(metrics), metrics["num_fg"].dtype
        packed = torch.stack([metrics[k].detach().float() for k in names])
        dist.all_reduce(packed, group=group)
        metrics = dict(zip(names, packed.unbind()))
        metrics["num_fg"] = metrics["num_fg"].to(fg_dtype)
    return total, metrics
