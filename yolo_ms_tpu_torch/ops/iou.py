"""Box conversions and the IoU family (IoU / GIoU / DIoU / CIoU).

Port of ``yolo_ms_tpu/ops/iou.py``. All functions broadcast over leading
dimensions.
"""

from __future__ import annotations

import math

import torch


def xywh_to_xyxy(boxes: torch.Tensor) -> torch.Tensor:
    """(cx, cy, w, h) -> (x1, y1, x2, y2)."""
    c, half = boxes[..., :2], boxes[..., 2:4] / 2.0
    return torch.cat([c - half, c + half], dim=-1)


def box_iou_xyxy(box1: torch.Tensor, box2: torch.Tensor, eps: float = 1e-7):
    """Elementwise (broadcasting) IoU of xyxy boxes."""
    ix1 = torch.maximum(box1[..., 0], box2[..., 0])
    iy1 = torch.maximum(box1[..., 1], box2[..., 1])
    ix2 = torch.minimum(box1[..., 2], box2[..., 2])
    iy2 = torch.minimum(box1[..., 3], box2[..., 3])
    inter = (ix2 - ix1).clamp(min=0) * (iy2 - iy1).clamp(min=0)
    a1 = (box1[..., 2] - box1[..., 0]) * (box1[..., 3] - box1[..., 1])
    a2 = (box2[..., 2] - box2[..., 0]) * (box2[..., 3] - box2[..., 1])
    return inter / (a1 + a2 - inter + eps)


def pairwise_iou_xyxy(boxes: torch.Tensor, eps: float = 1e-7) -> torch.Tensor:
    """[..., N, 4] -> [..., N, N] IoU matrix."""
    return box_iou_xyxy(boxes[..., :, None, :], boxes[..., None, :, :], eps)


def bbox_iou(
    box1: torch.Tensor,
    box2: torch.Tensor,
    xywh: bool = True,
    GIoU: bool = False,
    DIoU: bool = False,
    CIoU: bool = False,
    eps: float = 1e-7,
) -> torch.Tensor:
    """IoU / GIoU / DIoU / CIoU, the JAX function's math term for term.

    CIoU's aspect-ratio coefficient alpha is detached, as the JAX
    ``stop_gradient``, so the gradients match too.
    """
    b1 = xywh_to_xyxy(box1) if xywh else box1
    b2 = xywh_to_xyxy(box2) if xywh else box2

    ix1 = torch.maximum(b1[..., 0], b2[..., 0])
    iy1 = torch.maximum(b1[..., 1], b2[..., 1])
    ix2 = torch.minimum(b1[..., 2], b2[..., 2])
    iy2 = torch.minimum(b1[..., 3], b2[..., 3])
    inter = (ix2 - ix1).clamp(min=0) * (iy2 - iy1).clamp(min=0)

    a1 = (b1[..., 2] - b1[..., 0]) * (b1[..., 3] - b1[..., 1])
    a2 = (b2[..., 2] - b2[..., 0]) * (b2[..., 3] - b2[..., 1])
    union = a1 + a2 - inter + eps
    iou = inter / union

    if not (GIoU or DIoU or CIoU):
        return iou

    ex1 = torch.minimum(b1[..., 0], b2[..., 0])
    ey1 = torch.minimum(b1[..., 1], b2[..., 1])
    ex2 = torch.maximum(b1[..., 2], b2[..., 2])
    ey2 = torch.maximum(b1[..., 3], b2[..., 3])
    ew = (ex2 - ex1).clamp(min=0)
    eh = (ey2 - ey1).clamp(min=0)

    if GIoU:
        enclose_area = ew * eh + eps
        return iou - (enclose_area - union) / enclose_area

    c1x = (b1[..., 0] + b1[..., 2]) / 2
    c1y = (b1[..., 1] + b1[..., 3]) / 2
    c2x = (b2[..., 0] + b2[..., 2]) / 2
    c2y = (b2[..., 1] + b2[..., 3]) / 2
    center_dist_sq = (c1x - c2x) ** 2 + (c1y - c2y) ** 2
    diag_sq = ew**2 + eh**2 + eps
    diou_term = center_dist_sq / diag_sq
    if DIoU:
        return iou - diou_term

    w1 = b1[..., 2] - b1[..., 0]
    h1 = b1[..., 3] - b1[..., 1]
    w2 = b2[..., 2] - b2[..., 0]
    h2 = b2[..., 3] - b2[..., 1]
    v = (4 / math.pi**2) * (
        torch.atan(w2 / (h2 + eps)) - torch.atan(w1 / (h1 + eps))
    ) ** 2
    alpha = (v / (1 - iou + v + eps)).detach()
    return iou - diou_term - alpha * v


def ciou(box1: torch.Tensor, box2: torch.Tensor, xywh: bool = False) -> torch.Tensor:
    """Complete IoU (broadcasting elementwise)."""
    return bbox_iou(box1, box2, xywh=xywh, CIoU=True)
