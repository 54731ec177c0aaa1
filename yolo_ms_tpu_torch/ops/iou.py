"""Box conversions and IoU (the serving subset of ``yolo_ms_tpu/ops/iou.py``).

All functions broadcast over leading dimensions.
"""

from __future__ import annotations

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
