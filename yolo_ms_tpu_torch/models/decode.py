"""Anchor generation + DFL box decode on NHWC raw maps.

Port of ``yolo_ms_tpu/models/decode.py``. The functions keep the JAX
layout: they take the per-scale maps as NHWC ([B, H, W, 4*reg_max+nc]; a
``permute(0, 2, 3, 1)`` view of the network's NCHW output) and return the
reference eval contract [B, A, 4+nc]: (cx, cy, w, h) pixels, then sigmoid
class scores. Box math runs in f32 whatever the maps' dtype.
"""

from __future__ import annotations

from typing import Sequence

import torch

from yolo_ms_tpu_torch.nn.blocks import dfl_expectation

DEFAULT_STRIDES: tuple[int, ...] = (8, 16, 32)


def make_anchors(
    shapes: Sequence[tuple[int, int]],
    strides: Sequence[int] = DEFAULT_STRIDES,
    device=None,
):
    """Grid-center anchors (x+0.5, y+0.5) in grid units, row-major per level,
    concatenated over levels. Returns (anchors [A, 2], strides [A, 1])."""
    anchor_list, stride_list = [], []
    for (h, w), s in zip(shapes, strides):
        sx = torch.arange(w, dtype=torch.float32, device=device) + 0.5
        sy = torch.arange(h, dtype=torch.float32, device=device) + 0.5
        gy, gx = torch.meshgrid(sy, sx, indexing="ij")
        anchor_list.append(torch.stack([gx, gy], dim=-1).reshape(-1, 2))
        stride_list.append(
            torch.full((h * w, 1), float(s), dtype=torch.float32, device=device)
        )
    return torch.cat(anchor_list), torch.cat(stride_list)


def flatten_maps(raw_maps, num_classes: int, reg_max: int = 16):
    """NHWC maps -> (box_dist [B, A, 4, reg_max], cls [B, A, nc])."""
    no = 4 * reg_max + num_classes
    flat = []
    for m in raw_maps:
        b, h, w, c = m.shape
        if c != no:
            raise ValueError(f"expected {no} channels, got {c}")
        flat.append(m.reshape(b, h * w, c))
    x = torch.cat(flat, dim=1)
    box_dist = x[..., : 4 * reg_max].reshape(x.shape[0], x.shape[1], 4, reg_max)
    return box_dist, x[..., 4 * reg_max :]


def decode_boxes(box_dist, anchors, strides):
    """DFL distributions [B, A, 4, reg_max] -> (cx, cy, w, h) pixels."""
    ltrb = dfl_expectation(box_dist)
    x1y1 = anchors[None] - ltrb[..., :2]
    x2y2 = anchors[None] + ltrb[..., 2:]
    return torch.cat([(x1y1 + x2y2) / 2.0, x2y2 - x1y1], dim=-1) * strides[None]


def decode_predictions(
    raw_maps,
    num_classes: int,
    reg_max: int = 16,
    strides: Sequence[int] = DEFAULT_STRIDES,
) -> torch.Tensor:
    """NHWC raw maps -> [B, A, 4+nc]: boxes (cx, cy, w, h) px + sigmoid."""
    shapes = [(m.shape[1], m.shape[2]) for m in raw_maps]
    anchors, stride_t = make_anchors(shapes, strides, device=raw_maps[0].device)
    box_dist, cls = flatten_maps([m.float() for m in raw_maps], num_classes, reg_max)
    boxes = decode_boxes(box_dist, anchors, stride_t)
    return torch.cat([boxes, torch.sigmoid(cls)], dim=-1)
