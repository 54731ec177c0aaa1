"""Serving-side image preprocessing: ImageNet constants, letterbox, and the
on-device uint8 normalization.

The parts of ``yolo_ms_tpu/data/augment.py`` the serving path runs; the
training augmentations (mosaic, mixup, HSV, affine) are not ported yet.
"""

from __future__ import annotations

import numpy as np
import torch

IMAGENET_MEAN = np.asarray([0.485, 0.456, 0.406], dtype=np.float32)
IMAGENET_STD = np.asarray([0.229, 0.224, 0.225], dtype=np.float32)


def letterbox(img, boxes, out_h, out_w, pad_value=114):
    """Aspect-preserving resize + pad. Returns (img, boxes, scale,
    (pad_x, pad_y)) so detections can be mapped back."""
    import cv2

    h, w = img.shape[:2]
    r = min(out_h / h, out_w / w)
    nh, nw = int(round(h * r)), int(round(w * r))
    resized = cv2.resize(img, (nw, nh), interpolation=cv2.INTER_LINEAR)
    canvas = np.full((out_h, out_w, 3), pad_value, dtype=img.dtype)
    px, py = (out_w - nw) // 2, (out_h - nh) // 2
    canvas[py : py + nh, px : px + nw] = resized
    if len(boxes):
        boxes = boxes * r + np.asarray([px, py, px, py], dtype=np.float32)
    return canvas, boxes, r, (px, py)


def device_normalize_images(images: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """uint8 NHWC -> ImageNet-normalized NHWC in ``dtype``, on the images'
    device; float inputs pass through unchanged.

    One f32 multiply-add, x*s + t with s = 1/(255*std) and t = -mean/std
    (the JAX package's constants, computed the same way in numpy f32), then
    a single cast to the compute dtype.
    """
    if images.dtype != torch.uint8:
        return images
    s = torch.from_numpy(1.0 / (255.0 * IMAGENET_STD)).to(images.device)
    t = torch.from_numpy(-IMAGENET_MEAN / IMAGENET_STD).to(images.device)
    return (images.float() * s + t).to(dtype)
