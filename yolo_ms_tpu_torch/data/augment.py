"""Detection augmentations — numpy/cv2, from scratch.

A copy of ``yolo_ms_tpu/data/augment.py`` for the port; only
``device_normalize_images`` differs, as the torch counterpart of the JAX
function (one f32 multiply-add on the images' device, then a cast).

Re-implements the reference's albumentations pipeline (dataset.py:83-138) as
explicit host-side transforms, plus REAL mosaic and mixup (the reference
declares `mosaic`/`mixup` config knobs at coco_yolov8.yaml:55-56 but never
consumes them — here they are implemented).

Conventions: images are RGB uint8 HWC; boxes are xyxy float32 pixels with a
parallel int32 label array; every op returns (img, boxes, labels). Random
state is an explicit np.random.Generator — deterministic per-sample seeding
enables exact resume of the data pipeline.

Config knobs mirrored 1:1 (training.augmentation section,
coco_yolov8.yaml:44-56): hsv_h/hsv_s/hsv_v, degrees, translate, scale, shear,
perspective, flipud, fliplr, mosaic, mixup. Filter thresholds follow the
reference's bbox_params: min_visibility=0.1, min_area=1px
(dataset.py:84-87).
"""

from __future__ import annotations

import numpy as np
import torch

IMAGENET_MEAN = np.asarray([0.485, 0.456, 0.406], dtype=np.float32)
IMAGENET_STD = np.asarray([0.229, 0.224, 0.225], dtype=np.float32)

MIN_VISIBILITY = 0.1
MIN_AREA_PX = 1.0


def coco_to_xyxy(boxes_xywh: np.ndarray) -> np.ndarray:
    b = np.asarray(boxes_xywh, dtype=np.float32).reshape(-1, 4)
    return np.stack([b[:, 0], b[:, 1], b[:, 0] + b[:, 2], b[:, 1] + b[:, 3]], -1)


def xyxy_to_norm_cxcywh(boxes: np.ndarray, w: int, h: int) -> np.ndarray:
    """To the dataset target contract: normalized (cx, cy, w, h)
    (dataset.py:219-227)."""
    b = boxes.reshape(-1, 4)
    cx = (b[:, 0] + b[:, 2]) / 2 / w
    cy = (b[:, 1] + b[:, 3]) / 2 / h
    bw = (b[:, 2] - b[:, 0]) / w
    bh = (b[:, 3] - b[:, 1]) / h
    return np.stack([cx, cy, bw, bh], -1).astype(np.float32)


def _filter_boxes(boxes, labels, w, h, orig_areas=None):
    """Clip to the canvas and drop tiny / mostly-cropped boxes
    (reference bbox_params semantics, dataset.py:84-87 & :224-227)."""
    if len(boxes) == 0:
        return boxes.reshape(0, 4), labels
    clipped = boxes.copy()
    clipped[:, 0::2] = np.clip(clipped[:, 0::2], 0, w)
    clipped[:, 1::2] = np.clip(clipped[:, 1::2], 0, h)
    areas = (clipped[:, 2] - clipped[:, 0]) * (clipped[:, 3] - clipped[:, 1])
    keep = areas >= MIN_AREA_PX
    if orig_areas is not None:
        with np.errstate(divide="ignore", invalid="ignore"):
            vis = np.where(orig_areas > 0, areas / orig_areas, 0.0)
        keep &= vis >= MIN_VISIBILITY
    return clipped[keep], labels[keep]


def hsv_jitter(img, rng, h_gain=0.015, s_gain=0.7, v_gain=0.4):
    """HSV color jitter (dataset.py:92-100 HueSaturationValue equivalent)."""
    import cv2

    if h_gain == 0 and s_gain == 0 and v_gain == 0:
        return img
    r = rng.uniform(-1, 1, 3) * [h_gain, s_gain, v_gain] + 1
    hsv = cv2.cvtColor(img, cv2.COLOR_RGB2HSV)
    h, s, v = cv2.split(hsv)
    dtype = img.dtype
    x = np.arange(256)
    lut_h = ((x * r[0]) % 180).astype(dtype)
    lut_s = np.clip(x * r[1], 0, 255).astype(dtype)
    lut_v = np.clip(x * r[2], 0, 255).astype(dtype)
    hsv = cv2.merge((cv2.LUT(h, lut_h), cv2.LUT(s, lut_s), cv2.LUT(v, lut_v)))
    return cv2.cvtColor(hsv, cv2.COLOR_HSV2RGB)


def horizontal_flip(img, boxes):
    w = img.shape[1]
    img = np.ascontiguousarray(img[:, ::-1])
    if len(boxes):
        boxes = boxes.copy()
        boxes[:, [0, 2]] = w - boxes[:, [2, 0]]
    return img, boxes


def vertical_flip(img, boxes):
    h = img.shape[0]
    img = np.ascontiguousarray(img[::-1])
    if len(boxes):
        boxes = boxes.copy()
        boxes[:, [1, 3]] = h - boxes[:, [3, 1]]
    return img, boxes


def random_affine(
    img,
    boxes,
    labels,
    rng,
    degrees=0.0,
    translate=0.1,
    scale=0.5,
    shear=0.0,
    perspective=0.0,
):
    """Combined geometric augmentation via a single warp.

    Covers Rotate / ShiftScaleRotate / RandomScale / Affine-shear /
    Perspective from the reference menu (dataset.py:101-125) in one
    resampling pass (one warp beats five chained warps for both quality and
    host CPU time). Boxes are transformed by their 4 corners.
    """
    import cv2

    h, w = img.shape[:2]

    # center -> origin
    c = np.eye(3)
    c[0, 2], c[1, 2] = -w / 2, -h / 2
    # perspective
    p = np.eye(3)
    p[2, 0] = rng.uniform(-perspective, perspective)
    p[2, 1] = rng.uniform(-perspective, perspective)
    # rotation + isotropic scale
    r = np.eye(3)
    a = rng.uniform(-degrees, degrees)
    s = rng.uniform(1 - scale, 1 + scale) if scale > 0 else 1.0
    r[:2] = cv2.getRotationMatrix2D(angle=a, center=(0, 0), scale=s)
    # shear
    sh = np.eye(3)
    sh[0, 1] = np.tan(rng.uniform(-shear, shear) * np.pi / 180)
    sh[1, 0] = np.tan(rng.uniform(-shear, shear) * np.pi / 180)
    # translation (fraction of canvas) + back from origin
    t = np.eye(3)
    t[0, 2] = rng.uniform(0.5 - translate, 0.5 + translate) * w
    t[1, 2] = rng.uniform(0.5 - translate, 0.5 + translate) * h

    m = t @ sh @ r @ p @ c
    if perspective > 0:
        img = cv2.warpPerspective(img, m, dsize=(w, h), borderValue=(114, 114, 114))
    else:
        img = cv2.warpAffine(img, m[:2], dsize=(w, h), borderValue=(114, 114, 114))

    if len(boxes):
        orig_areas = (boxes[:, 2] - boxes[:, 0]) * (boxes[:, 3] - boxes[:, 1]) * s * s
        n = len(boxes)
        corners = np.ones((n * 4, 3))
        corners[:, :2] = boxes[:, [0, 1, 2, 1, 2, 3, 0, 3]].reshape(n * 4, 2)
        corners = corners @ m.T
        if perspective > 0:
            corners = corners[:, :2] / corners[:, 2:3]
        else:
            corners = corners[:, :2]
        corners = corners.reshape(n, 8)
        xs, ys = corners[:, 0::2], corners[:, 1::2]
        boxes = np.stack([xs.min(1), ys.min(1), xs.max(1), ys.max(1)], -1).astype(
            np.float32
        )
        boxes, labels = _filter_boxes(boxes, labels, w, h, orig_areas)
    return img, boxes, labels


def resize_linear(img, boxes, out_h, out_w):
    """Plain (non-letterbox) bilinear resize — the reference trains and
    infers on direct resize (dataset.py:134, tools/test.py:116)."""
    import cv2

    h, w = img.shape[:2]
    img = cv2.resize(img, (out_w, out_h), interpolation=cv2.INTER_LINEAR)
    if len(boxes):
        boxes = boxes * np.asarray(
            [out_w / w, out_h / h, out_w / w, out_h / h], dtype=np.float32
        )
    return img, boxes


def letterbox(img, boxes, out_h, out_w, pad_value=114):
    """Aspect-preserving resize + pad. Not used by the reference pipeline —
    provided for the standard deployment path. Returns (img, boxes, scale,
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


def normalize_imagenet(img: np.ndarray) -> np.ndarray:
    """uint8 RGB -> float32 ImageNet-normalized (dataset.py:135)."""
    return (img.astype(np.float32) / 255.0 - IMAGENET_MEAN) / IMAGENET_STD


def device_normalize_images(images: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """uint8 NHWC -> ImageNet-normalized NHWC in ``dtype``, on the images'
    device; float inputs pass through unchanged.

    One f32 multiply-add, x*s + t with s = 1/(255*std) and t = -mean/std
    (the JAX package's constants, computed the same way in numpy f32), then
    a single cast to the compute dtype. The constants are made on the
    device from Python scalars, so no host-to-device copy waits for the
    card.
    """
    if images.dtype != torch.uint8:
        return images
    s = _channel_constants(1.0 / (255.0 * IMAGENET_STD), images.device)
    t = _channel_constants(-IMAGENET_MEAN / IMAGENET_STD, images.device)
    return (images.float() * s + t).to(dtype)


def _channel_constants(values: np.ndarray, device) -> torch.Tensor:
    """Three f32 ``values`` as a [3] tensor filled on ``device`` (each is an
    f32, so its Python float fills it exactly)."""
    c = torch.arange(3, device=device)
    out = torch.full((3,), float(values[2]), dtype=torch.float32, device=device)
    out = torch.where(c == 1, float(values[1]), out)
    return torch.where(c == 0, float(values[0]), out)


def mosaic4(samples, rng, out_size):
    """4-image mosaic (config knob coco_yolov8.yaml:55, implemented here).

    samples: list of 4 (img, boxes_xyxy, labels). Returns a 2x-size canvas
    cropped around a jittered center, then resized by the caller.
    """
    import cv2

    s = out_size
    yc = int(rng.uniform(s * 0.5, s * 1.5))
    xc = int(rng.uniform(s * 0.5, s * 1.5))
    canvas = np.full((s * 2, s * 2, 3), 114, dtype=np.uint8)
    all_boxes, all_labels = [], []
    placements = [
        lambda w, h: (max(xc - w, 0), max(yc - h, 0), xc, yc),
        lambda w, h: (xc, max(yc - h, 0), min(xc + w, s * 2), yc),
        lambda w, h: (max(xc - w, 0), yc, xc, min(yc + h, s * 2)),
        lambda w, h: (xc, yc, min(xc + w, s * 2), min(yc + h, s * 2)),
    ]
    for i, (img, boxes, labels) in enumerate(samples):
        h, w = img.shape[:2]
        r = s / max(h, w)
        if r != 1:
            img = cv2.resize(img, (int(w * r), int(h * r)), interpolation=cv2.INTER_LINEAR)
            boxes = boxes * r if len(boxes) else boxes
            h, w = img.shape[:2]
        x1, y1, x2, y2 = placements[i](w, h)
        # region of the source to copy
        if i == 0:
            sx1, sy1 = w - (x2 - x1), h - (y2 - y1)
        elif i == 1:
            sx1, sy1 = 0, h - (y2 - y1)
        elif i == 2:
            sx1, sy1 = w - (x2 - x1), 0
        else:
            sx1, sy1 = 0, 0
        sx2, sy2 = sx1 + (x2 - x1), sy1 + (y2 - y1)
        canvas[y1:y2, x1:x2] = img[sy1:sy2, sx1:sx2]
        if len(boxes):
            shift = np.asarray([x1 - sx1, y1 - sy1, x1 - sx1, y1 - sy1], np.float32)
            all_boxes.append(boxes + shift)
            all_labels.append(labels)
    if all_boxes:
        boxes = np.concatenate(all_boxes)
        labels = np.concatenate(all_labels)
    else:
        boxes = np.zeros((0, 4), np.float32)
        labels = np.zeros((0,), np.int32)
    boxes, labels = _filter_boxes(boxes, labels, s * 2, s * 2)
    return canvas, boxes, labels


def mixup(img1, boxes1, labels1, img2, boxes2, labels2, rng):
    """Image-level mixup (config knob coco_yolov8.yaml:56, implemented)."""
    lam = float(np.clip(rng.beta(32.0, 32.0), 0.25, 0.75))
    img = (img1.astype(np.float32) * lam + img2.astype(np.float32) * (1 - lam)).astype(
        np.uint8
    )
    boxes = np.concatenate([boxes1, boxes2]) if len(boxes1) or len(boxes2) else boxes1
    labels = np.concatenate([labels1, labels2]) if len(labels1) or len(labels2) else labels1
    return img, boxes, labels


class TrainAugment:
    """The full training augmentation pipeline, config-driven.

    Mirrors _setup_transform (dataset.py:83-138): HSV -> geometric -> flips,
    then resize to the model input and ImageNet-normalize. Mosaic/mixup are
    applied by the loader (they need multiple samples).
    """

    def __init__(self, params: dict | None, img_size: tuple[int, int]):
        self.p = dict(params or {})
        self.img_h, self.img_w = img_size

    def __call__(self, img, boxes, labels, rng: np.random.Generator):
        p = self.p
        if any(p.get(k, 0) > 0 for k in ("hsv_h", "hsv_s", "hsv_v")):
            if rng.uniform() < 0.5:
                img = hsv_jitter(
                    img, rng, p.get("hsv_h", 0), p.get("hsv_s", 0), p.get("hsv_v", 0)
                )
        if any(
            p.get(k, 0) > 0
            for k in ("degrees", "translate", "scale", "shear", "perspective")
        ):
            img, boxes, labels = random_affine(
                img,
                boxes,
                labels,
                rng,
                degrees=p.get("degrees", 0.0),
                translate=p.get("translate", 0.0),
                scale=p.get("scale", 0.0),
                shear=p.get("shear", 0.0),
                perspective=p.get("perspective", 0.0),
            )
        if p.get("fliplr", 0) > 0 and rng.uniform() < p["fliplr"]:
            img, boxes = horizontal_flip(img, boxes)
        if p.get("flipud", 0) > 0 and rng.uniform() < p["flipud"]:
            img, boxes = vertical_flip(img, boxes)
        img, boxes = resize_linear(img, boxes, self.img_h, self.img_w)
        boxes, labels = _filter_boxes(boxes, labels, self.img_w, self.img_h)
        return img, boxes, labels


class EvalTransform:
    """Validation/inference transform: plain resize only (dataset.py:132-136
    with is_train=False)."""

    def __init__(self, img_size: tuple[int, int]):
        self.img_h, self.img_w = img_size

    def __call__(self, img, boxes, labels, rng=None):
        img, boxes = resize_linear(img, boxes, self.img_h, self.img_w)
        boxes, labels = _filter_boxes(boxes, labels, self.img_w, self.img_h)
        return img, boxes, labels
