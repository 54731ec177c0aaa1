"""COCO-JSON detection dataset — dependency-free parser + sample access.

A copy of ``yolo_ms_tpu/data/coco.py`` for the port.

Replaces the reference's pycocotools-backed COCODataset (dataset.py:12-233)
with a plain-json parser (pycocotools is a C extension the reference uses
only for index lookups — a dict build does the same work). Behavior parity:

- images sorted by id (dataset.py:40),
- missing image files filtered up front (dataset.py:69-81),
- category -> label remap with first-N truncation when num_classes < |cats|
  (dataset.py:52-63),
- annotations filtered: iscrowd==0, area>0, w>0, h>0 (dataset.py:165-174),
- per-sample output: RGB uint8 HWC image + boxes in COCO pixel xywh + labels.

Augmentation / resize / normalization live in data/augment.py; batching and
padding in data/loader.py.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass

import numpy as np


@dataclass
class CocoSample:
    image_id: int
    path: str
    width: int
    height: int
    boxes_xywh: np.ndarray  # [N, 4] pixel coords (x_min, y_min, w, h)
    labels: np.ndarray  # [N] int32 contiguous labels


class CocoDetectionDataset:
    """Indexable COCO detection dataset."""

    def __init__(
        self,
        images_dir: str,
        annotations_file: str,
        num_classes: int = 80,
        verbose: bool = True,
    ):
        if not os.path.exists(annotations_file):
            raise FileNotFoundError(f"Annotations file not found: {annotations_file}")
        if not os.path.isdir(images_dir):
            raise NotADirectoryError(f"Images directory not found: {images_dir}")
        self.images_dir = images_dir
        self.num_classes = num_classes

        with open(annotations_file) as f:
            coco = json.load(f)

        images = {im["id"]: im for im in coco.get("images", [])}
        cat_ids = sorted(c["id"] for c in coco.get("categories", []))
        if num_classes < len(cat_ids):
            if verbose:
                print(
                    f"Warning: dataset has {len(cat_ids)} categories, model "
                    f"configured for {num_classes}; using the first "
                    f"{num_classes} category ids."
                )
            cat_ids = cat_ids[:num_classes]
        self.cat2label = {cid: i for i, cid in enumerate(cat_ids)}
        self.label2cat = {i: cid for i, cid in enumerate(cat_ids)}
        self.class_names = [
            c.get("name", str(c["id"]))
            for c in sorted(coco.get("categories", []), key=lambda c: c["id"])
            if c["id"] in self.cat2label
        ]

        anns_by_img: dict[int, list] = {}
        for ann in coco.get("annotations", []):
            if ann.get("iscrowd", 0) != 0 or ann.get("area", 0) <= 0:
                continue
            if ann["category_id"] not in self.cat2label:
                continue
            x, y, w, h = ann["bbox"]
            if w <= 0 or h <= 0:
                continue
            anns_by_img.setdefault(ann["image_id"], []).append(ann)

        self.samples: list[CocoSample] = []
        missing = 0
        for img_id in sorted(images.keys()):
            info = images[img_id]
            path = os.path.join(images_dir, info["file_name"])
            if not os.path.exists(path):
                missing += 1
                continue
            anns = anns_by_img.get(img_id, [])
            if anns:
                boxes = np.asarray([a["bbox"] for a in anns], dtype=np.float32)
                labels = np.asarray(
                    [self.cat2label[a["category_id"]] for a in anns], dtype=np.int32
                )
            else:
                boxes = np.zeros((0, 4), dtype=np.float32)
                labels = np.zeros((0,), dtype=np.int32)
            self.samples.append(
                CocoSample(
                    image_id=img_id,
                    path=path,
                    width=info.get("width", 0),
                    height=info.get("height", 0),
                    boxes_xywh=boxes,
                    labels=labels,
                )
            )
        if verbose:
            msg = f"CocoDetectionDataset: {len(self.samples)} images"
            if missing:
                msg += f" ({missing} missing files filtered out)"
            print(msg)

    def __len__(self) -> int:
        return len(self.samples)

    def load_image(self, idx: int) -> np.ndarray:
        """Decode image idx to RGB uint8 HWC (host path; see native/ for the
        C++ decode fast path)."""
        from yolo_ms_tpu_torch.data.decode import decode_image

        return decode_image(self.samples[idx].path)

    def __getitem__(self, idx: int):
        s = self.samples[idx]
        img = self.load_image(idx)
        return img, s.boxes_xywh.copy(), s.labels.copy()
