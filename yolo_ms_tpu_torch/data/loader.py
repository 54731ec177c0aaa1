"""Batched detection loader: padded static-shape batches + async prefetch.

A copy of ``yolo_ms_tpu/data/loader.py`` for the port, for one process: the
multi-process feed (``process_shard`` with more than one process, and
``shard_images_only``) comes with the parallel slice, and asking for it
raises. Everything else is the JAX loader's, so batches are byte-equal.

Replaces the reference's DataLoader + concat-style collate (dataset.py:235-267
builds a dynamic [M,6] target tensor) with the jit-friendly padded layout:

  images [B, H, W, 3] float32 (ImageNet-normalized, NHWC)
  boxes  [B, max_gt, 4] normalized (cx, cy, w, h)
  labels [B, max_gt] int32
  mask   [B, max_gt] bool

Static shapes mean ONE compiled train step for every batch. Worker threads
(the host pipeline is IO/decode bound — threads suffice because decode
releases the GIL inside libjpeg/cv2) prefetch batches ahead of the device.

Determinism: every (epoch, index) pair seeds its own np.random.Generator, so
data order + augmentation draws are exactly reproducible and the iterator can
be checkpoint-resumed from (epoch, step) alone — the failure-recovery story
the reference lacks (SURVEY.md §5).
"""

from __future__ import annotations

import queue
import threading
from typing import Iterator

import numpy as np

from yolo_ms_tpu_torch.data import native_loader
from yolo_ms_tpu_torch.data.augment import (
    EvalTransform,
    TrainAugment,
    _filter_boxes,
    coco_to_xyxy,
    mixup,
    mosaic4,
    normalize_imagenet,
    resize_linear,
    xyxy_to_norm_cxcywh,
)
from yolo_ms_tpu_torch.data.coco import CocoDetectionDataset


class DetectionLoader:
    def __init__(
        self,
        dataset: CocoDetectionDataset,
        batch_size: int,
        img_size: tuple[int, int] = (640, 640),
        max_gt: int = 128,
        is_train: bool = True,
        augmentation: dict | None = None,
        seed: int = 42,
        num_workers: int = 4,
        prefetch: int = 4,
        drop_last: bool | None = None,
        device_normalize: bool = False,
        multiscale_sizes: list[int] | None = None,
        multiscale_interval: int = 10,
        process_shard: tuple[int, int] | None = None,
        shard_images_only: bool = False,
    ):
        # device_normalize=True emits raw uint8 pixels (the whole augment
        # pipeline is uint8 end-to-end); the consumer normalizes on device.
        # Host->device transfer drops 4x (uint8 vs f32) and the train step
        # loses a 629 MB/batch f32->bf16 convert at bs=128.
        self.device_normalize = device_normalize
        self.ds = dataset
        self.batch_size = batch_size
        # The multi-process feed (rows of a global batch per process, and
        # the image-only eval shard) is not in this slice: one process
        # decodes the whole batch.
        idx_, cnt_ = process_shard or (0, 1)
        if cnt_ < 1 or not 0 <= idx_ < cnt_:
            raise ValueError(f"invalid process_shard {(idx_, cnt_)}")
        if cnt_ > 1 or shard_images_only:
            raise NotImplementedError(
                "process_shard over several processes and shard_images_only "
                "are not ported yet (multi-process data parallel)"
            )
        self.img_h, self.img_w = img_size
        self.max_gt = max_gt
        self.is_train = is_train
        self.seed = seed
        self.num_workers = max(1, num_workers)
        self.prefetch = prefetch
        self.drop_last = is_train if drop_last is None else drop_last
        self.aug_params = dict(augmentation or {})
        self.mosaic_p = self.aug_params.get("mosaic", 0.0) if is_train else 0.0
        self.mixup_p = self.aug_params.get("mixup", 0.0) if is_train else 0.0
        self.transform = (
            TrainAugment(self.aug_params, img_size)
            if is_train
            else EvalTransform(img_size)
        )
        # Multi-scale training: square sizes sampled once per block of
        # multiscale_interval batches (train only). Deterministic in
        # (seed, epoch, block): every data-parallel host computes the same
        # size with NO collective, and mid-epoch resume re-derives it.
        # Each size is one extra jit specialization of the train step —
        # the same static-shape-bucket pattern as dataset.gt_buckets.
        self.multiscale_sizes: tuple[int, ...] = tuple(
            int(s) for s in (multiscale_sizes or []) if is_train
        )
        for s in self.multiscale_sizes:
            if s % 32:
                raise ValueError(
                    f"multiscale size {s} is not a stride-32 multiple"
                )
        self.multiscale_interval = max(1, int(multiscale_interval))
        self._ms_transforms: dict[tuple[int, int], TrainAugment] = {}

    def __len__(self) -> int:
        n = len(self.ds)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    # ------------------------------------------------------------------ #

    def _load_xyxy(self, idx: int):
        img, boxes_xywh, labels = self.ds[idx]
        return img, coco_to_xyxy(boxes_xywh), labels

    def _hw_for_batch(self, epoch: int, batch_idx: int) -> tuple[int, int]:
        """(H, W) canvas for one batch: the fixed img_size, or — under
        multi-scale training — a square size drawn per interval block,
        deterministic in (seed, epoch, block)."""
        if not self.multiscale_sizes:
            return (self.img_h, self.img_w)
        block = batch_idx // self.multiscale_interval
        rng = np.random.default_rng((self.seed, epoch, 0x5CA1E, block))
        s = self.multiscale_sizes[int(rng.integers(len(self.multiscale_sizes)))]
        return (s, s)

    def _transform_for(self, hw: tuple[int, int]):
        if hw == (self.img_h, self.img_w):
            return self.transform
        t = self._ms_transforms.get(hw)
        if t is None:
            t = TrainAugment(self.aug_params, hw)
            self._ms_transforms[hw] = t
        return t

    def _make_sample(
        self, epoch: int, idx: int, order: np.ndarray, hw: tuple[int, int]
    ):
        """One fully-augmented, resized, normalized sample on an hw canvas."""
        h, w = hw
        rng = np.random.default_rng((self.seed, epoch, int(idx)))
        ds_idx = int(order[idx])
        if self.is_train and self.mosaic_p > 0 and rng.uniform() < self.mosaic_p:
            picks = [ds_idx] + [int(rng.integers(len(self.ds))) for _ in range(3)]
            samples = [self._load_xyxy(i) for i in picks]
            img, boxes, labels = mosaic4(samples, rng, max(h, w))
        else:
            img, boxes, labels = self._load_xyxy(ds_idx)
        if self.is_train and self.mixup_p > 0 and rng.uniform() < self.mixup_p:
            j = int(rng.integers(len(self.ds)))
            img2, boxes2, labels2 = self._load_xyxy(j)
            # bring both to a common canvas first
            img, boxes = resize_linear(img, boxes, h, w)
            img2, boxes2 = resize_linear(img2, boxes2, h, w)
            img, boxes, labels = mixup(img, boxes, labels, img2, boxes2, labels2, rng)
        img, boxes, labels = self._transform_for(hw)(img, boxes, labels, rng)
        if self.device_normalize:
            return img, boxes, labels  # uint8; consumer normalizes on device
        return normalize_imagenet(img), boxes, labels

    def _pad_targets(
        self, boxes_xyxy: np.ndarray, labels: np.ndarray, hw: tuple[int, int]
    ):
        m = self.max_gt
        out_b = np.zeros((m, 4), np.float32)
        out_l = np.zeros((m,), np.int32)
        out_m = np.zeros((m,), bool)
        n = min(len(boxes_xyxy), m)
        if n:
            norm = xyxy_to_norm_cxcywh(boxes_xyxy[:n], hw[1], hw[0])
            out_b[:n] = norm
            out_l[:n] = labels[:n]
            out_m[:n] = True
        return out_b, out_l, out_m

    def _eval_targets_from_metadata(self, batch_ids, order):
        """Eval targets (padded boxes/labels/mask lists) computed purely from
        the dataset's annotation metadata — no image decode. The box math is
        the plain-resize scaling of EvalTransform (dataset.py:132-136
        semantics) driven by the ANNOTATED image dims. Returns None when the
        dataset lacks per-sample path/size metadata."""
        if not hasattr(self.ds, "samples"):
            return None
        samples = [self.ds.samples[int(order[i])] for i in batch_ids]
        if any(s.width <= 0 or s.height <= 0 for s in samples):
            return None  # no annotated dims -> cannot scale boxes
        bs, ls, ms = [], [], []
        for s in samples:
            boxes = coco_to_xyxy(s.boxes_xywh) * np.asarray(
                [
                    self.img_w / s.width,
                    self.img_h / s.height,
                ]
                * 2,
                np.float32,
            )
            boxes, labels = _filter_boxes(boxes, labels=s.labels, w=self.img_w, h=self.img_h)
            b, l, m = self._pad_targets(boxes, labels, (self.img_h, self.img_w))
            bs.append(b)
            ls.append(l)
            ms.append(m)
        return bs, ls, ms

    def _produce_native_eval(self, batch_ids, order):
        """Whole-batch fused decode+resize through the C++ loader
        (native/loader.cpp): one call decodes every JPEG/PNG of the batch on
        a pthread pool directly into the [B, H, W, 3] uint8 output — no
        per-image Python round trips. Eval-path only (plain resize, no
        augmentation, dataset.py:132-136 semantics); returns None when the
        .so isn't built or the dataset lacks path/size metadata, and the
        caller falls back to the per-sample path."""
        targets = self._eval_targets_from_metadata(batch_ids, order)
        if targets is None:
            return None
        imgs = self._decode_eval_images_native(batch_ids, order)
        if imgs is None:
            return None
        bs, ls, ms = targets
        return imgs, bs, ls, ms

    def _decode_eval_images_native(self, batch_ids, order):
        """Decode+resize(+normalize) just the IMAGES of the given rows via
        the C++ loader; None when unavailable."""
        if not native_loader.available() or not hasattr(self.ds, "samples"):
            return None
        samples = [self.ds.samples[int(order[i])] for i in batch_ids]
        imgs = native_loader.decode_resize_batch(
            [s.path for s in samples],
            self.img_h,
            self.img_w,
            num_threads=self.num_workers,
        )
        if imgs is None:
            return None
        if not self.device_normalize:
            imgs = np.stack([normalize_imagenet(im) for im in imgs])
        return imgs

    def _finish_batch(self, imgs, bs, ls, ms) -> dict:
        """Pad a short (final) batch to the batch size with zero images."""
        pad = self.batch_size - len(imgs)
        valid = len(imgs)
        for _ in range(pad):
            imgs.append(np.zeros_like(imgs[0]))
            bs.append(np.zeros_like(bs[0]))
            ls.append(np.zeros_like(ls[0]))
            ms.append(np.zeros_like(ms[0]))
        return {
            "images": np.stack(imgs),
            "boxes": np.stack(bs),
            "labels": np.stack(ls),
            "mask": np.stack(ms),
            "num_valid": valid,
        }

    def _epoch_order(self, epoch: int) -> np.ndarray:
        order = np.arange(len(self.ds))
        if self.is_train:
            np.random.default_rng((self.seed, epoch)).shuffle(order)
        return order

    def _batch_indices(self, epoch: int):
        n = len(self.ds)
        bs = self.batch_size
        num = n // bs if self.drop_last else (n + bs - 1) // bs
        return [range(b * bs, min((b + 1) * bs, n)) for b in range(num)]

    def epoch(self, epoch: int = 0, start_step: int = 0) -> Iterator[dict]:
        """Iterate batches of one epoch with threaded prefetch.

        `start_step` resumes mid-epoch (deterministic data checkpointing).
        """
        order = self._epoch_order(epoch)
        all_batches = self._batch_indices(epoch)
        # (batch, absolute index) pairs: multi-scale size selection keys on
        # the ABSOLUTE batch index so mid-epoch resume re-derives the same
        # per-batch canvas sizes.
        batches = [
            (b, i) for i, b in enumerate(all_batches) if i >= start_step
        ]
        if not batches:
            return
        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()
        # Sample production fans out over num_workers threads (decode/augment
        # release the GIL inside libjpeg/cv2/numpy). Determinism holds: each
        # sample is seeded purely by (seed, epoch, idx), and pool.map
        # preserves input order, so batches are byte-identical to the
        # single-threaded pipeline.
        from concurrent.futures import ThreadPoolExecutor

        pool = ThreadPoolExecutor(max_workers=self.num_workers)

        def one_sample(i, hw):
            img, boxes, labels = self._make_sample(epoch, i, order, hw)
            return (img,) + self._pad_targets(boxes, labels, hw)

        def produce(batch_ids, batch_idx):
            hw = self._hw_for_batch(epoch, batch_idx)
            if not self.is_train:
                fast = self._produce_native_eval(batch_ids, order)
                if fast is not None:
                    imgs_arr, bs, ls, ms = fast
                    return self._finish_batch(list(imgs_arr), bs, ls, ms)
            imgs, bs, ls, ms = [], [], [], []
            if self.num_workers > 1:
                results = list(pool.map(lambda i: one_sample(i, hw), batch_ids))
            else:
                results = [one_sample(i, hw) for i in batch_ids]
            for img, b, l, m in results:
                imgs.append(img)
                bs.append(b)
                ls.append(l)
                ms.append(m)
            return self._finish_batch(imgs, bs, ls, ms)

        def worker():
            # a failed batch is handed to the consumer, which raises it:
            # an epoch never ends early without saying why
            try:
                for batch_ids, batch_idx in batches:
                    if stop.is_set():
                        break
                    q.put(produce(list(batch_ids), batch_idx))
            except Exception as e:  # noqa: BLE001 - re-raised by the consumer
                q.put(e)
            finally:
                q.put(None)

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is None:
                    break
                if isinstance(item, Exception):
                    raise item
                yield item
        finally:
            stop.set()
            # drop the samples not started yet (the producer's pool.map then
            # raises CancelledError, which it hands to the queue), so closing
            # waits only for the samples in progress
            pool.shutdown(wait=False, cancel_futures=True)
            # unblock a worker waiting on a full queue, then let it finish
            while t.is_alive():
                try:
                    q.get_nowait()
                except queue.Empty:
                    t.join(0.05)
