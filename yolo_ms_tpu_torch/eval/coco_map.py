"""COCO-protocol mean-average-precision evaluator (host-side numpy).

A copy of ``yolo_ms_tpu/eval/coco_map.py`` for the port.

Own implementation of the metric the reference delegates to torchmetrics'
MeanAveragePrecision (train.py:17,41-47: box_format='xyxy',
iou_thresholds=[0.5]). Protocol (pycocotools COCOeval semantics):

- detections grouped per (image, class), sorted by score, truncated to the
  top ``max_dets`` per image per class (COCOeval's dt[:maxDets]),
- one IoU matrix per (image, class); greedy matching at every IoU threshold
  against the unmatched GT with highest IoU >= threshold,
- iscrowd GT ignore semantics: crowd IoU is intersection over DET area, a
  crowd GT can absorb any number of detections, and crowd-matched detections
  are IGNORED (neither TP nor FP),
- 101-point interpolated precision (COCO standard),
- AP averaged over classes that have (non-crowd) GT; mAP@[.5:.95] = mean over
  the 10 standard IoU thresholds; map_50 reported separately for parity with
  the reference's 'Validation/mAP_50' scalar (train.py:407).

Accumulation is update()/compute() like torchmetrics so the validation loop
shape matches the reference's (train.py:146,152). ``map_iou_thresholds``
and ``update_from_batch`` are the port's: the config setting and the padded
val batch, as ``Trainer.validate`` and ``tools/val.py`` both feed them. The matching is grouped
and array-wise — no dataset-wide per-detection Python loop — so COCO
val2017-scale evaluation (~5k images) completes in seconds.
"""

from __future__ import annotations

from collections import defaultdict

import numpy as np

COCO_IOU_THRESHOLDS = np.round(np.arange(0.5, 1.0, 0.05), 2)
RECALL_POINTS = np.linspace(0.0, 1.0, 101)


def _iou_matrix(
    a: np.ndarray, b: np.ndarray, b_crowd: np.ndarray | None = None
) -> np.ndarray:
    """[N,4] x [M,4] xyxy -> [N,M] IoU.

    Columns flagged in ``b_crowd`` use the COCO crowd convention: the
    denominator is the DETECTION area (intersection-over-foreground), so a
    detection fully inside a crowd region scores 1.0 against it.
    """
    if len(a) == 0 or len(b) == 0:
        return np.zeros((len(a), len(b)), np.float32)
    ix1 = np.maximum(a[:, None, 0], b[None, :, 0])
    iy1 = np.maximum(a[:, None, 1], b[None, :, 1])
    ix2 = np.minimum(a[:, None, 2], b[None, :, 2])
    iy2 = np.minimum(a[:, None, 3], b[None, :, 3])
    inter = np.clip(ix2 - ix1, 0, None) * np.clip(iy2 - iy1, 0, None)
    aa = (a[:, 2] - a[:, 0]) * (a[:, 3] - a[:, 1])
    ab = (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])
    union = aa[:, None] + ab[None, :] - inter
    if b_crowd is not None and b_crowd.any():
        union = np.where(b_crowd[None, :], aa[:, None], union)
    return inter / np.maximum(union, 1e-9)


class MeanAveragePrecision:
    def __init__(
        self,
        iou_thresholds=None,
        max_dets: int = 100,
        num_classes: int | None = None,
    ):
        self.iou_thresholds = (
            np.asarray(iou_thresholds, np.float64)
            if iou_thresholds is not None
            else COCO_IOU_THRESHOLDS
        )
        self.max_dets = max_dets
        self.num_classes = num_classes
        self.reset()

    def reset(self):
        # per class: lists of per-(image,class) match results
        self._scores = defaultdict(list)  # cls -> [D] score arrays
        self._tp = defaultdict(list)  # cls -> [T, D] bool arrays
        self._ignored = defaultdict(list)  # cls -> [T, D] bool arrays
        self._gt_count = defaultdict(int)  # cls -> non-crowd GT count

    def update(self, preds: list[dict], targets: list[dict]):
        """torchmetrics-compatible update: lists of per-image dicts with
        'boxes' [N,4] xyxy, 'scores' [N], 'labels' [N] (preds) and
        'boxes'/'labels' and optional 'iscrowd' [M] (targets)."""
        assert len(preds) == len(targets)
        for p, t in zip(preds, targets):
            pb = np.asarray(p["boxes"], np.float32).reshape(-1, 4)
            ps = np.asarray(p["scores"], np.float32).reshape(-1)
            pl = np.asarray(p["labels"], np.int64).reshape(-1)
            tb = np.asarray(t["boxes"], np.float32).reshape(-1, 4)
            tl = np.asarray(t["labels"], np.int64).reshape(-1)
            crowd = (
                np.asarray(t["iscrowd"], bool).reshape(-1)
                if "iscrowd" in t
                else np.zeros(len(tl), bool)
            )
            for cls in np.union1d(np.unique(pl), np.unique(tl)):
                if self.num_classes is not None and not (
                    0 <= cls < self.num_classes
                ):
                    continue
                self._match_image_class(
                    int(cls),
                    pb[pl == cls],
                    ps[pl == cls],
                    tb[tl == cls],
                    crowd[tl == cls],
                )

    # ------------------------------------------------------------------ #

    def _match_image_class(self, cls, dt_boxes, dt_scores, gt_boxes, gt_crowd):
        """Greedy COCO matching for one (image, class) at all thresholds."""
        self._gt_count[cls] += int((~gt_crowd).sum())
        if len(dt_scores) == 0:
            return
        # per-image per-class top max_dets by score (COCOeval dt[:maxDets])
        order = np.argsort(-dt_scores, kind="stable")[: self.max_dets]
        dt_boxes, dt_scores = dt_boxes[order], dt_scores[order]
        # GTs ordered non-crowd first (COCOeval sorts by ignore flag)
        gorder = np.argsort(gt_crowd, kind="stable")
        gt_boxes, gt_crowd = gt_boxes[gorder], gt_crowd[gorder]

        n_thr = len(self.iou_thresholds)
        d, g = len(dt_boxes), len(gt_boxes)
        tp = np.zeros((n_thr, d), bool)
        ignored = np.zeros((n_thr, d), bool)
        if g:
            ious = _iou_matrix(dt_boxes, gt_boxes, gt_crowd)
            # Greedy matching is sequential over detections (each real match
            # consumes a GT), but everything else vectorizes: each detection
            # does ONE [T, G] masked argmax over all IoU thresholds at once
            # instead of the former T x D x G pure-Python scan.
            #
            # COCOeval semantics preserved exactly:
            # - candidate GTs need iou >= min(thr, 1 - 1e-10),
            # - a real (non-crowd) match is always preferred over any crowd
            #   (COCOeval breaks at the ignore region once m is real),
            # - ties on IoU pick the LAST gt index (its running max updates
            #   on >=), hence the reversed argmax below,
            # - crowds absorb unlimited detections; crowd-matched detections
            #   are ignored (neither TP nor FP).
            thr_eff = np.minimum(self.iou_thresholds, 1.0 - 1e-10)[:, None]
            gt_matched = np.zeros((n_thr, g), bool)  # real GTs consumed, per thr
            real = ~gt_crowd
            rows = np.arange(n_thr)
            for di in range(d):
                ok = ious[di][None, :] >= thr_eff  # [T, G]
                cand_real = ok & real[None, :] & ~gt_matched
                has_real = cand_real.any(axis=1)  # [T]
                vals = np.where(cand_real, ious[di][None, :], -1.0)
                m_real = (g - 1) - np.argmax(vals[:, ::-1], axis=1)
                has_crowd = (ok & gt_crowd[None, :]).any(axis=1) & ~has_real
                tp[has_real, di] = True
                gt_matched[rows[has_real], m_real[has_real]] = True
                ignored[has_crowd, di] = True
        self._scores[cls].append(dt_scores)
        self._tp[cls].append(tp)
        self._ignored[cls].append(ignored)

    def _ap_for_class(self, cls: int) -> np.ndarray | None:
        """AP at each IoU threshold for one class, or None if no real GT."""
        gt_count = self._gt_count.get(cls, 0)
        if gt_count == 0:
            return None
        n_thr = len(self.iou_thresholds)
        if not self._scores.get(cls):
            return np.zeros(n_thr)  # GT exists but nothing predicted -> AP 0
        scores = np.concatenate(self._scores[cls])
        tp = np.concatenate(self._tp[cls], axis=1)  # [T, D]
        ignored = np.concatenate(self._ignored[cls], axis=1)
        order = np.argsort(-scores, kind="stable")
        tp, ignored = tp[:, order], ignored[:, order]

        aps = np.zeros(n_thr)
        for t_idx in range(n_thr):
            keep = ~ignored[t_idx]
            t = tp[t_idx][keep]
            if len(t) == 0:
                continue
            tps = np.cumsum(t)
            fps = np.cumsum(~t)
            recall = tps / gt_count
            precision = tps / np.maximum(tps + fps, 1e-9)
            # monotonically decreasing precision envelope (vectorized)
            precision = np.maximum.accumulate(precision[::-1])[::-1]
            # 101-point interpolation
            idx = np.searchsorted(recall, RECALL_POINTS, side="left")
            ap = np.where(
                idx < len(precision),
                precision[np.minimum(idx, len(precision) - 1)],
                0.0,
            )
            aps[t_idx] = ap.mean()
        return aps

    def compute(self) -> dict:
        classes = sorted(self._gt_count)
        per_class = {}
        for c in classes:
            aps = self._ap_for_class(int(c))
            if aps is not None:
                per_class[int(c)] = aps
        if not per_class:
            zero = float("nan")
            return {"map": zero, "map_50": zero, "map_75": zero, "per_class": {}}
        stack = np.stack(list(per_class.values()))  # [C, n_thr]
        result = {
            "map": float(stack.mean()),
            "per_class": {c: float(a.mean()) for c, a in per_class.items()},
        }
        thr = list(np.round(self.iou_thresholds, 2))
        if 0.5 in thr:
            result["map_50"] = float(stack[:, thr.index(0.5)].mean())
        if 0.75 in thr:
            result["map_75"] = float(stack[:, thr.index(0.75)].mean())
        return result


def map_iou_thresholds(setting) -> list[float]:
    """``evaluation.map_iou_thresholds`` -> IoU thresholds: a list as it is,
    or the preset ``"coco"`` (0.50:0.05:0.95); 0.5 is added when missing,
    since validation returns mAP@0.5."""
    thresholds = setting
    if isinstance(thresholds, str):
        if thresholds.lower() != "coco":
            raise ValueError(f"map_iou_thresholds: unknown preset {thresholds!r}")
        thresholds = [0.5 + 0.05 * i for i in range(10)]
    if 0.5 not in [round(float(t), 2) for t in thresholds]:
        thresholds = [0.5] + list(thresholds)
    return list(thresholds)


def update_from_batch(metric: MeanAveragePrecision, out: dict, batch: dict,
                      img_hw: tuple[int, int]) -> int:
    """Add the first ``batch["num_valid"]`` rows of a padded val batch: the
    post-process outputs ``out`` (host numpy ``boxes`` / ``scores`` /
    ``classes`` / ``valid``) against the batch's targets (normalized cx, cy,
    w, h, scaled to ``img_hw`` pixels). Returns the detections added."""
    ih, iw = img_hw
    scale = np.asarray([iw, ih, iw, ih], np.float32)
    preds, targets, n_dets = [], [], 0
    for i in range(batch["num_valid"]):
        valid = out["valid"][i]
        preds.append({
            "boxes": out["boxes"][i][valid],
            "scores": out["scores"][i][valid],
            "labels": out["classes"][i][valid],
        })
        m = batch["mask"][i]
        gt = batch["boxes"][i][m] * scale
        half = gt[:, 2:4] / 2.0
        targets.append({
            "boxes": np.concatenate([gt[:, :2] - half, gt[:, :2] + half], axis=-1),
            "labels": batch["labels"][i][m],
        })
        n_dets += int(valid.sum())
    metric.update(preds, targets)
    return n_dets
