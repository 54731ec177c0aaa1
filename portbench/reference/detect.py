"""The serving reference and the judge of served detections.

``dense`` runs the reference network in float32 (TF32 off) on uint8 NHWC
images and decodes every anchor: boxes [B, A, 4] xyxy in pixels and class
logits [B, A, nc]. ``serve`` is the plain serving tail on top of it (per
anchor the best class, the top ``pre_nms_topk`` anchors, the confidence
gate, greedy NMS within each class, the top ``max_det``); with the fp8
network it is the control.

``judge`` holds served detections against the float32 reference, image by
image. Each served detection is matched to the anchor whose reference box
overlaps it most. Two numbers come out, each the worst over the images:

- ``logit_err``, the worst logit error of the served answers, the larger
  of two parts. ``fidelity``: how far a served score, as a logit, lies
  from its anchor's reference logit for the served class. ``order``:
  greedy NMS serves, at each step, the best candidate that the detections
  served before it leave; at step k the judge takes, among the reference's
  candidates that no earlier served detection has taken or suppresses,
  the best reference logit, and reads by how much the served score, as a
  logit, lies below it. A served detection that an earlier one of its
  class suppresses in the reference reads as if its logit were the
  confidence gate's; where fewer than ``max_det`` came back, a candidate
  the reference still has left reads by how far it lies above the last
  one that could enter. (``order`` alone cannot tell bf16 from fp8: bf16
  rounds logits near the class prior 1/16 apart, and fp8's errors push
  its order readings either way.)
- ``box_err``: 1 - IoU of a served box with its anchor's reference box.

Rounding moves near-ties, so the judge gives way where the reference
cannot tell: a candidate counts as suppressed by a served detection when
their reference IoU is above ``iou_thresh - IOU_SLACK`` and the served
class is within ``CLASS_SLACK`` logits of the candidate's best, and a
served detection counts as wrongly served only above ``iou_thresh +
IOU_SLACK``.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from portbench.reference.model import STRIDES

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
CLASS_OFFSET = 8192.0
IOU_SLACK = 0.05
CLASS_SLACK = 0.25


def normalize(images_u8: torch.Tensor) -> torch.Tensor:
    """uint8 NHWC -> ImageNet-normalized NCHW float32."""
    x = images_u8.float() / 255.0
    mean = torch.tensor(IMAGENET_MEAN, device=x.device)
    std = torch.tensor(IMAGENET_STD, device=x.device)
    return ((x - mean) / std).permute(0, 3, 1, 2).contiguous()


def anchors(shapes, device):
    """Grid-cell centres in grid units [A, 2] and the stride of each [A, 1]."""
    pts, strides = [], []
    for (h, w), s in zip(shapes, STRIDES):
        gy, gx = torch.meshgrid(torch.arange(h, device=device) + 0.5,
                                torch.arange(w, device=device) + 0.5, indexing="ij")
        pts.append(torch.stack([gx, gy], -1).reshape(-1, 2).float())
        strides.append(torch.full((h * w, 1), float(s), device=device))
    return torch.cat(pts), torch.cat(strides)


def decode(maps, reg_max: int):
    """Per-scale (box [B, 4*reg_max, H, W], cls [B, nc, H, W]) -> boxes
    [B, A, 4] xyxy pixels (the DFL expectation of each side) and class
    logits [B, A, nc]."""
    shapes = [tuple(b.shape[2:]) for b, _ in maps]
    box = torch.cat([b.float().flatten(2).transpose(1, 2) for b, _ in maps], 1)
    cls = torch.cat([c.float().flatten(2).transpose(1, 2) for _, c in maps], 1)
    p = torch.softmax(box.reshape(*box.shape[:2], 4, reg_max), -1)
    ltrb = (p * torch.arange(reg_max, device=box.device, dtype=torch.float32)).sum(-1)
    pts, stride = anchors(shapes, box.device)
    boxes = torch.cat([pts - ltrb[..., :2], pts + ltrb[..., 2:]], -1) * stride
    return boxes, cls


@torch.no_grad()
def dense(model, images_u8: torch.Tensor):
    """The reference network on uint8 NHWC images -> (boxes, logits)."""
    return decode(model(normalize(images_u8)), model.reg_max)


def iou_matrix(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """[N, 4] x [M, 4] xyxy -> [N, M] IoU."""
    lt = torch.maximum(a[:, None, :2], b[None, :, :2])
    rb = torch.minimum(a[:, None, 2:], b[None, :, 2:])
    inter = (rb - lt).clamp(min=0).prod(-1)
    area_a = (a[:, 2:] - a[:, :2]).prod(-1)
    area_b = (b[:, 2:] - b[:, :2]).prod(-1)
    return inter / (area_a[:, None] + area_b[None, :] - inter + 1e-7)


def greedy_nms(boxes: torch.Tensor, valid: torch.Tensor, iou_thresh: float) -> torch.Tensor:
    """Boxes [B, K, 4] sorted by falling score and valid [B, K] -> keep
    [B, K], one box at a time."""
    over = torch.stack([iou_matrix(x, x) for x in boxes]) > iou_thresh
    keep = valid.clone()
    for i in range(boxes.shape[1]):
        keep[:, i] &= ~(over[:, i, :i] & keep[:, :i]).any(-1)
    return keep


@torch.no_grad()
def serve(boxes, logits, conf_thresh, iou_thresh, pre_nms_topk, max_det):
    """The plain serving tail on decoded (boxes, logits) -> the served
    dict: 'boxes' [B, max_det, 4], 'scores', 'classes', 'valid'."""
    best, cls = logits.max(-1)
    k = min(pre_nms_topk, best.shape[1])
    top, idx = best.topk(k, dim=1)
    score = torch.sigmoid(top)
    ok = score > conf_thresh
    bx = torch.gather(boxes, 1, idx[..., None].expand(-1, -1, 4))
    cl = torch.gather(cls, 1, idx)
    keep = greedy_nms(bx + cl[..., None].float() * CLASS_OFFSET, ok, iou_thresh)
    kept = torch.where(keep, score, -1.0)
    kd = min(max_det, k)
    s, j = kept.topk(kd, dim=1)
    valid = s > 0
    out = {
        "boxes": torch.where(valid[..., None], torch.gather(bx, 1, j[..., None].expand(-1, -1, 4)), 0.0),
        "scores": s.clamp(min=0.0),
        "classes": torch.where(valid, torch.gather(cl, 1, j), 0).int(),
        "valid": valid,
    }
    return {n: v.cpu().numpy() for n, v in out.items()}


def _logit(p: np.ndarray) -> np.ndarray:
    p = p.astype(np.float64)
    return np.log(p) - np.log1p(-p)


@torch.no_grad()
def judge(served: dict, boxes: torch.Tensor, logits: torch.Tensor, conf_thresh: float,
          iou_thresh: float, pre_nms_topk: int, max_det: int) -> dict:
    """Served detections (numpy, [B, max_det, ...]) against the reference's
    (boxes, logits) of the same images -> {'logit_err', 'box_err'} and
    logit_err's two parts, 'logit_err.fidelity' and 'logit_err.order',
    each the worst over the images."""
    dev = boxes.device
    gate = math.log(conf_thresh) - math.log1p(-conf_thresh)
    worst = {"order": 0.0, "fidelity": 0.0, "box_err": 0.0}
    for i in range(boxes.shape[0]):
        valid = np.asarray(served["valid"][i], bool)
        n = int(valid.sum())
        if not valid[:n].all():  # the valid rows are not first
            worst["order"] = math.inf
            continue
        ref_boxes, ref_logits = boxes[i], logits[i]
        best, _ = ref_logits.max(-1)
        k = min(pre_nms_topk, best.shape[0])
        cand_best, cand = best.topk(k)
        floor = max(float(cand_best[-1]), gate)
        keep = cand_best > gate
        cand, cand_best = cand[keep], cand_best[keep]
        if n == 0:
            if cand.numel():
                worst["order"] = max(worst["order"], float(cand_best[0]) - floor)
            continue
        sb = torch.from_numpy(np.asarray(served["boxes"][i][:n], np.float32)).to(dev)
        sc = torch.from_numpy(np.asarray(served["classes"][i][:n], np.int64)).to(dev)
        match_iou, a = iou_matrix(sb, ref_boxes).max(1)
        own = ref_logits[a, sc]  # each served detection's reference logit
        worst["box_err"] = max(worst["box_err"], float((1 - match_iou).max()))
        served_logit = torch.from_numpy(_logit(np.asarray(served["scores"][i][:n]))).to(dev)
        worst["fidelity"] = max(worst["fidelity"],
                                float((served_logit - own.double()).abs().max()))
        own_boxes = ref_boxes[a]
        # served detection k' wrongly served: an earlier one of its class
        # overlaps it in the reference beyond the slack
        pair = iou_matrix(own_boxes, own_boxes)
        same = sc[:, None] == sc[None, :]
        earlier = torch.ones(n, n, dtype=torch.bool, device=dev).tril(-1)
        wrong = ((pair > iou_thresh + IOU_SLACK) & same & earlier).any(1)
        own_eff = torch.where(wrong, gate, served_logit.float())
        # candidate j leaves the pool at the first step that takes or
        # suppresses it
        cand_boxes = ref_boxes[cand]
        near_cls = ref_logits[cand][:, sc] >= (cand_best[:, None] - CLASS_SLACK)
        gone = ((iou_matrix(cand_boxes, own_boxes) > iou_thresh - IOU_SLACK) & near_cls) | (
            cand[:, None] == a[None, :])
        steps = torch.arange(n, device=dev)
        first = torch.where(gone, steps[None, :], n).amin(1)  # [C]
        avail = first[:, None] >= steps[None, :]  # [C, n]: still there at step k
        pool_best = torch.where(avail, cand_best[:, None], -math.inf).amax(0)
        gap = (pool_best - own_eff).clamp(min=0).max()
        if n < max_det:
            left = cand_best[first >= n]
            if left.numel():
                gap = torch.maximum(gap, (left.max() - floor).clamp(min=0))
        worst["order"] = max(worst["order"], float(gap))
    return {"logit_err": max(worst["fidelity"], worst["order"]), "box_err": worst["box_err"],
            "logit_err.fidelity": worst["fidelity"], "logit_err.order": worst["order"]}
