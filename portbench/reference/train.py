"""The training reference: loss, assignment, optimizer and EMA, in float32.

A frozen copy of the recipe's step as plain ``torch`` code:

- the task-aligned assigner (TAL: metric score^0.5 x CIoU^6 over anchors
  whose centre lies inside a GT box, top 10 per GT, conflicts to the GT of
  highest IoU, soft labels scaled by the normalized metric). The ranking
  tensors are kept in bfloat16 at the points where the recipe's assigner
  rounds them (the clipped IoUs, the gathered class scores, the masked
  metric, the soft-label arithmetic), because where they round decides
  near-ties of the assignment; the top-k is k passes of first-index argmax;
- the loss: BCE-with-logits over every anchor and class against the soft
  labels, (1 - CIoU) and the two-bin DFL cross-entropy of the assigned
  anchors, each weighted by the anchor's target score and divided by the
  total target score (at least 1); total = 7.5 box + 0.5 cls + 1.5 DFL;
- the optimizer, optax's chain: clip by global norm (scale max_norm / norm
  only where norm >= max_norm), add decayed weights (every leaf), the
  Nesterov trace, times -lr, where lr(n) is a linear warm-up from 0 over
  ``warmup_steps`` updates into a cosine decay;
- the EMA of the parameters with decay
  ``ema_decay * (1 - exp(-(step + 1) / 2000))``.

``TrainReference`` runs these on the reference network in train mode,
float32 with TF32 off (or the fp8 control), from a state_dict and an
update count (with fresh momentum), and records
what the benchmark compares: each step's loss terms and ``num_fg``, the
first step's head maps, the first gradient as the optimizer takes it (clipped, decayed: the Nesterov
trace after one step) beside the norm of each leaf's raw first gradient,
and the parameters and EMA after each step.
"""

from __future__ import annotations

import math

import torch

from portbench.reference.model import STRIDES, Detector, set_precision

LOSS_TERMS = ("loss_box", "loss_cls", "loss_dfl", "total_loss")
# leaves whose raw first gradient is under this share of the median leaf's
# move by round-off alone under the optimizer and are left out of the change
STILL = 1e-3


def xywh_to_xyxy(b):
    c, half = b[..., :2], b[..., 2:4] / 2.0
    return torch.cat([c - half, c + half], dim=-1)


def ciou(b1, b2, eps: float = 1e-7):
    """Complete IoU of xyxy boxes, broadcasting; the aspect term's weight
    carries no gradient."""
    ix1 = torch.maximum(b1[..., 0], b2[..., 0])
    iy1 = torch.maximum(b1[..., 1], b2[..., 1])
    ix2 = torch.minimum(b1[..., 2], b2[..., 2])
    iy2 = torch.minimum(b1[..., 3], b2[..., 3])
    inter = (ix2 - ix1).clamp(min=0) * (iy2 - iy1).clamp(min=0)
    w1, h1 = b1[..., 2] - b1[..., 0], b1[..., 3] - b1[..., 1]
    w2, h2 = b2[..., 2] - b2[..., 0], b2[..., 3] - b2[..., 1]
    union = w1 * h1 + w2 * h2 - inter + eps
    iou = inter / union
    cw = (torch.maximum(b1[..., 2], b2[..., 2]) - torch.minimum(b1[..., 0], b2[..., 0])).clamp(min=0)
    ch = (torch.maximum(b1[..., 3], b2[..., 3]) - torch.minimum(b1[..., 1], b2[..., 1])).clamp(min=0)
    c2 = cw**2 + ch**2 + eps
    rho2 = ((b1[..., 0] + b1[..., 2] - b2[..., 0] - b2[..., 2]) ** 2
            + (b1[..., 1] + b1[..., 3] - b2[..., 1] - b2[..., 3]) ** 2) / 4
    v = (4 / math.pi**2) * (torch.atan(w2 / (h2 + eps)) - torch.atan(w1 / (h1 + eps))) ** 2
    alpha = (v / (1 - iou + v + eps)).detach()
    return iou - rho2 / c2 - alpha * v


@torch.no_grad()
def assign(pd_scores, pd_boxes, anchor_px, gt_labels, gt_boxes, gt_mask, nc, topk=10,
           alpha=0.5, beta=6.0, eps=1e-9):
    """TAL -> (target boxes [B, A, 4], target scores [B, A, nc], fg [B, A])."""
    bf16 = torch.bfloat16
    a, m = pd_scores.shape[1], gt_boxes.shape[1]
    ax, ay = anchor_px[None, None, :, 0], anchor_px[None, None, :, 1]
    inside = ((ax - gt_boxes[..., None, 0] > eps) & (ay - gt_boxes[..., None, 1] > eps)
              & (gt_boxes[..., None, 2] - ax > eps) & (gt_boxes[..., None, 3] - ay > eps))
    inside &= gt_mask[..., None]
    ious = ciou(gt_boxes[:, :, None, :], pd_boxes[:, None, :, :]).clamp(min=0.0).to(bf16)
    cls = gt_labels.clamp(0, nc - 1).long()
    score = torch.gather(pd_scores.transpose(1, 2), 1, cls[:, :, None].expand(-1, -1, a)).to(bf16)
    metric = score.float().pow(alpha) * ious.float().pow(beta)
    metric = torch.where(inside, metric, 0.0).to(bf16)
    work = metric.clone()
    for _ in range(min(topk, a)):
        work.scatter_(-1, work.argmax(-1, keepdim=True), -1.0)
    pos = (work < 0) & (metric > eps) & inside
    best_gt = torch.where(pos, ious, torch.tensor(-1.0, dtype=bf16)).argmax(1)
    pos &= torch.arange(m, device=gt_boxes.device)[None, :, None] == best_gt[:, None, :]
    fg = pos.any(1)
    tboxes = torch.gather(gt_boxes, 1, best_gt[..., None].expand(-1, -1, 4))
    tboxes = torch.where(fg[..., None], tboxes, 0.0)
    tlabels = torch.where(fg, torch.gather(cls, 1, best_gt), 0)
    zero = torch.tensor(0.0, dtype=bf16)
    metric_pos = torch.where(pos, metric, zero)
    iou_pos = torch.where(pos, ious, zero)
    norm = metric_pos * iou_pos.amax(2, keepdim=True) / (metric_pos.amax(2, keepdim=True) + eps)
    anchor_score = norm.amax(1).float()
    onehot = torch.nn.functional.one_hot(tlabels, nc).float() * fg[..., None]
    tscores = torch.where(fg[..., None], onehot * anchor_score[..., None], 0.0)
    return tboxes, tscores, fg


def detection_loss(maps, gt_boxes, gt_labels, gt_mask, nc, reg_max, w):
    """Per-scale NCHW (box, cls) maps and padded GT (normalized cxcywh) ->
    (total, {'loss_box', 'loss_cls', 'loss_dfl', 'total_loss', 'num_fg'})."""
    shapes = [tuple(b.shape[2:]) for b, _ in maps]
    dev = maps[0][0].device
    box = torch.cat([b.float().flatten(2).transpose(1, 2) for b, _ in maps], 1)
    logits = torch.cat([c.float().flatten(2).transpose(1, 2) for _, c in maps], 1)
    pts, stride = [], []
    for (h, wd), s in zip(shapes, STRIDES):
        gy, gx = torch.meshgrid(torch.arange(h, device=dev) + 0.5,
                                torch.arange(wd, device=dev) + 0.5, indexing="ij")
        pts.append(torch.stack([gx, gy], -1).reshape(-1, 2).float())
        stride.append(torch.full((h * wd, 1), float(s), device=dev))
    pts, stride = torch.cat(pts), torch.cat(stride)
    dist = box.reshape(*box.shape[:2], 4, reg_max)
    logz = torch.logsumexp(dist, -1)
    bins = torch.arange(reg_max, device=dev, dtype=torch.float32)
    ltrb = (torch.softmax(dist, -1) * bins).sum(-1)
    pd_boxes = torch.cat([pts[None] - ltrb[..., :2], pts[None] + ltrb[..., 2:]], -1) * stride[None]
    img_h, img_w = shapes[0][0] * STRIDES[0], shapes[0][1] * STRIDES[0]
    scale = torch.tensor([img_w, img_h, img_w, img_h], dtype=torch.float32, device=dev)
    gt_xyxy = xywh_to_xyxy(gt_boxes.float() * scale)
    tboxes, tscores, fg = assign(torch.sigmoid(logits).detach(), pd_boxes.detach(),
                                 pts * stride, gt_labels, gt_xyxy, gt_mask, nc,
                                 w["tal_topk"], w["tal_alpha"], w["tal_beta"])
    total_score = tscores.sum().clamp(min=1.0)
    bce = logits.clamp(min=0) - logits * tscores + torch.log1p(torch.exp(-logits.abs()))
    loss_cls = bce.sum() / total_score
    weight = tscores.sum(-1) * fg
    loss_box = ((1.0 - ciou(pd_boxes, tboxes)) * weight).sum() / total_score
    tb = tboxes / stride[None]
    target = torch.stack([pts[None, :, 0] - tb[..., 0], pts[None, :, 1] - tb[..., 1],
                          tb[..., 2] - pts[None, :, 0], tb[..., 3] - pts[None, :, 1]], -1)
    target = target.clamp(0.0, reg_max - 1 - 1e-3)
    left = torch.floor(target)
    wr = target - left
    two_hot = (1 - wr)[..., None] * (bins == left[..., None]) + wr[..., None] * (
        bins == left[..., None] + 1)
    dfl = (logz - (two_hot * dist).sum(-1)).mean(-1)
    loss_dfl = (dfl * weight).sum() / total_score
    total = w["box_weight"] * loss_box + w["cls_weight"] * loss_cls + w["dfl_weight"] * loss_dfl
    return total, {"loss_box": loss_box, "loss_cls": loss_cls, "loss_dfl": loss_dfl,
                   "total_loss": total, "num_fg": fg.sum()}


def learning_rate(n: int, t: dict) -> float:
    """lr of update ``n`` (from 0): warm-up from 0, then the cosine."""
    base = t["learning_rate"]
    s = t["scheduler"]
    warm = s["warmup_steps"]
    if n < warm:
        return base * n / warm
    decay = max(1, s["cosine_t_max"] * t["steps_per_epoch"])
    c = min(n - warm, decay)
    alpha = s["cosine_eta_min"] / base
    return base * ((1 - alpha) * 0.5 * (1 + math.cos(math.pi * c / decay)) + alpha)


class TrainReference:
    """The reference train step on ``device`` from a state_dict."""

    def __init__(self, cfg: dict, state_dict: dict, device, precision: str = "f32",
                 start_update: int = 0):
        self.cfg, self.t = cfg, cfg["train"]
        self.model = Detector(cfg).to(device)
        self.model.load_state_dict({k: v.float() if v.is_floating_point() else v
                                    for k, v in state_dict.items()})
        set_precision(self.model.train(), precision)
        self.names = [n for n, _ in self.model.named_parameters()]
        self.params = [p for _, p in self.model.named_parameters()]
        self.trace = [torch.zeros_like(p) for p in self.params]
        self.ema = {n: p.detach().clone() for n, p in self.model.named_parameters()}
        self.start = {n: p.detach().clone() for n, p in zip(self.names, self.params)}
        self.n = start_update  # the schedule's and the EMA's step count
        self.first_grad = self.raw_grad_norms = None
        self.losses = []

    def step(self, batch: dict) -> dict:
        from portbench.reference.detect import normalize

        t = self.t
        maps = self.model(normalize(batch["images"]))
        if not self.losses:
            self.first_maps = [torch.cat([b, c], 1).detach().clone() for b, c in maps]
        loss, terms = detection_loss(maps, batch["boxes"], batch["labels"], batch["mask"],
                                     self.cfg["num_classes"], self.cfg["reg_max"], t["loss"])
        grads = torch.autograd.grad(loss, self.params)
        with torch.no_grad():
            norm = torch.sqrt(sum((g.double() ** 2).sum() for g in grads)).float()
            clip = t["grad_clip_norm"]
            factor = 1.0 if norm < clip else clip / norm
            lr = learning_rate(self.n, t)
            mom, wd = t["sgd_momentum"], t["weight_decay"]
            for p, g, tr in zip(self.params, grads, self.trace):
                g = g * factor + wd * p
                tr.mul_(mom).add_(g)
                p.add_(g + mom * tr, alpha=-lr)
            if not self.losses:
                self.first_grad = {n: tr.clone() for n, tr in zip(self.names, self.trace)}
                self.raw_grad_norms = {n: g.norm() for n, g in zip(self.names, grads)}
            d = t["ema_decay"] * (1.0 - math.exp(-(self.n + 1.0) / 2000.0))
            for n, p in zip(self.names, self.params):
                self.ema[n].mul_(d).add_(p, alpha=1.0 - d)
        self.n += 1
        self.losses.append({k: float(v.detach()) for k, v in terms.items()})
        return self.losses[-1]

    def record(self) -> dict:
        """What the benchmark compares: the losses so far, the first step's
        head maps (NCHW, box and class channels), and by leaf (flattened)
        the first gradient as the optimizer took it and the change of the
        parameters and of the EMA since the start."""
        return {"losses": self.losses, "maps": self.first_maps,
                "first_grad": {n: g.reshape(-1) for n, g in self.first_grad.items()},
                "change": {n: (p.detach() - self.start[n]).reshape(-1)
                           for n, p in zip(self.names, self.params)},
                "ema_change": {n: (self.ema[n] - self.start[n]).reshape(-1) for n in self.names}}

    def moving(self) -> list:
        """The leaves whose raw first gradient is at least ``STILL`` of the
        median leaf's: the ones whose change is compared."""
        norms = {n: float(v) for n, v in self.raw_grad_norms.items()}
        floor = STILL * sorted(norms.values())[len(norms) // 2]
        return [n for n in self.names if norms[n] >= floor]
