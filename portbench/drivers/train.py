"""Training traffic: the recipe's train step on batches resident on the card.

The traffic file gives ``batch``, the GT bucket of each batch of the pool
(``buckets``: the pool cycles through them), the per-image GT count
(``gt_mean``, ``gt_dispersion``: negative binomial, at least 1, at most the
batch's bucket; a batch of a bucket above the smallest has one image above
the bucket below, so that the bucket is the one the trainer's
``_bucket_gt`` would pick) and ``profile_calls``. The seed draws the pixels
(uint8, uniform), the counts, the boxes (centres uniform in [0.05, 0.95],
sides log-uniform in [0.02, 0.5] of the image, clipped to it) and the
labels; the buckets, and so the work, are the same for every seed.
``start_update`` is where in the recipe's schedule the run stands: the
optimizer's update count and the EMA's step count start there (with the
momentum at 0), which sets the learning rate and the EMA's decay.

Set-up builds one ``TrainState`` (the configuration's architecture in train
structure, float32 master weights, EMA) and the step of ``make_train_step``
(``DetectionLoss`` and the optimizer as the recipe says, bf16 autocast),
then drives it through its first three steps on the pool's first three
batches and a fourth on the fourth; those steps' losses, the Nesterov trace
after the first (the first gradient as the optimizer takes it), and the
parameters and EMA after the third are kept. The window then runs the same
step on the same state, cycling through the pool. Afterwards the float32
reference (``reference/train.py``) follows the first three steps from the
same weights and batches.
"""

from __future__ import annotations

import gc
import statistics
import time

import numpy as np
import torch

from portbench.reference.model import forward_flops, ieee_f32
from portbench.reference.train import LOSS_TERMS, STILL, TrainReference
from portbench.trace import GcWatch, capture
from portbench.weights import seeded_state_dict


def pool_batches(rng: np.random.Generator, traffic: dict, cfg: dict, dev) -> list:
    """The traffic's batches on ``dev``: uint8 NHWC images and padded GT."""
    b, (h, w) = traffic["batch"], cfg["image_size"]
    mean, disp = traffic["gt_mean"], traffic["gt_dispersion"]
    smallest = min(traffic["buckets"])
    batches = []
    for m in traffic["buckets"]:
        counts = rng.negative_binomial(disp, disp / (disp + mean), size=b).clip(1, m)
        if m > smallest:
            below = max(x for x in traffic["buckets"] if x < m)
            counts[rng.integers(b)] = rng.integers(below + 1, m + 1)
        boxes = np.zeros((b, m, 4), np.float32)
        labels = np.zeros((b, m), np.int32)
        mask = np.zeros((b, m), bool)
        for i, n in enumerate(counts):
            wh = np.exp(rng.uniform(np.log(0.02), np.log(0.5), size=(n, 2)))
            c = rng.uniform(0.05, 0.95, size=(n, 2))
            x1y1 = np.clip(c - wh / 2, 0.0, 1.0)
            x2y2 = np.clip(c + wh / 2, 0.0, 1.0)
            boxes[i, :n] = np.concatenate([(x1y1 + x2y2) / 2, x2y2 - x1y1], 1)
            labels[i, :n] = rng.integers(0, cfg["num_classes"], size=n)
            mask[i, :n] = True
        images = rng.integers(0, 256, (b, h, w, 3), dtype=np.uint8)
        batches.append({k: torch.from_numpy(v).to(dev) for k, v in
                        (("images", images), ("boxes", boxes), ("labels", labels),
                         ("mask", mask))})
    return batches


def build(cfg: dict, state_dict: dict, dev):
    """(state, step) as the recipe builds them."""
    from yolo_ms_tpu_torch.models.registry import build_model
    from yolo_ms_tpu_torch.train.loss import DetectionLoss
    from yolo_ms_tpu_torch.train.optim import build_optimizer
    from yolo_ms_tpu_torch.train.trainer import TrainState, make_train_step
    from yolo_ms_tpu_torch.utils.config import SchedulerConfig, TrainingConfig

    t, loss = cfg["train"], cfg["train"]["loss"]
    model = build_model(cfg["port_architecture"], num_classes=cfg["num_classes"],
                        reg_max=cfg["reg_max"], device=dev)
    model.load_state_dict(state_dict)
    tcfg = TrainingConfig(
        batch_size=t["batch_size_per_card"], learning_rate=t["learning_rate"],
        optimizer=t["optimizer"], sgd_momentum=t["sgd_momentum"],
        sgd_nesterov=t["sgd_nesterov"], weight_decay=t["weight_decay"], epochs=t["epochs"],
        grad_clip_norm=t["grad_clip_norm"], ema_decay=t["ema_decay"],
        scheduler=SchedulerConfig(**t["scheduler"]))
    tx, _ = build_optimizer(tcfg, t["steps_per_epoch"])
    state = TrainState.create(model, tx, ema=t["ema_decay"] > 0)
    loss_fn = DetectionLoss(num_classes=cfg["num_classes"], reg_max=cfg["reg_max"],
                            box_weight=loss["box_weight"], cls_weight=loss["cls_weight"],
                            dfl_weight=loss["dfl_weight"], use_focal=loss["use_focal"],
                            tal_topk=loss["tal_topk"], tal_alpha=loss["tal_alpha"],
                            tal_beta=loss["tal_beta"], iou_type=loss["iou_type"])
    step = make_train_step(loss_fn, tx, t["ema_decay"], getattr(torch, cfg["dtype"]))
    return state, step


def leaves(flat: torch.Tensor, named: list) -> dict:
    """A flat vector in the order of ``named`` ([(name, numel)]) -> name ->
    leaf."""
    out, offset = {}, 0
    for name, n in named:
        out[name] = flat[offset : offset + n]
        offset += n
    return out


def leaf_gaps(got: dict, want: dict, names) -> dict:
    """name -> the leaf's gap between the norms, over the larger of its
    reference norm and the median leaf's."""
    g = {n: float(got[n].double().norm()) for n in names}
    w = {n: float(want[n].double().norm()) for n in names}
    floor = statistics.median(w.values())
    return {n: abs(g[n] - w[n]) / max(w[n], floor) for n in names}


def compare(got: dict, want: dict, moving: list, nc: int) -> dict:
    """The numbers that decide ``correct``, of a record (``losses`` of the
    three steps, the first step's head ``maps``, ``first_grad``, ``change``
    and ``ema_change`` by leaf) against the reference's: of the six maps
    (box and class channels of each level) the worst by the ratio of their
    spreads (``map_std_gap``) and by the RMS difference over the reference
    map's spread (``map_err``), each step's loss terms (relative) and
    ``num_fg`` (relative), and the median leaf's gap of the first gradient,
    and of the change of the parameters and of the EMA over the three
    steps, the last two over the leaves in ``moving``. The worst leaf's
    gaps come beside them (``*_worst``), and the three worst leaves with
    their sizes (``*_worst_leaves``: [name, elements, gap]), for the log.
    Random weights make the train-mode forward chaotic: bf16's rounding
    alone moves the maps element by element by most of their spread
    (``map_err``), while their spread, which fp8's rounding widens, stays
    put."""
    pairs = list(zip(got["losses"], want["losses"]))
    rows = min(got["maps"][0].shape[0], want["maps"][0].shape[0])
    nb = want["maps"][0].shape[1] - nc
    maps = [(g[:rows, part].float(), w[:rows, part].float())
            for g, w in zip(got["maps"], want["maps"])
            for part in (slice(0, nb), slice(nb, None))]
    out = {
        "map_std_gap": max(abs(float(g.std() / w.std()) - 1.0) for g, w in maps),
        "map_err": max(float((g - w).pow(2).mean().sqrt() / w.std()) for g, w in maps),
        "loss_gap": max(abs(g[k] - w[k]) / max(abs(w[k]), 1e-6) for g, w in pairs
                        for k in LOSS_TERMS),
        "fg_gap": max(abs(g["num_fg"] - w["num_fg"]) / max(w["num_fg"], 1.0) for g, w in pairs),
    }
    for name, key, names in (("grad_gap", "first_grad", list(want["first_grad"])),
                             ("change_gap", "change", moving),
                             ("ema_gap", "ema_change", moving)):
        gaps = leaf_gaps(got[key], want[key], names)
        out[name] = statistics.median(gaps.values())
        out[f"{name}_worst"] = max(gaps.values())
        out[f"{name}_worst_leaves"] = [[n, want[key][n].numel(), gaps[n]] for n in
                                       sorted(gaps, key=gaps.get, reverse=True)[:3]]
    out["loss_gap_first"] = max(abs(got["losses"][0][k] - want["losses"][0][k])
                                / max(abs(want["losses"][0][k]), 1e-6) for k in LOSS_TERMS)
    return out


def run(cell, card: str) -> dict:
    cfg, traffic, say = cell.cfg, cell.traffic, cell.say
    dev = torch.device(cell.device)
    state_dict = seeded_state_dict(cfg, cell.seed, dev)
    state, step = build(cfg, state_dict, dev)
    named = [(n, p.numel()) for n, p in state.model.named_parameters()]
    rng = np.random.default_rng(cell.seed)
    pool = pool_batches(rng, traffic, cfg, dev)
    say(f"GT per image in the pool: {[int(b['mask'].sum()) for b in pool]} over "
        f"{len(pool)} x {traffic['batch']} images, buckets {traffic['buckets']}")
    # resume the schedule at ``start_update`` (fresh momentum): the step count
    # sets the learning rate and the EMA's decay
    state.opt_state["count"].fill_(traffic["start_update"])
    state.step.fill_(traffic["start_update"])
    start = state.params.clone()
    first, maps = [], []
    grab = state.model.register_forward_hook(
        lambda module, args, out: maps.extend(m.detach().float() for m in out))
    for i in range(3):
        metrics = step(state, pool[i])
        first.append({k: float(metrics[k]) for k in (*LOSS_TERMS, "num_fg")})
        if i == 0:
            grab.remove()
            trace0 = state.opt_state["trace"].clone()
    after3, ema3 = state.params.clone(), state.ema_params.clone()
    step(state, pool[3 % len(pool)])
    torch.cuda.synchronize()
    setup_end = time.perf_counter()

    n, t0 = 0, time.perf_counter()
    with GcWatch() as gc_watch:
        while time.perf_counter() - t0 < cell.seconds:
            step(state, pool[n % len(pool)])
            n += 1
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    images = n * traffic["batch"]
    say(f"window {wall:.4f} s, {n} steps, {images} images; garbage collection in the window: "
        f"{gc_watch.summary()}")
    trace = None
    if cell.trace:
        calls = traffic["profile_calls"]

        def stretch():
            for i in range(calls):
                step(state, pool[i % len(pool)])

        trace = capture(stretch, calls, calls * traffic["batch"])
        trace.extra.update(flops_per_image=forward_flops(cfg, tuple(cfg["image_size"])))
    memory_peak = torch.cuda.max_memory_allocated()
    del state, step
    gc.collect()
    torch.cuda.empty_cache()

    t1 = time.perf_counter()
    with ieee_f32():
        ref = TrainReference(cfg, state_dict, dev, start_update=traffic["start_update"])
        for i in range(3):
            ref.step(pool[i])
    program = {"losses": first, "maps": maps, "first_grad": leaves(trace0, named),
               "change": leaves(after3 - start, named), "ema_change": leaves(ema3 - start, named)}
    moving = ref.moving()
    checks = compare(program, ref.record(), moving, cfg["num_classes"])
    say(f"reference: 3 float32 steps in {time.perf_counter() - t1:.4f} s; "
        f"{len(named) - len(moving)} of {len(named)} leaves still (raw first gradient "
        f"under {STILL} of the median leaf's) left out of the change")
    for i, (g, w) in enumerate(zip(first, ref.losses)):
        say(f"step {i + 1}: program {g} reference {w}")
    return {"attempted": n, "failed": 0, "setup_end": setup_end,
            "e2e": {"train_img_per_s": images / wall},
            "memory_peak_bytes": memory_peak, "trace": trace, "checks": checks}
