"""Serving traffic: ``Predictor.predict_batch`` on uint8 batches, numpy out.

The traffic is a closed loop: one caller sends the next batch when the
last one's detections are back. The traffic file gives ``batch`` (images a
call), ``pool`` (distinct batches drawn from the seed, cycled through the
window), ``sample`` (calls of the window whose detections are judged) and
``profile_calls`` (the traced stretch).

Set-up draws the weights on the card, builds the predictor (BN-folded,
entry layouts and dtype as the configuration says), draws the pool and
serves every batch of it once. The window then runs ``--seconds``. With
``--trace 1`` a stretch of ``profile_calls`` calls follows it under the
profiler, with the harness's ranges ``portbench/predict_batch``,
``portbench/infer`` and ``portbench/model`` around the calls into each
layer, and the ``select`` and NMS launches counted; a profile whose kernel
counts differ from the launch counters fails the run. Once the window has
closed and the predictor is gone, the float32 reference judges a sample,
drawn from the seed, of the window's calls (``reference/detect.py``).
"""

from __future__ import annotations

import gc
import time

import numpy as np
import torch

from portbench import yardstick
from portbench.reference import detect
from portbench.readers import NMS_KERNEL, SELECT_KERNEL
from portbench.reference.model import Detector, forward_flops, ieee_f32
from portbench.trace import GcWatch, capture
from portbench.weights import seeded_state_dict


def window(predict, pool: list, seconds: float):
    """The measured window, one call after another -> (outputs, latencies
    s, wall s)."""
    outs, lat = [], []
    start = time.perf_counter()
    end = start + seconds
    while time.perf_counter() < end:
        t = time.perf_counter()
        outs.append(predict(pool[len(outs) % len(pool)]))
        lat.append(time.perf_counter() - t)
    return outs, lat, time.perf_counter() - start


def traced(pred, pool: list, calls: int, card: str, cfg: dict):
    """The traced stretch, with the harness's ranges and the work of each
    ``select`` and NMS call recorded for the bounds."""
    from torch.profiler import record_function

    import yolo_ms_tpu_torch.ops.nms as nms_ops
    import yolo_ms_tpu_torch.ops.postprocess as post
    from yolo_ms_tpu_torch.ops.kernels.nms import nms as nms_entry
    from yolo_ms_tpu_torch.ops.kernels.select import select as select_entry

    sel_shapes, nms_inputs, open_ranges = [], [], []
    real_select, real_nms, real_infer = post.select_scales, nms_ops.nms_kernel, pred.infer

    def select_spy(pairs, reg_max=16):
        sel_shapes.append([((b.shape[0], b.shape[1], b.shape[2], b.element_size()),
                            (c.shape[2], c.element_size())) for b, c in pairs])
        return real_select(pairs, reg_max)

    def nms_spy(boxes, scores, iou):
        nms_inputs.append((boxes, scores))
        return real_nms(boxes, scores, iou)

    def infer(x):
        with record_function("portbench/infer"):
            return real_infer(x)

    def enter(module, args):
        r = record_function("portbench/model")
        r.__enter__()
        open_ranges.append(r)

    def leave(module, args, out):
        open_ranges.pop().__exit__(None, None, None)

    def run():
        for i in range(calls):
            with record_function("portbench/predict_batch"):
                pred.predict_batch(pool[i % len(pool)])

    hooks = [pred.serve.model.register_forward_pre_hook(enter),
             pred.serve.model.register_forward_hook(leave)]
    post.select_scales, nms_ops.nms_kernel, pred.infer = select_spy, nms_spy, infer
    before = (select_entry.launches, nms_entry.launches)
    try:
        trace = capture(run, calls, calls * len(pool[0]))
    finally:
        post.select_scales, nms_ops.nms_kernel = real_select, real_nms
        del pred.infer
        for h in hooks:
            h.remove()
    launched = (select_entry.launches - before[0], nms_entry.launches - before[1])
    seen = (sum(bool(SELECT_KERNEL.search(o.name)) for o in trace.ops),
            sum(bool(NMS_KERNEL.search(o.name)) for o in trace.ops))
    if seen != launched:
        raise RuntimeError(f"the profile holds {seen[0]} select and {seen[1]} NMS kernels, "
                           f"but {launched[0]} and {launched[1]} were launched: it lost events")
    sel_ms = [yardstick.bound_of(*yardstick.select_bound(s, card))[0] for s in sel_shapes]
    iou = cfg["serve"]["iou_thresh"]
    nms_ms = [yardstick.bound_of(*yardstick.nms_bound(
        scores, yardstick.nms_sweeps(boxes, scores, iou), card))[0] for boxes, scores in nms_inputs]
    trace.extra.update(
        select_bound_ms=sum(sel_ms) / calls, nms_bound_ms=sum(nms_ms) / calls,
        flops_per_image=forward_flops(cfg, tuple(cfg["image_size"])),
        select_kernels=seen[0], nms_kernels=seen[1])
    return trace


def run(cell, card: str) -> dict:
    from yolo_ms_tpu_torch.infer.predictor import Predictor
    from yolo_ms_tpu_torch.ops.kernels import nms as nms_kernel
    from yolo_ms_tpu_torch.ops.kernels import select as select_kernel

    cfg, traffic, say = cell.cfg, cell.traffic, cell.say
    dev = torch.device(cell.device)
    built = {k: m.build()["seconds"] for k, m in (("select", select_kernel), ("nms", nms_kernel))}
    say(f"nvcc build seconds (0.0: already built) {built}")
    dtype = getattr(torch, cfg["dtype"])
    state_dict = seeded_state_dict(cfg, cell.seed, dev, dtype)
    sv = cfg["serve"]
    hw = tuple(cfg["image_size"])
    pred = Predictor(cfg["port_architecture"], state_dict, cfg["num_classes"], input_size=hw,
                     conf_thresh=sv["conf_thresh"], iou_thresh=sv["iou_thresh"],
                     max_det=sv["max_det"], batch_size=traffic["batch"], dtype=dtype,
                     pre_nms_topk=sv["pre_nms_topk"], deploy=cfg["deploy"],
                     entry_layouts=cfg["entry_layouts"], device=dev)
    rng = np.random.default_rng(cell.seed)
    pool = [yardstick.serving_batch(rng, traffic["batch"], hw) for _ in range(traffic["pool"])]
    for x in pool:
        pred.predict_batch(x)
    torch.cuda.synchronize()
    setup_end = time.perf_counter()

    with GcWatch() as gc_watch:
        outs, lat, wall = window(pred.predict_batch, pool, cell.seconds)
    images = len(outs) * traffic["batch"]
    lat_ms = np.asarray(lat) * 1e3
    slow = np.flatnonzero(lat_ms > 3 * np.median(lat_ms))
    top = np.argsort(lat_ms)[::-1][:5]
    say(f"window {wall:.4f} s, {len(outs)} calls, {images} images; latency samples "
        f"{len(lat_ms)}, median {np.median(lat_ms):.4f} ms, p95 {np.percentile(lat_ms, 95):.4f} "
        f"ms, max {lat_ms.max():.4f} ms; {len(slow)} calls over 3x the median, the first at "
        f"{slow[:8].tolist()}; slowest {[(int(i), round(float(lat_ms[i]), 2)) for i in top]}")
    say(f"garbage collection in the window: {gc_watch.summary()}")
    trace = traced(pred, pool, traffic["profile_calls"], card, cfg) if cell.trace else None
    memory_peak = torch.cuda.max_memory_allocated()

    del pred
    gc.collect()
    torch.cuda.empty_cache()
    checks = judge(cell, state_dict, pool, outs, dev)
    return {"attempted": len(outs), "failed": 0, "setup_end": setup_end,
            "e2e": {"serve_img_per_s": images / wall,
                    "serve_p95_ms": float(np.percentile(lat_ms, 95))},
            "memory_peak_bytes": memory_peak, "trace": trace, "checks": checks}


def judge(cell, state_dict: dict, pool: list, outs: list, dev) -> dict:
    """The float32 reference on a sample of the window's calls, drawn from
    the seed: the worst of each number over the sampled images."""
    cfg, sv = cell.cfg, cell.cfg["serve"]
    t0 = time.perf_counter()
    ref = Detector(cfg).to(dev).eval()
    ref.load_state_dict({k: v.float() if v.is_floating_point() else v
                         for k, v in state_dict.items()})
    picks = np.random.default_rng([cell.seed, 1]).choice(
        len(outs), size=min(cell.traffic["sample"], len(outs)), replace=False)
    worst = {}
    by_batch = {}
    for i in sorted(picks):
        by_batch.setdefault(i % len(pool), []).append(i)
    # one reference pass over the sampled pool batches, a block of rows at a time
    for j, calls in by_batch.items():
        with ieee_f32():
            boxes, logits = detect.dense(ref, torch.from_numpy(pool[j]).to(dev))
        for i in calls:
            got = detect.judge(outs[i], boxes, logits, sv["conf_thresh"], sv["iou_thresh"],
                               sv["pre_nms_topk"], sv["max_det"])
            worst = {k: max(worst.get(k, 0.0), v) for k, v in got.items()}
    cell.say(f"judged {len(picks)} calls of the window ({len(picks) * cell.traffic['batch']} "
             f"images) against the float32 reference in {time.perf_counter() - t0:.4f} s")
    return worst
