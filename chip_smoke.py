"""Drive the PyTorch/CUDA port's serving, training and tool paths on one card.

    python3 chip_smoke.py

Needs one CUDA card and nvcc (sm_90a); it exits non-zero on the first phase
that fails, and without a card. Phases, each printing one line:

1. device: the card as ``nvidia-smi --query-gpu=name,power.limit`` names it;
2. build: compiles ``yolo_ms_tpu_torch/csrc/select.cu`` into the ignored
   ``yolo_ms_tpu_torch/build/`` directory and prints its registers and its
   launch plan (anchors per tile, ring stages, shared memory, CTAs per SM);
3. the one-launch ``select_scales`` against ``select_scales_plain`` on the
   card, at the serving scales (batch 32; HW 6400 / 1600 / 400) and at ragged
   and misaligned ones (HW 400 / 49 / 25); nc 80 and 3; f32 and bf16; split
   pair, unsplit map and NCHW permute view; plus the tie and +100 / -60
   cases: ``mx`` and ``cid`` exactly equal, ``ltrb`` within 1e-5 (f32) /
   1e-4 (bf16); each layout's copy route and its time per batch (L2
   flushed); then the card-only tests of ``tests/test_torch_cuda.py`` in a
   child pytest;
4. the two trained golden fixtures through ``Predictor(device="cuda")`` in
   f32, matched against their checked-in detections, and the card's raw
   maps on the same image held against the CPU's (atol 1e-4);
5. full-width serving: yolo-ms-xs and yolov8-n, nc=80, 640x640, bf16,
   batch 32, weights from seeded numpy through the converter, BN-folded;
   ``select.launches`` must rise by 1 per batch; outputs are checked, the
   kernel tail is held against the plain tail on the same f32 maps, and the
   batch time (host clock) and the copy, forward, post-process and kernel
   times (CUDA events) are measured as medians. The kernel is timed as one
   launch per batch with L2 flushed (by a write, and by a read) and
   unflushed (as the main path finds the maps after the head convs), each
   behind a spin kernel so that the host's enqueue time is not counted, and
   on each scale alone; the host's time to enqueue one call is measured
   apart. Each time stands beside its bound (bytes over the memory rate
   against operations over the f32 rate of the card that ``nvidia-smi``
   names);
6. training on the card:
   a. one f32 train step (TF32 off) of the golden yolov8-n weights with
      SGD-nesterov, weight decay, clipping and EMA, on the card and on the
      CPU in this process: loss terms within rtol 1e-4; params, BN
      statistics and EMA within rtol 1e-3 / atol 1e-5;
   b. the JAX package's learning recipe (``tests/test_learning.py``:
      yolov8-n, 160 px, nc=3, 32 synthetic images, batch 16, 60 epochs,
      Adam 2e-3, cosine with warmup 20) through ``Trainer.fit`` and
      ``validate``: mAP@0.5 must exceed 0.5;
   c. yolo-ms-xs at full width and depth, nc=80, 640x640, bf16 autocast,
      batch 32, with the ``coco_yolo_ms.yaml`` settings (warmup cut to 3
      steps), one epoch of 12 steps on synthetic 640x480 images and a
      64-image validation: every step finite, none skipped, positives in
      each; the first step's bf16 loss within 5 % of the f32 loss of the
      same batch; ``select.launches`` rising by exactly the number of val
      batches in ``fit`` (counts set to 0 just before it) and in a timed
      ``validate``; the checkpoint re-read by ``resume``. It prints ms/step
      (CUDA events), img/s, the host's wait for the loader, the gap from one
      step's start to the next (host clock), the end-to-end rate (every
      training image over the whole fit's wall time, validation and
      checkpoint writes included), the peak device memory and the validate
      time, then a breakdown of steps without the loader.

7. the tools on the card, each printing one line:
   a. ``tools.test`` on the golden yolov8-n from its ``weights.npz`` and from
      a reference-format ``.pt`` made from the same weights: the golden
      detections, one ``select`` launch per batch;
   b. ``tools.export`` of 6c's ``last.ckpt`` (EMA) to a folded f32 and a
      folded bf16 file (params, MB, seconds); the f32 export's raw maps
      against the unfolded EMA model's (TF32 off, atol 1e-3); ``tools.val``
      on each export over 6c's 64 val images at 640², batch 32: one
      ``select`` launch per val batch, ms per batch (host clock),
      detections and mAP@0.5;
   c. 6c's val images as an MJPG video through ``predict_video`` (640²,
      batch 32, the bf16 export served in f32): one launch per batch, each
      frame's detections those of ``predict_image`` on the decoded frame,
      every frame written; frames/s (host clock);
   d. the preemption drill: child processes (this script with
      ``--preempt-child``) train the 6b recipe cut to 2 epochs (SGD, f32,
      TF32 off, deterministic algorithms): twice uninterrupted; SIGTERM
      inside step 3's in-flight window, which must exit 143 with the
      committed step as its cursor; resumed from ``preempt.ckpt``, whose
      final params, statistics and EMA must equal the uninterrupted run's
      (rtol 1e-3 / atol 1e-5); the seconds from signal to exit;
   e. ``tools.analyze`` of yolo-ms-xs at 640² on the card: params and
      ``FlopCounterMode`` GFLOPs per image.

The last three lines are the kernel JSON, the nvidia-smi line, and
``{"ok": true, "device": {...}}``.

    python3 chip_smoke.py --parent DIR

instead times the select kernel of another checkout of the repo (``DIR``,
for example the parent commit unpacked with ``git archive``) against this
one on the same inputs, in turns (parent, this, this, parent), after
phases 1 and 2.

The kernel JSON counts ``select`` launches on every path
(``launches_by_path``): the serving run of phase 5, the training run of
phase 6c, and phase 7's ``tools.test``, ``tools.val`` and ``predict_video``
runs.
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import glob
import importlib.util
import json
import math
import os
import signal
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from yolo_ms_tpu_torch.data import native_loader
from yolo_ms_tpu_torch.data.augment import device_normalize_images
from yolo_ms_tpu_torch.data.decode import decode_and_resize
from yolo_ms_tpu_torch.infer.predictor import Predictor
from yolo_ms_tpu_torch.infer.video import predict_video
from yolo_ms_tpu_torch.models.deploy import fold_batchnorm
from yolo_ms_tpu_torch.models.registry import build_model
from yolo_ms_tpu_torch.ops.kernels import select as select_mod
from yolo_ms_tpu_torch.ops.kernels.select import (
    select,
    select_plain,
    select_scales,
    select_scales_plain,
)
from yolo_ms_tpu_torch.ops.nms import nms_fixed
from yolo_ms_tpu_torch.ops.postprocess import fused_postprocess
from yolo_ms_tpu_torch.tools import export as tools_export
from yolo_ms_tpu_torch.tools import test as tools_test
from yolo_ms_tpu_torch.tools import val as tools_val
from yolo_ms_tpu_torch.tools.analyze import analyze
from yolo_ms_tpu_torch.train.loss import DetectionLoss
from yolo_ms_tpu_torch.train.optim import build_optimizer
from yolo_ms_tpu_torch.train.trainer import Trainer, TrainState, make_train_step
from yolo_ms_tpu_torch.utils.checkpoint import load_serving_state_dict, restore_checkpoint
from yolo_ms_tpu_torch.utils.config import Config, TrainingConfig, load_config
from yolo_ms_tpu_torch.utils.convert import (
    load_npz,
    state_dict_to_variables,
    variables_to_state_dict,
)
from yolo_ms_tpu_torch.utils.device import full_f32

ROOT = os.path.dirname(os.path.abspath(__file__))
GOLDENS = (
    ("n", os.path.join(ROOT, "tests", "golden", "trained")),
    ("yolo-ms-xs", os.path.join(ROOT, "tests", "golden", "trained_yolo-ms-xs")),
)
SERVE_ARCHS = ("yolo-ms-xs", "yolov8-n")
BATCH, IMG, NC, REG_MAX = 32, 640, 80, 16
SERVE_BATCHES = 8  # batches in the counted main-path run, per model
LAYOUTS = ("split", "unsplit", "nchw")
# the serving scales at 640 px; a ragged set (HW 400 is not a multiple of the
# tile; the rows of HW 49 and 25 are not 16-byte aligned)
SCALE_SETS = (("serving", (80, 40, 20)), ("ragged", (20, 7, 5)))
# Device memory rate (bytes/s) and f32 rate outside the tensor cores
# (operations/s) by card name, from NVIDIA's data sheets (dense, full power).
PEAK_RATES = (
    ("H100 PCIe", 2.0e12, 51e12),
    ("H100 NVL", 3.9e12, 60e12),
    ("H100", 3.35e12, 67e12),
    ("H200", 4.8e12, 67e12),
)
LTRB_ATOL = {torch.float32: 1e-5, torch.bfloat16: 1e-4}
# f32 card forward (TF32 off) against the CPU's: the same sums in another
# order through ~60 conv layers. Phase 4 also prints the gap at the default
# (TF32) conv precision, which this bound is meant to exclude.
MAPS_ATOL = 1e-4


def peak_rates(name: str) -> tuple[float, float]:
    for key, mem, f32 in PEAK_RATES:
        if key in name:
            return mem, f32
    raise RuntimeError(f"no peak rates on record for {name!r}")


def select_bound(pairs, name: str) -> tuple[float, float]:
    """The two least times (ms) the card could take for one ``select_scales``
    call over (box, cls) pairs: each input element read once and 24 B
    written per anchor (mx, cid, ltrb) over the memory rate, and the f32
    operations (one compare per class logit; a max, subtract, clamp, exp,
    multiply and two adds per box logit) over the f32 rate. The bound is the
    larger."""
    mem_rate, f32_rate = peak_rates(name)
    nbytes = ops = 0
    for box, cls in pairs:
        n_anchor = box.shape[0] * box.shape[1]
        nbytes += n_anchor * (
            box.shape[2] * box.element_size() + cls.shape[2] * cls.element_size() + 24)
        ops += n_anchor * (cls.shape[2] + 7 * box.shape[2])
    return nbytes / mem_rate * 1e3, ops / f32_rate * 1e3


def bound_of(bytes_ms: float, ops_ms: float) -> tuple[float, str]:
    return (bytes_ms, "bytes") if bytes_ms >= ops_ms else (ops_ms, "operations")


def cuda_ms(fn, reps: int, flush: torch.Tensor | None = None, clean: bool = False,
            cover: bool = False) -> float:
    """Median device time of one call of ``fn`` (CUDA events around each
    call). ``flush`` is overwritten before each call so inputs come from HBM;
    with ``clean`` it is read instead, which leaves the L2 holding clean
    lines, so the call does not also write back up to 50 MB of dirty ones.
    ``cover`` first queues a spin kernel, so that the host's time to enqueue
    ``fn`` is not counted as device time."""
    fn()
    pairs = []
    for _ in range(reps):
        if flush is not None:
            if clean:
                flush.view(torch.int32).sum()
            else:
                flush.zero_()
        if cover:
            torch.cuda._sleep(400_000)  # about 0.2 ms of cycles
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in pairs)


def host_us(fn, reps: int = 200) -> float:
    """Median host time (us) to enqueue one call of ``fn``."""
    times = []
    for i in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e6)
        if i % 20 == 19:
            torch.cuda.synchronize()
    torch.cuda.synchronize()
    return statistics.median(times)


# ---------------------------------------------------------------- phase 3


def _layout_views(gen, b, h, w, nc, dtype, layout):
    """Random box/cls logits as [B, HW, C] views in one of three layouts."""
    dev = "cuda"
    nb = 4 * REG_MAX
    if layout == "nchw":
        box = torch.randn(b, nb, h, w, generator=gen, device=dev) * 2.0
        cls = torch.randn(b, nc, h, w, generator=gen, device=dev) * 2.0
        box, cls = box.to(dtype), cls.to(dtype)
        return box.permute(0, 2, 3, 1).flatten(1, 2), cls.permute(0, 2, 3, 1).flatten(1, 2)
    if layout == "split":
        box = (torch.randn(b, h * w, nb, generator=gen, device=dev) * 2.0).to(dtype)
        cls = (torch.randn(b, h * w, nc, generator=gen, device=dev) * 2.0).to(dtype)
        return box, cls
    flat = (torch.randn(b, h * w, nb + nc, generator=gen, device=dev) * 2.0).to(dtype)
    return flat[..., :nb], flat[..., nb:]


def compare_select(pairs, dtype, label):
    """``select_scales`` against ``select_scales_plain`` on the same maps."""
    mx, cid, ltrb = select_scales(pairs, REG_MAX)
    routes = list(select_scales.last_routes)
    pmx, pcid, pltrb = select_scales_plain(pairs, REG_MAX)
    torch.cuda.synchronize()
    if not torch.equal(mx, pmx):
        raise AssertionError(f"{label}: mx differs, max err {(mx - pmx).abs().max().item()}")
    if not torch.equal(cid, pcid):
        raise AssertionError(f"{label}: cid differs at {(cid != pcid).sum().item()} anchors")
    err = (ltrb - pltrb).abs().max().item()
    if not (err <= LTRB_ATOL[dtype]) or not torch.isfinite(ltrb).all():
        raise AssertionError(f"{label}: ltrb max err {err} > {LTRB_ATOL[dtype]}")
    return err, routes, (mx, cid, ltrb)


def _route_names(routes) -> str:
    return " ".join(f"{b}/{c}" for b, c in routes)


def phase_kernel_vs_plain(flush: torch.Tensor, name: str) -> float:
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    worst = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        for nc in (NC, 3):
            for set_name, sides in SCALE_SETS:
                parts = []
                for layout in LAYOUTS:
                    pairs = [_layout_views(gen, BATCH, s, s, nc, dtype, layout) for s in sides]
                    label = f"{dtype} {set_name} nc={nc} {layout}"
                    err, routes, _ = compare_select(pairs, dtype, label)
                    worst = max(worst, err)
                    part = f"{layout} err {err:.3e} route {_route_names(routes)}"
                    if set_name == "serving" and nc == NC:
                        ms = cuda_ms(lambda: select_scales(pairs, REG_MAX), 20, flush, cover=True)
                        bound = bound_of(*select_bound(pairs, name))[0]
                        part += f" {ms * 1e3:.1f} us ({bound / ms * 100:.0f} % of bound)"
                    parts.append(part)
                hws = "/".join(str(s * s) for s in sides)
                print(f"phase 3 select_scales {str(dtype)[6:]} B={BATCH} HW={hws} nc={nc}: "
                      f"mx, cid equal; " + "; ".join(parts))
    # ties and extremes: all-equal class logits -> id 0; side 0 peaked at
    # bin 3 (+100) -> 3.0; side 1 trails by 100 > 60 -> clamped, uniform 7.5
    for dtype in (torch.float32, torch.bfloat16):
        flat = torch.zeros(1, 16, 4 * REG_MAX + 8, dtype=dtype, device="cuda")
        flat[0, 0, 3] = 100.0
        err, _, (_, cid, ltrb) = compare_select(
            [(flat[..., : 4 * REG_MAX], flat[..., 4 * REG_MAX :])], dtype, f"{dtype} extremes"
        )
        worst = max(worst, err)
        got = ltrb[0, 0].tolist()
        if int(cid.abs().max()) != 0 or abs(got[0] - 3.0) > 1e-4 or abs(got[1] - 7.5) > 1e-4:
            raise AssertionError(f"extremes: cid {cid[0, :4].tolist()}, ltrb {got}")
        print(f"phase 3 select {str(dtype)[6:]} ties/+100/-60: cid 0, ltrb[0]={got[0]:.6f}, "
              f"ltrb[1]={got[1]:.6f}, max err {err:.3e}")
    return worst


def phase_cuda_tests() -> None:
    """The card-only tests (``cuda`` marker) in a child pytest; it imports no
    JAX, so it runs without the repo's conftest."""
    proc = subprocess.run(
        [sys.executable, "-m", "pytest", "--noconftest", "-q", "-p", "no:cacheprovider",
         "-m", "cuda", os.path.join("tests", "test_torch_cuda.py")],
        cwd=ROOT, capture_output=True, text=True, timeout=600,
    )
    lines = proc.stdout.strip().splitlines()
    summary = lines[-1] if lines else "no output"
    if proc.returncode != 0 or "skipped" in summary or "passed" not in summary:
        raise AssertionError(f"tests/test_torch_cuda.py: rc {proc.returncode}, {summary}\n"
                             f"{proc.stdout[-4000:]}{proc.stderr[-2000:]}")
    print(f"phase 3 tests/test_torch_cuda.py on the card: {summary}")


# ---------------------------------------------------------------- phase 4


def _iou(a, b):
    ix1, iy1 = max(a[0], b[0]), max(a[1], b[1])
    ix2, iy2 = min(a[2], b[2]), min(a[3], b[3])
    inter = max(0.0, ix2 - ix1) * max(0.0, iy2 - iy1)
    ua = (a[2] - a[0]) * (a[3] - a[1]) + (b[2] - b[0]) * (b[3] - b[1]) - inter
    return inter / max(ua, 1e-9)


def match_golden(got: list, golden: list, iou_min: float = 0.9, score_tol: float = 0.02) -> None:
    """The rule of tests/test_trained_golden.py: same count; each golden
    detection matched once by class, IoU > 0.9 and score within 0.02."""
    if len(got) != len(golden):
        raise AssertionError(f"{len(got)} detections, golden has {len(golden)}")
    unmatched = list(got)
    for g in golden:
        hit = next(
            (
                d
                for d in unmatched
                if d["class_id"] == g["class_id"]
                and _iou(d["box_xyxy"], g["box_xyxy"]) > iou_min
                and abs(d["score"] - g["score"]) < score_tol
            ),
            None,
        )
        if hit is None:
            raise AssertionError(f"golden detection unmatched: {g} in {got}")
        unmatched.remove(hit)


def phase_goldens() -> None:
    """Both trained goldens through the card's Predictor (f32, TF32 off),
    matched against their checked-in detections; then the card's raw maps
    on the same decoded image against the CPU's, within MAPS_ATOL."""
    for arch, gdir in GOLDENS:
        state_dict = load_npz(os.path.join(gdir, "weights.npz"))
        predictor = Predictor(
            arch,
            state_dict,
            num_classes=3,
            input_size=(160, 160),
            conf_thresh=0.25,
            iou_thresh=0.45,
            dtype=torch.float32,
            device="cuda",
        )
        fixture = os.path.join(gdir, "fixture_000.png")
        with tempfile.TemporaryDirectory() as out_dir:
            results = predictor.predict_paths(fixture, out_dir, verbose=False)
            if not os.path.exists(os.path.join(out_dir, "fixture_000_detected.jpg")):
                raise AssertionError("drawn fixture missing")
        with open(os.path.join(gdir, "fixture_000_detections.json")) as f:
            golden = json.load(f)
        got = next(iter(results.values()))
        match_golden(got, golden)

        image = torch.from_numpy(decode_and_resize(fixture, 160, 160)[None])
        cpu_model = build_model(arch, num_classes=3, device="cpu", deploy=True)
        cpu_model.load_state_dict(fold_batchnorm(state_dict), strict=True)
        with torch.inference_mode():
            want = cpu_model(_nchw(image))
            with full_f32():
                card = predictor.model(_nchw(image.cuda()))
            card_default = predictor.model(_nchw(image.cuda()))

        def max_err(maps):
            return max((m.cpu() - w).abs().max().item() for m, w in zip(maps, want))

        err = max_err(card)
        if not err <= MAPS_ATOL:
            raise AssertionError(f"{arch}: card raw maps differ from the CPU's by {err}")
        decoder = "native loader" if native_loader.available() else "cv2"
        print(f"phase 4 golden {arch}: {len(got)} detections match "
              f"(scores {[d['score'] for d in got]}, decoded by {decoder}); "
              f"raw maps card vs CPU max abs err {err:.3e} with TF32 off, "
              f"{max_err(card_default):.3e} at the default conv precision "
              f"({torch.backends.cudnn.conv.fp32_precision})")


def _nchw(images_u8: torch.Tensor, dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """What ``Predictor.infer`` feeds the network: normalized, NCHW."""
    return device_normalize_images(images_u8, dtype).permute(0, 3, 1, 2).contiguous()


# ---------------------------------------------------------------- phase 5


def seeded_state_dict(arch: str, num_classes: int, seed: int) -> dict:
    """Random weights made from a seed with numpy, in flax layout, through
    the converter: lecun-normal kernels, BN near identity, prior biases of
    the head's pred convs kept."""
    model = build_model(arch, num_classes=num_classes, device="cpu")
    variables = state_dict_to_variables(model.state_dict())
    rng = np.random.default_rng(seed)

    def fill(tree, path):
        for key, value in tree.items():
            if isinstance(value, dict):
                fill(value, path + [key])
                continue
            shape = value.shape
            if key == "kernel":
                fan_in = int(np.prod(shape[:3]))
                new = rng.standard_normal(shape) / np.sqrt(fan_in)
            elif key in ("scale", "var"):
                new = rng.uniform(0.8, 1.2, shape)
            elif key == "mean" or (key == "bias" and path[-1] != "pred"):
                new = rng.normal(0.0, 0.05, shape)
            else:
                new = value  # pred bias: detection prior
            tree[key] = np.asarray(new, np.float32)

    fill(variables, [])
    return variables_to_state_dict(variables)


def serve_model(arch: str, flush: torch.Tensor) -> dict:
    predictor = Predictor(
        arch,
        seeded_state_dict(arch, NC, seed=1),
        num_classes=NC,
        input_size=(IMG, IMG),
        conf_thresh=1e-5,
        batch_size=BATCH,
        dtype=torch.bfloat16,
        device="cuda",
    )
    rng = np.random.default_rng(2)
    batches = [
        rng.integers(0, 256, (BATCH, IMG, IMG, 3), dtype=np.uint8)
        for _ in range(SERVE_BATCHES)
    ]
    predictor.predict_batch(batches[0])  # warm-up (cuDNN plans, kernel load)

    # counted main-path run: every count at 0 just before, read just after
    select.launches = 0
    nms_fixed.sweeps = 0
    host_ms = []
    for imgs in batches:
        t0 = time.perf_counter()
        out = predictor.predict_batch(imgs)
        host_ms.append((time.perf_counter() - t0) * 1e3)
        check_outputs(out, arch)
    launches, sweeps = select.launches, nms_fixed.sweeps
    if launches != SERVE_BATCHES:
        raise AssertionError(f"{arch}: select launched {launches} times in "
                             f"{SERVE_BATCHES} batches, expected {SERVE_BATCHES}")

    # the kernel tail against the plain tail, on the same f32 maps
    x_u8 = torch.from_numpy(batches[0]).cuda()
    model = predictor.model
    with torch.inference_mode():
        raw = model(_nchw(x_u8, torch.bfloat16), split_head=True)
        maps = [(b.permute(0, 2, 3, 1), c.permute(0, 2, 3, 1)) for b, c in raw]
        maps32 = [(b.float(), c.float()) for b, c in maps]
        kw = dict(conf_thresh=1e-5, pre_nms_topk=1024, max_det=300)
        got = fused_postprocess(maps32, NC, **kw)
        want = fused_postprocess(maps32, NC, use_kernel=False, **kw)
        v = want["valid"]
        if not (torch.equal(got["valid"], v) and torch.equal(got["classes"][v], want["classes"][v])):
            raise AssertionError(f"{arch}: kernel tail and plain tail disagree on valid/classes")
        if not torch.allclose(got["scores"][v], want["scores"][v], rtol=1e-5, atol=0.0):
            raise AssertionError(f"{arch}: kernel tail scores differ")
        if not torch.allclose(got["boxes"][v], want["boxes"][v], rtol=0.0, atol=1e-3):
            raise AssertionError(f"{arch}: kernel tail boxes differ")
        tail_err = (got["boxes"][v] - want["boxes"][v]).abs().max().item()

        # where the batch time goes (device time, CUDA events)
        fwd_ms = cuda_ms(lambda: model(_nchw(x_u8, torch.bfloat16), split_head=True), 5)
        post_ms = cuda_ms(lambda: fused_postprocess(maps, NC, **kw), 5)
        infer_ms = cuda_ms(lambda: predictor.infer(x_u8), 5)

        # the select kernel, one launch per batch and each scale alone,
        # against its bound and the plain version
        name = torch.cuda.get_device_name(0)
        pairs = [(b.flatten(1, 2), c.flatten(1, 2)) for b, c in maps]
        err, routes, _ = compare_select(pairs, torch.bfloat16, f"{arch} serving maps")
        bytes_ms, ops_ms = select_bound(pairs, name)
        one = lambda: select_scales(pairs, REG_MAX)  # noqa: E731
        batch_sel = {
            "ms": cuda_ms(one, 20, flush, cover=True),
            "clean_ms": cuda_ms(one, 20, flush, clean=True, cover=True),
            "warm_ms": cuda_ms(one, 20, cover=True),
            "plain_ms": cuda_ms(lambda: select_scales_plain(pairs, REG_MAX), 20, flush, cover=True),
            "host_us": host_us(one),
            "bytes_ms": bytes_ms, "ops_ms": ops_ms, "err": err, "routes": routes,
        }
        scales = []
        for box, cls in pairs:
            bytes_ms, ops_ms = select_bound([(box, cls)], name)
            scales.append({
                "hw": box.shape[1],
                "ms": cuda_ms(lambda: select(box, cls, REG_MAX), 20, flush, cover=True),
                "plain_ms": cuda_ms(lambda: select_plain(box, cls, REG_MAX), 20, flush, cover=True),
                "bytes_ms": bytes_ms,
                "ops_ms": ops_ms,
            })
    h2d_ms = cuda_ms(lambda: torch.from_numpy(batches[0]).to("cuda"), 5)
    med = statistics.median(host_ms)
    return {
        "arch": arch, "launches": launches, "sweeps": sweeps, "host_ms": med,
        "img_s": BATCH / med * 1e3, "fwd_ms": fwd_ms, "post_ms": post_ms,
        "infer_ms": infer_ms, "h2d_ms": h2d_ms, "select": batch_sel, "scales": scales,
        "tail_err": tail_err,
    }


def check_outputs(out: dict, arch: str) -> None:
    shapes = {"boxes": (BATCH, 300, 4), "scores": (BATCH, 300),
              "classes": (BATCH, 300), "valid": (BATCH, 300)}
    for key, shape in shapes.items():
        if out[key].shape != shape:
            raise AssertionError(f"{arch}: {key} shape {out[key].shape} != {shape}")
    if not (np.isfinite(out["boxes"]).all() and np.isfinite(out["scores"]).all()):
        raise AssertionError(f"{arch}: non-finite outputs")
    if not out["valid"].any():
        raise AssertionError(f"{arch}: no detections at conf 1e-5")
    s = out["scores"][out["valid"]]
    c = out["classes"][out["valid"]]
    if not ((s > 0).all() and (s <= 1).all() and (c >= 0).all() and (c < NC).all()):
        raise AssertionError(f"{arch}: scores or classes out of range")


# ---------------------------------------------------------------- phase 6

# 6a: one f32 step of the golden yolov8-n on the card against the CPU's
STEP_LOSS_RTOL = 1e-4
STEP_STATE_TOL = dict(rtol=1e-3, atol=1e-5)
# 6b: the learning recipe of tests/test_learning.py
LEARN_EPOCHS = 60
LEARN_MAP_MIN = 0.5
LEARN_REFERENCE_MAP = 0.94  # the JAX package's result on this recipe (its test's docstring)
# 6c: the recipe of yolo_ms_tpu_torch/configs/coco_yolo_ms.yaml, read from its
# JSON copy beside it (the card machine has no PyYAML;
# tests/test_torch_config.py holds the copy equal to the YAML)
COCO_YOLO_MS = os.path.join(ROOT, "yolo_ms_tpu_torch", "configs", "coco_yolo_ms.json")
FULL_STEPS = 12  # training steps of 6c (one epoch)
FULL_VAL_IMAGES = 64
FULL_WARMUP = 3  # the recipe's 3000 warmup steps, cut to fit 12 steps
BF16_LOSS_RTOL = 0.05


def _test_module(name: str):
    """``tests/<name>.py``, loaded from this checkout by path (``tests`` is
    not a package, and another one may be installed)."""
    spec = importlib.util.spec_from_file_location(name, os.path.join(ROOT, "tests", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def make_coco_dataset(*args, **kwargs):
    """``tests/make_fixtures.make_coco_dataset``."""
    return _test_module("make_fixtures").make_coco_dataset(*args, **kwargs)


def _seeded_train_batch(b: int, img: int, nc: int, seed: int) -> dict:
    rng = np.random.default_rng(seed)
    c = rng.uniform(0.3, 0.7, (b, 6, 2))
    wh = rng.uniform(0.15, 0.6, (b, 6, 2))
    mask = np.zeros((b, 6), bool)
    mask[:, :4] = True
    return {
        "images": torch.from_numpy(rng.integers(0, 256, (b, img, img, 3), dtype=np.uint8)),
        "boxes": torch.from_numpy(np.concatenate([c, wh], -1).astype(np.float32)),
        "labels": torch.from_numpy(rng.integers(0, nc, (b, 6)).astype(np.int32)),
        "mask": torch.from_numpy(mask),
    }


def _one_train_step(device: str, state_dict: dict, batch: dict):
    """One f32 train step of yolov8-n (nc=3) from ``state_dict``, with
    SGD-nesterov, weight decay, clipping and EMA (its ramp at step 4000)."""
    model = build_model("n", num_classes=3, device="cpu")
    model.load_state_dict(state_dict, strict=True)
    cfg = TrainingConfig(batch_size=8, epochs=1, optimizer="sgd", learning_rate=0.01,
                         weight_decay=5e-4, grad_clip_norm=10.0, ema_decay=0.9999)
    tx, _ = build_optimizer(cfg, 4)
    state = TrainState.create(model.to(device), tx, ema=True)
    state.step.fill_(4000)
    step = make_train_step(DetectionLoss(num_classes=3), tx, cfg.ema_decay, torch.float32)
    metrics = step(state, {k: v.to(device) for k, v in batch.items()})
    return {k: float(v) for k, v in metrics.items()}, state


def phase_step_parity() -> dict:
    """6a: the golden yolov8-n weights, one f32 step (TF32 off) on the card
    and on the CPU, in this process: loss terms within STEP_LOSS_RTOL;
    params, BN statistics and EMA within STEP_STATE_TOL."""
    sd = load_npz(os.path.join(ROOT, "tests", "golden", "trained", "weights.npz"))
    batch = _seeded_train_batch(8, 160, 3, seed=5)
    card_m, card = _one_train_step("cuda", sd, batch)
    cpu_m, cpu = _one_train_step("cpu", sd, batch)
    if card_m["skipped_nonfinite"] or cpu_m["skipped_nonfinite"] or cpu_m["num_fg"] <= 0:
        raise AssertionError(f"6a: step skipped or without positives: {card_m} / {cpu_m}")
    worst_loss = 0.0
    for k in ("loss_box", "loss_cls", "loss_dfl", "total_loss"):
        rel = abs(card_m[k] - cpu_m[k]) / abs(cpu_m[k])
        worst_loss = max(worst_loss, rel)
        if not rel <= STEP_LOSS_RTOL:
            raise AssertionError(f"6a: {k} card {card_m[k]} vs CPU {cpu_m[k]}")
    worst = 0.0
    for name in ("params", "stats", "ema_params", "ema_stats"):
        got, want = getattr(card, name).cpu(), getattr(cpu, name)
        if not torch.allclose(got, want, **STEP_STATE_TOL):
            raise AssertionError(f"6a: {name} differ by {(got - want).abs().max().item()}")
        worst = max(worst, (got - want).abs().max().item())
    print(f"phase 6a train step yolov8-n golden 160px bs=8 f32 (TF32 off), SGD-nesterov + "
          f"decay + clip + EMA: card == CPU, loss terms max rel err {worst_loss:.2e} "
          f"(num_fg {int(card_m['num_fg'])}), params/stats/EMA max abs err {worst:.2e}")
    return {"loss_rel_err": worst_loss, "state_abs_err": worst}


@contextlib.contextmanager
def _quiet(log_path: str):
    """Send the trainer's per-step prints to a log file."""
    with open(log_path, "w") as f, contextlib.redirect_stdout(f):
        yield


def _learning_config(root: str, name: str, **training) -> Config:
    """The learning recipe of tests/test_learning.py over the 32 images under
    ``root``, with ``training`` overriding its training section."""
    images, ann = os.path.join(root, "images"), os.path.join(root, "annotations.json")
    return Config.from_dict({
        "dataset": {"train_images_path": images, "train_annotations_path": ann,
                    "val_images_path": images, "val_annotations_path": ann,
                    "num_classes": 3, "max_gt": 8},
        "model": {"architecture": "n", "input_size": [160, 160], "compute_dtype": "float32"},
        "training": {
            "batch_size": 16, "epochs": LEARN_EPOCHS, "learning_rate": 2e-3,
            "optimizer": "adam", "weight_decay": 0.0, "val_interval": LEARN_EPOCHS,
            "save_period": 1000, "experiment_name": name,
            "log_dir": os.path.join(root, "runs"), "augmentation": {"fliplr": 0.5},
            "grad_clip_norm": 10.0,
            "scheduler": {"type": "cosine", "cosine_t_max": LEARN_EPOCHS, "warmup_steps": 20},
            **training,
        },
        "evaluation": {"batch_size": 16, "confidence_threshold": 0.25},
        "workers": 4,
    })


def phase_learning(work: str) -> dict:
    """6b: the JAX package's learning recipe (tests/test_learning.py) through
    ``Trainer(Config.from_dict(...)).fit()`` on the card, then ``validate``."""
    root = os.path.join(work, "learn")
    make_coco_dataset(root, num_images=32, num_classes=3, img_w=320, img_h=256, seed=1)
    trainer = Trainer(_learning_config(root, "learn"), verbose=False)
    t0 = time.perf_counter()
    with _quiet(os.path.join(root, "fit.log")):
        trainer.fit()
    fit_s = time.perf_counter() - t0
    final = trainer.validate()
    if not final > LEARN_MAP_MIN:
        raise AssertionError(f"6b: mAP@0.5 {final:.4f} <= {LEARN_MAP_MIN} on the learning recipe")
    steps = int(trainer.state.step)
    print(f"phase 6b learning recipe yolov8-n 160px nc=3 f32, 32 images, bs 16, "
          f"{LEARN_EPOCHS} epochs ({steps} steps), Adam 2e-3, cosine + warmup 20: "
          f"mAP@0.5 {final:.4f} (> {LEARN_MAP_MIN}; the JAX package reached "
          f"{LEARN_REFERENCE_MAP} on this recipe, an accuracy, not a speed); fit {fit_s:.1f} s")
    return {"map50": final, "steps": steps, "fit_s": fit_s}


def _full_config(root: str, images: str, ann: str, val_images: str, val_ann: str,
                 name: str) -> Config:
    d = load_config(COCO_YOLO_MS).to_dict()
    d["dataset"].update(train_images_path=images, train_annotations_path=ann,
                        val_images_path=val_images, val_annotations_path=val_ann)
    d["training"].update(batch_size=BATCH, epochs=1, val_interval=1, experiment_name=name,
                         log_dir=os.path.join(root, "runs"))
    d["training"]["scheduler"]["warmup_steps"] = FULL_WARMUP
    return Config.from_dict(d)


def phase_full_width(work: str) -> dict:
    """6c: yolo-ms-xs at full width and depth, nc=80, 640x640, bf16 autocast,
    batch 32, coco_yolo_ms.yaml settings, one epoch of FULL_STEPS steps on
    synthetic 640x480 COCO images, validation over 64 images, a checkpoint
    written and resumed. The counted run of the training path: every count
    at 0 just before ``fit``, read just after."""
    root = os.path.join(work, "full")
    images, ann = make_coco_dataset(os.path.join(root, "train"), num_images=FULL_STEPS * BATCH,
                                    num_classes=NC, img_w=640, img_h=480, max_objects=12,
                                    seed=2)
    val_images, val_ann = make_coco_dataset(os.path.join(root, "val"),
                                            num_images=FULL_VAL_IMAGES, num_classes=NC,
                                            img_w=640, img_h=480, max_objects=12, seed=3)
    cfg = _full_config(root, images, ann, val_images, val_ann, "full")
    trainer = Trainer(cfg, verbose=False)
    if len(trainer.train_loader) != FULL_STEPS:
        raise AssertionError(f"6c: {len(trainer.train_loader)} steps per epoch")
    val_batches = len(trainer.val_loader)

    # the first batch's loss in f32 on the card, on a copy of the model (a
    # train-mode forward moves the BN statistics)
    batches = trainer.train_loader.epoch(0)
    first_batch = trainer._to_device(trainer._bucket_gt(next(batches)))
    batches.close()
    probe = copy.deepcopy(trainer.state.model)
    x = device_normalize_images(first_batch["images"], torch.float32).permute(0, 3, 1, 2)
    with torch.no_grad(), full_f32():
        f32_loss, _ = trainer.loss_fn(probe(x.contiguous()), first_batch["boxes"],
                                      first_batch["labels"], first_batch["mask"])
    f32_loss = float(f32_loss)
    del probe, x

    inner = trainer._train_step
    events, metrics, host_starts = [], [], []

    def timed_step(state, batch):
        host_starts.append(time.perf_counter())
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        m = inner(state, batch)
        end.record()
        events.append((start, end))
        metrics.append(m)
        return m

    trainer._train_step = timed_step
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    # counted run of the training path
    select.launches = 0
    nms_fixed.sweeps = 0
    t0 = time.perf_counter()
    with _quiet(os.path.join(root, "fit.log")):
        trainer.fit()
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    launches = select.launches
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    if launches != val_batches:
        raise AssertionError(f"6c: select launched {launches} times in a fit whose "
                             f"validation ran {val_batches} batches")

    host = [{k: float(v) for k, v in m.items()} for m in metrics]
    if len(host) != FULL_STEPS:
        raise AssertionError(f"6c: {len(host)} steps run, expected {FULL_STEPS}")
    for i, m in enumerate(host):
        if not all(math.isfinite(v) for v in m.values()):
            raise AssertionError(f"6c: step {i + 1} not finite: {m}")
        if m["skipped_nonfinite"] != 0.0 or m["num_fg"] <= 0:
            raise AssertionError(f"6c: step {i + 1} skipped or without positives: {m}")
    bf16_rel = abs(host[0]["total_loss"] - f32_loss) / abs(f32_loss)
    if not bf16_rel <= BF16_LOSS_RTOL:
        raise AssertionError(f"6c: first step bf16 loss {host[0]['total_loss']} vs f32 "
                             f"{f32_loss} (rel {bf16_rel:.3f})")
    step_ms = [s.elapsed_time(e) for s, e in events]
    med_ms = statistics.median(step_ms[2:])
    waits = trainer.data_wait_s
    wait_ms = statistics.median(waits[2:]) * 1e3
    # end to end: every training image over the whole fit's wall time
    fit_img_s = FULL_STEPS * BATCH / fit_s
    # a host statistic of the step loop: from one step's start to the next's
    period_ms = statistics.median(b - a for a, b in zip(host_starts[2:], host_starts[3:])) * 1e3

    # validate alone: timed, and one select launch per val batch
    before = select.launches
    t0 = time.perf_counter()
    val_map = trainer.validate()
    torch.cuda.synchronize()
    val_ms = (time.perf_counter() - t0) * 1e3
    if select.launches - before != val_batches:
        raise AssertionError(f"6c: validate launched select {select.launches - before} times "
                             f"for {val_batches} batches")

    # the checkpoint written by fit, read back by resume
    ckpt = os.path.join(trainer.ckpt.dir, "last.ckpt")
    resumed = Trainer(_full_config(root, images, ann, val_images, val_ann, "resumed"),
                      verbose=False)
    resumed.resume(ckpt)
    if not (resumed.start_epoch == 1 and int(resumed.state.step) == FULL_STEPS
            and torch.equal(resumed.state.params, trainer.state.params)
            and torch.equal(resumed.state.ema_stats, trainer.state.ema_stats)
            and all(torch.equal(resumed.state.opt_state[k], v)
                    for k, v in trainer.state.opt_state.items())):
        raise AssertionError("6c: resumed state differs from the trained one")
    ckpt_mb = os.path.getsize(ckpt) / 1e6
    alone = step_breakdown(resumed, first_batch)
    print(f"phase 6c train yolo-ms-xs nc={NC} {IMG}px bf16 bs={BATCH}, coco_yolo_ms.yaml "
          f"recipe (warmup cut to {FULL_WARMUP}), {FULL_STEPS} steps: all finite, none "
          f"skipped, num_fg {min(m['num_fg'] for m in host):.0f}-"
          f"{max(m['num_fg'] for m in host):.0f}; losses {host[0]['total_loss']:.4f} -> "
          f"{host[-1]['total_loss']:.4f}; first step bf16 {host[0]['total_loss']:.4f} vs f32 "
          f"{f32_loss:.4f} (rel {bf16_rel:.4f}); {med_ms:.3f} ms/step (CUDA events, median of "
          f"steps 3-{FULL_STEPS}; all {', '.join(f'{t:.1f}' for t in step_ms)}), "
          f"{BATCH / med_ms * 1e3:.1f} img/s; host wait for the loader {wait_ms:.1f} ms/step "
          f"(median); host-clock gap from one step's start to the next {period_ms:.1f} ms "
          f"(median of steps 3-{FULL_STEPS}); end to end {fit_img_s:.1f} img/s: "
          f"{FULL_STEPS * BATCH} images over the whole fit's {fit_s:.2f} s (loader start, "
          f"first step, validation and checkpoint writes included); peak memory "
          f"{peak_gib:.2f} GiB; validate "
          f"{FULL_VAL_IMAGES} images {val_ms:.1f} ms, mAP@0.5 {val_map:.4f}, select "
          f"launches {launches} in fit for {val_batches} val batches; checkpoint "
          f"{ckpt_mb:.1f} MB written and resumed")
    parts = ", ".join(f"{k} {v:.2f} ms" for k, v in alone["ranges"].items() if v > 0)
    busy = alone["busy_ms"]
    print(f"phase 6c step alone (the first batch resident on the card, no loader; "
          f"{alone['steps']} steps after 2 warm-up): {alone['event_ms']:.3f} ms/step (CUDA "
          f"events, median), host {alone['host_ms']:.3f} ms to enqueue one step (median); "
          f"torch.profiler over {alone['profiled']} steps: kernel time "
          + (f"{busy:.3f} ms/step in {alone['device_ops']:.0f} device operations "
             f"({alone['host_ms'] / max(alone['device_ops'], 1) * 1e3:.1f} us of host "
             f"enqueue each), {busy / alone['wall_ms'] * 100:.1f} % of the "
             f"{alone['wall_ms']:.3f} ms/step wall (idle {100 - busy / alone['wall_ms'] * 100:.1f}"
             f" %); in the fit's {med_ms:.3f} ms/step the card was busy "
             f"{busy / med_ms * 100:.1f} %" if busy else "not measured")
          + f"; device time by range: {parts or 'not measured'}")
    return {"launches": launches, "step_ms": med_ms, "img_s": BATCH / med_ms * 1e3,
            "wait_ms": wait_ms, "period_ms": period_ms, "fit_s": fit_s,
            "fit_img_s": fit_img_s, "peak_gib": peak_gib, "val_ms": val_ms,
            "alone": alone, "ckpt": ckpt,
            "data": (root, images, ann, val_images, val_ann)}


def step_breakdown(trainer: Trainer, batch: dict, steps: int = 10, profiled: int = 3) -> dict:
    """Steady-state train steps on one batch resident on the card, without
    the loader: the CUDA-event interval and the host's enqueue time per step
    (medians), then ``torch.profiler`` over ``profiled`` steps: the kernel
    time per step (the card's busy time), the number of device operations
    (kernels, copies, memsets) per step, the wall time per step, and the
    device time of the step's ranges (``train_step/forward`` ...; the
    backward's is that of the autograd engine's nodes). Where the
    profiler records no device time, those read 0 and are printed as not
    measured."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    step = trainer._train_step
    for _ in range(2):
        step(trainer.state, batch)
    torch.cuda.synchronize()
    pairs, host = [], []
    for _ in range(steps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        t0 = time.perf_counter()
        step(trainer.state, batch)
        host.append((time.perf_counter() - t0) * 1e3)
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(profiled):
            step(trainer.state, batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / profiled
    busy_us, ranges = 0.0, {}
    backward_us, device_ops = 0.0, 0
    for ev in prof.key_averages():
        if ev.key.startswith("train_step/"):
            ranges[ev.key[len("train_step/"):]] = ev.device_time_total / 1e3 / profiled
        elif ev.key.startswith("autograd::engine::evaluate_function"):
            # the backward runs on the autograd engine's thread, outside the
            # main thread's ``train_step/backward`` range: count its nodes
            backward_us += ev.device_time_total
        elif ev.device_type == DeviceType.CUDA:
            busy_us += ev.self_device_time_total
            device_ops += ev.count
    ranges["backward"] = backward_us / 1e3 / profiled
    return {
        "steps": steps, "profiled": profiled,
        "event_ms": statistics.median(s.elapsed_time(e) for s, e in pairs),
        "host_ms": statistics.median(host), "wall_ms": wall_ms,
        "busy_ms": busy_us / 1e3 / profiled, "ranges": ranges,
        "device_ops": device_ops / profiled,
    }


# ---------------------------------------------------------------- phase 7

DEVICE = "cuda"  # where phase 7's entry points run

# 7b: the folded f32 export's raw maps against the unfolded EMA model's (f32,
# TF32 off): the fold changes the summation order only
EXPORT_MAPS_ATOL = 1e-3
# 7c: a frame served in a batch of 32 against the same frame alone (f32, TF32
# off): the same detections up to the summation order of another batch size
VIDEO_IOU_MIN, VIDEO_SCORE_TOL = 0.99, 1e-3
# 7d: the resumed run against the uninterrupted one (f32, TF32 off, SGD,
# deterministic algorithms: without them two uninterrupted runs part by more
# than this within four steps)
PREEMPT_TOL = dict(rtol=1e-3, atol=1e-5)
PREEMPT_EPOCHS = 2  # the learning recipe cut to 2 epochs of 2 steps
PREEMPT_SNIPE = 2  # SIGTERM while the third step (epoch 1, step 0) is in flight


def phase_tools_test(work: str) -> int:
    """7a: ``tools.test.run`` on the golden yolov8-n, from its weights.npz
    and from a reference-format .pt made from the same weights in this
    process (``reference_state_dict`` of tests/test_torch_tools.py): both
    reproduce the golden detections, with one ``select`` launch per batch."""
    gdir = GOLDENS[0][1]
    npz = os.path.join(gdir, "weights.npz")
    fixture = os.path.join(gdir, "fixture_000.png")
    pt = os.path.join(work, "yolov8n.pt")
    torch.save({"model": _test_module("test_torch_tools").reference_state_dict(npz)}, pt)
    cfg_path = os.path.join(work, "golden_n.json")
    Config.from_dict({"dataset": {"num_classes": 3}, "device": DEVICE,
                      "model": {"architecture": "n", "input_size": [160, 160]}}).save(cfg_path)
    with open(os.path.join(gdir, "fixture_000_detections.json")) as f:
        golden = json.load(f)
    total, parts = 0, []
    for kind, ckpt in (("weights.npz", npz), ("reference .pt", pt)):
        out_dir = os.path.join(work, "detect_" + kind.split()[-1])
        select.launches = 0
        with _quiet(out_dir + ".log"):
            results = tools_test.run(cfg_path, ckpt, fixture, out_dir)
        launches = select.launches
        if launches != 1:
            raise AssertionError(f"7a {kind}: select launched {launches} times for 1 batch")
        match_golden(results[fixture], golden)
        if not os.path.getsize(os.path.join(out_dir, "fixture_000_detected.jpg")):
            raise AssertionError(f"7a {kind}: no drawn fixture")
        total += launches
        parts.append(f"from {kind} {len(results[fixture])} detections match, "
                     f"{launches} select launch")
    print("phase 7a tools.test golden yolov8-n 160px on the card: " + "; ".join(parts))
    return total


def phase_export_val(work: str, full: dict) -> dict:
    """7b: ``tools.export`` of 6c's last.ckpt (its EMA model) to a folded f32
    and a folded bf16 file; the f32 export's raw maps against the unfolded
    EMA model's on one batch of val images (TF32 off, EXPORT_MAPS_ATOL); then
    ``tools.val`` on each export over 6c's 64 val images at 640², batch 32,
    each a counted run: ``select.launches`` from 0 must reach the number of
    val batches."""
    _, _, _, val_images, val_ann = full["data"]
    exports = {}
    for name, bf16 in (("f32", False), ("bf16", True)):
        t0 = time.perf_counter()
        with _quiet(os.path.join(work, f"export_{name}.log")):
            info = tools_export.run(full["ckpt"], os.path.join(work, f"export_{name}.ckpt"),
                                    bf16=bf16)
        info["seconds"] = time.perf_counter() - t0
        info["file_mb"] = os.path.getsize(info["output"]) / 1e6
        exports[name] = info

    paths = sorted(glob.glob(os.path.join(val_images, "*.jpg")))
    u8 = torch.from_numpy(np.stack([decode_and_resize(p, IMG, IMG) for p in paths[:BATCH]]))
    unfolded = build_model("yolo-ms-xs", num_classes=NC, device=DEVICE)
    unfolded.load_state_dict(restore_checkpoint(full["ckpt"])["state"]["ema"], strict=True)
    folded = build_model("yolo-ms-xs", num_classes=NC, device=DEVICE, deploy=True)
    folded.load_state_dict(restore_checkpoint(exports["f32"]["output"]), strict=True)
    with torch.inference_mode(), full_f32():
        x = _nchw(u8.to(DEVICE))
        maps_err = max((a - b).abs().max().item() for a, b in zip(folded(x), unfolded(x)))
    del unfolded, folded, x
    if not maps_err <= EXPORT_MAPS_ATOL:
        raise AssertionError(f"7b: folded f32 export's raw maps differ from the EMA model's "
                             f"by {maps_err}")

    cfg = load_config(COCO_YOLO_MS).to_dict()
    cfg["dataset"].update(val_images_path=val_images, val_annotations_path=val_ann)
    cfg["evaluation"].update(batch_size=BATCH, img_size=[IMG, IMG])
    cfg["device"] = DEVICE
    cfg_path = os.path.join(work, "val.json")
    Config.from_dict(cfg).save(cfg_path)
    val_batches = math.ceil(len(paths) / BATCH)
    launches, parts = 0, []
    for name in ("f32", "bf16"):
        info = exports[name]
        select.launches = 0
        t0 = time.perf_counter()
        result = tools_val.run(cfg_path, info["output"], verbose=False)
        val_s = time.perf_counter() - t0
        n = select.launches
        if n != val_batches:
            raise AssertionError(f"7b {name}: select launched {n} times for {val_batches} "
                                 f"val batches")
        if result["images"] != len(paths):
            raise AssertionError(f"7b {name}: {result['images']} images validated")
        launches += n
        parts.append(
            f"{name}: {info['params']:,} params, {info['bytes'] / 1e6:.2f} MB of tensors "
            f"({info['file_mb']:.2f} MB file), exported in {info['seconds']:.2f} s; val "
            f"{statistics.median(result['batch_ms']):.1f} ms/batch predict_batch (host clock, "
            f"median of {len(result['batch_ms'])}; all {', '.join(f'{t:.1f}' for t in result['batch_ms'])}),"
            f" {val_s:.2f} s in all, {result['detections']} detections, mAP@0.5 "
            f"{result['map_50']:.4f}, select launches {n}")
    print(f"phase 7b tools.export + tools.val yolo-ms-xs nc={NC} {IMG}px bs={BATCH} from 6c's "
          f"last.ckpt (EMA), {len(paths)} val images, f32 serving (TF32 off): folded f32 export "
          f"vs unfolded EMA raw maps max abs err {maps_err:.3e}; " + "; ".join(parts))
    return {"launches": launches, "bf16": exports["bf16"]["output"]}


def phase_video(work: str, full: dict, export_path: str) -> int:
    """7c: 6c's 64 val images (640x480) as an MJPG .avi through
    ``predict_video`` at 640², batch 32, from the bf16 export (served in f32,
    TF32 off, conf 1e-5), a counted run: one ``select`` launch per batch.
    Every frame's detections match ``predict_image`` on the frame as
    decoded (VIDEO_IOU_MIN, VIDEO_SCORE_TOL) and the written video has
    every frame."""
    import cv2

    _, _, _, val_images, _ = full["data"]
    paths = sorted(glob.glob(os.path.join(val_images, "*.jpg")))
    first = cv2.imread(paths[0])
    src = os.path.join(work, "val.avi")
    writer = cv2.VideoWriter(src, cv2.VideoWriter_fourcc(*"MJPG"), 30.0,
                             (first.shape[1], first.shape[0]))
    if not writer.isOpened():
        raise AssertionError("7c: cv2 cannot write MJPG")
    for p in paths:
        writer.write(cv2.imread(p))
    writer.release()

    predictor = Predictor("yolo-ms-xs", load_serving_state_dict(export_path), num_classes=NC,
                          input_size=(IMG, IMG), conf_thresh=1e-5, batch_size=BATCH,
                          device=DEVICE)
    predictor.predict_batch(np.zeros((BATCH, IMG, IMG, 3), np.uint8))  # warm-up
    out = os.path.join(work, "detected.mp4")
    select.launches = 0
    t0 = time.perf_counter()
    with _quiet(os.path.join(work, "video.log")):
        dets = predict_video(predictor, src, out)
    video_s = time.perf_counter() - t0
    launches = select.launches
    if launches != math.ceil(len(paths) / BATCH):
        raise AssertionError(f"7c: select launched {launches} times for {len(paths)} frames "
                             f"in batches of {BATCH}")

    def frames_of(path):
        cap = cv2.VideoCapture(path)
        frames = []
        while True:
            ok, bgr = cap.read()
            if not ok:
                break
            frames.append(cv2.cvtColor(bgr, cv2.COLOR_BGR2RGB))
        cap.release()
        return frames

    frames = frames_of(src)
    if not len(dets) == len(frames) == len(paths):
        raise AssertionError(f"7c: {len(dets)} frames served, {len(frames)} decoded, "
                             f"{len(paths)} written")
    exact = n_dets = 0
    for got, rgb in zip(dets, frames):
        want = predictor.predict_image(rgb)
        n_dets += len(want)
        if got == want:
            exact += 1
        else:
            match_golden(got, want, VIDEO_IOU_MIN, VIDEO_SCORE_TOL)
    if n_dets == 0:
        raise AssertionError("7c: no detections to compare")
    written = len(frames_of(out))
    if written != len(paths):
        raise AssertionError(f"7c: the written video has {written} frames")
    print(f"phase 7c predict_video yolo-ms-xs bf16 export (f32 serving, TF32 off) {IMG}px "
          f"bs={BATCH} conf 1e-5, {len(paths)} MJPG frames 640x480: {len(paths) / video_s:.1f} "
          f"frames/s (host clock, {video_s:.2f} s: decode, resize, serve, draw and encode); "
          f"select launches {launches}; {n_dets} detections, every frame matches predict_image "
          f"on the decoded frame ({exact} of {len(frames)} exactly equal); written video "
          f"{written} frames")
    return launches


def preempt_child(root: str, exp: str, snipe: str, ckpt: str | None = None) -> int:
    """One run of the 7d drill (``chip_smoke.py --preempt-child ...``): the
    learning recipe cut to PREEMPT_EPOCHS epochs, SGD, f32 with TF32 off and
    PyTorch's deterministic algorithms (warning where an op has none), on
    the card; with ``snipe`` >= 0 it sends itself SIGTERM while that step is
    in flight; with ``ckpt`` it resumes from it. A run that ends writes its
    final state beside the data."""
    torch.use_deterministic_algorithms(True, warn_only=True)
    cfg = _learning_config(root, exp, epochs=PREEMPT_EPOCHS, optimizer="sgd",
                           learning_rate=0.01, weight_decay=5e-4, ema_decay=0.9999,
                           val_interval=1000,
                           scheduler={"type": "cosine", "cosine_t_max": PREEMPT_EPOCHS})
    trainer = Trainer(cfg, verbose=False, device=DEVICE)
    if ckpt:
        trainer.resume(ckpt)
    steps = [trainer.start_epoch * len(trainer.train_loader) + trainer.start_step]
    inner = trainer._train_step

    def step(state, batch):
        metrics = inner(state, batch)
        if steps[0] == int(snipe):
            print(f"SIGNAL_AT {time.time():.6f}", file=sys.stderr, flush=True)
            os.kill(os.getpid(), signal.SIGTERM)
            if not (trainer._preempt_signum == signal.SIGTERM and trainer._step_active):
                raise AssertionError("7d: the signal was not deferred")
        steps[0] += 1
        return metrics

    trainer._train_step = step
    with _quiet(os.path.join(root, exp + ".log")):
        trainer.fit()
    torch.save(trainer.state.state_dict(), os.path.join(root, exp + "_final.pt"))
    return 0


def phase_preempt(work: str) -> None:
    """7d: child processes on the card: U and U2 uninterrupted, P with
    SIGTERM inside step PREEMPT_SNIPE's in-flight window (the three side by
    side), then R resumed from P's preempt.ckpt. P exits 143 with the
    committed step as its cursor; R's final params, statistics and EMA
    equal U's within PREEMPT_TOL. U2 against U shows how far two runs of
    the same recipe part on the card."""
    root = os.path.join(work, "learn")
    env = dict(os.environ, CUBLAS_WORKSPACE_CONFIG=":4096:8")  # deterministic cuBLAS

    def start(exp, snipe=-1, *extra):
        log = open(os.path.join(root, exp + ".out"), "w")
        proc = subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--preempt-child", root, exp,
             str(snipe), *extra], cwd=ROOT, env=env, stdout=log, stderr=subprocess.STDOUT)
        log.close()
        return proc

    def wait(procs, timeout=300):
        """Exit code and host-clock exit time of each process."""
        ended, deadline = {}, time.time() + timeout
        try:
            while len(ended) < len(procs):
                if time.time() > deadline:
                    raise AssertionError("7d: a child process did not end")
                for name, p in procs.items():
                    if name not in ended and p.poll() is not None:
                        ended[name] = (p.returncode, time.time())
                time.sleep(0.01)
        finally:
            for p in procs.values():
                if p.poll() is None:
                    p.kill()
                    p.wait()
        return ended

    def output(exp):
        with open(os.path.join(root, exp + ".out")) as f:
            return f.read()

    t0 = time.perf_counter()
    ended = wait({"u": start("pre_u"), "u2": start("pre_u2"), "p": start("pre_p", PREEMPT_SNIPE)})
    term = 128 + signal.SIGTERM
    if ended["u"][0] != 0 or ended["u2"][0] != 0 or ended["p"][0] != term:
        raise AssertionError(f"7d: exit codes U {ended['u'][0]}, U2 {ended['u2'][0]}, P "
                             f"{ended['p'][0]} (want 0, 0, {term})\n{output('pre_u')[-3000:]}\n"
                             f"{output('pre_p')[-3000:]}")
    signal_at = next(float(ln.split()[1]) for ln in output("pre_p").splitlines()
                     if ln.startswith("SIGNAL_AT"))
    exit_s = ended["p"][1] - signal_at
    ckpt = os.path.join(root, "runs", "pre_p", "weights", "preempt.ckpt")
    restored = restore_checkpoint(ckpt)
    cursor = (restored["epoch"], restored["step_in_epoch"], restored["state"]["step"])
    if cursor != (1, 1, PREEMPT_SNIPE + 1):
        raise AssertionError(f"7d: preempt.ckpt cursor (epoch, step in epoch, steps) {cursor}")
    ended = wait({"r": start("pre_r", -1, ckpt)})
    if ended["r"][0] != 0:
        raise AssertionError(f"7d: resumed run exit {ended['r'][0]}\n{output('pre_r')[-3000:]}")
    drill_s = time.perf_counter() - t0
    final = {e: torch.load(os.path.join(root, f"pre_{e}_final.pt"), weights_only=True)
             for e in ("u", "u2", "r")}
    want = final["u"]

    def compare(got, check):
        if got["step"] != want["step"]:
            raise AssertionError(f"7d: {got['step']} steps vs {want['step']}")
        worst = 0.0
        for part in ("model", "ema"):
            for k, v in want[part].items():
                if not v.is_floating_point():
                    continue
                err = (got[part][k] - v).abs().max().item()
                if check and not torch.allclose(got[part][k], v, **PREEMPT_TOL):
                    raise AssertionError(f"7d: resumed {part} {k} differs by {err}")
                worst = max(worst, err)
        return worst

    repeat = compare(final["u2"], check=False)
    worst = compare(final["r"], check=True)
    nondet = sorted({ln.split(" does not have a deterministic")[0].split()[-1]
                     for e in ("pre_u", "pre_u2", "pre_p", "pre_r") for ln in output(e).splitlines()
                     if "does not have a deterministic implementation" in ln})
    print(f"phase 7d preemption drill, learning recipe cut to {PREEMPT_EPOCHS} epochs x 2 steps, "
          f"SGD f32 (TF32 off, deterministic algorithms), 4 child processes on the card: "
          f"SIGTERM inside step {PREEMPT_SNIPE + 1}'s in-flight window -> exit {term}, "
          f"preempt.ckpt at epoch 1 step 1 ({PREEMPT_SNIPE + 1} steps committed), {exit_s:.3f} s "
          f"from signal to exit (host clock); resumed final params/statistics/EMA == "
          f"uninterrupted, max abs err {worst:.3e} (two uninterrupted runs: {repeat:.3e}); ops "
          f"without a deterministic implementation: {', '.join(nondet) or 'none'}; drill "
          f"{drill_s:.1f} s")


def phase_analyze(work: str) -> None:
    """7e: ``tools.analyze`` of yolo-ms-xs at 640² on the card."""
    with _quiet(os.path.join(work, "analyze.log")):
        info = analyze("yolo-ms-xs", num_classes=NC, img_size=IMG, device=DEVICE)
    stages = ", ".join(f"{k} {v:,}" for k, v in info["stage_params"].items())
    print(f"phase 7e analyze yolo-ms-xs nc={NC} {IMG}px on the card: {info['params']:,} params "
          f"({stages}), {info['flops'] / 1e9:.2f} GFLOPs/image (FlopCounterMode: 2 x MACs of "
          f"convs and matmuls only), {info['anchors']:,} anchors, staged == full")


def _load_select_of(checkout: str):
    """The select module of another checkout; it builds that checkout's
    ``csrc/select.cu`` into that checkout's ``build/``."""
    path = os.path.join(checkout, "yolo_ms_tpu_torch", "ops", "kernels", "select.py")
    spec = importlib.util.spec_from_file_location("parent_select", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def phase_parent_ab(parent: str, flush: torch.Tensor, name: str) -> None:
    """The parent checkout's select kernel against this one at the serving
    shapes, on the same inputs, timed in turns (parent, this, this, parent;
    CUDA events, L2 flushed, median of 20 each). The parent is called once
    per scale, as its ``select`` takes one scale."""
    old = _load_select_of(parent)
    info = old.build()
    print(f"ab parent build: {info['seconds']:.2f} s")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(3)
    sides = dict(SCALE_SETS)["serving"]
    for dtype in (torch.bfloat16, torch.float32):
        for layout in LAYOUTS:
            pairs = [_layout_views(gen, BATCH, s, s, NC, dtype, layout) for s in sides]
            want = select_scales(pairs, REG_MAX)
            got = [torch.cat(p, dim=1) for p in zip(*(old.select(b, c, REG_MAX) for b, c in pairs))]
            if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
                raise AssertionError(f"ab {dtype} {layout}: parent and this disagree on mx/cid")
            ltrb_err = (got[2] - want[2]).abs().max().item()
            fns = {
                "parent": lambda: [old.select(b, c, REG_MAX) for b, c in pairs],
                "parent+cat": lambda: [torch.cat(p, dim=1) for p in zip(
                    *(old.select(b, c, REG_MAX) for b, c in pairs))],
                "this": lambda: select_scales(pairs, REG_MAX),
            }
            times = {k: [] for k in fns}
            for who in ("parent", "this", "this", "parent"):
                for key in fns:
                    if key.startswith(who):
                        times[key].append(cuda_ms(fns[key], 20, flush, cover=True))
            bound = bound_of(*select_bound(pairs, name))[0]
            print(f"ab select {str(dtype)[6:]} {layout} B={BATCH} HW=6400/1600/400 "
                  f"(bound {bound * 1e3:.1f} us, ltrb diff {ltrb_err:.1e}): " + "; ".join(
                      f"{k} " + "/".join(f"{t * 1e3:.1f}" for t in v) + " us"
                      for k, v in times.items()))
            if dtype == torch.bfloat16 and layout == "nchw":
                for box, cls in pairs:
                    per = {"parent": [], "this": []}
                    for who in ("parent", "this", "this", "parent"):
                        fn = old.select if who == "parent" else select
                        per[who].append(cuda_ms(lambda: fn(box, cls, REG_MAX), 20, flush,
                                                cover=True))
                    print(f"ab select bf16 nchw HW={box.shape[1]} alone: " + "; ".join(
                        f"{k} " + "/".join(f"{t * 1e3:.1f}" for t in v) + " us"
                        for k, v in per.items()))


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--parent", help="another checkout whose select kernel to time against")
    parser.add_argument("--preempt-child", nargs="+", help=argparse.SUPPRESS)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if args.preempt_child:
        return preempt_child(*args.preempt_child)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    name = torch.cuda.get_device_name(0)
    print(f"phase 1 device: {name} ({smi}); torch {torch.__version__}, CUDA {torch.version.cuda}")

    info = select_mod.build()
    regs = [ln.strip() for ln in info["log"].splitlines() if "registers" in ln]
    plans = "; ".join(
        "{} nc={}: {tile} anchors per tile, {stages} stages, {smem_bytes} B shared per CTA, "
        "{ctas_per_sm} CTAs per SM on {sms} SMs".format(str(dt)[6:], nc, **select_mod.plan(dt, nc))
        for dt in (torch.bfloat16, torch.float32) for nc in (NC, 3)
    )
    print(f"phase 2 build select.cu: {info['seconds']:.2f} s; {'; '.join(regs)}; plan: {plans}")

    flush = torch.empty(256 * 1024 * 1024, dtype=torch.uint8, device="cuda")
    if args.parent:
        phase_parent_ab(args.parent, flush, name)
        print(smi)
        return 0

    worst = phase_kernel_vs_plain(flush, name)
    phase_cuda_tests()
    phase_goldens()

    runs = [serve_model(arch, flush) for arch in SERVE_ARCHS]
    for r in runs:
        sel = r["select"]
        bound_ms, bound_by = bound_of(sel["bytes_ms"], sel["ops_ms"])
        per_scale = ", ".join(
            "HW {}: {:.1f} us (bound {:.1f} us by {}, plain {:.1f} us)".format(
                s["hw"], s["ms"] * 1e3, bound_of(s["bytes_ms"], s["ops_ms"])[0] * 1e3,
                bound_of(s["bytes_ms"], s["ops_ms"])[1], s["plain_ms"] * 1e3)
            for s in r["scales"]
        )
        print(
            f"phase 5 serve {r['arch']} bs={BATCH} {IMG}px bf16: {r['host_ms']:.3f} ms/batch "
            f"predict_batch (host clock, median of {SERVE_BATCHES}), {r['img_s']:.1f} img/s; "
            f"device: uint8 H2D {r['h2d_ms']:.3f} ms, infer {r['infer_ms']:.3f} ms = "
            f"normalize+forward {r['fwd_ms']:.3f} ms + post-process {r['post_ms']:.3f} ms; "
            f"select launches {r['launches']} in {SERVE_BATCHES} batches; "
            f"NMS sweeps {r['sweeps']} ({r['sweeps'] / SERVE_BATCHES:.1f}/batch); "
            f"kernel-vs-plain tail box err {r['tail_err']:.3e}"
        )
        print(
            f"phase 5 select {r['arch']}: one launch per batch {sel['ms'] * 1e3:.1f} us with L2 "
            f"flushed by a write, {sel['clean_ms'] * 1e3:.1f} us flushed by a read, "
            f"{sel['warm_ms'] * 1e3:.1f} us unflushed (bound {bound_ms * 1e3:.1f} us by "
            f"{bound_by}, {bound_ms / sel['ms'] * 100:.0f} / {bound_ms / sel['clean_ms'] * 100:.0f}"
            f" / {bound_ms / sel['warm_ms'] * 100:.0f} % of it; plain "
            f"{sel['plain_ms'] * 1e3:.1f} us; host {sel['host_us']:.1f} us to enqueue one call; "
            f"routes {_route_names(sel['routes'])}); each scale alone: {per_scale}"
        )

    with tempfile.TemporaryDirectory(prefix="chip_smoke_train_") as work:
        phase_step_parity()
        phase_learning(work)
        full = phase_full_width(work)
        tools = {"tools_test": phase_tools_test(work)}
        export_val = phase_export_val(work, full)
        tools["tools_val"] = export_val["launches"]
        tools["video"] = phase_video(work, full, export_val["bf16"])
        phase_preempt(work)
        phase_analyze(work)

    # one batch of the flagship, one launch
    sel = runs[0]["select"]
    bound_ms, bound_by = bound_of(sel["bytes_ms"], sel["ops_ms"])
    worst = max([worst] + [r["select"]["err"] for r in runs])
    serve_launches = sum(r["launches"] for r in runs)
    kernels = [{
        "name": "select",
        "route": "cuda",
        "source": "yolo_ms_tpu_torch/csrc/select.cu",
        "replaces": "yolo_ms_tpu/ops/pallas/select.py:56",
        "launches": serve_launches + full["launches"] + sum(tools.values()),
        "launches_by_path": {"serve": serve_launches, "train_validate": full["launches"],
                             **tools},
        "max_abs_err": worst,
        "ms": sel["ms"],
        "plain_ms": sel["plain_ms"],
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,
    }]
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
