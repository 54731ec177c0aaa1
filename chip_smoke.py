"""Drive the PyTorch/CUDA port's serving path on one card, end to end.

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
   names).

The last three lines are the kernel JSON, the nvidia-smi line, and
``{"ok": true, "device": {...}}``.

    python3 chip_smoke.py --parent DIR

instead times the select kernel of another checkout of the repo (``DIR``,
for example the parent commit unpacked with ``git archive``) against this
one on the same inputs, in turns (parent, this, this, parent), after
phases 1 and 2.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
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


def match_golden(got: list, golden: list) -> None:
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
                and _iou(d["box_xyxy"], g["box_xyxy"]) > 0.9
                and abs(d["score"] - g["score"]) < 0.02
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
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
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

    # one batch of the flagship, one launch
    sel = runs[0]["select"]
    bound_ms, bound_by = bound_of(sel["bytes_ms"], sel["ops_ms"])
    worst = max([worst] + [r["select"]["err"] for r in runs])
    kernels = [{
        "name": "select",
        "route": "cuda",
        "source": "yolo_ms_tpu_torch/csrc/select.cu",
        "replaces": "yolo_ms_tpu/ops/pallas/select.py:56",
        "launches": sum(r["launches"] for r in runs),
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
