"""Per-anchor selection: the hand-written CUDA kernel and its plain version.

``select_scales(pairs, reg_max)`` maps the per-scale box logits
[B, HW_i, 4*reg_max] and class logits [B, HW_i, nc] (f32 or bf16, one dtype,
any strides with an anchor or a channel stride of 1) to the concatenation
over scales, A = sum HW_i:

    mx   [B, A]    f32   max class logit
    cid  [B, A]    i32   first-index argmax class id
    ltrb [B, A, 4] f32   DFL expectation l, t, r, b

``select(box, cls, reg_max)`` is the one-scale call of the same kernel.
Both go through the ``torch.library`` op ``yolo_ms_tpu_torch::select_scales``
(registered when this module is imported), so a ``torch.export`` program
records the call and a process that loads the program launches the kernel
through this module, building it at first use.

It replaces the TPU Pallas kernel ``yolo_ms_tpu/ops/pallas/select.py``
(``_select_kernel`` via ``select_scale``). On CUDA tensors it launches
``csrc/select.cu`` once for all scales (built with nvcc for sm_90a at first
use into the package's ``build/`` directory and loaded with ctypes) or
raises; on CPU tensors it runs ``select_scales_plain``. ``select.launches``
counts kernel launches; ``select_scales.last_routes`` names the copy route
the last launch took for each (box, cls) map, and ``expected_routes(pairs)``
predicts it from the maps' strides, dtype and alignment:

- ``bulk_rows``: channel stride 1, base and batch stride 16-byte aligned,
  and either packed rows (anchor stride = channels) whose image of HW rows
  is a multiple of 16 bytes, whatever the row width, or strided rows (an
  unsplit map's slices) of 16-byte rows and anchor stride and at most 256
  channels. The main path's maps (the contiguous NHWC head outputs of
  ``entry_layouts="auto"``) take it at every class count at 640x640 (HW
  6400 / 1600 / 400), in bf16 and f32: each tile of anchors arrives
  anchor-major by one asynchronous bulk copy per map (a 1-D copy of the
  tile's packed rows, or a 3-D tensor map for strided rows). A packed map
  whose image is not a 16-byte multiple (nc 3 at HW 25: 150 bytes in bf16,
  300 in f32) stays on ``elements``; no tail is copied by threads.
- ``tma``: anchor stride 1 (the NCHW permute views of
  ``entry_layouts="default"``), aligned channel and batch strides, at most
  256 channels; one tensor-map copy per map and tile, channel-major.
- ``elements``: any other map (an unaligned base, HW 49 in NCHW, 134-byte
  unsplit rows, the images above), copied by all threads with consecutive
  threads along the map's unit stride; also the TMA-able map of a scale
  whose other map takes no TMA.
- ``wide``: every map of a launch whose tiles do not fit shared memory
  (``plan_fits`` is False): no ring of stages, each anchor's rows read
  straight from device memory (a warp an anchor's class row, or a thread
  an anchor on NCHW views), class ids in 32 bits.

Which class counts take which: the three routes above stage tiles of 32 to
128 anchors in a ring of at least two stages of ``4 * reg_max + nc``
channels within the 227 KB of shared memory one CTA may use. At reg_max 16
that holds up to nc = 826 in f32 and nc = 1,730 in bf16 (COCO's 80, the
fine-tune config's 10, VOC's 20 and LVIS's 1,203 classes in bf16); above it
(LVIS's 1,203 in f32, or any count up to 2**31 - 1) the launch takes
``wide``. Any nc >= 1 is served. On staged anchor-major tiles each class row
is walked in a scalar head up to its first 16-byte boundary, 16-byte
vectors and a scalar tail, by four lanes an anchor at tiles of 64 and 128
anchors and eight at 32 (``plan``'s ``lanes``). The JAX TPU kernel's own
limits (HW a multiple of 16, nc <= 255, its VMEM budget) are not this
kernel's.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from typing import Sequence

import torch

from yolo_ms_tpu_torch.nn.blocks import dfl_expectation

_PKG = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
SOURCE = os.path.join(_PKG, "csrc", "select.cu")
BUILD_DIR = os.path.join(_PKG, "build")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-ldl",
)
MAX_SCALES = 4
ROUTES = {0: "tma", 2: "elements", 3: "bulk_rows", 4: "wide"}  # the kernel's copy route codes
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
# make_plan's budget: the opt-in shared memory of one CTA, and what a CTA
# holds beside its ring (four mbarriers' 64 bytes and the thread groups'
# Partials<T>: 64 anchor pairs of class maxima, first indices and side maxima)
_SMEM_LIMIT = 227 * 1024
_RING_EXTRA = {torch.float32: 64 + 4352, torch.bfloat16: 64 + 2560}

_lib = None


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    raise RuntimeError("nvcc not found: the select kernel cannot be built")


def build(source: str = SOURCE) -> dict:
    """Compile ``csrc/select.cu`` (or another source of the same C
    interface) unless a library of the same source and flags is already in
    ``build/``. Returns {'path', 'seconds', 'log'} (seconds 0.0 and an empty
    log when the library was already there)."""
    return nvcc_build(source, NVCC_FLAGS, "libselect")


def nvcc_build(source: str, flags: tuple, prefix: str) -> dict:
    """``source`` compiled by nvcc with ``flags`` into
    ``build/{prefix}_{hash of source and flags}.so``, unless that library is
    already there; the ``build`` of each kernel's module."""
    with open(source, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(flags).encode()).hexdigest()
    path = os.path.join(BUILD_DIR, f"{prefix}_{digest[:16]}.so")
    if os.path.exists(path):
        return {"path": path, "seconds": 0.0, "log": ""}
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    t0 = time.perf_counter()
    proc = subprocess.run(
        [_nvcc(), *flags, "-o", tmp, source],
        capture_output=True,
        text=True,
    )
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, path)
    return {"path": path, "seconds": seconds, "log": proc.stderr}


def bind(path: str) -> ctypes.CDLL:
    """Load a library built by ``build`` and declare its C interface."""
    lib = ctypes.CDLL(path)
    i32, i64, ptr = ctypes.c_int, ctypes.c_int64, ctypes.c_void_p
    lib.yolo_select_launch.argtypes = [i32, i32, ptr, i64, i32, i32, ptr, ptr, ptr, ptr, ptr]
    lib.yolo_select_launch.restype = i32
    lib.yolo_select_plan.argtypes = [i32, i32, i32, ptr]
    lib.yolo_select_plan.restype = i32
    return lib


def _load():
    global _lib
    if _lib is None:
        _lib = bind(build()["path"])
    return _lib


def plan(dtype: torch.dtype, nc: int, reg_max: int = 16) -> dict:
    """The kernel's launch plan on the current card for a dtype and class
    count: anchors per tile, ring stages, dynamic shared bytes per CTA,
    CTAs per SM, SMs, ``route``: ``"ring"`` (tiles staged in shared
    memory) or ``"wide"`` (no stages; see ``plan_fits``), and ``lanes``, the
    threads that share one anchor's class row."""
    out = (ctypes.c_int32 * 7)()
    err = _load().yolo_select_plan(_DTYPE_CODE[dtype], nc, reg_max, out)
    if err != 0:
        raise RuntimeError(f"select plan failed: cudaError {err}")
    keys = ("tile", "stages", "smem_bytes", "ctas_per_sm", "sms")
    return {**dict(zip(keys, out)), "route": ("ring", "wide")[out[5]], "lanes": out[6]}


def plan_fits(dtype: torch.dtype, nc: int, reg_max: int = 16) -> bool:
    """Whether ``csrc/select.cu``'s ``make_plan`` finds a ring for these
    maps: two stages of a 32-anchor tile of ``4 * reg_max + nc`` channels
    (each stage rounded up to 128 bytes) beside the CTA's barriers and
    partials, within one CTA's shared memory. Where it does not, every map
    takes the ``wide`` route."""
    es = torch.empty((), dtype=dtype).element_size()
    stage = -(-((4 * reg_max + nc) * 32 * es) // 128) * 128
    return 2 * stage + _RING_EXTRA[dtype] <= _SMEM_LIMIT


def _check(pairs: Sequence, reg_max: int) -> None:
    if not 1 <= len(pairs) <= MAX_SCALES:
        raise ValueError(f"select takes 1 to {MAX_SCALES} scales, got {len(pairs)}")
    box0, cls0 = pairs[0]
    for box, cls in pairs:
        if box.dim() != 3 or cls.dim() != 3:
            raise ValueError(
                f"select expects box [B, HW, 4*reg_max] and cls [B, HW, nc]; got "
                f"{tuple(box.shape)} and {tuple(cls.shape)}"
            )
        if reg_max < 1 or box.shape[2] != 4 * reg_max:
            raise ValueError(f"box has {box.shape[2]} channels; reg_max={reg_max}")
        if box.shape[:2] != cls.shape[:2] or cls.shape[2] < 1:
            raise ValueError(f"box {tuple(box.shape)} and cls {tuple(cls.shape)} disagree")
        if box.shape[0] != box0.shape[0] or cls.shape[2] != cls0.shape[2]:
            raise ValueError(
                f"scales disagree on batch or classes: {tuple(cls.shape)} and {tuple(cls0.shape)}"
            )
        if box.dtype not in _DTYPE_CODE or cls.dtype != box.dtype or box.dtype != box0.dtype:
            raise TypeError(
                f"select takes f32 or bf16 maps of one dtype; got {box.dtype}, {cls.dtype} "
                f"beside {box0.dtype}"
            )
        if box.device != cls.device or box.device != box0.device:
            raise ValueError(f"maps on {box.device}, {cls.device} and {box0.device}")


def _map_route(t: torch.Tensor, hw: int, batch: int) -> str:
    """``pick_route`` of ``csrc/select.cu`` for one [B, HW, C] map, taking
    ``cuTensorMapEncodeTiled`` to succeed where the rule asks for it."""
    es = t.element_size()
    channels = t.shape[2]
    sb, shw, sc = t.stride()
    aligned = t.data_ptr() % 16 == 0
    if batch == 1:  # the batch stride is never stepped
        sb = sc * channels if shw == 1 else shw * hw
    if (shw == 1 and channels <= 256 and aligned and sc > 0 and sb > 0
            and sc * es % 16 == 0 and sb * es % 16 == 0):
        return "tma"
    if sc == 1 and aligned and sb > 0 and sb * es % 16 == 0:
        if shw == channels and hw * channels * es % 16 == 0:  # packed: one byte range a tile
            return "bulk_rows"
        if shw > 0 and shw * es % 16 == 0 and channels * es % 16 == 0 and channels <= 256:
            return "bulk_rows"
    return "elements"


def expected_routes(pairs: Sequence, reg_max: int = 16) -> list:
    """The (box, cls) copy routes that ``select_scales(pairs)`` takes on the
    card, one pair per scale with anchors (the rule of ``csrc/select.cu``'s
    ``make_plan`` and ``pick_route``, from the class count, dtype, the maps'
    strides and base alignment; see the module docstring). Runs on tensors
    of any device."""
    _check(pairs, reg_max)
    box0, cls0 = pairs[0]
    ring = plan_fits(box0.dtype, cls0.shape[2], reg_max)
    routes = []
    for box, cls in pairs:
        batch, hw = box.shape[:2]
        if hw == 0:
            continue
        if not ring:
            routes.append(("wide", "wide"))
            continue
        r_box, r_cls = _map_route(box, hw, batch), _map_route(cls, hw, batch)
        if (r_box == "tma") != (r_cls == "tma"):  # one layout per tile: anchor-major
            r_box, r_cls = ["elements" if r == "tma" else r for r in (r_box, r_cls)]
        routes.append((r_box, r_cls))
    return routes


def select_plain(box: torch.Tensor, cls: torch.Tensor, reg_max: int = 16):
    """One scale in plain torch ops (max / argmax / dfl_expectation)."""
    b, hw, _ = box.shape
    mx = cls.amax(dim=-1).float()
    cid = cls.argmax(dim=-1).to(torch.int32)
    ltrb = dfl_expectation(box.reshape(b, hw, 4, reg_max))
    return mx, cid, ltrb


def select_scales_plain(pairs: Sequence, reg_max: int = 16):
    """The plain version of ``select_scales``: ``select_plain`` per scale,
    concatenated over the anchors."""
    outs = [select_plain(box, cls, reg_max) for box, cls in pairs]
    return tuple(torch.cat(parts, dim=1) for parts in zip(*outs))


def _launch(boxes: list, clss: list, reg_max: int):
    """The CUDA implementation of the op: one launch of ``csrc/select.cu``
    for all scales, or an error."""
    return launch_with(_load(), boxes, clss, reg_max)


def launch_with(lib: ctypes.CDLL, boxes: list, clss: list, reg_max: int):
    """``_launch`` through a given library of ``select.cu``'s C interface
    (``bind``): the kernel as built, or an edited copy being measured."""
    pairs = list(zip(boxes, clss))
    _check(pairs, reg_max)
    for t in (*boxes, *clss):
        if t.shape[1] > 1 and t.shape[2] > 1 and 1 not in t.stride()[1:]:
            raise ValueError(
                f"select needs an anchor or a channel stride of 1; got strides {t.stride()}"
            )
    box0, cls0 = pairs[0]
    b, nc = box0.shape[0], cls0.shape[2]
    a = sum(box.shape[1] for box in boxes)
    dev = box0.device
    mx = torch.empty((b, a), dtype=torch.float32, device=dev)
    cid = torch.empty((b, a), dtype=torch.int32, device=dev)
    ltrb = torch.empty((b, a, 4), dtype=torch.float32, device=dev)
    pairs = [(box, cls) for box, cls in pairs if box.shape[1] > 0]
    if b == 0 or not pairs:
        return mx, cid, ltrb
    desc = []
    for box, cls in pairs:
        desc += [box.data_ptr(), *box.stride(), cls.data_ptr(), *cls.stride(), box.shape[1]]
    desc_arr = (ctypes.c_int64 * len(desc))(*desc)
    routes = (ctypes.c_int32 * (2 * len(pairs)))()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.yolo_select_launch(
            _DTYPE_CODE[box0.dtype], len(pairs), desc_arr, b, nc, reg_max,
            mx.data_ptr(), cid.data_ptr(), ltrb.data_ptr(), routes, stream,
        )
    if err != 0:
        raise RuntimeError(f"select kernel launch failed: cudaError {err}")
    select.launches += 1
    select_scales.last_routes = [(ROUTES[routes[2 * i]], ROUTES[routes[2 * i + 1]])
                                 for i in range(len(pairs))]
    return mx, cid, ltrb


@torch.library.custom_op("yolo_ms_tpu_torch::select_scales", mutates_args=())
def select_scales_op(
    boxes: list[torch.Tensor], clss: list[torch.Tensor], reg_max: int
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``torch.ops.yolo_ms_tpu_torch.select_scales``: the kernel on CUDA
    tensors, the plain version on CPU tensors, shapes alone on meta and
    fake tensors; any other device raises."""
    raise ValueError(f"select runs on cuda or cpu tensors, not {boxes[0].device}")


@select_scales_op.register_fake
def _select_scales_fake(boxes, clss, reg_max):
    _check(list(zip(boxes, clss)), reg_max)
    b, a = boxes[0].shape[0], sum(box.shape[1] for box in boxes)
    return (
        boxes[0].new_empty((b, a), dtype=torch.float32),
        boxes[0].new_empty((b, a), dtype=torch.int32),
        boxes[0].new_empty((b, a, 4), dtype=torch.float32),
    )


@select_scales_op.register_kernel("cpu")
def _select_scales_cpu(boxes, clss, reg_max):
    pairs = list(zip(boxes, clss))
    _check(pairs, reg_max)
    return select_scales_plain(pairs, reg_max)


select_scales_op.register_kernel("cuda")(_launch)


def select_scales(pairs: Sequence, reg_max: int = 16):
    """Kernel on CUDA tensors (one launch), ``select_scales_plain`` on CPU
    tensors, through the op ``yolo_ms_tpu_torch::select_scales`` so that
    ``torch.export`` can trace it; see the module docstring for shapes."""
    if not pairs:
        raise ValueError(f"select takes 1 to {MAX_SCALES} scales, got 0")
    dev = pairs[0][0].device
    if dev.type not in ("cuda", "cpu"):  # the op itself answers meta tensors with shapes
        raise ValueError(f"select runs on cuda or cpu tensors, not {dev}")
    boxes, clss = zip(*pairs)
    return select_scales_op(list(boxes), list(clss), reg_max)


def select(box: torch.Tensor, cls: torch.Tensor, reg_max: int = 16):
    """One scale: ``select_scales([(box, cls)], reg_max)``."""
    return select_scales([(box, cls)], reg_max)


select.launches = 0
select_scales.last_routes = []
