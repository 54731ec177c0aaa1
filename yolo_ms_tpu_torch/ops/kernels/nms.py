"""Exact greedy NMS on the device: the hand-written CUDA kernel and its plain version.

``nms(boxes, scores, iou_thresh)`` maps boxes [B, K, 4] f32 xyxy (already
class-shifted and sorted by descending score) and scores [B, K] f32, where
values <= 0 mark invalid rows, to

    keep   [B, K] bool  greedy NMS's keep mask
    sweeps [B]    i32   the sweeps of the fixed point that the eager loop
                        runs for that image, the final unchanged sweep
                        included (at most K)

through the ``torch.library`` op ``yolo_ms_tpu_torch::nms_fixed``
(registered when this module is imported), so that a ``torch.export``
program records the whole fixed point as one node and a process that loads
the program launches the kernel through this module.

It replaces the device loop of ``yolo_ms_tpu/ops/nms.py:nms_fixed`` (its
``jax.lax.while_loop``, :75-127), which the TPU runs with no host
involvement; it has no Pallas counterpart. On CUDA tensors the op launches
``csrc/nms.cu`` once per batch (built with nvcc for sm_90a at first use into
the package's ``build/`` directory and loaded with ctypes) or raises; on
CPU tensors it runs ``nms_fixed_plain``, the eager fixed point of matrix
sweeps, which reads its stop test on the host once per sweep.
``nms.launches`` counts kernel launches and ``nms.last_route`` names the
route of the last one:

- ``shared``: the overlap bits of an image (ceil(K/32) words a row) sit in
  shared memory beside its boxes, up to K = 1,288 (``route``); the main
  path's K = 1,024 takes it;
- ``global``: a larger K (``pre_nms_topk`` 4096) keeps them in a scratch of
  [B, ceil(K/32), K] words that the wrapper allocates.
"""

from __future__ import annotations

import ctypes
import os

import torch

from yolo_ms_tpu_torch.ops.iou import pairwise_iou_xyxy
from yolo_ms_tpu_torch.ops.kernels.select import BUILD_DIR, nvcc_build

_PKG = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
SOURCE = os.path.join(_PKG, "csrc", "nms.cu")
# -fmad=false: no multiply-add contraction may move an IoU across the threshold
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
ROUTES = ("shared", "global")  # the kernel's route codes
# the opt-in shared memory of one CTA on an H100 (the kernel checks the card's own)
_SMEM_LIMIT = 227 * 1024

_lib = None


def build(source: str = SOURCE) -> dict:
    """Compile ``csrc/nms.cu`` (or another source of the same C interface)
    unless a library of the same source and flags is already in ``build/``.
    Returns {'path', 'seconds', 'log'} (seconds 0.0 and an empty log when
    the library was already there)."""
    return nvcc_build(source, NVCC_FLAGS, "libnms")


def bind(path: str) -> ctypes.CDLL:
    """Load a library built by ``build`` and declare its C interface."""
    lib = ctypes.CDLL(path)
    i32, i64, ptr = ctypes.c_int, ctypes.c_int64, ctypes.c_void_p
    lib.yolo_nms_launch.argtypes = [i64, i32, ptr, ptr, ctypes.c_float, i32, ptr, ptr, ptr, ptr]
    lib.yolo_nms_launch.restype = i32
    lib.yolo_nms_plan.argtypes = [i32, ptr]
    lib.yolo_nms_plan.restype = i32
    return lib


def _load():
    global _lib
    if _lib is None:
        _lib = bind(build()["path"])
    return _lib


def words(k: int) -> int:
    """32-bit words of overlap bits a row: ceil(K / 32)."""
    return -(-k // 32)


def route(k: int) -> str:
    """The route for K boxes an image: ``shared`` where an image's boxes
    (16 B each), its overlap bits (4 B a word, ``words(k)`` words a row)
    and three rows of keep and valid words fit one CTA's shared memory,
    else ``global``."""
    w = words(k)
    return "shared" if 16 * k + 4 * w * k + 12 * w <= _SMEM_LIMIT else "global"


def plan(k: int) -> dict:
    """The kernel's plan on the current card for K boxes an image: its
    ``route``, dynamic shared bytes per CTA, threads per CTA and the card's
    opt-in shared memory limit."""
    out = (ctypes.c_int32 * 4)()
    err = _load().yolo_nms_plan(k, out)
    if err != 0:
        raise RuntimeError(f"nms plan failed: cudaError {err}")
    return {"route": ROUTES[out[0]], "smem_bytes": out[1], "threads": out[2],
            "smem_limit": out[3]}


def _check(boxes: torch.Tensor, scores: torch.Tensor) -> None:
    if boxes.dim() != 3 or boxes.shape[2] != 4 or scores.shape != boxes.shape[:2]:
        raise ValueError(f"nms expects boxes [B, K, 4] and scores [B, K]; got "
                         f"{tuple(boxes.shape)} and {tuple(scores.shape)}")
    if boxes.device != scores.device:
        raise ValueError(f"boxes on {boxes.device}, scores on {scores.device}")


def _overlap_and_valid(boxes, scores, iou_thresh: float):
    """The fixed point's operands: overlap [B, N, N] f32 0/1, where j < i
    (a higher-scored box) overlaps i above ``iou_thresh``; valid [B, N]."""
    n = boxes.shape[-2]
    iou = pairwise_iou_xyxy(boxes)
    # strictly lower triangle: a higher-scored j < i may suppress i
    tri = torch.ones(n, n, dtype=torch.bool, device=boxes.device).tril(-1)
    return ((iou > iou_thresh) & tri).float(), scores > 0.0


def _sweep(overlap, valid, keep):
    """One sweep of the fixed point: keep[i] = valid[i] and no kept j < i
    overlaps i. overlap [B, N, N] f32 0/1 (strictly lower triangle); the
    product is an exact count in f32 (or TF32)."""
    suppressed = torch.bmm(overlap, keep.float().unsqueeze(-1)).squeeze(-1) > 0.0
    return valid & ~suppressed


def nms_fixed_plain(boxes, scores, iou_thresh: float):
    """The plain version of ``nms``: the fixed point as batched [N, N] x [N]
    products in a Python loop, from keep = valid, until no image changes
    (each stop test reads one flag on the host) or after N sweeps. An
    image's sweeps count while it still changes, its final unchanged sweep
    included; the loop's own count is their max over the batch."""
    _check(boxes, scores)
    b, n = scores.shape
    overlap, valid = _overlap_and_valid(boxes, scores, iou_thresh)
    keep = valid
    sweeps = torch.zeros(b, dtype=torch.int32, device=scores.device)
    settled = torch.zeros(b, dtype=torch.bool, device=scores.device)
    for _ in range(n):
        new = _sweep(overlap, valid, keep)
        sweeps += (~settled).int()
        settled |= (new == keep).all(dim=-1)
        keep = new
        if bool(settled.all()):
            break
    return keep, sweeps


def _launch(boxes: torch.Tensor, scores: torch.Tensor, iou_thresh: float):
    """The CUDA implementation of the op: one launch of ``csrc/nms.cu`` per
    batch, or an error."""
    return launch_with(_load(), boxes, scores, iou_thresh)


def launch_with(lib: ctypes.CDLL, boxes: torch.Tensor, scores: torch.Tensor, iou_thresh: float):
    """``_launch`` through a given library of ``nms.cu``'s C interface
    (``bind``): the kernel as built, or an edited copy being measured."""
    _check(boxes, scores)
    if boxes.dtype != torch.float32 or scores.dtype != torch.float32:
        raise TypeError(f"nms takes f32 boxes and scores; got {boxes.dtype} and {scores.dtype}")
    b, k = scores.shape
    dev = boxes.device
    # the kernel reads each box as one 16-byte vector
    if not (boxes.is_contiguous() and scores.is_contiguous()) or boxes.data_ptr() % 16:
        raise ValueError("nms takes contiguous boxes and scores, the boxes 16-byte aligned")
    keep = torch.empty((b, k), dtype=torch.bool, device=dev)
    if b == 0 or k == 0:
        return keep, torch.zeros((b,), dtype=torch.int32, device=dev)
    sweeps = torch.empty((b,), dtype=torch.int32, device=dev)
    r = route(k)
    scratch = (torch.empty(b * words(k) * k, dtype=torch.int32, device=dev)
               if r == "global" else None)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.yolo_nms_launch(
            b, k, boxes.data_ptr(), scores.data_ptr(), float(iou_thresh), ROUTES.index(r),
            None if scratch is None else scratch.data_ptr(), keep.data_ptr(),
            sweeps.data_ptr(), stream,
        )
    if err != 0:
        raise RuntimeError(f"nms kernel launch failed: cudaError {err}")
    nms.launches += 1
    nms.last_route = r
    return keep, sweeps


@torch.library.custom_op("yolo_ms_tpu_torch::nms_fixed", mutates_args=())
def nms_fixed_op(
    boxes: torch.Tensor, scores: torch.Tensor, iou_thresh: float
) -> tuple[torch.Tensor, torch.Tensor]:
    """``torch.ops.yolo_ms_tpu_torch.nms_fixed``: the kernel on CUDA
    tensors, the plain version on CPU tensors, shapes alone on meta and
    fake tensors; any other device raises."""
    raise ValueError(f"nms runs on cuda or cpu tensors, not {boxes.device}")


@nms_fixed_op.register_fake
def _nms_fixed_fake(boxes, scores, iou_thresh):
    _check(boxes, scores)
    b, k = scores.shape
    return (scores.new_empty((b, k), dtype=torch.bool),
            scores.new_empty((b,), dtype=torch.int32))


@nms_fixed_op.register_kernel("cpu")
def _nms_fixed_cpu(boxes, scores, iou_thresh):
    return nms_fixed_plain(boxes, scores, iou_thresh)


nms_fixed_op.register_kernel("cuda")(_launch)


def nms(boxes: torch.Tensor, scores: torch.Tensor, iou_thresh: float):
    """Kernel on CUDA tensors (one launch), ``nms_fixed_plain`` on CPU
    tensors, through the op ``yolo_ms_tpu_torch::nms_fixed`` so that
    ``torch.export`` records it; see the module docstring for shapes."""
    dev = boxes.device
    if dev.type not in ("cuda", "cpu"):  # the op itself answers meta tensors with shapes
        raise ValueError(f"nms runs on cuda or cpu tensors, not {dev}")
    return nms_fixed_op(boxes, scores, float(iou_thresh))


nms.launches = 0
nms.last_route = None
