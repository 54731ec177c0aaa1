"""Per-anchor selection: the hand-written CUDA kernel and its plain version.

``select(box, cls, reg_max)`` maps one scale's box logits [B, HW, 4*reg_max]
and class logits [B, HW, nc] (f32 or bf16, any strides) to

    mx   [B, HW]    f32   max class logit
    cid  [B, HW]    i32   first-index argmax class id
    ltrb [B, HW, 4] f32   DFL expectation l, t, r, b

It replaces the TPU Pallas kernel ``yolo_ms_tpu/ops/pallas/select.py``
(``_select_kernel`` via ``select_scale``). On a CUDA tensor it launches
``csrc/select.cu`` (built with nvcc for sm_90a at first use into the
package's ``build/`` directory and loaded with ctypes) or raises; on a CPU
tensor it runs ``select_plain``. ``select.launches`` counts kernel
launches. The TPU kernel's limits (HW a multiple of 16, nc <= 255, the VMEM
block budget) do not apply.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time

import torch

from yolo_ms_tpu_torch.nn.blocks import dfl_expectation

_PKG = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
SOURCE = os.path.join(_PKG, "csrc", "select.cu")
BUILD_DIR = os.path.join(_PKG, "build")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

_lib = None


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    raise RuntimeError("nvcc not found: the select kernel cannot be built")


def build() -> dict:
    """Compile ``csrc/select.cu`` unless a library of the same source and
    flags is already in ``build/``. Returns {'path', 'seconds', 'log'}
    (seconds 0.0 and an empty log when the library was already there)."""
    with open(SOURCE, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode()).hexdigest()
    path = os.path.join(BUILD_DIR, f"libselect_{digest[:16]}.so")
    if os.path.exists(path):
        return {"path": path, "seconds": 0.0, "log": ""}
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    t0 = time.perf_counter()
    proc = subprocess.run(
        [_nvcc(), *NVCC_FLAGS, "-o", tmp, SOURCE],
        capture_output=True,
        text=True,
    )
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, path)
    return {"path": path, "seconds": seconds, "log": proc.stderr}


def _load():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(build()["path"])
        fn = lib.yolo_select_launch
        i64, ptr = ctypes.c_int64, ctypes.c_void_p
        fn.argtypes = [
            ctypes.c_int,
            ptr, i64, i64, i64,
            ptr, i64, i64, i64,
            i64, i64, ctypes.c_int, ctypes.c_int,
            ptr, ptr, ptr,
            ptr,
        ]
        fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def _check(box: torch.Tensor, cls: torch.Tensor, reg_max: int) -> None:
    if box.dim() != 3 or cls.dim() != 3:
        raise ValueError(
            f"select expects box [B, HW, 4*reg_max] and cls [B, HW, nc]; got "
            f"{tuple(box.shape)} and {tuple(cls.shape)}"
        )
    if reg_max < 1 or box.shape[2] != 4 * reg_max:
        raise ValueError(f"box has {box.shape[2]} channels; reg_max={reg_max}")
    if box.shape[:2] != cls.shape[:2] or cls.shape[2] < 1:
        raise ValueError(f"box {tuple(box.shape)} and cls {tuple(cls.shape)} disagree")
    if box.dtype not in _DTYPE_CODE or cls.dtype != box.dtype:
        raise TypeError(f"select takes f32 or bf16 maps of one dtype; got {box.dtype}, {cls.dtype}")
    if box.device != cls.device:
        raise ValueError(f"box on {box.device}, cls on {cls.device}")


def select_plain(box: torch.Tensor, cls: torch.Tensor, reg_max: int = 16):
    """The same function in plain torch ops (max / argmax / dfl_expectation)."""
    b, hw, _ = box.shape
    mx = cls.amax(dim=-1).float()
    cid = cls.argmax(dim=-1).to(torch.int32)
    ltrb = dfl_expectation(box.reshape(b, hw, 4, reg_max))
    return mx, cid, ltrb


def select(box: torch.Tensor, cls: torch.Tensor, reg_max: int = 16):
    """Kernel on CUDA tensors, ``select_plain`` on CPU tensors; see the
    module docstring for shapes."""
    _check(box, cls, reg_max)
    if box.device.type == "cpu":
        return select_plain(box, cls, reg_max)
    if box.device.type != "cuda":
        raise ValueError(f"select runs on cuda or cpu tensors, not {box.device}")
    b, hw, _ = box.shape
    dev = box.device
    mx = torch.empty((b, hw), dtype=torch.float32, device=dev)
    cid = torch.empty((b, hw), dtype=torch.int32, device=dev)
    ltrb = torch.empty((b, hw, 4), dtype=torch.float32, device=dev)
    if b * hw == 0:
        return mx, cid, ltrb
    lib = _load()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.yolo_select_launch(
            _DTYPE_CODE[box.dtype],
            box.data_ptr(), *box.stride(),
            cls.data_ptr(), *cls.stride(),
            b, hw, cls.shape[2], reg_max,
            mx.data_ptr(), cid.data_ptr(), ltrb.data_ptr(),
            stream,
        )
    if err != 0:
        raise RuntimeError(f"select kernel launch failed: cudaError {err}")
    select.launches += 1
    return mx, cid, ltrb


select.launches = 0
