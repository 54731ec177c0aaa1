"""A BN-folded conv's bias and activation in one pass: the hand-written CUDA kernel and its plain version.

``conv_epilogue(y, bias, act)`` sets, in place on a conv's output y
[N, C, H, W] (bf16 or f32, channels-last or contiguous NCHW memory),

    y <- SiLU(y + bias[c])   (act True)
    y <- y + bias[c]         (act False)

with ``bias`` [C] of y's dtype, and returns y. It goes through the
``torch.library`` op ``yolo_ms_tpu_torch::conv_epilogue`` (registered when
this module is imported; it mutates y), so a ``torch.export`` program of the
card's forward records the call and a process that loads the program
launches the kernel through this module.

It replaces no Pallas kernel: on the TPU, XLA fuses the deploy conv's bias
and SiLU into the conv (``yolo_ms_tpu/nn/blocks.py:ConvBnSiLU``). On CUDA
tensors the op launches ``csrc/epilogue.cu`` once (built with nvcc for
sm_90a at first use into the package's ``build/`` directory and loaded with
ctypes, as ``select`` and ``nms`` are) or raises; it adds the bias in f32
and rounds the result once, where torch's bias add and ``F.silu`` round
twice. On CPU tensors it runs ``conv_epilogue_plain``. ``launches`` counts
kernel launches and ``last_route`` names the path of the last one, which
``expected_route(y, bias)`` predicts from what the tensors show:

- ``vector``: channels-last memory whose C is a multiple of the 16-byte
  vector (8 bf16 or 4 f32 channels) with a 16-byte aligned bias, or NCHW
  memory whose H*W is; and a 16-byte aligned base. A vector's biases arrive
  in one load.
- ``elements``: any other C or H*W (YOLOv12's 307-wide MLP, 3-channel
  maps), an unaligned base or bias: each element of a vector finds its own
  channel.

Any other layout (a strided view that is neither), dtype or device raises.
``KERNEL`` matches the kernel's name in a profile.
"""

from __future__ import annotations

import ctypes
import os
import re

import torch
import torch.nn.functional as F

_PKG = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
SOURCE = os.path.join(_PKG, "csrc", "epilogue.cu")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
# the kernel's name in a profile, every instantiation
KERNEL = re.compile(r"\bconv_epilogue_kernel\b")
ROUTES = ("vector", "elements")  # the kernel's route codes
LAYOUTS = ("channels_last", "nchw")  # the kernel's layout codes
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
VECTOR_BYTES = 16

_lib = None


def build(source: str = SOURCE) -> dict:
    """Compile ``csrc/epilogue.cu`` (or another source of the same C
    interface) unless a library of the same source and flags is already in
    ``build/``. Returns {'path', 'seconds', 'log'}."""
    # imported here: select's module imports nn/blocks.py, which imports this one
    from yolo_ms_tpu_torch.ops.kernels.select import nvcc_build

    return nvcc_build(source, NVCC_FLAGS, "libepilogue")


def bind(path: str) -> ctypes.CDLL:
    """Load a library built by ``build`` and declare its C interface."""
    lib = ctypes.CDLL(path)
    i32, i64, ptr = ctypes.c_int, ctypes.c_int64, ctypes.c_void_p
    lib.yolo_conv_epilogue_launch.argtypes = [i32, i32, i32, ptr, ptr, i64, i64, i64, ptr,
                                              ptr]
    lib.yolo_conv_epilogue_launch.restype = i32
    return lib


def _load():
    global _lib
    if _lib is None:
        _lib = bind(build()["path"])
    return _lib


def layout(y: torch.Tensor) -> str:
    """``"nchw"`` for contiguous memory, ``"channels_last"`` for NHWC
    memory (a map that is both, H = W = 1 or C = 1, reads as NCHW: the two
    give each element the same channel); raises for any other."""
    if y.is_contiguous():
        return "nchw"
    if y.is_contiguous(memory_format=torch.channels_last):
        return "channels_last"
    raise ValueError(
        f"conv_epilogue takes channels-last or contiguous NCHW memory; got shape "
        f"{tuple(y.shape)} strides {y.stride()}"
    )


def _check(y: torch.Tensor, bias: torch.Tensor) -> str:
    if y.dim() != 4 or bias.dim() != 1 or bias.shape[0] != y.shape[1]:
        raise ValueError(
            f"conv_epilogue takes y [N, C, H, W] and bias [C]; got {tuple(y.shape)} and "
            f"{tuple(bias.shape)}"
        )
    if y.dtype not in _DTYPE_CODE or bias.dtype != y.dtype:
        raise TypeError(f"conv_epilogue takes f32 or bf16 y and a bias of its dtype; got "
                        f"{y.dtype}, {bias.dtype}")
    if y.device != bias.device:
        raise ValueError(f"y on {y.device}, bias on {bias.device}")
    if not bias.is_contiguous():
        raise ValueError(f"conv_epilogue takes a contiguous bias; got strides {bias.stride()}")
    return layout(y)


def expected_route(y: torch.Tensor, bias: torch.Tensor) -> str:
    """The path of ``csrc/epilogue.cu`` for these tensors (the module
    docstring's rule); runs on tensors of any device."""
    kind = _check(y, bias)
    vec = VECTOR_BYTES // y.element_size()
    if y.data_ptr() % VECTOR_BYTES:
        return "elements"
    if kind == "channels_last":
        aligned = y.shape[1] % vec == 0 and bias.data_ptr() % VECTOR_BYTES == 0
    else:
        aligned = y.shape[2] * y.shape[3] % vec == 0
    return "vector" if aligned else "elements"


def conv_epilogue_plain(y: torch.Tensor, bias: torch.Tensor, act: bool) -> torch.Tensor:
    """``F.silu(y + b)`` or ``y + b`` with b the bias as [1, C, 1, 1], a new
    tensor."""
    out = y + bias.view(1, -1, 1, 1)
    return F.silu(out) if act else out


def launch_with(lib: ctypes.CDLL, y: torch.Tensor, bias: torch.Tensor, act: bool) -> None:
    """The CUDA implementation of the op through a given library of
    ``epilogue.cu``'s C interface (``bind``): one launch, in place, or an
    error."""
    kind = _check(y, bias)
    if y.numel() == 0:
        return
    _, c, h, w = y.shape
    route = ctypes.c_int32(-1)
    with torch.cuda.device(y.device):
        stream = torch.cuda.current_stream(y.device).cuda_stream
        err = lib.yolo_conv_epilogue_launch(
            _DTYPE_CODE[y.dtype], LAYOUTS.index(kind), int(act), y.data_ptr(), bias.data_ptr(),
            y.numel(), c, h * w, ctypes.byref(route), stream,
        )
    if err != 0:
        raise RuntimeError(f"conv_epilogue kernel launch failed: cudaError {err}")
    conv_epilogue.launches += 1
    conv_epilogue.last_route = ROUTES[route.value]


@torch.library.custom_op("yolo_ms_tpu_torch::conv_epilogue", mutates_args=("y",))
def conv_epilogue_op(y: torch.Tensor, bias: torch.Tensor, act: bool) -> None:
    """``torch.ops.yolo_ms_tpu_torch.conv_epilogue``: the kernel on CUDA
    tensors, the plain version on CPU tensors, checks alone on meta and
    fake tensors; any other device raises."""
    raise ValueError(f"conv_epilogue runs on cuda or cpu tensors, not {y.device}")


@conv_epilogue_op.register_fake
def _conv_epilogue_fake(y, bias, act):
    _check(y, bias)


@conv_epilogue_op.register_kernel("cpu")
def _conv_epilogue_cpu(y, bias, act):
    _check(y, bias)
    y.copy_(conv_epilogue_plain(y, bias, act))


@conv_epilogue_op.register_kernel("cuda")
def _conv_epilogue_cuda(y, bias, act):
    launch_with(_load(), y, bias, act)


class _Recorded(torch.autograd.Function):
    """The op where autograd records the forward: y is marked as changed in
    place, and a backward raises. The op overwrites the sum y + b that
    SiLU's derivative needs, and torch would otherwise pass gradients
    through it as if nothing had happened."""

    @staticmethod
    def forward(ctx, y, bias, act):
        conv_epilogue_op(y, bias, act)
        ctx.mark_dirty(y)
        return y

    @staticmethod
    def backward(ctx, grad):
        raise RuntimeError(
            "conv_epilogue has no backward: train the train structure (conv, BatchNorm, "
            "SiLU), not a BN-folded deploy model"
        )


def conv_epilogue(y: torch.Tensor, bias: torch.Tensor, act: bool) -> torch.Tensor:
    """The kernel on CUDA tensors (one launch), the plain version on CPU
    tensors, in place on ``y``, through the op
    ``yolo_ms_tpu_torch::conv_epilogue``; returns ``y``. Where autograd
    records, the forward runs alike and a backward through it raises."""
    if y.device.type not in ("cuda", "cpu"):  # the op itself answers meta tensors
        raise ValueError(f"conv_epilogue runs on cuda or cpu tensors, not {y.device}")
    if torch.is_grad_enabled() and (y.requires_grad or bias.requires_grad):
        return _Recorded.apply(y, bias, bool(act))
    conv_epilogue_op(y, bias, bool(act))
    return y


conv_epilogue.launches = 0
conv_epilogue.last_route = None
