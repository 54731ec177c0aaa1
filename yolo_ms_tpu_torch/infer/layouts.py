"""Channels-last serving: the entry layouts of the serving module.

Port of ``yolo_ms_tpu/infer/layouts.py`` (``AutoLayoutInfer``). The JAX
class compiles the serving function with the compiler's preferred entry
layouts, pins the weights into their preferred formats once and places each
arriving image batch in the preferred image format. On the card the
counterpart is PyTorch's memory format, which sets the layout cuDNN is
given: ``torch.channels_last`` (NHWC memory behind NCHW shapes).

- The weights are converted to channels-last once, when the wrapper is
  built (or at its first call, when a test forces it on afterwards).
- The uint8 NHWC batch already is channels-last memory: its normalized
  ``permute(0, 3, 1, 2)`` view enters the network without a copy, where the
  default layout copies it into a contiguous NCHW tensor.
- Every conv then reads and writes NHWC. Every pool, upsample, add and
  concat keeps the layout of its inputs. The one exception is the first
  bottleneck conv of each C2f (``*.c2f_*.m_0.conv1.conv``): its input is a
  channel slice of the block's first conv, a strided view in either layout,
  which the conv copies. Its output is channels-last again.
- The split head's (box, cls) maps reach ``select`` as contiguous NHWC rows
  (the kernel's "rows" route), not as the strided NCHW views that take its
  TMA route.

Enabled on a CUDA device, disabled elsewhere, as the JAX class is off the
TPU: disabled, the module serves in the default layout and its outputs are
those of the plain module. Nothing falls back in silence: a module whose
weights do not all become channels-last raises.
"""

from __future__ import annotations

import torch
from torch import nn

ENTRY_LAYOUTS = ("auto", "default")
# The device types on which the wrapper is on. Tests add "cpu" to force it
# on for a module built after the change.
ENABLED_ON = ("cuda",)


def check_entry_layouts(entry_layouts: str) -> None:
    """Raise ``ValueError`` unless ``entry_layouts`` is ``"auto"`` or
    ``"default"``."""
    if entry_layouts not in ENTRY_LAYOUTS:
        raise ValueError(f"entry_layouts must be 'auto' or 'default', not {entry_layouts!r}")


def memory_format_name(memory_format: torch.memory_format) -> str:
    """``channels_last`` or ``contiguous_format``, as reports name it."""
    return str(memory_format).removeprefix("torch.")


def not_channels_last(module: nn.Module) -> list[str]:
    """The names of ``module``'s 4-D parameters whose memory is not
    channels-last."""
    return [
        name
        for name, p in module.named_parameters()
        if p.dim() == 4 and not p.is_contiguous(memory_format=torch.channels_last)
    ]


class AutoLayoutInfer:
    """``images_u8 -> out`` over a ``ServingProgram`` (``infer/program.py``)
    in the memory format that cuDNN's NHWC kernels take.

    ``program`` is converted in place: serving weights are fixed after
    construction (the ``Predictor``'s contract), so the conversion is done
    once. One conversion serves every batch shape.
    """

    def __init__(self, program: nn.Module):
        self._program = program
        device = next(program.parameters()).device
        self._disabled = device.type not in ENABLED_ON
        self._pinned = False
        self._ensure()

    def _ensure(self) -> torch.memory_format | None:
        """The program's weights pinned to channels-last (once), and its
        entry format set; None when disabled."""
        if self._disabled:
            return None
        if not self._pinned:
            self._program.to(memory_format=torch.channels_last)
            stubborn = not_channels_last(self._program)
            if stubborn:
                raise RuntimeError(
                    f"channels-last entry layouts: {len(stubborn)} weights stayed in "
                    f"another layout ({', '.join(stubborn[:4])}); serve with "
                    "entry_layouts='default'"
                )
            self._program.memory_format = torch.channels_last
            self._pinned = True
        return torch.channels_last

    def image_format(self) -> torch.memory_format | None:
        """The memory format in which the network takes its input
        (``torch.channels_last``), or None when the wrapper is disabled. A
        producer of uint8 NHWC batches needs no relayout for it: a
        contiguous NHWC batch is already channels-last memory."""
        return self._ensure()

    def __call__(self, images_u8: torch.Tensor) -> dict:
        self._ensure()
        return self._program(images_u8)
