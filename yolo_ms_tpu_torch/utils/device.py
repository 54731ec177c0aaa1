"""Device resolution and f32 precision for the port's entry points."""

from __future__ import annotations

import contextlib

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means the card: ``cuda`` when present, else an error.

    The entry points never fall back to the CPU on their own; a caller that
    wants the CPU (the tests) asks for it with ``device="cpu"``.
    """
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device available; pass device='cpu' to run on the CPU"
            )
        return torch.device("cuda")
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r} requested but CUDA is not available")
    return dev


def config_device(cfg, device=None):
    """The device an entry point given a ``Config`` runs on: ``device`` if
    the caller names one, else the CPU when the config says ``device:
    "cpu"``, else the card (``None`` for ``resolve_device``)."""
    if device is None and str(cfg.device).lower() == "cpu":
        return "cpu"
    return device


@contextlib.contextmanager
def full_f32():
    """Run f32 matmuls and cuDNN convs in IEEE f32 (no TF32) inside the block.

    The JAX package pins HIGHEST precision for f32 models (nn/blocks.py
    dfl_expectation, the postprocess gathers, the trainer); on the card the
    counterpart is turning off TF32 in both switches: the matmul switch
    (off by default) and the cuDNN conv switch (TF32 by default). bf16
    serving is unaffected. The previous settings are restored on exit.
    """
    switches = (torch.backends.cuda.matmul, torch.backends.cudnn.conv)
    before = [s.fp32_precision for s in switches]
    try:
        for s in switches:
            s.fp32_precision = "ieee"
        yield
    finally:
        for s, v in zip(switches, before):
            s.fp32_precision = v
