"""Tracing and timing utilities, the port of ``yolo_ms_tpu/utils/profiler.py``.

- ``trace(log_dir)``: a context manager around ``torch.profiler`` with the
  CPU activity, and the CUDA one where a card is present; on exit it writes
  a Chrome trace (``trace.json``, viewable in Perfetto or
  ``chrome://tracing``) into ``log_dir``. It yields the profiler, whose
  ``key_averages()`` can be read after the block.
- ``Timer``: steady-state wall-clock timing (warmup, then iterations; mean,
  median, p10, p90), with ``torch.cuda.synchronize()`` after each call
  whose result holds a tensor on the card, where the JAX package blocks
  until ready.

The JAX package's ``enable_compilation_cache`` (a persistent XLA cache) has
no counterpart here: nothing is traced and compiled per shape. Its named
substitute is the nvcc build directory ``yolo_ms_tpu_torch/build/``, which
keeps the ``select`` kernel built from one run to the next.
"""

from __future__ import annotations

import contextlib
import os
import time

import numpy as np
import torch


@contextlib.contextmanager
def trace(log_dir: str):
    """``torch.profiler`` over the block; writes ``log_dir/trace.json``."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def _on_card(result) -> bool:
    if isinstance(result, torch.Tensor):
        return result.is_cuda
    if isinstance(result, dict):
        return any(_on_card(v) for v in result.values())
    if isinstance(result, (list, tuple)):
        return any(_on_card(v) for v in result)
    return False


def _wait(result) -> None:
    if _on_card(result):
        torch.cuda.synchronize()


class Timer:
    """Steady-state timing: ``f(i)`` must build and launch the work of
    iteration i (vary its inputs with i so nothing is cached end to end)."""

    def __init__(self, warmup: int = 3, iters: int = 20):
        self.warmup = warmup
        self.iters = iters

    def measure(self, f) -> dict:
        for i in range(self.warmup):
            _wait(f(i))
        times = []
        for i in range(self.iters):
            t0 = time.perf_counter()
            _wait(f(self.warmup + i))
            times.append(time.perf_counter() - t0)
        arr = np.asarray(times)
        return {
            "mean_s": float(arr.mean()),
            "median_s": float(np.median(arr)),
            "p10_s": float(np.percentile(arr, 10)),
            "p90_s": float(np.percentile(arr, 90)),
            "iters": self.iters,
        }
