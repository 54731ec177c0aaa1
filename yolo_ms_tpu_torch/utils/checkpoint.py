"""Checkpointing on ``torch.save`` / ``torch.load``, written atomically.

Port of the orbax half of ``yolo_ms_tpu/utils/checkpoint.py``: checkpoints
carry the full training state (model and EMA state_dicts, the optimizer's
flat state, the step, the epoch and the step within it), so training
resumes exactly. The policy is the JAX package's: ``last.ckpt`` every epoch,
``epoch_N.ckpt`` every ``save_period`` epochs, ``best.ckpt`` on a new best
metric, which persists to ``best_metric.json`` so a resumed run never
overwrites ``best.ckpt`` with a worse model. Each file is written to a
temporary name in the same directory and renamed over the target, so a
crash mid-write leaves the previous checkpoint whole.

The reference ``.pt`` key mapping (``torch_state_dict_to_variables``) is
not ported yet.
"""

from __future__ import annotations

import json
import os
import tempfile
from typing import Any

import torch


def save_checkpoint(path: str, obj: Any) -> None:
    """``torch.save`` to a temporary file beside ``path``, then rename."""
    path = os.path.abspath(path)
    d = os.path.dirname(path)
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(prefix=".tmp_", suffix=".ckpt", dir=d)
    try:
        with os.fdopen(fd, "wb") as f:
            torch.save(obj, f)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise


def restore_checkpoint(path: str, map_location="cpu") -> Any:
    """Load a checkpoint written by ``save_checkpoint`` (tensors, numbers,
    strings and containers only: loaded with ``weights_only=True``)."""
    return torch.load(os.path.abspath(path), map_location=map_location, weights_only=True)


class CheckpointManager:
    """best / last / periodic checkpoint policy (train.py:410-425 parity)."""

    def __init__(self, directory: str, save_period: int = 10):
        self.dir = os.path.abspath(directory)
        os.makedirs(self.dir, exist_ok=True)
        self.save_period = save_period
        self.best_metric = self._load_best_metric()

    def _best_metric_path(self) -> str:
        return os.path.join(self.dir, "best_metric.json")

    def _load_best_metric(self) -> float:
        try:
            with open(self._best_metric_path()) as f:
                return float(json.load(f)["best_metric"])
        except (OSError, ValueError, KeyError):
            return float("-inf")

    def _save_best_metric(self) -> None:
        fd, tmp = tempfile.mkstemp(prefix=".tmp_", suffix=".json", dir=self.dir)
        with os.fdopen(fd, "w") as f:
            json.dump({"best_metric": self.best_metric}, f)
        os.replace(tmp, self._best_metric_path())

    def on_epoch_end(self, state, epoch: int, metric: float | None = None) -> bool:
        """Save last (and epoch_N every save_period); save best and return
        True when ``metric`` beats the best so far."""
        save_checkpoint(os.path.join(self.dir, "last.ckpt"), state)
        if (epoch + 1) % self.save_period == 0:
            save_checkpoint(os.path.join(self.dir, f"epoch_{epoch + 1}.ckpt"), state)
        if metric is not None and metric > self.best_metric:
            self.best_metric = metric
            self._save_best_metric()
            save_checkpoint(os.path.join(self.dir, "best.ckpt"), state)
            return True
        return False
