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

``torch_state_dict_to_variables`` is a copy of the JAX package's mapping of
a reference-format ``.pt`` state_dict (the ``model`` / ``state_dict``
wrappers and the DataParallel ``module.`` prefix included) to flax
variables; ``load_torch_checkpoint`` composes it with
``variables_to_state_dict``, so a reference ``.pt`` becomes a port
state_dict with no per-architecture table. ``load_serving_state_dict`` turns
any checkpoint flavour into the state_dict a ``Predictor`` serves.
"""

from __future__ import annotations

import json
import os
import tempfile
from typing import Any

import numpy as np
import torch

from yolo_ms_tpu_torch.utils.convert import load_npz, variables_to_state_dict


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


# --------------------------------------------------------------------------
# Reference .pt -> flax variables -> port state_dict
# --------------------------------------------------------------------------


def _unwrap_state_dict(ckpt) -> dict:
    if isinstance(ckpt, dict):
        if "model" in ckpt and isinstance(ckpt["model"], dict):
            ckpt = ckpt["model"]
        elif "state_dict" in ckpt and isinstance(ckpt["state_dict"], dict):
            ckpt = ckpt["state_dict"]
    if any(k.startswith("module.") for k in ckpt):
        ckpt = {k.removeprefix("module."): v for k, v in ckpt.items()}
    return ckpt


def _set(tree: dict, path: list[str], value) -> None:
    node = tree
    for p in path[:-1]:
        node = node.setdefault(p, {})
    node[path[-1]] = value


_SEQ_IDX_TO_NAME = {0: "conv1", 1: "conv2", 2: "pred"}


def torch_state_dict_to_variables(state_dict: dict) -> dict:
    """Map a reference-architecture torch state dict to flax variables
    (numpy leaves).

    Key grammar (reference module tree, yolov8.py:8-21):
      backbone.(conv0|conv1|conv3|conv5|conv7).(conv|bn).*
      backbone.(c2f_2|c2f_4|c2f_6|c2f_8).(conv1|conv2).(conv|bn).* | .m.{i}.conv{1,2}.(conv|bn).*
      backbone.sppf.(conv1|conv2).(conv|bn).*
      neck.(c2f_1..c2f_4) like c2f; neck.(conv1|conv2).(conv|bn).*
      head.(box|cls).{lvl}.{0|1}.(conv|bn).* | .{2}.(weight|bias)   [branch seq]
      head.dfl.conv.weight  -> dropped (frozen arange conv; decode is
                               computed analytically in models/decode.py)
    Any other key raises ``KeyError``.
    """
    sd = _unwrap_state_dict(state_dict)
    params: dict = {}
    batch_stats: dict = {}

    for key, tensor in sd.items():
        t = np.asarray(tensor.detach().cpu().numpy() if hasattr(tensor, "detach") else tensor)
        parts = key.split(".")
        if parts[0] == "head" and parts[1] == "dfl":
            continue  # analytic in decode
        if "num_batches_tracked" in key:
            continue

        # normalize head branch indices: head.box.0.1.bn.weight
        if parts[0] == "head" and parts[1] in ("box", "cls"):
            lvl, seq = parts[2], int(parts[3])
            base = [parts[0], f"{parts[1]}_{lvl}", _SEQ_IDX_TO_NAME[seq]]
            rest = parts[4:]
            if seq == 2:  # plain Conv2d: weight/bias
                name = rest[0]
                if name == "weight":
                    _set(params, base + ["kernel"], t.transpose(2, 3, 1, 0))
                else:
                    _set(params, base + ["bias"], t)
                continue
            parts = base + rest  # fall through to Conv/BN handling
        else:
            # C2f bottleneck list: ...m.{i}... -> m_{i}
            parts = [
                f"m_{parts[i + 1]}" if p == "m" and parts[i + 1].isdigit() else p
                for i, p in enumerate(parts)
            ]
            parts = [p for i, p in enumerate(parts) if not (p.isdigit() and parts[i - 1].startswith("m_"))]

        leaf = parts[-1]
        mod = parts[-2]
        base = parts[:-2]
        if mod == "conv" and leaf == "weight":
            _set(params, base + ["conv", "kernel"], t.transpose(2, 3, 1, 0))
        elif mod == "bn":
            if leaf == "weight":
                _set(params, base + ["bn", "scale"], t)
            elif leaf == "bias":
                _set(params, base + ["bn", "bias"], t)
            elif leaf == "running_mean":
                _set(batch_stats, base + ["bn", "mean"], t)
            elif leaf == "running_var":
                _set(batch_stats, base + ["bn", "var"], t)
        else:
            raise KeyError(f"Unmapped torch key: {key}")

    return {"params": params, "batch_stats": batch_stats}


def load_torch_checkpoint(path: str) -> dict[str, torch.Tensor]:
    """A reference ``.pt`` file -> port state_dict (CPU tensors). The
    reference's files may carry non-tensor objects, so this one load is not
    ``weights_only``: open only ``.pt`` files from a source you trust."""
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    return variables_to_state_dict(torch_state_dict_to_variables(ckpt))


def load_serving_state_dict(path: str) -> dict[str, torch.Tensor]:
    """Any checkpoint flavour -> the state_dict to serve (shared by the
    test / val / export CLIs), dispatched by extension as in the JAX
    package: a reference ``.pt`` / ``.pth`` (mapped), a flax-layout ``.npz``,
    a port train checkpoint (the EMA model, the validated one, else the raw
    model) or a state_dict as it was saved (a BN-folded export)."""
    if not os.path.exists(path):
        raise FileNotFoundError(f"Checkpoint file not found: {path}")
    if path.endswith((".pt", ".pth")):
        return load_torch_checkpoint(path)
    if path.endswith(".npz"):
        return load_npz(path)
    restored = restore_checkpoint(path)
    if "state" in restored:
        state = restored["state"]
        return state["ema"] if state.get("ema") is not None else state["model"]
    return restored
