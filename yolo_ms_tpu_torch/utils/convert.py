"""Weight bridge: flax variables (or a flat "/"-keyed npz) <-> state_dict.

The port's modules are named after the flax paths, so the mapping is a
rename plus a transpose, with no per-architecture table:

    params/<p>/kernel        [kh, kw, I, O] HWIO  -> <p>.weight  [O, I, kh, kw]
                             (depthwise [k, k, 1, C] -> [C, 1, k, k])
    params/<p>/bias                               -> <p>.bias
    params/<p>/bn/scale                           -> <p>.bn.weight
    params/<p>/bn/bias                            -> <p>.bn.bias
    batch_stats/<p>/bn/mean                       -> <p>.bn.running_mean
    batch_stats/<p>/bn/var                        -> <p>.bn.running_var
                                                  (+ <p>.bn.num_batches_tracked = 0)

For example ``params/backbone/stage_2/block_0/branch_1/expand/conv/kernel``
becomes ``backbone.stage_2.block_0.branch_1.expand.conv.weight`` and
``params/head/box_0/pred/bias`` becomes ``head.box_0.pred.bias``. The
transpose is the one of ``yolo_ms_tpu/utils/checkpoint.py`` (OIHW ->
HWIO there, its inverse here). Both directions are exact.

A JAX train state crosses the same way (``train_state_to_state_dicts``):
``params`` + ``batch_stats`` become the model's state_dict and
``ema_params`` + ``ema_batch_stats`` the EMA model's. ``flax_param_path``
names a port parameter by its flax path, which the ``freeze_layers``
patterns match.
"""

from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch

_STATS_TO_TORCH = {"mean": "running_mean", "var": "running_var"}
_STATS_TO_FLAX = {v: k for k, v in _STATS_TO_TORCH.items()}


def _flatten(tree, prefix: str = "") -> dict[str, np.ndarray]:
    out = {}
    for key in tree.keys():
        path = f"{prefix}/{key}" if prefix else str(key)
        value = tree[key]
        if isinstance(value, Mapping):
            out.update(_flatten(value, path))
        else:
            out[path] = np.asarray(value)
    return out


def _to_tensor(arr: np.ndarray) -> torch.Tensor:
    if arr.dtype.kind == "V" or arr.dtype.name == "bfloat16":
        arr = arr.astype(np.float32)  # numpy-extension dtypes torch cannot wrap
    return torch.from_numpy(np.array(arr, order="C"))  # own, writable copy


def variables_to_state_dict(variables) -> dict[str, torch.Tensor]:
    """Nested flax variables, or a flat mapping with "/"-joined keys (the
    golden ``weights.npz`` files), -> a torch state_dict (CPU tensors)."""
    sd: dict[str, torch.Tensor] = {}
    for key, arr in _flatten(variables).items():
        collection, *mod, leaf = key.split("/")
        if collection == "params":
            if leaf == "kernel":
                if arr.ndim != 4:
                    raise ValueError(f"{key}: expected a 4-d conv kernel, got {arr.shape}")
                name, arr = "weight", arr.transpose(3, 2, 0, 1)
            elif leaf == "scale":
                name = "weight"
            elif leaf == "bias":
                name = "bias"
            else:
                raise KeyError(f"unmapped flax param: {key}")
        elif collection == "batch_stats":
            if leaf not in _STATS_TO_TORCH:
                raise KeyError(f"unmapped flax batch stat: {key}")
            name = _STATS_TO_TORCH[leaf]
            if leaf == "mean":
                sd[".".join(mod + ["num_batches_tracked"])] = torch.tensor(0)
        else:
            raise KeyError(f"unknown flax collection in {key}")
        sd[".".join(mod + [name])] = _to_tensor(arr)
    return sd


def state_dict_to_variables(state_dict) -> dict:
    """torch state_dict -> nested flax variables of numpy arrays (copies, so
    later in-place updates of the model do not reach them): {'params': ...}
    plus {'batch_stats': ...} when BN stats are present."""
    params: dict = {}
    stats: dict = {}
    for key, t in state_dict.items():
        *mod, leaf = key.split(".")
        if leaf == "num_batches_tracked":
            continue
        arr = t.detach().cpu()
        if arr.dtype == torch.bfloat16:
            arr = arr.float()
        arr = arr.numpy()
        if leaf in _STATS_TO_FLAX:
            tree, path = stats, mod + [_STATS_TO_FLAX[leaf]]
        elif leaf == "weight" and arr.ndim == 4:
            tree, path, arr = params, mod + ["kernel"], arr.transpose(2, 3, 1, 0)
        elif leaf == "weight" and arr.ndim == 1:
            tree, path = params, mod + ["scale"]
        elif leaf == "bias":
            tree, path = params, mod + ["bias"]
        else:
            raise KeyError(f"unmapped torch key: {key} {tuple(arr.shape)}")
        node = tree
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = np.array(arr, order="C")  # a copy: no alias of the tensor
    out = {"params": params}
    if stats:
        out["batch_stats"] = stats
    return out


def flax_param_path(name: str, ndim: int) -> str:
    """Port parameter name -> flax params path: ``backbone.conv0.conv.weight``
    (4-d) -> ``backbone/conv0/conv/kernel``, ``backbone.conv0.bn.weight``
    (1-d) -> ``backbone/conv0/bn/scale``, ``*.bias`` -> ``*/bias``."""
    *mod, leaf = name.split(".")
    if leaf == "weight":
        leaf = "kernel" if ndim == 4 else "scale"
    elif leaf != "bias":
        raise KeyError(f"not a parameter name: {name}")
    return "/".join(mod + [leaf])


def train_state_to_state_dicts(state) -> tuple[dict, dict | None]:
    """A JAX ``TrainState`` (or a mapping with its fields), as numpy, ->
    (model state_dict, EMA state_dict or None): ``params`` +
    ``batch_stats``, and ``ema_params`` + ``ema_batch_stats``."""

    def field(key):
        return state[key] if isinstance(state, Mapping) else getattr(state, key)

    model = variables_to_state_dict(
        {"params": field("params"), "batch_stats": field("batch_stats")}
    )
    if field("ema_params") is None:
        return model, None
    ema = variables_to_state_dict(
        {"params": field("ema_params"), "batch_stats": field("ema_batch_stats")}
    )
    return model, ema


def load_npz(path: str) -> dict[str, torch.Tensor]:
    """A flat "/"-keyed variables npz (tests/golden/*/weights.npz) ->
    state_dict."""
    with np.load(path) as z:
        return variables_to_state_dict({k: z[k] for k in z.files})
