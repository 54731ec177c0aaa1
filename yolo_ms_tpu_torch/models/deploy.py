"""Deploy-time BN folding on a state_dict, and the deploy module structure.

Port of ``yolo_ms_tpu/models/deploy.py``. At inference BatchNorm is a
per-channel affine map that folds exactly into the preceding conv:

    weight' = weight * gamma / sqrt(var + eps)       (per out-channel)
    bias'   = beta - mean * gamma / sqrt(var + eps)

``fold_batchnorm`` maps a train-structure state_dict to that deploy
structure; ``to_deploy_structure`` turns a module into the matching
structure (conv with bias, no BatchNorm), so the folded state_dict loads
with ``strict=True``. There is no global deploy mode as in the JAX package.
"""

from __future__ import annotations

import torch
from torch import nn

from yolo_ms_tpu_torch.nn.blocks import BN_EPS, ConvBnSiLU

_BN_LEAVES = ("weight", "bias", "running_mean", "running_var", "num_batches_tracked")


def to_deploy_structure(model: nn.Module) -> nn.Module:
    """In place: every ConvBnSiLU becomes conv(+bias) with no BatchNorm."""
    for m in model.modules():
        if isinstance(m, ConvBnSiLU):
            m.to_deploy()
    return model


def fold_batchnorm(state_dict: dict) -> dict:
    """Train-structure state_dict -> deploy-structure state_dict (every
    ``<p>bn.*`` folded into ``<p>conv.weight`` / a new ``<p>conv.bias``).
    The fold runs in f32 and each result keeps its tensor's dtype."""
    out = dict(state_dict)
    for key in state_dict:
        if not (key == "bn.weight" or key.endswith(".bn.weight")):
            continue
        prefix = key[: -len("bn.weight")]
        missing = [
            k
            for k in (prefix + "conv.weight", prefix + "bn.running_mean",
                      prefix + "bn.running_var", prefix + "bn.bias")
            if k not in state_dict
        ]
        if missing:
            raise ValueError(
                f"fold_batchnorm: BatchNorm at '{prefix}bn' cannot be folded; "
                f"missing {missing}"
            )
        w = state_dict[prefix + "conv.weight"]
        gamma = state_dict[prefix + "bn.weight"].float()
        beta = state_dict[prefix + "bn.bias"].float()
        mean = state_dict[prefix + "bn.running_mean"].float()
        var = state_dict[prefix + "bn.running_var"].float()
        f = gamma / torch.sqrt(var + BN_EPS)
        out[prefix + "conv.weight"] = (w.float() * f[:, None, None, None]).to(w.dtype)
        out[prefix + "conv.bias"] = (beta - mean * f).to(w.dtype)
        for leaf in _BN_LEAVES:
            out.pop(prefix + "bn." + leaf, None)
    return out


def is_deploy_variables(state_dict: dict) -> bool:
    """True when the state_dict is already BN-folded: no ``bn`` submodule
    anywhere (every train-structure ConvBnSiLU owns one)."""
    return not any("bn" in key.split(".")[:-1] for key in state_dict)
