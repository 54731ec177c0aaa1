"""Weight bridge of the PyTorch port: flax variables / golden npz <-> state_dict.

Both trained golden ``weights.npz`` files convert, load ``strict=True`` into
the port's models, round-trip back to identical arrays, and BN-fold to what
the JAX ``fold_batchnorm`` gives.
"""

import os

import numpy as np
import pytest
import torch

from yolo_ms_tpu.models.deploy import fold_batchnorm as jax_fold_batchnorm
from yolo_ms_tpu.models.deploy import is_deploy_variables as jax_is_deploy
from yolo_ms_tpu_torch.models.deploy import fold_batchnorm, is_deploy_variables
from yolo_ms_tpu_torch.models.registry import build_model
from yolo_ms_tpu_torch.utils.convert import (
    flax_param_path,
    load_npz,
    state_dict_to_variables,
    train_state_to_state_dicts,
    variables_to_state_dict,
)

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
CASES = [("n", "trained"), ("yolo-ms-xs", "trained_yolo-ms-xs")]


def _npz(sub):
    with np.load(os.path.join(GOLDEN, sub, "weights.npz")) as z:
        return {k: z[k] for k in z.files}


def _unflatten(flat):
    out = {}
    for key, v in flat.items():
        node = out
        parts = key.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return out


def _flatten(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        out.update(_flatten(v, path) if isinstance(v, dict) else {path: v})
    return out


@pytest.mark.parametrize("arch,sub", CASES)
def test_npz_round_trip_is_exact(arch, sub):
    flat = _npz(sub)
    sd = load_npz(os.path.join(GOLDEN, sub, "weights.npz"))
    back = _flatten(state_dict_to_variables(sd))
    assert sorted(back) == sorted(flat)
    for key, want in flat.items():
        assert back[key].dtype == want.dtype, key
        np.testing.assert_array_equal(back[key], want, err_msg=key)


@pytest.mark.parametrize("arch,sub", CASES)
def test_npz_loads_strict_with_flax_names(arch, sub):
    sd = load_npz(os.path.join(GOLDEN, sub, "weights.npz"))
    model = build_model(arch, num_classes=3, device="cpu")
    model.load_state_dict(sd, strict=True)
    # HWIO -> OIHW; a depthwise [k, k, 1, C] kernel -> [C, 1, k, k]
    flat = _npz(sub)
    np.testing.assert_array_equal(
        sd["backbone.conv0.conv.weight"].numpy(),
        flat["params/backbone/conv0/conv/kernel"].transpose(3, 2, 0, 1),
    )
    np.testing.assert_array_equal(
        sd["head.box_0.pred.bias"].numpy(), flat["params/head/box_0/pred/bias"]
    )
    if arch == "yolo-ms-xs":
        dw = sd["backbone.stage_2.block_0.branch_1.dw.conv.weight"]
        kernel = flat["params/backbone/stage_2/block_0/branch_1/dw/conv/kernel"]
        assert kernel.shape[2] == 1 and dw.shape == (kernel.shape[3], 1, 3, 3)
    assert int(sd["backbone.conv0.bn.num_batches_tracked"]) == 0


@pytest.mark.parametrize("arch,sub", CASES)
def test_fold_batchnorm_matches_jax(arch, sub):
    tree = _unflatten(_npz(sub))
    variables = {"params": tree["params"], "batch_stats": tree["batch_stats"]}
    want = variables_to_state_dict(
        {"params": jax_fold_batchnorm(variables)["params"]}
    )
    got = fold_batchnorm(variables_to_state_dict(variables))
    assert sorted(got) == sorted(want)
    for key in want:
        np.testing.assert_allclose(
            got[key].numpy(), np.asarray(want[key]), rtol=0, atol=1e-6, err_msg=key
        )
    assert is_deploy_variables(got) and not is_deploy_variables(
        variables_to_state_dict(variables)
    )
    assert jax_is_deploy(jax_fold_batchnorm(variables))
    model = build_model(arch, num_classes=3, device="cpu", deploy=True)
    model.load_state_dict(got, strict=True)


def test_fold_batchnorm_rejects_missing_stats():
    sd = {
        "conv.weight": torch.ones(4, 3, 1, 1),
        "bn.weight": torch.ones(4),
        "bn.bias": torch.zeros(4),
    }
    with pytest.raises(ValueError, match="cannot be folded"):
        fold_batchnorm(sd)


def test_unmapped_keys_raise():
    with pytest.raises(KeyError):
        variables_to_state_dict({"params": {"x": {"embedding": np.zeros(3)}}})
    with pytest.raises(KeyError):
        state_dict_to_variables({"x.weight": torch.zeros(2, 2)})


def test_state_dict_to_variables_copies():
    """The numpy leaves are copies: training the model in place afterwards
    leaves them as they were."""
    model = build_model("n", num_classes=3, device="cpu")
    variables = state_dict_to_variables(model.state_dict())
    before = variables["params"]["backbone"]["conv0"]["conv"]["kernel"].copy()
    stats = variables["batch_stats"]["backbone"]["conv0"]["bn"]["var"].copy()
    with torch.no_grad():
        model.backbone.conv0.conv.weight.add_(1.0)
        model.backbone.conv0.bn.running_var.mul_(3.0)
    np.testing.assert_array_equal(variables["params"]["backbone"]["conv0"]["conv"]["kernel"], before)
    np.testing.assert_array_equal(variables["batch_stats"]["backbone"]["conv0"]["bn"]["var"], stats)


def test_train_state_and_param_paths():
    """A JAX train state crosses to (model, EMA) state_dicts, and each port
    parameter is named by its flax path."""
    model = build_model("n", num_classes=3, device="cpu")
    variables = state_dict_to_variables(model.state_dict())
    state = {"params": variables["params"], "batch_stats": variables["batch_stats"],
             "ema_params": variables["params"], "ema_batch_stats": variables["batch_stats"]}
    sd, ema = train_state_to_state_dicts(state)
    assert sd.keys() == ema.keys() == model.state_dict().keys()
    assert train_state_to_state_dicts(dict(state, ema_params=None))[1] is None
    for name, p in model.named_parameters():
        node = variables["params"]
        for key in flax_param_path(name, p.ndim).split("/"):
            node = node[key]
        assert node.size == p.numel(), name
    with pytest.raises(KeyError):
        flax_param_path("backbone.conv0.bn.running_mean", 1)
