"""The port's ``Trainer`` against the JAX ``Trainer``, end to end.

Both train yolov8-n (160 px, nc=3) for two epochs of two steps on the same
synthetic COCO set (the learning recipe's rectangles) with Adam, a warmup,
clipping, weight decay and EMA, from the same initial weights: the trained
golden ``tests/golden/trained/weights.npz``, which the port loads as its
pretrained weights and the JAX Trainer gets through its ``init_model``, so
that validation finds objects. Each runs on one device (the JAX Trainer's
mesh is cut to one CPU device, as the port runs). The loaders are byte-equal
(``test_torch_data.py``), so the runs see the same batches. Held: every
step's loss terms rtol 1e-4 and num_fg equal; the params, BatchNorm
statistics and their EMA after steps one and three rtol 1e-3 / atol 1e-5,
but for the params of elements whose Adam steps, replayed from the JAX run's
gradients, could move that far within the gradients' rounding: those within
twice the summed learning rates, and every moment within its rounding bound
(``assert_adam_params_close``); the validation mAP at the end of training
equal.
"""

import os

import jax
import numpy as np
import pytest
import torch

from tests.make_fixtures import make_coco_dataset
from tests.test_torch_cuda import assert_adam_params_close
from tests.torch_policy import NullLogger
from yolo_ms_tpu.parallel.mesh import make_mesh
from yolo_ms_tpu.train import trainer as jax_trainer_mod
from yolo_ms_tpu.utils.config import Config as JaxConfig
from yolo_ms_tpu_torch.train import trainer as trainer_mod
from yolo_ms_tpu_torch.train.trainer import Trainer
from yolo_ms_tpu_torch.utils.config import Config
from yolo_ms_tpu_torch.utils.convert import (
    load_npz,
    state_dict_to_variables,
    train_state_to_state_dicts,
    variables_to_state_dict,
)

LOSS_KEYS = ("loss_box", "loss_cls", "loss_dfl", "total_loss")
STATE_TOL = dict(rtol=1e-3, atol=1e-5)
SNAPSHOT_STEPS = (1, 3)
LR = 5e-4
# the learning rates of the first three updates: warmup 0, LR / 2, then the
# cosine's LR
LRS = (0.0, LR / 2, LR)
MAX_ADAM_STEP = 2 * sum(LRS)
GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden", "trained",
                      "weights.npz")


def _config(root, images, ann, name, pretrained=None):
    return {
        "dataset": {"train_images_path": images, "train_annotations_path": ann,
                    "val_images_path": images, "val_annotations_path": ann,
                    "num_classes": 3, "max_gt": 8, "gt_buckets": []},
        "model": {"architecture": "n", "input_size": [160, 160], "compute_dtype": "float32",
                  "pretrained_weights_path": pretrained},
        "training": {
            "batch_size": 4, "epochs": 2, "learning_rate": LR, "optimizer": "adam",
            "weight_decay": 5e-4, "grad_clip_norm": 10.0, "ema_decay": 0.9999,
            "val_interval": 2, "save_period": 1000, "experiment_name": name,
            "log_dir": os.path.join(root, "runs"), "seed": 3,
            "augmentation": {"fliplr": 0.5, "mosaic": 0.5, "hsv_v": 0.3},
            "scheduler": {"type": "cosine", "warmup_steps": 2},
        },
        "evaluation": {"batch_size": 4, "confidence_threshold": 0.05},
        "workers": 1,
        "device": "cpu",
    }


def _host(tree):
    return jax.tree_util.tree_map(np.asarray, jax.device_get(tree))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    with pytest.MonkeyPatch.context() as mp:
        # no test reads the scalars: neither Trainer imports TensorFlow
        mp.setattr(trainer_mod, "MetricLogger", NullLogger)
        mp.setattr(jax_trainer_mod, "MetricLogger", NullLogger)
        return _runs(str(tmp_path_factory.mktemp("fit")), mp)


def _runs(root, mp):
    images, ann = make_coco_dataset(root, num_images=8, num_classes=3, img_w=320, img_h=256,
                                    seed=1)

    port = Trainer(Config.from_dict(_config(root, images, ann, "port", GOLDEN)),
                   verbose=False)
    initial = state_dict_to_variables(load_npz(GOLDEN))
    assert all(torch.equal(v, port.state.model.state_dict()[k])
               for k, v in load_npz(GOLDEN).items())
    port_rec = []
    inner = port._train_step

    def port_step(state, batch):
        m = inner(state, batch)
        snap = None
        if len(port_rec) + 1 in SNAPSHOT_STEPS:
            snap = (state.model.state_dict(), state.ema.state_dict())
            snap = tuple({k: v.clone() for k, v in sd.items()} for sd in snap)
            snap += (state.opt_state["mu"].clone(),)
        port_rec.append(({k: float(v) for k, v in m.items()}, snap))
        return m

    port._train_step = port_step
    port.fit()
    port_map = port._last_val_result

    mp.setattr(jax_trainer_mod, "make_mesh", lambda: make_mesh(jax.devices()[:1]))
    mp.setattr(jax_trainer_mod, "init_model", lambda model, rng, size: initial)
    jt = jax_trainer_mod.Trainer(
        JaxConfig.from_dict(_config(root, images, ann, "jax")), verbose=False)
    # the state where the step's outputs live, so that the second step runs
    # the first one's executable instead of compiling another
    jt.state = jax.device_put(jt.state, jt.repl)
    jax_rec = []
    jinner = jt._train_step

    def jax_step(state, batch):
        new, m = jinner(state, batch)
        snap = _host(new) if len(jax_rec) + 1 in SNAPSHOT_STEPS else None
        jax_rec.append(({k: float(v) for k, v in _host(m).items()}, snap,
                        _host(_jax_adam_mu(new))))
        return new, m

    jt._train_step = jax_step
    jt.fit()
    names = [n for n, _ in port.state.model.named_parameters()]
    return port_rec, port_map, jax_rec, jt._last_val_result, names


def test_per_step_losses_equal(runs):
    port_rec, _, jax_rec, _, _ = runs
    assert len(port_rec) == len(jax_rec) == 4
    for i, ((pm, _), (jm, _, _)) in enumerate(zip(port_rec, jax_rec)):
        assert pm["skipped_nonfinite"] == jm["skipped_nonfinite"] == 0.0
        assert pm["num_fg"] == jm["num_fg"], f"step {i + 1}"
        for k in LOSS_KEYS:
            np.testing.assert_allclose(pm[k], jm[k], rtol=1e-4, err_msg=f"step {i + 1} {k}")
    assert any(jm["num_fg"] > 0 for jm, _, _ in jax_rec)


def _jax_adam_mu(jax_state):
    """The first Adam moment of a JAX train state, as a params tree."""
    for part in jax.tree_util.tree_leaves(
            jax_state.opt_state, is_leaf=lambda x: hasattr(x, "mu")):
        if hasattr(part, "mu"):
            return part.mu
    raise AssertionError("no Adam state in the optimizer state")


def _flat(sd, names):
    return torch.cat([torch.as_tensor(np.asarray(sd[n])).reshape(-1) for n in names])


def _flat_mu(mu_tree, names):
    return _flat(variables_to_state_dict({"params": mu_tree}), names)


@pytest.mark.parametrize("step", SNAPSHOT_STEPS)
def test_state_after_steps_equal(runs, step):
    port_rec, _, jax_rec, _, names = runs
    got_model, got_ema, got_mu = port_rec[step - 1][1]
    jax_state = jax_rec[step - 1][1]
    want_model, want_ema = train_state_to_state_dicts(jax_state)
    mus_want = [_flat_mu(jax_rec[s][2], names) for s in range(step)]
    sizes = [got_model[n].numel() for n in names]
    for got, want, which in ((got_model, want_model, "model"), (got_ema, want_ema, "ema")):
        assert_adam_params_close(_flat(got, names), _flat(want, names), got_mu,
                                 mus_want, LRS[:step], sizes, MAX_ADAM_STEP)
        for key, val in want.items():
            if key in names or key.endswith("num_batches_tracked"):
                continue
            np.testing.assert_allclose(got[key].numpy(), val.numpy(),
                                       err_msg=f"step {step} {which} {key}", **STATE_TOL)


def test_validation_map_equal(runs):
    _, port_map, _, jax_map, _ = runs
    assert set(port_map) == set(jax_map)
    assert jax_map["map_50"] > 0.5  # the trained weights find the rectangles
    for k in ("map", "map_50"):
        np.testing.assert_allclose(port_map[k], jax_map[k], rtol=0, atol=1e-6, err_msg=k)
    assert port_map["per_class"].keys() == jax_map["per_class"].keys()
    for c, v in jax_map["per_class"].items():
        np.testing.assert_allclose(port_map["per_class"][c], v, rtol=0, atol=1e-6)
