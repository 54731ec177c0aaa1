"""The port's train step and Trainer against the JAX package's.

- ``init_model`` against flax's init: the same variable tree and shapes;
  kernels drawn as ``lecun_normal`` (the same truncated law as flax's own
  draws); zero biases, identity BatchNorm, the head's prior biases.
- One and three f32 train steps of yolov8-n (64 px, nc=3, batch 2) with
  SGD-nesterov, weight decay, clipping, a warmup and EMA, against
  ``make_train_step`` on the same weights and batches: the loss terms rtol
  1e-4, num_fg equal; params, BatchNorm statistics, EMA params and EMA
  statistics rtol 1e-3 / atol 1e-5 after each step. Adam's steps are held
  through the ``Trainer`` against the JAX ``Trainer``, whose step is
  ``make_train_step`` (``test_torch_trainer_fit.py``).
- Both NaN-guard cases of the JAX unit tests (a non-finite loss; a finite
  loss with non-finite gradients): skipped on both sides, and the port's
  whole state unchanged but for the step count.
- GT buckets: slicing the GT padding off changes nothing.
- ``Trainer`` resume at an epoch end and mid-epoch gives the same next
  losses as the uninterrupted run; ``tools/train.py`` on a YAML; the
  device rule; ``MeanAveragePrecision`` equal to the JAX one.

One JAX train-step compile serves the step tests (module fixture).
"""

import functools
import os
from types import SimpleNamespace

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.make_fixtures import make_coco_dataset
from yolo_ms_tpu.eval.coco_map import MeanAveragePrecision as JaxMAP
from yolo_ms_tpu.models.registry import build_model as jax_build_model
from yolo_ms_tpu.train.loss import DetectionLoss as JaxLoss
from yolo_ms_tpu.train.optim import build_optimizer as jax_build_optimizer
from yolo_ms_tpu.train.trainer import TrainState as JaxState
from yolo_ms_tpu.train.trainer import make_train_step as jax_make_train_step
from yolo_ms_tpu.utils.config import TrainingConfig as JaxTrainingConfig
from yolo_ms_tpu_torch.eval.coco_map import MeanAveragePrecision
from yolo_ms_tpu_torch.models.registry import build_model, init_model
from yolo_ms_tpu_torch.train.loss import DetectionLoss
from yolo_ms_tpu_torch.train.optim import build_optimizer
from yolo_ms_tpu_torch.train.trainer import Trainer, TrainState, make_train_step
from yolo_ms_tpu_torch.utils.checkpoint import save_checkpoint
from yolo_ms_tpu_torch.utils.config import Config, SchedulerConfig, TrainingConfig
from yolo_ms_tpu_torch.utils.convert import state_dict_to_variables, train_state_to_state_dicts

IMG, BATCH, NC = 64, 2, 3
EMA_DECAY = 0.9999
START_STEP = 4000  # the EMA ramp d = decay * (1 - exp(-(step+1)/2000)) is ~0.86 here
LOSS_RTOL = 1e-4
STATE_TOL = dict(rtol=1e-3, atol=1e-5)
OPT = dict(batch_size=BATCH, epochs=2, optimizer="sgd", learning_rate=0.02,
           sgd_momentum=0.937, sgd_nesterov=True, weight_decay=5e-4, grad_clip_norm=10.0,
           ema_decay=EMA_DECAY)
SCHED = dict(type="cosine", warmup_steps=2)


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    """Two intra-op threads for torch: beside the JAX runtime's own thread
    pool in this process, torch's default of one OpenMP thread per core
    oversubscribes the cores and the file runs several times slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _port_initial_model():
    model = build_model("n", num_classes=NC, device="cpu")
    return init_model(model, torch.Generator().manual_seed(0))


def _batches(n=3):
    """Seeded float images (pre-normalized, as the JAX unit tests feed) and
    GT boxes large enough to have positives at init."""
    rng = np.random.default_rng(0)
    out = []
    for _ in range(n):
        c = rng.uniform(0.35, 0.65, (BATCH, 4, 2))
        wh = rng.uniform(0.5, 0.9, (BATCH, 4, 2))
        mask = np.zeros((BATCH, 4), bool)
        mask[:, :2] = True
        mask[1, 2] = True
        out.append({
            "images": rng.standard_normal((BATCH, IMG, IMG, 3)).astype(np.float32),
            "boxes": np.concatenate([c, wh], -1).astype(np.float32),
            "labels": rng.integers(0, NC, (BATCH, 4)).astype(np.int32),
            "mask": mask,
        })
    return out


def _torch_batch(b):
    return {k: torch.from_numpy(np.array(v)) for k, v in b.items()}


def _port_setup():
    model = _port_initial_model()
    cfg = TrainingConfig(**OPT)
    cfg.scheduler = SchedulerConfig(**SCHED)
    tx, _ = build_optimizer(cfg, 4)
    state = TrainState.create(model, tx, ema=True)
    state.step.fill_(START_STEP)
    step = make_train_step(DetectionLoss(num_classes=NC), tx, EMA_DECAY, torch.float32)
    return state, step


@pytest.fixture(scope="module")
def jax_run():
    """The JAX step from the port's initial weights: the states after each
    of three steps, and the two NaN-guard cases from the state after one."""
    variables = state_dict_to_variables(_port_initial_model().state_dict())
    params = jax.tree_util.tree_map(jnp.asarray, variables["params"])
    stats = jax.tree_util.tree_map(jnp.asarray, variables["batch_stats"])
    cfg = JaxTrainingConfig(**OPT)
    from yolo_ms_tpu.utils.config import SchedulerConfig as JaxSched

    cfg.scheduler = JaxSched(**SCHED)
    tx, _ = jax_build_optimizer(cfg, 4, params=params)
    model = jax_build_model("n", num_classes=NC)
    step = jax.jit(jax_make_train_step(model, JaxLoss(num_classes=NC), tx, ema_decay=EMA_DECAY))
    state = JaxState(params=params, batch_stats=stats, opt_state=tx.init(params),
                     step=jnp.int32(START_STEP), rng=jax.random.PRNGKey(0),
                     ema_params=params, ema_batch_stats=stats)
    states, metrics = [], []
    for b in _batches():
        state, m = step(state, {k: jnp.asarray(v) for k, v in b.items()})
        states.append(jax.device_get(state))
        metrics.append(jax.device_get(m))
    bad = {}
    for case in ("nan_pixel", "constant_images"):
        b = dict(_batches()[1])
        b["images"] = b["images"].copy()
        if case == "nan_pixel":
            b["images"][0, 0, 0, 0] = np.nan
        else:
            b["images"][:] = 0.0
        _, m = step(jax.device_put(states[0]), {k: jnp.asarray(v) for k, v in b.items()})
        bad[case] = (b, jax.device_get(m))
    return states, metrics, bad


def _assert_state_matches(port_state, jax_state, label):
    want_model, want_ema = train_state_to_state_dicts(jax_state)
    for got_sd, want_sd, which in ((port_state.model.state_dict(), want_model, "model"),
                                   (port_state.ema.state_dict(), want_ema, "ema")):
        for key, want in want_sd.items():
            if key.endswith("num_batches_tracked"):
                continue
            np.testing.assert_allclose(got_sd[key].numpy(), want.numpy(),
                                       err_msg=f"{label} {which} {key}", **STATE_TOL)
    assert int(port_state.step) == int(jax_state.step)


def test_one_and_three_steps_match_make_train_step(jax_run):
    states, metrics, _ = jax_run
    port_state, step = _port_setup()
    for i, b in enumerate(_batches()):
        m = step(port_state, _torch_batch(b))
        want = metrics[i]
        assert float(m["skipped_nonfinite"]) == float(want["skipped_nonfinite"]) == 0.0
        assert int(m["num_fg"]) == int(want["num_fg"]) > 0
        for k in ("loss_box", "loss_cls", "loss_dfl", "total_loss"):
            np.testing.assert_allclose(float(m[k]), float(want[k]), rtol=LOSS_RTOL,
                                       err_msg=f"step {i + 1} {k}")
        if i in (0, 2):  # after one step and after three
            _assert_state_matches(port_state, states[i], f"after step {i + 1}")
    # the warmup's first update used lr 0; the later ones moved the weights
    p0 = _port_initial_model().state_dict()["backbone.conv0.conv.weight"]
    assert not torch.equal(port_state.model.state_dict()["backbone.conv0.conv.weight"], p0)


@pytest.mark.parametrize("case", ["nan_pixel", "constant_images"])
def test_nan_guard_matches_and_freezes_the_state(jax_run, case):
    _, _, bad = jax_run
    batch, want = bad[case]
    port_state, step = _port_setup()
    step(port_state, _torch_batch(_batches()[0]))
    before = {
        "params": port_state.params.clone(), "stats": port_state.stats.clone(),
        "ema_params": port_state.ema_params.clone(), "ema_stats": port_state.ema_stats.clone(),
        **{f"opt_{k}": v.clone() for k, v in port_state.opt_state.items()},
    }
    m = step(port_state, _torch_batch(batch))
    assert float(want["skipped_nonfinite"]) == 1.0
    assert float(m["skipped_nonfinite"]) == 1.0
    if case == "constant_images":  # every loss term finite, the gradients not
        assert np.isfinite(float(want["total_loss"]))
        assert np.isfinite(float(m["total_loss"]))
    after = {
        "params": port_state.params, "stats": port_state.stats,
        "ema_params": port_state.ema_params, "ema_stats": port_state.ema_stats,
        **{f"opt_{k}": v for k, v in port_state.opt_state.items()},
    }
    for k, v in before.items():
        assert torch.equal(after[k], v), k
        if v.is_floating_point():
            assert torch.isfinite(after[k]).all(), k
    assert int(port_state.step) == START_STEP + 2  # the count still advances


def test_gt_bucket_slicing_is_exact():
    """A [B, 16]-padded GT batch and its [B, 4] slice give the same step."""
    b = _batches()[0]
    wide = dict(b)
    pad = 12
    wide["boxes"] = np.concatenate([b["boxes"], np.full((BATCH, pad, 4), 0.25, np.float32)], 1)
    wide["labels"] = np.concatenate([b["labels"], np.ones((BATCH, pad), np.int32)], 1)
    wide["mask"] = np.concatenate([b["mask"], np.zeros((BATCH, pad), bool)], 1)
    s_wide, step = _port_setup()
    m_wide = step(s_wide, _torch_batch(wide))
    s_slim, step = _port_setup()
    m_slim = step(s_slim, _torch_batch(b))
    assert int(m_wide["num_fg"]) == int(m_slim["num_fg"])
    np.testing.assert_allclose(float(m_wide["total_loss"]), float(m_slim["total_loss"]),
                               rtol=1e-6)
    torch.testing.assert_close(s_wide.params, s_slim.params, rtol=1e-6, atol=1e-7)
    torch.testing.assert_close(s_wide.stats, s_slim.stats, rtol=1e-6, atol=1e-7)


def test_bucket_gt_picks_covering_bucket():
    """As the JAX ``_bucket_gt``: the highest USED slot decides; no covering
    bucket leaves the full width; an empty batch takes the smallest."""
    rng = np.random.default_rng(0)
    host = {
        "images": rng.standard_normal((2, 8, 8, 3)).astype(np.float32),
        "boxes": rng.random((2, 16, 4)).astype(np.float32),
        "labels": np.zeros((2, 16), np.int32),
        "mask": np.zeros((2, 16), bool),
    }
    fake = SimpleNamespace(_gt_buckets=(4, 8))
    host["mask"][1, 5] = True
    out = Trainer._bucket_gt(fake, host)
    assert out["boxes"].shape[1] == 8 and out["mask"][1, 5]
    host["mask"][0, 9] = True
    assert Trainer._bucket_gt(fake, host)["boxes"].shape[1] == 16
    host["mask"][:] = False
    assert Trainer._bucket_gt(fake, host)["boxes"].shape[1] == 4
    assert Trainer._bucket_gt(SimpleNamespace(_gt_buckets=()), host)["boxes"].shape[1] == 16


def test_init_matches_flax_init():
    port = state_dict_to_variables(_port_initial_model().state_dict())
    jmodel = jax_build_model("n", num_classes=NC)
    shapes = jax.eval_shape(functools.partial(jmodel.init, train=False),
                            jax.random.PRNGKey(0), jnp.zeros((1, IMG, IMG, 3)))
    want_tree = jax.tree_util.tree_map(lambda s: s.shape, shapes)
    got_tree = jax.tree_util.tree_map(lambda a: a.shape, port)
    assert got_tree == want_tree

    # kernels: z = w * sqrt(fan_in) follows flax's lecun_normal law (a unit
    # normal truncated at 2 sigma, rescaled to std 1)
    flat = jax.tree_util.tree_flatten_with_path(port["params"])[0]
    kernels = [(p, a) for p, a in flat if p[-1].key == "kernel"]
    port_z = np.concatenate([a.ravel() * np.sqrt(np.prod(a.shape[:3])) for _, a in kernels])
    # flax's draw of as many values in one [n, 1] kernel (fan-in n): one
    # compile instead of one per kernel shape
    n = port_z.size
    drawn = fnn.initializers.lecun_normal()(jax.random.PRNGKey(0), (n, 1), jnp.float32)
    flax_z = np.asarray(drawn).ravel() * np.sqrt(n)
    assert port_z.size > 1e6
    bound = 2.0 / 0.87962566103423978
    for z in (port_z, flax_z):
        assert abs(z.std() - 1.0) < 0.01 and abs(z.mean()) < 0.01
        assert np.abs(z).max() <= bound * (1 + 1e-5) and np.abs(z).max() > 0.99 * bound
    assert abs(np.mean(np.abs(port_z)) - np.mean(np.abs(flax_z))) < 0.005

    # biases, BatchNorm and the head priors: flax's constants
    from yolo_ms_tpu.models.yolo import DetectHead

    head = DetectHead(version="n", num_classes=NC)
    feats = [jnp.zeros((1, IMG // s, IMG // s, c)) for s, c in zip((8, 16, 32), (64, 128, 256))]
    head_vars = jax.device_get(head.init(jax.random.PRNGKey(0), feats, train=False))
    for path, a in flat:
        keys = [k.key for k in path]
        if keys[-1] == "bias" and keys[-2] == "pred":
            node = head_vars["params"]
            for k in keys[1:]:
                node = node[k]
            np.testing.assert_array_equal(a, np.asarray(node), err_msg="/".join(keys))
        elif keys[-1] == "bias":
            assert not a.any(), "/".join(keys)
        elif keys[-1] == "scale":
            assert (a == 1).all(), "/".join(keys)
    for path, a in jax.tree_util.tree_flatten_with_path(port["batch_stats"])[0]:
        assert (a == (0.0 if path[-1].key == "mean" else 1.0)).all()


# ------------------------------------------------------------- Trainer


@pytest.fixture(scope="module")
def coco(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("trainer"))
    images, ann = make_coco_dataset(root, num_images=8, num_classes=2, img_w=96, img_h=96)
    return root, images, ann


def _cfg(coco, name, **training):
    root, images, ann = coco
    t = {
        "batch_size": 4, "epochs": 2, "learning_rate": 1e-3, "optimizer": "sgd",
        "weight_decay": 5e-4, "grad_clip_norm": 10.0, "ema_decay": 0.9999,
        "val_interval": 2, "save_period": 1, "experiment_name": name,
        "log_dir": os.path.join(root, "runs"), "augmentation": {"fliplr": 0.5, "mosaic": 0.5},
        "scheduler": {"type": "cosine", "warmup_steps": 1},
    }
    t.update(training)
    return Config.from_dict({
        "dataset": {"train_images_path": images, "train_annotations_path": ann,
                    "val_images_path": images, "val_annotations_path": ann,
                    "num_classes": 2, "max_gt": 8, "gt_buckets": [4]},
        "model": {"architecture": "n", "input_size": [IMG, IMG]},
        "training": t,
        "evaluation": {"batch_size": 4, "confidence_threshold": 0.001},
        "workers": 2,
        "device": "cpu",
    })


class _Stop(Exception):
    pass


def _record(trainer, stop_after=None, save=None):
    """Wrap the trainer's step to record each step's total loss; optionally
    save a mid-epoch checkpoint and stop after ``stop_after`` steps."""
    losses = []
    inner = trainer._train_step
    steps_per_epoch = len(trainer.train_loader)

    def step(state, batch):
        m = inner(state, batch)
        losses.append(float(m["total_loss"]))
        if stop_after is not None and len(losses) == stop_after:
            done = trainer.start_epoch * steps_per_epoch + trainer.start_step + len(losses)
            save_checkpoint(save, trainer.checkpoint(done // steps_per_epoch,
                                                     done % steps_per_epoch))
            raise _Stop
        return m

    trainer._train_step = step
    return losses


def test_resume_at_epoch_end_and_mid_epoch(coco):
    root = coco[0]
    full = Trainer(_cfg(coco, "full"), verbose=False)
    want = _record(full)
    full.fit()
    assert len(want) == 4 and int(full.state.step) == 4
    wdir = os.path.join(root, "runs", "full", "weights")
    assert {"last.ckpt", "epoch_1.ckpt", "epoch_2.ckpt", "best.ckpt",
            "best_metric.json"} <= set(os.listdir(wdir))

    # at an epoch end: epoch_1.ckpt holds the state after epoch 1
    resumed = Trainer(_cfg(coco, "resume_epoch"), verbose=False)
    resumed.resume(os.path.join(wdir, "epoch_1.ckpt"))
    assert (resumed.start_epoch, resumed.start_step, int(resumed.state.step)) == (1, 0, 2)
    got = _record(resumed)
    resumed.fit()
    np.testing.assert_allclose(got, want[2:], rtol=1e-6)
    torch.testing.assert_close(resumed.state.params, full.state.params, rtol=1e-6, atol=1e-7)
    torch.testing.assert_close(resumed.state.ema_stats, full.state.ema_stats, rtol=1e-6,
                               atol=1e-7)

    # mid-epoch: stopped after the third step (epoch 2, step 1)
    mid = os.path.join(root, "mid.ckpt")
    cut = Trainer(_cfg(coco, "cut"), verbose=False)
    _record(cut, stop_after=3, save=mid)
    with pytest.raises(_Stop):
        cut.fit()
    again = Trainer(_cfg(coco, "resume_mid"), verbose=False)
    again.resume(mid)
    assert (again.start_epoch, again.start_step, int(again.state.step)) == (1, 1, 3)
    got = _record(again)
    again.fit()
    np.testing.assert_allclose(got, want[3:], rtol=1e-6)
    torch.testing.assert_close(again.state.params, full.state.params, rtol=1e-6, atol=1e-7)
    assert np.isfinite(again.validate())


def test_train_cli_on_a_yaml(coco):
    from yolo_ms_tpu_torch.tools.train import main

    root = coco[0]
    cfg = _cfg(coco, "cli", epochs=1, val_interval=1)
    path = os.path.join(root, "cli.yaml")
    cfg.save(path)
    main(["--config", path])
    ckpt = os.path.join(root, "runs", "cli", "weights", "last.ckpt")
    assert os.path.exists(ckpt)
    assert os.path.exists(os.path.join(root, "runs", "cli", "config.yaml"))
    main(["--config", path, "--resume", ckpt])  # epoch 1 of 1 done: nothing left to run
    with pytest.raises(SystemExit):
        main(["--config", os.path.join(root, "missing.yaml")])


def test_device_rule(coco):
    """Any device but "cpu" means the card; without one the Trainer raises."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    for device in ("cuda", "tpu"):
        cfg = _cfg(coco, "dev")
        cfg.device = device
        with pytest.raises(RuntimeError, match="CUDA"):
            Trainer(cfg, verbose=False)
    assert Trainer(_cfg(coco, "dev_cpu"), verbose=False).device.type == "cpu"


def test_pretrained_npz_and_checkpoint_merge(coco, tmp_path):
    """Flax-layout .npz weights and the port's own checkpoints load through
    the non-strict, shape-checked merge."""
    src = Trainer(_cfg(coco, "src", seed=7), verbose=False)
    variables = state_dict_to_variables(src.state.model.state_dict())
    flat = {}
    for coll, tree in variables.items():
        for path, a in jax.tree_util.tree_flatten_with_path(tree)[0]:
            flat["/".join([coll] + [k.key for k in path])] = a
    flat["params/head/cls_0/pred/bias"] = np.zeros(5, np.float32)  # shape mismatch: skipped
    npz = str(tmp_path / "w.npz")
    np.savez(npz, **flat)
    dst = Trainer(_cfg(coco, "dst", pretrained_weights=npz), verbose=False)
    got, want = dst.state.model.state_dict(), src.state.model.state_dict()
    assert torch.equal(got["backbone.conv0.conv.weight"], want["backbone.conv0.conv.weight"])
    assert not torch.equal(got["head.cls_0.pred.bias"], torch.zeros(2))  # kept its own
    ckpt = str(tmp_path / "own.ckpt")
    save_checkpoint(ckpt, src.checkpoint(0, 0))
    dst2 = Trainer(_cfg(coco, "dst2", pretrained_weights=ckpt), verbose=False)
    assert torch.equal(dst2.state.params, src.state.params)
    assert torch.equal(dst2.state.ema_params, src.state.params)  # EMA starts at the weights
    # a reference-format .pt goes through the key mapping (utils/checkpoint.py)
    from tests.test_torch_tools import reference_state_dict

    pt = str(tmp_path / "ref.pt")
    torch.save({"model": reference_state_dict(npz)}, pt)
    dst3 = Trainer(_cfg(coco, "dst3", pretrained_weights=pt), verbose=False)
    got = dst3.state.model.state_dict()
    assert torch.equal(got["backbone.conv0.conv.weight"], want["backbone.conv0.conv.weight"])
    assert not torch.equal(got["head.cls_0.pred.bias"], torch.zeros(2))  # kept its own


def test_mean_average_precision_equals_jax():
    rng = np.random.default_rng(5)
    thresholds = [0.5 + 0.05 * i for i in range(10)]
    port, jax_map = MeanAveragePrecision(iou_thresholds=thresholds), JaxMAP(
        iou_thresholds=thresholds)
    for _ in range(3):
        preds, targets = [], []
        for _ in range(4):
            n, m = int(rng.integers(0, 12)), int(rng.integers(0, 6))
            gt = rng.uniform(0, 50, (m, 2))
            gt = np.concatenate([gt, gt + rng.uniform(5, 40, (m, 2))], -1).astype(np.float32)
            det = np.concatenate([gt[: n // 2] + rng.normal(0, 3, (min(n // 2, m), 4)),
                                  rng.uniform(0, 80, (n - min(n // 2, m), 4))]).astype(np.float32)
            det[:, 2:] = np.maximum(det[:, 2:], det[:, :2] + 1)
            preds.append({"boxes": det, "scores": rng.random(len(det)).astype(np.float32),
                          "labels": rng.integers(0, 3, len(det))})
            targets.append({"boxes": gt, "labels": rng.integers(0, 3, m)})
        port.update(preds, targets)
        jax_map.update(preds, targets)
    got, want = port.compute(), jax_map.compute()
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]), err_msg=k)
    assert 0.0 < want["map_50"] < 1.0


def test_chip_smoke_recipe_is_the_yaml(tmp_path):
    """``chip_smoke.py`` trains yolo-ms-xs from ``coco_yolo_ms.json``, which
    is byte for byte what ``Config.save`` writes for ``coco_yolo_ms.yaml``
    (the card machine has no PyYAML). After editing the YAML, regenerate it
    with ``load_config(yaml).save(json)``."""
    import chip_smoke
    from yolo_ms_tpu_torch.utils.config import load_config

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    configs = os.path.join(root, "yolo_ms_tpu_torch", "configs")
    assert chip_smoke.COCO_YOLO_MS == os.path.join(configs, "coco_yolo_ms.json")
    saved = str(tmp_path / "coco_yolo_ms.json")
    load_config(os.path.join(configs, "coco_yolo_ms.yaml")).save(saved)
    with open(saved) as want, open(chip_smoke.COCO_YOLO_MS) as got:
        assert got.read() == want.read()
