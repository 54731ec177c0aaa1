"""The port's optimizer and LR schedules against the JAX package's optax chain.

Schedules: every kind (cosine, step, none) with and without warmup, at every
step, rtol 1e-7. The chain: SGD-nesterov and Adam with clipping, weight
decay, frozen leaves and gradient accumulation, several updates in a row,
the updates and the parameters within rtol 1e-6, plus an atol of 1e-6 times
the largest entry (the flat global norm sums in another order than optax's
per-leaf sums, which moves entries that nearly cancel by a few ulps of the
large ones).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from yolo_ms_tpu.train import optim as jopt
from yolo_ms_tpu.utils.config import TrainingConfig as JaxTrainingConfig
from yolo_ms_tpu_torch.train import optim as topt
from yolo_ms_tpu_torch.utils.config import TrainingConfig, _build, SchedulerConfig

SCHED_TOL = dict(rtol=1e-7, atol=0.0)
CHAIN_RTOL = 1e-6
STEPS_PER_EPOCH = 7


def _cfgs(**kw):
    sched = kw.pop("scheduler", {})
    jc, tc = JaxTrainingConfig(**kw), TrainingConfig(**kw)
    from yolo_ms_tpu.utils.config import SchedulerConfig as JaxSchedulerConfig
    from yolo_ms_tpu.utils.config import _build as jbuild

    jc.scheduler = jbuild(JaxSchedulerConfig, sched)
    tc.scheduler = _build(SchedulerConfig, sched)
    return jc, tc


SCHEDULES = {
    "cosine": {"type": "cosine"},
    "cosine_tmax_etamin": {"type": "cosine", "cosine_t_max": 3, "cosine_eta_min": 1e-4},
    "step": {"type": "step", "step_lr_size": 2, "step_lr_gamma": 0.3},
    "none": {"type": "none"},
}


@pytest.mark.parametrize("warmup", [0, 5])
@pytest.mark.parametrize("kind", sorted(SCHEDULES))
def test_schedule_matches_optax_at_every_step(kind, warmup):
    jc, tc = _cfgs(learning_rate=0.01, epochs=6,
                   scheduler=dict(SCHEDULES[kind], warmup_steps=warmup))
    js = jopt.build_schedule(jc, STEPS_PER_EPOCH)
    ts = topt.build_schedule(tc, STEPS_PER_EPOCH)
    counts = np.arange(6 * STEPS_PER_EPOCH + warmup + 5)
    want = np.asarray([js(jnp.int32(c)) for c in counts], np.float32)
    got = np.asarray([ts(torch.tensor(int(c), dtype=torch.int32)).item() for c in counts],
                     np.float32)
    np.testing.assert_allclose(got, want, **SCHED_TOL)
    if warmup:
        assert got[0] == 0.0  # the first update of a warmup uses lr 0


def _tree(rng):
    """A small flax-like parameter tree: conv kernels, BN scale/bias, a pred
    bias; and its flat order as the port sees it."""
    return {
        "backbone": {
            "conv0": {
                "bn": {"bias": rng.standard_normal(4), "scale": rng.standard_normal(4)},
                "conv": {"kernel": rng.standard_normal((3, 3, 2, 4))},
            },
            "conv1": {"conv": {"kernel": rng.standard_normal((1, 1, 4, 6))}},
        },
        "head": {"box_0": {"pred": {"bias": rng.standard_normal(6),
                                    "kernel": rng.standard_normal((1, 1, 6, 6))}}},
    }


def _paths_and_leaves(tree):
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    paths = ["/".join(str(k.key) for k in p) for p, _ in flat]
    return paths, [np.asarray(v, np.float32) for _, v in flat]


CHAINS = {
    "sgd_nesterov_clip_decay": dict(optimizer="sgd", sgd_momentum=0.937, sgd_nesterov=True,
                                    weight_decay=5e-4, grad_clip_norm=10.0),
    "sgd_plain_momentum": dict(optimizer="sgd", sgd_momentum=0.9, sgd_nesterov=False,
                               weight_decay=0.0, grad_clip_norm=0.0),
    "adam_clip_decay": dict(optimizer="adam", adam_betas=[0.9, 0.999], weight_decay=5e-4,
                            grad_clip_norm=1.0),
    "sgd_freeze": dict(optimizer="sgd", weight_decay=5e-4, grad_clip_norm=3.0,
                       freeze_layers=["backbone.conv0"]),
    "adam_freeze_accum2": dict(optimizer="adam", weight_decay=1e-3, grad_clip_norm=2.0,
                               freeze_layers=["head/box_0"], grad_accum_steps=2),
    "sgd_accum2": dict(optimizer="sgd", weight_decay=5e-4, grad_clip_norm=10.0,
                       grad_accum_steps=2),
}


@pytest.mark.parametrize("name", sorted(CHAINS))
def test_chain_matches_optax(name):
    rng = np.random.default_rng(0)
    kw = dict(CHAINS[name], learning_rate=0.05, epochs=3,
              scheduler={"type": "cosine", "warmup_steps": 2})
    jc, tc = _cfgs(**kw)
    tree = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float32), _tree(rng))
    paths, leaves = _paths_and_leaves(tree)
    tx, _ = jopt.build_optimizer(jc, STEPS_PER_EPOCH, params=tree)
    trainable = None
    if tc.freeze_layers:
        keep = topt.freeze_mask(paths, tc.freeze_layers)
        jmask = jax.tree_util.tree_leaves(jopt.freeze_mask(tree, jc.freeze_layers))
        assert keep == jmask  # the same leaves frozen
        assert not all(keep)
        trainable = torch.cat([torch.full((x.size,), k) for k, x in zip(keep, leaves)])
    port, _ = topt.build_optimizer(tc, STEPS_PER_EPOCH, trainable=trainable)

    j_params, j_state = tree, tx.init(tree)
    t_params = torch.from_numpy(np.concatenate([x.ravel() for x in leaves]))
    t_state = port.init(t_params)
    treedef = jax.tree_util.tree_structure(tree)
    for i in range(7):
        # gradients whose global norm crosses the clip bound both ways
        scale = [0.05, 3.0, 40.0][i % 3]
        g_leaves = [rng.standard_normal(x.shape).astype(np.float32) * scale for x in leaves]
        j_grads = jax.tree_util.tree_unflatten(treedef, [jnp.asarray(g) for g in g_leaves])
        j_up, j_state = tx.update(j_grads, j_state, j_params)
        j_params = optax.apply_updates(j_params, j_up)
        t_grads = torch.from_numpy(np.concatenate([g.ravel() for g in g_leaves]))
        t_up, t_state = port.update(t_grads, t_state, t_params)
        t_params = t_params + t_up
        want_up = np.concatenate([np.asarray(u).ravel() for u in jax.tree_util.tree_leaves(j_up)])
        want_p = np.concatenate([np.asarray(p).ravel() for p in jax.tree_util.tree_leaves(j_params)])
        for got, want, what in ((t_up, want_up, "update"), (t_params, want_p, "params")):
            np.testing.assert_allclose(
                got.numpy(), want, rtol=CHAIN_RTOL, atol=CHAIN_RTOL * np.abs(want).max(),
                err_msg=f"{what} {i}")
    if tc.grad_accum_steps > 1:
        # mini-steps return zero updates; 7 calls apply 3 updates
        assert int(t_state["count"]) == 3
    if trainable is not None:
        frozen = ~trainable
        assert torch.equal(t_params[frozen], torch.from_numpy(
            np.concatenate([x.ravel() for x in leaves]))[frozen])


def test_update_is_functional():
    """``update`` writes nothing in place: the trainer's NaN guard commits
    the new state only when it is finite."""
    _, tc = _cfgs(optimizer="adam", learning_rate=0.1, epochs=1, grad_clip_norm=1.0,
                  weight_decay=1e-3, grad_accum_steps=2)
    port, _ = topt.build_optimizer(tc, 4)
    params = torch.randn(10, generator=torch.Generator().manual_seed(0))
    state = port.init(params)
    before = {k: v.clone() for k, v in state.items()}
    p0 = params.clone()
    for _ in range(2):
        port.update(torch.ones(10), state, params)
    assert torch.equal(params, p0)
    assert all(torch.equal(state[k], before[k]) for k in state)


def test_unknown_optimizer_and_scheduler_raise():
    _, tc = _cfgs(optimizer="lion")
    with pytest.raises(ValueError):
        topt.build_optimizer(tc, 4)
    _, tc = _cfgs(scheduler={"type": "poly"})
    with pytest.raises(ValueError):
        topt.build_schedule(tc, 4)
