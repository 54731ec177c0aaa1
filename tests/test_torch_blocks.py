"""Blocks of the PyTorch port against the flax blocks, at narrow widths.

Each block gets the same random weights (numpy, through the converter) and
the same NHWC input; the port runs NCHW in f32 on the CPU. Both the eval
structure (conv + BN) and the folded deploy structure are compared,
rtol 1e-4 / atol 1e-4.
"""

import functools
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tests.torch_policy  # noqa: F401 - the port's thread policy
from yolo_ms_tpu.models.deploy import fold_batchnorm as jax_fold
from yolo_ms_tpu.nn import blocks as jb
from yolo_ms_tpu_torch.models.deploy import fold_batchnorm, to_deploy_structure
from yolo_ms_tpu_torch.nn import blocks as tb
from yolo_ms_tpu_torch.utils.convert import variables_to_state_dict

TOL = dict(rtol=1e-4, atol=1e-4)

# name -> (flax module, port module, input shapes NHWC, call kwargs, takes train)
CASES = {
    "conv3x3_s2_odd": (
        lambda: jb.ConvBnSiLU(16, 3, 2), lambda: tb.ConvBnSiLU(8, 16, 3, 2),
        [(2, 15, 15, 8)], {}, True,
    ),
    "conv_grouped": (
        lambda: jb.ConvBnSiLU(16, 3, groups=4), lambda: tb.ConvBnSiLU(8, 16, 3, groups=4),
        [(2, 12, 12, 8)], {}, True,
    ),
    "conv_depthwise_k5": (
        lambda: jb.ConvBnSiLU(16, 5, groups=16), lambda: tb.ConvBnSiLU(16, 16, 5, groups=16),
        [(2, 12, 12, 16)], {}, True,
    ),
    "conv1x1_no_act": (
        lambda: jb.ConvBnSiLU(12, 1, act=False), lambda: tb.ConvBnSiLU(8, 12, 1, act=False),
        [(2, 9, 9, 8)], {}, True,
    ),
    "bottleneck": (
        lambda: jb.Bottleneck(16), lambda: tb.Bottleneck(16),
        [(2, 12, 12, 16)], {}, True,
    ),
    "c2f": (
        lambda: jb.C2f(32, 2), lambda: tb.C2f(16, 32, 2),
        [(2, 12, 12, 16)], {}, True,
    ),
    "c2f_no_shortcut": (
        lambda: jb.C2f(16, 1, shortcut=False), lambda: tb.C2f(24, 16, 1, shortcut=False),
        [(2, 10, 10, 24)], {}, True,
    ),
    "sppf": (
        lambda: jb.SPPF(24, 5), lambda: tb.SPPF(32, 24, 5),
        [(2, 12, 12, 32)], {}, True,
    ),
    "squeeze_excite": (
        lambda: jb.SqueezeExcite(16), lambda: tb.SqueezeExcite(16),
        [(2, 8, 8, 16)], {}, False,
    ),
    "inverted_bottleneck_se_k7": (
        lambda: jb.InvertedBottleneck(16, 7, use_se=True),
        lambda: tb.InvertedBottleneck(12, 16, 7, use_se=True),
        [(2, 14, 14, 12)], {}, True,
    ),
    "msblock_k5": (
        lambda: jb.MSBlock(24, kernel_size=5), lambda: tb.MSBlock(16, 24, 5),
        [(2, 12, 12, 16)], {}, True,
    ),
    "msblock_v8ms_widths": (
        lambda: jb.MSBlock(30, kernel_size=3, branch_ratio=1.25, expansion=3.0),
        lambda: tb.MSBlock(20, 30, 3, branch_ratio=1.25, expansion=3.0),
        [(2, 10, 10, 20)], {}, True,
    ),
    "mssppf": (
        lambda: jb.MSSPPF(24), lambda: tb.MSSPPF(32, 24),
        [(2, 12, 12, 32)], {}, True,
    ),
    "msfusion_upsample": (
        lambda: jb.MSFusion(16), lambda: tb.MSFusion(20, 16),
        [(2, 8, 8, 12), (2, 16, 16, 8)], {"upsample_a": True}, True,
    ),
    "msfusion": (
        lambda: jb.MSFusion(16), lambda: tb.MSFusion(20, 16),
        [(2, 8, 8, 12), (2, 8, 8, 8)], {}, True,
    ),
}


def _randomize(variables, rng):
    """Replace every leaf with seeded numpy values (BN stats away from the
    identity so the fold is exercised)."""

    def fill(tree):
        out = {}
        for k, v in tree.items():
            if not hasattr(v, "shape"):
                out[k] = fill(v)
                continue
            shape = v.shape
            if k == "kernel":
                new = rng.standard_normal(shape) / np.sqrt(np.prod(shape[:3]))
            elif k in ("scale", "var"):
                new = rng.uniform(0.5, 1.5, shape)
            else:
                new = rng.normal(0.0, 0.1, shape)
            out[k] = new.astype(np.float32)
        return out

    return {c: fill(t) for c, t in variables.items()}


@pytest.mark.parametrize("deploy", [False, True], ids=["eval", "deploy"])
@pytest.mark.parametrize("name", sorted(CASES))
def test_block_matches_flax(name, deploy):
    flax_ctor, torch_ctor, shapes, kw, takes_train = CASES[name]
    rng = np.random.default_rng(zlib.crc32(name.encode()))
    xs = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    jkw = dict(kw, train=False) if takes_train else dict(kw)
    fmod = flax_ctor()
    # the flax tree's shapes without running init; values from numpy
    shapes_tree = jax.eval_shape(
        functools.partial(fmod.init, **jkw), jax.random.PRNGKey(0), *map(jnp.asarray, xs)
    )
    variables = _randomize(shapes_tree, rng)
    apply = functools.partial(fmod.apply, **jkw)
    sd = variables_to_state_dict(variables)
    tmod = torch_ctor()
    if deploy:
        # the JAX fold looks for conv+bn below the root, so nest one level
        jvars = jax_fold({c: {"m": t} for c, t in variables.items()})
        jvars = {"params": jvars["params"]["m"]}
        with jb.deploy_mode():
            want = apply(jvars, *map(jnp.asarray, xs))
        sd = fold_batchnorm(sd)
        to_deploy_structure(tmod)
    else:
        want = apply(variables, *map(jnp.asarray, xs))
    tmod.load_state_dict(sd, strict=True)
    tmod.eval()
    with torch.no_grad():
        got = tmod(*(torch.from_numpy(x).permute(0, 3, 1, 2) for x in xs), **kw)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), np.asarray(want), **TOL)


def test_maxpool_same_pads_with_neg_inf_and_upsample2x():
    x = -np.abs(np.random.default_rng(0).standard_normal((2, 7, 9, 3))).astype(np.float32) - 1
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    for window in (3, 5):
        want = np.asarray(jb.maxpool_same(jnp.asarray(x), window))
        got = tb.maxpool_same(xt, window).permute(0, 2, 3, 1).numpy()
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        tb.upsample2x(xt).permute(0, 2, 3, 1).numpy(),
        np.asarray(jb.upsample2x(jnp.asarray(x))),
    )


def test_dfl_expectation_adversarial():
    """Shared row-max shift with the -60 clamp, not a per-side softmax: a
    +100 bin pins its side to that bin, and a side trailing by more than 60
    is clamped flat (expectation 7.5 for 16 bins)."""
    rng = np.random.default_rng(1)
    dist = (rng.standard_normal((2, 5, 4, 16)) * 3.0).astype(np.float32)
    dist[0, 0] = 0.0
    dist[0, 0, 0, 3] = 100.0  # side 0 -> bin 3; sides 1-3 trail by 100
    dist[1, 2, 2, 11] = 100.0
    got = tb.dfl_expectation(torch.from_numpy(dist)).numpy()
    want = np.asarray(jb.dfl_expectation(jnp.asarray(dist)))
    np.testing.assert_allclose(got, want, **TOL)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got[0, 0], [3.0, 7.5, 7.5, 7.5], atol=1e-5)
    assert abs(got[1, 2, 2] - 11.0) < 1e-5


def test_yolo_params_and_bn_constants():
    for v in ("n", "s", "m", "l", "x"):
        assert tb.yolo_params(v) == jb.yolo_params(v)
    assert tb.BN_EPS == jb.BN_EPS
    assert abs(tb.BN_MOMENTUM - (1 - jb.BN_MOMENTUM)) < 1e-12
    with pytest.raises(ValueError):
        tb.yolo_params("q")


TRAIN_CASES = ("conv3x3_s2_odd", "conv_depthwise_k5", "c2f", "msblock_k5", "msfusion_upsample")


@pytest.mark.parametrize("name", TRAIN_CASES)
def test_block_train_mode_matches_flax(name):
    """Train mode: the output is normalized with the batch statistics, and
    the running statistics move as flax's do (decay 0.97, the BIASED batch
    variance); outputs and new statistics rtol/atol 1e-4, gradients of the
    output sum w.r.t. the input too."""
    flax_ctor, torch_ctor, shapes, kw, _ = CASES[name]
    rng = np.random.default_rng(zlib.crc32(name.encode()) + 1)
    xs = [rng.standard_normal(s).astype(np.float32) * 2.0 + 0.5 for s in shapes]
    fmod = flax_ctor()
    shapes_tree = jax.eval_shape(
        functools.partial(fmod.init, train=False, **kw), jax.random.PRNGKey(0),
        *map(jnp.asarray, xs)
    )
    variables = _randomize(shapes_tree, rng)

    def jfn(v, *ins):
        out, upd = fmod.apply(v, *ins, train=True, mutable=["batch_stats"], **kw)
        return out.sum(), (out, upd["batch_stats"])

    grad_fn = jax.value_and_grad(jfn, argnums=tuple(range(1, len(xs) + 1)), has_aux=True)
    (_, (want, new_stats)), jgrads = jax.jit(grad_fn)(variables, *map(jnp.asarray, xs))
    tmod = torch_ctor()
    tmod.load_state_dict(variables_to_state_dict(variables), strict=True)
    tmod.train()
    tins = [torch.from_numpy(x).permute(0, 3, 1, 2).requires_grad_(True) for x in xs]
    got = tmod(*tins, **kw)
    got.sum().backward()
    np.testing.assert_allclose(got.detach().permute(0, 2, 3, 1).numpy(), np.asarray(want), **TOL)
    for t, jg in zip(tins, jgrads):
        np.testing.assert_allclose(t.grad.permute(0, 2, 3, 1).numpy(), np.asarray(jg), **TOL)
    want_sd = variables_to_state_dict({"batch_stats": jax.device_get(new_stats)})
    got_sd = tmod.state_dict()
    assert want_sd.keys() <= got_sd.keys()
    for key, val in want_sd.items():
        if key.endswith("num_batches_tracked"):
            continue
        np.testing.assert_allclose(got_sd[key].numpy(), val.numpy(), err_msg=key, **TOL)
        # the statistics moved from their start values
        if key.endswith("running_var"):
            start = variables_to_state_dict(variables)[key]
            assert not torch.allclose(got_sd[key], start)
