"""Models of the PyTorch port against the flax models, with the trained
golden weights (nc=3) at 64 and 160 px.

The three raw maps match flax ``apply`` (rtol/atol 1e-3), the eval decode
matches at the tolerances of tests/test_torch_parity.py (rtol 1e-3 /
atol 2e-2, box relative error < 1e-3), and the BN-folded deploy forward
equals the eval forward.
"""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yolo_ms_tpu.models.decode import decode_predictions as jax_decode
from yolo_ms_tpu.models.registry import MODEL_ZOO as JAX_ZOO
from yolo_ms_tpu.models.registry import build_model as jax_build
from yolo_ms_tpu.models.registry import count_params as jax_count
from yolo_ms_tpu_torch.models.decode import decode_predictions, make_anchors
from yolo_ms_tpu_torch.models.deploy import fold_batchnorm
from yolo_ms_tpu_torch.models.registry import MODEL_ZOO, build_model, count_params
from yolo_ms_tpu_torch.utils.convert import load_npz, variables_to_state_dict

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
CASES = [("n", "trained"), ("yolo-ms-xs", "trained_yolo-ms-xs")]


def _golden_variables(sub):
    out = {}
    with np.load(os.path.join(GOLDEN, sub, "weights.npz")) as z:
        for key in z.files:
            node = out
            parts = key.split("/")
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = z[key]
    return out


def _port_maps(model, x_nhwc):
    with torch.no_grad():
        raw = model(torch.from_numpy(x_nhwc).permute(0, 3, 1, 2))
    return [m.permute(0, 2, 3, 1) for m in raw]


@pytest.mark.parametrize("size", [64, 160])
@pytest.mark.parametrize("arch,sub", CASES)
def test_raw_maps_and_decode_match_flax(arch, sub, size):
    variables = _golden_variables(sub)
    x = np.random.default_rng(size).standard_normal((1, size, size, 3)).astype(np.float32)
    want = jax_build(arch, num_classes=3).apply(variables, jnp.asarray(x), train=False)

    model = build_model(arch, num_classes=3, device="cpu")
    model.load_state_dict(load_npz(os.path.join(GOLDEN, sub, "weights.npz")), strict=True)
    got = _port_maps(model, x)
    assert len(got) == 3
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-3, atol=1e-3)

    ours = decode_predictions(got, 3).numpy()
    ref = np.asarray(jax_decode(want, 3))
    assert ours.shape == ref.shape
    np.testing.assert_allclose(ours, ref, rtol=1e-3, atol=2e-2)
    rel = np.abs(ours[..., :4] - ref[..., :4]).max() / np.abs(ref[..., :4]).max()
    assert rel < 1e-3


@pytest.mark.parametrize("arch,sub", CASES)
def test_deploy_forward_equals_eval_forward(arch, sub):
    sd = load_npz(os.path.join(GOLDEN, sub, "weights.npz"))
    x = np.random.default_rng(7).standard_normal((2, 64, 64, 3)).astype(np.float32)
    eval_model = build_model(arch, num_classes=3, device="cpu")
    eval_model.load_state_dict(sd, strict=True)
    deploy_model = build_model(arch, num_classes=3, device="cpu", deploy=True)
    deploy_model.load_state_dict(fold_batchnorm(sd), strict=True)
    assert not any(".bn." in k for k in deploy_model.state_dict())
    with torch.no_grad():
        split = deploy_model(torch.from_numpy(x).permute(0, 3, 1, 2), split_head=True)
    for w, (box, cls) in zip(_port_maps(eval_model, x), split):
        g = torch.cat([box, cls], dim=1).permute(0, 2, 3, 1)
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("arch,sub", CASES)
def test_count_params_matches_jax(arch, sub):
    model = build_model(arch, num_classes=3, device="cpu")
    assert count_params(model) == jax_count(_golden_variables(sub))


def test_zoo_names_and_anchors():
    assert sorted(MODEL_ZOO) == sorted(JAX_ZOO) and len(MODEL_ZOO) == 20
    with pytest.raises(ValueError, match="Unknown architecture"):
        build_model("yolov9", device="cpu")
    anchors, strides = make_anchors([(4, 6), (2, 3)], (8, 16))
    assert anchors.shape == (30, 2) and strides.shape == (30, 1)
    np.testing.assert_array_equal(anchors[:7].numpy(), [[0.5, 0.5], [1.5, 0.5], [2.5, 0.5],
                                                        [3.5, 0.5], [4.5, 0.5], [5.5, 0.5],
                                                        [0.5, 1.5]])
    assert float(strides[-1]) == 16.0


def test_build_model_needs_cuda_unless_cpu_is_asked():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="CUDA"):
        build_model("n", num_classes=3)
    with pytest.raises(RuntimeError, match="CUDA"):
        build_model("n", num_classes=3, device="cuda")


def _random_variables(jmodel, x, rng):
    tree = jax.eval_shape(functools.partial(jmodel.init, train=False), jax.random.PRNGKey(0), x)

    def fill(t):
        out = {}
        for k, v in t.items():
            if not hasattr(v, "shape"):
                out[k] = fill(v)
            elif k == "kernel":
                out[k] = (rng.standard_normal(v.shape) / np.sqrt(np.prod(v.shape[:3]))).astype(np.float32)
            elif k in ("scale", "var"):
                out[k] = rng.uniform(0.5, 1.5, v.shape).astype(np.float32)
            else:
                out[k] = rng.normal(0.0, 0.1, v.shape).astype(np.float32)
        return out

    return {c: fill(t) for c, t in tree.items()}


@pytest.mark.slow
@pytest.mark.parametrize("arch", sorted(MODEL_ZOO))
def test_zoo_raw_maps_match_flax(arch):
    x = np.random.default_rng(0).standard_normal((1, 64, 64, 3)).astype(np.float32)
    jmodel = jax_build(arch, num_classes=5)
    variables = _random_variables(jmodel, jnp.asarray(x), np.random.default_rng(1))
    want = jmodel.apply(variables, jnp.asarray(x), train=False)
    model = build_model(arch, num_classes=5, device="cpu")
    model.load_state_dict(variables_to_state_dict(variables), strict=True)
    for g, w in zip(_port_maps(model, x), want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-3, atol=1e-3)
