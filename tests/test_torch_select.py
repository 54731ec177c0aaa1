"""The port's per-anchor ``select`` against the JAX Pallas kernel (interpret
mode), on the CPU, where the wrapper runs its plain torch version.

Cases of tests/test_pallas_select.py: random [2, 400, 144] maps in f32 and
bf16 (mx rtol 1e-6, cid equal, ltrb rtol/atol 1e-5), all-equal class logits
(id 0) and a +100 bin (3.0, finite); the inputs fed as a split pair, as
slices of an unsplit map, and as a non-contiguous NCHW permute view; and
``select_scales`` over three scales (HW 64 / 16 / 4; nc 80, 3, the
fine-tune config's 10 and an odd 5) against
the JAX kernel's outputs per scale, concatenated. The CUDA kernel itself is
held against this plain version on the card (tests/test_torch_cuda.py,
chip_smoke.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tests.torch_policy  # noqa: F401 - the port's thread policy
from yolo_ms_tpu.ops.pallas.select import select_scale
from yolo_ms_tpu_torch.ops.kernels.select import select, select_plain, select_scales

NC, REG_MAX = 80, 16
NB = 4 * REG_MAX


def _bf16_exact(x):
    """numpy f32 -> values exactly representable in bf16."""
    return np.array(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))


def _views(flat, layout, h, w):
    """[B, HW, 4*reg_max+nc] torch map -> (box, cls) views in a layout."""
    if layout == "split":
        return flat[..., :NB].contiguous(), flat[..., NB:].contiguous()
    if layout == "unsplit":
        return flat[..., :NB], flat[..., NB:]
    b = flat.shape[0]
    nchw = flat.reshape(b, h, w, -1).permute(0, 3, 1, 2).contiguous()
    view = nchw.permute(0, 2, 3, 1).flatten(1, 2)  # strides (C*HW, 1, HW)
    assert not view.is_contiguous()
    return view[..., :NB], view[..., NB:]


@pytest.mark.parametrize("layout", ["split", "unsplit", "nchw"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_select_matches_pallas_kernel(dtype, layout):
    b, h, w = 2, 20, 20  # HW 400, the P5 map at 640 px
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((b, h * w, NB + NC)) * 2.0).astype(np.float32)
    if dtype == "bfloat16":
        x = _bf16_exact(x)
    want_mx, want_cid, want_ltrb = jax.device_get(
        select_scale(jnp.asarray(x, getattr(jnp, dtype)), NC, REG_MAX, interpret=True)
    )
    flat = torch.from_numpy(x).to(getattr(torch, dtype))
    mx, cid, ltrb = select(*_views(flat, layout, h, w), REG_MAX)
    assert mx.dtype == torch.float32 and cid.dtype == torch.int32
    assert ltrb.dtype == torch.float32 and ltrb.shape == (b, h * w, 4)
    np.testing.assert_allclose(mx.numpy(), want_mx, rtol=1e-6)
    np.testing.assert_array_equal(cid.numpy(), want_cid)
    np.testing.assert_allclose(ltrb.numpy(), want_ltrb, rtol=1e-5, atol=1e-5)


SCALE_SIDES = [(8, 8), (4, 4), (2, 2)]  # HW 64 / 16 / 4


@pytest.mark.parametrize("layout", ["split", "unsplit", "nchw"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("nc", [NC, 3, 10, 5])
def test_select_scales_matches_concatenated_pallas_kernel(nc, dtype, layout):
    """All scales in one call equal the JAX kernel per scale, concatenated."""
    rng = np.random.default_rng(7)
    pairs, want = [], []
    for h, w in SCALE_SIDES:
        x = (rng.standard_normal((2, h * w, NB + nc)) * 2.0).astype(np.float32)
        if dtype == "bfloat16":
            x = _bf16_exact(x)
        want.append(select_scale(jnp.asarray(x, getattr(jnp, dtype)), nc, REG_MAX, interpret=True))
        flat = torch.from_numpy(x).to(getattr(torch, dtype))
        pairs.append(_views(flat, layout, h, w))
    want_mx, want_cid, want_ltrb = (
        np.asarray(jnp.concatenate(parts, axis=1)) for parts in zip(*want)
    )
    mx, cid, ltrb = select_scales(pairs, REG_MAX)
    assert mx.dtype == torch.float32 and cid.dtype == torch.int32
    assert ltrb.dtype == torch.float32 and ltrb.shape == (2, 84, 4)
    np.testing.assert_allclose(mx.numpy(), want_mx, rtol=1e-6)
    np.testing.assert_array_equal(cid.numpy(), want_cid)
    np.testing.assert_allclose(ltrb.numpy(), want_ltrb, rtol=1e-5, atol=1e-5)


def test_select_scales_rejects_mismatched_scales():
    box, cls = torch.zeros(2, 16, NB), torch.zeros(2, 16, NC)
    with pytest.raises(ValueError, match="batch or classes"):
        select_scales([(box, cls), (box[:1, :4], cls[:1, :4])], REG_MAX)  # B differs
    with pytest.raises(ValueError, match="batch or classes"):
        select_scales([(box, cls), (box[:, :4], cls[:, :4, :3])], REG_MAX)  # nc differs
    with pytest.raises(TypeError):
        select_scales([(box, cls), (box[:, :4].bfloat16(), cls[:, :4].bfloat16())], REG_MAX)
    with pytest.raises(ValueError, match="scales"):
        select_scales([], REG_MAX)
    with pytest.raises(ValueError, match="scales"):
        select_scales([(box, cls)] * 5, REG_MAX)


def test_select_ties_and_extremes():
    """First-index argmax on all-equal class logits; one +100 bin -> 3.0."""
    flat = np.zeros((1, 16, NB + 8), np.float32)
    flat[0, 0, 3] = 100.0
    want_mx, want_cid, want_ltrb = jax.device_get(
        select_scale(jnp.asarray(flat), 8, REG_MAX, interpret=True)
    )
    t = torch.from_numpy(flat)
    mx, cid, ltrb = select(t[..., :NB], t[..., NB:], REG_MAX)
    assert int(cid.abs().max()) == 0
    assert abs(float(ltrb[0, 0, 0]) - 3.0) < 1e-4
    assert torch.isfinite(ltrb).all()
    np.testing.assert_array_equal(cid.numpy(), want_cid)
    np.testing.assert_allclose(ltrb.numpy(), want_ltrb, rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(mx.numpy(), want_mx)


def test_select_rejects_bad_inputs():
    box = torch.zeros(2, 10, NB)
    cls = torch.zeros(2, 10, 3)
    with pytest.raises(ValueError):
        select(box[..., :60], cls, REG_MAX)  # not 4*reg_max channels
    with pytest.raises(ValueError):
        select(box, cls[:, :9], REG_MAX)  # anchors disagree
    with pytest.raises(TypeError):
        select(box.half(), cls.half(), REG_MAX)
    with pytest.raises(TypeError):
        select(box, cls.bfloat16(), REG_MAX)
    with pytest.raises(ValueError, match="cuda or cpu"):
        select(box.to("meta"), cls.to("meta"), REG_MAX)


def test_cuda_tensor_without_cuda_raises():
    """No quiet CPU fallback: asking for the card where there is none fails."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises((RuntimeError, AssertionError)):
        box = torch.zeros(1, 4, NB, device="cuda")
        select(box, torch.zeros(1, 4, 3, device="cuda"), REG_MAX)


def test_plain_version_is_the_cpu_path():
    rng = np.random.default_rng(5)
    box = torch.from_numpy(rng.standard_normal((3, 50, NB)).astype(np.float32))
    cls = torch.from_numpy(rng.standard_normal((3, 50, 7)).astype(np.float32))
    before = select.launches
    for a, b in zip(select(box, cls, REG_MAX), select_plain(box, cls, REG_MAX)):
        assert torch.equal(a, b)
    assert select.launches == before  # no kernel launch on the CPU
