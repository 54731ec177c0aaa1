"""CUDA-only tests of the port: the hand-written select kernel against its
plain version, and the kernel tail of ``fused_postprocess`` against the plain
tail, on the card. They skip without a card. This file imports no JAX, so on
a machine without JAX it runs with

    python -m pytest --noconftest -q tests/test_torch_cuda.py
"""

import pytest
import torch

from yolo_ms_tpu_torch.ops.kernels.select import (
    select,
    select_plain,
    select_scales,
    select_scales_plain,
)
from yolo_ms_tpu_torch.ops.postprocess import fused_postprocess

REG_MAX = 16
NB = 4 * REG_MAX
LTRB_ATOL = {torch.float32: 1e-5, torch.bfloat16: 1e-4}
# the serving scales at 640 px, and ragged / misaligned ones: HW 400 is not a
# multiple of the tile, and HW 49 and 25 rows are not 16-byte aligned
SCALE_SETS = {"serving": [80, 40, 20], "ragged": [20, 7, 5]}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    return gen


def _views(gen, b, h, w, nc, dtype, layout):
    if layout == "nchw":
        m = torch.randn(b, NB + nc, h, w, generator=gen, device="cuda") * 2.0
        v = m.to(dtype).permute(0, 2, 3, 1).flatten(1, 2)
    else:
        v = (torch.randn(b, h * w, NB + nc, generator=gen, device="cuda") * 2.0).to(dtype)
    if layout == "split":
        return v[..., :NB].contiguous(), v[..., NB:].contiguous()
    return v[..., :NB], v[..., NB:]


def _assert_equal_to_plain(got, want, dtype):
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0])
    assert torch.equal(got[1], want[1])
    assert (got[2] - want[2]).abs().max().item() <= LTRB_ATOL[dtype]


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["split", "unsplit", "nchw"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hw_side,nc", [(80, 80), (40, 3), (20, 80), (7, 5)])
def test_kernel_matches_plain(card, hw_side, nc, dtype, layout):
    box, cls = _views(card, 4, hw_side, hw_side, nc, dtype, layout)
    before = select.launches
    got = select(box, cls, REG_MAX)
    assert select.launches == before + 1
    _assert_equal_to_plain(got, select_plain(box, cls, REG_MAX), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["split", "unsplit", "nchw"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("nc", [80, 3])
@pytest.mark.parametrize("scales", list(SCALE_SETS))
def test_scales_match_plain(card, scales, nc, dtype, layout):
    pairs = [_views(card, 4, s, s, nc, dtype, layout) for s in SCALE_SETS[scales]]
    before = select.launches
    got = select_scales(pairs, REG_MAX)
    assert select.launches == before + 1
    assert got[2].shape == (4, sum(s * s for s in SCALE_SETS[scales]), 4)
    _assert_equal_to_plain(got, select_scales_plain(pairs, REG_MAX), dtype)


@pytest.mark.cuda
def test_copy_routes(card):
    """The NCHW view goes through TMA; aligned channels-last rows through
    16-byte row copies; HW 49 and 134-byte rows element by element."""
    bf16 = torch.bfloat16
    select_scales([_views(card, 2, s, s, 80, bf16, "nchw") for s in (20, 7)], REG_MAX)
    assert select_scales.last_routes == [("tma", "tma"), ("elements", "elements")]
    select_scales([_views(card, 2, 20, 20, 80, bf16, layout) for layout in ("split", "unsplit")],
                  REG_MAX)
    assert select_scales.last_routes == [("rows", "rows")] * 2
    select(*_views(card, 2, 20, 20, 3, bf16, "unsplit"), REG_MAX)
    assert select_scales.last_routes == [("elements", "elements")]


@pytest.mark.cuda
def test_rejects_strides_without_a_unit_one(card):
    box = torch.zeros(2, 64, 2 * NB, device="cuda")[..., ::2]  # strides (8192, 128, 2)
    cls = torch.zeros(2, 64, 80, device="cuda")
    with pytest.raises(ValueError, match="stride of 1"):
        select(box, cls, REG_MAX)


@pytest.mark.cuda
def test_kernel_ties_and_extremes(card):
    for dtype in (torch.float32, torch.bfloat16):
        flat = torch.zeros(1, 16, NB + 8, device="cuda", dtype=dtype)
        flat[0, 0, 3] = 100.0
        pairs = [(flat[..., :NB], flat[..., NB:])] * 2
        mx, cid, ltrb = select_scales(pairs, REG_MAX)
        _assert_equal_to_plain((mx, cid, ltrb), select_scales_plain(pairs, REG_MAX), dtype)
        assert int(cid.abs().max()) == 0
        for a in (0, 16):
            assert abs(ltrb[0, a, 0].item() - 3.0) < 1e-4
            assert abs(ltrb[0, a, 1].item() - 7.5) < 1e-4  # trails by 100: clamped flat
        assert torch.isfinite(ltrb).all()


@pytest.mark.cuda
@pytest.mark.parametrize("split", [True, False])
def test_fused_postprocess_kernel_matches_plain(card, split):
    nc = 80
    maps = []
    for h, w in [(16, 16), (8, 8), (4, 4)]:
        box = torch.randn(2, NB, h, w, generator=card, device="cuda") * 1.5
        cls = torch.randn(2, nc, h, w, generator=card, device="cuda") * 1.5
        if split:
            maps.append((box.permute(0, 2, 3, 1), cls.permute(0, 2, 3, 1)))
        else:
            maps.append(torch.cat([box, cls], dim=1).permute(0, 2, 3, 1))
    before = select.launches
    got = fused_postprocess(maps, nc, pre_nms_topk=64, max_det=20)
    assert select.launches == before + 1
    want = fused_postprocess(maps, nc, pre_nms_topk=64, max_det=20, use_kernel=False)
    v = want["valid"]
    assert torch.equal(got["valid"], v)
    assert torch.equal(got["classes"][v], want["classes"][v])
    torch.testing.assert_close(got["scores"][v], want["scores"][v], rtol=1e-5, atol=0)
    torch.testing.assert_close(got["boxes"][v], want["boxes"][v], rtol=0, atol=1e-3)
