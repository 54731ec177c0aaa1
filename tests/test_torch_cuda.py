"""CUDA-only tests of the port: the hand-written select kernel against its
plain version, and the kernel tail of ``fused_postprocess`` against the plain
tail, on the card. They skip without a card. This file imports no JAX, so on
a machine without JAX it runs with

    python -m pytest --noconftest -q tests/test_torch_cuda.py
"""

import pytest
import torch

from yolo_ms_tpu_torch.ops.kernels.select import select, select_plain
from yolo_ms_tpu_torch.ops.postprocess import fused_postprocess

REG_MAX = 16
NB = 4 * REG_MAX
LTRB_ATOL = {torch.float32: 1e-5, torch.bfloat16: 1e-4}


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


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["split", "unsplit", "nchw"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hw_side,nc", [(80, 80), (40, 3), (20, 80), (7, 5)])
def test_kernel_matches_plain(card, hw_side, nc, dtype, layout):
    box, cls = _views(card, 4, hw_side, hw_side, nc, dtype, layout)
    before = select.launches
    mx, cid, ltrb = select(box, cls, REG_MAX)
    assert select.launches == before + 1
    pmx, pcid, pltrb = select_plain(box, cls, REG_MAX)
    torch.cuda.synchronize()
    assert torch.equal(mx, pmx)
    assert torch.equal(cid, pcid)
    assert (ltrb - pltrb).abs().max().item() <= LTRB_ATOL[dtype]


@pytest.mark.cuda
def test_kernel_ties_and_extremes(card):
    flat = torch.zeros(1, 16, NB + 8, device="cuda")
    flat[0, 0, 3] = 100.0
    mx, cid, ltrb = select(flat[..., :NB], flat[..., NB:], REG_MAX)
    assert int(cid.abs().max()) == 0
    assert abs(ltrb[0, 0, 0].item() - 3.0) < 1e-4
    assert abs(ltrb[0, 0, 1].item() - 7.5) < 1e-4  # trails by 100: clamped flat
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
    got = fused_postprocess(maps, nc, pre_nms_topk=64, max_det=20)
    want = fused_postprocess(maps, nc, pre_nms_topk=64, max_det=20, use_kernel=False)
    v = want["valid"]
    assert torch.equal(got["valid"], v)
    assert torch.equal(got["classes"][v], want["classes"][v])
    torch.testing.assert_close(got["scores"][v], want["scores"][v], rtol=1e-5, atol=0)
    torch.testing.assert_close(got["boxes"][v], want["boxes"][v], rtol=0, atol=1e-3)
