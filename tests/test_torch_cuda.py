"""CUDA-only tests of the port: the hand-written select and NMS kernels
against their plain versions (through their wrappers and their
``torch.library`` ops), the serving function with no host read
(``torch.cuda.set_sync_debug_mode("error")``),
the kernel tail of ``fused_postprocess`` against the plain tail, an
exported serving program against ``Predictor.infer``, channels-last
serving (``entry_layouts="auto"``) against the default layout, and the
forward replayed from CUDA graphs (``infer/graphs.py``) against the eager
serving function, on the card.
They skip without a card. This file imports no JAX, so on
a machine without JAX it runs with

    python -m pytest --noconftest -q tests/test_torch_cuda.py
"""

import itertools

import pytest
import torch

import tests.torch_policy  # noqa: F401 - the port's thread policy
from yolo_ms_tpu_torch.ops.kernels.select import (
    expected_routes,
    plan,
    plan_fits,
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
# class counts with a ring of shared memory: around the 16-byte vectors (8
# bf16 or 4 f32 classes), the fine-tune config's 10, VOC's 20, past 255,
# LVIS's 1,203 and the last ring counts (1,730 bf16, 826 f32)
RING_NC = {torch.bfloat16: [1, 3, 5, 10, 20, 79, 81, 255, 1203, 1730],
           torch.float32: [1, 3, 5, 10, 20, 79, 81, 255, 826]}
LR = 0.01  # the train step's learning rate (its first update's, no warmup)


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
    assert select_scales.last_routes == expected_routes(pairs, REG_MAX)
    assert got[2].shape == (4, sum(s * s for s in SCALE_SETS[scales]), 4)
    _assert_equal_to_plain(got, select_scales_plain(pairs, REG_MAX), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["split", "unsplit", "nchw"])
@pytest.mark.parametrize("scales", list(SCALE_SETS))
@pytest.mark.parametrize("dtype,nc", [(dt, nc) for dt, ncs in RING_NC.items() for nc in ncs])
def test_class_rows_of_any_width_match_plain(card, dtype, nc, scales, layout):
    """Class rows that are not 16-byte multiples, staged in the ring: split
    maps at the serving scales take bulk rows for both maps (one byte range
    a tile), whatever the row width; other maps the route ``expected_routes``
    names. Every row walked as head, vectors and tail."""
    pairs = [_views(card, 2, s, s, nc, dtype, layout) for s in SCALE_SETS[scales]]
    assert plan_fits(dtype, nc, REG_MAX)
    got = select_scales(pairs, REG_MAX)
    assert select_scales.last_routes == expected_routes(pairs, REG_MAX)
    if layout == "split" and scales == "serving":
        assert select_scales.last_routes == [("bulk_rows", "bulk_rows")] * 3
    _assert_equal_to_plain(got, select_scales_plain(pairs, REG_MAX), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["split", "unsplit", "nchw"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("nc", [5, 10, 81, 1203])
def test_ties_across_a_rows_head_and_vectors(card, nc, dtype, layout):
    """Anchor a's class row starts (a * nc * elem_bytes) % 16 bytes past a
    16-byte boundary of its tile. Where it starts off one, 2.0 on the last
    class of the scalar head and on the first class of the first vector
    gives the head's; where it starts on one, 2.0 on classes 0 and nc - 1
    gives 0; every third anchor instead holds 3.0 on its last class (the
    tail), which wins. HW 400 and 49; the rest of each row 0."""
    es = torch.empty((), dtype=dtype).element_size()
    pairs = [_views(card, 2, s, s, nc, dtype, layout) for s in (20, 7)]
    want = []
    for _, cls in pairs:
        hw = cls.shape[1]
        vals = torch.zeros(hw, nc)
        ids = torch.empty(hw, dtype=torch.int32)
        for a in range(hw):
            head = min(nc, (16 - a * nc * es % 16) % 16 // es)
            if a % 3 == 2:
                vals[a, nc - 1], ids[a] = 3.0, nc - 1
            elif 0 < head < nc:
                vals[a, head - 1] = vals[a, head] = 2.0
                ids[a] = head - 1
            else:
                vals[a, 0] = vals[a, nc - 1] = 2.0
                ids[a] = 0
        cls.copy_(vals.expand(2, hw, nc).to(device="cuda", dtype=dtype))
        want.append(ids.expand(2, hw))
    got = select_scales(pairs, REG_MAX)
    assert select_scales.last_routes == expected_routes(pairs, REG_MAX)
    _assert_equal_to_plain(got, select_scales_plain(pairs, REG_MAX), dtype)
    assert torch.equal(got[1].cpu(), torch.cat(want, dim=1))


@pytest.mark.cuda
def test_copy_routes(card):
    """The NCHW view goes through TMA; aligned channels-last rows (split or
    unsplit) through asynchronous bulk copies of anchor rows; HW 49 in
    NCHW and 134-byte rows element by element."""
    bf16 = torch.bfloat16
    select_scales([_views(card, 2, s, s, 80, bf16, "nchw") for s in (20, 7)], REG_MAX)
    assert select_scales.last_routes == [("tma", "tma"), ("elements", "elements")]
    select_scales([_views(card, 2, 20, 20, 80, bf16, layout) for layout in ("split", "unsplit")],
                  REG_MAX)
    assert select_scales.last_routes == [("bulk_rows", "bulk_rows")] * 2
    select(*_views(card, 2, 20, 20, 3, bf16, "unsplit"), REG_MAX)
    assert select_scales.last_routes == [("elements", "elements")]


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["split", "unsplit"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_bulk_rows_ragged_tiles(card, dtype, layout):
    """The bulk-rows route on the serving maps' tile edges: HW 6400 (50 full
    tiles of 128) and 400 (3 full, one of 16 anchors) in bf16; in f32 (64
    anchors a tile) 400 ends on 16 too. A packed map's short last tile is
    copied short; its dead rows are never stored."""
    pairs = [_views(card, 3, s, s, 80, dtype, layout) for s in (80, 20)]
    got = select_scales(pairs, REG_MAX)
    assert select_scales.last_routes == [("bulk_rows", "bulk_rows")] * 2
    assert got[0].shape == (3, 6800)
    _assert_equal_to_plain(got, select_scales_plain(pairs, REG_MAX), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("reg_max", [5, 8])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_bulk_rows_scalar_reads(card, dtype, reg_max):
    """Anchor-major tiles whose rows are not whole 16-byte vectors: box
    sides of 5 bins (10 or 20 bytes) and 5-class rows are read element by
    element; sides of 8 bins as vectors."""
    nb = 4 * reg_max
    pairs = []
    for s in (20, 7):
        flat = (torch.randn(2, s * s, nb + 5, generator=card, device="cuda") * 2.0).to(dtype)
        pairs.append((flat[..., :nb].contiguous(), flat[..., nb:].contiguous()))
    got = select_scales(pairs, reg_max)
    assert select_scales.last_routes == expected_routes(pairs, reg_max)
    _assert_equal_to_plain(got, select_scales_plain(pairs, reg_max), dtype)


@pytest.mark.cuda
def test_mixed_layouts_of_one_scale(card):
    """An NCHW box view beside a contiguous NHWC class map: one tile has one
    layout, so the box map is copied element by element, anchor-major."""
    box = (torch.randn(2, NB, 20, 20, generator=card, device="cuda") * 2.0).to(torch.bfloat16)
    cls = (torch.randn(2, 400, 80, generator=card, device="cuda") * 2.0).to(torch.bfloat16)
    pairs = [(box.permute(0, 2, 3, 1).flatten(1, 2), cls)]
    got = select_scales(pairs, REG_MAX)
    assert select_scales.last_routes == [("elements", "bulk_rows")]
    _assert_equal_to_plain(got, select_scales_plain(pairs, REG_MAX), torch.bfloat16)


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
@pytest.mark.parametrize("layout", ["split", "unsplit", "nchw"])
@pytest.mark.parametrize("nc,dtype", [(827, torch.float32), (900, torch.float32),
                                      (1203, torch.float32), (1732, torch.bfloat16)])
def test_wide_route_matches_plain(card, nc, dtype, layout):
    """Class counts whose tiles fit no ring of shared memory (f32 past 826,
    bf16 past 1,730 at reg_max 16; LVIS's 1,203 in f32) take the wide route
    on every map, at ragged scales (HW 400 is not a multiple of its
    256-anchor tile; 49 and 25), one launch for all scales."""
    pairs = [_views(card, 2, s, s, nc, dtype, layout) for s in (20, 7, 5)]
    assert not plan_fits(dtype, nc, REG_MAX)
    before = select.launches
    got = select_scales(pairs, REG_MAX)
    assert select.launches == before + 1
    assert select_scales.last_routes == expected_routes(pairs, REG_MAX) == [("wide", "wide")] * 3
    _assert_equal_to_plain(got, select_scales_plain(pairs, REG_MAX), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["split", "unsplit", "nchw"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_past_256_classes_matches_plain(card, dtype, layout):
    """nc 300 fits a ring, but no TMA or strided bulk rows past 256
    channels: NCHW views and unsplit class slices go element by element."""
    pairs = [_views(card, 2, s, s, 300, dtype, layout) for s in (20, 7)]
    got = select_scales(pairs, REG_MAX)
    assert select_scales.last_routes == expected_routes(pairs, REG_MAX)
    assert "wide" not in {r for pair in select_scales.last_routes for r in pair}
    _assert_equal_to_plain(got, select_scales_plain(pairs, REG_MAX), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["split", "unsplit", "nchw"])
def test_wide_route_class_ids_past_16_bits(card, layout):
    """nc 65,536, HW 16, one image, f32: anchor a's max at class 65,520 + a,
    past the 16-bit ids of the ring's thread groups."""
    box, cls = _views(card, 1, 4, 4, 65536, torch.float32, layout)
    for a in range(16):
        cls[0, a, 65520 + a] = 100.0
    got = select(box, cls, REG_MAX)
    assert select_scales.last_routes == [("wide", "wide")]
    _assert_equal_to_plain(got, select_plain(box, cls, REG_MAX), torch.float32)
    assert got[1][0].tolist() == [65520 + a for a in range(16)]


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["split", "unsplit", "nchw"])
@pytest.mark.parametrize("nc", [900, 901])
def test_wide_route_ties_across_lanes(card, nc, layout):
    """Ties on the wide route (nc 900: rows read as 16-byte vectors where
    channels-last; 901: element by element): a row of one value gives class
    0, and 1.0 at classes 500, 77 and 13 (other lanes of the warp, other
    vectors) gives 13, as ``argmax`` does."""
    box, cls = _views(card, 2, 4, 4, nc, torch.float32, layout)
    cls.zero_()
    cls[:, 8:, [500, 77, 13]] = 1.0
    mx, cid, ltrb = select(box, cls, REG_MAX)
    assert select_scales.last_routes == [("wide", "wide")]
    _assert_equal_to_plain((mx, cid, ltrb), select_plain(box, cls, REG_MAX), torch.float32)
    assert cid[:, :8].eq(0).all() and cid[:, 8:].eq(13).all()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,last", [(torch.float32, 826), (torch.bfloat16, 1730)])
def test_plan_route_is_plan_fits(card, dtype, last):
    """``plan`` reports a ring up to the class count where ``plan_fits``
    (the Python rule) says so, and the wide route (256 anchors a tile, no
    stages, no shared memory) past it; it raises for no nc >= 1."""
    for nc in (1, 80, last, last + 1, 65536):
        p = plan(dtype, nc, REG_MAX)
        assert p["route"] == ("ring" if plan_fits(dtype, nc, REG_MAX) else "wide")
        assert p["route"] == ("ring" if nc <= last else "wide")
        if p["route"] == "wide":
            assert (p["tile"], p["stages"], p["smem_bytes"], p["lanes"]) == (256, 0, 0, 32)
        else:
            assert p["lanes"] == (8 if p["tile"] == 32 else 4)
        assert p["ctas_per_sm"] >= 1 and p["sms"] >= 1


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


@pytest.mark.cuda
def test_select_op_on_card_matches_plain(card):
    """The ``torch.library`` op on CUDA tensors is the kernel: one launch per
    call, the plain version's result."""
    pairs = [_views(card, 2, h, h, 80, torch.bfloat16, "nchw") for h in (16, 8, 4)]
    boxes, clss = [list(x) for x in zip(*pairs)]
    before = select.launches
    for _ in range(2):
        got = torch.ops.yolo_ms_tpu_torch.select_scales(boxes, clss, REG_MAX)
    assert select.launches == before + 2
    _assert_equal_to_plain(got, select_scales_plain(pairs, REG_MAX), torch.bfloat16)


def _nms_inputs(b, k, seed=0, span=400.0, pad=0, classes=1):
    """Seeded boxes [b, k, 4] xyxy, shifted by a class among ``classes`` as
    the serving tail shifts them, and descending scores [b, k] with the last
    ``pad`` rows invalid, on the card."""
    import numpy as np

    from yolo_ms_tpu_torch.ops.nms import CLASS_OFFSET

    rng = np.random.default_rng(seed)
    centers = rng.uniform(0, span, (b, k, 2))
    sizes = rng.uniform(8, 60, (b, k, 2))
    boxes = np.concatenate([centers - sizes / 2, centers + sizes / 2], -1)
    boxes += rng.integers(0, classes, (b, k, 1)) * CLASS_OFFSET
    scores = np.sort(rng.uniform(0.05, 1.0, (b, k)), axis=1)[:, ::-1].copy()
    if pad:
        scores[:, -pad:] = -1.0
    return (torch.from_numpy(boxes.astype(np.float32)).cuda(),
            torch.from_numpy(scores.astype(np.float32)).cuda())


def _nms_chain(n, iou, width=20.0):
    """n boxes in a row, each overlapping the next above ``iou`` and the one
    after that below it: the fixed point settles one link per sweep."""
    r = (1.0 - iou) / (1.0 + iou)
    x = torch.arange(n, dtype=torch.float64) * 0.75 * r * width
    boxes = torch.stack([x, torch.zeros(n, dtype=torch.float64), x + width,
                         torch.full((n,), 10.0, dtype=torch.float64)], -1)
    return boxes.float().cuda(), torch.linspace(1.0, 0.5, n).cuda()


def _assert_nms_equal_to_plain(boxes, scores, iou):
    """One launch of the NMS kernel: the plain fixed point's keep mask and
    sweeps per image, exactly, on the route ``route`` names for K."""
    from yolo_ms_tpu_torch.ops.kernels.nms import nms, nms_fixed_plain, route

    before = nms.launches
    keep, sweeps = nms(boxes, scores, iou)
    assert nms.launches == before + 1
    assert nms.last_route == route(boxes.shape[1])
    want_keep, want_sweeps = nms_fixed_plain(boxes, scores, iou)
    torch.cuda.synchronize()
    assert keep.dtype == torch.bool and sweeps.dtype == torch.int32
    assert torch.equal(keep, want_keep)
    assert torch.equal(sweeps, want_sweeps), (sweeps, want_sweeps)
    return keep, sweeps


@pytest.mark.cuda
@pytest.mark.parametrize("iou", [0.3, 0.45, 0.7])
@pytest.mark.parametrize("case", ["flagship", "goldens", "b1", "all_invalid", "global"])
def test_nms_kernel_matches_plain(card, case, iou):
    """The flagship's shape (32 images of K = 1,024 boxes shifted over 80
    classes, 100 invalid rows), the goldens' K = 525 (not a multiple of 32),
    one image, a row with no valid box, and K = 4,096 (the global-scratch
    route)."""
    b, k, kw = {"flagship": (32, 1024, dict(pad=100, classes=80, span=640.0)),
                "goldens": (2, 525, dict(pad=40, span=160.0)),
                "b1": (1, 1024, dict(pad=7, classes=3)),
                "all_invalid": (3, 300, {}),
                "global": (2, 4096, dict(pad=300, classes=4, span=640.0))}[case]
    boxes, scores = _nms_inputs(b, k, seed=int(iou * 100), **kw)
    if case == "all_invalid":
        scores[1] = -1.0
    keep, sweeps = _assert_nms_equal_to_plain(boxes, scores, iou)
    assert 0 < int(keep.sum()) < int((scores > 0).sum())
    if case == "all_invalid":
        assert not keep[1].any() and int(sweeps[1]) == 1


@pytest.mark.cuda
def test_nms_kernel_chain_of_1024(card):
    """A chain of 1,024 boxes (1,023 links) beside a random image: the
    kernel runs as many sweeps as the plain loop, up to K."""
    cb, cs = _nms_chain(1024, 0.45)
    boxes, scores = _nms_inputs(2, 1024, seed=5, span=640.0)
    boxes[0], scores[0] = cb, cs
    keep, sweeps = _assert_nms_equal_to_plain(boxes, scores, 0.45)
    assert keep[0].tolist() == [i % 2 == 0 for i in range(1024)]
    assert int(sweeps[0]) > 1000 >= int(sweeps[1])


@pytest.mark.cuda
@pytest.mark.parametrize("iou", [0.5, 0.3])
def test_nms_kernel_iou_exactly_at_the_threshold(card, iou):
    """IoU 50 / 100 = 0.5 and 30 / 100 (the f32 nearest 0.3) are not above
    their thresholds rounded to f32; a hair below, the second box goes."""
    import numpy as np

    small = {0.5: 5.0, 0.3: 3.0}[iou]
    boxes = torch.tensor([[[0, 0, 10, 10], [0, 0, 10, small]]], device="cuda")
    scores = torch.tensor([[0.9, 0.8]], device="cuda")
    keep, _ = _assert_nms_equal_to_plain(boxes, scores, iou)
    assert keep.tolist() == [[True, True]]
    below = float(np.nextafter(np.float32(iou), np.float32(0)))
    keep, _ = _assert_nms_equal_to_plain(boxes, scores, below)
    assert keep.tolist() == [[True, False]]


@pytest.mark.cuda
def test_nms_plan_route_is_route(card):
    """The kernel's own route rule (``yolo_nms_plan``, from the card's
    opt-in shared memory) is the host's (``route``)."""
    from yolo_ms_tpu_torch.ops.kernels.nms import plan, route

    for k in (1, 31, 525, 1024, 1288, 1289, 4096):
        p = plan(k)
        assert p["route"] == route(k), (k, p)
        assert p["smem_bytes"] <= p["smem_limit"] == 227 * 1024


@pytest.mark.cuda
def test_nms_op_on_card_is_the_kernel(card):
    """The op on CUDA tensors launches the kernel (one launch a call), and
    raises on what the kernel does not take: no plain fallback."""
    from yolo_ms_tpu_torch.ops.kernels.nms import nms, nms_fixed_plain

    boxes, scores = _nms_inputs(2, 64, seed=1, span=100.0)
    before = nms.launches
    keep, sweeps = torch.ops.yolo_ms_tpu_torch.nms_fixed(boxes, scores, 0.45)
    assert nms.launches == before + 1
    want = nms_fixed_plain(boxes, scores, 0.45)
    assert torch.equal(keep, want[0]) and torch.equal(sweeps, want[1])
    with pytest.raises(TypeError):
        nms(boxes.double(), scores.double(), 0.45)
    with pytest.raises(ValueError):
        nms(boxes[:, ::2], scores[:, ::2], 0.45)
    assert nms.launches == before + 1


@pytest.mark.cuda
def test_serving_reads_nothing_back(card, tmp_path):
    """Under ``torch.cuda.set_sync_debug_mode("error")`` (any operation that
    waits for the card raises): ``Predictor.infer``, the exported program
    and the benchmark CLI's ``e2e`` loop, after a warm-up call each, with
    one ``nms`` launch per call."""
    import os

    import numpy as np

    from yolo_ms_tpu_torch.infer.predictor import Predictor
    from yolo_ms_tpu_torch.infer.program import load_program
    from yolo_ms_tpu_torch.models.deploy import fold_batchnorm
    from yolo_ms_tpu_torch.ops.kernels.nms import nms
    from yolo_ms_tpu_torch.tools.benchmark import make_loop
    from yolo_ms_tpu_torch.tools.export import export_program
    from yolo_ms_tpu_torch.utils.convert import load_npz

    sd = fold_batchnorm(load_npz(os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "golden", "trained", "weights.npz")))
    path = str(tmp_path / "serve.pt2")
    export_program(sd, "n", 3, path, batch=2, img_size=(160, 160), device="cuda")
    program = load_program(path, device="cuda")
    predictor = Predictor("n", sd, num_classes=3, input_size=(160, 160),
                          dtype=torch.bfloat16, conf_thresh=0.25, device="cuda")
    loop = make_loop("n", 2, "e2e", img_size=160, device="cuda")
    images = torch.from_numpy(
        np.random.default_rng(0).integers(0, 256, (2, 160, 160, 3), dtype=np.uint8)).cuda()

    def serve_program(x):
        with torch.inference_mode():
            return program(x)

    calls = [lambda: predictor.infer(images), lambda: serve_program(images),
             lambda: loop(0), lambda: loop(1)]
    for call in calls:
        call()  # warm-up: cuDNN plans, the kernels' builds
    torch.cuda.synchronize()
    before = nms.launches
    acc = torch.zeros((), device="cuda")
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(2):
            for call in calls[:2]:
                out = call()
                acc = acc + out["scores"].sum()
            for i in range(3):
                acc = acc + loop(i).float()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert torch.isfinite(acc).item()
    assert nms.launches == before + 10


@pytest.mark.cuda
def test_exported_program_on_card_matches_infer(card, tmp_path):
    """The golden yolov8-n exported on the card and loaded by
    ``load_program``: the bf16 ``Predictor.infer``'s detections, one
    ``select`` launch per call."""
    import os

    import numpy as np

    from yolo_ms_tpu_torch.infer.layouts import not_channels_last
    from yolo_ms_tpu_torch.infer.predictor import Predictor
    from yolo_ms_tpu_torch.infer.program import load_program
    from yolo_ms_tpu_torch.models.deploy import fold_batchnorm
    from yolo_ms_tpu_torch.tools.export import export_program
    from yolo_ms_tpu_torch.utils.convert import load_npz

    sd = fold_batchnorm(load_npz(os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "golden", "trained", "weights.npz")))
    path = str(tmp_path / "serve.pt2")
    info = export_program(sd, "n", 3, path, batch=2, img_size=(160, 160), device="cuda")
    assert info["memory_format"] == "channels_last"
    program = load_program(path, device="cuda")
    assert not_channels_last(program) == []
    images = torch.from_numpy(
        np.random.default_rng(0).integers(0, 256, (2, 160, 160, 3), dtype=np.uint8)).cuda()
    predictor = Predictor("n", sd, num_classes=3, input_size=(160, 160),
                          dtype=torch.bfloat16, conf_thresh=0.25, device="cuda")
    want = predictor.infer(images)
    before = select.launches
    with torch.inference_mode():
        got = program(images)
    torch.cuda.synchronize()
    assert select.launches == before + 1
    assert torch.equal(got["valid"], want["valid"])
    assert torch.equal(got["classes"], want["classes"])
    for key in ("boxes", "scores"):
        torch.testing.assert_close(got[key], want[key], rtol=1e-5, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["n", "yolo-ms-xs"])
def test_channels_last_serving_on_card(card, arch):
    """Each golden in f32 (TF32 off) through ``Predictor(entry_layouts=
    "auto")`` and ``"default"`` on the same images: the same detections;
    under auto every conv's output is channels-last on the card (inputs
    too, but the C2f channel slices), and ``select`` takes no TMA route (its
    maps are contiguous NHWC rows): the box maps (256-byte f32 rows) take
    the bulk-rows route, and so do the 3-class maps (12-byte rows) of HW 400
    and 100; an image of HW 25 is 300 bytes, not a 16-byte multiple, so that
    class map is copied element by element."""
    import os

    import numpy as np
    from torch import nn

    from yolo_ms_tpu_torch.infer.predictor import Predictor
    from yolo_ms_tpu_torch.utils.convert import load_npz

    sub = "trained" if arch == "n" else "trained_yolo-ms-xs"
    sd = load_npz(os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden", sub,
                               "weights.npz"))
    kw = dict(num_classes=3, input_size=(160, 160), conf_thresh=0.25, device="cuda")
    auto = Predictor(arch, sd, entry_layouts="auto", **kw)
    default = Predictor(arch, sd, entry_layouts="default", **kw)
    assert auto.serve.memory_format == torch.channels_last
    assert default.serve.memory_format == torch.contiguous_format
    images = torch.from_numpy(
        np.random.default_rng(0).integers(0, 256, (2, 160, 160, 3), dtype=np.uint8)).cuda()
    strided_in, strided_out = [], []

    def check(name):
        def hook(module, args, out):
            if not args[0].is_contiguous(memory_format=torch.channels_last):
                strided_in.append(name)
            if not out.is_contiguous(memory_format=torch.channels_last):
                strided_out.append(name)
        return hook

    hooks = [m.register_forward_hook(check(n)) for n, m in auto.model.named_modules()
             if isinstance(m, nn.Conv2d)]
    try:
        got = auto.infer(images)
    finally:
        for h in hooks:
            h.remove()
    routes = list(select_scales.last_routes)
    want = default.infer(images)
    torch.cuda.synchronize()
    assert strided_out == []
    assert all(".m_0.conv1." in n for n in strided_in), strided_in
    assert "tma" not in [r for pair in routes for r in pair], routes
    assert routes == [("bulk_rows", "bulk_rows")] * 2 + [("bulk_rows", "elements")], routes
    assert torch.equal(got["valid"], want["valid"])
    assert torch.equal(got["classes"], want["classes"])
    torch.testing.assert_close(got["boxes"], want["boxes"], rtol=0.0, atol=1e-3)
    torch.testing.assert_close(got["scores"], want["scores"], rtol=1e-4, atol=1e-6)


GOLDEN_DIRS = {"n": "trained", "yolo-ms-xs": "trained_yolo-ms-xs"}


def _golden_predictor(arch, dtype=torch.bfloat16, deploy=True, conf=0.25, device="cuda"):
    import os

    from yolo_ms_tpu_torch.infer.predictor import Predictor
    from yolo_ms_tpu_torch.utils.convert import load_npz

    sd = load_npz(os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden",
                               GOLDEN_DIRS[arch], "weights.npz"))
    return Predictor(arch, sd, num_classes=3, input_size=(160, 160), conf_thresh=conf,
                     dtype=dtype, deploy=deploy, device=device)


def _eager_serve(pred):
    """A ``ServingProgram`` built directly on ``pred``'s model (its weights,
    layout and settings): the eager serving function."""
    import contextlib

    from yolo_ms_tpu_torch.infer.program import ServingProgram
    from yolo_ms_tpu_torch.utils.device import full_f32

    program = ServingProgram(pred.model, pred.num_classes, pred.reg_max,
                             conf_thresh=pred.conf_thresh, iou_thresh=pred.iou_thresh,
                             max_det=pred.max_det, pre_nms_topk=pred.pre_nms_topk,
                             dtype=pred.dtype)
    program.memory_format = pred.serve.memory_format

    def serve(x):
        precision = full_f32() if pred.dtype == torch.float32 else contextlib.nullcontext()
        with torch.inference_mode(), precision:
            return program(x)
    return serve


def _images(batch, seed):
    import numpy as np

    return torch.from_numpy(np.random.default_rng(seed).integers(
        0, 256, (batch, 160, 160, 3), dtype=np.uint8)).cuda()


def _assert_same(got, want):
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        assert torch.equal(got[k], want[k]), k


@pytest.fixture
def deterministic():
    before = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True, warn_only=True)
    yield
    torch.use_deterministic_algorithms(before)


@pytest.mark.cuda
@pytest.mark.parametrize("deploy", [True, False])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("arch", ["n", "yolo-ms-xs"])
def test_replayed_infer_equals_eager_program(card, deterministic, arch, dtype, deploy):
    """``Predictor.infer`` replaying its forward from a CUDA graph, at two
    batch shapes in one predictor, equals the eager ``ServingProgram`` on the
    same weights bit for bit; one capture per key, one replay per later
    call."""
    from yolo_ms_tpu_torch.infer import graphs

    pred = _golden_predictor(arch, dtype, deploy, conf=1e-3)
    assert pred.deploy == deploy
    eager = _eager_serve(pred)
    before = dict(graphs.tally)
    for i, batch in enumerate([2, 1, 2, 1, 2]):
        x = _images(batch, i)
        _assert_same(pred.infer(x), eager(x))
    assert graphs.tally["captures"] - before["captures"] == 2
    assert graphs.tally["replays"] - before["replays"] == 3
    assert len(pred.serve.model._graphs) == 2
    assert all(graphs.graph_nodes(g) > 50 for g, _, _ in pred.serve.model._graphs.values())


@pytest.mark.cuda
def test_a_predictor_on_another_card_captures_on_its_card(card):
    """A ``Predictor`` on the last card, called while card 0 is current,
    captures and replays its forward on its own card: replayed calls on
    other images equal the eager serving function there, and the graph
    holds the forward's nodes. Skips with one card."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two cards")
    from yolo_ms_tpu_torch.infer import graphs

    dev = torch.device("cuda", torch.cuda.device_count() - 1)
    current = torch.cuda.current_device()
    torch.cuda.set_device(0)
    try:
        pred = _golden_predictor("n", conf=1e-3, device=dev)
        eager = _eager_serve(pred)
        for seed in range(3):
            x = _images(2, seed).to(dev)
            got = pred.infer(x)
            assert torch.cuda.current_device() == 0
            assert all(v.device == dev for v in got.values())
            _assert_same(got, eager(x))
        ((graph, static_in, _),) = pred.serve.model._graphs.values()
        assert static_in.device == dev
        assert graphs.graph_nodes(graph) > 50
    finally:
        torch.cuda.set_device(current)


@pytest.mark.cuda
def test_results_do_not_alias_the_graphs_outputs(card):
    """The result dict of one call, held on the card through later calls
    on other images, keeps its values; no result shares memory with the
    graph's static input or outputs."""
    pred = _golden_predictor("n", conf=1e-3)
    eager = _eager_serve(pred)
    x = [_images(2, seed) for seed in range(3)]
    pred.infer(x[0])  # the capture
    first = pred.infer(x[1])
    want = {k: v.clone() for k, v in eager(x[1]).items()}
    pred.infer(x[2])
    pred.infer(x[0])
    _assert_same(first, want)
    ((_, static_in, static_out),) = pred.serve.model._graphs.values()
    static = [static_in] + [m for pair in static_out for m in pair]
    ranges = [(t.untyped_storage().data_ptr(),
               t.untyped_storage().data_ptr() + t.untyped_storage().nbytes()) for t in static]
    for k, v in first.items():
        p = v.untyped_storage().data_ptr()
        assert not any(a <= p < b for a, b in ranges), k


@pytest.mark.cuda
def test_a_model_with_a_spatial_group_is_never_captured(card):
    """After ``set_spatial_group`` with a spatial axis of 2 the forward runs
    eagerly (plain outside a sharded forward), with the same detections."""
    from types import SimpleNamespace

    from yolo_ms_tpu_torch.infer import graphs
    from yolo_ms_tpu_torch.nn.blocks import set_spatial_group
    from yolo_ms_tpu_torch.parallel.spatial import HeightShards

    pred = _golden_predictor("n")
    eager = _eager_serve(pred)
    set_spatial_group(pred.model, SimpleNamespace(spatial=2, shards=HeightShards(None, [0, 1], 0)))
    before = dict(graphs.tally)
    for seed in range(2):
        x = _images(2, seed)
        _assert_same(pred.infer(x), eager(x))
    assert graphs.tally == before
    assert pred.serve.model._graphs == {}


def _kernels_by_range(prof, range_name):
    """The names of the kernels and memsets in ``prof`` enqueued inside the
    ``record_function`` range ``range_name`` (by the host time of the
    operator, else the runtime call, that enqueued each), and of all."""
    from torch.autograd import DeviceType

    events = prof.profiler.kineto_results.events()
    op_at, runtime_at, ranges, kernels = {}, {}, [], []
    for e in events:
        if e.device_type() != DeviceType.CPU:
            if not e.name().startswith(("Memcpy", range_name)):
                kernels.append(e)
            continue
        if e.name().startswith("cu"):
            runtime_at.setdefault(e.correlation_id(), e.start_ns())
        else:
            op_at.setdefault(e.correlation_id(), e.start_ns())
        if e.name() == range_name:
            ranges.append((e.start_ns(), e.start_ns() + e.duration_ns()))
    inside = []
    for k in kernels:
        launch = op_at.get(k.linked_correlation_id(), runtime_at.get(k.correlation_id()))
        if launch is not None and any(s <= launch <= e for s, e in ranges):
            inside.append(_op_name(k.name()))
    return inside, [_op_name(k.name()) for k in kernels]


def _op_name(name):
    # a memset node of a graph shows as "memset32", an eager one as "Memset (Device)"
    return "memset" if name.lower().startswith("memset") else name


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["n", "yolo-ms-xs"])
def test_profile_of_a_replay_holds_the_forwards_kernels(card, arch):
    """Under ``torch.profiler``, a replayed call enqueues every kernel and
    memset of the eager forward, the same by name and number, inside a range
    that forward hooks on ``Predictor.serve.model`` open and close (as the
    benchmark's ``portbench/model``)."""
    from collections import Counter

    from torch.profiler import ProfilerActivity, profile, record_function

    pred = _golden_predictor(arch)
    x = _images(2, 0)
    pred.infer(x)  # the capture
    torch.cuda.synchronize()
    with torch.inference_mode():
        net_in = pred.serve.network_input(x)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as eager_prof:
        with record_function("test/model"), torch.inference_mode():
            pred.model(net_in, split_head=True)
        torch.cuda.synchronize()
    want, _ = _kernels_by_range(eager_prof, "test/model")
    assert len(want) > 50

    opened = []

    def enter(module, args):
        r = record_function("test/model")
        r.__enter__()
        opened.append(r)

    def leave(module, args, out):
        opened.pop().__exit__(None, None, None)

    hooks = [pred.serve.model.register_forward_pre_hook(enter),
             pred.serve.model.register_forward_hook(leave)]
    try:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            pred.infer(x)
            torch.cuda.synchronize()
    finally:
        for h in hooks:
            h.remove()
    got, every = _kernels_by_range(prof, "test/model")
    assert Counter(got) == Counter(want)
    assert len(every) > len(got)  # the post-process's kernels, outside the range


@pytest.mark.cuda
def test_yolov12_replay_captures_its_attention(card, deterministic):
    """yolov12-l through ``Predictor`` at bs 2, 640², bf16, channels-last:
    the replayed forward's detections equal the eager serving function's
    bit for bit; a replay's profile holds the attention kernels
    (``ops/attention.py:KERNEL``) once a counted call, so the graph captured
    SDPA; and ``serve/model`` counts the model's 16 attention calls (8 at
    P4 in 4 areas, 8 at P5 in 1, 8 heads of 32) and its 205 deploy convs,
    each with its epilogue in the kernel, on every call."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    from yolo_ms_tpu_torch.infer import graphs
    from yolo_ms_tpu_torch.infer.predictor import Predictor
    from yolo_ms_tpu_torch.models.registry import build_model, init_model
    from yolo_ms_tpu_torch.ops import attention
    from yolo_ms_tpu_torch.utils import profiler

    model = init_model(build_model("yolov12-l", device="cpu"), torch.Generator().manual_seed(0))
    pred = Predictor("yolov12-l", model.state_dict(), num_classes=80, input_size=(640, 640),
                     conf_thresh=1e-3, dtype=torch.bfloat16, device="cuda")
    eager = _eager_serve(pred)
    x = [torch.from_numpy(np.random.default_rng(seed).integers(
        0, 256, (2, 640, 640, 3), dtype=np.uint8)).cuda() for seed in range(3)]
    want_out = [eager(xi) for xi in x]
    before = dict(graphs.tally)
    profiler.clear()
    with profiler.recording():
        got_out = [pred.infer(xi) for xi in x]
    for got, want_i in zip(got_out, want_out):
        _assert_same(got, want_i)
    assert graphs.tally["captures"] - before["captures"] == 1
    assert graphs.tally["replays"] - before["replays"] == 2
    seqs4, seqs5, tokens = 2 * 4 * 8, 2 * 1 * 8, 400
    want = {"attn_head_dim": 32, "attn_calls": 16,
            "attn_rows": 8 * (seqs4 + seqs5) * tokens,
            "attn_scores": 8 * (seqs4 + seqs5) * tokens**2,
            "conv_biased": 205, "conv_epilogues": 205}
    spans = [s.counts for s in profiler.spans() if s.name == "serve/model"]
    assert len(spans) == 3
    assert [{k: v for k, v in c.items() if k != "replayed"} for c in spans] == [want] * 3
    assert [c.get("replayed") for c in spans] == [0, 1, 1]
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        pred.infer(x[0])
        torch.cuda.synchronize()
    _, names = _kernels_by_range(prof, "serve/model")
    assert sum(bool(attention.KERNEL.search(n)) for n in names) == 16, sorted(set(names))
    profiler.clear()


# the relative norms of the error with which the port's bf16 area
# attention and R-ELAN branch may follow the float32 reference's (see
# ``yolov12_branch_gaps``). Read on an H100 over 8 seeds at bs 32, 640²:
# the program's attention 0.015-0.035, its branch 0.064-0.170 (bf16's
# rounding, grown through the 8 ABlocks of a stage); area 1 at P4 0.30-0.44
# and 0.28-0.61; heads read as [(q|k|v), heads, d] 1.36-1.64 and 0.92-1.80.
# Each limit lies between the program's worst and the controls' least.
Y12_TOL = {"attn": 0.1, "branch": 0.22}
Y12_CONTROLS = {"P4": ("area 1 at P4", "heads read as [(q|k|v), heads, d]"),
                "P5": ("heads read as [(q|k|v), heads, d]",)}


def _heads_as_qkv_major(stage):
    """``stage`` with every ``qkv`` conv's output channels permuted so that
    the port's ``[heads, (q | k | v), d]`` reading takes what a reading of
    the channels as ``[(q | k | v), heads, d]`` would: the control of a
    wrong head layout."""
    import copy

    from yolo_ms_tpu_torch.nn.blocks import AAttn

    stage = copy.deepcopy(stage)
    for m in stage.modules():
        if isinstance(m, AAttn):
            conv = m.qkv.conv
            c, d = conv.out_channels // 3, conv.out_channels // 3 // m.heads
            idx = torch.arange(3 * c, device=conv.weight.device).view(3, m.heads, d)
            perm = idx.permute(1, 0, 2).reshape(-1)  # port channel -> source channel
            with torch.no_grad():
                conv.weight.copy_(conv.weight[perm])
                conv.bias.copy_(conv.bias[perm])
    return stage


def _with_area(stage, area):
    import copy

    from yolo_ms_tpu_torch.nn.blocks import AAttn

    stage = copy.deepcopy(stage)
    for m in stage.modules():
        if isinstance(m, AAttn):
            m.area = area
    return stage


def yolov12_branch_gaps(level, seed, batch=32, img=640, device="cuda"):
    """The R-ELAN branch of yolov12-l's attention stage at ``level`` (P4:
    ``backbone.a2c2f_6``, area 4; P5: ``backbone.a2c2f_8``, area 1) as the
    port serves it (BN folded, bf16, channels-last, SDPA) against the
    float32 reference (``portbench/reference/arch/yolov12.py``: explicit
    matmuls and softmax, IEEE float32), on the benchmark's seeded weights
    and on the stage's input from the reference's backbone on uniform
    images. Returns {"program" or a control's name: {"attn": the worst
    |got - want| / |want| of the stage's 8 ``AAttn``, each given the
    reference's input, "branch": that of the stage's ``conv2`` output,
    before ``gamma``, given the stage's input}}."""
    from portbench import run
    from portbench.reference.model import Detector, family, ieee_f32
    from portbench.weights import seeded_state_dict
    from yolo_ms_tpu_torch.models.deploy import fold_batchnorm
    from yolo_ms_tpu_torch.models.registry import build_model

    cfg = dict(run.load_json("configs", "yolov12-l.json"), image_size=[img, img])
    sd = seeded_state_dict(cfg, seed, device)
    ref = Detector(cfg).to(device).eval()
    ref.load_state_dict(sd)
    name = {"P4": "a2c2f_6", "P5": "a2c2f_8"}[level]
    gen = torch.Generator(device=device).manual_seed(seed)
    x = torch.rand(batch, 3, img, img, generator=gen, device=device)
    seen, attn_io = {}, {}

    def keep(store, key, value):  # a hook that returns None changes nothing
        store[key] = value

    stage_ref = getattr(ref.backbone, name)
    stage_ref.register_forward_pre_hook(lambda m, args: keep(seen, "x", args[0]))
    stage_ref.conv2.register_forward_hook(lambda m, args, out: keep(seen, "want", out))
    for key, m in stage_ref.named_modules():
        if isinstance(m, family("yolov12").AAttn):
            m.register_forward_hook(
                lambda m, args, out, key=key: keep(attn_io, key, (args[0], out.double())))
    with torch.no_grad(), ieee_f32():
        ref.backbone(x)
    assert len(attn_io) == 8

    port = build_model("yolov12-l", device=device, deploy=True)
    port.load_state_dict(fold_batchnorm(sd))
    port.to(torch.bfloat16).to(memory_format=torch.channels_last)
    stage = getattr(port.backbone, name)
    controls = {"program": stage, "area 1 at P4": _with_area(stage, 1),
                "heads read as [(q|k|v), heads, d]": _heads_as_qkv_major(stage)}

    def bf16(t):
        return t.to(torch.bfloat16).contiguous(memory_format=torch.channels_last)

    def gap(got, want):
        return float((got.double() - want).norm() / want.norm())

    gaps = {}
    for key in ("program", *Y12_CONTROLS[level]):
        mod, out = controls[key], {}
        handle = mod.conv2.register_forward_hook(lambda m, args, o: keep(out, "got", o))
        with torch.inference_mode():
            mod(bf16(seen["x"]))
            attns = dict(mod.named_modules())
            worst = max(gap(attns[k](bf16(xin)), want) for k, (xin, want) in attn_io.items())
        handle.remove()
        if key == "program":
            assert out["got"].is_contiguous(memory_format=torch.channels_last)
        gaps[key] = {"attn": worst, "branch": gap(out["got"], seen["want"].double())}
    return gaps


@pytest.mark.cuda
@pytest.mark.parametrize("level", ["P4", "P5"])
def test_yolov12_attention_stage_in_bf16_follows_the_float32_reference(card, level):
    """The card's bf16 FlashAttention on strided channels-last views, inside
    the R-ELAN branch of each attention stage at the cell's shapes (bs 32,
    640²: [128, 8, 400, 32] at P4, [32, 8, 400, 32] at P5), follows the
    float32 reference within ``Y12_TOL``; a wrong attention (area 1
    at P4; heads read as [(q|k|v), heads, d]) does not. The benchmark's
    judge cannot see this branch (``gamma`` scales it by 0.01 in the
    served maps), so this test is what holds the card's attention to an
    independent reference."""
    gaps = yolov12_branch_gaps(level, seed=2**31 + 20)
    for part, tol in Y12_TOL.items():
        assert gaps["program"][part] < tol, gaps
        for control in Y12_CONTROLS[level]:
            assert gaps[control][part] > tol, (control, gaps)


def _train_one_step(device, optimizer):
    """One f32 train step of a seeded yolov8-n (nc=3, 96 px, batch 4) with
    clipping, weight decay and EMA, from the same CPU-drawn weights."""
    import numpy as np

    from yolo_ms_tpu_torch.models.registry import build_model, init_model
    from yolo_ms_tpu_torch.train.loss import DetectionLoss
    from yolo_ms_tpu_torch.train.optim import build_optimizer
    from yolo_ms_tpu_torch.train.trainer import TrainState, make_train_step
    from yolo_ms_tpu_torch.utils.config import TrainingConfig

    model = init_model(build_model("n", num_classes=3, device="cpu"),
                       torch.Generator().manual_seed(0))
    cfg = TrainingConfig(batch_size=4, epochs=1, optimizer=optimizer, learning_rate=LR,
                         weight_decay=5e-4, grad_clip_norm=10.0, ema_decay=0.9999)
    tx, _ = build_optimizer(cfg, 4)
    state = TrainState.create(model.to(device), tx, ema=True)
    state.step.fill_(4000)
    step = make_train_step(DetectionLoss(num_classes=3), tx, cfg.ema_decay, torch.float32)
    rng = np.random.default_rng(0)
    c, wh = rng.uniform(0.35, 0.65, (4, 3, 2)), rng.uniform(0.5, 0.9, (4, 3, 2))
    batch = {
        "images": torch.from_numpy(rng.integers(0, 256, (4, 96, 96, 3), dtype=np.uint8)),
        "boxes": torch.from_numpy(np.concatenate([c, wh], -1).astype(np.float32)),
        "labels": torch.from_numpy(rng.integers(0, 3, (4, 3)).astype(np.int32)),
        "mask": torch.ones(4, 3, dtype=torch.bool),
    }
    metrics = step(state, {k: v.to(device) for k, v in batch.items()})
    return {k: float(v) for k, v in metrics.items()}, state


# the rounding bound of a gradient (or Adam moment) element: this share of the
# largest |value| of its parameter in the reference, plus rtol of its own
# (two implementations' f32 sums in another order)
ADAM_ROUNDING = 5e-4
ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8  # optax.adam's defaults, as the port's


def adam_rounding_bound(x: torch.Tensor, sizes: list[int], rtol: float = 1e-3) -> torch.Tensor:
    """``ADAM_ROUNDING`` times the largest |x| of each element's parameter
    (``sizes``: the numels of the parameters laid end to end in ``x``), plus
    ``rtol`` times |x|."""
    leaf = torch.repeat_interleave(torch.arange(len(sizes)), torch.tensor(sizes))
    top = torch.zeros(len(sizes)).scatter_reduce(0, leaf, x.abs(), "amax")
    return ADAM_ROUNDING * top[leaf] + rtol * x.abs()


def adam_sensitive(mus: list[torch.Tensor], lrs: list[float], sizes: list[int], tol):
    """The elements whose Adam steps could move a parameter by more than
    ``tol`` if each of the reference's gradients moved within its rounding
    bound. The gradients are read back from the reference's first moments
    after each update (``mus``, from the optimizer's start; ``lrs`` their
    learning rates), and Adam is replayed at every corner of the bounds."""
    grads, prev = [], torch.zeros_like(mus[0])
    for mu in mus:
        grads.append((mu - ADAM_B1 * prev) / (1 - ADAM_B1))
        prev = mu
    bounds = [adam_rounding_bound(g, sizes) for g in grads]

    def moved(signs):
        mu = nu = torch.zeros_like(grads[0])
        total = torch.zeros_like(grads[0])
        for n, (g, b, lr, sign) in enumerate(zip(grads, bounds, lrs, signs), start=1):
            g = g + sign * b
            mu = ADAM_B1 * mu + (1 - ADAM_B1) * g
            nu = ADAM_B2 * nu + (1 - ADAM_B2) * g * g
            m_hat, v_hat = mu / (1 - ADAM_B1**n), nu / (1 - ADAM_B2**n)
            total += lr * m_hat / (torch.sqrt(v_hat) + ADAM_EPS)
        return total

    base = moved([0] * len(grads))
    worst = torch.zeros_like(base)
    for signs in itertools.product((-1, 1), repeat=len(grads)):
        worst = torch.maximum(worst, (moved(signs) - base).abs())
    return worst > tol


def assert_adam_params_close(got, want, mu_got, mus_want, lrs, sizes, max_step,
                             rtol=1e-3, atol=1e-5) -> int:
    """Adam's update lr * m / (sqrt(v) + eps) is a ratio: where a gradient is
    within rounding of zero, or of eps, the step's sign and size follow the
    order of the sums (lr * sign(g) on the first update, however small g).
    Held, on flat tensors, with the reference's first moments after each
    update (``mus_want``) and the updates' learning rates (``lrs``):
    - every element of the first moment within its rounding bound
      (``adam_rounding_bound``) of the reference's last;
    - every param within rtol / atol, except the elements whose steps, replayed
      from the reference's gradients, could move by more than that within the
      gradients' rounding bounds (``adam_sensitive``);
    - those exempt elements within ``max_step`` (twice the summed learning
      rates).
    Prints and returns the number of exempt elements."""
    mu_want = mus_want[-1]
    d_mu = (mu_got - mu_want).abs()
    off_mu = d_mu > adam_rounding_bound(mu_want, sizes, rtol)
    assert not off_mu.any(), f"{int(off_mu.sum())} first-moment elements beyond rounding"
    # the share of its parameter's largest |moment| that each moment's
    # difference reaches beyond rtol: what ADAM_ROUNDING must cover
    reach = float(((d_mu - rtol * mu_want.abs()).clamp_min(0)
                   / (adam_rounding_bound(mu_want, sizes, 0.0) / ADAM_ROUNDING)
                   .clamp_min(1e-30)).max())
    exempt = adam_sensitive(mus_want, lrs, sizes, atol + rtol * want.abs())
    d = (got - want).abs()
    off = d > atol + rtol * want.abs()
    assert not (off & ~exempt).any(), (
        f"{int((off & ~exempt).sum())} of {off.numel()} params off where the reference's "
        f"steps are not within rounding of moving that far")
    if exempt.any():
        assert d[exempt].max() <= max_step + atol
    print(f"Adam: {int(exempt.sum())} of {got.numel()} elements exempt "
          f"({int((off & exempt).sum())} of them off); moments reach {reach:.2e} of "
          f"their parameter's largest beyond rtol")
    return int(exempt.sum())


@pytest.mark.cuda
@pytest.mark.parametrize("optimizer", ["sgd", "adam"])
def test_train_step_on_card_matches_cpu(card, optimizer):
    """The f32 train step (TF32 off) on the card equals the CPU's: loss terms
    rtol 1e-4; params, BN statistics and EMA rtol 1e-3 / atol 1e-5 (for Adam,
    params and EMA params as ``assert_adam_params_close`` says, with the CPU
    as the reference)."""
    card_m, card_state = _train_one_step("cuda", optimizer)
    cpu_m, cpu_state = _train_one_step("cpu", optimizer)
    assert card_m["skipped_nonfinite"] == cpu_m["skipped_nonfinite"] == 0.0
    assert card_m["num_fg"] == cpu_m["num_fg"] > 0
    for k in ("loss_box", "loss_cls", "loss_dfl", "total_loss"):
        assert abs(card_m[k] - cpu_m[k]) <= 1e-4 * abs(cpu_m[k]), k
    for name in ("params", "stats", "ema_params", "ema_stats"):
        got, want = getattr(card_state, name).cpu(), getattr(cpu_state, name)
        if optimizer == "adam" and name.endswith("params"):
            sizes = [p.numel() for p in cpu_state.model.parameters()]
            assert_adam_params_close(got, want, card_state.opt_state["mu"].cpu(),
                                     [cpu_state.opt_state["mu"]], [LR], sizes, 2 * LR)
        else:
            torch.testing.assert_close(got, want, rtol=1e-3, atol=1e-5)


EPILOGUE_SHAPES = {"small": (2, 5, 7), "big": (16, 96, 96)}  # (batch, H, W)
EPILOGUE_LAYOUTS = {"channels_last": torch.channels_last, "nchw": torch.contiguous_format}


def _assert_one_rounding(got, y0, bias, act):
    """``got`` is act(y0 + bias) computed in f32 and rounded once to y0's
    dtype: within one bf16 rounding (2**-8 of the value), or f32 rounding."""
    import torch.nn.functional as F

    want = y0.float() + bias.float().view(1, -1, 1, 1)
    want = F.silu(want) if act else want
    tol = (2.0**-8, 1e-5) if y0.dtype == torch.bfloat16 else (1e-6, 1e-6)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), want, rtol=tol[0], atol=tol[1])


@pytest.mark.cuda
@pytest.mark.parametrize("act", [True, False])
@pytest.mark.parametrize("c", [80, 307, 3])
@pytest.mark.parametrize("layout", list(EPILOGUE_LAYOUTS))
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("size", list(EPILOGUE_SHAPES))
def test_epilogue_kernel_matches_plain(card, size, dtype, layout, c, act):
    """``csrc/epilogue.cu`` in place on a conv-output-like map: one launch,
    the route ``expected_route`` names, act(y + b) within one rounding. The
    big maps walk many grid strides (the carried channel and plane index)."""
    from yolo_ms_tpu_torch.ops.kernels.epilogue import conv_epilogue, expected_route

    b, h, w = EPILOGUE_SHAPES[size]
    y = (torch.randn(b, c, h, w, generator=card, device="cuda") * 3.0).to(dtype)
    y = y.contiguous(memory_format=EPILOGUE_LAYOUTS[layout])
    bias = torch.randn(c, generator=card, device="cuda").to(dtype)
    y0 = y.clone()
    before = conv_epilogue.launches
    assert conv_epilogue(y, bias, act) is y
    assert conv_epilogue.launches == before + 1
    assert conv_epilogue.last_route == expected_route(y, bias)
    assert y.stride() == y0.stride()
    _assert_one_rounding(y, y0, bias, act)


@pytest.mark.cuda
@pytest.mark.parametrize("offset", [1, 3])
@pytest.mark.parametrize("layout", list(EPILOGUE_LAYOUTS))
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_epilogue_kernel_on_an_unaligned_view(card, dtype, layout, offset):
    """A map starting ``offset`` elements into its buffer (no 16-byte
    boundary at its base) takes the element route, with a scalar head and
    tail: every element of the view moves, none of the buffer around it."""
    from yolo_ms_tpu_torch.ops.kernels.epilogue import conv_epilogue, expected_route

    n, c, h, w = 2, 80, 9, 11
    size = n * c * h * w
    buf = torch.randn(offset + size + 5, generator=card, device="cuda").to(dtype)
    flat = buf[offset:offset + size]
    y = (flat.view(n, h, w, c).permute(0, 3, 1, 2) if layout == "channels_last"
         else flat.view(n, c, h, w))
    bias = torch.randn(c, generator=card, device="cuda").to(dtype)
    outside, y0 = torch.cat([buf[:offset], buf[offset + size:]]), y.clone()
    conv_epilogue(y, bias, True)
    assert conv_epilogue.last_route == expected_route(y, bias) == "elements"
    _assert_one_rounding(y, y0, bias, True)
    assert torch.equal(torch.cat([buf[:offset], buf[offset + size:]]), outside)


@pytest.mark.cuda
def test_deploy_conv_takes_the_kernel(card, deterministic):
    """A deploy ``ConvBnSiLU`` on the card runs its conv without the bias
    and the kernel adds bias and SiLU within one rounding (one launch,
    counted), with grad off or on; with grad on a backward raises."""
    import torch.nn.functional as F

    from yolo_ms_tpu_torch.nn.blocks import ConvBnSiLU
    from yolo_ms_tpu_torch.ops.kernels.epilogue import conv_epilogue
    from yolo_ms_tpu_torch.utils.profiler import counted

    torch.manual_seed(0)
    m = ConvBnSiLU(64, 307, 3)
    m.to_deploy()
    with torch.no_grad():
        m.conv.bias.normal_()
    m = m.to("cuda", torch.bfloat16).to(memory_format=torch.channels_last)
    x = torch.randn(4, 64, 40, 40, generator=card, device="cuda").to(torch.bfloat16)
    x = x.contiguous(memory_format=torch.channels_last)
    for grad in (False, True):
        before = conv_epilogue.launches
        with torch.set_grad_enabled(grad), counted() as counts:
            got = m(x)
        assert counts == {"conv_biased": 1, "conv_epilogues": 1}
        assert conv_epilogue.launches == before + 1
        assert got.is_contiguous(memory_format=torch.channels_last)
        with torch.no_grad():
            _assert_one_rounding(got, F.conv2d(x, m.conv.weight, None, 1, 1), m.conv.bias,
                                 True)
        if grad:
            with pytest.raises(RuntimeError, match="no backward"):
                got.float().sum().backward()


@pytest.mark.cuda
@pytest.mark.parametrize("arch,convs", [("n", 57), ("yolo-ms-xs", 90)])
def test_replayed_forward_runs_every_epilogue_in_the_graph(card, arch, convs):
    """A replayed serving forward launches the epilogue kernel once per
    deploy conv inside the graph (no Python call of the forward: the
    launch counter stays), and ``serve/model`` carries ``conv_epilogues``
    equal to ``conv_biased``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from yolo_ms_tpu_torch.ops.kernels.epilogue import KERNEL, conv_epilogue
    from yolo_ms_tpu_torch.utils import profiler

    pred = _golden_predictor(arch)
    x = _images(2, 0)
    pred.infer(x)  # warm-up and capture
    torch.cuda.synchronize()
    before = conv_epilogue.launches
    profiler.clear()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        pred.infer(x)
        torch.cuda.synchronize()
    assert conv_epilogue.launches == before
    (span,) = [s for s in profiler.spans() if s.name == "serve/model"]
    profiler.clear()
    assert span.counts["replayed"] == 1
    assert span.counts["conv_biased"] == span.counts["conv_epilogues"] == convs
    launched = [e for e in prof.profiler.kineto_results.events()
                if e.device_type() != DeviceType.CPU and KERNEL.search(e.name())]
    assert len(launched) == convs


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["xs-serve-b32", "v8n-serve-b32", "y12l-serve-b32"])
def test_each_serving_cell_passes_its_judge(card, cell):
    """Each serving configuration of the benchmark through the harness's
    serving path (``portbench/drivers/serve.py``, a 1 s window over two
    pooled batches of 32 at 640x640): the float32 reference's judge reads
    every number under the cell's limits, and the forward ran its epilogues
    in the kernel."""
    import dataclasses

    from portbench import run

    from yolo_ms_tpu_torch.ops.kernels.epilogue import conv_epilogue

    c, _, _ = run.load_cell(cell, 2**31 + 21, 1, False)
    c = dataclasses.replace(c, traffic=dict(c.traffic, pool=2, sample=2),
                            say=lambda *a: None)
    before = conv_epilogue.launches
    out = run.load_module("drivers", "serve").run(c, torch.cuda.get_device_name(0))
    assert conv_epilogue.launches > before
    for key, limit in c.limits.items():
        assert out["checks"][key] <= limit, (key, out["checks"])
