"""The copy route rule of ``csrc/select.cu`` as ``expected_routes`` states it
in Python, on CPU tensors: which (box, cls) route each scale's maps take on
the card, from their class count, dtype, strides and base alignment, and
``plan_fits``, the shared-memory rule past which every map takes ``wide``. ``chip_smoke.py``
(phases 3 and 5) and ``tests/test_torch_cuda.py`` hold the kernel's
``select_scales.last_routes`` equal to it on the card. No JAX here.
"""

import pytest
import torch

import tests.torch_policy  # noqa: F401 - the port's thread policy
from yolo_ms_tpu_torch.ops.kernels.select import expected_routes, plan_fits

REG_MAX = 16
NB = 4 * REG_MAX
BF16, F32 = torch.bfloat16, torch.float32


def _split(b, side, nc, dtype):
    """Contiguous NHWC head maps, as ``entry_layouts="auto"`` serves them."""
    return (torch.zeros(b, side * side, NB, dtype=dtype),
            torch.zeros(b, side * side, nc, dtype=dtype))


def _unsplit(b, side, nc, dtype):
    flat = torch.zeros(b, side * side, NB + nc, dtype=dtype)
    return flat[..., :NB], flat[..., NB:]


def _nchw(b, side, nc, dtype):
    """The permute(0, 2, 3, 1) views of NCHW maps (``"default"``)."""
    box = torch.zeros(b, NB, side, side, dtype=dtype)
    cls = torch.zeros(b, nc, side, side, dtype=dtype)
    return box.permute(0, 2, 3, 1).flatten(1, 2), cls.permute(0, 2, 3, 1).flatten(1, 2)


def _offset(b, side, nc, dtype):
    """Contiguous NHWC maps whose base lies 2 bytes past an aligned one."""
    hw = side * side
    box = torch.zeros(b * hw * NB + 1, dtype=dtype)[1:].view(b, hw, NB)
    cls = torch.zeros(b * hw * nc + 1, dtype=dtype)[1:].view(b, hw, nc)
    return box, cls


def _padded(b, side, nc, dtype):
    """Contiguous NHWC maps that are the first HW rows of maps 64 rows
    taller: packed rows and a 16-byte batch stride whatever HW is."""
    hw = side * side
    box = torch.zeros(b, hw + 64, NB, dtype=dtype)[:, :hw]
    return box, torch.zeros(b, hw + 64, nc, dtype=dtype)[:, :hw]


def _mixed(b, side, nc, dtype):
    """An NCHW box view beside a contiguous NHWC class map."""
    return _nchw(b, side, nc, dtype)[0], _split(b, side, nc, dtype)[1]


BULK, TMA, ELEMS, WIDE = ("bulk_rows",) * 2, ("tma",) * 2, ("elements",) * 2, ("wide",) * 2
CASES = {
    # auto's split maps at 640 px: the main path
    **{f"auto-{dt}-{s}px": (_split, 32, [s], 80, dtype, [BULK])
       for dt, dtype in (("bf16", BF16), ("f32", F32)) for s in (80, 40, 20)},
    "auto-bf16-three-scales": (_split, 32, [80, 40, 20], 80, BF16, [BULK] * 3),
    "unsplit-bf16-144": (_unsplit, 32, [80, 40, 20], 80, BF16, [BULK] * 3),
    "unsplit-f32-144": (_unsplit, 4, [20], 80, F32, [BULK]),
    "nchw-bf16": (_nchw, 32, [80, 40, 20], 80, BF16, [TMA] * 3),
    "nchw-f32": (_nchw, 4, [20], 80, F32, [TMA]),
    # HW 49 and 25: aligned rows channels-last, 98- and 50-byte channel rows in NCHW
    "auto-bf16-hw49-hw25": (_split, 4, [7, 5], 80, BF16, [BULK] * 2),
    "unsplit-bf16-hw49-hw25": (_unsplit, 4, [7, 5], 80, BF16, [BULK] * 2),
    "nchw-bf16-hw49-hw25": (_nchw, 4, [7, 5], 80, BF16, [ELEMS] * 2),
    # nc 3: 134-byte unsplit rows; 12-byte split class rows are packed, so
    # one tile is one byte range, but an image of HW 25 is 300 bytes
    "unsplit-bf16-nc3": (_unsplit, 4, [20], 3, BF16, [ELEMS]),
    "auto-f32-nc3": (_split, 2, [20, 10, 5], 3, F32,
                     [BULK, BULK, ("bulk_rows", "elements")]),
    "offset-2-bytes": (_offset, 4, [20], 80, BF16, [ELEMS]),
    "offset-2-bytes-nc10": (_offset, 4, [20, 10], 10, BF16, [ELEMS] * 2),
    # packed class rows of any width at the 640 px scales: the fine-tune
    # config's 10 classes and VOC's 20, 20- to 80-byte rows
    **{f"auto-{dt}-nc{nc}-640px": (_split, 2, [80, 40, 20], nc, dtype, [BULK] * 3)
       for dt, dtype in (("bf16", BF16), ("f32", F32)) for nc in (10, 20)},
    # the last tile's byte range (and the image's) not a 16-byte multiple:
    # HW 25 x 3 classes, 150 bytes in bf16; 49 x 10, 980 bytes; the class
    # maps stay on elements even where the batch stride is aligned
    "padded-bf16-nc3-hw25": (_padded, 2, [5], 3, BF16, [("bulk_rows", "elements")]),
    "padded-bf16-nc10-hw49-hw16": (_padded, 2, [7, 4], 10, BF16,
                                   [("bulk_rows", "elements"), BULK]),
    # one image: the image's own bytes decide
    "one-image-bf16-nc10": (_split, 1, [80, 40, 20], 10, BF16, [BULK] * 3),
    "one-image-bf16-nc3-hw25": (_split, 1, [5], 3, BF16, [("bulk_rows", "elements")]),
    "mixed-nchw-box": (_mixed, 4, [20], 80, BF16, [("elements", "bulk_rows")]),
    # one image: the batch stride is never stepped
    "one-image-nc3-unsplit-f32": (_unsplit, 1, [7], 4, F32, [BULK]),
    # nc 300: no TMA and no strided bulk rows past 256 channels
    "auto-f32-nc300": (_split, 2, [4, 2], 300, F32, [BULK] * 2),
    "unsplit-f32-nc300": (_unsplit, 2, [4], 300, F32, [("bulk_rows", "elements")]),
    "nchw-f32-nc300": (_nchw, 2, [4], 300, F32, [ELEMS]),
    # the last class counts with a ring, and the first without (LVIS: 1,203);
    # HW 4 x 1,203 bf16 classes is 9,624 bytes, not a 16-byte multiple
    "auto-f32-nc826": (_split, 2, [4], 826, F32, [BULK]),
    "auto-bf16-nc1730": (_split, 2, [4], 1730, BF16, [BULK]),
    "auto-bf16-nc1203": (_split, 2, [4, 2], 1203, BF16, [BULK, ("bulk_rows", "elements")]),
    "auto-bf16-nc1203-640px": (_split, 1, [80, 40, 20], 1203, BF16, [BULK] * 3),
    **{f"{make.__name__[1:]}-{dt}-nc{nc}-wide": (make, 2, [4, 2], nc, dtype, [WIDE] * 2)
       for make in (_split, _unsplit, _nchw)
       for dt, dtype, nc in (("f32", F32, 827), ("f32", F32, 1203), ("bf16", BF16, 1731))},
}


@pytest.mark.parametrize("case", list(CASES))
def test_expected_routes(case):
    make, b, sides, nc, dtype, want = CASES[case]
    pairs = [make(b, s, nc, dtype) for s in sides]
    assert expected_routes(pairs, REG_MAX) == want


@pytest.mark.parametrize("dtype,last", [(F32, 826), (BF16, 1730)])
def test_plan_fits_thresholds(dtype, last):
    """Two 32-anchor stages of (64 + nc) channels, each rounded up to 128
    bytes, beside 4,416 (f32) or 2,624 (bf16) bytes of barriers and
    partials, within 232,448 bytes: f32 fits up to nc 826 (227,840 bytes
    of ring), bf16 up to 1,730 (229,632); other reg_max move the line."""
    assert plan_fits(dtype, 1) and plan_fits(dtype, 80) and plan_fits(dtype, last)
    assert not plan_fits(dtype, last + 1) and not plan_fits(dtype, 65536)
    assert plan_fits(dtype, last + 4, reg_max=15) and not plan_fits(dtype, last - 3, reg_max=17)
