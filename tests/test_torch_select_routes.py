"""The copy route rule of ``csrc/select.cu`` as ``expected_routes`` states it
in Python, on CPU tensors: which (box, cls) route each scale's maps take on
the card, from their strides, dtype and base alignment. ``chip_smoke.py``
(phases 3 and 5) and ``tests/test_torch_cuda.py`` hold the kernel's
``select_scales.last_routes`` equal to it on the card. No JAX here.
"""

import pytest
import torch

from yolo_ms_tpu_torch.ops.kernels.select import expected_routes

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


def _mixed(b, side, nc, dtype):
    """An NCHW box view beside a contiguous NHWC class map."""
    return _nchw(b, side, nc, dtype)[0], _split(b, side, nc, dtype)[1]


BULK, TMA, ELEMS = ("bulk_rows",) * 2, ("tma",) * 2, ("elements",) * 2
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
    # nc 3: 134-byte unsplit rows, 6-byte split class rows
    "unsplit-bf16-nc3": (_unsplit, 4, [20], 3, BF16, [ELEMS]),
    "auto-f32-nc3": (_split, 2, [20, 10, 5], 3, F32, [("bulk_rows", "elements")] * 3),
    "offset-2-bytes": (_offset, 4, [20], 80, BF16, [ELEMS]),
    "mixed-nchw-box": (_mixed, 4, [20], 80, BF16, [("elements", "bulk_rows")]),
    # one image: the batch stride is never stepped
    "one-image-nc3-unsplit-f32": (_unsplit, 1, [7], 4, F32, [BULK]),
}


@pytest.mark.parametrize("case", list(CASES))
def test_expected_routes(case):
    make, b, sides, nc, dtype, want = CASES[case]
    pairs = [make(b, s, nc, dtype) for s in sides]
    assert expected_routes(pairs, REG_MAX) == want
