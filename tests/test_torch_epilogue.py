"""The BN-folded convs' epilogue (``ops/kernels/epilogue.py``) on the CPU:
the op ``yolo_ms_tpu_torch::conv_epilogue`` in place against the plain
``F.silu(y + b)`` / ``y + b``, its fake implementation, the layouts and
dtypes it refuses, the route rule; a deploy ``ConvBnSiLU`` off the card
runs torch's conv with its bias and ``F.silu`` as before; the counts of
``counted()``. The kernel itself is in ``tests/test_torch_cuda.py``.
"""

import pytest
import torch
import torch.nn.functional as F

import tests.torch_policy  # noqa: F401 - the port's thread policy
from yolo_ms_tpu_torch.models.registry import build_model
from yolo_ms_tpu_torch.nn.blocks import ConvBnSiLU
from yolo_ms_tpu_torch.ops.kernels import epilogue
from yolo_ms_tpu_torch.ops.kernels.epilogue import (
    conv_epilogue,
    conv_epilogue_op,
    conv_epilogue_plain,
)
from yolo_ms_tpu_torch.utils.profiler import counted

LAYOUTS = {"channels_last": torch.channels_last, "nchw": torch.contiguous_format}


def _map(c, dtype, layout, seed=0, shape=(2, 5, 7)):
    gen = torch.Generator().manual_seed(seed)
    b, h, w = shape
    y = (torch.randn(b, c, h, w, generator=gen) * 3.0).to(dtype)
    bias = torch.randn(c, generator=gen).to(dtype)
    return y.contiguous(memory_format=LAYOUTS[layout]), bias


@pytest.mark.parametrize("act", [True, False])
@pytest.mark.parametrize("c", [307, 3])
@pytest.mark.parametrize("layout", list(LAYOUTS))
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_op_on_cpu_is_the_plain_epilogue_in_place(dtype, layout, c, act):
    y, bias = _map(c, dtype, layout)
    want = y + bias.view(1, -1, 1, 1)
    want = F.silu(want) if act else want
    ptr, strides = y.data_ptr(), y.stride()
    got = conv_epilogue(y, bias, act)
    assert got is y and y.data_ptr() == ptr and y.stride() == strides
    assert torch.equal(y, want)


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_fake_implementation_keeps_shape_and_strides(layout):
    """``opcheck``: the schema's mutation of y, the fake implementation
    against the CPU one (shapes, strides, dtypes) and the op's dispatch."""
    y, bias = _map(307, torch.bfloat16, layout)
    torch.library.opcheck(conv_epilogue_op, (y, bias, True),
                          test_utils=("test_schema", "test_faketensor"))
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode() as mode:
        fy, fb = mode.from_tensor(y), mode.from_tensor(bias)
        conv_epilogue_op(fy, fb, True)
        assert fy.shape == y.shape and fy.stride() == y.stride() and fy.dtype == y.dtype
        with pytest.raises(ValueError, match="channels-last or contiguous NCHW"):
            conv_epilogue_op(fy[:, :, ::2], fb, True)


@pytest.mark.parametrize("case,error,match", [
    ("strided", ValueError, "channels-last or contiguous NCHW"),
    ("permuted", ValueError, "channels-last or contiguous NCHW"),
    ("float16", TypeError, "f32 or bf16"),
    ("float16_bias", TypeError, "f32 or bf16"),
    ("bf16_bias", TypeError, "a bias of its dtype"),
    ("bias_len", ValueError, r"bias \[C\]"),
    ("bias_strided", ValueError, "contiguous bias"),
    ("three_dims", ValueError, r"\[N, C, H, W\]"),
    ("meta", ValueError, "cuda or cpu"),
])
def test_what_the_kernel_cannot_take_raises(case, error, match):
    y, bias = _map(16, torch.float32, "nchw")
    y = {"strided": y[:, :, :, ::2], "permuted": y.permute(0, 1, 3, 2),
         "float16": y.half(), "three_dims": y[0], "meta": y.to("meta")}.get(case, y)
    bias = {"float16_bias": bias.half(), "bf16_bias": bias.bfloat16(), "bias_len": bias[:15],
            "bias_strided": torch.randn(32)[::2], "meta": bias.to("meta")}.get(case, bias)
    before = y.clone() if y.device.type == "cpu" else None
    with pytest.raises(error, match=match):
        conv_epilogue(y, bias, True)
    if before is not None:
        assert torch.equal(y, before)


@pytest.mark.parametrize("dtype,c,hw,layout,offset,want", [
    (torch.bfloat16, 80, (20, 20), "channels_last", 0, "vector"),
    (torch.bfloat16, 307, (20, 20), "channels_last", 0, "elements"),
    (torch.float32, 3, (20, 20), "channels_last", 0, "elements"),
    (torch.float32, 3, (8, 8), "nchw", 0, "vector"),
    (torch.bfloat16, 80, (7, 7), "nchw", 0, "elements"),
    (torch.bfloat16, 80, (20, 20), "channels_last", 1, "elements"),
])
def test_expected_route(dtype, c, hw, layout, offset, want):
    """The vector path wants a 16-byte aligned base and whole vectors of
    one channel run: C (channels-last) or H*W (NCHW) a multiple of 8 bf16
    or 4 f32; an unaligned view of an aligned map takes ``elements``."""
    h, w = hw
    if offset:  # a channels-last map starting ``offset`` elements into its buffer
        buf = torch.zeros(offset + 2 * h * w * c, dtype=dtype)
        y = buf[offset:].view(2, h, w, c).permute(0, 3, 1, 2)
    else:
        y = torch.zeros(2, c, h, w, dtype=dtype).contiguous(memory_format=LAYOUTS[layout])
    assert epilogue.layout(y) == layout
    assert epilogue.expected_route(y, torch.zeros(c, dtype=dtype)) == want


@pytest.mark.parametrize("act", [True, False])
@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_deploy_conv_on_cpu_is_the_parents_conv_and_silu(layout, act):
    """Off the card a deploy ``ConvBnSiLU`` is ``F.silu(conv(x))`` with the
    bias inside torch's conv, bit for bit, and counts one biased conv and no
    epilogue, with grad on or off."""
    torch.manual_seed(0)
    m = ConvBnSiLU(12, 24, 3, act=act).eval()
    m.to_deploy()
    with torch.no_grad():
        m.conv.bias.normal_()
    m.to(memory_format=LAYOUTS[layout])
    x = torch.randn(2, 12, 9, 11).contiguous(memory_format=LAYOUTS[layout])
    want = F.conv2d(x, m.conv.weight, m.conv.bias, 1, 1)
    want = F.silu(want) if act else want
    for grad in (False, True):
        with torch.set_grad_enabled(grad), counted() as counts:
            got = m(x)
        assert torch.equal(got, want)
        assert counts == {"conv_biased": 1, "conv_epilogues": 0}


@pytest.mark.parametrize("act", [True, False])
def test_op_where_autograd_records_runs_and_refuses_a_backward(act):
    """With grad on and a conv's output that requires grad, the op gives
    the plain epilogue in place and marks y as changed; a backward through
    it raises, where torch would pass the conv's gradient on unchanged."""
    x = torch.randn(2, 4, 5, 5, requires_grad=True)
    w = torch.randn(6, 4, 3, 3, requires_grad=True)
    bias = torch.randn(6, requires_grad=True)
    y = F.conv2d(x, w, None, 1, 1)
    want = conv_epilogue_plain(y.detach(), bias.detach(), act)
    got = conv_epilogue(y, bias, act)
    assert torch.equal(got.detach(), want)
    assert got.grad_fn is not None and "Recorded" in type(got.grad_fn).__name__
    with pytest.raises(RuntimeError, match="no backward"):
        got.sum().backward()


def test_train_structure_never_counts_a_biased_conv():
    m = ConvBnSiLU(4, 8, 3)
    x = torch.randn(2, 4, 6, 6)
    for train in (True, False):
        m.train(train)
        with torch.no_grad(), counted() as counts:
            m(x)
        assert counts == {}


def test_counted_on_a_small_deploy_yolov8_forward():
    """``conv_biased`` is the forward's number of deploy ``ConvBnSiLU``
    calls, each module called once; ``conv_epilogues`` 0 on the CPU."""
    model = build_model("n", num_classes=3, deploy=True, device="cpu").eval()
    calls = []
    hooks = [m.register_forward_hook(lambda mod, a, o: calls.append(mod))
             for m in model.modules() if isinstance(m, ConvBnSiLU)]
    try:
        with torch.no_grad(), counted() as counts:
            model(torch.zeros(1, 3, 64, 64))
    finally:
        for h in hooks:
            h.remove()
    assert len(calls) == len(set(calls)) == 57
    assert counts == {"conv_biased": len(calls), "conv_epilogues": 0}
