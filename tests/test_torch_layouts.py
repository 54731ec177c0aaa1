"""The port's entry layouts (``yolo_ms_tpu_torch/infer/layouts.py``) on the CPU.

The port of ``tests/test_layouts.py``: ``AutoLayoutInfer`` is off on the
CPU, as the JAX class is off the TPU, and its outputs there are the plain
module's, bit for bit. Forced on (``ENABLED_ON`` given the CPU), the CPU
runs the network channels-last: the outputs equal the default layout's
(f32, rtol 1e-5 / atol 1e-5) for every batch shape; every ``Conv2d`` of a
deploy yolov8-n and yolo-ms-xs reads and writes channels-last memory but
the named exceptions; the split head's NHWC map views are contiguous; the
``Predictor`` matches the JAX ``Predictor(entry_layouts="auto")`` (which
takes its fallback on the CPU) at ``tests/test_torch_parity.py``'s
tolerances, with ``deploy`` True and False; both trained goldens are
reproduced; and the exported program round-trips with its channels-last
weights.
"""

from __future__ import annotations

import json
import os
import re

import numpy as np
import pytest
import torch
from torch import nn

import tests.torch_policy  # noqa: F401 - the port's thread policy
from yolo_ms_tpu_torch.data.augment import device_normalize_images
from yolo_ms_tpu_torch.data.decode import decode_and_resize
from yolo_ms_tpu_torch.infer import layouts
from yolo_ms_tpu_torch.infer.layouts import AutoLayoutInfer, not_channels_last
from yolo_ms_tpu_torch.infer.predictor import Predictor
from yolo_ms_tpu_torch.infer.program import ServingProgram, load_program
from yolo_ms_tpu_torch.models.deploy import fold_batchnorm
from yolo_ms_tpu_torch.models.registry import build_model, init_model
from yolo_ms_tpu_torch.ops.postprocess import fused_postprocess
from yolo_ms_tpu_torch.tools import export as tools_export
from yolo_ms_tpu_torch.utils.convert import load_npz

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden")
CASES = {"n": "trained", "yolo-ms-xs": "trained_yolo-ms-xs"}
CL = torch.channels_last
TOL = dict(rtol=1e-5, atol=1e-5)  # f32, one layout against the other
# the convs whose INPUT is not channels-last, and why: the first bottleneck
# of each C2f reads the first half of the block's first conv as a channel
# slice, a strided view in either layout (the conv copies it); its output is
# channels-last. yolo-ms-xs has none: its MS block adds two slices first.
NOT_CHANNELS_LAST_INPUTS = {
    "yolov8-n": re.compile(r"(backbone|neck)\.c2f_\d\.m_0\.conv1\.conv"),
    "yolo-ms-xs": None,
}


@pytest.fixture
def forced(monkeypatch):
    """The wrapper on for modules on the CPU, as on the card."""
    monkeypatch.setattr(layouts, "ENABLED_ON", ("cuda", "cpu"))


def _weights(arch: str) -> dict:
    return load_npz(os.path.join(GOLDEN, CASES[arch], "weights.npz"))


def _images(b: int = 2, h: int = 160, w: int = 160) -> torch.Tensor:
    """The golden fixture resized, then copies with numpy-seeded noise."""
    base = decode_and_resize(os.path.join(GOLDEN, "trained", "fixture_000.png"), h, w)
    rng = np.random.default_rng(0)
    noisy = [np.clip(base.astype(np.int16) + rng.integers(-8, 9, base.shape), 0, 255)
             for _ in range(b - 1)]
    return torch.from_numpy(np.stack([base, *noisy]).astype(np.uint8))


def _program(arch: str, dtype=torch.float32) -> ServingProgram:
    model = build_model(arch, num_classes=3, dtype=dtype, device="cpu", deploy=True)
    model.load_state_dict(fold_batchnorm(_weights(arch)), strict=True)
    return ServingProgram(model, 3, conf_thresh=0.25, dtype=dtype)


def _todays_path(program: ServingProgram, images_u8: torch.Tensor) -> dict:
    """The serving function before entry layouts: a contiguous NCHW copy in,
    NHWC views of the NCHW maps out."""
    x = device_normalize_images(images_u8, program.dtype).permute(0, 3, 1, 2).contiguous()
    raw = program.model(x, split_head=True)
    maps = [(b.permute(0, 2, 3, 1), c.permute(0, 2, 3, 1)) for b, c in raw]
    return fused_postprocess(maps, program.num_classes, conf_thresh=program.conf_thresh)


def _assert_outputs_close(got: dict, want: dict, **tol) -> None:
    assert torch.equal(got["valid"], want["valid"])
    assert torch.equal(got["classes"], want["classes"])
    for key in ("boxes", "scores"):
        torch.testing.assert_close(got[key], want[key], **tol)


def test_disabled_on_cpu_is_the_plain_module():
    program = _program("n")
    wrapped = AutoLayoutInfer(program)
    assert wrapped._disabled and wrapped.image_format() is None
    assert program.memory_format == torch.contiguous_format
    assert all(p.is_contiguous() for p in program.parameters())
    images = _images()
    with torch.inference_mode():
        got, want = wrapped(images), _todays_path(_program("n"), images)
    assert want["valid"].any()
    for key in want:
        assert torch.equal(got[key], want[key]), key


@pytest.mark.parametrize("arch", list(CASES))
def test_forced_on_matches_default_layout(forced, arch):
    program, default = _program(arch), _program(arch)
    wrapped = AutoLayoutInfer(program)
    assert wrapped.image_format() == CL and program.memory_format == CL
    assert not_channels_last(program) == []
    assert not_channels_last(default)  # the default layout's weights are NCHW
    images = _images()
    with torch.inference_mode():
        x = program.network_input(images)
        assert x.is_contiguous(memory_format=CL)
        got, want = wrapped(images), default(images)
        maps = program.model(x, split_head=True)
        want_maps = default.model(default.network_input(images), split_head=True)
    assert want["valid"].any()
    _assert_outputs_close(got, want, **TOL)
    for pair, want_pair in zip(maps, want_maps):
        for m, w in zip(pair, want_pair):
            assert m.permute(0, 2, 3, 1).is_contiguous()  # the select kernel's rows
            torch.testing.assert_close(m, w, **TOL)


def test_forced_on_per_shape_use(forced):
    """One wrapper, converted once, serves every batch shape."""
    program, default = _program("n"), _program("n")
    wrapped = AutoLayoutInfer(program)
    for b, h, w in ((1, 96, 128), (3, 64, 64), (2, 160, 160)):
        images = _images(b, h, w)
        with torch.inference_mode():
            got, want = wrapped(images), default(images)
        assert got["boxes"].shape == (b, 300, 4)
        _assert_outputs_close(got, want, **TOL)


def test_forced_on_raises_where_weights_stay_nchw(forced):
    class Stubborn(nn.Conv2d):
        def _apply(self, fn, recurse=True):  # ignores every conversion
            return self

    program = _program("n")
    branch = program.model.head.box_0.conv1
    conv = branch.conv  # 3x3: a 1x1 kernel's NCHW memory is channels-last as well
    stubborn = Stubborn(conv.in_channels, conv.out_channels, 3, padding=1)
    stubborn.load_state_dict(conv.state_dict())
    branch.conv = stubborn
    with pytest.raises(RuntimeError, match=r"head\.box_0\.conv1\.conv\.weight"):
        AutoLayoutInfer(program)


def test_forced_on_later_converts_at_first_call():
    """The JAX test's way of forcing the wrapper on: ``_disabled`` set after
    construction; the weights convert at the first call."""
    program, default = _program("n"), _program("n")
    wrapped = AutoLayoutInfer(program)
    wrapped._disabled = False
    images = _images()
    with torch.inference_mode():
        got, want = wrapped(images), default(images)
    assert program.memory_format == CL and not_channels_last(program) == []
    _assert_outputs_close(got, want, **TOL)


@pytest.mark.parametrize("arch", ["yolov8-n", "yolo-ms-xs"])
def test_every_conv_runs_channels_last(forced, arch):
    """A forward hook on every ``Conv2d`` of the deploy model: input and
    output channels-last, but the inputs named in
    ``NOT_CHANNELS_LAST_INPUTS``; the head's maps as contiguous NHWC."""
    model = init_model(build_model(arch, num_classes=3, device="cpu"),
                       torch.Generator().manual_seed(0))
    predictor = Predictor(arch, model.state_dict(), 3, input_size=(64, 64), device="cpu")
    seen, strided_in, strided_out, maps = [], [], [], []

    def check(name):
        def hook(module, args, out):
            seen.append(name)
            if not args[0].is_contiguous(memory_format=CL):
                strided_in.append(name)
            if not out.is_contiguous(memory_format=CL):
                strided_out.append(name)
        return hook

    hooks = [m.register_forward_hook(check(n)) for n, m in predictor.model.named_modules()
             if isinstance(m, nn.Conv2d)]
    hooks.append(predictor.model.head.register_forward_hook(
        lambda module, args, out: maps.extend(out)))
    try:
        predictor.infer(_images(2, 64, 64))
    finally:
        for h in hooks:
            h.remove()
    assert len(seen) == sum(isinstance(m, nn.Conv2d) for m in predictor.model.modules())
    assert strided_out == []
    want = NOT_CHANNELS_LAST_INPUTS[arch]
    assert strided_in == [n for n in seen if want is not None and want.fullmatch(n)]
    if want is not None:
        assert strided_in  # the exception is real, and listed
    assert len(maps) == 3
    for box, cls in maps:
        assert box.permute(0, 2, 3, 1).is_contiguous() and cls.permute(0, 2, 3, 1).is_contiguous()


def _jax_variables(arch: str) -> dict:
    tree = {}
    with np.load(os.path.join(GOLDEN, CASES[arch], "weights.npz")) as z:
        for key in z.files:
            node = tree
            *parents, leaf = key.split("/")
            for p in parents:
                node = node.setdefault(p, {})
            node[leaf] = z[key]
    return {"params": tree["params"], "batch_stats": tree["batch_stats"]}


@pytest.mark.parametrize("deploy", [True, False])
def test_forced_on_matches_jax_predictor(forced, deploy):
    """The golden yolov8-n weights through the JAX ``Predictor`` (its
    default ``entry_layouts="auto"``, the fallback on the CPU; ``deploy=
    False`` is ``tests/test_deploy.py``'s unfolded case) and the port's
    forced channels-last ``Predictor`` on the same numpy inputs: ``valid``
    and ``classes`` equal, boxes and scores within rtol 1e-3 / atol 2e-2,
    boxes within 1e-3 of their largest coordinate."""
    from yolo_ms_tpu.infer.predictor import Predictor as JaxPredictor

    kw = dict(num_classes=3, input_size=(160, 160), conf_thresh=0.25, batch_size=2,
              deploy=deploy)
    images = _images().numpy()
    want = JaxPredictor("n", _jax_variables("n"), **kw).predict_batch(images)
    predictor = Predictor("n", _weights("n"), device="cpu", **kw)
    assert predictor.deploy is deploy
    assert any(isinstance(m, nn.BatchNorm2d) for m in predictor.model.modules()) is not deploy
    assert predictor.serve.memory_format == CL
    got = predictor.predict_batch(images)
    v = np.asarray(want["valid"])
    assert v.any()
    np.testing.assert_array_equal(got["valid"], v)
    np.testing.assert_array_equal(got["classes"][v], np.asarray(want["classes"])[v])
    for key in ("boxes", "scores"):
        np.testing.assert_allclose(got[key][v], np.asarray(want[key])[v], rtol=1e-3, atol=2e-2,
                                   err_msg=key)
    boxes = np.asarray(want["boxes"])[v]
    assert np.abs(got["boxes"][v] - boxes).max() / np.abs(boxes).max() < 1e-3


def _golden_match(got: list, golden: list) -> None:
    """The rule of tests/test_trained_golden.py: same count; each golden
    detection matched once by class, IoU > 0.9 and score within 0.02."""

    def iou(a, b):
        ix1, iy1 = max(a[0], b[0]), max(a[1], b[1])
        ix2, iy2 = min(a[2], b[2]), min(a[3], b[3])
        inter = max(0.0, ix2 - ix1) * max(0.0, iy2 - iy1)
        ua = (a[2] - a[0]) * (a[3] - a[1]) + (b[2] - b[0]) * (b[3] - b[1]) - inter
        return inter / max(ua, 1e-9)

    assert len(got) == len(golden), (got, golden)
    unmatched = list(got)
    for g in golden:
        hit = next((d for d in unmatched if d["class_id"] == g["class_id"]
                    and iou(d["box_xyxy"], g["box_xyxy"]) > 0.9
                    and abs(d["score"] - g["score"]) < 0.02), None)
        assert hit is not None, f"golden detection unmatched: {g} in {got}"
        unmatched.remove(hit)


@pytest.mark.parametrize("arch", list(CASES))
def test_forced_on_reproduces_goldens(forced, tmp_path, arch):
    """``predict_paths`` (the pipelined loop, its host buffers NHWC uint8)
    under forced channels-last, f32: the network takes the buffer's batch
    as channels-last memory, and the golden detections come out."""
    gdir = os.path.join(GOLDEN, CASES[arch])
    predictor = Predictor(arch, _weights(arch), num_classes=3, input_size=(160, 160),
                          conf_thresh=0.25, iou_thresh=0.45, device="cpu")
    entries = []
    hook = predictor.model.register_forward_pre_hook(
        lambda module, args: entries.append(args[0].is_contiguous(memory_format=CL)))
    try:
        results = predictor.predict_paths(os.path.join(gdir, "fixture_000.png"), str(tmp_path),
                                          verbose=False)
    finally:
        hook.remove()
    assert entries == [True]
    with open(os.path.join(gdir, "fixture_000_detections.json")) as f:
        _golden_match(next(iter(results.values())), json.load(f))


def test_deploy_false_takes_a_folded_state_dict_as_it_is():
    predictor = Predictor("n", fold_batchnorm(_weights("n")), num_classes=3,
                          input_size=(64, 64), deploy=False, device="cpu")
    assert predictor.deploy is True


def test_entry_layouts_other_than_auto_or_default_raise(tmp_path):
    with pytest.raises(ValueError, match="entry_layouts"):
        Predictor("n", _weights("n"), num_classes=3, input_size=(64, 64),
                  entry_layouts="bogus", device="cpu")
    with pytest.raises(ValueError, match="entry_layouts"):
        tools_export.export_program(fold_batchnorm(_weights("n")), "n", 3,
                                    str(tmp_path / "x.pt2"), img_size=(64, 64), device="cpu",
                                    entry_layouts="bogus")
    assert not os.listdir(tmp_path)


def test_export_forced_channels_last_round_trips(forced, tmp_path):
    """``export_program(entry_layouts="auto")`` traces the program in
    channels-last; ``load_program`` gives back channels-last weights and the
    eager program's outputs (``tests/test_torch_program.py``'s tolerance)."""
    path = str(tmp_path / "serve.pt2")
    info = tools_export.export_program(fold_batchnorm(_weights("n")), "n", 3, path, batch=2,
                                       img_size=(160, 160), device="cpu")
    assert info["memory_format"] == "channels_last"
    program = load_program(path, device="cpu")
    assert not_channels_last(program) == []
    predictor = Predictor("n", _weights("n"), num_classes=3, input_size=(160, 160),
                          dtype=torch.bfloat16, device="cpu")
    images = _images()
    with torch.inference_mode():
        got = program(images)
    want = predictor.infer(images)
    assert want["valid"].any()
    _assert_outputs_close(got, want, rtol=1e-5, atol=1e-4)


def test_export_raises_where_the_file_loses_channels_last(forced, monkeypatch, tmp_path):
    monkeypatch.setattr(tools_export, "not_channels_last", lambda module: ["a.weight"])
    with pytest.raises(RuntimeError, match="lost the channels-last layout"):
        tools_export.export_program(fold_batchnorm(_weights("n")), "n", 3,
                                    str(tmp_path / "serve.pt2"), img_size=(64, 64),
                                    device="cpu")
    assert not os.listdir(tmp_path)


@pytest.mark.parametrize("fmt", [CL, torch.contiguous_format])
@pytest.mark.parametrize("index", [0, 1])
def test_halo_rows_keep_the_memory_format(fmt, index):
    """``gather_rows`` of a height-sharded 3x3 conv (two ranks; the other
    rank's rows handed over in place of the messages): the rows of the
    whole map with the zero padding, in the memory format of this rank's
    map, so that a channels-last network stays channels-last when served
    height-sharded (``serve_height_sharded``)."""
    from yolo_ms_tpu_torch.parallel.spatial import HeightShards, conv_rows, row_partition

    whole = torch.randn(2, 8, 10, 6).contiguous(memory_format=fmt)
    h = whole.shape[2]
    parts = row_partition(h, 2)
    needs = [conv_rows(o, 3, 1, 1) for o in parts]
    shards = HeightShards(None, [0, 1], index)

    def send_recv(sends, recvs):  # the other rank's rows, as its messages carry them
        _, plan = shards._plan(h, tuple(needs))
        for r, buf in recvs.items():
            buf.copy_(whole[:, :, plan[r][0] : plan[r][1]])
        return recvs

    shards._send_recv = send_recv
    lo, hi = parts[index]
    got = shards.gather_rows(whole[:, :, lo:hi].contiguous(memory_format=fmt), h, needs, 0.0)
    a, e = needs[index]
    want = torch.nn.functional.pad(whole, (0, 0, 1, 1))[:, :, a + 1 : e + 1]
    assert torch.equal(got, want)
    assert got.is_contiguous(memory_format=fmt)
