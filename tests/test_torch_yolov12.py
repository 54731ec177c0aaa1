"""YOLOv12-L of the port (``models/yolo12.py``, ``ops/attention.py``) against
the benchmark's plain float32 reference (``portbench/reference/arch/
yolov12.py``) on the CPU, at the published widths and small images.

The port and the reference load one seeded state_dict. In float32 they
agree to 2e-6 on head maps of spread ~1-9 (SDPA's fused softmax against the
explicit matmuls, BatchNorm folded into the convs: the same sums in another
order), so ``TOL`` (1e-4 absolute) leaves 50x of room; a wrong attention
(area 1 at P4, or the R-ELAN branch dropped) moves the maps by more.
P4 is 8x8 (128 px) or 10x10 (160 px) tokens, cut into 4 runs of 16 or 25:
at 160 px a run is not a whole number of rows.
"""

import pytest
import torch

import tests.torch_policy  # noqa: F401 - the port's thread policy
from portbench import run
from portbench.reference.model import Detector, forward_flops
from portbench.weights import seeded_state_dict
from yolo_ms_tpu_torch.models.deploy import fold_batchnorm
from yolo_ms_tpu_torch.models.registry import build_model, count_params
from yolo_ms_tpu_torch.models.yolo12 import YOLOv12
from yolo_ms_tpu_torch.nn.blocks import AAttn
from yolo_ms_tpu_torch.utils.profiler import counted

SEED = 2**31 + 11
TOL = 1e-4  # absolute, on the head's maps: 50x the float32 disagreement measured


def _cfg(img=160):
    cfg = run.load_json("configs", "yolov12-l.json")
    cfg.update(image_size=[img, img])
    return cfg


@pytest.fixture(scope="module")
def state_dict():
    return seeded_state_dict(_cfg(), SEED, "cpu")


def _reference(cfg, sd):
    ref = Detector(cfg).eval()
    ref.load_state_dict(sd)
    return ref


@pytest.fixture(scope="module")
def reference_maps(state_dict):
    """The reference's head maps on one image, per image size."""
    ref = _reference(_cfg(), state_dict)
    return {img: _maps(ref, _image(img)) for img in (128, 160)}


def _maps(model, x, **kw):
    with torch.no_grad():
        return [m for pair in model(x, **kw) for m in pair]


def _image(img):
    return torch.randn(1, 3, img, img, generator=torch.Generator().manual_seed(0))


@pytest.mark.parametrize("deploy", [False, True])
@pytest.mark.parametrize("img", [128, 160])
def test_port_matches_the_reference_in_float32(state_dict, reference_maps, img, deploy):
    port = build_model("yolov12-l", num_classes=80, device="cpu", deploy=deploy)
    port.load_state_dict(fold_batchnorm(state_dict) if deploy else state_dict, strict=True)
    got, want = _maps(port, _image(img), split_head=True), reference_maps[img]
    assert [tuple(m.shape) for m in got] == [tuple(m.shape) for m in want]
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0.0, atol=TOL)


@pytest.mark.parametrize("change", ["area 1 at P4", "R-ELAN branch dropped"])
def test_a_wrong_attention_moves_the_maps_past_the_tolerance(state_dict, reference_maps, change):
    """The control: the reference with one piece of the mechanism changed
    differs from the right one by more than ``TOL``, so the parity test
    sees it."""
    cfg, sd = _cfg(), state_dict
    if change == "area 1 at P4":
        cfg["area"] = [1, 1]
    else:
        sd = {k: torch.zeros_like(v) if k.endswith("gamma") else v for k, v in sd.items()}
    wrong = _maps(_reference(cfg, sd), _image(160))
    gap = max(float((a - b).abs().max()) for a, b in zip(reference_maps[160], wrong))
    assert gap > 3 * TOL


def test_area_attention_is_separate_attentions_over_contiguous_runs():
    """``AAttn`` with area 4 on a 10x10 map equals, run by run of 25
    row-major tokens (two and a half rows) and head by head, an explicit
    softmax attention over ``[heads, (q | k | v), 32]`` channels."""
    torch.manual_seed(0)
    dim, heads, area = 64, 2, 4
    mod = AAttn(dim, heads, area).eval()
    for m in mod.modules():
        if isinstance(m, torch.nn.BatchNorm2d):
            m.running_mean.normal_(0.0, 0.1)
            m.running_var.uniform_(0.5, 2.0)
    x = torch.randn(2, dim, 10, 10)
    d, run_len = dim // heads, 100 // area
    with torch.no_grad():
        got = mod(x)
        qkv = mod.qkv(x).flatten(2).transpose(1, 2)  # [B, 100 tokens, 3C]
        out, v = torch.empty(2, 100, dim), torch.empty(2, 100, dim)
        for h in range(heads):
            q, k, v[..., d * h : d * (h + 1)] = qkv[..., 3 * d * h : 3 * d * (h + 1)].split(d, -1)
            for r in range(area):
                t = slice(r * run_len, (r + 1) * run_len)
                p = torch.softmax(q[:, t] @ k[:, t].transpose(1, 2) / d**0.5, dim=-1)
                out[:, t, d * h : d * (h + 1)] = p @ v[:, t, d * h : d * (h + 1)]
        as_map = lambda t: t.transpose(1, 2).reshape(2, dim, 10, 10)  # noqa: E731
        want = mod.proj(as_map(out) + mod.pe(as_map(v)))
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("memory_format", [torch.contiguous_format, torch.channels_last])
def test_the_sdpa_path_equals_the_explicit_softmax(memory_format):
    """The port's ``AAttn`` (SDPA) against the reference's (explicit
    matmuls and softmax) on one state_dict, in either layout; ``counted``
    counts the call's shapes."""
    from portbench.reference.model import family

    torch.manual_seed(1)
    b, c, heads, area, h, w = 2, 64, 2, 4, 6, 10
    ref = family("yolov12").AAttn(c, heads, area).eval()
    for m in ref.modules():
        if isinstance(m, torch.nn.BatchNorm2d):
            m.running_mean.normal_(0.0, 0.1)
            m.running_var.uniform_(0.5, 2.0)
    port = AAttn(c, heads, area).eval()
    port.load_state_dict(ref.state_dict(), strict=True)
    port.to(memory_format=memory_format)
    x = torch.randn(b, c, h, w)
    with torch.no_grad(), counted() as counts:
        got = port(x.contiguous(memory_format=memory_format))
    with torch.no_grad():
        want = ref(x)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    assert got.is_contiguous(memory_format=memory_format)
    tokens = h * w // area
    assert counts == {"attn_head_dim": c // heads, "attn_calls": 1,
                      "attn_rows": b * area * heads * tokens,
                      "attn_scores": b * area * heads * tokens**2}


def test_parameters_and_forward_flops_are_the_published_ones():
    with torch.device("meta"):  # shapes alone: no weights drawn
        assert count_params(YOLOv12()) == 26_450_768
    assert round(forward_flops(_cfg(640), (640, 640)) / 1e9, 2) == 95.43
