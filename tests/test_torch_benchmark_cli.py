"""The port's benchmark CLI (``yolo_ms_tpu_torch/tools/benchmark.py``) on the
CPU, held against the JAX module (``yolo_ms_tpu/tools/benchmark.py``): the
copied fixture writer and overlap harness, the per-iteration inputs and the
train batch, the report keys (the ``e2e`` and streaming reports add the
serving layout, ``entry_layouts`` and ``memory_format``), the streaming run
and the CLI's options. No
JAX model is compiled here (``tests/test_benchmark_cli.py`` compiles the
JAX side); rates measured here are CPU rates, checked only for sign.
"""

from __future__ import annotations

import json
import os
import re
import time
from concurrent.futures import ThreadPoolExecutor

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tests.torch_policy  # noqa: F401 - the port's thread policy
from tests.test_benchmark_cli import REPORT_KEYS
from yolo_ms_tpu.tools import benchmark as jax_bench
from yolo_ms_tpu_torch.infer import layouts
from yolo_ms_tpu_torch.tools import benchmark as bench

LAYOUT_KEYS = {"entry_layouts", "memory_format"}  # the serving modes' report adds these

STREAMING_KEYS = {
    "arch", "mode", "batch", "img_size", "n_images", "threads", "native_loader",
    "entry_layouts", "memory_format", "device", "sustained_img_per_s",
    "host_decode_img_per_s", "host_decode_cpu_s_per_img", "cores_per_chip_derived",
    "h2d_img_per_s", "h2d_mb_per_s", "device_only_img_per_s", "bound",
}


def test_stream_fixture_bytes_equal_jax(tmp_path):
    ours = bench.ensure_stream_fixture(str(tmp_path / "port"), 6, seed=1)
    theirs = jax_bench.ensure_stream_fixture(str(tmp_path / "jax"), 6, seed=1)
    assert [os.path.basename(p) for p in ours] == [os.path.basename(p) for p in theirs]
    for a, b in zip(ours + [os.path.join(tmp_path, "port", "manifest.txt")],
                    theirs + [os.path.join(tmp_path, "jax", "manifest.txt")]):
        with open(a, "rb") as fa, open(b, "rb") as fb:
            assert fa.read() == fb.read(), a
    # a second call, and a call on the JAX package's fixture, rewrite nothing
    for paths in (ours, theirs):
        mtimes = [os.path.getmtime(p) for p in paths]
        again = bench.ensure_stream_fixture(os.path.dirname(paths[0]), 6, seed=1)
        assert again == paths
        assert [os.path.getmtime(p) for p in again] == mtimes


@pytest.mark.parametrize("h_ms,d_ms", [(30.0, 10.0), (10.0, 30.0), (20.0, 20.0)])
def test_pipelined_sustained_overlap(h_ms, d_ms):
    """The JAX test's calibrated legs and bounds: a sleep on the producer
    thread (host) against a one-lane executor (device); the wall per item
    tracks the slower leg, not the sum of both."""
    n = 24
    with ThreadPoolExecutor(max_workers=1) as device:

        def produce(_):
            time.sleep(h_ms / 1e3)
            return object()

        def dispatch(_payload):
            return device.submit(time.sleep, d_ms / 1e3)

        elapsed, done = bench.pipelined_sustained(
            range(n), produce, dispatch, lambda f: f.result(), depth=4
        )
    assert done == n
    per_item_ms = elapsed / n * 1e3
    floor, serial = max(h_ms, d_ms), h_ms + d_ms
    assert per_item_ms < floor + 0.45 * (serial - floor), (
        f"h={h_ms} d={d_ms}: {per_item_ms:.1f} ms/item: overlap lost")
    assert per_item_ms > 0.9 * floor, (
        f"h={h_ms} d={d_ms}: {per_item_ms:.1f} ms/item is faster than the slower leg")


def _jax_inputs(mode, batch, img_size):
    """What the JAX ``run_benchmark`` builds for ``mode`` (its lines, on
    the same generator)."""
    rng = np.random.default_rng(0)
    if mode == "e2e":
        return jnp.asarray(
            rng.integers(0, 256, (batch, img_size, img_size, 3), dtype=np.uint8))
    if mode == "forward":
        return jnp.asarray(rng.standard_normal((batch, img_size, img_size, 3)), jnp.bfloat16)
    max_gt = 32
    return {
        "images": jnp.asarray(rng.standard_normal((batch, img_size, img_size, 3)), jnp.float32),
        "boxes": jnp.tile(jnp.asarray([0.5, 0.5, 0.4, 0.4], jnp.float32), (batch, max_gt, 1)),
        "labels": jnp.zeros((batch, max_gt), jnp.int32),
        "mask": jnp.asarray(np.arange(max_gt)[None, :] < 8, jnp.bool_).repeat(batch, axis=0),
    }


def _host(x: torch.Tensor) -> np.ndarray:
    return (x.float() if x.dtype == torch.bfloat16 else x).numpy()


@pytest.mark.parametrize("mode", ["e2e", "forward"])
def test_iteration_inputs_equal_jax(mode):
    """Iteration i's input equals JAX's ``imgs + i.astype(uint8)`` (uint8,
    wrapping at 256) or ``imgs + i.astype(bf16) * 1e-3`` (bf16), bit for bit."""
    want0 = _jax_inputs(mode, 2, 16)
    host = bench._inputs(mode, 2, 16)["images"]
    x = torch.from_numpy(host)
    if mode == "forward":
        x = x.to(torch.bfloat16)
    for i in (0, 1, 7, 49, 255, 256, 257):
        ji = jnp.asarray(i, jnp.int32)
        if mode == "e2e":
            want = want0 + ji.astype(jnp.uint8)
        else:
            want = want0 + ji.astype(jnp.bfloat16) * 1e-3
        got = bench._shifted(x, i)
        assert got.dtype == x.dtype
        np.testing.assert_array_equal(_host(got), np.asarray(want, np.float32)
                                      if mode == "forward" else np.asarray(want))
    if mode == "e2e":  # the wrap: 255 -> 0
        np.testing.assert_array_equal(bench._shifted(x, 256).numpy(), host)
        assert not np.array_equal(bench._shifted(x, 255).numpy(), host)


def test_train_batch_equals_jax():
    want = _jax_inputs("train", 3, 16)
    got = bench._inputs("train", 3, 16)
    assert set(got) == set(want)
    for key, value in want.items():
        assert got[key].dtype == np.asarray(value).dtype, key
        np.testing.assert_array_equal(got[key], np.asarray(value), err_msg=key)
    x = torch.from_numpy(got["images"])
    for i in (0, 3, 300):
        want_i = want["images"] + jnp.asarray(i, jnp.int32).astype(jnp.float32) * 1e-3
        np.testing.assert_array_equal(bench._shifted(x, i).numpy(), np.asarray(want_i))


@pytest.mark.parametrize("mode,batch", [("forward", 1), ("e2e", 1), ("train", 2)])
def test_run_benchmark_report(mode, batch):
    r = bench.run_benchmark("n", batch, mode, img_size=64, num_classes=4, k=1, reps=1,
                            device="cpu")
    assert set(r) == REPORT_KEYS | (LAYOUT_KEYS if mode == "e2e" else set())
    assert r["arch"] == "n" and r["mode"] == mode and r["batch"] == batch
    assert r["device"] == "cpu"
    assert r["k_wall_ms_per_batch"] > 0 and r["k_wall_img_per_s"] > 0
    assert r["steady_state_ms_per_batch"] > 0 and r["steady_state_img_per_s"] > 0
    assert r["steady_state_ms_per_batch"] <= r["k_wall_ms_per_batch"] * 1.5


def test_train_mode_state_is_live():
    """The port of the JAX test: one iteration moves the live state (step
    1, Adam's first moment non-zero: the warm-up LR is 0 at step 0, so the
    parameters may not move), and the loop's runs keep updating the same
    state: the step counter counts every iteration, warm-up included."""
    loop = bench.make_loop("n", 2, "train", img_size=64, num_classes=4, device="cpu")
    params0 = loop.state.params.clone()
    metrics = loop.run(0)
    assert int(loop.state.step) == 1
    assert float(metrics["skipped_nonfinite"]) == 0.0
    assert float(loop.state.opt_state["mu"].abs().sum()) > 0.0
    assert torch.isfinite(loop(1))
    assert int(loop.state.step) == 2
    assert not torch.equal(loop.state.params, params0)
    bench._loop_rates(loop, 1, 1, loop.device)
    assert int(loop.state.step) == 2 + bench.iterations_run(1, 1)


def test_e2e_iteration_is_predictor_infer():
    """The e2e iteration is the serving function at ``Predictor``'s
    defaults, on the seed-0 weights: iteration 0 equals a ``Predictor``
    built from the same draws on the same images."""
    from yolo_ms_tpu_torch.infer.predictor import Predictor
    from yolo_ms_tpu_torch.models.registry import build_model, init_model

    loop = bench.make_loop("n", 2, "e2e", img_size=64, num_classes=4, device="cpu")
    model = init_model(build_model("n", num_classes=4, device="cpu"),
                       torch.Generator().manual_seed(0))
    predictor = Predictor("n", model.state_dict(), 4, input_size=(64, 64),
                          dtype=torch.bfloat16, device="cpu")
    images = torch.from_numpy(bench._inputs("e2e", 2, 64)["images"])
    got, want = loop.run(0), predictor.infer(images)
    for key in want:
        assert torch.equal(got[key], want[key]), key
    assert torch.equal(loop(0), want["scores"].sum() + want["boxes"].sum())


def test_run_streaming_report(tmp_path):
    fx = str(tmp_path / "fixture")
    bench.ensure_stream_fixture(fx, 8, seed=1)
    r = bench.run_streaming("n", batch=4, img_size=64, num_classes=4, images_dir=fx,
                            n_images=8, threads=2, depth=2, device="cpu")
    assert set(r) == STREAMING_KEYS
    assert r["mode"] == "streaming"
    assert r["n_images"] == 8
    assert r["entry_layouts"] == "auto"
    assert r["memory_format"] == "contiguous_format"  # auto is off on the CPU
    assert r["sustained_img_per_s"] > 0
    assert r["host_decode_img_per_s"] > 0
    assert r["h2d_img_per_s"] > 0
    assert r["device_only_img_per_s"] > 0
    assert r["bound"] in ("host", "transfer", "device", "balanced")
    assert r["host_decode_cpu_s_per_img"] > 0
    assert r["cores_per_chip_derived"] > 0


def _options(main, capsys) -> tuple[set, set]:
    """The options and choice sets that ``main --help`` prints."""
    with pytest.raises(SystemExit):
        main(["--help"])
    text = capsys.readouterr().out
    return set(re.findall(r"--[a-z_]+", text)), set(re.findall(r"\{[a-z0-9_,]+\}", text))


def _calls(module, monkeypatch, argv) -> list:
    """``module.main(argv)`` with its two runners recorded, not run."""
    calls = []

    def record(name):
        def fake(*args, **kwargs):
            calls.append((name, args, kwargs))
            return {"arch": args[0]}
        return fake

    monkeypatch.setattr(module, "run_benchmark", record("run_benchmark"))
    monkeypatch.setattr(module, "run_streaming", record("run_streaming"))
    module.main(argv)
    return calls


def test_cli_options_and_defaults_equal_jax(capsys, monkeypatch):
    ours, theirs = _options(bench.main, capsys), _options(jax_bench.main, capsys)
    assert ours[0] == theirs[0] | {"--device"}
    assert ours[1] == theirs[1]
    for argv in ([], ["--mode", "streaming"], ["--mode", "train", "--arch", "s"]):
        got = _calls(bench, monkeypatch, argv)
        capsys.readouterr()
        want = _calls(jax_bench, monkeypatch, argv)
        capsys.readouterr()
        # the JAX CLI passes entry_layouts to its streaming run only
        port_only = {"device"} | ({"entry_layouts"} if got[0][0] == "run_benchmark" else set())
        assert [(n, a, {k: v for k, v in kw.items() if k not in port_only})
                for n, a, kw in got] == want
        assert got[0][2]["device"] is None
        assert got[0][2]["entry_layouts"] == "auto"


@pytest.mark.parametrize("entry_layouts,forced,want", [
    ("default", True, "contiguous_format"),
    ("auto", False, "contiguous_format"),
    ("auto", True, "channels_last"),
])
def test_entry_layouts_selects_the_serving_layout(monkeypatch, capsys, entry_layouts, forced,
                                                  want):
    """``--entry_layouts`` reaches the e2e and streaming predictors and the
    report echoes the memory format that the network ran in: channels-last
    only under ``auto`` where the wrapper is on (the card; the CPU here
    when forced), contiguous NCHW otherwise."""
    if forced:
        monkeypatch.setattr(layouts, "ENABLED_ON", ("cuda", "cpu"))
    loop = bench.make_loop("n", 1, "e2e", img_size=64, num_classes=4, device="cpu",
                           entry_layouts=entry_layouts)
    assert layouts.memory_format_name(loop.predictor.serve.memory_format) == want
    out = loop.run(0)
    assert out["valid"].shape == (1, 300)
    calls = _calls(bench, monkeypatch, ["--entry_layouts", entry_layouts])
    assert calls[0][2]["entry_layouts"] == entry_layouts
    calls = _calls(bench, monkeypatch, ["--mode", "streaming", "--entry_layouts", entry_layouts])
    assert calls[0][2]["entry_layouts"] == entry_layouts
    capsys.readouterr()


def test_entry_layouts_errors():
    with pytest.raises(ValueError, match="entry_layouts"):
        bench.make_loop("n", 1, "e2e", img_size=64, num_classes=4, device="cpu",
                        entry_layouts="bogus")
    with pytest.raises(ValueError, match="serves nothing"):
        bench.make_loop("n", 1, "forward", img_size=64, num_classes=4, device="cpu",
                        entry_layouts="default")
    with pytest.raises(ValueError, match="entry_layouts"):
        bench.run_streaming("n", 2, img_size=64, num_classes=4, entry_layouts="bogus",
                            device="cpu")


def test_cli_prints_one_json_line(capsys):
    bench.main(["--device", "cpu", "--arch", "n", "--batch", "1", "--mode", "forward",
                "--img_size", "64", "--num_classes", "4", "--k", "1", "--reps", "1"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    assert set(json.loads(lines[0])) == REPORT_KEYS


def test_no_card_raises_instead_of_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench.run_benchmark("n", 1, "forward", img_size=64, num_classes=4, k=1, reps=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench.main(["--arch", "n", "--batch", "1", "--img_size", "64", "--k", "1"])
