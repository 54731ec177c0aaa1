"""The port's serving tools on the CPU: the reference ``.pt`` mapping,
``tools.{test,val,export,analyze,visualize}``, ``predict_video`` and the
profiler, held against the JAX package's recorded outputs (the trained
goldens), its numpy-only functions and the port's verified modules. No JAX
model is compiled here.

The module imports no JAX at its top: ``chip_smoke.py`` loads
``reference_state_dict`` from this file by path on a machine without JAX.
"""

from __future__ import annotations

import json
import os
import re

import numpy as np
import pytest
import torch

from tests.torch_policy import NullLogger
from yolo_ms_tpu_torch.models.deploy import fold_batchnorm
from yolo_ms_tpu_torch.models.registry import build_model
from yolo_ms_tpu_torch.utils.convert import load_npz

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden")
V8_NPZ = os.path.join(GOLDEN, "trained", "weights.npz")
V8_FIXTURE = os.path.join(GOLDEN, "trained", "fixture_000.png")
V8_DETECTIONS = os.path.join(GOLDEN, "trained", "fixture_000_detections.json")


@pytest.fixture
def no_tensorboard(monkeypatch):
    from yolo_ms_tpu_torch.train import trainer

    monkeypatch.setattr(trainer, "MetricLogger", NullLogger)


# ----------------------------------------------------------------------------
# The inverse of the .pt mapping: flax-layout npz -> reference state_dict
# ----------------------------------------------------------------------------

_HEAD_SEQ = {"conv1": "0", "conv2": "1", "pred": "2"}
_STATS = {"mean": "running_mean", "var": "running_var"}


def reference_state_dict(npz_path: str) -> dict[str, torch.Tensor]:
    """A flat "/"-keyed flax variables npz -> a state_dict in the reference's
    key grammar (yolov8.py): ``m_{i}`` -> ``m.{i}``, head ``{box,cls}_{l}``
    ``conv1/conv2/pred`` -> ``head.{box,cls}.{l}.{0,1,2}``, HWIO -> OIHW, BN
    scale/bias/mean/var -> weight/bias/running_mean/running_var, plus the
    ``num_batches_tracked`` counters and the frozen ``head.dfl.conv.weight``."""
    sd = {}
    with np.load(npz_path) as z:
        for key in z.files:
            coll, *mod, leaf = key.split("/")
            arr = z[key]
            if mod[0] == "head":
                branch, lvl = mod[1].split("_")
                mod = ["head", branch, lvl, _HEAD_SEQ[mod[2]]] + mod[3:]
            else:
                mod = [p for m in mod for p in (m.split("_") if re.fullmatch(r"m_\d+", m) else [m])]
            if coll == "params":
                if leaf == "kernel":
                    name, arr = "weight", arr.transpose(3, 2, 0, 1)
                else:
                    name = "weight" if leaf == "scale" else "bias"
            else:
                name = _STATS[leaf]
                if leaf == "mean":
                    sd[".".join(mod + ["num_batches_tracked"])] = torch.tensor(7)
            sd[".".join(mod + [name])] = torch.from_numpy(np.ascontiguousarray(arr))
    sd["head.dfl.conv.weight"] = torch.arange(16, dtype=torch.float32).view(1, 16, 1, 1)
    return sd


def _wrap(sd: dict, how: str):
    if how == "model":
        return {"model": sd, "epoch": 3}
    if how == "module":
        return {"state_dict": {f"module.{k}": v for k, v in sd.items()}}
    return sd


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        out.update(_flat(v, path) if isinstance(v, dict) else {path: v})
    return out


def _maps(model, x):
    with torch.no_grad():
        return model(x)


@pytest.mark.parametrize("how", ["bare", "model", "module"])
def test_pt_mapping_equals_jax_and_reproduces_golden_maps(how):
    from yolo_ms_tpu.utils.checkpoint import torch_state_dict_to_variables as jax_map
    from yolo_ms_tpu_torch.utils.checkpoint import torch_state_dict_to_variables

    ref = _wrap(reference_state_dict(V8_NPZ), how)
    got, want = _flat(torch_state_dict_to_variables(ref)), _flat(jax_map(ref))
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    with np.load(V8_NPZ) as z:
        assert sorted(got) == sorted(z.files)
        for k in z.files:
            np.testing.assert_array_equal(got[k], z[k], err_msg=k)


def test_pt_file_loads_strict_and_serves_the_golden_maps(tmp_path):
    from yolo_ms_tpu_torch.utils.checkpoint import load_torch_checkpoint

    path = str(tmp_path / "yolov8n.pt")
    torch.save({"model": reference_state_dict(V8_NPZ), "optimizer": None}, path)
    from_pt = build_model("n", num_classes=3, device="cpu")
    from_pt.load_state_dict(load_torch_checkpoint(path), strict=True)
    from_npz = build_model("n", num_classes=3, device="cpu")
    from_npz.load_state_dict(load_npz(V8_NPZ), strict=True)
    x = torch.from_numpy(np.random.default_rng(0).standard_normal((1, 3, 64, 64), np.float32))
    for a, b in zip(_maps(from_pt, x), _maps(from_npz, x)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=1e-3)


def test_pt_mapping_raises_keyerror_like_jax():
    from yolo_ms_tpu.utils.checkpoint import torch_state_dict_to_variables as jax_map
    from yolo_ms_tpu_torch.utils.checkpoint import torch_state_dict_to_variables

    bad = dict(reference_state_dict(V8_NPZ))
    bad["backbone.conv0.act.alpha"] = torch.zeros(1)
    for fn in (jax_map, torch_state_dict_to_variables):
        with pytest.raises(KeyError, match="backbone.conv0.act.alpha"):
            fn(bad)


def test_trainer_starts_from_a_reference_pt(tmp_path, no_tensorboard):
    from yolo_ms_tpu_torch.train.trainer import Trainer
    from yolo_ms_tpu_torch.utils.config import Config

    path = str(tmp_path / "yolov8n.pt")
    torch.save(reference_state_dict(V8_NPZ), path)
    cfg = Config.from_dict({
        "dataset": {"num_classes": 3},
        "model": {"architecture": "n", "input_size": [64, 64], "pretrained_weights_path": path},
        "training": {"log_dir": str(tmp_path / "runs"), "ema_decay": 0.9999},
    })
    trainer = Trainer(cfg, verbose=False, device="cpu")
    want = load_npz(V8_NPZ)
    for sd in (trainer.state.model.state_dict(), trainer.state.ema.state_dict()):
        for k, v in want.items():
            if not k.endswith("num_batches_tracked"):
                assert torch.equal(sd[k], v), k


# ----------------------------------------------------------------------------
# tools.test
# ----------------------------------------------------------------------------


def _iou(a, b):
    ix1, iy1 = max(a[0], b[0]), max(a[1], b[1])
    ix2, iy2 = min(a[2], b[2]), min(a[3], b[3])
    inter = max(0.0, ix2 - ix1) * max(0.0, iy2 - iy1)
    ua = (a[2] - a[0]) * (a[3] - a[1]) + (b[2] - b[0]) * (b[3] - b[1]) - inter
    return inter / max(ua, 1e-9)


def assert_golden_match(got, golden, iou_min=0.9, score_tol=0.02):
    """The rule of tests/test_trained_golden.py: same count; each golden
    detection matched once by class, IoU and score."""
    assert len(got) == len(golden), (got, golden)
    unmatched = list(got)
    for g in golden:
        hit = next((d for d in unmatched if d["class_id"] == g["class_id"]
                    and _iou(d["box_xyxy"], g["box_xyxy"]) > iou_min
                    and abs(d["score"] - g["score"]) < score_tol), None)
        assert hit is not None, f"detection unmatched: {g} in {got}"
        unmatched.remove(hit)


def _config(tmp_path, arch="n", size=160, **sections) -> str:
    d = {"dataset": {"num_classes": 3}, "model": {"architecture": arch, "input_size": [size, size]},
         "device": "cpu", "workers": 2}
    for k, v in sections.items():
        d.setdefault(k, {}).update(v)
    path = str(tmp_path / "config.json")
    with open(path, "w") as f:
        json.dump(d, f)
    return path


@pytest.mark.parametrize("kind", ["npz", "pt"])
def test_tools_test_reproduces_the_golden(tmp_path, kind):
    from yolo_ms_tpu_torch.tools import test as test_cli

    ckpt = V8_NPZ
    if kind == "pt":
        ckpt = str(tmp_path / "yolov8n.pt")
        torch.save({"model": reference_state_dict(V8_NPZ)}, ckpt)
    out = tmp_path / "out"
    results = test_cli.run(_config(tmp_path), ckpt, V8_FIXTURE, str(out))
    with open(V8_DETECTIONS) as f:
        golden = json.load(f)
    assert_golden_match(results[V8_FIXTURE], golden)
    with open(out / "fixture_000_detections.json") as f:
        assert_golden_match(json.load(f), golden)
    assert os.path.getsize(out / "fixture_000_detected.jpg") > 0


def test_tools_test_main_needs_a_card_unless_the_config_says_cpu(tmp_path):
    from yolo_ms_tpu_torch.tools import test as test_cli

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid here")
    cfg = _config(tmp_path)
    with open(cfg) as f:
        d = json.load(f)
    d["device"] = "cuda"
    with open(cfg, "w") as f:
        json.dump(d, f)
    with pytest.raises(SystemExit):
        test_cli.main(["--config", cfg, "--checkpoint", V8_NPZ, "--source", V8_FIXTURE,
                       "--output_dir", str(tmp_path / "out")])
    assert not (tmp_path / "out").exists()


# ----------------------------------------------------------------------------
# tools.val
# ----------------------------------------------------------------------------


def _val_data(tmp_path):
    from tests.make_fixtures import make_coco_dataset

    return make_coco_dataset(str(tmp_path / "data"), num_images=10, num_classes=3,
                             img_w=320, img_h=256, seed=7)


def test_tools_val_equals_trainer_validate_and_jax_map(tmp_path, monkeypatch, no_tensorboard):
    from yolo_ms_tpu.eval.coco_map import MeanAveragePrecision as JaxMAP
    from yolo_ms_tpu_torch.eval.coco_map import MeanAveragePrecision
    from yolo_ms_tpu_torch.tools import val as val_cli
    from yolo_ms_tpu_torch.train.trainer import Trainer
    from yolo_ms_tpu_torch.utils.config import load_config

    images, ann = _val_data(tmp_path)
    cfg_path = _config(
        tmp_path,
        dataset={"val_images_path": images, "val_annotations_path": ann, "max_gt": 8},
        evaluation={"batch_size": 4, "img_size": [160, 160], "confidence_threshold": 0.05,
                    "map_iou_thresholds": "coco"},
        model={"pretrained_weights_path": V8_NPZ},
        training={"log_dir": str(tmp_path / "runs"), "ema_decay": 0.9999},
    )
    jax_maps = []

    class Recording(MeanAveragePrecision):
        """The port's metric, also feeding the JAX one the same inputs."""

        def __init__(self, iou_thresholds):
            super().__init__(iou_thresholds=iou_thresholds)
            jax_maps.append(JaxMAP(iou_thresholds=iou_thresholds))

        def update(self, preds, targets):
            jax_maps[-1].update(preds, targets)
            super().update(preds, targets)

    monkeypatch.setattr(val_cli, "MeanAveragePrecision", Recording)
    result = val_cli.run(cfg_path, V8_NPZ, verbose=False)
    assert result["images"] == 10 and len(result["batch_ms"]) == 3  # 4 + 4 + 2
    assert result["detections"] > 0 and result["map_50"] > 0.5
    want = jax_maps[0].compute()
    for key in ("map", "map_50", "map_75"):
        assert abs(result[key] - want[key]) <= 1e-6, (key, result[key], want[key])

    trainer = Trainer(load_config(cfg_path), verbose=False)
    assert trainer.validate() == pytest.approx(result["map_50"], abs=1e-6)
    assert trainer._last_val_result["map"] == pytest.approx(result["map"], abs=1e-6)


# ----------------------------------------------------------------------------
# tools.export
# ----------------------------------------------------------------------------


def _train_checkpoint(path, ema_sd):
    """A port train checkpoint as ``Trainer.checkpoint`` writes it, with a
    raw model that differs from the EMA one."""
    from yolo_ms_tpu_torch.utils.checkpoint import save_checkpoint

    raw = {k: (v + 1.0 if v.is_floating_point() else v) for k, v in ema_sd.items()}
    save_checkpoint(path, {"state": {"model": raw, "ema": ema_sd, "opt_state": {}, "step": 4},
                           "epoch": 0, "step_in_epoch": 0})
    return raw


def test_export_from_pt_npz_and_train_checkpoint(tmp_path):
    from yolo_ms_tpu_torch.tools import export
    from yolo_ms_tpu_torch.utils.checkpoint import restore_checkpoint

    sd = load_npz(V8_NPZ)
    want = fold_batchnorm(sd)
    pt = str(tmp_path / "yolov8n.pt")
    torch.save(reference_state_dict(V8_NPZ), pt)
    ckpt = str(tmp_path / "last.ckpt")
    raw = _train_checkpoint(ckpt, sd)
    for name, src in (("pt", pt), ("npz", V8_NPZ), ("ckpt", ckpt)):
        info = export.run(src, str(tmp_path / f"{name}.ckpt"))
        got = restore_checkpoint(info["output"])
        assert sorted(got) == sorted(want), name
        for k in want:
            torch.testing.assert_close(got[k], want[k], rtol=0, atol=1e-6, msg=k)
        assert info["params"] == sum(v.numel() for v in want.values())
        assert info["bytes"] == 4 * info["params"] and info["dtype"] == "float32"
    # the EMA model is exported, not the raw one
    raw_folded = fold_batchnorm(raw)
    got = restore_checkpoint(str(tmp_path / "ckpt.ckpt"))
    assert not torch.equal(got["backbone.conv0.conv.weight"], raw_folded["backbone.conv0.conv.weight"])
    # an export exports as it is
    again = export.run(str(tmp_path / "npz.ckpt"), str(tmp_path / "again.ckpt"))
    assert all(torch.equal(restore_checkpoint(again["output"])[k], want[k]) for k in want)


def test_bf16_export_is_half_the_bytes_and_serves_the_golden(tmp_path):
    from yolo_ms_tpu_torch.tools import export
    from yolo_ms_tpu_torch.tools import test as test_cli
    from yolo_ms_tpu_torch.utils.checkpoint import restore_checkpoint

    f32 = export.run(V8_NPZ, str(tmp_path / "f32.ckpt"))
    bf16 = export.run(V8_NPZ, str(tmp_path / "bf16.ckpt"), bf16=True)
    assert bf16["dtype"] == "bfloat16" and bf16["params"] == f32["params"]
    assert 2 * bf16["bytes"] == f32["bytes"]
    got = restore_checkpoint(bf16["output"])
    assert all(v.dtype == torch.bfloat16 for v in got.values())
    with open(V8_DETECTIONS) as f:
        golden = json.load(f)
    results = test_cli.run(_config(tmp_path), f32["output"], V8_FIXTURE, str(tmp_path / "out"))
    assert_golden_match(results[V8_FIXTURE], golden)


# ----------------------------------------------------------------------------
# predict_video
# ----------------------------------------------------------------------------


def test_predict_video_ragged_batches_equal_predict_image(tmp_path):
    import cv2

    from yolo_ms_tpu_torch.data.decode import decode_image
    from yolo_ms_tpu_torch.infer.predictor import Predictor
    from yolo_ms_tpu_torch.infer.video import predict_video

    src = str(tmp_path / "in.avi")
    frame = decode_image(V8_FIXTURE)
    h, w = frame.shape[:2]
    writer = cv2.VideoWriter(src, cv2.VideoWriter_fourcc(*"MJPG"), 10.0, (w, h))
    assert writer.isOpened()
    for k in range(5):
        writer.write(cv2.cvtColor(np.roll(frame, 7 * k, axis=1), cv2.COLOR_RGB2BGR))
    writer.release()

    pred = Predictor("n", load_npz(V8_NPZ), num_classes=3, input_size=(160, 160),
                     batch_size=2, device="cpu")
    out = str(tmp_path / "out.mp4")
    dets = predict_video(pred, src, out, verbose=False)
    cap = cv2.VideoCapture(src)
    frames = []
    while True:
        ok, bgr = cap.read()
        if not ok:
            break
        frames.append(cv2.cvtColor(bgr, cv2.COLOR_BGR2RGB))
    cap.release()
    assert len(dets) == len(frames) == 5
    assert sum(len(d) for d in dets) > 0
    for got, rgb in zip(dets, frames):
        assert got == pred.predict_image(rgb)
    cap = cv2.VideoCapture(out)
    assert int(cap.get(cv2.CAP_PROP_FRAME_COUNT)) == 5
    cap.release()


# ----------------------------------------------------------------------------
# analyze, visualize, profiler
# ----------------------------------------------------------------------------


@pytest.mark.parametrize("arch,sub", [("n", "trained"), ("yolo-ms-xs", "trained_yolo-ms-xs")])
def test_analyze_counts_match_the_golden_and_staged_equals_full(arch, sub):
    from yolo_ms_tpu_torch.tools.analyze import analyze

    info = analyze(arch, num_classes=3, img_size=64, device="cpu")
    with np.load(os.path.join(GOLDEN, sub, "weights.npz")) as z:
        sizes = {k: z[k].size for k in z.files if k.startswith("params/")}
    assert info["params"] == sum(sizes.values())
    for stage in ("backbone", "neck", "head"):
        want = sum(n for k, n in sizes.items() if k.startswith(f"params/{stage}/"))
        assert info["stage_params"][stage] == want, stage
    assert info["anchors"] == info["expected_anchors"] == 84
    assert info["flops"] > 0 and info["decoded"].shape == (1, 84, 4 + 3)


def test_visualize_writes_the_jax_modules_files(tmp_path):
    pytest.importorskip("matplotlib")
    from yolo_ms_tpu_torch.tools.visualize import visualize

    jax_src = os.path.join(os.path.dirname(GOLDEN), "..", "yolo_ms_tpu", "tools", "visualize.py")
    with open(jax_src) as f:
        src = f.read()
    want = set()
    for stem in re.findall(r'f"(\w+)_\{name\}\.png"', src):
        names = ("P3", "P4", "P5") if stem == "backbone" else ("N1", "N2", "N3")
        want |= {f"{stem}_{n}.png" for n in names}
    want |= set(re.findall(r'"(\w+\.png)"', src))
    assert len(want) == 8
    visualize("n", None, str(tmp_path / "viz"), num_classes=3, channels_per_stage=4,
              img_size=64, device="cpu")
    assert set(os.listdir(tmp_path / "viz")) == want


def test_profiler_timer_and_trace(tmp_path):
    """``trace`` writes the profiler's Chrome trace with the program's spans
    of the block on a track of their own, on the profiler's time base."""
    from yolo_ms_tpu_torch.utils.profiler import span, trace

    def f(i):
        with span("outer", items=i), span("inner"):
            return torch.full((64, 64), float(i)) @ torch.ones(64, 64)

    f(0)  # off: no span
    with trace(str(tmp_path / "prof")) as prof:
        with torch.profiler.record_function("ranged"):
            f(1)
    assert any("mm" in e.key for e in prof.key_averages())
    with open(tmp_path / "prof" / "trace.json") as fh:
        events = json.load(fh)["traceEvents"]
    spans = {e["name"]: e for e in events if e.get("cat") == "program_span"}
    assert set(spans) == {"outer", "inner"}
    outer, inner = spans["outer"], spans["inner"]
    assert outer["args"]["items"] == 1 and inner["args"]["parent"] == outer["args"]["id"]
    assert inner["args"]["call"] == outer["args"]["id"] and outer["pid"] == inner["pid"]
    assert outer["pid"] not in {e.get("pid") for e in events if e.get("cat") != "program_span"
                                and e.get("ph") == "X"}
    ranged = next(e for e in events if e.get("name") == "ranged")
    slack_us = 100.0
    assert ranged["ts"] - slack_us <= outer["ts"]
    assert outer["ts"] + outer["dur"] <= ranged["ts"] + ranged["dur"] + slack_us


def test_cli_mains_parse(tmp_path):
    from yolo_ms_tpu_torch.tools import analyze, export

    export.main(["--checkpoint", V8_NPZ, "--output", str(tmp_path / "e.ckpt"), "--bf16"])
    assert os.path.exists(tmp_path / "e.ckpt")
    analyze.main(["--version", "n", "--num_classes", "3", "--img_size", "64", "--device", "cpu"])
