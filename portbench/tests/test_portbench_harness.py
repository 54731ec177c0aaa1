"""The benchmark's files, its frozen yardsticks and the FLOP count, on the CPU.

Run from the root of the repository: ``python -m pytest portbench/tests -q``.
"""

from __future__ import annotations

import hashlib
import importlib.util
import json
import os
import shutil
import sys

import pytest
import torch

from portbench import run, yardstick
from portbench.reference.model import forward_flops

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
HERE = os.path.join(ROOT, "portbench")


def bench() -> dict:
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def _load_by_path(name: str, path: str):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[name] = module
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("cell", [w["name"] for w in bench()["workloads"]])
def test_every_cell_resolves_to_files(cell):
    b = bench()
    entry, e2e, per_layer = run.resolve(b, cell)
    cfg = run.load_json("configs", f"{entry['config']}.json")
    traffic = run.load_json("traffic", f"{entry['traffic']}.json")
    limits = run.load_json("workloads", f"{cell}.json")["limits"]
    assert cfg["name"] == entry["config"]
    assert os.path.exists(os.path.join(HERE, "drivers", f"{traffic['driver']}.py"))
    assert limits and all(v > 0 for v in limits.values())
    names = {m["name"] for m in e2e}
    assert "setup_s" in names and len(names) >= 2
    assert per_layer
    for m in per_layer:
        assert m["moves"] in names
        assert callable(run.load_module("metrics", m["name"]).read)
    config_entry = {c["name"]: c for c in b["configs"]}[entry["config"]]
    assert config_entry["file"] == f"portbench/configs/{entry['config']}.json"


def test_a_new_cell_and_metric_are_found_without_editing_a_file(tmp_path):
    """A cell, a traffic mix and a metric added as new files and entries
    in a copy: the copy's harness finds them, and no file that was there
    changed but BENCHMARK.json."""
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(HERE, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))

    def digests():
        return {p: hashlib.sha256(p.read_bytes()).hexdigest()
                for p in (tmp_path / "portbench").rglob("*") if p.is_file()}

    before = digests()
    b = json.loads((tmp_path / "BENCHMARK.json").read_text())
    b["workloads"].append({"name": "xs-serve-b8", "config": "yolo-ms-xs",
                           "traffic": "batch8-closed", "chips": 1, "why": "a new cell"})
    b["end_to_end"][0]["workloads"].append("xs-serve-b8")
    b["per_layer"].append({"name": "serve.h2d_ms", "unit": "ms", "better": "lower",
                           "source": "device_trace", "layer": "infer/predictor.py",
                           "moves": "serve_img_per_s", "workloads": ["xs-serve-b8"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(b))
    (tmp_path / "portbench/traffic/batch8-closed.json").write_text(json.dumps(
        {"driver": "serve", "batch": 8, "pool": 8, "sample": 4, "profile_calls": 10}))
    (tmp_path / "portbench/workloads/xs-serve-b8.json").write_text(json.dumps(
        {"limits": {"logit_gap": 1.0}}))
    (tmp_path / "portbench/metrics/serve.h2d_ms.py").write_text(
        "def read(trace):\n    return 1.5\n")
    copy = _load_by_path("portbench_copy_run", str(tmp_path / "portbench/run.py"))
    entry, e2e, per_layer = copy.resolve(json.loads((tmp_path / "BENCHMARK.json").read_text()),
                                         "xs-serve-b8")
    assert copy.load_json("traffic", f"{entry['traffic']}.json")["batch"] == 8
    assert [m["name"] for m in e2e] == ["serve_img_per_s", "setup_s"]
    assert [m["name"] for m in per_layer] == ["serve.h2d_ms"]
    assert copy.load_module("metrics", "serve.h2d_ms").read(None) == 1.5
    after = digests()
    assert {p: d for p, d in after.items() if p in before} == before


def test_frozen_bounds_give_chip_smokes_numbers():
    smoke = _load_by_path("chip_smoke_for_bounds", os.path.join(ROOT, "chip_smoke.py"))
    name = "NVIDIA H100 80GB HBM3"
    for nc, dtype in ((80, torch.bfloat16), (1203, torch.float32), (10, torch.bfloat16)):
        pairs = [(torch.empty(32, hw, 64, dtype=dtype, device="meta"),
                  torch.empty(32, hw, nc, dtype=dtype, device="meta")) for hw in (6400, 1600, 400)]
        shapes = [((b.shape[0], b.shape[1], b.shape[2], b.element_size()),
                   (c.shape[2], c.element_size())) for b, c in pairs]
        assert yardstick.select_bound(shapes, name) == smoke.select_bound(pairs, name)
    gen = torch.Generator().manual_seed(0)
    scores = torch.rand(4, 1024, generator=gen) - 0.1
    sweeps = [21, 20, 3, 1]
    assert yardstick.nms_bound(scores, sweeps, name) == smoke.nms_bound(scores, sweeps, name)
    assert yardstick.PEAK_RATES == smoke.PEAK_RATES


def test_nms_sweeps_are_the_plain_fixed_points():
    from yolo_ms_tpu_torch.ops.kernels.nms import nms_fixed_plain

    gen = torch.Generator().manual_seed(1)
    xy = torch.rand(3, 200, 2, generator=gen) * 300
    wh = torch.rand(3, 200, 2, generator=gen) * 120 + 4
    boxes = torch.cat([xy, xy + wh], -1)
    scores = torch.rand(3, 200, generator=gen).sort(dim=1, descending=True).values - 0.2
    _, want = nms_fixed_plain(boxes, scores, 0.45)
    assert yardstick.nms_sweeps(boxes, scores, 0.45) == want.tolist()


@pytest.mark.parametrize("config,gflop", [("yolo-ms-xs", 11.72), ("yolov8-n", 8.74)])
def test_reference_flops_at_640(config, gflop):
    cfg = run.load_json("configs", f"{config}.json")
    assert round(forward_flops(cfg, (640, 640)) / 1e9, 2) == gflop
