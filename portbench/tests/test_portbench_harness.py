"""The benchmark's files, its frozen yardsticks and the FLOP count, on the CPU.

Run from the root of the repository: ``python -m pytest portbench/tests -q``.
"""

from __future__ import annotations

import hashlib
import importlib.util
import json
import os
import shutil
import subprocess
import sys
import textwrap

import pytest
import torch

from portbench import run, yardstick
from portbench.reference.model import Detector, forward_flops
from portbench.weights import seeded_state_dict

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


def _digests(root):
    return {p: hashlib.sha256(p.read_bytes()).hexdigest()
            for p in root.rglob("*") if p.is_file() and "__pycache__" not in p.parts}


def _copy(tmp_path) -> dict:
    """BENCHMARK.json and portbench/ copied into ``tmp_path``; the digests of
    the copy's portbench/ files."""
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(HERE, tmp_path / "portbench", ignore=shutil.ignore_patterns("__pycache__"))
    return _digests(tmp_path / "portbench")


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
    before = _copy(tmp_path)
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
    after = _digests(tmp_path / "portbench")
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


# a family of its own: a conv with BatchNorm, a token matmul with a declared
# 2-D leaf, a learned per-channel gamma with a declared fill, and the shared
# head; ``matmul`` "mm" multiplies, "none" skips it, "sdpa" calls
# F.scaled_dot_product_attention instead
TOY_FAMILY = '''
import torch
import torch.nn.functional as F
from torch import nn

from portbench.reference.model import ConvBnSiLU, Head, Net

LEAVES = ((".gamma", lambda flat, gen: flat.fill_(0.01)),
          (lambda name, shape: len(shape) == 2, lambda flat, gen: flat.normal_(generator=gen)))


class Body(nn.Module):
    def __init__(self, cfg):
        super().__init__()
        c = cfg["width"]
        self.stem = ConvBnSiLU(3, c, 3, 8)
        self.mix = nn.Parameter(torch.empty(c, c))
        self.gamma = nn.Parameter(torch.empty(c))
        if cfg.get("undeclared"):
            self.scale = nn.Parameter(torch.empty(c))
        self.matmul = cfg["matmul"]

    def forward(self, x):
        x = self.stem(x)
        b, c, h, w = x.shape
        t = x.flatten(2).transpose(1, 2)
        if self.matmul == "mm":
            t = t + self.gamma * (t @ self.mix)
        elif self.matmul == "sdpa":
            t = t + self.gamma * F.scaled_dot_product_attention(t, t, t)
        x = t.transpose(1, 2).reshape(b, c, h, w)
        return x, F.max_pool2d(x, 2), F.max_pool2d(x, 4)


class Levels(nn.Module):
    def forward(self, *feats):
        return feats


def build(cfg):
    c = cfg["width"]
    return Net(cfg, Body(cfg), Levels(), Head((c, c, c), cfg["num_classes"], cfg["reg_max"]))
'''
TOY_CONFIG = {"name": "toy", "family": "toy", "width": 16, "num_classes": 3, "reg_max": 16,
              "image_size": [64, 64], "matmul": "mm"}


def _toy_copy(tmp_path, toy: dict) -> dict:
    """Copy portbench/ and BENCHMARK.json and add the toy family as new
    files and entries; the digests of the copy's files before the adding."""
    before = _copy(tmp_path)
    b = json.loads((tmp_path / "BENCHMARK.json").read_text())
    b["configs"].append({"name": "toy", "source": "https://arxiv.org/abs/2502.12524",
                         "file": "portbench/configs/toy.json", "reduced": [],
                         "why": "a family of its own"})
    b["workloads"].append({"name": "toy-serve-b2", "config": "toy", "traffic": "batch32-closed",
                           "chips": 1, "why": "a new family"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(b))
    (tmp_path / "portbench/configs/toy.json").write_text(json.dumps(toy))
    (tmp_path / "portbench/reference/arch/toy.py").write_text(TOY_FAMILY)
    (tmp_path / "portbench/workloads/toy-serve-b2.json").write_text(json.dumps(
        {"limits": {"logit_err": 0.15}}))
    return before


def _run_in(tmp_path, code: str) -> subprocess.CompletedProcess:
    """``code`` run in the copy, with ``cell``, the toy cell as the copy's
    harness loads it."""
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    prelude = ("import torch\n"
               "from portbench import run\n"
               "cell, _, _ = run.load_cell('toy-serve-b2', 0, 1, False)\n")
    proc = subprocess.run([sys.executable, "-c", prelude + textwrap.dedent(code)], cwd=tmp_path,
                          env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return proc


def test_a_new_family_is_found_without_editing_a_file(tmp_path):
    """A configuration of a family of its own, added as new files and
    entries in a copy: the copy's weights draw its declared leaves, its
    ``Detector`` builds it, ``detect.dense`` decodes it, ``forward_flops``
    counts its matmul, and no file that was in the copy changed."""
    before = _toy_copy(tmp_path, TOY_CONFIG)
    got = json.loads(_run_in(tmp_path, """
    import json
    from portbench.reference import detect
    from portbench.reference.model import Detector, forward_flops
    from portbench.weights import seeded_state_dict

    cfg = cell.cfg
    sd = seeded_state_dict(cfg, 2**31 + 5, "cpu")
    assert torch.equal(sd["backbone.gamma"], torch.full((16,), 0.01))
    assert sd["backbone.mix"].std() > 0.5
    model = Detector(cfg).eval()
    model.load_state_dict(sd)
    images = torch.randint(0, 256, (2, 64, 64, 3), dtype=torch.uint8)
    boxes, logits = detect.dense(model, images)
    flops = {m: forward_flops(dict(cfg, matmul=m), (64, 64)) for m in ("mm", "none")}
    try:
        forward_flops(dict(cfg, matmul="sdpa"), (64, 64))
        sdpa = "counted"
    except ValueError as e:
        sdpa = str(e)
    print(json.dumps({"boxes": list(boxes.shape), "logits": list(logits.shape),
                      "finite": bool(boxes.isfinite().all() and logits.isfinite().all()),
                      "flops": flops, "sdpa": sdpa}))
    """).stdout.strip().splitlines()[-1])
    anchors = 8 * 8 + 4 * 4 + 2 * 2
    assert got["boxes"] == [2, anchors, 4] and got["logits"] == [2, anchors, 3] and got["finite"]
    hw, c = 8 * 8, TOY_CONFIG["width"]
    assert got["flops"]["mm"] - got["flops"]["none"] == 2 * hw * c * c
    assert "scaled_dot_product_attention" in got["sdpa"]
    after = _digests(tmp_path / "portbench")
    assert {p: d for p, d in after.items() if p in before} == before


def test_a_leaf_no_rule_covers_raises(tmp_path):
    _toy_copy(tmp_path, dict(TOY_CONFIG, undeclared=True))
    out = _run_in(tmp_path, """
    from portbench.weights import seeded_state_dict

    try:
        seeded_state_dict(cell.cfg, 0, "cpu")
    except KeyError as e:
        print(e)
    """).stdout
    assert "no rule draws backbone.scale" in out


def test_an_unknown_family_names_the_families_that_have_files():
    cfg = dict(run.load_json("configs", "yolov8-n.json"), family="yolov9")
    with pytest.raises(ValueError, match=r"'yolov9'.*\['yolo-ms', 'yolov8'\]"):
        Detector(cfg)


def _state_digest(sd: dict) -> str:
    h = hashlib.sha256()
    for k in sorted(sd):
        v = sd[k]
        h.update(f"{k} {tuple(v.shape)} {v.dtype}".encode())
        h.update(v.contiguous().numpy().tobytes())
    return h.hexdigest()


@pytest.mark.parametrize("config,digest", [
    ("yolo-ms-xs", "73bb6629051c29a66a1f4f4ea9b2990a6d32f7bd4ebf8bd5d06b75bd195821cf"),
    ("yolov8-n", "c9a48eaf276623e61f3f5b700636e59c8a50cd916625276c89ec9d51aa821959"),
])
def test_seeded_weights_keep_their_bits(config, digest):
    """The CPU draw at seed 0 at full widths, pinned: the cells' weights, and
    so every reading in the ledger, rest on it (torch 2.13's CPU generator)."""
    cfg = run.load_json("configs", f"{config}.json")
    assert _state_digest(seeded_state_dict(cfg, 0, "cpu")) == digest
