"""Whole runs of the harness in fresh interpreters: the CPU rehearsal of each
cell (``rehearse.py``), with and without a fault planted in the timed path,
the imports a run and the reference may make, and a run on the card.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
REHEARSE = os.path.join(ROOT, "portbench", "tests", "rehearse.py")
FORBIDDEN = {"jax", "jaxlib", "flax", "yolo_ms_tpu"}
KEYS = ["correct", "attempted", "failed", "metrics", "device"]


def _env():
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    return env


def rehearse(*args, timeout=300):
    """(result line, loaded top-level modules) of a rehearsal."""
    proc = subprocess.run([sys.executable, REHEARSE, *map(str, args)], cwd=ROOT, env=_env(),
                          capture_output=True, text=True, timeout=timeout)
    assert proc.returncode == 0, proc.stderr[-3000:]
    *_, result, loaded = proc.stdout.strip().splitlines()
    return json.loads(result), set(json.loads(loaded)["loaded"])


@pytest.mark.parametrize("cell,trace", [("xs-serve-b32", 0), ("xs-serve-b32", 1),
                                        ("v8n-serve-b32", 0), ("v8n-serve-b32", 1),
                                        ("xs-train-b32", 1)])
def test_a_rehearsed_run_prints_a_result_and_loads_no_jax(cell, trace):
    result, loaded = rehearse(cell, 2**31 + 7, 1, trace)
    assert list(result)[:5] == KEYS and list(result)[-1] == "compared"
    assert not loaded & FORBIDDEN
    assert "yolo_ms_tpu_torch" in loaded
    if trace:
        assert {"busy_s", "window_s"} <= set(result["device"])
        assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}
    else:
        assert set(result["metrics"]) == {"serve_img_per_s", "setup_s"}
    if "serve" in cell:
        assert result["correct"], result["compared"]


@pytest.mark.parametrize("cell,fault", [("xs-serve-b32", "answer"), ("xs-serve-b32", "half"),
                                        ("v8n-serve-b32", "answer"),
                                        ("xs-train-b32", "half"), ("xs-train-b32", "frozen")])
def test_a_fault_in_the_timed_path_reads_not_correct(cell, fault):
    result, _ = rehearse(cell, 2**31 + 7, 1, 0, "--fault", fault)
    assert result["correct"] is False, result["compared"]


def test_the_reference_imports_nothing_of_the_program():
    code = ("import sys, portbench.reference.model, portbench.reference.detect, "
            "portbench.reference.train, portbench.weights, portbench.yardstick\n"
            "for f in portbench.reference.model.families():\n"
            "    portbench.reference.model.family(f)\n"
            "print(sorted({m.split('.')[0] for m in sys.modules}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=_env(),
                         capture_output=True, text=True, timeout=120, check=True).stdout
    loaded = set(eval(out))
    assert not loaded & (FORBIDDEN | {"yolo_ms_tpu_torch"})


def test_without_the_program_the_benchmark_prints_no_result(tmp_path):
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "portbench"), tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    proc = subprocess.run([sys.executable, "-m", "portbench.run", "--workload", "xs-serve-b32",
                           "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=tmp_path,
                          env=_env(), capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert '"correct"' not in proc.stdout


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.cuda
def test_a_short_run_on_the_card_is_correct(card):
    proc = subprocess.run([sys.executable, "-m", "portbench.run", "--workload", "v8n-serve-b32",
                           "--seed", str(2**31 + 3), "--seconds", "2", "--trace", "0"],
                          cwd=ROOT, env=_env(), capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    assert result["correct"], result["compared"]
