"""The PyTorch port stands alone: importing every module of
``yolo_ms_tpu_torch``, and ``chip_smoke`` as a module, loads no jax, flax,
triton or ``yolo_ms_tpu`` module, and no matplotlib (``tools/visualize.py``
imports it when it runs), checked in a fresh interpreter."""

import json
import os
import subprocess
import sys

from tests.torch_policy import child_env

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SCRIPT = r"""
import importlib, json, pkgutil, sys
import yolo_ms_tpu_torch
names = ["yolo_ms_tpu_torch"] + [
    m.name for m in pkgutil.walk_packages(yolo_ms_tpu_torch.__path__, "yolo_ms_tpu_torch.")
]
for name in names:
    importlib.import_module(name)
import chip_smoke
banned = sorted(
    m for m in sys.modules
    if m.split(".")[0] in ("jax", "jaxlib", "flax", "triton", "yolo_ms_tpu", "matplotlib")
)
print(json.dumps({"imported": names, "banned": banned}))
"""


def test_port_imports_no_jax_flax_triton_or_jax_package():
    env = {k: v for k, v in child_env().items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = ROOT
    proc = subprocess.run(
        [sys.executable, "-c", SCRIPT],
        cwd=ROOT,
        env=env,
        capture_output=True,
        text=True,
        timeout=120,
    )
    assert proc.returncode == 0, proc.stderr
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    assert result["banned"] == []
    expected = {
        "yolo_ms_tpu_torch.nn.blocks",
        "yolo_ms_tpu_torch.models.yolo",
        "yolo_ms_tpu_torch.models.ms",
        "yolo_ms_tpu_torch.models.registry",
        "yolo_ms_tpu_torch.models.decode",
        "yolo_ms_tpu_torch.models.deploy",
        "yolo_ms_tpu_torch.ops.iou",
        "yolo_ms_tpu_torch.ops.nms",
        "yolo_ms_tpu_torch.ops.postprocess",
        "yolo_ms_tpu_torch.ops.kernels.select",
        "yolo_ms_tpu_torch.ops.kernels.nms",
        "yolo_ms_tpu_torch.data.augment",
        "yolo_ms_tpu_torch.data.decode",
        "yolo_ms_tpu_torch.data.native_loader",
        "yolo_ms_tpu_torch.infer.predictor",
        "yolo_ms_tpu_torch.infer.program",
        "yolo_ms_tpu_torch.infer.layouts",
        "yolo_ms_tpu_torch.infer.graphs",
        "yolo_ms_tpu_torch.utils.convert",
        "yolo_ms_tpu_torch.utils.checkpoint",
        "yolo_ms_tpu_torch.utils.profiler",
        "yolo_ms_tpu_torch.train.trainer",
        "yolo_ms_tpu_torch.infer.video",
        "yolo_ms_tpu_torch.tools.test",
        "yolo_ms_tpu_torch.tools.val",
        "yolo_ms_tpu_torch.tools.export",
        "yolo_ms_tpu_torch.tools.analyze",
        "yolo_ms_tpu_torch.tools.visualize",
        "yolo_ms_tpu_torch.tools.train",
        "yolo_ms_tpu_torch.tools.benchmark",
        "yolo_ms_tpu_torch.data.loader",
        "yolo_ms_tpu_torch.train.loss",
        "yolo_ms_tpu_torch.utils.logging",
        "yolo_ms_tpu_torch.parallel",
        "yolo_ms_tpu_torch.parallel.distributed",
        "yolo_ms_tpu_torch.parallel.mesh",
        "yolo_ms_tpu_torch.parallel.spatial",
        "yolo_ms_tpu_torch.parallel.dryrun",
    }
    assert expected <= set(result["imported"])
