"""The port's exported serving program on the CPU.

``python -m yolo_ms_tpu_torch.tools.export --program`` traces the serving
function (uint8 -> normalize -> BN-folded bf16 forward -> ``fused_postprocess``
with the ``select`` op and the ``nms_fixed`` op) of each trained golden at
160 px into a file. The file, loaded by ``load_program``, gives what
``Predictor(dtype=torch.bfloat16).predict_batch`` gives (``valid`` and
``classes`` equal; boxes and scores at rtol 1e-5 / atol 1e-4, the tolerance
of the JAX round-trip test ``tests/test_deploy.py``), in this process and in
a fresh interpreter that imports no ``yolo_ms_tpu_torch.models`` module; and
the golden yolov8-n program finds the detections of the JAX package's own
``export_stablehlo`` artifact by the golden rule of
``tests/test_trained_golden.py`` (same count, same class, IoU > 0.9, score
within 0.02).
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from tests.torch_policy import child_env
from yolo_ms_tpu_torch.data.decode import decode_and_resize
from yolo_ms_tpu_torch.infer.predictor import Predictor
from yolo_ms_tpu_torch.infer.program import load_program
from yolo_ms_tpu_torch.tools import export as tools_export
from yolo_ms_tpu_torch.utils.convert import load_npz

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(ROOT, "tests", "golden")
CASES = {"n": "trained", "yolo-ms-xs": "trained_yolo-ms-xs"}
TOL = dict(rtol=1e-5, atol=1e-4)


def _weights(arch):
    return os.path.join(GOLDEN, CASES[arch], "weights.npz")


def _image(arch):
    path = os.path.join(GOLDEN, CASES[arch], "fixture_000.png")
    return decode_and_resize(path, 160, 160)[None]


@pytest.fixture(scope="module")
def programs(tmp_path_factory):
    """Both goldens exported by the CLI, on the CPU: {arch: program path}."""
    out = tmp_path_factory.mktemp("programs")
    paths = {}
    for arch in CASES:
        paths[arch] = str(out / f"{arch}.pt2")
        tools_export.main([
            "--checkpoint", _weights(arch), "--output", str(out / f"{arch}.ckpt"),
            "--program", paths[arch], "--arch", arch, "--num_classes", "3",
            "--img_size", "160", "160", "--device", "cpu",
        ])
    return paths


def _predictor_out(arch):
    predictor = Predictor(arch, load_npz(_weights(arch)), num_classes=3,
                          input_size=(160, 160), dtype=torch.bfloat16, device="cpu")
    return predictor.predict_batch(_image(arch))


def _assert_same(got, want):
    assert set(got) == set(want)
    np.testing.assert_array_equal(got["valid"], want["valid"])
    np.testing.assert_array_equal(got["classes"], want["classes"])
    for key in ("boxes", "scores"):
        np.testing.assert_allclose(got[key], want[key], **TOL, err_msg=key)
    assert want["valid"].any()


@pytest.mark.parametrize("arch", list(CASES))
def test_program_matches_predictor(programs, arch):
    assert torch.export.load(programs[arch]).example_inputs is None  # no batch inside
    program = load_program(programs[arch], device="cpu")
    targets = {str(n.target) for n in program.graph.nodes if n.op == "call_function"}
    assert {"yolo_ms_tpu_torch.select_scales.default",
            "yolo_ms_tpu_torch.nms_fixed.default"} <= targets
    assert not any("while_loop" in t for t in targets)
    with torch.inference_mode():
        out = program(torch.from_numpy(_image(arch)))
    _assert_same({k: v.numpy() for k, v in out.items()}, _predictor_out(arch))


CHILD = r"""
import json, sys
import numpy as np
import torch
from yolo_ms_tpu_torch.infer.program import load_program
outs = {}
for arch, (path, image) in json.loads(sys.argv[1]).items():
    with torch.inference_mode():
        out = load_program(path, device="cpu")(torch.from_numpy(np.load(image)))
    outs.update({f"{arch}/{k}": v.numpy() for k, v in out.items()})
np.savez(sys.argv[2], **outs)
banned = sorted(m for m in sys.modules if m.startswith("yolo_ms_tpu_torch.models")
                or m.split(".")[0] in ("jax", "flax", "yolo_ms_tpu"))
print(json.dumps({"banned": banned}))
"""


def test_program_served_without_model_code(programs, tmp_path):
    """A fresh interpreter serves both programs through ``load_program``
    alone: no module of ``yolo_ms_tpu_torch.models`` (nor JAX) is imported,
    and the outputs are the Predictor's."""
    args = {}
    for arch in CASES:
        np.save(tmp_path / f"{arch}.npy", _image(arch))
        args[arch] = (programs[arch], str(tmp_path / f"{arch}.npy"))
    env = {k: v for k, v in child_env().items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = ROOT
    proc = subprocess.run(
        [sys.executable, "-c", CHILD, json.dumps(args), str(tmp_path / "out.npz")],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr
    assert json.loads(proc.stdout.strip().splitlines()[-1])["banned"] == []
    with np.load(tmp_path / "out.npz") as z:
        for arch in CASES:
            got = {k.split("/")[1]: z[k] for k in z.files if k.startswith(f"{arch}/")}
            _assert_same(got, _predictor_out(arch))


def _detections(out):
    v = np.asarray(out["valid"])[0]
    return [
        {"class_id": int(c), "box_xyxy": [float(x) for x in b], "score": float(s)}
        for b, s, c in zip(np.asarray(out["boxes"])[0][v], np.asarray(out["scores"])[0][v],
                           np.asarray(out["classes"])[0][v])
    ]


def _iou(a, b):
    ix1, iy1 = max(a[0], b[0]), max(a[1], b[1])
    ix2, iy2 = min(a[2], b[2]), min(a[3], b[3])
    inter = max(0.0, ix2 - ix1) * max(0.0, iy2 - iy1)
    ua = (a[2] - a[0]) * (a[3] - a[1]) + (b[2] - b[0]) * (b[3] - b[1]) - inter
    return inter / max(ua, 1e-9)


def test_program_matches_jax_stablehlo(programs, tmp_path):
    """The golden yolov8-n: the port's program against the JAX package's
    ``export_stablehlo`` artifact of the same weights, called through
    ``jax.export.deserialize``; both keep the detections scoring above 0.25."""
    import jax
    from jax import export as jexport

    from yolo_ms_tpu.models.deploy import fold_batchnorm
    from yolo_ms_tpu.tools.export import export_stablehlo

    tree = {}
    with np.load(_weights("n")) as z:
        for key in z.files:
            node = tree
            *parents, leaf = key.split("/")
            for p in parents:
                node = node.setdefault(p, {})
            node[leaf] = z[key]
    variables = fold_batchnorm({"params": tree["params"], "batch_stats": tree["batch_stats"]})
    path = str(tmp_path / "serve.stablehlo")
    export_stablehlo(variables, "n", 3, path, batch=1, img_size=(160, 160))
    with open(path, "rb") as f:
        artifact = jexport.deserialize(f.read())
    image = _image("n")
    want = _detections(jax.device_get(artifact.call(image)))
    with torch.inference_mode():
        got = _detections(load_program(programs["n"], device="cpu")(torch.from_numpy(image)))
    assert want and len(got) == len(want), (got, want)
    unmatched = list(got)
    for g in want:
        hit = next((d for d in unmatched if d["class_id"] == g["class_id"]
                    and _iou(d["box_xyxy"], g["box_xyxy"]) > 0.9
                    and abs(d["score"] - g["score"]) < 0.02), None)
        assert hit is not None, f"JAX detection unmatched: {g} in {got}"
        unmatched.remove(hit)


def test_export_program_takes_a_folded_state_dict(tmp_path):
    with pytest.raises(ValueError, match="fold_batchnorm"):
        tools_export.export_program(load_npz(_weights("n")), "n", 3, str(tmp_path / "x.pt2"),
                                    img_size=(160, 160), device="cpu")
    assert not os.listdir(tmp_path)
