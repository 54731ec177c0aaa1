"""The port's SIGTERM-deferred preemption save on the CPU, in child
processes (a signal handler installs only on a main thread).

Three fits of yolov8-n at 64 px (f32, SGD with EMA, 8 images, batch 2: four
steps per epoch, two epochs), the counterpart of the JAX package's
``tests/test_multihost_trainer.py::test_preemption_under_load_and_resume_equality``
in one process:

  U  uninterrupted;
  P  the same run, SIGTERM delivered to itself while the third step
     (epoch 0, step 2) is in flight: the handler defers to the commit
     point, which saves ``preempt.ckpt`` at (epoch 0, 3 steps) and exits
     128 + SIGTERM;
  R  ``resume(preempt.ckpt)`` run to the end.

R's final params, BN statistics, EMA and optimizer state equal U's element
by element, and R sees U's batches from step 3 on. The idle path (a signal
with no step in flight) and the cursor encoding are checked against the
JAX package's ``_save_preempt_and_exit``.
"""

import json
import os
import signal
import subprocess
import sys
import time
import types

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_WORKER = r"""
import hashlib, json, os, signal, sys, time
# the trainer's TensorBoard writer then uses tensorboard's own stub instead
# of importing TensorFlow, which takes ~20 s where it is installed
sys.modules["tensorflow"] = None
import torch
torch.set_num_threads(2)
from yolo_ms_tpu_torch.train.trainer import Trainer
from yolo_ms_tpu_torch.utils.config import Config

mode, data_root, exp = sys.argv[1], sys.argv[2], sys.argv[3]
images, ann = os.path.join(data_root, "images"), os.path.join(data_root, "annotations.json")
cfg = Config.from_dict({
    "dataset": {"train_images_path": images, "train_annotations_path": ann,
                "num_classes": 2, "max_gt": 8},
    "model": {"architecture": "n", "input_size": [64, 64], "compute_dtype": "float32"},
    "training": {"batch_size": 2, "epochs": 2, "optimizer": "sgd", "learning_rate": 0.01,
                 "weight_decay": 5e-4, "ema_decay": 0.9999, "val_interval": 100,
                 "experiment_name": exp, "log_dir": os.path.join(data_root, "runs"),
                 "augmentation": {"fliplr": 0.5}},
    "device": "cpu", "workers": 2,
})
trainer = Trainer(cfg, verbose=False)

if mode == "idle":
    trainer._cursor = (1, 0)  # no commit yet in epoch 1
    trainer._install_preemption_handler()
    print("READY", flush=True)
    time.sleep(120)
    sys.exit(99)  # the signal never came

if mode == "resume":
    trainer.resume(sys.argv[4])
spe = len(trainer.train_loader)
offset = trainer.start_epoch * spe + trainer.start_step
snipe = int(os.environ.get("SNIPE_STEP", "-1"))
records = []
inner = trainer._train_step

def step(state, batch):
    metrics = inner(state, batch)
    i = offset + len(records)
    digest = hashlib.sha256(batch["images"].numpy().tobytes()).hexdigest()
    records.append((i, digest, float(metrics["total_loss"])))
    if i == snipe:
        # a real SIGTERM inside fit's in-flight window: the handler must
        # defer to the commit point
        os.kill(os.getpid(), signal.SIGTERM)
        assert trainer._preempt_signum == signal.SIGTERM
        assert trainer._step_active, "signal outside the in-flight window"
        print("DEFERRED", flush=True)
    return metrics

trainer._train_step = step
rc = 0
try:
    trainer.fit()
except SystemExit as e:
    rc = int(e.code or 0)
print("RECORDS " + json.dumps(records), flush=True)
if rc == 0:
    torch.save(trainer.state.state_dict(), os.path.join(data_root, exp + "_final.pt"))
sys.exit(rc)
"""


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    env["YOLO_MS_PREEMPT_GRACE_S"] = "60"
    return env


def _spawn(*args, extra_env=None):
    env = _env()
    env.update(extra_env or {})
    return subprocess.Popen([sys.executable, "-c", _WORKER, *args], cwd=ROOT, env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def _records(out: str) -> dict:
    for line in out.splitlines():
        if line.startswith("RECORDS "):
            return {i: (digest, loss) for i, digest, loss in json.loads(line[8:])}
    raise AssertionError(f"no RECORDS line in:\n{out[-3000:]}")


@pytest.fixture(scope="module")
def drill(tmp_path_factory):
    """U and P side by side, then R from P's preempt.ckpt."""
    from tests.make_fixtures import make_coco_dataset

    root = str(tmp_path_factory.mktemp("preempt"))
    make_coco_dataset(root, num_images=8, num_classes=2, img_w=96, img_h=96)
    u = _spawn("fit", root, "u")
    p = _spawn("fit", root, "p", extra_env={"SNIPE_STEP": "2"})
    u_out, p_out = u.communicate(timeout=300)[0], p.communicate(timeout=300)[0]
    ckpt = os.path.join(root, "runs", "p", "weights", "preempt.ckpt")
    r = _spawn("resume", root, "r", ckpt)
    r_out = r.communicate(timeout=300)[0]
    return {"root": root, "ckpt": ckpt, "rc": (u.returncode, p.returncode, r.returncode),
            "out": (u_out, p_out, r_out)}


def test_inflight_sigterm_saves_the_committed_step(drill):
    from yolo_ms_tpu_torch.utils.checkpoint import restore_checkpoint

    u_rc, p_rc, _ = drill["rc"]
    u_out, p_out, _ = drill["out"]
    assert u_rc == 0, u_out[-3000:]
    assert p_rc == 128 + signal.SIGTERM, p_out[-3000:]
    assert "DEFERRED" in p_out
    restored = restore_checkpoint(drill["ckpt"])
    # the step in flight (epoch 0, step 2) was committed before the save
    assert (restored["epoch"], restored["step_in_epoch"]) == (0, 3)
    assert restored["state"]["step"] == 3
    ref, got = _records(u_out), _records(p_out)
    assert sorted(ref) == list(range(8)) and sorted(got) == [0, 1, 2]
    assert all(got[i] == ref[i] for i in got)


def test_resume_equals_the_uninterrupted_run(drill):
    u_out, _, r_out = drill["out"]
    assert drill["rc"][2] == 0, r_out[-3000:]
    want = torch.load(os.path.join(drill["root"], "u_final.pt"), weights_only=True)
    got = torch.load(os.path.join(drill["root"], "r_final.pt"), weights_only=True)
    assert got["step"] == want["step"] == 8
    for part in ("model", "ema", "opt_state"):
        assert sorted(got[part]) == sorted(want[part])
        for k, v in want[part].items():
            assert torch.equal(got[part][k], v), (part, k)


def test_mid_epoch_resume_sees_the_same_batches(drill):
    u_out, _, r_out = drill["out"]
    ref, got = _records(u_out), _records(r_out)
    assert sorted(got) == list(range(3, 8))
    for i in got:
        assert got[i] == ref[i], i  # the same images, and the same loss


def test_idle_sigterm_before_the_first_commit_of_an_epoch(tmp_path):
    from tests.make_fixtures import make_coco_dataset
    from yolo_ms_tpu_torch.utils.checkpoint import restore_checkpoint

    root = str(tmp_path)
    make_coco_dataset(root, num_images=4, num_classes=2, img_w=96, img_h=96)
    proc = _spawn("idle", root, "idle")
    lines = []
    try:
        deadline = time.time() + 120
        while not lines or lines[-1].strip() != "READY":
            assert time.time() < deadline and proc.poll() is None, "".join(lines)
            lines.append(proc.stdout.readline())
        t0 = time.perf_counter()
        proc.send_signal(signal.SIGTERM)
        rc = proc.wait(timeout=60)
        exit_s = time.perf_counter() - t0
    finally:
        if proc.poll() is None:
            proc.kill()
        proc.stdout.close()
    assert rc == 128 + signal.SIGTERM
    assert exit_s < 30
    restored = restore_checkpoint(os.path.join(root, "runs", "idle", "weights", "preempt.ckpt"))
    assert (restored["epoch"], restored["step_in_epoch"]) == (0, 0)  # "epoch 0 complete"
    assert restored["state"]["step"] == 0


@pytest.mark.parametrize("cursor", [(1, 0), (0, 0), (2, 3)])
def test_cursor_encoding_matches_jax(cursor, monkeypatch, tmp_path):
    """The port's ``_save_preempt_and_exit`` and the JAX package's write the
    same (epoch, step_in_epoch) for the same cursor."""
    import numpy as np

    from yolo_ms_tpu.train.trainer import Trainer as JaxTrainer
    from yolo_ms_tpu.utils import checkpoint as jax_ckpt
    from yolo_ms_tpu_torch.train import trainer as port

    saved = {}

    def capture(who):
        def save(path, obj, **kw):
            saved[who] = (int(obj["epoch"]), int(obj["step_in_epoch"]))
        return save

    monkeypatch.setattr(jax_ckpt, "save_checkpoint", capture("jax"))
    monkeypatch.setattr(port, "save_checkpoint", capture("port"))
    ckpt = types.SimpleNamespace(dir=str(tmp_path))
    jax_self = types.SimpleNamespace(
        state=types.SimpleNamespace(params=np.zeros(1)), _primary=True, ckpt=ckpt, _cursor=cursor)
    port_self = types.SimpleNamespace(
        device=torch.device("cpu"), ckpt=ckpt, _cursor=cursor,
        checkpoint=lambda epoch, step: {"epoch": epoch, "step_in_epoch": step})
    for fn, obj in ((JaxTrainer._save_preempt_and_exit, jax_self),
                    (port.Trainer._save_preempt_and_exit, port_self)):
        with pytest.raises(SystemExit) as e:
            fn(obj, signal.SIGTERM)
        assert e.value.code == 128 + signal.SIGTERM
    assert saved["port"] == saved["jax"]

