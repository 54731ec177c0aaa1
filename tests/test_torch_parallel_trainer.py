"""The port's ``Trainer`` over two ``gloo`` ranks on the CPU against one
process on the same global batch, and its preemption drain across ranks.

The counterpart of the JAX package's ``tests/test_multihost_trainer.py``
(``:206``, ``:251``, ``:343``), with the ranks in child processes
(``tests/torch_dp_worker.py``): yolov8-n, global batch 4 (2 rows per rank),
SGD with EMA, ``gt_buckets [4]``. Each rank writes under its own
``runs_rank{r}`` directory so the test sees that rank 1 writes nothing.

- fit from the trained golden weights (160 px, nc=3, so that mAP is far
  from 0) for one step on 4 synthetic images whose rows need 4 GT slots on
  rank 0 and 5 on rank 1, so the ranks must agree on the bucket through
  ``global_max_int``) and validate: the loss terms of every rank equal the
  one-process run's at rtol 1e-4, ``num_fg`` and the GT bucket equal, the
  ranks' final states bitwise equal, mAP equal (abs 1e-6). One step, as in
  the JAX test: a second step's loss moves by ~3e-3 for the ~3e-6 by which
  the summation order moves the first step's parameters (the assignment and
  BatchNorm over 2x2 maps amplify it), so later losses are not a fair
  comparison;
- preemption, from random init at 64 px, nc=2, on 8 images: U (2 epochs) and P (the same, SIGTERM to both ranks while
  global step 2 is in flight) side by side: both P ranks exit 143 well
  inside the grace window, only rank 0 wrote ``preempt.ckpt`` (at epoch 1,
  step 1), and R, both ranks resumed from it, ends with a state equal to
  U's element by element;
- the idle drill: both ranks waiting between steps with the handler
  installed, SIGTERM to both: both exit 143 at once, and rank 0 alone
  wrote ``preempt.ckpt``, with cursor (1, 0) encoded as "epoch 0
  complete" as the JAX trainer does.
"""

import os
import signal
import time

import pytest
import torch

import tests.torch_policy  # noqa: F401 - the port's thread policy
from tests.make_fixtures import make_coco_dataset
from tests.torch_dp_worker import finish, lines, run_ranks, start_ranks

TERMS = ("loss_box", "loss_cls", "loss_dfl", "total_loss")
GRACE_S = 60


@pytest.fixture(scope="module")
def data_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("dp_trainer"))
    make_coco_dataset(root, num_images=8, num_classes=2, img_w=96, img_h=96, max_objects=6,
                      seed=4)
    return root


@pytest.fixture(scope="module")
def fit_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("dp_fit"))
    make_coco_dataset(root, num_images=4, num_classes=3, img_w=320, img_h=256, max_objects=6,
                      seed=1)
    return root


def _records(out: str) -> dict:
    return {i: (digest, bucket, m) for i, digest, bucket, m in lines(out, "RECORD")}


def _files(root: str) -> set:
    return {os.path.relpath(os.path.join(d, f), root)
            for d, _, fs in os.walk(root) for f in fs}


@pytest.fixture(scope="module")
def fit_runs(fit_root):
    solo = start_ranks("trainer", 1, fit_root, "solo", "1", "golden")
    dp = start_ranks("trainer", 2, fit_root, "dp", "1", "golden")
    solo_rc, solo_out = finish(solo)
    dp_rc, dp_out = finish(dp)
    return solo_rc, solo_out, dp_rc, dp_out


def test_two_rank_trainer_equals_one_process(fit_runs, fit_root):
    solo_rc, solo_out, dp_rc, dp_out = fit_runs
    assert solo_rc == [0], solo_out[0][-3000:]
    assert dp_rc == [0, 0], dp_out[0][-3000:] + dp_out[1][-3000:]
    # the ranks' rows need different buckets: 4 slots and 5
    assert [lines(o, "NEEDED")[0] for o in dp_out] == [4, 5]
    ref = _records(solo_out[0])
    assert sorted(ref) == [0]
    for r, out in enumerate(dp_out):
        got = _records(out)
        assert sorted(got) == [0]
        for i in got:
            _, bucket, m = got[i]
            _, want_bucket, want = ref[i]
            assert bucket == want_bucket, f"rank {r} step {i}: bucket {bucket} vs {want_bucket}"
            assert m["num_fg"] == want["num_fg"] > 0
            assert m["skipped_nonfinite"] == 0.0
            for k in TERMS:
                assert m[k] == pytest.approx(want[k], rel=1e-4), f"rank {r} step {i} {k}"
        assert got[0][1] == 8  # agreed on the larger need
    maps = [lines(o, "MAP")[0] for o in dp_out]
    want_map = lines(solo_out[0], "MAP")[0]
    assert maps[0] == maps[1]
    assert want_map["map"] > 0.5
    assert maps[0]["map"] == pytest.approx(want_map["map"], abs=1e-6)
    assert maps[0]["detections"] == want_map["detections"] > 0
    a, b = (torch.load(os.path.join(fit_root, f"dp_rank{r}_final.pt"), weights_only=True)
            for r in (0, 1))
    for part in ("model", "ema", "opt_state"):
        for k, v in a[part].items():
            assert torch.equal(v, b[part][k]), (part, k)


def test_only_rank_zero_writes(fit_runs, fit_root):
    assert fit_runs[2] == [0, 0]
    assert not os.path.exists(os.path.join(fit_root, "runs_rank1"))
    written = _files(os.path.join(fit_root, "runs_rank0", "dp"))
    assert {"config.yaml", "weights/last.ckpt", "weights/best.ckpt",
            "weights/best_metric.json"} <= written
    assert any(f.startswith("tensorboard_logs/") for f in written)


@pytest.fixture(scope="module")
def drill(data_root):
    """U and P side by side (4 ranks), then R resumed from P's checkpoint."""
    t0 = time.monotonic()
    u = start_ranks("trainer", 2, data_root, "u", "2", "random")
    p = start_ranks("trainer", 2, data_root, "p", "2", "random",
                    env={"SNIPE_STEP": "2", "YOLO_MS_PREEMPT_GRACE_S": str(GRACE_S)})
    p_rc, p_out = finish(p)
    p_s = time.monotonic() - t0
    u_rc, u_out = finish(u)
    ckpt = os.path.join(data_root, "runs_rank0", "p", "weights", "preempt.ckpt")
    r_rc, r_out = run_ranks("trainer", 2, data_root, "r", "2", "random", ckpt)
    return {"rc": (u_rc, p_rc, r_rc), "out": (u_out, p_out, r_out), "ckpt": ckpt, "p_s": p_s}


def test_two_rank_preemption_drains(drill, data_root):
    from yolo_ms_tpu_torch.utils.checkpoint import restore_checkpoint

    u_rc, p_rc, _ = drill["rc"]
    u_out, p_out, _ = drill["out"]
    assert u_rc == [0, 0], u_out[0][-3000:] + u_out[1][-3000:]
    term = 128 + signal.SIGTERM
    assert p_rc == [term, term], p_out[0][-3000:] + p_out[1][-3000:]
    assert drill["p_s"] < GRACE_S  # drained, not ended by the watchdog
    for out in p_out:
        assert "DEFERRED" in out
        assert "Traceback" not in out
    # only the primary saved, at the committed step
    assert not os.path.exists(os.path.join(data_root, "runs_rank1"))
    restored = restore_checkpoint(drill["ckpt"])
    assert (restored["epoch"], restored["step_in_epoch"], restored["state"]["step"]) == (1, 1, 3)
    ref = _records(u_out[0])
    for out in p_out:
        got = _records(out)
        assert sorted(got) == [0, 1, 2]
        assert all(got[i][2] == ref[i][2] for i in got)


def test_two_rank_idle_preemption(data_root):
    from yolo_ms_tpu_torch.utils.checkpoint import restore_checkpoint

    procs = start_ranks("idle", 2, data_root, "idle")
    try:
        deadline = time.monotonic() + 120
        for p in procs:
            line = ""
            while line.strip() != "READY":
                assert time.monotonic() < deadline and p.poll() is None, line
                line = p.stdout.readline()
        t0 = time.monotonic()
        for p in procs:
            p.send_signal(signal.SIGTERM)
        rcs = [p.wait(timeout=60) for p in procs]
        exit_s = time.monotonic() - t0
    finally:
        finish(procs, timeout=10)
    assert rcs == [128 + signal.SIGTERM] * 2
    assert exit_s < GRACE_S
    assert not os.path.exists(os.path.join(data_root, "runs_rank1"))
    restored = restore_checkpoint(
        os.path.join(data_root, "runs_rank0", "idle", "weights", "preempt.ckpt"))
    assert (restored["epoch"], restored["step_in_epoch"]) == (0, 0)
    assert restored["state"]["step"] == 0


def test_two_rank_resume_equals_uninterrupted(drill, data_root):
    _, _, r_rc = drill["rc"]
    u_out, _, r_out = drill["out"]
    assert r_rc == [0, 0], r_out[0][-3000:] + r_out[1][-3000:]
    for r in (0, 1):
        assert sorted(_records(r_out[r])) == [3]
        assert _records(r_out[r])[3] == _records(u_out[r])[3]  # same rows, same losses
        want = torch.load(os.path.join(data_root, f"u_rank{r}_final.pt"), weights_only=True)
        got = torch.load(os.path.join(data_root, f"r_rank{r}_final.pt"), weights_only=True)
        assert got["step"] == want["step"] == 4
        for part in ("model", "ema", "opt_state"):
            for k, v in want[part].items():
                assert torch.equal(got[part][k], v), (r, part, k)
