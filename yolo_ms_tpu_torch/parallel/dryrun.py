"""A data-parallel dry run on the CPU: one train step over ``gloo`` ranks.

The counterpart of the first leg of the JAX package's
``__graft_entry__.dryrun_multichip``: yolov8-n at 128 px, nc=8, a global
batch of 2 rows per rank, max_gt 4, each image with one near-image-sized GT
box (so that the random-init model has TAL positives and the box and DFL
gradients cross the ranks too). Fresh child processes join a ``gloo`` group
on the CPU and take one step on their rows; rank 0 then takes the
one-process step on the whole global batch from the same start, in the same
process (with no group, that step runs no collective). The run passes when
the loss is finite, the step count is 1, ``num_fg > 0``, every rank ends
with the same state, and that state and the loss equal the one-process
step's. The optimizer is SGD, so that the states compare element by element
(Adam's first step is +-lr on any gradient, even one within rounding of
zero, whose sign the order of the sums decides). The spatial (DP x SP) leg
waits for ROADMAP A12.

    python -m yolo_ms_tpu_torch.parallel.dryrun [--procs N]
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys

import numpy as np
import torch

IMG, NUM_CLASSES, ROWS_PER_RANK, MAX_GT = 128, 8, 2, 4
LOSS_RTOL = 1e-4
STATE_TOL = dict(rtol=1e-3, atol=1e-5)
TERMS = ("loss_box", "loss_cls", "loss_dfl", "total_loss", "num_fg")


def global_batch(batch: int) -> dict:
    """The JAX dry run's batch: seeded normal images, one GT box per image."""
    rng = np.random.default_rng(0)
    return {
        "images": rng.standard_normal((batch, IMG, IMG, 3), dtype=np.float32),
        "boxes": np.tile(np.asarray([0.5, 0.5, 0.9, 0.9], np.float32), (batch, MAX_GT, 1)),
        "labels": np.zeros((batch, MAX_GT), np.int32),
        "mask": np.tile(np.asarray([True] + [False] * (MAX_GT - 1)), (batch, 1)),
    }


def _one_step(batch: dict, group=None):
    """One train step of a fresh yolov8-n (seed 0) on ``batch`` (this rank's
    rows of the global batch under ``group``): the metrics and the state."""
    from yolo_ms_tpu_torch.models.registry import build_model, init_model
    from yolo_ms_tpu_torch.nn.blocks import set_batch_norm_group
    from yolo_ms_tpu_torch.train.loss import DetectionLoss
    from yolo_ms_tpu_torch.train.optim import build_optimizer
    from yolo_ms_tpu_torch.train.trainer import TrainState, make_train_step
    from yolo_ms_tpu_torch.utils.config import TrainingConfig

    model = init_model(build_model("n", num_classes=NUM_CLASSES, device="cpu"),
                       torch.Generator().manual_seed(0))
    cfg = TrainingConfig(batch_size=len(batch["images"]), epochs=1, optimizer="sgd",
                         learning_rate=0.01)
    tx, _ = build_optimizer(cfg, 10)
    state = TrainState.create(set_batch_norm_group(model, group), tx, ema=False)
    step = make_train_step(DetectionLoss(num_classes=NUM_CLASSES, group=group), tx, group=group)
    metrics = step(state, {k: torch.from_numpy(np.ascontiguousarray(v))
                           for k, v in batch.items()})
    return {k: float(metrics[k]) for k in TERMS}, state


def child() -> None:
    """One rank (torchrun's variables in the environment)."""
    import torch.distributed as dist

    from yolo_ms_tpu_torch.parallel.distributed import (
        data_parallel_group,
        leave_group,
        maybe_initialize_distributed,
    )
    from yolo_ms_tpu_torch.parallel.mesh import shard_batch

    torch.set_num_threads(2)
    assert maybe_initialize_distributed(device="cpu")
    world, rank = dist.get_world_size(), dist.get_rank()
    batch = global_batch(ROWS_PER_RANK * world)
    metrics, state = _one_step(shard_batch(batch), data_parallel_group())
    flat = torch.cat([state.params, state.stats])
    gathered = [torch.empty_like(flat) for _ in range(world)]
    dist.all_gather(gathered, flat)
    result = {"rank": rank, "world": world, "steps": int(state.step), **metrics,
              "ranks_equal": all(torch.equal(g, flat) for g in gathered)}
    if rank == 0:
        # the one-process step on the same global batch, from the same start
        # (no group: it runs no collective, while the group is still up)
        solo, solo_state = _one_step(batch)
        result["solo"] = solo
        result["loss_rel_err"] = max(
            abs(metrics[k] - solo[k]) / max(abs(solo[k]), 1e-12) for k in TERMS)
        want = torch.cat([solo_state.params, solo_state.stats])
        result["state_abs_err"] = (flat - want).abs().max().item()
        result["state_close"] = bool(torch.allclose(flat, want, **STATE_TOL))
    leave_group()
    print("DRYRUN " + json.dumps(result), flush=True)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def dryrun_data_parallel(procs: int = 2, timeout_s: float = 600.0) -> dict:
    """Run the dry run in ``procs`` fresh ranks; raise unless it passes.
    Returns rank 0's result."""
    port = _free_port()
    root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    children = []
    for rank in range(procs):
        env = dict(os.environ, RANK=str(rank), LOCAL_RANK=str(rank), WORLD_SIZE=str(procs),
                   MASTER_ADDR="localhost", MASTER_PORT=str(port))
        env["PYTHONPATH"] = root + os.pathsep + env.get("PYTHONPATH", "")
        children.append(subprocess.Popen(
            [sys.executable, "-m", "yolo_ms_tpu_torch.parallel.dryrun", "--child"],
            cwd=root, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    outs = []
    try:
        for p in children:
            outs.append(p.communicate(timeout=timeout_s)[0])
    finally:
        for p in children:
            if p.poll() is None:
                p.kill()
                p.wait()
    results = []
    for rank, (p, out) in enumerate(zip(children, outs)):
        lines = [ln for ln in out.splitlines() if ln.startswith("DRYRUN ")]
        if p.returncode != 0 or not lines:
            raise RuntimeError(f"dry run rank {rank} failed (rc={p.returncode}):\n{out[-4000:]}")
        results.append(json.loads(lines[-1][len("DRYRUN "):]))
    first = results[0]
    for r in results:
        assert np.isfinite(r["total_loss"]), f"non-finite loss in the dry run: {r}"
        assert r["steps"] == 1, r
        assert r["num_fg"] > 0, f"no TAL positives, so no box/DFL gradient crossed: {r}"
        assert r["ranks_equal"], f"rank {r['rank']}: the ranks' states differ"
        assert all(r[k] == first[k] for k in TERMS), "the ranks report different metrics"
    assert first["loss_rel_err"] <= LOSS_RTOL, first
    assert first["state_close"], first
    print(f"dry run OK: {procs} gloo ranks, global batch {ROWS_PER_RANK * procs}, loss "
          f"{first['total_loss']:.4f}, num_fg {first['num_fg']:.0f}; one-process step: loss "
          f"rel err {first['loss_rel_err']:.2e}, state max abs err {first['state_abs_err']:.2e}")
    return first


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--procs", type=int, default=2)
    parser.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    args = parser.parse_args()
    if args.child:
        child()
    else:
        dryrun_data_parallel(args.procs)


if __name__ == "__main__":
    main()
