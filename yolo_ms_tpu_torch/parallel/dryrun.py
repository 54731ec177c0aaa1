"""A data-parallel dry run: one train step over ``gloo`` ranks on the CPU.

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
zero, whose sign the order of the sums decides).

With an even number of ranks a second leg follows, the counterpart of the
JAX dry run's hybrid leg: the same step from the same start on a
(procs // 2, 2) (data, spatial) mesh, each rank holding its data row's
images and its half of their height; its loss must be within
1e-3 * max(1, |loss|) of the pure data-parallel step's.

``--device cuda`` runs the same on the cards of one host, one rank per card
over ``nccl`` (f32 with TF32 off), the halo exchanges of the hybrid leg
included.

    python -m yolo_ms_tpu_torch.parallel.dryrun [--procs N] [--device cpu|cuda]
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
HYBRID_LOSS_TOL = 1e-3  # the JAX dry run's: |hybrid - DP| < 1e-3 * max(1, |DP|)
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


def _one_step(batch: dict, device, group=None, mesh=None):
    """One train step on ``device`` of a fresh yolov8-n (seed 0) on
    ``batch`` (this rank's rows of the global batch under ``group``, or on a
    2-D ``mesh`` its data row's rows, height-sharded): the metrics and the
    state."""
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
    state = TrainState.create(model.to(device), tx, ema=False)
    loss = DetectionLoss(num_classes=NUM_CLASSES, group=group)
    if mesh is None:
        set_batch_norm_group(state.model, group)
    else:
        loss = mesh.attach(state.model, loss)
    step = make_train_step(loss, tx, group=group, mesh=mesh)
    metrics = step(state, {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
                           if isinstance(v, np.ndarray) else v for k, v in batch.items()})
    return {k: float(metrics[k]) for k in TERMS}, state


def child(device: str) -> None:
    """One rank (torchrun's variables in the environment) on ``device``."""
    import torch.distributed as dist

    from yolo_ms_tpu_torch.parallel.distributed import (
        data_parallel_group,
        leave_group,
        maybe_initialize_distributed,
        rank_device,
    )
    from yolo_ms_tpu_torch.parallel.mesh import hybrid_batch_sharding, make_mesh_2d, shard_batch

    torch.set_num_threads(2)
    assert maybe_initialize_distributed(device=device)
    dev = rank_device()
    # f32 on the card as on the CPU, so that the tolerances hold on both
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    world, rank = dist.get_world_size(), dist.get_rank()
    batch = global_batch(ROWS_PER_RANK * world)
    metrics, state = _one_step(shard_batch(batch), dev, data_parallel_group())
    flat = torch.cat([state.params, state.stats])
    gathered = [torch.empty_like(flat) for _ in range(world)]
    dist.all_gather(gathered, flat)
    result = {"rank": rank, "world": world, "backend": dist.get_backend(),
              "steps": int(state.step), **metrics,
              "ranks_equal": all(torch.equal(g, flat) for g in gathered)}
    if world % 2 == 0:
        mesh = make_mesh_2d(world // 2, 2)
        hybrid, _ = _one_step(hybrid_batch_sharding(mesh)(batch), dev, mesh=mesh)
        result["hybrid"] = {"mesh": [mesh.data, mesh.spatial], **hybrid}
    if rank == 0:
        # the one-process step on the same global batch, from the same start
        # (no group: it runs no collective, while the group is still up)
        solo, solo_state = _one_step(batch, dev)
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


def dryrun_data_parallel(procs: int = 2, timeout_s: float = 600.0, device: str = "cpu") -> dict:
    """Run the dry run in ``procs`` fresh ranks; raise unless it passes.
    Returns rank 0's result. ``device`` is ``"cpu"`` (gloo ranks) or
    ``"cuda"`` (one card per rank, over nccl)."""
    port = _free_port()
    root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    children = []
    for rank in range(procs):
        env = dict(os.environ, RANK=str(rank), LOCAL_RANK=str(rank), WORLD_SIZE=str(procs),
                   MASTER_ADDR="localhost", MASTER_PORT=str(port))
        env["PYTHONPATH"] = root + os.pathsep + env.get("PYTHONPATH", "")
        children.append(subprocess.Popen(
            [sys.executable, "-m", "yolo_ms_tpu_torch.parallel.dryrun", "--child",
             "--device", device],
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
    print(f"dry run OK (torch {torch.__version__}): {procs} {first['backend']} ranks, global batch "
          f"{ROWS_PER_RANK * procs}, loss {first['total_loss']:.4f}, num_fg "
          f"{first['num_fg']:.0f}; one-process step: loss rel err {first['loss_rel_err']:.2e}, "
          f"state max abs err {first['state_abs_err']:.2e}")
    if procs % 2 == 0:
        hybrid = first["hybrid"]
        assert all(r["hybrid"] == hybrid for r in results), "the ranks' hybrid metrics differ"
        gap = abs(hybrid["total_loss"] - first["total_loss"])
        assert gap < HYBRID_LOSS_TOL * max(1.0, abs(first["total_loss"])), (
            f"hybrid DP x SP loss {hybrid['total_loss']} != pure DP loss {first['total_loss']}")
        print(f"dry run hybrid OK: ({procs // 2}, 2) (data, spatial) mesh, loss "
              f"{hybrid['total_loss']:.4f} (pure DP {first['total_loss']:.4f}, |diff| {gap:.2e})")
    return first


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--procs", type=int, default=2)
    parser.add_argument("--device", choices=("cpu", "cuda"), default="cpu",
                        help="the ranks on the CPU over gloo (the default), or one card "
                             "per rank over nccl")
    parser.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    args = parser.parse_args()
    if args.child:
        child(args.device)
    else:
        dryrun_data_parallel(args.procs, device=args.device)


if __name__ == "__main__":
    main()
