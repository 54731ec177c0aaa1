"""Child processes of the port's data-parallel CPU tests: ``run_ranks``
starts ``world`` ranks of this file on a fresh ``gloo`` group (torchrun's
variables in their environment, so ``maybe_initialize_distributed`` runs as
under torchrun), each with a timeout, and returns their exit codes and
output. ``world=1`` runs one process with no group: the one-process
reference on the same global batch.

Each mode reads its inputs from, and writes its results to, a directory the
test names; no mode imports JAX. Every rank takes its thread environment
from ``tests/torch_policy.py``, the one source of the thread count of every
process that a port test starts.
"""

from __future__ import annotations

import json
import os
import signal
import socket
import subprocess
import sys
import time

from tests.torch_policy import child_env

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def start_ranks(mode: str, world: int, *args: str, env: dict | None = None) -> list:
    """Start the ranks of ``mode``; each writes its output to a pipe."""
    port = _free_port()
    procs = []
    for rank in range(world):
        e = child_env()
        for k in ("RANK", "LOCAL_RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
            e.pop(k, None)
        if world > 1:
            e.update(RANK=str(rank), LOCAL_RANK=str(rank), WORLD_SIZE=str(world),
                     MASTER_ADDR="localhost", MASTER_PORT=str(port))
        e["PYTHONPATH"] = ROOT + os.pathsep + e.get("PYTHONPATH", "")
        e["YOLO_MS_PREEMPT_GRACE_S"] = e.get("YOLO_MS_PREEMPT_GRACE_S", "60")
        e.update(env or {})
        procs.append(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), mode, *args], cwd=ROOT, env=e,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    return procs


def finish(procs: list, timeout: float = 240.0) -> tuple[list, list]:
    """Exit codes and outputs; a rank still running at the deadline is
    killed (and the test fails on its exit code)."""
    outs, deadline = [], time.monotonic() + timeout
    try:
        for p in procs:
            try:
                outs.append(p.communicate(timeout=max(1.0, deadline - time.monotonic()))[0])
            except subprocess.TimeoutExpired:
                p.kill()
                outs.append(p.communicate()[0] + "\nKILLED AT THE TIMEOUT")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return [p.returncode for p in procs], outs


def run_ranks(mode: str, world: int, *args: str, env: dict | None = None,
              timeout: float = 240.0) -> tuple[list, list]:
    return finish(start_ranks(mode, world, *args, env=env), timeout)


def lines(out: str, tag: str) -> list:
    """The JSON payloads of the lines ``TAG {...}`` of one rank's output."""
    return [json.loads(ln[len(tag) + 1:]) for ln in out.splitlines() if ln.startswith(tag + " ")]


# ---------------------------------------------------------------- the ranks


def _setup():
    # the trainer's TensorBoard writer then uses tensorboard's own stub
    # instead of importing TensorFlow (~20 s where it is installed)
    sys.modules["tensorflow"] = None
    from yolo_ms_tpu_torch.parallel.distributed import maybe_initialize_distributed

    maybe_initialize_distributed(device="cpu")


def mode_helpers(out_dir: str) -> None:
    import torch

    from yolo_ms_tpu_torch.parallel import distributed as D
    from yolo_ms_tpu_torch.parallel.mesh import make_mesh, shard_batch

    rank = D.get_rank()
    info = D.process_info()
    if rank == 1:
        time.sleep(1.0)  # the barrier must wait for the late rank
    t0 = time.monotonic()
    D.barrier("start")
    D.barrier("again")
    waited = time.monotonic() - t0
    x = torch.tensor([rank + 1.0], requires_grad=True)
    y = D.all_reduce_sum(x, D.data_parallel_group())
    (y * (rank + 1.0)).sum().backward()
    rows = shard_batch({"a": torch.arange(8).reshape(4, 2), "n": 3})
    print("HELPERS " + json.dumps({
        "info": info, "primary": D.is_primary_process(), "max": D.global_max_int(7 + 26 * rank),
        "waited": waited, "sum": y.item(), "grad": x.grad.item(), "calls": D.all_reduce_sum.calls,
        "mesh": make_mesh() is not None, "rows": rows["a"].tolist(), "n": rows["n"],
    }), flush=True)


def mode_bn_block(io_dir: str) -> None:
    """One ConvBnSiLU in train mode on this rank's half of the batch."""
    import torch

    from yolo_ms_tpu_torch.nn.blocks import ConvBnSiLU, set_batch_norm_group
    from yolo_ms_tpu_torch.parallel.distributed import data_parallel_group, get_rank
    from yolo_ms_tpu_torch.parallel.mesh import shard_batch

    inp = torch.load(os.path.join(io_dir, "bn_block.pt"), weights_only=True)
    mod = ConvBnSiLU(*inp["ctor"])
    mod.load_state_dict(inp["sd"], strict=True)
    set_batch_norm_group(mod, data_parallel_group()).train()
    out = mod(shard_batch({"x": inp["x"]})["x"])
    torch.save({"out": out.detach(), "sd": mod.state_dict()},
               os.path.join(io_dir, f"bn_block_rank{get_rank()}.pt"))


def model_grads(model, x, weights):
    """Train-mode forward of ``x`` and the gradients of sum(maps * weights)
    with respect to ``x`` and every parameter."""
    import torch

    x = x.clone().requires_grad_(True)
    maps = model(x)
    loss = sum((m * w).sum() for m, w in zip(maps, weights))
    params = list(model.parameters())
    grads = torch.autograd.grad(loss, [x] + params)
    return grads[0], list(grads[1:])


def mode_bn_model(io_dir: str) -> None:
    """yolov8-n in train mode, in f64, on this rank's rows: statistics,
    input and (summed over the ranks) parameter gradients."""
    import torch
    import torch.distributed as dist

    from yolo_ms_tpu_torch.models.registry import build_model
    from yolo_ms_tpu_torch.nn.blocks import BatchNorm2d, set_batch_norm_group
    from yolo_ms_tpu_torch.parallel.distributed import (
        all_reduce_sum,
        data_parallel_group,
        get_rank,
    )
    from yolo_ms_tpu_torch.parallel.mesh import shard_batch

    inp = torch.load(os.path.join(io_dir, "bn_model.pt"), weights_only=True)
    model = build_model("n", num_classes=2, device="cpu")
    model.load_state_dict(inp["sd"], strict=True)
    set_batch_norm_group(model, data_parallel_group()).double().train()
    local = shard_batch({"x": inp["x"], **{f"w{i}": w for i, w in enumerate(inp["w"])}})
    weights = [local[f"w{i}"] for i in range(len(inp["w"]))]
    x_grad, p_grads = model_grads(model, local["x"], weights)
    for g in p_grads:
        dist.all_reduce(g)
    n_bn = sum(isinstance(m, BatchNorm2d) for m in model.modules())
    torch.save({"x_grad": x_grad, "p_grads": p_grads, "sd": model.state_dict(),
                "bn_layers": n_bn, "syncs": all_reduce_sum.calls},
               os.path.join(io_dir, f"bn_model_rank{get_rank()}.pt"))


def mode_step(io_dir: str) -> None:
    """``make_train_step`` (SGD with EMA) on this rank's rows of each global
    batch of ``step.pt``; the state after every step; then a batch with a
    NaN pixel in rank 1's row only, from the state after the last step."""
    import numpy as np
    import torch

    from yolo_ms_tpu_torch.models.registry import build_model
    from yolo_ms_tpu_torch.nn.blocks import set_batch_norm_group
    from yolo_ms_tpu_torch.parallel.distributed import data_parallel_group, get_rank
    from yolo_ms_tpu_torch.parallel.mesh import shard_batch
    from yolo_ms_tpu_torch.train.loss import DetectionLoss
    from yolo_ms_tpu_torch.train.optim import build_optimizer
    from yolo_ms_tpu_torch.train.trainer import TrainState, make_train_step
    from yolo_ms_tpu_torch.utils.config import SchedulerConfig, TrainingConfig

    inp = torch.load(os.path.join(io_dir, "step.pt"), weights_only=False)
    model = build_model("n", num_classes=inp["nc"], device="cpu")
    model.load_state_dict(inp["sd"], strict=True)
    cfg = TrainingConfig(**inp["opt"])
    cfg.scheduler = SchedulerConfig(**inp["sched"])
    tx, _ = build_optimizer(cfg, 4)
    group = data_parallel_group()
    state = TrainState.create(model, tx, ema=True)
    set_batch_norm_group(state.model, group)
    state.step.fill_(inp["start_step"])
    step = make_train_step(DetectionLoss(num_classes=inp["nc"], group=group), tx, cfg.ema_decay,
                           torch.float32, group)
    rank = get_rank()

    def local(batch):
        return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in shard_batch(batch).items()}

    results = []
    for batch in inp["batches"]:
        m = step(state, local(batch))
        results.append({"metrics": {k: float(v) for k, v in m.items()},
                        "state": state.state_dict(),
                        "flat": torch.cat([state.params, state.stats, state.ema_params,
                                           state.ema_stats])})
    before = [t.clone() for t in (state.params, state.stats, state.ema_params, state.ema_stats,
                                  *state.opt_state.values())]
    m = step(state, local(inp["nan_batch"]))
    after = (state.params, state.stats, state.ema_params, state.ema_stats,
             *state.opt_state.values())
    nan = {"metrics": {k: float(v) for k, v in m.items()},
           "frozen": all(torch.equal(a, b) for a, b in zip(before, after)),
           "step": int(state.step)}
    torch.save({"steps": results, "nan": nan}, os.path.join(io_dir, f"step_rank{rank}.pt"))


def trainer_config(data_root: str, exp: str, log_dir: str, epochs: int = 1,
                   golden: bool = False):
    """yolov8-n, SGD with EMA, global batch 4, ``gt_buckets [4]``: random
    init at 64 px with nc=2, or (``golden``) from the trained golden weights
    at 160 px with nc=3, which detect the synthetic set's objects, so that
    the validation's mAP is far from 0."""
    from yolo_ms_tpu_torch.utils.config import Config

    images, ann = os.path.join(data_root, "images"), os.path.join(data_root, "annotations.json")
    size, nc = (160, 3) if golden else (64, 2)
    weights = os.path.join(ROOT, "tests", "golden", "trained", "weights.npz") if golden else None
    return Config.from_dict({
        "dataset": {"train_images_path": images, "train_annotations_path": ann,
                    "val_images_path": images, "val_annotations_path": ann,
                    "num_classes": nc, "max_gt": 8, "gt_buckets": [4]},
        "model": {"architecture": "n", "input_size": [size, size], "compute_dtype": "float32",
                  "pretrained_weights_path": weights},
        "training": {"batch_size": 4, "epochs": epochs, "optimizer": "sgd",
                     "learning_rate": 0.01, "weight_decay": 5e-4, "ema_decay": 0.9999,
                     "val_interval": 1, "experiment_name": exp, "log_dir": log_dir,
                     "augmentation": {"fliplr": 0.5}},
        "evaluation": {"batch_size": 4, "confidence_threshold": 0.05},
        "device": "cpu", "workers": 2,
    })


def mode_trainer(data_root: str, exp: str, epochs: str, model: str, resume: str = "") -> None:
    """``Trainer.fit`` (validation at each epoch end). Each rank writes
    under its own ``runs_rank{r}`` so that the test sees who wrote what.
    Prints the local GT-slot need of the first batch, one RECORD per step
    (global step, sha256 of this rank's images, the loss terms), and after
    a fit that ends, the last validation's mAP; writes the final state to
    ``{exp}_rank{r}_final.pt``. ``SNIPE_STEP`` sends this process SIGTERM
    while that global step is in flight."""
    import hashlib

    import numpy as np
    import torch

    from yolo_ms_tpu_torch.parallel.distributed import get_rank
    from yolo_ms_tpu_torch.train.trainer import Trainer

    rank = get_rank()
    trainer = Trainer(trainer_config(data_root, exp, os.path.join(data_root, f"runs_rank{rank}"),
                                     int(epochs), golden=model == "golden"), verbose=False)
    first = next(iter(trainer.train_loader.epoch(0)))
    used = np.flatnonzero(first["mask"].any(axis=0))
    print("NEEDED " + json.dumps(int(used[-1]) + 1 if used.size else 1), flush=True)
    if resume:
        trainer.resume(resume)
    spe = len(trainer.train_loader)
    offset = trainer.start_epoch * spe + trainer.start_step
    snipe = int(os.environ.get("SNIPE_STEP", "-1"))
    inner, n = trainer._train_step, [0]

    def step(state, batch):
        metrics = inner(state, batch)
        i = offset + n[0]
        n[0] += 1
        digest = hashlib.sha256(batch["images"].numpy().tobytes()).hexdigest()
        print("RECORD " + json.dumps([i, digest, batch["boxes"].shape[1],
                                      {k: float(v) for k, v in metrics.items()}]), flush=True)
        if i == snipe:
            print(f"SIGNAL_AT {time.time():.6f}", flush=True)
            os.kill(os.getpid(), signal.SIGTERM)
            assert trainer._preempt_signum == signal.SIGTERM and trainer._step_active
            print("DEFERRED", flush=True)
        return metrics

    trainer._train_step = step
    trainer.fit()
    result = trainer._last_val_result
    print("MAP " + json.dumps({"detections": trainer._last_val_detections,
                               **{k: float(v) for k, v in result.items() if np.isscalar(v)}}),
          flush=True)
    torch.save(trainer.state.state_dict(), os.path.join(data_root, f"{exp}_rank{rank}_final.pt"))


def mode_idle(data_root: str, exp: str) -> None:
    """A ``Trainer`` with its preemption handler installed and no step in
    flight, at cursor (1, 0); prints READY and waits for the signal."""
    from yolo_ms_tpu_torch.parallel.distributed import get_rank
    from yolo_ms_tpu_torch.train.trainer import Trainer

    trainer = Trainer(trainer_config(data_root, exp,
                                     os.path.join(data_root, f"runs_rank{get_rank()}")),
                      verbose=False)
    trainer._cursor = (1, 0)  # no commit yet in epoch 1
    trainer._install_preemption_handler()
    print("READY", flush=True)
    time.sleep(120)
    sys.exit(99)  # the signal never came


# ------------------------------------------------------- height sharding


def mode_spatial_serve(io_dir: str) -> None:
    """``spatial_serve.pt``'s model and batch served height-sharded over all
    ranks (a (1, world) mesh): the detections, and the raw maps of the
    sharded forward (gathered to full height by the head)."""
    import torch

    from yolo_ms_tpu_torch.infer.program import ServingProgram
    from yolo_ms_tpu_torch.models.registry import build_model
    from yolo_ms_tpu_torch.nn.blocks import set_spatial_group
    from yolo_ms_tpu_torch.parallel.distributed import get_rank, world_size
    from yolo_ms_tpu_torch.parallel.mesh import make_mesh_2d
    from yolo_ms_tpu_torch.parallel.spatial import serve_height_sharded

    inp = torch.load(os.path.join(io_dir, "spatial_serve.pt"), weights_only=False)
    mesh = make_mesh_2d(1, world_size())
    model = build_model(inp["arch"], num_classes=inp["nc"], device="cpu")
    model.load_state_dict(inp["sd"], strict=True)
    set_spatial_group(model, mesh)
    images = torch.from_numpy(inp["images"])  # NHWC f32, the same on every rank
    with torch.no_grad():
        out = serve_height_sharded(
            ServingProgram(model, inp["nc"], dtype=torch.float32, **inp["post"]), images, mesh)
        with mesh.shards.rows(images.shape[1]):
            maps = model(mesh.shards.own_rows(images, 1).permute(0, 3, 1, 2).contiguous())
    torch.save({"out": out, "maps": [m.permute(0, 2, 3, 1) for m in maps],
                "exchanges": mesh.shards.exchanges},
               os.path.join(io_dir, f"spatial_serve_rank{get_rank()}.pt"))


def spatial_step_setup(sd: dict, nc: int, mesh=None, arch: str = "n"):
    """``arch`` from ``sd`` with the JAX spatial test's SGD (weight decay 0,
    no EMA) and its f32 train step; hybrid data x spatial over ``mesh``
    (``Mesh.attach``), or one process without it."""
    from yolo_ms_tpu_torch.models.registry import build_model
    from yolo_ms_tpu_torch.train.loss import DetectionLoss
    from yolo_ms_tpu_torch.train.optim import build_optimizer
    from yolo_ms_tpu_torch.train.trainer import TrainState, make_train_step
    from yolo_ms_tpu_torch.utils.config import TrainingConfig

    model = build_model(arch, num_classes=nc, device="cpu")
    model.load_state_dict(sd, strict=True)
    tx, _ = build_optimizer(TrainingConfig(batch_size=8, epochs=1, weight_decay=0.0,
                                           optimizer="sgd"), 10)
    state = TrainState.create(model, tx, ema=False)
    loss = DetectionLoss(num_classes=nc)
    if mesh is not None:
        loss = mesh.attach(state.model, loss)
    return state, make_train_step(loss, tx, mesh=mesh)


def mode_spatial_step(io_dir: str, data: str, spatial: str) -> None:
    """The hybrid train step on a (data, spatial) mesh for each batch of
    ``spatial_step.pt``, from its weights: the metrics and the flat state
    after every step, and the exchanges this rank took part in."""
    import numpy as np
    import torch

    from yolo_ms_tpu_torch.parallel.distributed import get_rank
    from yolo_ms_tpu_torch.parallel.mesh import hybrid_batch_sharding, make_mesh_2d

    inp = torch.load(os.path.join(io_dir, "spatial_step.pt"), weights_only=False)
    mesh = make_mesh_2d(int(data), int(spatial))
    state, step = spatial_step_setup(inp["sd"], inp["nc"], mesh, inp["arch"])
    local = {k: torch.from_numpy(np.ascontiguousarray(v)) if isinstance(v, np.ndarray) else v
             for k, v in hybrid_batch_sharding(mesh)(inp["batch"]).items()}
    out = {"metrics": [], "flat": [], "rows": tuple(local["images"].shape)}
    for _ in range(inp["steps"]):
        m = step(state, local)
        out["metrics"].append({k: float(v) for k, v in m.items()})
        out["flat"].append(torch.cat([state.params, state.stats]).clone())
    out["exchanges"] = mesh.shards.exchanges
    torch.save(out, os.path.join(io_dir, f"spatial_step_{data}x{spatial}_rank{get_rank()}.pt"))


def mode_spatial_trainer(data_root: str, exp: str, spatial: str) -> None:
    """``Trainer.fit`` + ``validate`` with ``parallel.spatial`` (the JAX
    package's ``tests/test_train_e2e.py`` tiny config), each rank logging
    under its own ``runs_rank{r}``: one RESULT line, the final state in
    ``{exp}_rank{r}_final.pt``."""
    import numpy as np
    import torch

    from yolo_ms_tpu_torch.parallel.distributed import get_rank
    from yolo_ms_tpu_torch.train.trainer import Trainer
    from yolo_ms_tpu_torch.utils.config import Config

    rank = get_rank()
    images, ann = os.path.join(data_root, "images"), os.path.join(data_root, "annotations.json")
    cfg = Config.from_dict({
        "dataset": {"train_images_path": images, "train_annotations_path": ann,
                    "val_images_path": images, "val_annotations_path": ann,
                    "num_classes": 2, "max_gt": 8, "gt_buckets": [4]},
        "model": {"architecture": "n", "input_size": [64, 64]},
        "training": {"batch_size": 8, "epochs": 1, "learning_rate": 1e-3, "optimizer": "adam",
                     "weight_decay": 0.0, "val_interval": 2, "experiment_name": exp,
                     "log_dir": os.path.join(data_root, f"runs_rank{rank}"),
                     "augmentation": {"fliplr": 0.5},
                     "scheduler": {"type": "cosine", "cosine_t_max": 2}},
        "evaluation": {"batch_size": 8, "confidence_threshold": 0.05},
        "parallel": {"spatial": int(spatial)},
        "device": "cpu", "workers": 1,
    })
    trainer = Trainer(cfg, verbose=False)
    inner, metrics = trainer._train_step, []

    def step(state, batch):
        m = inner(state, batch)
        metrics.append({k: float(v) for k, v in m.items()})
        return m

    trainer._train_step = step
    trainer.fit()
    m = trainer.validate()
    mesh = trainer.mesh
    print("RESULT " + json.dumps({
        "mesh": None if mesh is None else [mesh.data, mesh.spatial], "steps": int(trainer.state.step),
        "metrics": metrics, "map": None if np.isnan(m) else float(m),
        "val_images_local": trainer._val_images_local,
        "exchanges": None if mesh is None else mesh.shards.exchanges,
    }), flush=True)
    torch.save(trainer.state.state_dict(), os.path.join(data_root, f"{exp}_rank{rank}_final.pt"))


if __name__ == "__main__":
    _setup()
    {"helpers": mode_helpers, "bn_block": mode_bn_block, "bn_model": mode_bn_model,
     "step": mode_step, "trainer": mode_trainer, "idle": mode_idle,
     "spatial_serve": mode_spatial_serve, "spatial_step": mode_spatial_step,
     "spatial_trainer": mode_spatial_trainer}[sys.argv[1]](*sys.argv[2:])
    from yolo_ms_tpu_torch.parallel.distributed import leave_group

    leave_group()
