"""Training pipeline: the train step, validation, checkpoints and resume.

Port of ``yolo_ms_tpu/train/trainer.py``, on one device or data parallel
over several processes (one device per rank):

- ``make_train_step`` builds the step: train-mode forward (bf16 autocast, or
  full f32 with TF32 off) -> ``DetectionLoss`` in f32 -> backward -> the
  optax-semantics optimizer on one flat f32 vector -> NaN guard -> EMA of
  the parameters and of the BatchNorm running statistics.
- The NaN guard checks the loss and the updates. A bad step leaves the
  parameters, the running statistics (which the train-mode forward writes in
  place, so they are snapshotted first), the optimizer state and the EMA as
  they were; the step count still advances. The decision stays on the
  device: every commit is a ``torch.where`` on the one ``good`` flag, so a
  step needs no host sync.
- ``Trainer`` runs ``fit`` (loader -> step; per-step losses stay on the
  device, one host read every 10 steps; the epoch mean; validation every
  ``val_interval`` epochs; best / last / epoch_N checkpoints), ``validate``
  (EMA weights and EMA statistics through the serving tail
  ``fused_postprocess``, COCO-protocol mAP on the host) and ``resume`` (at
  an epoch end or mid-epoch; the loader is a pure function of
  (seed, epoch, index), so the resumed run sees the same batches).

The parameters of the model (and of its EMA copy) are views into one flat
f32 tensor, the running statistics into another, so that the optimizer,
the guard and the EMA each touch a handful of tensors whatever the number
of layers.

SIGTERM / SIGINT during ``fit`` save ``weights/preempt.ckpt`` (the full
state and the cursor of committed steps) and exit with 128 + the signal's
number. A signal that lands while a train step is being enqueued is
deferred to the step's commit point; ``resume`` continues from the file.
Pretrained weights may be a reference ``.pt`` file (mapped by
``utils/checkpoint.py``), a flax-layout ``.npz`` or a port checkpoint.

Data parallel (a process group of more than one rank, see
``parallel/distributed.py``): ``training.batch_size`` is the GLOBAL batch and
each rank's loader yields its rows of it; every rank computes the step the
JAX package computes on the global batch. ``Trainer`` reads the group once
and hands it to each layer that reduces over it: the BatchNorm statistics
are the global batch's (``nn/blocks.py``), each rank's loss is its own sums
over the global normalizer (``train/loss.py``), and ONE sum all-reduce of
the flat gradient before the optimizer makes it the global loss's gradient. Clipping,
decay, accumulation, the NaN guard and the EMA then see the same bytes on
every rank, so every rank commits the same state with no further collective
(``DistributedDataParallel`` is not used: it averages the gradients and its
buffer broadcast overwrites the BatchNorm statistics). Validation serves each
rank's rows and gathers the fixed-shape detections, so that every rank
accumulates mAP over the same global stream; only rank 0 writes files. The
JAX trainer's ``_globalize`` (assembling a global array from each host's
rows) becomes ``_to_device``, since each rank's rows are already on its own
device, and ``_run_synced`` (fencing each new XLA compile with a barrier)
becomes a plain call, since nothing compiles per shape here.

Hybrid data x spatial (``parallel.spatial = S > 1``, the JAX trainer's 2-D
mesh): the ranks form a (world / S, S) mesh (``parallel/mesh.py``). The S
ranks of one data row decode the same rows of the global batch and each
takes its band of the image height (``spatial_sharding``); the model
exchanges halo rows around every conv and pool and gathers the head's maps
to full height (``nn/blocks.py:set_spatial_group``), so that every rank of
the row computes that row's loss. BatchNorm and the gradient sum over the
world, the loss normalizer and metrics over the data group
(``Mesh.attach``). Validation is sharded over ``data`` only, as in JAX:
the ranks of one data row decode and serve the same rows at full height,
and the detections are gathered over the data group.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import os
import signal
import socket
import threading
import time

import numpy as np
import torch
import torch.distributed as dist
from torch import nn
from torch.profiler import record_function

from yolo_ms_tpu_torch.data.augment import device_normalize_images
from yolo_ms_tpu_torch.data.coco import CocoDetectionDataset
from yolo_ms_tpu_torch.data.loader import DetectionLoader
from yolo_ms_tpu_torch.eval.coco_map import (
    MeanAveragePrecision,
    map_iou_thresholds,
    update_from_batch,
)
from yolo_ms_tpu_torch.models.registry import build_model, init_model
from yolo_ms_tpu_torch.nn.blocks import set_batch_norm_group
from yolo_ms_tpu_torch.ops.postprocess import fused_postprocess
from yolo_ms_tpu_torch.parallel.distributed import (
    data_parallel_group,
    get_rank,
    global_max_int,
    is_primary_process,
    leave_group,
    rank_device,
    world_size,
)
from yolo_ms_tpu_torch.parallel.mesh import make_mesh_2d, spatial_sharding
from yolo_ms_tpu_torch.train.loss import DetectionLoss
from yolo_ms_tpu_torch.train.optim import build_optimizer, freeze_mask
from yolo_ms_tpu_torch.utils.checkpoint import (
    CheckpointManager,
    load_torch_checkpoint,
    restore_checkpoint,
    save_checkpoint,
)
from yolo_ms_tpu_torch.utils.config import Config
from yolo_ms_tpu_torch.utils.convert import flax_param_path, load_npz
from yolo_ms_tpu_torch.utils.device import config_device, full_f32, resolve_device
from yolo_ms_tpu_torch.utils.logging import MetricLogger
from yolo_ms_tpu_torch.utils.profiler import span

BATCH_KEYS = ("images", "boxes", "labels", "mask")


def _flat_params(model: nn.Module) -> torch.Tensor:
    """Move every parameter into one flat f32 tensor (each parameter becomes
    a view of it) and return the flat tensor."""
    params = list(model.parameters())
    flat = torch.cat([p.detach().reshape(-1).float() for p in params])
    offset = 0
    for p in params:
        n = p.numel()
        p.data = flat[offset : offset + n].view_as(p)
        offset += n
    return flat


def _flat_stats(model: nn.Module) -> torch.Tensor:
    """The same for the BatchNorm running means and variances."""
    mods = [m for m in model.modules() if isinstance(m, nn.BatchNorm2d)]
    flat = torch.cat(
        [t.reshape(-1).float() for m in mods for t in (m.running_mean, m.running_var)]
    )
    offset = 0
    for m in mods:
        for name in ("running_mean", "running_var"):
            n = getattr(m, name).numel()
            setattr(m, name, flat[offset : offset + n])
            offset += n
    return flat


@dataclasses.dataclass
class TrainState:
    """The whole training state, on one device.

    ``model`` is in train structure and train mode; ``params`` and
    ``stats`` are the flat tensors its parameters and running statistics
    view. ``ema`` is the EMA copy (eval mode, no gradients) with its own
    flat ``ema_params`` / ``ema_stats``, or None when EMA is off. ``step``
    counts train-step calls (an int32 device scalar, as the JAX state's).
    """

    model: nn.Module
    params: torch.Tensor
    stats: torch.Tensor
    opt_state: dict
    step: torch.Tensor
    ema: nn.Module | None = None
    ema_params: torch.Tensor | None = None
    ema_stats: torch.Tensor | None = None

    @classmethod
    def create(cls, model: nn.Module, tx, ema: bool) -> "TrainState":
        model.train()
        params = _flat_params(model)
        stats = _flat_stats(model)
        ema_model = ema_params = ema_stats = None
        if ema:
            ema_model = copy.deepcopy(model).eval().requires_grad_(False)
            ema_params = _flat_params(ema_model)
            ema_stats = _flat_stats(ema_model)
        return cls(
            model=model,
            params=params,
            stats=stats,
            opt_state=tx.init(params),
            step=torch.zeros((), dtype=torch.int32, device=params.device),
            ema=ema_model,
            ema_params=ema_params,
            ema_stats=ema_stats,
        )

    def state_dict(self) -> dict:
        """Host copies of everything, for a checkpoint."""

        def host(sd):
            return {k: v.detach().cpu().clone() for k, v in sd.items()}

        return {
            "model": host(self.model.state_dict()),
            "ema": None if self.ema is None else host(self.ema.state_dict()),
            "opt_state": host(self.opt_state),
            "step": int(self.step),
        }

    @torch.no_grad()
    def load_state_dict(self, sd: dict) -> None:
        """Restore in place (the flat tensors keep their identity)."""
        self.model.load_state_dict(sd["model"], strict=True)
        if (sd["ema"] is None) != (self.ema is None):
            raise ValueError("checkpoint and trainer disagree on EMA")
        if self.ema is not None:
            self.ema.load_state_dict(sd["ema"], strict=True)
        if set(sd["opt_state"]) != set(self.opt_state):
            raise ValueError(
                f"optimizer state keys differ: {sorted(sd['opt_state'])} vs "
                f"{sorted(self.opt_state)}"
            )
        for k, v in sd["opt_state"].items():
            self.opt_state[k] = v.to(self.opt_state[k].device)
        self.step.fill_(int(sd["step"]))


def _precision(compute_dtype: torch.dtype, device: torch.device):
    """bf16: autocast (f32 master weights); f32: full f32, TF32 off."""
    if compute_dtype == torch.bfloat16:
        return torch.autocast(device_type=device.type, dtype=torch.bfloat16)
    return full_f32()


def make_train_step(loss_fn: DetectionLoss, tx, ema_decay: float = 0.0,
                    compute_dtype: torch.dtype = torch.float32, group=None, mesh=None):
    """Build ``train_step(state, batch) -> metrics``, the counterpart of the
    JAX package's pure step: it updates ``state`` in place and returns the
    loss terms, ``num_fg`` and ``skipped_nonfinite`` as device scalars.

    ``batch`` holds device tensors: uint8 (or float) NHWC ``images``,
    normalized (cx, cy, w, h) ``boxes`` [B, M, 4], ``labels`` [B, M] and
    ``mask`` [B, M]. The loss runs in f32 outside the autocast region. The
    four parts are ``torch.profiler`` ranges (``train_step/forward``,
    ``/loss``, ``/backward``, ``/update``), which cost nothing unless a
    profiler runs.

    Under data parallelism (``group``, the process group of the ranks;
    ``loss_fn`` and the model's BatchNorm layers carry the same group, see
    ``Trainer``) ``batch`` holds this rank's rows, the metrics are the
    global batch's, and the flat gradient is summed over the ranks (one
    all-reduce) before the optimizer. A step whose collective fails
    raises with the state as it was (the statistics the forward moved are
    put back), so a preempted run can still save it.

    On a 2-D ``mesh`` (``parallel/mesh.py``; pass it instead of ``group``,
    with the model given to ``mesh.attach`` and the loss it returned) the
    gradient is summed over the world, and ``batch`` is what
    ``hybrid_batch_sharding`` or ``spatial_sharding`` cut for this rank: its
    band of the image rows, and the image height as ``batch["height"]``; the
    forward runs height-sharded.
    """
    if mesh is not None:
        if group is not None:
            raise ValueError("pass the process group or the mesh, not both: the mesh "
                             "settles the gradient's group")
        if loss_fn.group is not mesh.data_group:
            raise ValueError("on a mesh the loss reduces over the data group: train "
                             "with the loss that mesh.attach returns")
        group = data_parallel_group()
    sharded = mesh is not None and mesh.spatial > 1

    def train_step(state: TrainState, batch: dict) -> dict:
        model = state.model
        images = device_normalize_images(batch["images"], compute_dtype)
        images = images.permute(0, 3, 1, 2).contiguous()
        rows = mesh.shards.rows(batch["height"]) if sharded else contextlib.nullcontext()
        old_stats = state.stats.clone()  # the forward updates them in place
        params = list(model.parameters())
        try:
            with _precision(compute_dtype, images.device):
                with record_function("train_step/forward"), rows:
                    raw = model(images)
                with record_function("train_step/loss"), torch.autocast(
                        device_type=images.device.type, enabled=False):
                    loss, metrics = loss_fn(raw, batch["boxes"], batch["labels"],
                                            batch["mask"])
                with record_function("train_step/backward"):
                    grads = torch.autograd.grad(loss, params)
            with torch.no_grad():
                flat_grads = torch.cat([g.reshape(-1) for g in grads]).float()
                if group is not None:
                    with record_function("train_step/grad_all_reduce"):
                        dist.all_reduce(flat_grads, group=group)
        except BaseException:
            with torch.no_grad():
                state.stats.copy_(old_stats)
            raise

        with torch.no_grad(), record_function("train_step/update"):
            updates, new_opt = tx.update(flat_grads, state.opt_state, state.params)
            # the global batch's loss (in one process, ``loss`` itself)
            good = torch.isfinite(metrics["total_loss"]) & torch.isfinite(updates).all()
            new_params = state.params + updates
            if state.ema is not None and ema_decay > 0.0:
                d = ema_decay * (1.0 - torch.exp(-(state.step.float() + 1.0) / 2000.0))
                ema_p = state.ema_params * d + new_params * (1.0 - d)
                ema_s = state.ema_stats * d + state.stats * (1.0 - d)
                state.ema_params.copy_(torch.where(good, ema_p, state.ema_params))
                state.ema_stats.copy_(torch.where(good, ema_s, state.ema_stats))
            state.params.copy_(torch.where(good, new_params, state.params))
            state.stats.copy_(torch.where(good, state.stats, old_stats))
            for k, v in new_opt.items():
                state.opt_state[k] = torch.where(good, v, state.opt_state[k])
            state.step += 1
        metrics = {k: v.detach() for k, v in metrics.items()}
        metrics["skipped_nonfinite"] = 1.0 - good.float()
        return metrics

    return train_step


class Trainer:
    """Config-driven training on one device (the card unless the caller or
    the config asks for the CPU), or data parallel on this rank's device
    when a process group of several ranks is up."""

    def __init__(self, cfg: Config, verbose: bool = True, device=None):
        self.cfg = cfg
        self.verbose = verbose
        self.device = resolve_device(config_device(cfg, device))
        self.rank, self.world = get_rank(), world_size()
        self._primary = is_primary_process()
        # the data-parallel group (None in one process): the trainer hands it
        # to the loss, the train step and the model's BatchNorm layers
        self.group = data_parallel_group()
        if self.world > 1 and self.device.type == "cuda" and self.device.index is None:
            self.device = rank_device()
        mcfg, dcfg, tcfg = cfg.model, cfg.dataset, cfg.training
        self.img_size = tuple(mcfg.input_size)
        # parallel.spatial > 1: hybrid DP x SP, batch over "data", image
        # height over "spatial" (the JAX trainer's checks and messages; the
        # two that read only the config come first)
        spatial = max(1, int(cfg.parallel.spatial))
        self.mesh = None
        if spatial > 1:
            if self.img_size[0] % spatial:
                raise ValueError(f"parallel.spatial={spatial} must divide the image "
                                 f"height ({self.img_size[0]})")
            for s in tcfg.multiscale_sizes or []:
                if int(s) % spatial:
                    raise ValueError(f"parallel.spatial={spatial} must divide every "
                                     f"multiscale size (got {s})")
            if self.world % spatial:
                raise ValueError(f"parallel.spatial={spatial} must divide the device "
                                 f"count ({self.world})")
            self.mesh = make_mesh_2d(self.world // spatial, spatial)
        # the rows of the global batch this rank's data row decodes, and
        # the group over which the data rows' results are gathered
        data_shard = ((self.mesh.data_index, self.mesh.data) if self.mesh
                      else (self.rank, self.world))
        self._data_group = self.mesh.data_group if self.mesh else self.group
        self.compute_dtype = (
            torch.bfloat16 if mcfg.compute_dtype == "bfloat16" else torch.float32
        )
        self.loss_fn = DetectionLoss(
            num_classes=dcfg.num_classes,
            reg_max=mcfg.reg_max,
            box_weight=cfg.loss.box_weight,
            cls_weight=cfg.loss.cls_weight,
            dfl_weight=cfg.loss.dfl_weight,
            use_focal=cfg.loss.use_focal,
            alpha=cfg.loss.alpha,
            gamma=cfg.loss.gamma,
            tal_topk=cfg.loss.tal_topk,
            iou_type=cfg.loss.iou_type,
            group=self._data_group,
        )

        # --- data ---
        self.train_loader = None
        self.val_loader = None
        if dcfg.train_annotations_path:
            train_ds = CocoDetectionDataset(
                dcfg.train_images_path,
                dcfg.train_annotations_path,
                num_classes=dcfg.num_classes,
                verbose=verbose,
            )
            self.train_loader = DetectionLoader(
                train_ds,
                batch_size=tcfg.batch_size,
                img_size=self.img_size,
                max_gt=dcfg.max_gt,
                is_train=True,
                augmentation=tcfg.augmentation.as_dict(),
                seed=tcfg.seed,
                num_workers=cfg.workers,
                device_normalize=True,
                multiscale_sizes=tcfg.multiscale_sizes,
                multiscale_interval=tcfg.multiscale_interval,
                # batch_size is the GLOBAL batch; this rank decodes its data
                # row's rows
                process_shard=data_shard,
            )
        # the sharded val feed (the JAX trainer's preconditions, over the
        # data axis only): each data row decodes and serves its image rows,
        # the targets stay global
        self._val_images_local = (
            data_shard[1] > 1 and cfg.evaluation.batch_size % data_shard[1] == 0
        )
        self._image_rows = spatial_sharding(self.mesh) if self.mesh else None
        if dcfg.val_annotations_path:
            val_ds = CocoDetectionDataset(
                dcfg.val_images_path,
                dcfg.val_annotations_path,
                num_classes=dcfg.num_classes,
                verbose=verbose,
            )
            self.val_loader = DetectionLoader(
                val_ds,
                batch_size=cfg.evaluation.batch_size,
                img_size=self.img_size,
                max_gt=dcfg.max_gt,
                is_train=False,
                seed=tcfg.seed,
                num_workers=cfg.workers,
                drop_last=False,
                device_normalize=True,
                process_shard=data_shard if self._val_images_local else None,
                shard_images_only=self._val_images_local,
            )

        # --- model: drawn on the CPU from the seed (the same weights on
        # every device), then pretrained weights merged in ---
        model = build_model(
            mcfg.architecture, num_classes=dcfg.num_classes, reg_max=mcfg.reg_max,
            device="cpu",
        )
        init_model(model, torch.Generator().manual_seed(tcfg.seed))
        self._maybe_load_pretrained(model)
        model.to(self.device)

        steps_per_epoch = len(self.train_loader) if self.train_loader else 1
        # the schedule counts APPLIED updates: per-epoch boundaries shrink
        # by the accumulation factor
        self.accum = max(1, tcfg.grad_accum_steps or 1)
        trainable = None
        if tcfg.freeze_layers:
            keep = freeze_mask(
                [flax_param_path(n, p.ndim) for n, p in model.named_parameters()],
                tcfg.freeze_layers,
            )
            trainable = torch.cat([
                torch.full((p.numel(),), k, dtype=torch.bool)
                for k, p in zip(keep, model.parameters())
            ]).to(self.device)
        self.tx, self.lr_schedule = build_optimizer(
            tcfg, max(1, steps_per_epoch // self.accum), trainable=trainable
        )
        self.state = TrainState.create(model, self.tx, ema=tcfg.ema_decay > 0)
        # not the eval-only EMA copy
        if self.mesh:
            self.loss_fn = self.mesh.attach(self.state.model, self.loss_fn)
        else:
            set_batch_norm_group(self.state.model, self.group)
        self._broadcast_state()
        self._train_step = make_train_step(
            self.loss_fn, self.tx, tcfg.ema_decay, self.compute_dtype,
            group=None if self.mesh else self.group, mesh=self.mesh,
        )
        self.start_epoch = 0
        self.start_step = 0
        # (epoch, steps committed in it): one tuple stored in one STORE_ATTR,
        # so the signal handler (which runs between bytecodes on this same
        # thread) never sees a half-updated pair
        self._cursor = (0, 0)
        # True exactly while a train step is being enqueued: its in-place
        # commits of params, statistics, moments and EMA are not all queued
        # yet, so the handler defers the save to the loop's commit point
        self._step_active = False
        self._preempt_signum: int | None = None
        self._gt_buckets: tuple[int, ...] = tuple(
            sorted(b for b in (dcfg.gt_buckets or []) if 0 < b < dcfg.max_gt)
        )

        # only the primary writes: every rank sees the same output directory
        self.output_dir = os.path.join(tcfg.log_dir, tcfg.experiment_name)
        if self._primary:
            os.makedirs(self.output_dir, exist_ok=True)
            cfg.save(os.path.join(self.output_dir, "config.yaml"))
        self.logger = MetricLogger(os.path.join(self.output_dir, "tensorboard_logs"))
        self.ckpt = CheckpointManager(
            os.path.join(self.output_dir, "weights"), save_period=tcfg.save_period
        )

    # ------------------------------------------------------------------ #

    def _say(self, *args) -> None:
        """Print on the primary only (every rank runs the same loop)."""
        if self._primary:
            print(*args)

    @torch.no_grad()
    def _broadcast_state(self) -> None:
        """Rank 0's parameters, statistics, optimizer state, EMA and step on
        every rank (after init or resume)."""
        if self.world == 1:
            return
        st = self.state
        tensors = [st.params, st.stats, st.step, *st.opt_state.values()]
        tensors += [t for t in (st.ema_params, st.ema_stats) if t is not None]
        for t in tensors:
            dist.broadcast(t, src=0)

    def _maybe_load_pretrained(self, model: nn.Module) -> None:
        for path in (
            self.cfg.model.pretrained_weights_path,
            self.cfg.training.pretrained_weights,
        ):
            if not path:
                continue
            if not os.path.exists(path):
                print(f"Warning: pretrained weights not found: {path}")
                continue
            if path.endswith((".pt", ".pth")):
                loaded = load_torch_checkpoint(path)
            elif path.endswith(".npz"):
                loaded = load_npz(path)
            else:
                loaded = restore_checkpoint(path)
                loaded = loaded.get("state", {}).get("model", loaded)
            _merge_matching(model, loaded, verbose=self.verbose)
            print(f"Loaded pretrained weights from {path}")

    def _bucket_gt(self, host_batch: dict) -> dict:
        """Slice the padded GT arrays to the smallest configured bucket that
        covers the highest used slot. Exact: padding rows are masked out of
        the assigner and the loss, so only their cost goes."""
        buckets = self._gt_buckets
        if not buckets:
            return host_batch
        mask = np.asarray(host_batch["mask"])
        used = np.flatnonzero(mask.any(axis=0))
        needed = int(used[-1]) + 1 if used.size else 1
        if world_size() > 1:
            # every rank must slice alike (the loss's all-reduces see the same
            # bucket): agree on the highest slot over the ranks
            needed = global_max_int(needed)
        m = next((b for b in buckets if b >= needed), mask.shape[1])
        if m >= mask.shape[1]:
            return host_batch
        return {
            "images": host_batch["images"],
            "boxes": host_batch["boxes"][:, :m],
            "labels": host_batch["labels"][:, :m],
            "mask": host_batch["mask"][:, :m],
        }

    def _to_device(self, host_batch: dict) -> dict:
        """The batch on this rank's device: under spatial > 1, its band of
        the image rows, with the image height as ``"height"``."""
        if self._image_rows is not None:
            host_batch = self._image_rows(host_batch)
        out = {
            k: torch.from_numpy(np.ascontiguousarray(host_batch[k])).to(
                self.device, non_blocking=True
            )
            for k in BATCH_KEYS
        }
        if "height" in host_batch:
            out["height"] = host_batch["height"]
        return out

    def _infer(self, model: nn.Module, images_u8: np.ndarray) -> dict:
        """The serving tail on a batch of images: host numpy outputs. Under
        the sharded val feed ``images_u8`` holds this data row's rows and the
        outputs of every data row are gathered in order."""
        with torch.inference_mode(), _precision(self.compute_dtype, self.device):
            x = torch.from_numpy(np.ascontiguousarray(images_u8)).to(self.device)
            x = device_normalize_images(x, self.compute_dtype).permute(0, 3, 1, 2).contiguous()
            raw = model(x, split_head=True)
            maps = [(b.permute(0, 2, 3, 1), c.permute(0, 2, 3, 1)) for b, c in raw]
            out = fused_postprocess(
                maps,
                self.cfg.dataset.num_classes,
                self.cfg.model.reg_max,
                conf_thresh=self.cfg.evaluation.confidence_threshold,
                iou_thresh=self.cfg.evaluation.iou_threshold,
            )
            if self._val_images_local:
                out = _gather_rows(out, self._data_group)
        return {k: v.cpu().numpy() for k, v in out.items()}

    # ------------------------------------------------------------------ #

    def validate(self, epoch: int = -1) -> float:
        """mAP@0.5 over the val set, with the EMA weights and statistics
        (the raw ones when EMA is off). ``evaluation.map_iou_thresholds =
        "coco"`` also computes AP@[.50:.05:.95]; the returned metric stays
        mAP@0.5."""
        assert self.val_loader is not None, "no validation dataset configured"
        thresholds = map_iou_thresholds(self.cfg.evaluation.map_iou_thresholds)
        metric = MeanAveragePrecision(iou_thresholds=thresholds)
        n_images = total_dets = 0
        model = self.state.ema if self.state.ema is not None else self.state.model
        was_training = model.training
        model.eval()
        try:
            for batch in self.val_loader.epoch(0):
                out = self._infer(model, batch["images"])
                total_dets += update_from_batch(metric, out, batch, self.img_size)
                n_images += batch["num_valid"]
        finally:
            model.train(was_training)
        result = metric.compute()
        map50 = result.get("map_50", result["map"])
        self._last_val_result = result
        self._last_val_detections = total_dets
        if len(thresholds) > 1:
            self.logger.scalar("Validation/mAP_50_95", result["map"], max(epoch, 0))
        if self.verbose and self._primary:
            extra = f", AP@[.5:.95] = {result['map']:.4f}" if len(thresholds) > 1 else ""
            print(
                f"Validation epoch {epoch}: {n_images} images, "
                f"{total_dets} detections, mAP@0.5 = {map50:.4f}{extra}"
            )
        return map50

    # ------------------------------------------------------------------ #

    def checkpoint(self, epoch: int, step_in_epoch: int) -> dict:
        """What a checkpoint holds: the full state, the epoch and the step
        within it (0 = the epoch is complete)."""
        return {
            "state": self.state.state_dict(),
            "epoch": epoch,
            "step_in_epoch": step_in_epoch,
        }

    def resume(self, path: str) -> None:
        """Restore the full state; continue after a complete epoch, or
        mid-epoch at the saved step."""
        restored = restore_checkpoint(path)
        self.state.load_state_dict(restored["state"])
        self._broadcast_state()
        step_in_epoch = int(restored.get("step_in_epoch", 0) or 0)
        if step_in_epoch > 0:
            self.start_epoch = int(restored["epoch"])
            self.start_step = step_in_epoch
        else:
            self.start_epoch = int(restored["epoch"]) + 1
            self.start_step = 0

    def _save_preempt_and_exit(self, signum: int):
        """Save ``preempt.ckpt`` with the committed state and cursor, then
        exit 128 + signum. The card is synchronized first, so the file holds
        every queued commit. Under data parallelism every rank has finished
        its step in flight (the state is the same on all); the other ranks
        exit at once and the primary alone saves, with no collective."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        if not is_primary_process():
            leave_group()
            raise SystemExit(128 + signum)
        path = os.path.join(self.ckpt.dir, "preempt.ckpt")
        print(f"\nSignal {signum}: saving preemption checkpoint to {path}", flush=True)
        epoch, step = self._cursor
        if step == 0:
            # resume() reads step_in_epoch == 0 as "epoch complete, start the
            # next one" (the end-of-epoch checkpoint format). A preemption
            # before the first commit of epoch E must restart E from its
            # top: encode that as "epoch E-1 complete".
            epoch -= 1
        # the loader is a pure function of (seed, epoch, index): exact
        # mid-epoch resume
        save_checkpoint(path, self.checkpoint(epoch, step))
        leave_group()
        raise SystemExit(128 + signum)

    def _install_preemption_handler(self) -> dict:
        """Save a full-state checkpoint on SIGTERM / SIGINT, then exit
        128 + signum. Returns the handlers it replaced.

        Two paths:

        - idle (no train step being enqueued): the handler saves directly;
          the state is the last committed one.
        - a step in flight: ``_train_step`` enqueues in-place commits on the
          flat params, statistics, moments and EMA, so a save in the middle
          of that call would write a half-committed state. The handler only
          records the signal; ``fit`` saves at the commit point, with the
          cursor counting the step.

        A watchdog (``YOLO_MS_PREEMPT_GRACE_S`` seconds, default 60) armed
        at signal time hard-exits with the same code if the save does not
        finish. Under data parallelism it is also armed from a helper thread
        woken through ``signal.set_wakeup_fd``, so that it bounds a rank
        whose main thread is blocked in a collective (Python runs the
        handler only when that call returns). Off the main thread
        ``signal.signal`` raises ``ValueError`` and no handler is installed.
        Returns what ``_restore_signal_handling`` puts back."""
        grace = float(os.environ.get("YOLO_MS_PREEMPT_GRACE_S", "60"))

        def arm(signum):
            w = threading.Timer(grace, lambda: os._exit(128 + signum))
            w.daemon = True
            w.start()

        def handler(signum, frame):
            arm(signum)
            self._preempt_signum = signum
            if self._step_active:
                return  # defer: fit commits the step in flight, then saves
            self._save_preempt_and_exit(signum)

        previous = {}
        for sig in (signal.SIGTERM, signal.SIGINT):
            try:
                previous[sig] = signal.signal(sig, handler)
            except ValueError:
                return previous  # not in the main thread
        if self.world > 1:
            reader, writer = socket.socketpair()
            writer.setblocking(False)
            previous["wakeup_fd"] = (signal.set_wakeup_fd(writer.fileno()), writer)

            def watch():
                with reader:  # closing the writer ends the loop
                    while data := reader.recv(64):
                        for signum in data:
                            if signum in (signal.SIGTERM, signal.SIGINT):
                                arm(signum)

            threading.Thread(target=watch, daemon=True).start()
        return previous

    @staticmethod
    def _restore_signal_handling(previous: dict) -> None:
        wakeup = previous.pop("wakeup_fd", None)
        if wakeup is not None:
            old_fd, writer = wakeup
            signal.set_wakeup_fd(old_fd)
            writer.close()  # the watch thread's recv returns, and it ends
        for sig, h in previous.items():
            signal.signal(sig, h)

    def _preempted_peer_gone(self) -> bool:
        """After a failed step under data parallelism: True when this rank
        has a preemption signal, waiting up to 5 s for it (a peer preempted
        first may leave before this rank's signal lands)."""
        if self.world == 1:
            return False
        deadline = time.monotonic() + 5.0
        while self._preempt_signum is None and time.monotonic() < deadline:
            time.sleep(0.05)  # the handler runs between these sleeps
        return self._preempt_signum is not None

    def fit(self) -> None:
        assert self.train_loader is not None, "no training dataset configured"
        tcfg = self.cfg.training
        steps_per_epoch = len(self.train_loader)
        self._cursor = (self.start_epoch, self.start_step)
        previous = self._install_preemption_handler()
        self._say(f"Starting training for {tcfg.epochs} epochs ({steps_per_epoch} steps/epoch)")
        try:
            for epoch in range(self.start_epoch, tcfg.epochs):
                first_step = self.start_step if epoch == self.start_epoch else 0
                self._cursor = (epoch, first_step)
                self._fit_epoch(epoch, first_step, steps_per_epoch)
        finally:
            self._restore_signal_handling(previous)
        self.logger.close()
        self._say("Training finished.")

    def _fit_epoch(self, epoch: int, first_step: int, steps_per_epoch: int) -> None:
        tcfg = self.cfg.training
        t0 = time.time()
        # state.step counts train-step calls; the schedule counts applied
        # updates
        count = torch.tensor(int(self.state.step) // self.accum)
        lr = float(self.lr_schedule(count))
        self.logger.scalar("Training/Learning_Rate", lr, epoch)
        step_losses = []
        batches = self.train_loader.epoch(epoch, start_step=first_step)
        batch_idx = first_step
        try:
            while True:
                with span("fit/wait_batch"):
                    batch = next(batches, None)
                if batch is None:
                    break
                # in-flight window: a signal landing here is deferred to the
                # commit point below (see _install_preemption_handler)
                self._step_active = True
                try:
                    with span("fit/step"):
                        dev_batch = self._to_device(self._bucket_gt(batch))
                        metrics = self._train_step(self.state, dev_batch)
                    self._cursor = (epoch, batch_idx + 1)
                except Exception:
                    # a collective that fails because a preempted peer has
                    # gone: this step committed nothing, so drain as the
                    # signal asks instead of dying with a traceback
                    if self._preempted_peer_gone():
                        self._step_active = False
                        self._save_preempt_and_exit(self._preempt_signum)
                    raise
                finally:
                    self._step_active = False
                if self._preempt_signum is not None:
                    self._save_preempt_and_exit(self._preempt_signum)
                step_losses.append(metrics["total_loss"])
                gstep = epoch * steps_per_epoch + batch_idx
                if (batch_idx + 1) % 10 == 0 or batch_idx == 0:
                    m = {k: float(v) for k, v in metrics.items()}
                    self._say(
                        f"  epoch {epoch + 1} batch {batch_idx + 1}/{steps_per_epoch} "
                        f"loss {m['total_loss']:.4f} (box {m['loss_box']:.4f} "
                        f"cls {m['loss_cls']:.4f} dfl {m['loss_dfl']:.4f})"
                    )
                    self.logger.scalar("Loss/Batch/Total", m["total_loss"], gstep)
                    self.logger.scalar("Loss/Batch/Box", m["loss_box"], gstep)
                    self.logger.scalar("Loss/Batch/Cls", m["loss_cls"], gstep)
                    self.logger.scalar("Loss/Batch/DFL", m["loss_dfl"], gstep)
                batch_idx += 1
        finally:
            # stop the loader's threads now, not when the generator is
            # collected: an exit must not wait on them
            batches.close()

        avg_loss = float(torch.stack(step_losses).mean()) if step_losses else 0.0
        self.logger.scalar("Loss/Epoch/Total", avg_loss, epoch)
        self._say(
            f"Epoch {epoch + 1}/{tcfg.epochs}: avg loss {avg_loss:.4f}, "
            f"{time.time() - t0:.1f}s"
        )

        val_metric = None
        if self.val_loader is not None and (epoch + 1) % tcfg.val_interval == 0:
            val_metric = self.validate(epoch + 1)
            self.logger.scalar("Validation/mAP_50", val_metric, epoch)

        if self.ckpt.on_epoch_end(self.checkpoint(epoch, 0), epoch, val_metric):
            self._say(f"New best mAP@0.5: {val_metric:.4f}")


def _gather_rows(out: dict, group) -> dict:
    """Every rank's rows of the fixed-shape ``[local_B, max_det]`` serving
    outputs, concatenated in rank order: one all-gather of the four packed
    into f32 (class ids and the valid flag are exact in f32)."""
    packed = torch.cat([
        out["boxes"].float(),
        out["scores"].float()[..., None],
        out["classes"].float()[..., None],
        out["valid"].float()[..., None],
    ], dim=-1)
    parts = [torch.empty_like(packed) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, packed, group=group)
    rows = torch.cat(parts)
    return {
        "boxes": rows[..., :4].to(out["boxes"].dtype),
        "scores": rows[..., 4].to(out["scores"].dtype),
        "classes": rows[..., 5].to(out["classes"].dtype),
        "valid": rows[..., 6] > 0,
    }


@torch.no_grad()
def _merge_matching(model: nn.Module, loaded: dict, verbose: bool = True) -> None:
    """Non-strict load: copy the entries whose name and shape match
    (``load_state_dict(strict=False)`` with a shape check)."""
    own = model.state_dict()
    missing = [k for k in own if k not in loaded]
    unexpected, mismatched = [], []
    for key, val in loaded.items():
        if key not in own:
            unexpected.append(key)
        elif tuple(own[key].shape) != tuple(val.shape):
            mismatched.append(key)
        else:
            own[key].copy_(torch.as_tensor(val))
    if verbose and (missing or unexpected or mismatched):
        print(
            f"Pretrained merge: {len(missing)} missing, "
            f"{len(unexpected)} unexpected, {len(mismatched)} shape-mismatched"
        )


def train(config_path: str) -> None:
    """CLI-compatible entry: train(config_path)."""
    from yolo_ms_tpu_torch.utils.config import load_config

    Trainer(load_config(config_path)).fit()
