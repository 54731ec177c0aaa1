"""Optimizer and LR schedules with the exact semantics of the JAX package's
optax chain (``yolo_ms_tpu/train/optim.py``).

The chain, in order: ``clip_by_global_norm`` -> ``add_decayed_weights`` (L2
on every trainable leaf, BN scale/bias and conv biases included) ->
``scale_by_adam`` or ``trace(nesterov)`` -> ``-lr``, with

- clipping by ``max_norm / norm`` only when ``norm >= max_norm`` (optax's
  rule; ``torch.nn.utils.clip_grad_norm_`` divides by ``norm + 1e-6``);
- the LR of update *n* is ``sched(n)``, counted from 0; a warmup joins a
  linear ramp from 0 to the schedule (so the first update uses lr 0);
- frozen leaves (``freeze_layers`` patterns against the flax parameter
  paths) take no part in the norm and get no decay, moments or update;
- gradient accumulation as ``optax.MultiSteps``: a running mean of k
  gradients is applied once per k calls, the other calls return zero
  updates, and the schedule advances once per applied update.

Everything works on ONE flat f32 vector per quantity (the parameters, their
gradients, each moment): a handful of kernels per step whatever the number
of parameter tensors, and every count lives on the device, so an update
needs no host sync. ``update`` is functional: it returns the updates and the
new state and writes nothing, so a caller can commit both only when they are
finite (the trainer's NaN guard).
"""

from __future__ import annotations

import math
from typing import Callable

import torch

from yolo_ms_tpu_torch.utils.config import TrainingConfig

Schedule = Callable[[torch.Tensor], torch.Tensor]


def _f32(x, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device=like.device)


def build_schedule(cfg: TrainingConfig, steps_per_epoch: int) -> Schedule:
    """``sched(count)`` -> f32 LR tensor, for an int count tensor on any
    device; the optax schedules' formulas, evaluated in f32 as they are."""
    base_lr = float(cfg.learning_rate)
    s = cfg.scheduler
    kind = (s.type or "none").lower()
    if kind == "cosine":
        t_max_epochs = s.cosine_t_max or cfg.epochs
        decay_steps = float(max(1, t_max_epochs * steps_per_epoch))
        alpha = s.cosine_eta_min / base_lr if base_lr > 0 else 0.0

        def sched(count):
            c = torch.minimum(count.float(), _f32(decay_steps, count))
            cosine = 0.5 * (1 + torch.cos(math.pi * c / decay_steps))
            return base_lr * ((1 - alpha) * cosine + alpha)

    elif kind == "step":
        n_drops = max(1, cfg.epochs // max(1, s.step_lr_size))
        boundaries = [
            (i * s.step_lr_size * steps_per_epoch, s.step_lr_gamma)
            for i in range(1, n_drops + 1)
        ]

        def sched(count):
            v = _f32(base_lr, count)
            for threshold, scale in boundaries:
                indicator = torch.clamp(torch.sign(threshold - count.float()), min=0.0)
                v = v * indicator + (1 - indicator) * scale * v
            return v

    elif kind == "none":

        def sched(count):
            return _f32(base_lr, count)

    else:
        raise ValueError(f"Unsupported scheduler: {s.type}")

    warmup = int(s.warmup_steps)
    if warmup > 0:
        main = sched

        def sched(count):
            c = torch.clamp(count.float(), 0, warmup)
            ramp = (0.0 - base_lr) * (1 - c / warmup) + base_lr
            return torch.where(count < warmup, ramp, main(count - warmup))

    return sched


def freeze_mask(paths: list[str], patterns: list[str]) -> list[bool]:
    """True = trainable, per flax parameter path ("backbone/conv0/conv/kernel").
    Substring match; dots in patterns read as '/', so reference finetune
    configs ("backbone.conv1") freeze what they say."""
    norm = [p.replace(".", "/") for p in patterns]
    return [not any(p in path for p in norm) for path in paths]


class OptaxChain:
    """The optax chain of ``build_optimizer`` on flat f32 vectors.

    ``trainable`` is a bool vector over the flat parameters (None: all
    trainable). State: the update counts (int32 device scalars), the
    moments, and under accumulation the running-mean gradient.
    """

    def __init__(self, cfg: TrainingConfig, sched: Schedule,
                 trainable: torch.Tensor | None = None):
        self.name = cfg.optimizer.lower()
        if self.name not in ("adam", "sgd"):
            raise ValueError(f"Unsupported optimizer: {cfg.optimizer}")
        self.sched = sched
        self.clip = float(cfg.grad_clip_norm or 0.0)
        self.wd = float(cfg.weight_decay or 0.0)
        self.b1, self.b2 = (float(b) for b in cfg.adam_betas)
        self.momentum = float(cfg.sgd_momentum)
        self.nesterov = bool(cfg.sgd_nesterov)
        self.accum = max(1, int(getattr(cfg, "grad_accum_steps", 1) or 1))
        self.trainable = trainable

    def init(self, params: torch.Tensor) -> dict[str, torch.Tensor]:
        def zeros():
            return torch.zeros_like(params)

        def count():
            return torch.zeros((), dtype=torch.int32, device=params.device)

        state = {"count": count()}  # applied updates: the schedule's count
        if self.name == "adam":
            state.update(adam_count=count(), mu=zeros(), nu=zeros())
        elif self.momentum > 0:
            state["trace"] = zeros()
        if self.accum > 1:
            state.update(mini_step=count(), acc=zeros())
        return state

    def _inner(self, grads, state, params):
        """clip -> decay -> adam | trace -> -lr; returns (updates, new state)."""
        new = {}
        g = grads
        if self.trainable is not None:
            g = torch.where(self.trainable, g, 0.0)
        if self.clip > 0:
            norm = torch.sqrt(torch.sum(g * g))
            g = torch.where(norm < self.clip, g, (g / norm) * self.clip)
        if self.wd > 0:
            p = params if self.trainable is None else torch.where(self.trainable, params, 0.0)
            g = g + self.wd * p
        if self.name == "adam":
            mu = (1 - self.b1) * g + self.b1 * state["mu"]
            nu = (1 - self.b2) * (g * g) + self.b2 * state["nu"]
            n = state["adam_count"] + 1
            mu_hat = mu / (1 - self.b1 ** n.float())
            nu_hat = nu / (1 - self.b2 ** n.float())
            g = mu_hat / (torch.sqrt(nu_hat) + 1e-8)
            new.update(adam_count=n, mu=mu, nu=nu)
        elif self.momentum > 0:
            f = g + self.momentum * state["trace"]
            g = g + self.momentum * f if self.nesterov else f
            new["trace"] = f
        lr = self.sched(state["count"])
        new["count"] = state["count"] + 1
        return g * (-lr), new

    def update(self, grads: torch.Tensor, state: dict, params: torch.Tensor):
        """(updates, new_state); nothing is written in place."""
        if self.accum == 1:
            return self._inner(grads, state, params)
        mini = state["mini_step"]
        acc = state["acc"] + (grads - state["acc"]) / (mini + 1).float()
        inner, new_inner = self._inner(acc, state, params)
        emit = mini == self.accum - 1
        emit_f = emit.float()
        new = {k: torch.where(emit, v, state[k]) for k, v in new_inner.items()}
        new["mini_step"] = (mini + 1) % self.accum
        new["acc"] = (1 - emit_f) * acc
        return emit_f * inner, new


def build_optimizer(cfg: TrainingConfig, steps_per_epoch: int,
                    trainable: torch.Tensor | None = None):
    """Returns (optimizer, lr_schedule_fn), as the JAX factory."""
    sched = build_schedule(cfg, steps_per_epoch)
    return OptaxChain(cfg, sched, trainable), sched
