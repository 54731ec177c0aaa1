"""Seeded weights: one state_dict drawn on the device from ``--seed``.

The same state_dict goes to the program and to the reference. Every kind of
leaf is drawn in one call over all leaves of that kind, on the device, and
then cut into the leaves:

- conv kernels: normal, std 1/sqrt(fan_in) (fan_in = in channels per group
  x kernel area), so that activations keep their scale through the depth;
- BatchNorm: scale U(0.5, 1.5), shift N(0, 0.1), running mean N(0, 0.1), running variance U(0.5, 2), so that
  folding them into the convs is a real change of every weight;
- the head's ``pred`` biases: box logits 1.0, class logits at their prior
  (about 5 objects per image over a level's cells);
- ``num_batches_tracked``: 0.

A family's reference file may declare further kinds in ``LEAVES`` (see
``portbench/reference/model.py``); each is drawn in one call over its leaves,
in the template's order, after the shared kinds, so that what a family
declares never moves the bits of the shared kinds. A leaf that no rule
covers raises ``KeyError``.
"""

from __future__ import annotations

import math

import torch

from portbench.reference.model import Detector, family, head_prior


def template(cfg: dict) -> dict:
    """name -> (shape, dtype) of the architecture's state_dict."""
    with torch.device("meta"):
        sd = Detector(cfg).state_dict()
    return {k: (tuple(v.shape), v.dtype) for k, v in sd.items()}


def _cut(flat: torch.Tensor, shapes: list) -> list:
    out, offset = [], 0
    for shape in shapes:
        n = math.prod(shape)
        out.append(flat[offset : offset + n].view(shape))
        offset += n
    return out


def _is_kernel(name: str, shape: tuple) -> bool:
    return name.endswith(".weight") and len(shape) == 4


# the shared kinds of leaf, in the order they are drawn: (name suffix or
# predicate (name, shape) -> bool, fill(flat, generator)); a leaf takes the
# first kind that matches it, these before a family's ``LEAVES``
SHARED = (
    (_is_kernel, lambda t, gen: t.normal_(0.0, 1.0, generator=gen)),
    (".bn.weight", lambda t, gen: t.uniform_(0.5, 1.5, generator=gen)),
    (".bn.bias", lambda t, gen: t.normal_(0.0, 0.1, generator=gen)),
    (".running_mean", lambda t, gen: t.normal_(0.0, 0.1, generator=gen)),
    (".running_var", lambda t, gen: t.uniform_(0.5, 2.0, generator=gen)),
)


def _matches(match, name: str, shape: tuple) -> bool:
    return name.endswith(match) if isinstance(match, str) else match(name, shape)


def seeded_state_dict(cfg: dict, seed: int, device, dtype=torch.float32) -> dict:
    """The state_dict of ``cfg``'s architecture drawn from ``seed`` on
    ``device``; floating leaves in ``dtype``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    tpl = template(cfg)
    kinds = SHARED + tuple(getattr(family(cfg["family"]), "LEAVES", ()))
    groups = [[] for _ in kinds]
    for name, (shape, _) in tpl.items():
        if name.endswith("num_batches_tracked") or name.endswith(".pred.bias"):
            continue
        hit = next((i for i, (match, _) in enumerate(kinds) if _matches(match, name, shape)),
                   None)
        if hit is not None:
            groups[hit].append(name)
    sd = {}
    for names, (_, fill) in zip(groups, kinds):
        if not names:
            continue
        flat = torch.empty(sum(math.prod(tpl[n][0]) for n in names), device=device)
        fill(flat, gen)
        for n, t in zip(names, _cut(flat, [tpl[n][0] for n in names])):
            sd[n] = t
    for n in groups[0]:
        shape = tpl[n][0]
        sd[n] = sd[n] * (shape[1] * shape[2] * shape[3]) ** -0.5
    for name, (shape, dt) in tpl.items():
        if name in sd:
            continue
        if name.endswith("num_batches_tracked"):
            sd[name] = torch.zeros(shape, dtype=dt, device=device)
        elif name.endswith(".pred.bias"):
            level = int(name.split(".")[1].split("_")[1])
            value = 1.0 if ".box_" in name else head_prior(cfg, level)
            sd[name] = torch.full(shape, value, device=device)
        else:
            raise KeyError(f"no rule draws {name}")
    return {k: v.to(dtype) if v.is_floating_point() else v for k, v in sd.items()}
