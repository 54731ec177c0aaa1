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
"""

from __future__ import annotations

import math

import torch

from portbench.reference.model import Detector, head_prior


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


def seeded_state_dict(cfg: dict, seed: int, device, dtype=torch.float32) -> dict:
    """The state_dict of ``cfg``'s architecture drawn from ``seed`` on
    ``device``; floating leaves in ``dtype``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    tpl = template(cfg)
    groups = {"kernel": [], "bn_scale": [], "bn_shift": [], "bn_mean": [], "bn_var": []}
    for name, (shape, _) in tpl.items():
        if name.endswith(".weight") and len(shape) == 4:
            groups["kernel"].append(name)
        elif name.endswith(".bn.weight"):
            groups["bn_scale"].append(name)
        elif name.endswith(".bn.bias"):
            groups["bn_shift"].append(name)
        elif name.endswith(".running_mean"):
            groups["bn_mean"].append(name)
        elif name.endswith(".running_var"):
            groups["bn_var"].append(name)
    sd = {}

    def draw(kind, fill):
        names = groups[kind]
        total = sum(math.prod(tpl[n][0]) for n in names)
        flat = torch.empty(total, device=device)
        fill(flat)
        for n, t in zip(names, _cut(flat, [tpl[n][0] for n in names])):
            sd[n] = t

    draw("kernel", lambda t: t.normal_(0.0, 1.0, generator=gen))
    for n in groups["kernel"]:
        shape = tpl[n][0]
        sd[n] = sd[n] * (shape[1] * shape[2] * shape[3]) ** -0.5
    draw("bn_scale", lambda t: t.uniform_(0.5, 1.5, generator=gen))
    draw("bn_shift", lambda t: t.normal_(0.0, 0.1, generator=gen))
    draw("bn_mean", lambda t: t.normal_(0.0, 0.1, generator=gen))
    draw("bn_var", lambda t: t.uniform_(0.5, 2.0, generator=gen))
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
