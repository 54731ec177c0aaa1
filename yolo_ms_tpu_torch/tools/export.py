"""Deploy-checkpoint export CLI: ``python -m yolo_ms_tpu_torch.tools.export``.

The ``run`` of ``yolo_ms_tpu/tools/export.py``: a reference ``.pt``, a
flax-layout ``.npz``, a port train checkpoint (its EMA model, the one
``validate`` scored and ``best.ckpt`` was picked by) or a state_dict
becomes a serving artifact: BatchNorm folded into the conv weights and
biases (``models/deploy.py``), unless it is folded already, and optionally
every floating tensor cast to bfloat16 for a file of half the size. The
file is a state_dict written atomically by ``save_checkpoint``; the
``Predictor``, ``tools.test`` and ``tools.val`` serve it as it is.

The JAX package's ``--stablehlo`` (the whole serving function serialized
with its weights) is not offered: its counterpart, a ``torch.export``
program, needs the ``select`` kernel registered as a ``torch.library``
custom op first.
"""

from __future__ import annotations

import argparse

import torch

from yolo_ms_tpu_torch.models.deploy import fold_batchnorm, is_deploy_variables
from yolo_ms_tpu_torch.utils.checkpoint import load_serving_state_dict, save_checkpoint


def run(checkpoint_path: str, output_path: str, bf16: bool = False) -> dict:
    state_dict = load_serving_state_dict(checkpoint_path)
    folded = dict(state_dict) if is_deploy_variables(state_dict) else fold_batchnorm(state_dict)
    if bf16:
        folded = {
            k: v.to(torch.bfloat16) if v.is_floating_point() else v for k, v in folded.items()
        }
    n_params = sum(v.numel() for v in folded.values())
    nbytes = sum(v.numel() * v.element_size() for v in folded.values())
    save_checkpoint(output_path, folded)
    info = {
        "output": output_path,
        "params": int(n_params),
        "bytes": int(nbytes),
        "dtype": "bfloat16" if bf16 else "float32",
    }
    print(
        f"Exported deploy checkpoint: {output_path} "
        f"({n_params / 1e6:.2f}M params, {nbytes / 1e6:.1f} MB, "
        f"{'bf16' if bf16 else 'f32'})"
    )
    return info


def main(argv: list[str] | None = None) -> None:
    p = argparse.ArgumentParser(description="Export a BN-folded deploy checkpoint")
    p.add_argument("--checkpoint", required=True,
                   help="train checkpoint (.ckpt), state_dict, .npz or reference .pt")
    p.add_argument("--output", required=True, help="output .ckpt path")
    p.add_argument(
        "--bf16", action="store_true", help="store weights in bfloat16 (half size)"
    )
    args = p.parse_args(argv)
    run(args.checkpoint, args.output, bf16=args.bf16)


if __name__ == "__main__":
    main()
