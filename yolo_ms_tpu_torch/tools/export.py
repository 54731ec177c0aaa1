"""Deploy-checkpoint export CLI: ``python -m yolo_ms_tpu_torch.tools.export``.

The ``run`` of ``yolo_ms_tpu/tools/export.py``: a reference ``.pt``, a
flax-layout ``.npz``, a port train checkpoint (its EMA model, the one
``validate`` scored and ``best.ckpt`` was picked by) or a state_dict
becomes a serving artifact: BatchNorm folded into the conv weights and
biases (``models/deploy.py``), unless it is folded already, and optionally
every floating tensor cast to bfloat16 for a file of half the size. The
file is a state_dict written atomically by ``save_checkpoint``; the
``Predictor``, ``tools.test`` and ``tools.val`` serve it as it is.

``--program serve.pt2`` (with ``--arch``, ``--num_classes``, ``--batch``,
``--img_size`` and ``--device``) also exports the whole serving function of
that file at the JAX CLI's thresholds (conf 0.25, IoU 0.45), the
counterpart of the JAX package's ``--stablehlo``. ``export_program``, which
also takes other thresholds, traces ``infer/program.py:ServingProgram`` (uint8 ->
normalize -> BN-folded bf16 forward -> ``fused_postprocess``) with
``torch.export`` at a fixed [batch, H, W, 3] uint8 input and saves it with
its weights inside. ``infer.program.load_program`` serves the file with no
model code. The program is tied to the device it was exported on (its
weights and the devices in its graph), where JAX names ``--platforms``.
With ``entry_layouts="auto"`` (the default, as in ``Predictor``) it is
traced in the layout that ``infer/layouts.py:AutoLayoutInfer`` gives the
device: channels-last weights and entry on the card, contiguous NCHW on the
CPU. The saved file is read back once to check that it kept the
channels-last weights; if it did not, the export raises rather than write
an NCHW program.
It needs no TF32 switch: its convs run in bf16, the NMS product is exact
on 0/1 entries, and the gathers are ``torch.gather``.
"""

from __future__ import annotations

import argparse
import os

import torch

from yolo_ms_tpu_torch.infer.layouts import (
    AutoLayoutInfer,
    check_entry_layouts,
    memory_format_name,
    not_channels_last,
)
from yolo_ms_tpu_torch.infer.program import ServingProgram
from yolo_ms_tpu_torch.models.deploy import fold_batchnorm, is_deploy_variables
from yolo_ms_tpu_torch.models.registry import build_model
from yolo_ms_tpu_torch.utils.checkpoint import load_serving_state_dict, save_checkpoint
from yolo_ms_tpu_torch.utils.device import resolve_device


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


def export_program(
    state_dict: dict,
    arch: str,
    num_classes: int,
    output_path: str,
    batch: int = 1,
    img_size: tuple[int, int] = (640, 640),
    device=None,
    conf_thresh: float = 0.25,
    iou_thresh: float = 0.45,
    entry_layouts: str = "auto",
) -> dict:
    """Trace the serving function of a folded state_dict with
    ``torch.export`` and save the program, weights inside, to
    ``output_path``. Its calling convention: images_u8 [batch, H, W, 3]
    uint8 on the export device -> the ``fused_postprocess`` dict, as
    ``Predictor(dtype=torch.bfloat16, entry_layouts=entry_layouts).infer``
    returns it."""
    if not is_deploy_variables(state_dict):
        raise ValueError("export_program takes a folded state_dict: fold_batchnorm first")
    check_entry_layouts(entry_layouts)
    dev = resolve_device(device)
    model = build_model(
        arch, num_classes=num_classes, dtype=torch.bfloat16, device=dev, deploy=True
    )
    model.load_state_dict(state_dict, strict=True)
    serve = ServingProgram(
        model, num_classes, conf_thresh=conf_thresh, iou_thresh=iou_thresh
    )
    if entry_layouts == "auto":
        AutoLayoutInfer(serve)  # converts serve's weights and entry where it is on
    channels_last = serve.memory_format == torch.channels_last
    example = torch.zeros((batch, *img_size, 3), dtype=torch.uint8, device=dev)
    with torch.no_grad():
        program = torch.export.export(serve, (example,), strict=False)
    program.example_inputs = None  # the file holds weights and graph, not a batch
    tmp = f"{output_path}.{os.getpid()}.tmp"
    try:
        with open(tmp, "wb") as f:  # a file object: no warning on the suffix
            torch.export.save(program, f)
        if channels_last:
            lost = not_channels_last(torch.export.load(tmp).module())
            if lost:
                raise RuntimeError(
                    f"torch {torch.__version__}: the saved program lost the channels-last "
                    f"layout of {len(lost)} weights ({', '.join(lost[:4])}); export with "
                    "entry_layouts='default'"
                )
        os.replace(tmp, output_path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    info = {
        "output": output_path,
        "bytes": os.path.getsize(output_path),
        "device": dev.type,
        "input": f"uint8[{batch},{img_size[0]},{img_size[1]},3]",
        "memory_format": memory_format_name(serve.memory_format),
    }
    print(
        f"Exported serving program: {output_path} ({info['bytes'] / 1e6:.1f} MB, "
        f"device {info['device']}, input {info['input']}, {info['memory_format']})"
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
    p.add_argument(
        "--program",
        default=None,
        help="also export the whole serving function (weights inside) to this path",
    )
    p.add_argument("--arch", default="yolo-ms-xs", help="model for --program")
    p.add_argument("--num_classes", type=int, default=80)
    p.add_argument("--batch", type=int, default=1, help="--program batch size")
    p.add_argument(
        "--img_size", type=int, nargs=2, default=[640, 640], metavar=("H", "W")
    )
    p.add_argument(
        "--device", default=None, help="device the program runs on (default: the card)"
    )
    args = p.parse_args(argv)
    run(args.checkpoint, args.output, bf16=args.bf16)
    if args.program:
        export_program(
            load_serving_state_dict(args.output),
            args.arch,
            args.num_classes,
            args.program,
            batch=args.batch,
            img_size=tuple(args.img_size),
            device=args.device,
        )


if __name__ == "__main__":
    main()
