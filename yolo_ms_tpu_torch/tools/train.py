"""Training CLI: ``python -m yolo_ms_tpu_torch.tools.train --config cfg.yaml``.

The CLI of ``yolo_ms_tpu/tools/train.py``: ``--config`` points at a YAML file
with the reference schema; ``--resume`` restores a full training-state
checkpoint. Training runs on the card; a config with ``device: "cpu"`` runs
on the CPU.

Data parallel on N cards of one host (``training.batch_size`` is the global
batch, split evenly over the ranks)::

    torchrun --nproc_per_node=N -m yolo_ms_tpu_torch.tools.train --config cfg.yaml

One rank per card over NCCL (the CPU, ``device: "cpu"``, uses gloo).

Hybrid data x spatial: ``parallel: {spatial: S}`` in the config splits the
image height over S ranks and the batch over the N / S data rows (S must
divide N, the input height and every multiscale size). Ranks that share
one card need gloo, which this CLI does not pick: start them from code
with ``maybe_initialize_distributed("gloo")`` before the ``Trainer`` is
built.
"""

from __future__ import annotations

import argparse
import traceback


def main(argv: list[str] | None = None) -> None:
    parser = argparse.ArgumentParser(description="Train a YOLO detector on a CUDA card.")
    parser.add_argument(
        "--config",
        type=str,
        default="yolo_ms_tpu_torch/configs/coco_yolov8.yaml",
        help="Path to the YAML configuration file.",
    )
    parser.add_argument(
        "--resume", type=str, default=None, help="Path to a .ckpt to resume from."
    )
    args = parser.parse_args(argv)

    from yolo_ms_tpu_torch.parallel.distributed import (
        leave_group,
        maybe_initialize_distributed,
        process_info,
    )
    from yolo_ms_tpu_torch.train.trainer import Trainer
    from yolo_ms_tpu_torch.utils.config import load_config
    from yolo_ms_tpu_torch.utils.device import config_device

    try:
        cfg = load_config(args.config)
        # several processes (torchrun): join the group before anything touches
        # a device; the config is read first only to learn that device
        if maybe_initialize_distributed(device=config_device(cfg) or "cuda"):
            print(f"torch.distributed initialized: {process_info()}")
        trainer = Trainer(cfg)
        if args.resume:
            trainer.resume(args.resume)
        trainer.fit()
        leave_group()
    except FileNotFoundError as e:
        print(f"Error: {e}. Check the config path and dataset paths inside it.")
        raise SystemExit(1)
    except Exception:
        traceback.print_exc()
        raise SystemExit(1)


if __name__ == "__main__":
    main()
