"""Training CLI: ``python -m yolo_ms_tpu_torch.tools.train --config cfg.yaml``.

The CLI of ``yolo_ms_tpu/tools/train.py``: ``--config`` points at a YAML file
with the reference schema; ``--resume`` restores a full training-state
checkpoint. Training runs on the card; a config with ``device: "cpu"`` runs
on the CPU.
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

    from yolo_ms_tpu_torch.train.trainer import Trainer
    from yolo_ms_tpu_torch.utils.config import load_config

    try:
        cfg = load_config(args.config)
        trainer = Trainer(cfg)
        if args.resume:
            trainer.resume(args.resume)
        trainer.fit()
    except FileNotFoundError as e:
        print(f"Error: {e}. Check the config path and dataset paths inside it.")
        raise SystemExit(1)
    except Exception:
        traceback.print_exc()
        raise SystemExit(1)


if __name__ == "__main__":
    main()
