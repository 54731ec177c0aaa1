"""Metric logging: TensorBoard scalars with the reference's names.

The reference logs via torch.utils.tensorboard (train.py:202-205, :348,
:385-390, :396, :407). Same scalar names here so dashboards transfer:
Training/Learning_Rate, Loss/Batch/{Total,Box,Cls,DFL}, Loss/Epoch/Total,
Validation/mAP_50. Falls back to a CSV writer if tensorboard is unavailable.
A copy of ``yolo_ms_tpu/utils/logging.py``.
"""

from __future__ import annotations

import csv
import os

from yolo_ms_tpu_torch.parallel.distributed import is_primary_process


class MetricLogger:
    """One writer per run: under data parallelism only the primary writes
    events (a shared log directory would get interleaved files from every
    rank); the others log nothing."""

    def __init__(self, log_dir: str):
        self._tb = None
        self._csv = None
        if not is_primary_process():
            return
        os.makedirs(log_dir, exist_ok=True)
        try:
            from torch.utils.tensorboard import SummaryWriter

            self._tb = SummaryWriter(log_dir=log_dir)
        except ImportError:
            path = os.path.join(log_dir, "metrics.csv")
            self._csv_file = open(path, "a", newline="")
            self._csv = csv.writer(self._csv_file)

    def scalar(self, tag: str, value: float, step: int):
        if self._tb is not None:
            self._tb.add_scalar(tag, float(value), step)
        elif self._csv is not None:
            self._csv.writerow([step, tag, float(value)])
            self._csv_file.flush()

    def close(self):
        if self._tb is not None:
            self._tb.close()
        if self._csv is not None:
            self._csv_file.close()
