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


class MetricLogger:
    """One writer per run; the port trains in one process (multi-process
    training and its process-0-only writer come with the parallel slice)."""

    def __init__(self, log_dir: str):
        self._tb = None
        self._csv = None
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
