"""The port's learning recipe on the CPU: the full stack must overfit
synthetic data, as ``tests/test_learning.py`` asks of the JAX package (the
same recipe and the same bar). Slow (minutes on a CPU); ``chip_smoke.py``
runs the same recipe on the card (phase 6b) with a bar of 0.5.
"""

import os

import pytest

import tests.torch_policy  # noqa: F401 - the port's thread policy
from tests.make_fixtures import make_coco_dataset
from yolo_ms_tpu_torch.train.trainer import Trainer
from yolo_ms_tpu_torch.utils.config import Config


@pytest.mark.slow
def test_overfits_synthetic_rectangles(tmp_path):
    root = str(tmp_path)
    images_dir, ann = make_coco_dataset(
        root, num_images=32, num_classes=3, img_w=320, img_h=256, seed=1
    )
    cfg = Config.from_dict({
        "dataset": {
            "train_images_path": images_dir, "train_annotations_path": ann,
            "val_images_path": images_dir, "val_annotations_path": ann,
            "num_classes": 3, "max_gt": 8,
        },
        "model": {"architecture": "n", "input_size": [160, 160], "compute_dtype": "float32"},
        "training": {
            "batch_size": 16, "epochs": 60, "learning_rate": 2e-3, "optimizer": "adam",
            "weight_decay": 0.0, "val_interval": 60, "save_period": 1000,
            "experiment_name": "learn", "log_dir": os.path.join(root, "runs"),
            "augmentation": {"fliplr": 0.5}, "grad_clip_norm": 10.0,
            "scheduler": {"type": "cosine", "cosine_t_max": 60, "warmup_steps": 20},
        },
        "evaluation": {"batch_size": 16, "confidence_threshold": 0.25},
        "workers": 1,
        "device": "cpu",
    })
    trainer = Trainer(cfg, verbose=False)
    trainer.fit()
    final = trainer.validate()
    assert final > 0.15, f"model failed to learn: mAP@0.5 = {final}"
