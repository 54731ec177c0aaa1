"""The port's config module and YAMLs against the JAX package's.

``yolo_ms_tpu_torch/utils/config.py`` is a copy; its three YAMLs differ from
the JAX package's only in ``device``. Checked exactly: equal dicts.
"""

import json
import os
import sys

import pytest

import tests.torch_policy  # noqa: F401 - the port's thread policy
from yolo_ms_tpu.utils import config as jcfg
from yolo_ms_tpu_torch.utils import config as tcfg

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
YAMLS = ("coco_yolo_ms.yaml", "coco_yolov8.yaml", "finetune_example.yaml")


@pytest.mark.parametrize("name", YAMLS)
def test_yamls_equal_apart_from_device(name):
    jax_d = jcfg.load_config(os.path.join(ROOT, "yolo_ms_tpu", "configs", name)).to_dict()
    port_d = tcfg.load_config(os.path.join(ROOT, "yolo_ms_tpu_torch", "configs", name)).to_dict()
    assert jax_d.pop("device") == "tpu"
    assert port_d.pop("device") == "cuda"
    assert port_d == jax_d


def test_from_dict_equal_on_a_full_dict():
    d = {
        "dataset": {"num_classes": 3, "max_gt": 8, "gt_buckets": [4], "unknown_key": 1},
        "model": {"architecture": "yolo-ms-xs", "input_size": [160, 160],
                  "compute_dtype": "bfloat16"},
        "training": {
            "batch_size": 4, "optimizer": "sgd", "ema_decay": 0.9999,
            "grad_accum_steps": 2, "multiscale_sizes": [96, 128],
            "scheduler": {"type": "step", "warmup_steps": 3},
            "augmentation": {"mosaic": 1.0, "mixup": 0.1},
        },
        "evaluation": {"map_iou_thresholds": "coco"},
        "device": "cpu",
        "workers": 2,
        "top_level_extra": {"a": 1},
    }
    a, b = jcfg.Config.from_dict(d), tcfg.Config.from_dict(d)
    assert a.to_dict() == b.to_dict()
    assert a.extra == b.extra == {"top_level_extra": {"a": 1}}
    assert a.dataset.extra == b.dataset.extra == {"unknown_key": 1}


def test_defaults_differ_only_in_device():
    a, b = jcfg.Config().to_dict(), tcfg.Config().to_dict()
    assert (a.pop("device"), b.pop("device")) == ("tpu", "cuda")
    assert a == b


def test_works_without_pyyaml(monkeypatch, tmp_path):
    """``from_dict`` needs no PyYAML; ``save`` then writes JSON and
    ``load_config`` reads it back, still without PyYAML."""
    monkeypatch.setitem(sys.modules, "yaml", None)  # import yaml -> ImportError
    cfg = tcfg.Config.from_dict({"model": {"architecture": "n"}, "device": "cpu"})
    path = tmp_path / "cfg.yaml"
    cfg.save(str(path))
    with open(path) as f:
        assert json.load(f) == cfg.to_dict()
    assert tcfg.load_config(str(path)).to_dict() == cfg.to_dict()


def test_save_load_roundtrip_matches_jax(tmp_path):
    cfg = tcfg.load_config(os.path.join(ROOT, "yolo_ms_tpu_torch", "configs", "coco_yolo_ms.yaml"))
    path = str(tmp_path / "c.yaml")
    cfg.save(path)
    assert tcfg.load_config(path).to_dict() == cfg.to_dict()
    assert jcfg.load_config(path).to_dict() == cfg.to_dict()
