"""The plain reference against ``yolo_ms_tpu_torch`` on the CPU at small sizes,
and the control and the faults that the comparison has to catch.

The program runs in float32 here, so that it and the reference compute the
same sums: the forward agrees exactly, the served detections read no gap,
and one train step agrees to float32 rounding. The control (the reference
in fp8) and the faults then read past the cells' limits.
"""

from __future__ import annotations

import json
import os

import numpy as np
import pytest
import torch

from portbench import calibrate, run
from portbench.drivers.train import build, compare, leaves, pool_batches
from portbench.reference import detect
from portbench.reference.model import Detector
from portbench.reference.train import LOSS_TERMS, TrainReference
from portbench.weights import seeded_state_dict

SIZES = {"yolov8-n": (160, 8), "yolo-ms-xs": (128, 4)}
SEED = 2**31 + 11  # past 32 signed bits, as the checks' seeds are


def small(config: str, dtype: str = "float32") -> dict:
    cfg = run.load_json("configs", f"{config}.json")
    img, nc = SIZES[config]
    cfg.update(image_size=[img, img], num_classes=nc, dtype=dtype)
    return cfg


def limits(cell: str) -> dict:
    return run.load_json("workloads", f"{cell}.json")["limits"]


@pytest.fixture(autouse=True)
def _threads():
    before = torch.get_num_threads()
    torch.set_num_threads(4)
    yield
    torch.set_num_threads(before)


@pytest.mark.parametrize("config", sorted(SIZES))
def test_reference_forward_is_the_programs(config):
    from yolo_ms_tpu_torch.models.registry import build_model

    cfg = small(config)
    sd = seeded_state_dict(cfg, SEED, "cpu")
    ref = Detector(cfg).eval()
    ref.load_state_dict(sd)
    port = build_model(config, num_classes=cfg["num_classes"], device="cpu")
    port.load_state_dict(sd)
    x = torch.randn(2, 3, *cfg["image_size"], generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        for (rb, rc), (pb, pc) in zip(ref(x), port.eval()(x, split_head=True)):
            torch.testing.assert_close(rb, pb, rtol=1e-5, atol=1e-5)
            torch.testing.assert_close(rc, pc, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("config", sorted(SIZES))
def test_served_detections_read_no_gap_in_float32(config):
    from yolo_ms_tpu_torch.infer.predictor import Predictor

    cfg = small(config)
    sv, hw = cfg["serve"], tuple(cfg["image_size"])
    sd = seeded_state_dict(cfg, SEED, "cpu")
    pred = Predictor(config, sd, cfg["num_classes"], input_size=hw,
                     conf_thresh=sv["conf_thresh"], iou_thresh=sv["iou_thresh"],
                     max_det=sv["max_det"], batch_size=2, pre_nms_topk=sv["pre_nms_topk"],
                     device="cpu")
    x = np.random.default_rng(SEED).integers(0, 256, (2, *hw, 3), dtype=np.uint8)
    ref = Detector(cfg).eval()
    ref.load_state_dict(sd)
    boxes, logits = detect.dense(ref, torch.from_numpy(x))
    got = detect.judge(pred.predict_batch(x), boxes, logits, sv["conf_thresh"],
                       sv["iou_thresh"], sv["pre_nms_topk"], sv["max_det"])
    assert got["logit_err"] < 1e-2 and got["box_err"] < 1e-3
    own = detect.serve(boxes, logits, sv["conf_thresh"], sv["iou_thresh"],
                       sv["pre_nms_topk"], sv["max_det"])
    assert detect.judge(own, boxes, logits, sv["conf_thresh"], sv["iou_thresh"],
                        sv["pre_nms_topk"], sv["max_det"]) == pytest.approx(
        {"logit_err": 0.0, "box_err": 0.0, "logit_err.fidelity": 0.0, "logit_err.order": 0.0},
        abs=1e-6)


def test_one_train_step_is_the_programs():
    cfg = small("yolo-ms-xs")
    traffic = {"batch": 2, "buckets": [8, 8, 16, 16], "gt_mean": 6, "gt_dispersion": 2.0}
    sd = seeded_state_dict(cfg, SEED, "cpu")
    state, step = build(cfg, sd, torch.device("cpu"))
    state.opt_state["count"].fill_(3000)
    state.step.fill_(3000)
    named = [(n, p.numel()) for n, p in state.model.named_parameters()]
    batch = pool_batches(np.random.default_rng(SEED), traffic, cfg, "cpu")[0]
    start = state.params.clone()
    maps = []
    state.model.register_forward_hook(lambda m, a, out: maps.extend(x.detach() for x in out))
    metrics = step(state, batch)
    ref = TrainReference(cfg, sd, "cpu", start_update=3000)
    ref.step(batch)
    got = {"losses": [{k: float(metrics[k]) for k in (*LOSS_TERMS, "num_fg")}], "maps": maps,
           "first_grad": leaves(state.opt_state["trace"], named),
           "change": leaves(state.params - start, named),
           "ema_change": leaves(state.ema_params - start, named)}
    gaps = compare(got, ref.record(), ref.moving(), cfg["num_classes"])
    assert gaps["map_err"] < 1e-3
    assert gaps["loss_gap"] < 1e-5 and gaps["fg_gap"] == 0.0
    assert gaps["grad_gap"] < 1e-3
    # a change of ~1e-5 on weights of ~0.1 keeps 2-3 digits of float32; the
    # EMA's is a quarter of it
    assert gaps["change_gap"] < 1e-2 and gaps["ema_gap"] < 5e-2


@pytest.mark.parametrize("cell,config", [("xs-serve-b32", "yolo-ms-xs"),
                                         ("v8n-serve-b32", "yolov8-n")])
def test_the_fp8_control_fails_the_serving_limits(cell, config):
    cfg = small(config)
    traffic = dict(run.load_json("traffic", f"{run_traffic(cell)}.json"), batch=2, pool=2,
                   sample=2)
    got = calibrate.serve_readings(cfg, traffic, SEED, torch.device("cpu"))["control"]
    assert any(got[k] > lim for k, lim in limits(cell).items()), got


def test_the_fp8_control_and_half_batch_fail_the_train_limits():
    cfg = small("yolo-ms-xs")
    traffic = dict(run.load_json("traffic", "train-b32.json"), batch=4, buckets=[8, 8, 16])
    got = calibrate.train_readings(cfg, traffic, SEED, torch.device("cpu"))
    lim = limits("xs-train-b32")
    for name in ("control", "half"):
        assert any(got[name][k] > v for k, v in lim.items()), (name, got[name])


def run_traffic(cell: str) -> str:
    with open(os.path.join(run.ROOT, "BENCHMARK.json")) as f:
        return {w["name"]: w for w in json.load(f)["workloads"]}[cell]["traffic"]
