"""The upper readings of the numbers that decide ``correct``: the control and
the faults, at a cell's own size, on the card.

    python3 -m portbench.calibrate --workload <cell> --seeds 11,12,13 [--program SECONDS]

from the root of a checkout; the benchmark's own runs never run it. For
each seed it prints one JSON line per reading, with the numbers under the
names the cell's limits use:

- with ``--program``: ``program``, the cell's own driver run in this
  process with a window of SECONDS (the lower readings, many seeds in one
  process);
- serving cells: ``control``, the float32 reference put in the program's
  place and computed in fp8 (``reference/model.py``), serving the same
  batches, judged like the program on as many images as a run judges;
- the training cell: ``control`` (the fp8 reference's three steps in the
  program's place) and ``half`` (the reference on the first half of each
  batch, the mean taken over it: half of the batch left out). A step that
  returns the state unchanged reads 1 in ``change_gap`` and ``ema_gap``
  without a run.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch

from portbench import yardstick
from portbench.drivers.train import compare, pool_batches
from portbench.reference import detect
from portbench.reference.model import Detector, ieee_f32, set_precision
from portbench.reference.train import TrainReference
from portbench.weights import seeded_state_dict

HERE = os.path.dirname(os.path.abspath(__file__))


def serve_readings(cfg: dict, traffic: dict, seed: int, dev) -> dict:
    sv, hw = cfg["serve"], tuple(cfg["image_size"])
    state_dict = seeded_state_dict(cfg, seed, dev, getattr(torch, cfg["dtype"]))
    rng = np.random.default_rng(seed)
    pool = [yardstick.serving_batch(rng, traffic["batch"], hw) for _ in range(traffic["pool"])]
    f32 = {k: v.float() if v.is_floating_point() else v for k, v in state_dict.items()}
    ref, ctl = Detector(cfg).to(dev).eval(), Detector(cfg).to(dev).eval()
    ref.load_state_dict(f32)
    ctl.load_state_dict(f32)
    set_precision(ctl, "fp8")
    worst = {}
    with ieee_f32():
        for j in range(traffic["sample"]):
            x = torch.from_numpy(pool[j % len(pool)]).to(dev)
            boxes, logits = detect.dense(ref, x)
            served = detect.serve(*detect.dense(ctl, x), sv["conf_thresh"], sv["iou_thresh"],
                                  sv["pre_nms_topk"], sv["max_det"])
            got = detect.judge(served, boxes, logits, sv["conf_thresh"], sv["iou_thresh"],
                               sv["pre_nms_topk"], sv["max_det"])
            worst = {k: max(worst.get(k, 0.0), v) for k, v in got.items()}
    return {"control": worst}


def train_readings(cfg: dict, traffic: dict, seed: int, dev) -> dict:
    state_dict = seeded_state_dict(cfg, seed, dev)
    pool = pool_batches(np.random.default_rng(seed), traffic, cfg, dev)
    start = traffic["start_update"]
    out = {}
    with ieee_f32():
        ref = TrainReference(cfg, state_dict, dev, start_update=start)
        for i in range(3):
            ref.step(pool[i])
        want, moving = ref.record(), ref.moving()
        for name, precision, rows in (("control", "fp8", None), ("half", "f32", 0.5)):
            other = TrainReference(cfg, state_dict, dev, precision, start_update=start)
            for i in range(3):
                batch = pool[i]
                if rows:
                    n = int(batch["images"].shape[0] * rows)
                    batch = {k: v[:n] for k, v in batch.items()}
                other.step(batch)
            out[name] = compare(other.record(), want, moving, cfg["num_classes"])
            del other
    return out


def program_readings(workload: str, seed: int, seconds: int) -> dict:
    from portbench import run

    cell, _, _ = run.load_cell(workload, seed, seconds, False)
    out = run.load_module("drivers", cell.traffic["driver"]).run(
        cell, torch.cuda.get_device_name(0))
    return {"program": out["checks"]}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--program", type=int, default=0,
                    help="read the program's numbers with a window of this many seconds")
    args = ap.parse_args(argv)
    with open(os.path.join(os.path.dirname(HERE), "BENCHMARK.json")) as f:
        entry = {w["name"]: w for w in json.load(f)["workloads"]}[args.workload]
    with open(os.path.join(HERE, "configs", f"{entry['config']}.json")) as f:
        cfg = json.load(f)
    with open(os.path.join(HERE, "traffic", f"{entry['traffic']}.json")) as f:
        traffic = json.load(f)
    dev = torch.device("cuda")
    readings = train_readings if traffic["driver"] == "train" else serve_readings
    for seed in (int(s) for s in args.seeds.split(",")):
        got = (program_readings(args.workload, seed, args.program) if args.program
               else readings(cfg, traffic, seed, dev))
        for name, numbers in got.items():
            print(json.dumps({"workload": args.workload, "seed": seed, "reading": name,
                              **numbers}), flush=True)


if __name__ == "__main__":
    main()
