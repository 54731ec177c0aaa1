"""Run one benchmark cell of ``yolo_ms_tpu_torch`` once, on this machine's card.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The cell's entry in ``BENCHMARK.json`` names
its configuration (``portbench/configs/<config>.json``) and its traffic
(``portbench/traffic/<traffic>.json``, which names the driver,
``portbench/drivers/<driver>.py``); ``portbench/workloads/<cell>.json`` holds
the limits of the numbers that decide ``correct``. ``BENCHMARK.json`` also
says which metrics the cell reports: with ``--trace 0`` its end-to-end
metrics, with ``--trace 1`` its per-layer metrics, each read by
``portbench/metrics/<metric>.py`` from the traced stretch. The configuration's
``family`` names its float32 reference, ``portbench/reference/arch/<family>.py``.
Adding a cell, a traffic mix, a metric or a configuration of a new family adds
files and entries; no file here changes.

The last line of standard output is the result, one JSON object; facts of
the card and the run go to standard error before it, and the numbers
compared, each beside its limit, are the last lines of standard error.
Without a CUDA card (or with fewer cards than the cell asks for) it prints
no result and exits with 3; it exits with 4 if JAX or the JAX package was
loaded.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()  # set-up is counted from the start of the process

import argparse  # noqa: E402
import dataclasses  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
# top-level module names that no run may load, compared whole
FORBIDDEN = ("jax", "jaxlib", "flax", "yolo_ms_tpu")
CACHE = os.path.join(ROOT, ".portbench_cache")
DEVICE = "cuda"  # the CPU rehearsal in tests/ sets "cpu"


def say(*parts) -> None:
    print(*parts, file=sys.stderr, flush=True)


def load_json(*parts) -> dict:
    with open(os.path.join(HERE, *parts)) as f:
        return json.load(f)


def load_module(kind: str, name: str):
    """``portbench/<kind>/<name>.py`` as a module (names may hold dots)."""
    path = os.path.join(HERE, kind, f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"portbench_{kind}_{name.replace('.', '_')}",
                                                  path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


@dataclasses.dataclass
class Cell:
    """Everything a driver gets: the cell as the files give it, and the
    run's arguments."""

    name: str
    chips: int
    cfg: dict
    traffic: dict
    limits: dict
    seed: int
    seconds: int
    trace: bool
    device: str = DEVICE
    say: object = say


def resolve(bench: dict, workload: str) -> tuple[dict, list, list]:
    """The cell's entry and its end-to-end and per-layer metric entries."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; BENCHMARK.json has {sorted(cells)}")
    e2e = [m for m in bench["end_to_end"] if workload in m.get("workloads", [workload])]
    reported = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if (workload in m["workloads"] if "workloads" in m else m["moves"] in reported)]
    return cells[workload], e2e, per_layer


def load_cell(workload: str, seed: int, seconds: int, trace: bool):
    """(the cell, its end-to-end metric entries, its per-layer metric
    entries) as ``BENCHMARK.json`` and the cell's files give them."""
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    entry, e2e, per_layer = resolve(bench, workload)
    cell = Cell(name=workload, chips=int(entry["chips"]),
                cfg=load_json("configs", f"{entry['config']}.json"),
                traffic=load_json("traffic", f"{entry['traffic']}.json"),
                limits=load_json("workloads", f"{workload}.json")["limits"],
                seed=seed, seconds=seconds, trace=trace, device=DEVICE)
    return cell, e2e, per_layer


def card_facts(torch) -> str:
    """Log the software and the card; return the card's name."""
    name = torch.cuda.get_device_name(0)
    say(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")
    say(f"card {name} x{torch.cuda.device_count()}")
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,clocks.max.sm,clocks.mem,"
             "temperature.gpu", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=20)
        say(f"nvidia-smi name, power.limit, clocks.sm, clocks.max.sm, clocks.mem, temp: "
            f"{smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else smi.stderr.strip()}")
    except (OSError, subprocess.TimeoutExpired) as e:
        say(f"nvidia-smi not read: {e}")
    return name


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=int, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    # every cache of the program stays at a fixed path inside the checkout
    os.environ["TRITON_CACHE_DIR"] = os.path.join(CACHE, "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(CACHE, "torch_extensions")
    os.environ["USE_FLAX"] = "0"
    # one process with one CPU thread: the card does the work, and idle pool
    # threads would only contend with the thread that feeds it
    os.environ["OMP_NUM_THREADS"] = "1"
    cell, e2e, per_layer = load_cell(args.workload, args.seed, args.seconds, bool(args.trace))
    import torch

    torch.set_num_threads(1)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        say(f"{args.workload} needs {cell.chips} CUDA card(s); this machine has "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 3
    card = card_facts(torch)
    driver = load_module("drivers", cell.traffic["driver"])
    out = driver.run(cell, card)

    found = forbidden_modules()
    if found:
        say(f"loaded in this process: {', '.join(found)}; the benchmark may load none of "
            f"{', '.join(FORBIDDEN)}")
        return 4

    compared = {k: {"value": out["checks"][k], "limit": lim} for k, lim in cell.limits.items()}
    correct = all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
                  for c in compared.values())
    device = {"platform": "gpu", "kind": card, "count": cell.chips,
              "memory_peak_bytes": out["memory_peak_bytes"]}
    line = {"correct": correct, "attempted": out["attempted"], "failed": out["failed"]}
    if cell.trace:
        trace = out["trace"]
        metrics = {}
        for m in per_layer:
            value = load_module("metrics", m["name"]).read(trace)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        device.update(busy_s=trace.busy_ns / 1e9, window_s=trace.window_s)
        line.update(metrics=metrics, device=device, breakdown=trace.breakdown())
    else:
        values = dict(out["e2e"], setup_s=out["setup_end"] - T0)
        line.update(metrics={m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                             for m in e2e}, device=device)
    line["compared"] = compared
    for k in sorted(set(out["checks"]) - set(compared)):
        say(f"read {k} {out['checks'][k]!r} (not compared)")
    for k, c in compared.items():
        say(f"compared {k} {c['value']!r} limit {c['limit']!r}")
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
