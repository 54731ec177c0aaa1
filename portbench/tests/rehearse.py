"""A CPU rehearsal of ``portbench.run``: the whole run of a cell at a tiny size.

    python portbench/tests/rehearse.py <cell> <seed> <seconds> <trace> [--fault NAME]

from the root of the repository. It stands the CPU in for the card (the
CUDA queries and the nvcc builds are stubbed, ``run.DEVICE`` is "cpu"),
shrinks the cell (96x96 images, 4 classes, batches of 2, a pool of 2, GT
buckets of 4 and 8) and runs ``portbench.run.main``, which prints the
result line as on the card. After it, one more line names every top-level
module the process loaded that the benchmark may not load.

``--fault`` breaks the timed path underneath, to show that ``correct``
comes out false:

- ``answer``: every served detection's class moves by one, where
  ``Predictor.predict_batch`` returns it;
- ``half``: a served batch's second half comes back empty; a train step
  takes the mean over the first half of the batch alone;
- ``frozen``: the train step returns the state unchanged.
"""

from __future__ import annotations

import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))

import torch  # noqa: E402

from portbench import run  # noqa: E402

SMALL_CFG = {"image_size": [96, 96], "num_classes": 4}
SMALL_TRAFFIC = {"batch": 2, "pool": 2, "sample": 2, "profile_calls": 2, "buckets": [4, 4, 8, 8],
                 "gt_mean": 3}


def stub_card() -> None:
    torch.cuda.is_available = lambda: True
    torch.cuda.device_count = lambda: 1
    torch.cuda.get_device_name = lambda *a: "CPU rehearsal (H100 peaks)"
    torch.cuda.synchronize = lambda *a: None
    torch.cuda.max_memory_allocated = lambda *a: 0
    torch.cuda.empty_cache = lambda: None
    from yolo_ms_tpu_torch.ops.kernels import nms, select

    for m in (select, nms):
        m.build = lambda *a: {"path": "", "seconds": 0.0, "log": ""}
    run.DEVICE = "cpu"


def shrink() -> None:
    real = run.load_json

    def small(*parts):
        d = real(*parts)
        if parts[0] == "configs":
            d.update(SMALL_CFG)
        elif parts[0] == "traffic":
            d.update({k: v for k, v in SMALL_TRAFFIC.items() if k in d})
        return d

    run.load_json = small


def plant(fault: str) -> None:
    if fault in ("answer", "half"):
        from yolo_ms_tpu_torch.infer.predictor import Predictor

        real = Predictor.predict_batch

        def broken(self, images):
            out = real(self, images)
            if fault == "answer":
                out["classes"] = (out["classes"] + 1) % self.num_classes
            else:
                half = len(images) // 2
                for k in out:
                    out[k][half:] = 0
            return out

        Predictor.predict_batch = broken
    if fault in ("half", "frozen"):
        from yolo_ms_tpu_torch.train import trainer

        real_make = trainer.make_train_step

        def make(*args, **kwargs):
            step = real_make(*args, **kwargs)

            def half_batch(state, batch):
                half = batch["images"].shape[0] // 2
                return step(state, {k: v[:half] for k, v in batch.items()})

            def frozen(state, batch):
                saved = [t.clone() for t in (state.params, state.stats, state.ema_params)]
                moments = {k: v.clone() for k, v in state.opt_state.items()}
                metrics = step(state, batch)
                with torch.no_grad():
                    for t, old in zip((state.params, state.stats, state.ema_params), saved):
                        t.copy_(old)
                state.opt_state.update(moments)
                return metrics

            return frozen if fault == "frozen" else half_batch

        trainer.make_train_step = make


def main(argv) -> int:
    fault = None
    if "--fault" in argv:
        i = argv.index("--fault")
        fault = argv[i + 1]
        argv = argv[:i] + argv[i + 2:]
    cell, seed, seconds, trace = argv
    torch.set_num_threads(2)
    stub_card()
    shrink()
    if fault:
        plant(fault)
    rc = run.main(["--workload", cell, "--seed", seed, "--seconds", seconds, "--trace", trace])
    print(json.dumps({"loaded": sorted({m.split(".")[0] for m in sys.modules})}))
    return rc


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
