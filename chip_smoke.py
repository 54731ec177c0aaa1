"""Drive the PyTorch/CUDA port's serving, training and tool paths on one card.

    python3 chip_smoke.py

Needs one CUDA card and nvcc (sm_90a); it exits non-zero on the first phase
that fails, and without a card. Phases, each printing one line:

1. device: the card as ``nvidia-smi --query-gpu=name,power.limit`` names it;
2. build: compiles ``yolo_ms_tpu_torch/csrc/select.cu`` and
   ``csrc/nms.cu`` (two nvcc processes at once) into the ignored
   ``yolo_ms_tpu_torch/build/`` directory and prints their registers and
   launch plans (select: ring or wide route, anchors per tile, ring stages,
   shared memory, CTAs per SM, lanes a class row at nc 80, 3, 10 and 1,203;
   nms: shared or global route and shared memory at K 525, 1,024, 1,288,
   1,289 and 4,096);
3. the one-launch ``select_scales`` against ``select_scales_plain`` on the
   card, at the serving scales (batch 32; HW 6400 / 1600 / 400) and at ragged
   and misaligned ones (HW 400 / 49 / 25); nc 80, 3, 10 and 1,203; f32 and bf16; split
   pair, unsplit map and NCHW permute view; plus the tie and +100 / -60
   cases: ``mx`` and ``cid`` exactly equal, ``ltrb`` within 1e-5 (f32) /
   1e-4 (bf16); each launch's copy routes equal to ``expected_routes`` (the
   route rule in Python); each layout's routes and, at the serving scales,
   its time per batch (L2 flushed) beside its bound, and the plain
   version's time on the split maps;
   b. the NMS kernel against ``nms_fixed_plain`` (keep and sweeps per
      image exactly equal; ``phase_nms_vs_plain``): the flagship's shape
      and K 4,096 (the global route), each timed beside its bound and the
      plain loop, a 1,024-box chain, a row of no valid box, one image, and
      IoUs exactly at the threshold;
   c. the deploy convs' epilogue kernel (``conv_epilogue``, bias + SiLU or
      the identity, in place) against ``conv_epilogue_plain`` computed in
      f32 on the same inputs, within one rounding: bs 32 maps of 256
      channels at 80x80 and YOLOv12-L's 307-wide MLP map at 40x40,
      channels-last and NCHW, bf16 and f32; one launch each on the route
      ``expected_route`` names; each timed (L2 flushed by a write) beside
      its bound (y read and written once over the memory rate), the plain
      version and torch's ``add_`` + ``F.silu``, the ops it replaced;
   then the card-only tests of ``tests/test_torch_cuda.py`` in a child
   pytest;
4. the two trained golden fixtures through ``Predictor(device="cuda")`` in
   f32 (TF32 off) in both entry layouts, ``entry_layouts="auto"``
   (channels-last, the default) and ``"default"`` (NCHW), matched against
   their checked-in detections, every NMS launch (K 525) held against the
   plain version, and the card's raw maps on the same image held against
   the CPU's (atol 1e-4);
5. full-width serving: yolo-ms-xs and yolov8-n, nc=80, 640x640, bf16,
   batch 32, weights from seeded numpy through the converter, BN-folded,
   served through ``Predictor(entry_layouts="auto")`` (the main path) and
   ``"default"`` in turns on the same 8 batches, twice: the first pass
   holds every ``select`` launch against ``select_scales_plain`` on the same
   maps and its copy routes against ``expected_routes``, and under auto
   every map must take the bulk-rows route, and every ``nms`` launch against
   ``nms_fixed_plain`` on the boxes it served, at conf 1e-5 and with the
   scores gated at 0.25 (keep and sweeps exact); the second is timed;
   ``select.launches`` and ``nms.launches`` must rise by 1 per batch;
   outputs are checked; auto's raw maps must lie within 2e-2 (max |diff| /
   max |default|) of default's and be contiguous NHWC; the kernel tail is
   held against the plain tail on the same f32 maps; per layout the batch
   time (host clock), the forward and post-process times (CUDA events, in
   turns), the kernels of one forward (``torch.profiler``: their count and
   time, the layout transposes among them) and ``select``'s time, route and
   share of its bound; under auto, the convs whose input or output is not
   channels-last (forward hooks); each distinct conv timed alone in both
   layouts (where channels-last loses and gains most). The main path's
   kernel is timed as one
   launch per batch with L2 flushed (by a write, and by a read) and
   unflushed (as the main path finds the maps after the head convs), each
   behind a spin kernel so that the host's enqueue time is not counted, and
   on each scale alone; the host's time to enqueue one call is measured
   apart. The NMS kernel is timed on auto's last served input beside the
   plain loop, and the post-process and ``infer`` again with the plain
   NMS loop in the same turns. Each time stands beside its bound (bytes
   over the memory rate against operations over the f32 rate of the card
   that ``nvidia-smi`` names);
   b. LVIS v1's class count: yolo-ms-xs with nc = 1,203, bs 32, 640²,
      seeded weights, BN-folded, conf 1e-5, through
      ``Predictor(entry_layouts="auto")`` in bf16 (its tiles fit a ring:
      bulk rows on every map) and then in f32 with TF32 off (they do not:
      ``select``'s wide route), 4 batches checked and 4 timed each: every
      launch equal to the plain version on the maps it served, its routes
      those of ``expected_routes`` and bulk rows (or wide) on every map,
      every ``nms`` launch as in phase 5;
      the kernel tail equal to the plain tail; ms per batch and
      ``select``'s time (L2 flushed by a write) beside its bound and the
      plain version's;
   c. the fine-tune configuration (``yolo_ms_tpu/configs/
      finetune_example.yaml``: yolov8-n, 10 classes, 640²) by 5b's rules,
      bf16 and f32 (TF32 off), bulk rows on every map;
6. training on the card:
   a. one f32 train step (TF32 off) of the golden yolov8-n weights with
      SGD-nesterov, weight decay, clipping and EMA, on the card and on the
      CPU in this process: loss terms within rtol 1e-4; params, BN
      statistics and EMA within rtol 1e-3 / atol 1e-5;
   b. the JAX package's learning recipe (``tests/test_learning.py``:
      yolov8-n, 160 px, nc=3, 32 synthetic images, batch 16, 60 epochs,
      Adam 2e-3, cosine with warmup 20) through ``Trainer.fit`` and
      ``validate``: mAP@0.5 must exceed 0.5;
   c. yolo-ms-xs at full width and depth, nc=80, 640x640, bf16 autocast,
      batch 32, with the ``coco_yolo_ms.yaml`` settings (warmup cut to 3
      steps), one epoch of 12 steps on synthetic 640x480 images and a
      64-image validation: every step finite, none skipped, positives in
      each; the first step's bf16 loss within 5 % of the f32 loss of the
      same batch; ``select.launches`` rising by exactly the number of val
      batches in ``fit`` (counts set to 0 just before it) and in a timed
      ``validate``; the checkpoint re-read by ``resume``. It prints ms/step
      (CUDA events), img/s, the host's wait for the loader, the gap from one
      step's start to the next (host clock), the end-to-end rate (every
      training image over the whole fit's wall time, validation and
      checkpoint writes included), the peak device memory and the validate
      time, then a breakdown of steps without the loader.

7. the tools on the card, each printing one line:
   a. ``tools.test`` on the golden yolov8-n from its ``weights.npz`` and from
      a reference-format ``.pt`` made from the same weights: the golden
      detections, one ``select`` launch per batch;
   b. ``tools.export`` of 6c's ``last.ckpt`` (EMA) to a folded f32 and a
      folded bf16 file (params, MB, seconds); the f32 export's raw maps
      against the unfolded EMA model's (TF32 off, atol 1e-3); ``tools.val``
      on each export over 6c's 64 val images at 640², batch 32: one
      ``select`` launch per val batch, ms per batch (host clock),
      detections and mAP@0.5;
   c. 6c's val images as an MJPG video through ``predict_video`` (640²,
      batch 32, the bf16 export served in f32): one launch per batch, each
      frame's detections those of ``predict_image`` on the decoded frame,
      every frame written; frames/s (host clock);
   d. the preemption drill: child processes (this script with
      ``--preempt-child``) train the 6b recipe cut to 2 epochs (SGD, f32,
      TF32 off, deterministic algorithms): twice uninterrupted; SIGTERM
      inside step 3's in-flight window, which must exit 143 with the
      committed step as its cursor; resumed from ``preempt.ckpt``, whose
      final params, statistics and EMA must equal the uninterrupted run's
      (rtol 1e-3 / atol 1e-5); the seconds from signal to exit;
   e. ``tools.analyze`` of yolo-ms-xs at 640² on the card: params and
      ``FlopCounterMode`` GFLOPs per image;
   f. ``Predictor(deploy=False)`` (BatchNorm unfolded, eval mode) in both
      entry layouts, f32 with TF32 off: both trained goldens reproduce
      their detections (phase 4's rule); 6c's checkpoint gives raw maps
      within 1e-3 of the folded model's (7b's rule) and serves its 64 val
      images; one ``select`` launch per served batch.
8. data-parallel training, each rank a child process (this script with
   ``--dp-child``) started with torchrun's variables, so the port's own
   ``maybe_initialize_distributed`` runs; two ranks share the one card over
   ``gloo`` (NCCL refuses two ranks on one device):
   a. 6a's recipe for 3 steps in two ranks x 4 rows (deterministic
      algorithms) against one process x 8: loss terms within rtol 1e-4,
      params, statistics and EMA within rtol 1e-3 / atol 1e-5 after each
      step, the ranks' states bitwise equal; a NaN pixel in rank 1's rows
      makes both ranks skip the step; then 6b's trained checkpoint validated
      in the two ranks (the val feed sharded, the detections gathered)
      against one process: the same detection count, mAP@0.5 within 1e-6,
      one ``select`` launch per val batch per rank;
   b. 6c's recipe and cut at global batch 32 = 2 ranks x 16, 6 steps, then
      the sharded validation of 6c's 64 val images: every step finite, none
      skipped, positives in each, the first step's loss within rtol 1e-2 of
      the one-process step on the same global batch, the ranks bitwise
      equal at the end, the same mAP on both (near 0 after 6 steps: 8a
      holds the sharded validation against one process), one ``select`` launch per val
      batch per rank (counts set to 0 just before the fit), files from rank
      0 only; it prints the step time (CUDA events) beside 6c's, the
      end-to-end rate, the gradient and BatchNorm all-reduces replayed alone
      at the step's sizes, and the peak memory of each rank;
   c. 7d's drill in two ranks: SIGTERM to both inside step 3's in-flight
      window; both exit 143, only rank 0 wrote ``preempt.ckpt``, and a
      two-rank resume equals the uninterrupted two-rank run; the seconds
      from signal to exit of each rank;
   d. NCCL: 8a over ``nccl``, one rank per card, on a host with two or more
      cards; on one card, the port's refusal of a second rank (before
      init) and a one-rank
      ``nccl`` group (init, one all-reduce, one train step).
9. the exported serving program and the pipelined ``predict_paths``:
   a. ``tools.export --program`` of both trained goldens (160², nc=3,
      batch 1), and ``tools.export.run`` + ``export_program`` of phase 5's
      seeded yolo-ms-xs (nc=80, batch 32, 640², conf 1e-5), channels-last
      (``entry_layouts="auto"``; the export reads the saved file back and
      raises if it lost the layout): seconds and file MB;
   b. the flagship program (``load_program``, its weights channels-last) on
      phase 5's 8 batches against ``Predictor(entry_layouts="auto").infer``
      on the same batches: ``valid`` and
      ``classes`` equal, boxes within 1e-3 px, scores within rtol 1e-5; one
      ``select`` launch per call; ms/batch on the host clock beside phase
      5's, the device time of a call, and the post-process alone exported
      and timed against the eager one (CUDA events, in turns); then
      ``torch.profiler`` over the program, ``Predictor.infer`` and both
      tails: wall, kernel time, card idle, device operations and host
      reads of a device value per call;
   c. a child interpreter serves the golden programs through
      ``load_program``: it must import no ``yolo_ms_tpu_torch.models``
      module (nor JAX), and its detections must match the golden ones;
   d. ``predict_paths`` over 6c's 384 training images (640x480) at bs=32
      640² bf16, sequential and pipelined in turns: equal results,
      byte-equal files, one launch per batch; img/s of each;
   e. the flagship exported at ``entry_layouts="default"`` (the NCHW
      program) against ``Predictor(entry_layouts="default").infer`` on
      phase 5's 8 batches by 9b's rules, one ``select`` launch per call on
      the TMA route; ms/batch beside the auto program's.

10. hybrid data x spatial training and height-sharded serving, in gloo
    ranks on the one card (this script with ``--dp-child 10``): first 2
    ranks, then 4; one process in this one is the reference:
    a. 6a's recipe from the golden yolov8-n (160², f32, TF32 off,
       deterministic algorithms, SGD), two steps on 6a's batch of 8 on a
       (1, 2) and a (2, 2) mesh: step 1 loss terms within rtol 1e-5,
       ``num_fg`` equal, params / statistics / EMA within rtol 1e-3 / atol
       1e-5; step 2 by the JAX spatial test's rules (``num_fg`` within 2,
       loss within 5e-2, parameters within 1e-2 in relative norm); the
       ranks bitwise equal. The 5-row P5 map splits 2/3: the uneven case;
    b. 8b's recipe, set and cut with ``parallel.spatial = 2`` through
       ``Trainer.fit`` on the 4 ranks' (2, 2) mesh (16 images x 320 rows
       each), 6 steps, then validation sharded over data only: every step
       finite, none skipped, positives in each; the first loss within 1e-2
       of one process (8b's); the ranks bitwise equal; one mAP; files from
       rank 0 only; ms/step beside 6c's and 8b's, the third step's halo
       exchanges replayed alone, and the peak memory of each rank beside
       8b's;
    c. both trained goldens (conf 0.25) and yolo-ms-xs with phase 5's seeded
       weights on one 1280² image (conf 1e-5), f32, served height-sharded
       over S = 2 and 4 ranks (``serve_height_sharded``): valid flags and
       scores slot by slot within rtol 1e-5, each detection one of the
       one-process NMS survivors (boxes rtol 1e-4 / atol 1e-3); the goldens'
       checked-in detections matched on every rank; one ``select`` launch
       per call per rank; ms per image beside one process.

11. the benchmark CLI's functions (``yolo_ms_tpu_torch/tools/benchmark.py``)
    at full width, bs=32, 640², nc=80, seed-0 weights, K=10, reps 3:
    a. ``run_benchmark(arch, 32, "e2e")`` for yolo-ms-xs and yolov8-n, its
       report's layout ``auto`` / ``channels_last``:
       ``select.launches`` equal to the iterations run, warm-up included
       (1 per iteration); iteration 0 equal to ``Predictor.infer`` built
       here from the same draws on the same images, at the benchmark's conf
       0.25 and at 1e-5 (9b's rules); the report beside phase 5's ``infer``
       time; NMS sweeps per iteration;
    b. ``forward`` of yolo-ms-xs beside phase 5's normalize + forward;
    c. ``train`` of yolo-ms-xs (``run_benchmark``'s body, every loss kept):
       every loss finite, the step counter equal to the iterations run;
       beside 6c's step alone;
    d. ``run_streaming`` of yolo-ms-xs over the 2,048-JPEG fixture, 8 decode
       threads, depth 8: every leg, the native loader's presence, the
       ``bound`` verdict and the derived cores per card; ``select.launches``
       equal to the calls made, every batch served by the sustained leg;
    e. the ``native/`` loader: where g++ compiles ``jpeglib.h`` and
       ``png.h``, ``native/build.sh`` builds it into the ignored
       ``yolo_ms_tpu_torch/build/`` (a failed build fails the run) and
       ``tools/benchmark.py --mode streaming --images DIR`` runs over 11d's
       fixture with it and then with cv2: each leg of both runs, one launch
       per call; the first batch and both goldens' fixtures decoded by each
       give the same detections (phase 4's rule). Where the tools are
       absent it prints so.

The last three lines are the kernel JSON, the nvidia-smi line, and
``{"ok": true, "device": {...}}``.

    python3 chip_smoke.py --parent DIR

instead times the select kernel of another checkout of the repo (``DIR``,
for example the parent commit unpacked with ``git archive``) against this
one on the same inputs, in turns (parent, this, this, parent), after
phases 1 and 2, at nc 80 and on 5c's and 5b's bf16 maps; ``--variants``
(alone or beside ``--parent``) times the edited copies of ``select.cu`` in
``SELECT_VARIANTS`` (the copies alone, with no compute; the wide route at
every class count from 256 to 1,730 in bf16; 16 or 32 lanes a class row;
three CTAs an SM; no class walk; no exp in the box sums) against the
kernel as built, and those of ``nms.cu`` in ``NMS_VARIANTS`` (no skip of
the quotient, whole rows dealt to threads, both, the overlap bits alone).

The kernel JSON lists ``select``, ``nms`` and ``conv_epilogue``. It counts
the first two's launches on
every path (``launches_by_path``; each path's count is checked equal for
the two kernels, since every post-process launches each once): the serving run of phase 5 (both layouts, both
passes), the training run of
phase 6c, phase 7's ``tools.test``, ``tools.val`` and ``predict_video``
runs, phase 8b's data-parallel validation (``train_dp_validate``, both
ranks' launches), phase 9's program calls (``program``) and
``predict_paths`` runs (``predict_paths``), phase 10's validation on
the (2, 2) mesh (``train_spatial_validate``) and height-sharded serving
(``serve_height_sharded``), every rank's launches, phase 11's e2e
benchmark runs (``benchmark_e2e``) and streaming runs
(``benchmark_streaming``; ``streaming_images``, 11e's two), phase 5b's
LVIS-width serving (``serve_wide``), phase 5c's fine-tune serving
(``serve_finetune``), 7f's unfolded serving
(``serve_unfolded``) and 9e's NCHW program (``program_nchw``). On each
of these paths of this process (each rank in its own), and wherever a
path's count is taken, ``conv_epilogue.launches`` must have risen by one
per deploy ``ConvBnSiLU`` forward that Python ran on the card (a global
forward hook counts them) and, for an exported program, by the program's
``conv_epilogue`` calls per call; phase 5 also counts the epilogue
kernels of one replayed call in a profile, one per deploy conv. The
``conv_epilogue`` entry gives this process's launches, each counted
path's (``launches_by_path``, by label; a path checked batch by batch
sums its batches) and 3c's errors and times.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import contextlib
import copy
import glob
import importlib.util
import io
import json
import math
import os
import re
import shutil
import signal
import socket
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from yolo_ms_tpu_torch.data import native_loader
from yolo_ms_tpu_torch.data.augment import device_normalize_images
from yolo_ms_tpu_torch.data.decode import decode_and_resize, decode_image
from yolo_ms_tpu_torch.infer import graphs
from yolo_ms_tpu_torch.infer.layouts import ENTRY_LAYOUTS, memory_format_name, not_channels_last
from yolo_ms_tpu_torch.infer.predictor import Predictor
from yolo_ms_tpu_torch.infer.program import load_program
from yolo_ms_tpu_torch.infer.video import predict_video
from yolo_ms_tpu_torch.models.deploy import fold_batchnorm
from yolo_ms_tpu_torch.models.registry import build_model, init_model
from yolo_ms_tpu_torch.nn.blocks import (
    BatchNorm2d,
    ConvBnSiLU,
    set_batch_norm_group,
    set_spatial_group,
)
from yolo_ms_tpu_torch.ops.kernels import epilogue as epilogue_mod
from yolo_ms_tpu_torch.ops.kernels.epilogue import conv_epilogue, conv_epilogue_plain
from yolo_ms_tpu_torch.ops.kernels import select as select_mod
from yolo_ms_tpu_torch.ops.kernels.select import (
    expected_routes,
    select,
    select_plain,
    select_scales,
    select_scales_plain,
)
from yolo_ms_tpu_torch.ops import nms as nms_ops
from yolo_ms_tpu_torch.ops import postprocess as postprocess_mod
from yolo_ms_tpu_torch.ops.kernels import nms as nms_mod
from yolo_ms_tpu_torch.ops.kernels.nms import nms, nms_fixed_plain
from yolo_ms_tpu_torch.ops.nms import CLASS_OFFSET, nms_fixed
from yolo_ms_tpu_torch.ops.postprocess import fused_postprocess
from yolo_ms_tpu_torch.parallel.distributed import (
    all_reduce_sum,
    data_parallel_group,
    exchange,
    get_rank,
    leave_group,
    maybe_initialize_distributed,
    rank_device,
    world_size,
)
from yolo_ms_tpu_torch.parallel.mesh import hybrid_batch_sharding, make_mesh_2d, shard_batch
from yolo_ms_tpu_torch.parallel.spatial import serve_height_sharded
from yolo_ms_tpu_torch.tools import benchmark
from yolo_ms_tpu_torch.tools import export as tools_export
from yolo_ms_tpu_torch.tools import test as tools_test
from yolo_ms_tpu_torch.tools import val as tools_val
from yolo_ms_tpu_torch.tools.analyze import analyze
from yolo_ms_tpu_torch.train.loss import DetectionLoss
from yolo_ms_tpu_torch.train.optim import build_optimizer
from yolo_ms_tpu_torch.train.trainer import Trainer, TrainState, make_train_step
from yolo_ms_tpu_torch.utils import profiler
from yolo_ms_tpu_torch.utils.checkpoint import (
    load_serving_state_dict,
    restore_checkpoint,
    save_checkpoint,
)
from yolo_ms_tpu_torch.utils.config import Config, TrainingConfig, load_config
from yolo_ms_tpu_torch.utils.convert import (
    load_npz,
    state_dict_to_variables,
    variables_to_state_dict,
)
from yolo_ms_tpu_torch.utils.device import full_f32

ROOT = os.path.dirname(os.path.abspath(__file__))
GOLDENS = (
    ("n", os.path.join(ROOT, "tests", "golden", "trained")),
    ("yolo-ms-xs", os.path.join(ROOT, "tests", "golden", "trained_yolo-ms-xs")),
)
SERVE_ARCHS = ("yolo-ms-xs", "yolov8-n")
BATCH, IMG, NC, REG_MAX = 32, 640, 80, 16
SERVE_BATCHES = 8  # batches in the counted main-path run, per model and layout
# Predictor(entry_layouts=...) over ENTRY_LAYOUTS: "auto" (the default,
# channels-last on the card) is the main path; phases 4 and 5 also serve
# "default" (NCHW)
LAYOUT_FORMATS = {"auto": torch.channels_last, "default": torch.contiguous_format}
# auto's bf16 raw head maps against default's, max |diff| / max |default|:
# the same convs through other cuDNN kernels (NHWC against NCHW), each
# layer's output rounded to bf16 (8 bits of mantissa, 3.9e-3 per rounding)
LAYOUT_MAPS_REL = 2e-2
# cuDNN's layout conversions and other transposes, by kernel name
TRANSPOSE_KERNELS = re.compile(r"nchwToNhwc|nhwcToNchw|[Tt]ranspose")
LAYOUTS = ("split", "unsplit", "nchw")
# the serving scales at 640 px; a ragged set (HW 400 is not a multiple of the
# tile; the rows of HW 49 and 25 are not 16-byte aligned)
SCALE_SETS = (("serving", (80, 40, 20)), ("ragged", (20, 7, 5)))
# Device memory rate (bytes/s) and f32 rate outside the tensor cores
# (operations/s) by card name, from NVIDIA's data sheets (dense, full power).
PEAK_RATES = (
    ("H100 PCIe", 2.0e12, 51e12),
    ("H100 NVL", 3.9e12, 60e12),
    ("H100", 3.35e12, 67e12),
    ("H200", 4.8e12, 67e12),
)
LTRB_ATOL = {torch.float32: 1e-5, torch.bfloat16: 1e-4}
# select's copy route for every map of the main path (auto's contiguous NHWC
# maps); phase 5 fails on any launch that takes another
MAIN_PATH_ROUTE = "bulk_rows"
# f32 card forward (TF32 off) against the CPU's: the same sums in another
# order through ~60 conv layers. Phase 4 also prints the gap at the default
# (TF32) conv precision, which this bound is meant to exclude.
MAPS_ATOL = 1e-4


def peak_rates(name: str) -> tuple[float, float]:
    for key, mem, f32 in PEAK_RATES:
        if key in name:
            return mem, f32
    raise RuntimeError(f"no peak rates on record for {name!r}")


def select_bound(pairs, name: str) -> tuple[float, float]:
    """The two least times (ms) the card could take for one ``select_scales``
    call over (box, cls) pairs: each input element read once and 24 B
    written per anchor (mx, cid, ltrb) over the memory rate, and the f32
    operations (one compare per class logit; a max, subtract, clamp, exp,
    multiply and two adds per box logit) over the f32 rate. The bound is the
    larger."""
    mem_rate, f32_rate = peak_rates(name)
    nbytes = ops = 0
    for box, cls in pairs:
        n_anchor = box.shape[0] * box.shape[1]
        nbytes += n_anchor * (
            box.shape[2] * box.element_size() + cls.shape[2] * cls.element_size() + 24)
        ops += n_anchor * (cls.shape[2] + 7 * box.shape[2])
    return nbytes / mem_rate * 1e3, ops / f32_rate * 1e3


def bound_of(bytes_ms: float, ops_ms: float) -> tuple[float, str]:
    return (bytes_ms, "bytes") if bytes_ms >= ops_ms else (ops_ms, "operations")


# The deploy ``ConvBnSiLU`` forwards on card tensors that Python ran in
# this process (a global forward hook, ``watch_deploy_convs``): each
# launches the epilogue kernel once. A graph replay runs neither (phase 5
# counts the kernels of a replay in a profile); an exported program
# launches the kernel with no module forward (``program_epilogues``).
DEPLOY_CONVS = {"run": 0}
EPILOGUE = {"before": 0}  # epilogue launches of this process before the last zero_counts
# each counted path's epilogue launches, by ``launched``'s label (a label
# checked batch by batch sums its batches)
EPILOGUE_BY_PATH: dict = {}


def is_deploy_conv(module) -> bool:
    return isinstance(module, ConvBnSiLU) and module.bn is None and module.conv.bias is not None


def _deploy_conv_ran(module, args, output) -> None:
    if (is_deploy_conv(module) and args and args[0].is_cuda
            and torch._guards.detect_fake_mode(args) is None):  # not a torch.export trace
        DEPLOY_CONVS["run"] += 1


def watch_deploy_convs() -> None:
    torch.nn.modules.module.register_module_forward_hook(_deploy_conv_ran)


def deploy_convs(model) -> int:
    """The deploy ``ConvBnSiLU`` modules of ``model``; a forward calls each once."""
    return sum(is_deploy_conv(m) for m in model.modules())


def program_epilogues(program) -> int:
    """The ``conv_epilogue`` calls in a loaded program's graph: its launches a call."""
    op = torch.ops.yolo_ms_tpu_torch.conv_epilogue.default
    return sum(node.target is op for gm in program.modules()
               if isinstance(gm, torch.fx.GraphModule) for node in gm.graph.nodes)


def zero_counts() -> None:
    """Every kernel's launch count to 0, just before a counted path."""
    select.launches = 0
    nms.launches = 0
    EPILOGUE["before"] += conv_epilogue.launches
    conv_epilogue.launches = 0
    DEPLOY_CONVS["run"] = 0


def counts() -> tuple[int, int, int, int]:
    """The (select, nms, epilogue) launch counts and the deploy convs run
    now, to difference later."""
    return select.launches, nms.launches, conv_epilogue.launches, DEPLOY_CONVS["run"]


def launched(label: str, since: tuple | None = None, program_convs: int = 0) -> int:
    """The ``select`` launches since ``since`` (``counts()`` taken before;
    None after ``zero_counts``), once the NMS kernel is found to have
    launched as often: every post-process call launches each kernel once,
    so each path's count is both kernels'. The epilogue kernel must have
    launched once per deploy conv that Python ran, and ``program_convs``
    times per call (one ``select`` launch) of an exported program."""
    base = since or (0, 0, 0, 0)
    sel, nm = select.launches - base[0], nms.launches - base[1]
    if sel != nm:
        raise AssertionError(f"{label}: select launched {sel} times but nms {nm}")
    epi, convs = conv_epilogue.launches - base[2], DEPLOY_CONVS["run"] - base[3]
    if epi != convs + program_convs * sel:
        raise AssertionError(f"{label}: the epilogue kernel launched {epi} times for {convs} "
                             f"deploy convs run and {sel} calls of {program_convs} in a program")
    EPILOGUE_BY_PATH[label] = epi + (EPILOGUE_BY_PATH.get(label, 0) if since else 0)
    return sel


def cuda_ms(fn, reps: int, flush: torch.Tensor | None = None, clean: bool = False,
            cover: bool = False) -> float:
    """Median device time of one call of ``fn`` (CUDA events around each
    call). ``flush`` is overwritten before each call so inputs come from HBM;
    with ``clean`` it is read instead, which leaves the L2 holding clean
    lines, so the call does not also write back up to 50 MB of dirty ones.
    ``cover`` first queues a spin kernel, so that the host's time to enqueue
    ``fn`` is not counted as device time."""
    fn()
    pairs = []
    for _ in range(reps):
        if flush is not None:
            if clean:
                flush.view(torch.int32).sum()
            else:
                flush.zero_()
        if cover:
            torch.cuda._sleep(400_000)  # about 0.2 ms of cycles
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in pairs)


def host_us(fn, reps: int = 200) -> float:
    """Median host time (us) to enqueue one call of ``fn``."""
    times = []
    for i in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e6)
        if i % 20 == 19:
            torch.cuda.synchronize()
    torch.cuda.synchronize()
    return statistics.median(times)


# f32 operations of the NMS fixed point: per pair j < i of valid boxes (four
# max / min, two widths, two clamps and the product of the intersection, the
# two adds and a subtract of the union, the quotient, the compare), per valid
# box (its area: two widths and a product), and per overlap word of a valid
# row in a sweep (an AND and a test)
NMS_PAIR_OPS, NMS_BOX_OPS, NMS_WORD_OPS = 14, 3, 2
NMS_IOU = 0.45  # the serving tail's IoU threshold
NMS_PLAN_K = (525, 1024, 1288, 1289, 4096)  # the goldens', the main path's, the routes' edge


def nms_bound(scores: torch.Tensor, sweeps: list, name: str) -> tuple[float, float]:
    """The two least times (ms) the card could take for one NMS call over
    boxes [B, K, 4] and scores [B, K] that ran ``sweeps`` per image: 16 B
    of box and 4 B of score read and 1 B of keep written per box, 4 B of
    sweeps per image, over the memory rate; and the operations these inputs
    need (``NMS_*_OPS``, over the valid boxes of each image only: an invalid
    box suppresses nothing and is never kept) over the f32 rate."""
    mem_rate, f32_rate = peak_rates(name)
    b, k = scores.shape
    ops = 0
    for v, n_sweeps in zip((scores > 0).sum(dim=1).tolist(), sweeps):
        words = sum(-(-i // 32) for i in range(v))
        ops += v * (v - 1) // 2 * NMS_PAIR_OPS + v * NMS_BOX_OPS + n_sweeps * words * NMS_WORD_OPS
    return b * (21 * k + 4) / mem_rate * 1e3, ops / f32_rate * 1e3


NMS_CHECKS = {"launches": 0, "err": 0}  # launches held against the plain version, worst error


def check_nms(boxes, scores, iou, label, got=None) -> list:
    """The kernel's (keep, sweeps) on these inputs (``got``, or one launch
    now) against ``nms_fixed_plain``'s on the same inputs: both exactly
    equal. Returns the sweeps per image."""
    keep, sweeps = nms(boxes, scores, iou) if got is None else got
    want_keep, want_sweeps = nms_fixed_plain(boxes, scores, iou)
    torch.cuda.synchronize()
    err = max(int((keep.int() - want_keep.int()).abs().max()),
              int((sweeps - want_sweeps).abs().max())) if keep.numel() else 0
    NMS_CHECKS["launches"] += 1
    NMS_CHECKS["err"] = max(NMS_CHECKS["err"], err)
    if not (torch.equal(keep, want_keep) and torch.equal(sweeps, want_sweeps)):
        raise AssertionError(f"{label}: nms keeps {(keep != want_keep).sum().item()} boxes "
                             f"otherwise than the plain version; sweeps {sweeps.tolist()} "
                             f"against {want_sweeps.tolist()}")
    return sweeps.tolist()


class NmsSpy:
    """While ``on``: every NMS call of the post-process (one kernel launch)
    is held against ``nms_fixed_plain`` on the same boxes and scores
    (``check_nms``), and again with the scores gated at conf 0.25 (what the
    tail would give it at that threshold; a comparison launch, taken back
    out of the count). Each call's max sweeps are kept under ``label``, and
    the last call's inputs too. The plain version launches no kernel."""

    def __init__(self):
        self.label = None
        self.sweeps = {}
        self.inputs = {}

    @contextlib.contextmanager
    def on(self):
        real = nms_ops.nms_kernel

        def spy(boxes, scores, iou):
            before = nms.launches
            got = real(boxes, scores, iou)
            if nms.launches != before + 1:
                raise AssertionError(f"{self.label}: an nms call launched "
                                     f"{nms.launches - before} kernels")
            sweeps = check_nms(boxes, scores, iou, f"{self.label} served boxes", got)
            check_nms(boxes, torch.where(scores > 0.25, scores, -1.0), iou,
                      f"{self.label} served boxes at conf 0.25")
            nms.launches = before + 1
            self.sweeps.setdefault(self.label, []).append(max(sweeps, default=0))
            self.inputs[self.label] = (boxes, scores, iou)
            return got

        nms_ops.nms_kernel = spy
        try:
            yield self
        finally:
            nms_ops.nms_kernel = real


@contextlib.contextmanager
def plain_nms():
    """Every post-process inside runs the NMS fixed point's plain version
    (one host read per sweep) in place of the kernel: the tail that the
    kernel replaced, for comparisons within one call."""
    real = nms_ops.nms_kernel
    nms_ops.nms_kernel = nms_fixed_plain
    try:
        yield
    finally:
        nms_ops.nms_kernel = real


# ---------------------------------------------------------------- phase 3


def _layout_views(gen, b, h, w, nc, dtype, layout):
    """Random box/cls logits as [B, HW, C] views in one of three layouts."""
    dev = "cuda"
    nb = 4 * REG_MAX
    if layout == "nchw":
        box = torch.randn(b, nb, h, w, generator=gen, device=dev) * 2.0
        cls = torch.randn(b, nc, h, w, generator=gen, device=dev) * 2.0
        box, cls = box.to(dtype), cls.to(dtype)
        return box.permute(0, 2, 3, 1).flatten(1, 2), cls.permute(0, 2, 3, 1).flatten(1, 2)
    if layout == "split":
        box = (torch.randn(b, h * w, nb, generator=gen, device=dev) * 2.0).to(dtype)
        cls = (torch.randn(b, h * w, nc, generator=gen, device=dev) * 2.0).to(dtype)
        return box, cls
    flat = (torch.randn(b, h * w, nb + nc, generator=gen, device=dev) * 2.0).to(dtype)
    return flat[..., :nb], flat[..., nb:]


def compare_select(pairs, dtype, label):
    """``select_scales`` against ``select_scales_plain`` on the same maps,
    and its copy routes against ``expected_routes``."""
    got = select_scales(pairs, REG_MAX)
    routes = check_routes(pairs, label)
    return check_select(got, select_scales_plain(pairs, REG_MAX), dtype, label), routes, got


def check_routes(pairs, label, only: str | None = None) -> list:
    """The last launch's copy routes: those ``expected_routes`` predicts for
    ``pairs`` and, with ``only``, that one route for every map."""
    routes = list(select_scales.last_routes)
    want = expected_routes(pairs, REG_MAX)
    if routes != want:
        raise AssertionError(f"{label}: select took routes {routes}, expected {want}")
    if only is not None and any(r != only for pair in routes for r in pair):
        raise AssertionError(f"{label}: select took routes {routes}, not {only} alone")
    return routes


def check_select(got, want, dtype, label) -> float:
    """The kernel's (mx, cid, ltrb) against the plain version's: ``mx`` and
    ``cid`` equal, ``ltrb`` within LTRB_ATOL; returns the ltrb error."""
    (mx, cid, ltrb), (pmx, pcid, pltrb) = got, want
    torch.cuda.synchronize()
    if not torch.equal(mx, pmx):
        raise AssertionError(f"{label}: mx differs, max err {(mx - pmx).abs().max().item()}")
    if not torch.equal(cid, pcid):
        raise AssertionError(f"{label}: cid differs at {(cid != pcid).sum().item()} anchors")
    err = (ltrb - pltrb).abs().max().item()
    if not (err <= LTRB_ATOL[dtype]) or not torch.isfinite(ltrb).all():
        raise AssertionError(f"{label}: ltrb max err {err} > {LTRB_ATOL[dtype]}")
    return err


def _route_names(routes) -> str:
    return " ".join(f"{b}/{c}" for b, c in routes)


# phase 2's plans and phase 3's class counts: COCO's, the goldens', the
# fine-tune config's and LVIS's
PHASE3_NC = (NC, 3, 10, 1203)


def phase_kernel_vs_plain(flush: torch.Tensor, name: str) -> float:
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    worst = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        for nc in PHASE3_NC:
            for set_name, sides in SCALE_SETS:
                parts = []
                for layout in LAYOUTS:
                    pairs = [_layout_views(gen, BATCH, s, s, nc, dtype, layout) for s in sides]
                    label = f"{dtype} {set_name} nc={nc} {layout}"
                    err, routes, _ = compare_select(pairs, dtype, label)
                    worst = max(worst, err)
                    part = f"{layout} err {err:.3e} route {_route_names(routes)}"
                    if set_name == "serving":
                        ms = cuda_ms(lambda: select_scales(pairs, REG_MAX), 20, flush, cover=True)
                        bound = bound_of(*select_bound(pairs, name))[0]
                        part += (f" {ms * 1e3:.1f} us (bound {bound * 1e3:.1f} us, "
                                 f"{bound / ms * 100:.0f} % of it)")
                        if layout == "split":
                            plain = cuda_ms(lambda: select_scales_plain(pairs, REG_MAX), 5, flush,
                                            cover=True)
                            part += f", plain {plain * 1e3:.1f} us"
                    parts.append(part)
                hws = "/".join(str(s * s) for s in sides)
                print(f"phase 3 select_scales {str(dtype)[6:]} B={BATCH} HW={hws} nc={nc}: "
                      f"mx, cid equal; " + "; ".join(parts))
    # ties and extremes: all-equal class logits -> id 0; side 0 peaked at
    # bin 3 (+100) -> 3.0; side 1 trails by 100 > 60 -> clamped, uniform 7.5
    for dtype in (torch.float32, torch.bfloat16):
        flat = torch.zeros(1, 16, 4 * REG_MAX + 8, dtype=dtype, device="cuda")
        flat[0, 0, 3] = 100.0
        err, _, (_, cid, ltrb) = compare_select(
            [(flat[..., : 4 * REG_MAX], flat[..., 4 * REG_MAX :])], dtype, f"{dtype} extremes"
        )
        worst = max(worst, err)
        got = ltrb[0, 0].tolist()
        if int(cid.abs().max()) != 0 or abs(got[0] - 3.0) > 1e-4 or abs(got[1] - 7.5) > 1e-4:
            raise AssertionError(f"extremes: cid {cid[0, :4].tolist()}, ltrb {got}")
        print(f"phase 3 select {str(dtype)[6:]} ties/+100/-60: cid 0, ltrb[0]={got[0]:.6f}, "
              f"ltrb[1]={got[1]:.6f}, max err {err:.3e}")
    return worst


def _nms_random(b: int, k: int, seed: int, span: float = 640.0, pad: int = 0,
                classes: int = 80):
    """Seeded boxes [b, k, 4] xyxy, each shifted by one of ``classes``
    classes as the serving tail shifts them, and descending scores [b, k]
    with the last ``pad`` rows invalid, on the card."""
    rng = np.random.default_rng(seed)
    centers = rng.uniform(0, span, (b, k, 2))
    sizes = rng.uniform(8, 60, (b, k, 2))
    boxes = np.concatenate([centers - sizes / 2, centers + sizes / 2], -1)
    boxes += rng.integers(0, classes, (b, k, 1)) * CLASS_OFFSET
    scores = np.sort(rng.uniform(0.05, 1.0, (b, k)), axis=1)[:, ::-1].copy()
    if pad:
        scores[:, -pad:] = -1.0
    return (torch.from_numpy(boxes.astype(np.float32)).cuda(),
            torch.from_numpy(scores.astype(np.float32)).cuda())


def _nms_chain(n: int, iou: float = NMS_IOU, width: float = 20.0):
    """n boxes in a row, each overlapping the next above ``iou`` and the one
    after that below it: greedy keeps every other box, and the fixed point
    settles one link per sweep (n sweeps in all)."""
    r = (1.0 - iou) / (1.0 + iou)
    x = np.arange(n) * 0.75 * r * width
    boxes = np.stack([x, np.zeros(n), x + width, np.full(n, 10.0)], -1)
    return (torch.from_numpy(boxes.astype(np.float32)).cuda(),
            torch.linspace(1.0, 0.5, n, device="cuda"))


def phase_nms_vs_plain(name: str) -> None:
    """3b: the NMS kernel against ``nms_fixed_plain`` on the card, keep and
    sweeps per image exactly equal, at IoU 0.45: the flagship's shape (bs
    32, K 1,024, 8 classes shifted by 8192, 100 invalid rows) and K 4,096
    (the global-scratch route), each timed beside its bound and the plain
    version; a 1,024-box chain (1,023 links, 1,024 sweeps), a row of no
    valid box, one image; then IoUs of exactly 0.5 and of the f32 nearest
    0.3 at those thresholds and a hair below them."""
    chain_b, chain_s = _nms_random(2, 1024, 2)
    chain_b[0], chain_s[0] = _nms_chain(1024)
    invalid_b, invalid_s = _nms_random(3, 300, 3, span=300.0, classes=3)
    invalid_s[1] = -1.0
    cases = [
        (f"bs {BATCH} K 1024, 8 classes", *_nms_random(BATCH, 1024, 0, span=320.0, pad=100,
                                                        classes=8), True),
        ("bs 2 K 4096, 4 classes", *_nms_random(2, 4096, 1, pad=300, classes=4), True),
        ("a 1,024-box chain beside a random image", chain_b, chain_s, False),
        ("bs 3 K 300, row 1 all invalid", invalid_b, invalid_s, False),
        ("bs 1 K 1024, 3 classes", *_nms_random(1, 1024, 4, span=300.0, pad=7, classes=3), False),
    ]
    for label, boxes, scores, timed in cases:
        n = nms.launches
        sweeps = check_nms(boxes, scores, NMS_IOU, f"3b {label}")
        route = nms.last_route
        if nms.launches != n + 1 or route != nms_mod.route(boxes.shape[1]):
            raise AssertionError(f"3b {label}: {nms.launches - n} launches on route {route}")
        line = (f"phase 3b nms {label}: keep and sweeps equal to the plain version, route "
                f"{route}, sweeps per image {min(sweeps)}-{max(sweeps)}")
        if timed:
            ms = cuda_ms(lambda: nms(boxes, scores, NMS_IOU), 20, cover=True)
            plain = cuda_ms(lambda: nms_fixed_plain(boxes, scores, NMS_IOU), 3)
            bound_ms, bound_by = bound_of(*nms_bound(scores, sweeps, name))
            line += (f"; {ms * 1e3:.1f} us (bound {bound_ms * 1e3:.2f} us by {bound_by}, "
                     f"{bound_ms / ms * 100:.1f} % of it), plain {plain:.3f} ms")
        print(line)
    # [0, 0, 10, 10] against [0, 0, 10, 5]: IoU 0.5; [20, 0, 30, 10] against
    # [20, 0, 30, 3]: 30 / 100, the f32 nearest 0.3 (0.3 rounds up in f32)
    boxes = torch.tensor([[[0, 0, 10, 10], [0, 0, 10, 5], [20, 0, 30, 10], [20, 0, 30, 3]]],
                         dtype=torch.float32, device="cuda")
    scores = torch.tensor([[0.9, 0.8, 0.7, 0.6]], device="cuda")
    below = {t: float(np.nextafter(np.float32(t), np.float32(0))) for t in (0.5, 0.3)}
    want = {0.5: [1, 1, 1, 1], below[0.5]: [1, 0, 1, 1], 0.3: [1, 0, 1, 1],
            below[0.3]: [1, 0, 1, 0]}
    for iou, keep in want.items():
        check_nms(boxes, scores, iou, f"3b IoU at {iou!r}")
        got = nms(boxes, scores, iou)[0][0].int().tolist()
        if got != keep:
            raise AssertionError(f"3b IoU at {iou!r}: keep {got}, expected {keep}")
    print(f"phase 3b nms IoUs exactly at the threshold (0.5; the f32 nearest 0.3) and a hair "
          f"below: keep equal to the plain version and to {list(want.values())}")


# 3c: the main path's shapes (yolo-ms-xs' and YOLOv12-L's P3 map at bs 32,
# YOLOv12-L's 307-wide MLP map) in both layouts and dtypes
EPILOGUE_CASES = (
    ("P3 bs 32", (32, 256, 80, 80), torch.bfloat16, torch.channels_last, True),
    ("P3 bs 32 identity", (32, 256, 80, 80), torch.bfloat16, torch.channels_last, False),
    ("307-wide bs 32", (32, 307, 40, 40), torch.bfloat16, torch.channels_last, True),
    ("P3 bs 32 NCHW", (32, 256, 80, 80), torch.bfloat16, torch.contiguous_format, True),
    ("P3 bs 32 f32", (32, 256, 80, 80), torch.float32, torch.channels_last, True),
    ("307-wide bs 32 f32 NCHW", (32, 307, 40, 40), torch.float32, torch.contiguous_format, True),
)
# act(y + b) in f32, rounded once to y's dtype: under one rounding (2**-8
# of the value in bf16, 2**-24 in f32), with 1e-6 of the value for the
# kernel's f32 SiLU against torch's
EPILOGUE_REL = {torch.bfloat16: 2.0**-8 + 1e-6, torch.float32: 1e-6}


def phase_epilogue_vs_plain(flush: torch.Tensor, name: str) -> dict:
    """3c: ``conv_epilogue`` against ``conv_epilogue_plain`` in f32 on the
    same inputs, one launch each on the route ``expected_route`` names;
    timed beside the plain version, torch's ``add_`` + ``F.silu`` (the ops
    it replaced) and its bound (y read and written once over the memory
    rate). Returns the worst error and the first case's times."""
    import torch.nn.functional as F

    gen = torch.Generator(device="cuda")
    gen.manual_seed(3)
    mem_rate, _ = peak_rates(name)
    worst = worst_abs = 0.0
    first = None
    for label, shape, dtype, fmt, act in EPILOGUE_CASES:
        y0 = (torch.randn(shape, generator=gen, device="cuda") * 3.0).to(dtype)
        y0 = y0.contiguous(memory_format=fmt)
        bias = torch.randn(shape[1], generator=gen, device="cuda").to(dtype)
        want = conv_epilogue_plain(y0.float(), bias.float(), act)
        y, n = y0.clone(), conv_epilogue.launches
        conv_epilogue(y, bias, act)
        route = conv_epilogue.last_route
        if conv_epilogue.launches != n + 1 or route != epilogue_mod.expected_route(y0, bias):
            raise AssertionError(f"3c {label}: {conv_epilogue.launches - n} launches on route "
                                 f"{route}")
        diff = (y.float() - want).abs()
        err, abs_err = (diff / (want.abs() + 1e-6)).max().item(), diff.max().item()
        parent = conv_epilogue_plain(y0, bias, act).float()
        parent_err = ((parent - want).abs() / (want.abs() + 1e-6)).max().item()
        if not err <= EPILOGUE_REL[dtype]:
            raise AssertionError(f"3c {label}: relative error {err} against the f32 epilogue")
        worst, worst_abs = max(worst, err), max(worst_abs, abs_err)
        bias_view = bias.view(1, -1, 1, 1)
        ms = cuda_ms(lambda: conv_epilogue(y, bias, act), 20, flush, cover=True)
        plain_ms = cuda_ms(lambda: conv_epilogue_plain(y, bias, act), 20, flush, cover=True)
        library_ms = cuda_ms(
            lambda: F.silu(y.add_(bias_view)) if act else y.add_(bias_view), 20, flush,
            cover=True)
        bound_ms = 2 * y.numel() * y.element_size() / mem_rate * 1e3
        print(f"phase 3c conv_epilogue {label} {list(shape)} {str(dtype)[6:]} "
              f"{epilogue_mod.layout(y0)} {'SiLU' if act else 'identity'}: route {route}, "
              f"relative error {err:.2e} (torch's ops in {str(dtype)[6:]} {parent_err:.2e}); "
              f"{ms * 1e3:.1f} us (bound {bound_ms * 1e3:.1f} us by bytes, "
              f"{bound_ms / ms * 100:.0f} % of it; L2 flushed by a write), plain "
              f"{plain_ms * 1e3:.1f} us, add_ + F.silu {library_ms * 1e3:.1f} us")
        if first is None:
            first = {"ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
                     "bound_ms": bound_ms}
    return {"err": worst, "abs_err": worst_abs, **first}


# the card tests that need two cards, deselected on a machine with one
TWO_CARD_TESTS = "another_card"


def phase_cuda_tests() -> None:
    """The card-only tests (``cuda`` marker) in a child pytest; it imports no
    JAX, so it runs without the repo's conftest. With one card the tests
    that need two (``TWO_CARD_TESTS``) are deselected, and the line says
    so; any skip fails the phase."""
    one_card = torch.cuda.device_count() < 2
    proc = subprocess.run(
        [sys.executable, "-m", "pytest", "--noconftest", "-q", "-p", "no:cacheprovider",
         "-m", "cuda", *(("-k", f"not {TWO_CARD_TESTS}") if one_card else ()),
         os.path.join("tests", "test_torch_cuda.py")],
        cwd=ROOT, capture_output=True, text=True, timeout=600,
    )
    lines = proc.stdout.strip().splitlines()
    summary = lines[-1] if lines else "no output"
    if proc.returncode != 0 or "skipped" in summary or "passed" not in summary:
        raise AssertionError(f"tests/test_torch_cuda.py: rc {proc.returncode}, {summary}\n"
                             f"{proc.stdout[-4000:]}{proc.stderr[-2000:]}")
    print(f"phase 3 tests/test_torch_cuda.py on the card: {summary}"
          + (f" (one card: the tests matching {TWO_CARD_TESTS!r} deselected)" if one_card
             else ""))


# ---------------------------------------------------------------- phase 4


def _iou(a, b):
    ix1, iy1 = max(a[0], b[0]), max(a[1], b[1])
    ix2, iy2 = min(a[2], b[2]), min(a[3], b[3])
    inter = max(0.0, ix2 - ix1) * max(0.0, iy2 - iy1)
    ua = (a[2] - a[0]) * (a[3] - a[1]) + (b[2] - b[0]) * (b[3] - b[1]) - inter
    return inter / max(ua, 1e-9)


def match_golden(got: list, golden: list, iou_min: float = 0.9, score_tol: float = 0.02) -> None:
    """The rule of tests/test_trained_golden.py: same count; each golden
    detection matched once by class, IoU > 0.9 and score within 0.02."""
    if len(got) != len(golden):
        raise AssertionError(f"{len(got)} detections, golden has {len(golden)}")
    unmatched = list(got)
    for g in golden:
        hit = next(
            (
                d
                for d in unmatched
                if d["class_id"] == g["class_id"]
                and _iou(d["box_xyxy"], g["box_xyxy"]) > iou_min
                and abs(d["score"] - g["score"]) < score_tol
            ),
            None,
        )
        if hit is None:
            raise AssertionError(f"golden detection unmatched: {g} in {got}")
        unmatched.remove(hit)


def phase_goldens() -> None:
    """Both trained goldens through the card's Predictor (f32, TF32 off) in
    each entry layout, ``auto`` (channels-last, the default) and
    ``default`` (NCHW), matched against their checked-in detections; then
    the card's raw maps on the same decoded image against the CPU's (NCHW),
    within MAPS_ATOL. Each NMS launch (K 525, the 160 px anchors) is held
    against the plain version (``NmsSpy``)."""
    nspy = NmsSpy()
    for arch, gdir in GOLDENS:
        state_dict = load_npz(os.path.join(gdir, "weights.npz"))
        fixture = os.path.join(gdir, "fixture_000.png")
        with open(os.path.join(gdir, "fixture_000_detections.json")) as f:
            golden = json.load(f)
        image = torch.from_numpy(decode_and_resize(fixture, 160, 160)[None])
        cpu_model = build_model(arch, num_classes=3, device="cpu", deploy=True)
        cpu_model.load_state_dict(fold_batchnorm(state_dict), strict=True)
        with torch.inference_mode():
            want = cpu_model(_nchw(image))
        for layout in ENTRY_LAYOUTS:
            predictor = Predictor(
                arch,
                state_dict,
                num_classes=3,
                input_size=(160, 160),
                conf_thresh=0.25,
                iou_thresh=0.45,
                dtype=torch.float32,
                entry_layouts=layout,
                device="cuda",
            )
            if predictor.serve.memory_format != LAYOUT_FORMATS[layout]:
                raise AssertionError(f"4 {arch} {layout}: the network runs in "
                                     f"{predictor.serve.memory_format}")
            nspy.label = f"4 {arch} {layout}"
            with tempfile.TemporaryDirectory() as out_dir, nspy.on():
                results = predictor.predict_paths(fixture, out_dir, verbose=False)
                if not os.path.exists(os.path.join(out_dir, "fixture_000_detected.jpg")):
                    raise AssertionError("drawn fixture missing")
            got = next(iter(results.values()))
            match_golden(got, golden)

            x = image.cuda()
            with torch.inference_mode():
                with full_f32():
                    card = predictor.model(predictor.serve.network_input(x))
                card_default = predictor.model(predictor.serve.network_input(x))

            def max_err(maps):
                return max((m.cpu() - w).abs().max().item() for m, w in zip(maps, want))

            err = max_err(card)
            if not err <= MAPS_ATOL:
                raise AssertionError(f"{arch} {layout}: card raw maps differ from the CPU's "
                                     f"by {err}")
            decoder = "native loader" if native_loader.available() else "cv2"
            print(f"phase 4 golden {arch} entry_layouts={layout} "
                  f"({memory_format_name(predictor.serve.memory_format)}): {len(got)} "
                  f"detections match "
                  f"(scores {[d['score'] for d in got]}, decoded by {decoder}); NMS at K "
                  f"{nspy.inputs[nspy.label][0].shape[1]} equal to the plain version at conf "
                  f"0.25 ({nspy.sweeps[nspy.label]} sweeps); "
                  f"raw maps card vs CPU max abs err {err:.3e} with TF32 off, "
                  f"{max_err(card_default):.3e} at the default conv precision "
                  f"({torch.backends.cudnn.conv.fp32_precision})")


def _nchw(images_u8: torch.Tensor, dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """What ``Predictor(entry_layouts="default").infer`` feeds the network:
    normalized, contiguous NCHW."""
    return device_normalize_images(images_u8, dtype).permute(0, 3, 1, 2).contiguous()


# ---------------------------------------------------------------- phase 5


def seeded_state_dict(arch: str, num_classes: int, seed: int) -> dict:
    """Random weights made from a seed with numpy, in flax layout, through
    the converter: lecun-normal kernels, BN near identity, prior biases of
    the head's pred convs kept."""
    model = build_model(arch, num_classes=num_classes, device="cpu")
    variables = state_dict_to_variables(model.state_dict())
    rng = np.random.default_rng(seed)

    def fill(tree, path):
        for key, value in tree.items():
            if isinstance(value, dict):
                fill(value, path + [key])
                continue
            shape = value.shape
            if key == "kernel":
                fan_in = int(np.prod(shape[:3]))
                new = rng.standard_normal(shape) / np.sqrt(fan_in)
            elif key in ("scale", "var"):
                new = rng.uniform(0.8, 1.2, shape)
            elif key == "mean" or (key == "bias" and path[-1] != "pred"):
                new = rng.normal(0.0, 0.05, shape)
            else:
                new = value  # pred bias: detection prior
            tree[key] = np.asarray(new, np.float32)

    fill(variables, [])
    return variables_to_state_dict(variables)


def serve_batches() -> list:
    """Phase 5's SERVE_BATCHES uint8 batches, made from a seed."""
    rng = np.random.default_rng(2)
    return [
        rng.integers(0, 256, (BATCH, IMG, IMG, 3), dtype=np.uint8)
        for _ in range(SERVE_BATCHES)
    ]


class SelectSpy:
    """While ``on``: every ``select_scales`` call of the post-process (one
    kernel launch) is held against ``select_scales_plain`` on the same maps
    (``check_select``) and its copy routes against ``expected_routes`` (and,
    where ``only`` names one for the layout, against that route alone); its
    routes and error are kept under ``layout``. The plain version launches
    no kernel, so the count is unchanged."""

    def __init__(self, only: dict | None = None):
        self.layout = None
        self.only = only or {}
        self.calls = {}

    @contextlib.contextmanager
    def on(self):
        real = postprocess_mod.select_scales

        def spy(pairs, reg_max=REG_MAX):
            before = select.launches
            got = real(pairs, reg_max)
            if select.launches != before + 1:
                raise AssertionError(f"{self.layout}: a select call launched "
                                     f"{select.launches - before} kernels")
            routes = check_routes(pairs, f"{self.layout} served maps",
                                  self.only.get(self.layout))
            err = check_select(got, select_scales_plain(pairs, reg_max), pairs[0][0].dtype,
                               f"{self.layout} served maps")
            self.calls.setdefault(self.layout, []).append((routes, err))
            return got

        postprocess_mod.select_scales = spy
        try:
            yield self
        finally:
            postprocess_mod.select_scales = real


def conv_layout_audit(predictor: Predictor, x_u8: torch.Tensor) -> tuple[list, list]:
    """One forward with a hook on every ``Conv2d``: the names of the convs
    whose input, and whose output, is not channels-last memory."""
    strided_in, strided_out = [], []

    def check(name):
        def hook(module, args, out):
            if not args[0].is_contiguous(memory_format=torch.channels_last):
                strided_in.append(name)
            if not out.is_contiguous(memory_format=torch.channels_last):
                strided_out.append(name)
        return hook

    hooks = [m.register_forward_hook(check(n)) for n, m in predictor.model.named_modules()
             if isinstance(m, torch.nn.Conv2d)]
    try:
        with torch.inference_mode():
            predictor.model(predictor.serve.network_input(x_u8), split_head=True)
    finally:
        for h in hooks:
            h.remove()
    return strided_in, strided_out


def conv_layout_costs(predictor: Predictor, x_u8: torch.Tensor, top: int = 4) -> dict:
    """Each distinct conv of the model (input shape, weight shape, stride,
    groups) timed alone in both layouts on a random input of its shape: the
    weight and input contiguous NCHW, then both channels-last (CUDA events,
    median of 5, the bias and activation left out). Returns both sums over
    every conv of one forward and the ``top`` convs where channels-last
    loses and gains most, by the first module name with that shape."""
    seen = {}

    def record(name):
        def hook(module, args, out):
            key = (tuple(args[0].shape), tuple(module.weight.shape), module.stride,
                   module.padding, module.groups)
            seen.setdefault(key, [name, module, 0])[2] += 1
        return hook

    hooks = [m.register_forward_hook(record(n)) for n, m in predictor.model.named_modules()
             if isinstance(m, torch.nn.Conv2d)]
    try:
        with torch.inference_mode():
            predictor.model(predictor.serve.network_input(x_u8), split_head=True)
    finally:
        for h in hooks:
            h.remove()
    rows, totals = [], {"nchw": 0.0, "channels_last": 0.0}
    gen = torch.Generator(device="cuda")
    gen.manual_seed(3)
    with torch.inference_mode():
        for (shape, _, stride, padding, groups), (name, module, calls) in seen.items():
            w = module.weight
            x = torch.randn(shape, generator=gen, device="cuda").to(w.dtype)
            ms = {}
            for fmt, key in ((torch.contiguous_format, "nchw"), (torch.channels_last,
                                                                 "channels_last")):
                xf, wf = x.contiguous(memory_format=fmt), w.contiguous(memory_format=fmt)
                ms[key] = cuda_ms(lambda: torch.nn.functional.conv2d(
                    xf, wf, None, stride, padding, 1, groups), 5)
                totals[key] += ms[key] * calls
            kind = (f"{'dw' if groups > 1 else 'dense'} k{w.shape[2]} s{stride[0]} "
                    f"{shape[1]}->{w.shape[0]} @{shape[2]}x{shape[3]}")
            rows.append((ms["channels_last"] - ms["nchw"], name, kind, calls, ms))
    rows.sort(key=lambda r: -r[0])
    return {"convs": sum(r[3] for r in rows), "distinct": len(rows), "totals": totals,
            "losses": [r for r in rows[:top] if r[0] > 0],
            "gains": [r for r in rows[::-1][:top] if r[0] < 0]}


def forward_kernels(fn, top: int = 6) -> dict:
    """``torch.profiler`` over one call of ``fn`` (after one unprofiled
    call): the device kernels, their time, the layout transposes among them
    (``TRANSPOSE_KERNELS``) and the ``top`` kernels by time. Where the
    profiler records no device time, the counts read 0."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kernels = [(ev.key, ev.self_device_time_total, ev.count) for ev in prof.key_averages()
               if ev.device_type == DeviceType.CUDA]
    moves = [k for k in kernels if TRANSPOSE_KERNELS.search(k[0])]
    kernels.sort(key=lambda k: -k[1])
    return {"kernels": sum(k[2] for k in kernels), "busy_ms": sum(k[1] for k in kernels) / 1e3,
            "transposes": sum(k[2] for k in moves), "transpose_ms": sum(k[1] for k in moves) / 1e3,
            "transpose_names": sorted({k[0][:60] for k in moves}),
            "top": [(k[0][:70], k[1] / 1e3, k[2]) for k in kernels[:top]]}


def epilogues_in_profile(fn) -> int:
    """The epilogue kernels (``epilogue.py:KERNEL``) that ``torch.profiler``
    records on the card in one call of ``fn``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(ev.count for ev in prof.key_averages()
               if ev.device_type == DeviceType.CUDA and epilogue_mod.KERNEL.search(ev.key))


def serve_model(arch: str, flush: torch.Tensor) -> dict:
    """Phase 5 for one model: served by ``Predictor(entry_layouts="auto")``
    (the main path) and ``"default"`` in turns on the same batches."""
    state_dict = seeded_state_dict(arch, NC, seed=1)
    predictors = {
        layout: Predictor(arch, state_dict, num_classes=NC, input_size=(IMG, IMG),
                          conf_thresh=1e-5, batch_size=BATCH, dtype=torch.bfloat16,
                          entry_layouts=layout, device="cuda")
        for layout in ENTRY_LAYOUTS
    }
    for layout, p in predictors.items():
        if p.serve.memory_format != LAYOUT_FORMATS[layout]:
            raise AssertionError(f"{arch} {layout}: the network runs in {p.serve.memory_format}")
    batches = serve_batches()
    for p in predictors.values():
        p.predict_batch(batches[0])  # warm-up (cuDNN plans, kernel load)

    # counted main-path run: every count at 0 just before, read just after.
    # The first pass holds every select launch against the plain version on
    # the same maps; the second is timed. Each batch is served by both
    # layouts in turns (the order flips from batch to batch).
    zero_counts()
    nms_fixed.sweeps = 0
    tally = dict(graphs.tally)  # the warm-up captured each layout's forward
    spy = SelectSpy(only={"auto": MAIN_PATH_ROUTE})
    nspy = NmsSpy()
    host_ms = {layout: [] for layout in ENTRY_LAYOUTS}
    launches = dict.fromkeys(ENTRY_LAYOUTS, 0)
    for checked in (True, False):
        with contextlib.ExitStack() as spies:
            if checked:
                spies.enter_context(spy.on())
                spies.enter_context(nspy.on())
                spies.enter_context(profiler.recording())  # nms_fixed.sweeps tallies
            for i, imgs in enumerate(batches):
                for layout in ENTRY_LAYOUTS[:: 1 if i % 2 == 0 else -1]:
                    spy.layout = nspy.label = layout
                    n = counts()
                    t0 = time.perf_counter()
                    out = predictors[layout].predict_batch(imgs)
                    if not checked:
                        host_ms[layout].append((time.perf_counter() - t0) * 1e3)
                    if launched(f"{arch} {layout}", n) != 1:
                        raise AssertionError(f"{arch} {layout}: {select.launches - n[0]} select "
                                             f"launches in one batch")
                    launches[layout] += 1
                    check_outputs(out, f"{arch} {layout}")
    total, sweeps = launched(arch), int(nms_fixed.sweeps)
    if total != 2 * len(ENTRY_LAYOUTS) * SERVE_BATCHES:
        raise AssertionError(f"{arch}: select launched {total} times in "
                             f"{2 * len(ENTRY_LAYOUTS) * SERVE_BATCHES} batches")
    replays = {k: graphs.tally[k] - tally[k] for k in tally}
    if replays != {"captures": 0, "replays": total}:
        raise AssertionError(f"{arch}: {replays} in {total} batches of one shape, where every "
                             "forward replays its graph")
    # the epilogue inside the replayed graph: one kernel a deploy conv, no
    # launch from Python
    replayed_epilogues = {}
    for layout, p in predictors.items():
        n = conv_epilogue.launches
        found = epilogues_in_profile(lambda: p.infer(torch.from_numpy(batches[0]).cuda()))
        if found != deploy_convs(p.model) or conv_epilogue.launches != n:
            raise AssertionError(f"{arch} {layout}: {found} epilogue kernels in a replay of "
                                 f"{deploy_convs(p.model)} deploy convs, "
                                 f"{conv_epilogue.launches - n} launched from Python")
        replayed_epilogues[layout] = found
    checked_routes = {layout: sorted({_route_names(r) for r, _ in calls})
                      for layout, calls in spy.calls.items()}
    checked_err = max(err for calls in spy.calls.values() for _, err in calls)

    x_u8 = torch.from_numpy(batches[0]).cuda()
    kw = dict(conf_thresh=1e-5, pre_nms_topk=1024, max_det=300)
    with torch.inference_mode():
        # auto's raw maps against default's, on the same batch
        maps = {}
        for layout, p in predictors.items():
            raw = p.model(p.serve.network_input(x_u8), split_head=True)
            maps[layout] = [(b.permute(0, 2, 3, 1), c.permute(0, 2, 3, 1)) for b, c in raw]
        maps_rel = max(
            (a.float() - d.float()).abs().max().item() / d.float().abs().max().item()
            for pa, pd in zip(maps["auto"], maps["default"]) for a, d in zip(pa, pd))
        if not maps_rel <= LAYOUT_MAPS_REL:
            raise AssertionError(f"{arch}: auto's raw maps differ from default's by {maps_rel} "
                                 f"of their largest value")
        if not all(m.is_contiguous() for pair in maps["auto"] for m in pair):
            raise AssertionError(f"{arch}: auto's head maps are not contiguous NHWC")

        # the kernel tail against the plain tail, on the same f32 maps (auto's)
        tail_err = check_tail(maps["auto"], NC, arch)

        # where the batch time goes (device time, CUDA events), each layout
        # in turns: auto, default, default, auto; the tail and infer also
        # with the plain NMS loop (the tail the kernel replaced)
        parts = {layout: {key: [] for key in ("fwd_ms", "post_ms", "infer_ms", "post_plain_ms",
                                              "infer_plain_ms")}
                 for layout in ENTRY_LAYOUTS}
        for layout in ENTRY_LAYOUTS + ENTRY_LAYOUTS[::-1]:
            p, part = predictors[layout], parts[layout]
            part["fwd_ms"].append(cuda_ms(
                lambda: p.model(p.serve.network_input(x_u8), split_head=True), 5))
            part["post_ms"].append(cuda_ms(lambda: fused_postprocess(maps[layout], NC, **kw), 5))
            part["infer_ms"].append(cuda_ms(lambda: p.infer(x_u8), 5))
            with plain_nms():
                part["post_plain_ms"].append(
                    cuda_ms(lambda: fused_postprocess(maps[layout], NC, **kw), 5))
                part["infer_plain_ms"].append(cuda_ms(lambda: p.infer(x_u8), 5))
        profiles = {layout: forward_kernels(
            lambda: p.model(p.serve.network_input(x_u8), split_head=True))
            for layout, p in predictors.items()}
        audit = conv_layout_audit(predictors["auto"], x_u8)
        conv_costs = conv_layout_costs(predictors["default"], x_u8)

        # the select kernel on each layout's maps, one launch per batch,
        # against its bound; on the main path's (auto) also each scale alone,
        # the plain version and the host's enqueue
        name = torch.cuda.get_device_name(0)
        sel = {}
        for layout in ENTRY_LAYOUTS:
            pairs = [(b.flatten(1, 2), c.flatten(1, 2)) for b, c in maps[layout]]
            err, routes, _ = compare_select(pairs, torch.bfloat16, f"{arch} {layout} maps")
            bytes_ms, ops_ms = select_bound(pairs, name)
            one = lambda: select_scales(pairs, REG_MAX)  # noqa: E731
            sel[layout] = {"ms": cuda_ms(one, 20, flush, cover=True), "bytes_ms": bytes_ms,
                           "ops_ms": ops_ms, "err": err, "routes": routes}
            if layout == "auto":
                sel[layout].update({
                    "clean_ms": cuda_ms(one, 20, flush, clean=True, cover=True),
                    "warm_ms": cuda_ms(one, 20, cover=True),
                    "plain_ms": cuda_ms(lambda: select_scales_plain(pairs, REG_MAX), 20, flush,
                                        cover=True),
                    "host_us": host_us(one),
                })
                scales = []
                for box, cls in pairs:
                    bytes_ms, ops_ms = select_bound([(box, cls)], name)
                    scales.append({
                        "hw": box.shape[1],
                        "ms": cuda_ms(lambda: select(box, cls, REG_MAX), 20, flush, cover=True),
                        "plain_ms": cuda_ms(lambda: select_plain(box, cls, REG_MAX), 20, flush,
                                            cover=True),
                        "bytes_ms": bytes_ms,
                        "ops_ms": ops_ms,
                    })
        # the NMS kernel on the main path's last input (auto's last batch)
        nb, ns, niou = nspy.inputs["auto"]
        n_sweeps = check_nms(nb, ns, niou, f"{arch} auto nms")
        bytes_ms, ops_ms = nms_bound(ns, n_sweeps, name)
        nms_t = {"ms": cuda_ms(lambda: nms(nb, ns, niou), 20, cover=True),
                 "plain_ms": cuda_ms(lambda: nms_fixed_plain(nb, ns, niou), 5),
                 "host_us": host_us(lambda: nms(nb, ns, niou)), "bytes_ms": bytes_ms,
                 "ops_ms": ops_ms, "sweeps": max(n_sweeps), "k": nb.shape[1],
                 "route": nms.last_route, "valid": int((ns > 0).sum())}
    h2d_ms = cuda_ms(lambda: torch.from_numpy(batches[0]).to("cuda"), 5)
    layouts = {
        layout: {"host_ms": statistics.median(host_ms[layout]),
                 "fwd_ms": statistics.median(parts[layout]["fwd_ms"]),
                 "post_ms": statistics.median(parts[layout]["post_ms"]),
                 "infer_ms": statistics.median(parts[layout]["infer_ms"]),
                 "post_plain_ms": statistics.median(parts[layout]["post_plain_ms"]),
                 "infer_plain_ms": statistics.median(parts[layout]["infer_plain_ms"]),
                 "nms_sweeps": nspy.sweeps[layout],
                 "parts": parts[layout], "launches": launches[layout],
                 "checked_routes": checked_routes[layout], "kernels": profiles[layout],
                 "select": sel[layout]}
        for layout in ENTRY_LAYOUTS
    }
    auto = layouts["auto"]
    return {
        "arch": arch, "launches": total, "sweeps": sweeps, "host_ms": auto["host_ms"],
        "replayed_epilogues": replayed_epilogues,
        "img_s": BATCH / auto["host_ms"] * 1e3, "fwd_ms": auto["fwd_ms"],
        "post_ms": auto["post_ms"], "infer_ms": auto["infer_ms"], "h2d_ms": h2d_ms,
        "select": sel["auto"], "scales": scales, "tail_err": tail_err, "maps_rel": maps_rel,
        "nms": nms_t,
        "checked_err": checked_err, "audit": audit, "layouts": layouts,
        "conv_costs": conv_costs,
        "predictor": predictors["auto"], "state_dict": state_dict,
    }


def check_tail(maps, nc: int, label: str) -> float:
    """The kernel tail against the plain tail on the same maps taken to f32
    (phase 5's settings): ``valid`` and ``classes`` equal, scores within
    rtol 1e-5, boxes within 1e-3 px; returns the worst box error."""
    kw = dict(conf_thresh=1e-5, pre_nms_topk=1024, max_det=300)
    maps32 = [(b.float(), c.float()) for b, c in maps]
    got = fused_postprocess(maps32, nc, **kw)
    want = fused_postprocess(maps32, nc, use_kernel=False, **kw)
    v = want["valid"]
    if not (torch.equal(got["valid"], v) and torch.equal(got["classes"][v], want["classes"][v])):
        raise AssertionError(f"{label}: kernel tail and plain tail disagree on valid/classes")
    if not torch.allclose(got["scores"][v], want["scores"][v], rtol=1e-5, atol=0.0):
        raise AssertionError(f"{label}: kernel tail scores differ")
    if not torch.allclose(got["boxes"][v], want["boxes"][v], rtol=0.0, atol=1e-3):
        raise AssertionError(f"{label}: kernel tail boxes differ")
    return (got["boxes"][v] - want["boxes"][v]).abs().max().item()


# 5b: LVIS v1's class count at the flagship's full width. In f32 its tiles
# fit no ring of shared memory (select's wide route); in bf16 they do.
WIDE_NC = 1203
WIDE_BATCHES = 4  # of phase 5's batches, per pass and dtype
# 5c: the fine-tune configuration, yolo_ms_tpu/configs/finetune_example.yaml
# (yolov8-n, 10 classes, 640x640); its pretrained path is a placeholder, so
# the weights are seeded as 5b's
FINETUNE_ARCH, FINETUNE_NC = "yolov8-n", 10


def serve_classes(arch: str, nc: int, phase: str, flush: torch.Tensor, name: str) -> dict:
    """5b and 5c: ``arch`` with ``nc`` classes, bs 32, 640², seeded weights,
    BN-folded, conf 1e-5, through ``Predictor(entry_layouts="auto")`` in
    bf16 and then in f32 (TF32 off), each a counted run of two passes over
    WIDE_BATCHES batches: the first holds every ``select`` launch against
    ``select_scales_plain`` on the maps it served and its routes against
    ``expected_routes`` and, on every map, bulk rows where a ring fits
    (``plan_fits``) and the wide route where none does; the second is
    timed; every NMS launch of the first is held against the plain version
    (``NmsSpy``). Then the kernel tail against the plain tail, and
    ``select`` on one batch's maps with L2 flushed by a write beside its
    bound and the plain version; one line per dtype."""
    state_dict = seeded_state_dict(arch, nc, seed=1)
    batches = serve_batches()[:WIDE_BATCHES]
    runs = {}
    for dtype in (torch.bfloat16, torch.float32):
        label = f"{phase} {str(dtype)[6:]}"
        predictor = Predictor(arch, state_dict, num_classes=nc, input_size=(IMG, IMG),
                              conf_thresh=1e-5, batch_size=BATCH, dtype=dtype,
                              entry_layouts="auto", device="cuda")
        predictor.predict_batch(batches[0])  # warm-up
        only = MAIN_PATH_ROUTE if select_mod.plan_fits(dtype, nc, REG_MAX) else "wide"
        spy = SelectSpy(only={label: only})
        nspy = NmsSpy()
        spy.layout = nspy.label = label
        host_ms = []
        zero_counts()
        for checked in (True, False):
            with contextlib.ExitStack() as spies:
                if checked:
                    spies.enter_context(spy.on())
                    spies.enter_context(nspy.on())
                for imgs in batches:
                    n = counts()
                    t0 = time.perf_counter()
                    out = predictor.predict_batch(imgs)
                    if not checked:
                        host_ms.append((time.perf_counter() - t0) * 1e3)
                    if launched(label, n) != 1:
                        raise AssertionError(f"{label}: {select.launches - n[0]} select launches "
                                             f"in one batch")
                    check_outputs(out, label, nc)
        launches = launched(label)
        if launches != 2 * WIDE_BATCHES:
            raise AssertionError(f"{label}: select launched {launches} times in "
                                 f"{2 * WIDE_BATCHES} batches")
        x_u8 = torch.from_numpy(batches[0]).cuda()
        precision = full_f32() if dtype == torch.float32 else contextlib.nullcontext()
        with torch.inference_mode():
            with precision:
                raw = predictor.model(predictor.serve.network_input(x_u8), split_head=True)
            maps = [(b.permute(0, 2, 3, 1), c.permute(0, 2, 3, 1)) for b, c in raw]
            tail_err = check_tail(maps, nc, label)
            pairs = [(b.flatten(1, 2), c.flatten(1, 2)) for b, c in maps]
            err, routes, _ = compare_select(pairs, dtype, f"{label} maps")
            bytes_ms, ops_ms = select_bound(pairs, name)
            runs[str(dtype)[6:]] = {
                "host_ms": statistics.median(host_ms), "launches": launches,
                "checked_routes": sorted({_route_names(r) for r, _ in spy.calls[label]}),
                "checked_err": max(e for _, e in spy.calls[label]), "tail_err": tail_err,
                "nms_sweeps": nspy.sweeps[label],
                "err": err, "routes": routes, "bytes_ms": bytes_ms, "ops_ms": ops_ms,
                "ms": cuda_ms(lambda: select_scales(pairs, REG_MAX), 20, flush, cover=True),
                "plain_ms": cuda_ms(lambda: select_scales_plain(pairs, REG_MAX), 5, flush,
                                    cover=True),
            }
        del predictor, raw, maps, pairs
    for dt, w in runs.items():
        bound_ms, bound_by = bound_of(w["bytes_ms"], w["ops_ms"])
        print(f"phase {phase} serve {arch} nc={nc} bs={BATCH} {IMG}px {dt}"
              f"{' (TF32 off)' if dt == 'float32' else ''} entry_layouts=auto: "
              f"{w['host_ms']:.3f} ms/batch predict_batch (host clock, median of "
              f"{WIDE_BATCHES}), {BATCH / w['host_ms'] * 1e3:.1f} img/s; select and nms launches "
              f"{w['launches']} each in {2 * WIDE_BATCHES} batches, each equal to the plain version "
              f"(worst ltrb err {w['checked_err']:.3e}; NMS sweeps per checked batch "
              f"{w['nms_sweeps']}, keep and sweeps exact at conf 1e-5 and 0.25), routes "
              f"{', '.join(w['checked_routes'])}; "
              f"kernel-vs-plain tail box err {w['tail_err']:.3e}; select on one batch's maps "
              f"{w['ms'] * 1e3:.1f} us with L2 flushed by a write (bound {bound_ms * 1e3:.1f} us "
              f"by {bound_by}, {bound_ms / w['ms'] * 100:.0f} % of it; routes "
              f"{_route_names(w['routes'])}), plain {w['plain_ms'] * 1e3:.1f} us")
    return {"launches": sum(r["launches"] for r in runs.values()),
            "err": max(max(r["err"], r["checked_err"]) for r in runs.values()), "runs": runs}


def _ms_pair(values) -> str:
    return " / ".join(f"{v:.3f}" for v in values)


def print_serving(r: dict) -> None:
    """Phase 5's lines for one model: each layout's batch, the layouts
    against each other, the conv audit, and the select kernel."""
    for layout, lr in r["layouts"].items():
        sel, k = lr["select"], lr["kernels"]
        bound_ms, bound_by = bound_of(sel["bytes_ms"], sel["ops_ms"])
        busy = f"{k['busy_ms']:.3f} ms" if k["busy_ms"] else "not measured"
        print(
            f"phase 5 serve {r['arch']} bs={BATCH} {IMG}px bf16 entry_layouts={layout} "
            f"({memory_format_name(LAYOUT_FORMATS[layout])}): {lr['host_ms']:.3f} ms/batch "
            f"predict_batch "
            f"(host clock, median of {SERVE_BATCHES}), {BATCH / lr['host_ms'] * 1e3:.1f} img/s; "
            f"device (CUDA events, median of 2, in turns): infer {lr['infer_ms']:.3f} ms "
            f"({_ms_pair(lr['parts']['infer_ms'])}) = normalize+forward {lr['fwd_ms']:.3f} ms "
            f"({_ms_pair(lr['parts']['fwd_ms'])}) + post-process {lr['post_ms']:.3f} ms "
            f"({_ms_pair(lr['parts']['post_ms'])}); with the plain NMS loop in the same turns: "
            f"infer {lr['infer_plain_ms']:.3f} ms ({_ms_pair(lr['parts']['infer_plain_ms'])}), "
            f"post-process {lr['post_plain_ms']:.3f} ms "
            f"({_ms_pair(lr['parts']['post_plain_ms'])}); NMS sweeps per checked batch "
            f"{lr['nms_sweeps']}; select and nms launches {lr['launches']} in "
            f"{2 * SERVE_BATCHES} batches, each equal to the plain version, routes "
            f"{', '.join(lr['checked_routes'])}; select {sel['ms'] * 1e3:.1f} us on these maps "
            f"(L2 flushed by a write; bound {bound_ms * 1e3:.1f} us by {bound_by}, "
            f"{bound_ms / sel['ms'] * 100:.0f} % of it); one forward profiled: {k['kernels']} "
            f"kernels, {busy} of kernel time, {k['transposes']} layout transposes "
            f"({k['transpose_ms']:.3f} ms: {', '.join(k['transpose_names']) or 'none'}); top "
            f"kernels: " + "; ".join(f"{n} {t:.3f} ms x{c}" for n, t, c in k["top"]))
    strided_in, strided_out = r["audit"]
    print(f"phase 5 layouts {r['arch']}: auto's raw maps vs default's max |diff| / max |default| "
          f"{r['maps_rel']:.3e} (bound {LAYOUT_MAPS_REL}); auto's maps contiguous NHWC; convs "
          f"under auto whose output is not channels-last: {strided_out or 'none'}; whose input "
          f"is not: {strided_in or 'none'}; uint8 H2D {r['h2d_ms']:.3f} ms; NMS sweeps "
          f"{r['sweeps']} ({r['sweeps'] / (2 * SERVE_BATCHES):.1f}/batch of the checked pass, "
          f"the device tally); "
          f"select and nms launches {r['launches']} each, every nms launch equal to the plain "
          f"version at conf 1e-5 and 0.25, worst ltrb err against plain {r['checked_err']:.3e}; "
          f"kernel-vs-plain tail box err {r['tail_err']:.3e}; epilogue kernels in one replayed "
          f"call (profile) {r['replayed_epilogues']}, one a deploy conv")
    t = r["nms"]
    bound_ms, bound_by = bound_of(t["bytes_ms"], t["ops_ms"])
    print(f"phase 5 nms {r['arch']} main path (auto's last batch: bs {BATCH}, K {t['k']}, "
          f"{t['valid']} valid boxes, {t['sweeps']} sweeps, route {t['route']}): one launch "
          f"{t['ms'] * 1e3:.1f} us (CUDA events behind a spin kernel; bound {bound_ms * 1e3:.2f} "
          f"us by {bound_by}, {bound_ms / t['ms'] * 100:.1f} % of it; bytes alone "
          f"{t['bytes_ms'] * 1e3:.2f} us); plain loop {t['plain_ms']:.3f} ms; host "
          f"{t['host_us']:.1f} us to enqueue one call")
    c = r["conv_costs"]

    def conv_row(row):
        diff, name, kind, calls, ms = row
        return (f"{name} ({kind}, x{calls}): NCHW {ms['nchw']:.3f} ms, channels-last "
                f"{ms['channels_last']:.3f} ms")

    print(f"phase 5 convs {r['arch']}: the {c['convs']} convs of one forward ({c['distinct']} "
          f"distinct) timed alone, each layout in turn (CUDA events, median of 5, no bias or "
          f"activation): sum NCHW {c['totals']['nchw']:.3f} ms, channels-last "
          f"{c['totals']['channels_last']:.3f} ms; channels-last loses most at: "
          + ("; ".join(conv_row(x) for x in c["losses"]) or "none") + "; gains most at: "
          + ("; ".join(conv_row(x) for x in c["gains"]) or "none"))
    sel = r["select"]
    bound_ms, bound_by = bound_of(sel["bytes_ms"], sel["ops_ms"])
    per_scale = ", ".join(
        "HW {}: {:.1f} us (bound {:.1f} us by {}, plain {:.1f} us)".format(
            s["hw"], s["ms"] * 1e3, bound_of(s["bytes_ms"], s["ops_ms"])[0] * 1e3,
            bound_of(s["bytes_ms"], s["ops_ms"])[1], s["plain_ms"] * 1e3)
        for s in r["scales"]
    )
    print(
        f"phase 5 select {r['arch']} main path (auto maps): one launch per batch "
        f"{sel['ms'] * 1e3:.1f} us with L2 flushed by a write, {sel['clean_ms'] * 1e3:.1f} us "
        f"flushed by a read, {sel['warm_ms'] * 1e3:.1f} us unflushed (bound "
        f"{bound_ms * 1e3:.1f} us by {bound_by}, {bound_ms / sel['ms'] * 100:.0f} / "
        f"{bound_ms / sel['clean_ms'] * 100:.0f} / {bound_ms / sel['warm_ms'] * 100:.0f} % of "
        f"it; plain {sel['plain_ms'] * 1e3:.1f} us; host {sel['host_us']:.1f} us to enqueue one "
        f"call; routes {_route_names(sel['routes'])}); each scale alone: {per_scale}"
    )


def check_outputs(out: dict, arch: str, nc: int = NC) -> None:
    shapes = {"boxes": (BATCH, 300, 4), "scores": (BATCH, 300),
              "classes": (BATCH, 300), "valid": (BATCH, 300)}
    for key, shape in shapes.items():
        if out[key].shape != shape:
            raise AssertionError(f"{arch}: {key} shape {out[key].shape} != {shape}")
    if not (np.isfinite(out["boxes"]).all() and np.isfinite(out["scores"]).all()):
        raise AssertionError(f"{arch}: non-finite outputs")
    if not out["valid"].any():
        raise AssertionError(f"{arch}: no detections at conf 1e-5")
    s = out["scores"][out["valid"]]
    c = out["classes"][out["valid"]]
    if not ((s > 0).all() and (s <= 1).all() and (c >= 0).all() and (c < nc).all()):
        raise AssertionError(f"{arch}: scores or classes out of range")


# ---------------------------------------------------------------- phase 6

# 6a: one f32 step of the golden yolov8-n on the card against the CPU's
STEP_LOSS_RTOL = 1e-4
STEP_STATE_TOL = dict(rtol=1e-3, atol=1e-5)
# 6b: the learning recipe of tests/test_learning.py
LEARN_EPOCHS = 60
LEARN_MAP_MIN = 0.5
LEARN_REFERENCE_MAP = 0.94  # the JAX package's result on this recipe (its test's docstring)
# 6c: the recipe of yolo_ms_tpu_torch/configs/coco_yolo_ms.yaml, read from its
# JSON copy beside it (the card machine has no PyYAML;
# tests/test_torch_config.py holds the copy equal to the YAML)
COCO_YOLO_MS = os.path.join(ROOT, "yolo_ms_tpu_torch", "configs", "coco_yolo_ms.json")
FULL_STEPS = 12  # training steps of 6c (one epoch)
FULL_VAL_IMAGES = 64
FULL_WARMUP = 3  # the recipe's 3000 warmup steps, cut to fit 12 steps
BF16_LOSS_RTOL = 0.05


def _test_module(name: str):
    """``tests/<name>.py``, loaded from this checkout by path (``tests`` is
    not a package, and another one may be installed)."""
    spec = importlib.util.spec_from_file_location(name, os.path.join(ROOT, "tests", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def make_coco_dataset(*args, **kwargs):
    """``tests/make_fixtures.make_coco_dataset``."""
    return _test_module("make_fixtures").make_coco_dataset(*args, **kwargs)


def _seeded_train_batch(b: int, img: int, nc: int, seed: int) -> dict:
    rng = np.random.default_rng(seed)
    c = rng.uniform(0.3, 0.7, (b, 6, 2))
    wh = rng.uniform(0.15, 0.6, (b, 6, 2))
    mask = np.zeros((b, 6), bool)
    mask[:, :4] = True
    return {
        "images": torch.from_numpy(rng.integers(0, 256, (b, img, img, 3), dtype=np.uint8)),
        "boxes": torch.from_numpy(np.concatenate([c, wh], -1).astype(np.float32)),
        "labels": torch.from_numpy(rng.integers(0, nc, (b, 6)).astype(np.int32)),
        "mask": torch.from_numpy(mask),
    }


def _sgd_state(device, state_dict: dict, group=None, mesh=None):
    """yolov8-n (nc=3) from ``state_dict`` with 6a's recipe, SGD-nesterov,
    weight decay, clipping and EMA (its ramp at step 4000): the state and
    the f32 step, data parallel over ``group`` when one is given, or on a
    2-D ``mesh`` (data parallel and height-sharded)."""
    model = build_model("n", num_classes=3, device="cpu")
    model.load_state_dict(state_dict, strict=True)
    cfg = TrainingConfig(batch_size=8, epochs=1, optimizer="sgd", learning_rate=0.01,
                         weight_decay=5e-4, grad_clip_norm=10.0, ema_decay=0.9999)
    tx, _ = build_optimizer(cfg, 4)
    state = TrainState.create(model.to(device), tx, ema=True)
    state.step.fill_(4000)
    loss = DetectionLoss(num_classes=3, group=group)
    if mesh is None:
        set_batch_norm_group(state.model, group)
    else:
        loss = mesh.attach(state.model, loss)
    return state, make_train_step(loss, tx, cfg.ema_decay, torch.float32, group, mesh)


def _one_train_step(device: str, state_dict: dict, batch: dict):
    """One f32 train step of 6a's recipe from ``state_dict``."""
    state, step = _sgd_state(device, state_dict)
    metrics = step(state, {k: v.to(device) for k, v in batch.items()})
    return {k: float(v) for k, v in metrics.items()}, state


def phase_step_parity() -> dict:
    """6a: the golden yolov8-n weights, one f32 step (TF32 off) on the card
    and on the CPU, in this process: loss terms within STEP_LOSS_RTOL;
    params, BN statistics and EMA within STEP_STATE_TOL."""
    sd = load_npz(os.path.join(ROOT, "tests", "golden", "trained", "weights.npz"))
    batch = _seeded_train_batch(8, 160, 3, seed=5)
    card_m, card = _one_train_step("cuda", sd, batch)
    cpu_m, cpu = _one_train_step("cpu", sd, batch)
    if card_m["skipped_nonfinite"] or cpu_m["skipped_nonfinite"] or cpu_m["num_fg"] <= 0:
        raise AssertionError(f"6a: step skipped or without positives: {card_m} / {cpu_m}")
    worst_loss = 0.0
    for k in ("loss_box", "loss_cls", "loss_dfl", "total_loss"):
        rel = abs(card_m[k] - cpu_m[k]) / abs(cpu_m[k])
        worst_loss = max(worst_loss, rel)
        if not rel <= STEP_LOSS_RTOL:
            raise AssertionError(f"6a: {k} card {card_m[k]} vs CPU {cpu_m[k]}")
    worst = 0.0
    for name in ("params", "stats", "ema_params", "ema_stats"):
        got, want = getattr(card, name).cpu(), getattr(cpu, name)
        if not torch.allclose(got, want, **STEP_STATE_TOL):
            raise AssertionError(f"6a: {name} differ by {(got - want).abs().max().item()}")
        worst = max(worst, (got - want).abs().max().item())
    print(f"phase 6a train step yolov8-n golden 160px bs=8 f32 (TF32 off), SGD-nesterov + "
          f"decay + clip + EMA: card == CPU, loss terms max rel err {worst_loss:.2e} "
          f"(num_fg {int(card_m['num_fg'])}), params/stats/EMA max abs err {worst:.2e}")
    return {"loss_rel_err": worst_loss, "state_abs_err": worst}


@contextlib.contextmanager
def _quiet(log_path: str):
    """Send the trainer's per-step prints to a log file."""
    with open(log_path, "w") as f, contextlib.redirect_stdout(f):
        yield


def _learning_config(root: str, name: str, **training) -> Config:
    """The learning recipe of tests/test_learning.py over the 32 images under
    ``root``, with ``training`` overriding its training section."""
    images, ann = os.path.join(root, "images"), os.path.join(root, "annotations.json")
    return Config.from_dict({
        "dataset": {"train_images_path": images, "train_annotations_path": ann,
                    "val_images_path": images, "val_annotations_path": ann,
                    "num_classes": 3, "max_gt": 8},
        "model": {"architecture": "n", "input_size": [160, 160], "compute_dtype": "float32"},
        "training": {
            "batch_size": 16, "epochs": LEARN_EPOCHS, "learning_rate": 2e-3,
            "optimizer": "adam", "weight_decay": 0.0, "val_interval": LEARN_EPOCHS,
            "save_period": 1000, "experiment_name": name,
            "log_dir": os.path.join(root, "runs"), "augmentation": {"fliplr": 0.5},
            "grad_clip_norm": 10.0,
            "scheduler": {"type": "cosine", "cosine_t_max": LEARN_EPOCHS, "warmup_steps": 20},
            **training,
        },
        "evaluation": {"batch_size": 16, "confidence_threshold": 0.25},
        "workers": 4,
    })


def phase_learning(work: str) -> dict:
    """6b: the JAX package's learning recipe (tests/test_learning.py) through
    ``Trainer(Config.from_dict(...)).fit()`` on the card, then ``validate``."""
    root = os.path.join(work, "learn")
    make_coco_dataset(root, num_images=32, num_classes=3, img_w=320, img_h=256, seed=1)
    trainer = Trainer(_learning_config(root, "learn"), verbose=False)
    t0 = time.perf_counter()
    with _quiet(os.path.join(root, "fit.log")):
        trainer.fit()
    fit_s = time.perf_counter() - t0
    final = trainer.validate()
    if not final > LEARN_MAP_MIN:
        raise AssertionError(f"6b: mAP@0.5 {final:.4f} <= {LEARN_MAP_MIN} on the learning recipe")
    steps = int(trainer.state.step)
    print(f"phase 6b learning recipe yolov8-n 160px nc=3 f32, 32 images, bs 16, "
          f"{LEARN_EPOCHS} epochs ({steps} steps), Adam 2e-3, cosine + warmup 20: "
          f"mAP@0.5 {final:.4f} (> {LEARN_MAP_MIN}; the JAX package reached "
          f"{LEARN_REFERENCE_MAP} on this recipe, an accuracy, not a speed); fit {fit_s:.1f} s")
    return {"map50": final, "steps": steps, "fit_s": fit_s}


def _full_config(root: str, images: str, ann: str, val_images: str, val_ann: str,
                 name: str) -> Config:
    d = load_config(COCO_YOLO_MS).to_dict()
    d["dataset"].update(train_images_path=images, train_annotations_path=ann,
                        val_images_path=val_images, val_annotations_path=val_ann)
    d["training"].update(batch_size=BATCH, epochs=1, val_interval=1, experiment_name=name,
                         log_dir=os.path.join(root, "runs"))
    d["training"]["scheduler"]["warmup_steps"] = FULL_WARMUP
    return Config.from_dict(d)


def phase_full_width(work: str) -> dict:
    """6c: yolo-ms-xs at full width and depth, nc=80, 640x640, bf16 autocast,
    batch 32, coco_yolo_ms.yaml settings, one epoch of FULL_STEPS steps on
    synthetic 640x480 COCO images, validation over 64 images, a checkpoint
    written and resumed. The counted run of the training path: every count
    at 0 just before ``fit``, read just after."""
    root = os.path.join(work, "full")
    images, ann = make_coco_dataset(os.path.join(root, "train"), num_images=FULL_STEPS * BATCH,
                                    num_classes=NC, img_w=640, img_h=480, max_objects=12,
                                    seed=2)
    val_images, val_ann = make_coco_dataset(os.path.join(root, "val"),
                                            num_images=FULL_VAL_IMAGES, num_classes=NC,
                                            img_w=640, img_h=480, max_objects=12, seed=3)
    cfg = _full_config(root, images, ann, val_images, val_ann, "full")
    trainer = Trainer(cfg, verbose=False)
    if len(trainer.train_loader) != FULL_STEPS:
        raise AssertionError(f"6c: {len(trainer.train_loader)} steps per epoch")
    val_batches = len(trainer.val_loader)

    # the first batch's loss in f32 on the card, on a copy of the model (a
    # train-mode forward moves the BN statistics)
    batches = trainer.train_loader.epoch(0)
    first_batch = trainer._to_device(trainer._bucket_gt(next(batches)))
    batches.close()
    probe = copy.deepcopy(trainer.state.model)
    x = device_normalize_images(first_batch["images"], torch.float32).permute(0, 3, 1, 2)
    with torch.no_grad(), full_f32():
        f32_loss, _ = trainer.loss_fn(probe(x.contiguous()), first_batch["boxes"],
                                      first_batch["labels"], first_batch["mask"])
    f32_loss = float(f32_loss)
    del probe, x

    inner = trainer._train_step
    events, metrics, host_starts = [], [], []

    def timed_step(state, batch):
        host_starts.append(time.perf_counter())
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        m = inner(state, batch)
        end.record()
        events.append((start, end))
        metrics.append(m)
        return m

    trainer._train_step = timed_step
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    # counted run of the training path
    zero_counts()
    nms_fixed.sweeps = 0
    profiler.clear()
    t0 = time.perf_counter()
    with _quiet(os.path.join(root, "fit.log")), profiler.recording():  # the fit/* spans
        trainer.fit()
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    launches = launched("6c fit")
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    if launches != val_batches:
        raise AssertionError(f"6c: select launched {launches} times in a fit whose "
                             f"validation ran {val_batches} batches")

    host = [{k: float(v) for k, v in m.items()} for m in metrics]
    if len(host) != FULL_STEPS:
        raise AssertionError(f"6c: {len(host)} steps run, expected {FULL_STEPS}")
    for i, m in enumerate(host):
        if not all(math.isfinite(v) for v in m.values()):
            raise AssertionError(f"6c: step {i + 1} not finite: {m}")
        if m["skipped_nonfinite"] != 0.0 or m["num_fg"] <= 0:
            raise AssertionError(f"6c: step {i + 1} skipped or without positives: {m}")
    bf16_rel = abs(host[0]["total_loss"] - f32_loss) / abs(f32_loss)
    if not bf16_rel <= BF16_LOSS_RTOL:
        raise AssertionError(f"6c: first step bf16 loss {host[0]['total_loss']} vs f32 "
                             f"{f32_loss} (rel {bf16_rel:.3f})")
    step_ms = [s.elapsed_time(e) for s, e in events]
    med_ms = statistics.median(step_ms[2:])
    # the loader's wait before each step: a fit/wait_batch span followed by its fit/step
    recorded = profiler.spans()
    waits = [(w.end_ns - w.start_ns) / 1e9 for w, nxt in zip(recorded, recorded[1:])
             if w.name == "fit/wait_batch" and nxt.name == "fit/step"]
    if len(waits) != FULL_STEPS:
        raise AssertionError(f"6c: {len(waits)} loader waits recorded for {FULL_STEPS} steps")
    wait_ms = statistics.median(waits[2:]) * 1e3
    # end to end: every training image over the whole fit's wall time
    fit_img_s = FULL_STEPS * BATCH / fit_s
    # a host statistic of the step loop: from one step's start to the next's
    period_ms = statistics.median(b - a for a, b in zip(host_starts[2:], host_starts[3:])) * 1e3

    # validate alone: timed, and one select launch per val batch
    before = counts()
    t0 = time.perf_counter()
    val_map = trainer.validate()
    torch.cuda.synchronize()
    val_ms = (time.perf_counter() - t0) * 1e3
    n = launched("6c validate", before)
    if n != val_batches:
        raise AssertionError(f"6c: validate launched select {n} times for {val_batches} batches")

    # the checkpoint written by fit, read back by resume
    ckpt = os.path.join(trainer.ckpt.dir, "last.ckpt")
    resumed = Trainer(_full_config(root, images, ann, val_images, val_ann, "resumed"),
                      verbose=False)
    resumed.resume(ckpt)
    if not (resumed.start_epoch == 1 and int(resumed.state.step) == FULL_STEPS
            and torch.equal(resumed.state.params, trainer.state.params)
            and torch.equal(resumed.state.ema_stats, trainer.state.ema_stats)
            and all(torch.equal(resumed.state.opt_state[k], v)
                    for k, v in trainer.state.opt_state.items())):
        raise AssertionError("6c: resumed state differs from the trained one")
    ckpt_mb = os.path.getsize(ckpt) / 1e6
    alone = step_breakdown(resumed, first_batch)
    print(f"phase 6c train yolo-ms-xs nc={NC} {IMG}px bf16 bs={BATCH}, coco_yolo_ms.yaml "
          f"recipe (warmup cut to {FULL_WARMUP}), {FULL_STEPS} steps: all finite, none "
          f"skipped, num_fg {min(m['num_fg'] for m in host):.0f}-"
          f"{max(m['num_fg'] for m in host):.0f}; losses {host[0]['total_loss']:.4f} -> "
          f"{host[-1]['total_loss']:.4f}; first step bf16 {host[0]['total_loss']:.4f} vs f32 "
          f"{f32_loss:.4f} (rel {bf16_rel:.4f}); {med_ms:.3f} ms/step (CUDA events, median of "
          f"steps 3-{FULL_STEPS}; all {', '.join(f'{t:.1f}' for t in step_ms)}), "
          f"{BATCH / med_ms * 1e3:.1f} img/s; host wait for the loader {wait_ms:.1f} ms/step "
          f"(median); host-clock gap from one step's start to the next {period_ms:.1f} ms "
          f"(median of steps 3-{FULL_STEPS}); end to end {fit_img_s:.1f} img/s: "
          f"{FULL_STEPS * BATCH} images over the whole fit's {fit_s:.2f} s (loader start, "
          f"first step, validation and checkpoint writes included); peak memory "
          f"{peak_gib:.2f} GiB; validate "
          f"{FULL_VAL_IMAGES} images {val_ms:.1f} ms, mAP@0.5 {val_map:.4f}, select "
          f"launches {launches} in fit for {val_batches} val batches; checkpoint "
          f"{ckpt_mb:.1f} MB written and resumed")
    parts = ", ".join(f"{k} {v:.2f} ms" for k, v in alone["ranges"].items() if v > 0)
    busy = alone["busy_ms"]
    print(f"phase 6c step alone (the first batch resident on the card, no loader; "
          f"{alone['steps']} steps after 2 warm-up): {alone['event_ms']:.3f} ms/step (CUDA "
          f"events, median), host {alone['host_ms']:.3f} ms to enqueue one step (median); "
          f"torch.profiler over {alone['profiled']} steps: kernel time "
          + (f"{busy:.3f} ms/step in {alone['device_ops']:.0f} device operations "
             f"({alone['host_ms'] / max(alone['device_ops'], 1) * 1e3:.1f} us of host "
             f"enqueue each), {busy / alone['wall_ms'] * 100:.1f} % of the "
             f"{alone['wall_ms']:.3f} ms/step wall (idle {100 - busy / alone['wall_ms'] * 100:.1f}"
             f" %); in the fit's {med_ms:.3f} ms/step the card was busy "
             f"{busy / med_ms * 100:.1f} %" if busy else "not measured")
          + f"; device time by range: {parts or 'not measured'}")
    return {"launches": launches, "step_ms": med_ms, "img_s": BATCH / med_ms * 1e3,
            "wait_ms": wait_ms, "period_ms": period_ms, "fit_s": fit_s,
            "fit_img_s": fit_img_s, "peak_gib": peak_gib, "val_ms": val_ms,
            "alone": alone, "ckpt": ckpt,
            "data": (root, images, ann, val_images, val_ann)}


def step_breakdown(trainer: Trainer, batch: dict, steps: int = 10, profiled: int = 3) -> dict:
    """Steady-state train steps on one batch resident on the card, without
    the loader: the CUDA-event interval and the host's enqueue time per step
    (medians), then ``torch.profiler`` over ``profiled`` steps: the kernel
    time per step (the card's busy time), the number of device operations
    (kernels, copies, memsets) per step, the wall time per step, and the
    device time of the step's ranges (``train_step/forward`` ...; the
    backward's is that of the autograd engine's nodes). Where the
    profiler records no device time, those read 0 and are printed as not
    measured."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    step = trainer._train_step
    for _ in range(2):
        step(trainer.state, batch)
    torch.cuda.synchronize()
    pairs, host = [], []
    for _ in range(steps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        t0 = time.perf_counter()
        step(trainer.state, batch)
        host.append((time.perf_counter() - t0) * 1e3)
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(profiled):
            step(trainer.state, batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / profiled
    busy_us, ranges = 0.0, {}
    backward_us, device_ops = 0.0, 0
    for ev in prof.key_averages():
        if ev.key.startswith("train_step/"):
            ranges[ev.key[len("train_step/"):]] = ev.device_time_total / 1e3 / profiled
        elif ev.key.startswith("autograd::engine::evaluate_function"):
            # the backward runs on the autograd engine's thread, outside the
            # main thread's ``train_step/backward`` range: count its nodes
            backward_us += ev.device_time_total
        elif ev.device_type == DeviceType.CUDA:
            busy_us += ev.self_device_time_total
            device_ops += ev.count
    ranges["backward"] = backward_us / 1e3 / profiled
    return {
        "steps": steps, "profiled": profiled,
        "event_ms": statistics.median(s.elapsed_time(e) for s, e in pairs),
        "host_ms": statistics.median(host), "wall_ms": wall_ms,
        "busy_ms": busy_us / 1e3 / profiled, "ranges": ranges,
        "device_ops": device_ops / profiled,
    }


# ---------------------------------------------------------------- phase 7

DEVICE = "cuda"  # where phase 7's entry points run

# 7b: the folded f32 export's raw maps against the unfolded EMA model's (f32,
# TF32 off): the fold changes the summation order only
EXPORT_MAPS_ATOL = 1e-3
# 7c: a frame served in a batch of 32 against the same frame alone (f32, TF32
# off): the same detections up to the summation order of another batch size
VIDEO_IOU_MIN, VIDEO_SCORE_TOL = 0.99, 1e-3
# 7d: the resumed run against the uninterrupted one (f32, TF32 off, SGD,
# deterministic algorithms: without them two uninterrupted runs part by more
# than this within four steps)
PREEMPT_TOL = dict(rtol=1e-3, atol=1e-5)
PREEMPT_EPOCHS = 2  # the learning recipe cut to 2 epochs of 2 steps
PREEMPT_SNIPE = 2  # SIGTERM while the third step (epoch 1, step 0) is in flight


def phase_tools_test(work: str) -> int:
    """7a: ``tools.test.run`` on the golden yolov8-n, from its weights.npz
    and from a reference-format .pt made from the same weights in this
    process (``reference_state_dict`` of tests/test_torch_tools.py): both
    reproduce the golden detections, with one ``select`` launch per batch."""
    gdir = GOLDENS[0][1]
    npz = os.path.join(gdir, "weights.npz")
    fixture = os.path.join(gdir, "fixture_000.png")
    pt = os.path.join(work, "yolov8n.pt")
    torch.save({"model": _test_module("test_torch_tools").reference_state_dict(npz)}, pt)
    cfg_path = os.path.join(work, "golden_n.json")
    Config.from_dict({"dataset": {"num_classes": 3}, "device": DEVICE,
                      "model": {"architecture": "n", "input_size": [160, 160]}}).save(cfg_path)
    with open(os.path.join(gdir, "fixture_000_detections.json")) as f:
        golden = json.load(f)
    total, parts = 0, []
    for kind, ckpt in (("weights.npz", npz), ("reference .pt", pt)):
        out_dir = os.path.join(work, "detect_" + kind.split()[-1])
        zero_counts()
        with _quiet(out_dir + ".log"):
            results = tools_test.run(cfg_path, ckpt, fixture, out_dir)
        launches = launched(f"7a {kind}")
        if launches != 1:
            raise AssertionError(f"7a {kind}: select launched {launches} times for 1 batch")
        match_golden(results[fixture], golden)
        if not os.path.getsize(os.path.join(out_dir, "fixture_000_detected.jpg")):
            raise AssertionError(f"7a {kind}: no drawn fixture")
        total += launches
        parts.append(f"from {kind} {len(results[fixture])} detections match, "
                     f"{launches} select launch")
    print("phase 7a tools.test golden yolov8-n 160px on the card: " + "; ".join(parts))
    return total


def phase_export_val(work: str, full: dict) -> dict:
    """7b: ``tools.export`` of 6c's last.ckpt (its EMA model) to a folded f32
    and a folded bf16 file; the f32 export's raw maps against the unfolded
    EMA model's on one batch of val images (TF32 off, EXPORT_MAPS_ATOL); then
    ``tools.val`` on each export over 6c's 64 val images at 640², batch 32,
    each a counted run: ``select.launches`` from 0 must reach the number of
    val batches."""
    _, _, _, val_images, val_ann = full["data"]
    exports = {}
    for name, bf16 in (("f32", False), ("bf16", True)):
        t0 = time.perf_counter()
        with _quiet(os.path.join(work, f"export_{name}.log")):
            info = tools_export.run(full["ckpt"], os.path.join(work, f"export_{name}.ckpt"),
                                    bf16=bf16)
        info["seconds"] = time.perf_counter() - t0
        info["file_mb"] = os.path.getsize(info["output"]) / 1e6
        exports[name] = info

    paths = sorted(glob.glob(os.path.join(val_images, "*.jpg")))
    u8 = torch.from_numpy(np.stack([decode_and_resize(p, IMG, IMG) for p in paths[:BATCH]]))
    unfolded = build_model("yolo-ms-xs", num_classes=NC, device=DEVICE)
    unfolded.load_state_dict(restore_checkpoint(full["ckpt"])["state"]["ema"], strict=True)
    folded = build_model("yolo-ms-xs", num_classes=NC, device=DEVICE, deploy=True)
    folded.load_state_dict(restore_checkpoint(exports["f32"]["output"]), strict=True)
    with torch.inference_mode(), full_f32():
        x = _nchw(u8.to(DEVICE))
        maps_err = max((a - b).abs().max().item() for a, b in zip(folded(x), unfolded(x)))
    del unfolded, folded, x
    if not maps_err <= EXPORT_MAPS_ATOL:
        raise AssertionError(f"7b: folded f32 export's raw maps differ from the EMA model's "
                             f"by {maps_err}")

    cfg = load_config(COCO_YOLO_MS).to_dict()
    cfg["dataset"].update(val_images_path=val_images, val_annotations_path=val_ann)
    cfg["evaluation"].update(batch_size=BATCH, img_size=[IMG, IMG])
    cfg["device"] = DEVICE
    cfg_path = os.path.join(work, "val.json")
    Config.from_dict(cfg).save(cfg_path)
    val_batches = math.ceil(len(paths) / BATCH)
    launches, parts = 0, []
    for name in ("f32", "bf16"):
        info = exports[name]
        zero_counts()
        t0 = time.perf_counter()
        result = tools_val.run(cfg_path, info["output"], verbose=False)
        val_s = time.perf_counter() - t0
        n = launched(f"7b {name}")
        if n != val_batches:
            raise AssertionError(f"7b {name}: select launched {n} times for {val_batches} "
                                 f"val batches")
        if result["images"] != len(paths):
            raise AssertionError(f"7b {name}: {result['images']} images validated")
        launches += n
        parts.append(
            f"{name}: {info['params']:,} params, {info['bytes'] / 1e6:.2f} MB of tensors "
            f"({info['file_mb']:.2f} MB file), exported in {info['seconds']:.2f} s; val "
            f"{statistics.median(result['batch_ms']):.1f} ms/batch predict_batch (host clock, "
            f"median of {len(result['batch_ms'])}; all {', '.join(f'{t:.1f}' for t in result['batch_ms'])}),"
            f" {val_s:.2f} s in all, {result['detections']} detections, mAP@0.5 "
            f"{result['map_50']:.4f}, select launches {n}")
    print(f"phase 7b tools.export + tools.val yolo-ms-xs nc={NC} {IMG}px bs={BATCH} from 6c's "
          f"last.ckpt (EMA), {len(paths)} val images, f32 serving (TF32 off): folded f32 export "
          f"vs unfolded EMA raw maps max abs err {maps_err:.3e}; " + "; ".join(parts))
    return {"launches": launches, "bf16": exports["bf16"]["output"]}


def phase_video(work: str, full: dict, export_path: str) -> int:
    """7c: 6c's 64 val images (640x480) as an MJPG .avi through
    ``predict_video`` at 640², batch 32, from the bf16 export (served in f32,
    TF32 off, conf 1e-5), a counted run: one ``select`` launch per batch.
    Every frame's detections match ``predict_image`` on the frame as
    decoded (VIDEO_IOU_MIN, VIDEO_SCORE_TOL) and the written video has
    every frame."""
    import cv2

    _, _, _, val_images, _ = full["data"]
    paths = sorted(glob.glob(os.path.join(val_images, "*.jpg")))
    first = cv2.imread(paths[0])
    src = os.path.join(work, "val.avi")
    writer = cv2.VideoWriter(src, cv2.VideoWriter_fourcc(*"MJPG"), 30.0,
                             (first.shape[1], first.shape[0]))
    if not writer.isOpened():
        raise AssertionError("7c: cv2 cannot write MJPG")
    for p in paths:
        writer.write(cv2.imread(p))
    writer.release()

    predictor = Predictor("yolo-ms-xs", load_serving_state_dict(export_path), num_classes=NC,
                          input_size=(IMG, IMG), conf_thresh=1e-5, batch_size=BATCH,
                          device=DEVICE)
    predictor.predict_batch(np.zeros((BATCH, IMG, IMG, 3), np.uint8))  # warm-up
    out = os.path.join(work, "detected.mp4")
    zero_counts()
    t0 = time.perf_counter()
    with _quiet(os.path.join(work, "video.log")):
        dets = predict_video(predictor, src, out)
    video_s = time.perf_counter() - t0
    launches = launched("7c")
    if launches != math.ceil(len(paths) / BATCH):
        raise AssertionError(f"7c: select launched {launches} times for {len(paths)} frames "
                             f"in batches of {BATCH}")

    def frames_of(path):
        cap = cv2.VideoCapture(path)
        frames = []
        while True:
            ok, bgr = cap.read()
            if not ok:
                break
            frames.append(cv2.cvtColor(bgr, cv2.COLOR_BGR2RGB))
        cap.release()
        return frames

    frames = frames_of(src)
    if not len(dets) == len(frames) == len(paths):
        raise AssertionError(f"7c: {len(dets)} frames served, {len(frames)} decoded, "
                             f"{len(paths)} written")
    exact = n_dets = 0
    for got, rgb in zip(dets, frames):
        want = predictor.predict_image(rgb)
        n_dets += len(want)
        if got == want:
            exact += 1
        else:
            match_golden(got, want, VIDEO_IOU_MIN, VIDEO_SCORE_TOL)
    if n_dets == 0:
        raise AssertionError("7c: no detections to compare")
    written = len(frames_of(out))
    if written != len(paths):
        raise AssertionError(f"7c: the written video has {written} frames")
    print(f"phase 7c predict_video yolo-ms-xs bf16 export (f32 serving, TF32 off) {IMG}px "
          f"bs={BATCH} conf 1e-5, {len(paths)} MJPG frames 640x480: {len(paths) / video_s:.1f} "
          f"frames/s (host clock, {video_s:.2f} s: decode, resize, serve, draw and encode); "
          f"select launches {launches}; {n_dets} detections, every frame matches predict_image "
          f"on the decoded frame ({exact} of {len(frames)} exactly equal); written video "
          f"{written} frames")
    return launches


def phase_unfolded(full: dict) -> int:
    """7f: ``Predictor(deploy=False)``, BatchNorm unfolded in eval mode, in
    both entry layouts: both trained goldens (train-structure weights.npz,
    160², f32, TF32 off, conf 0.25) reproduce their checked-in detections
    by phase 4's rule; 6c's checkpoint (its EMA model) served unfolded in
    f32 gives raw maps within EXPORT_MAPS_ATOL of the folded model's (7b's
    rule) and serves 6c's 64 val images at conf 1e-5. A counted run: one
    ``select`` launch per served batch."""
    launches, parts = 0, []
    for arch, gdir in GOLDENS:
        state_dict = load_npz(os.path.join(gdir, "weights.npz"))
        fixture = os.path.join(gdir, "fixture_000.png")
        with open(os.path.join(gdir, "fixture_000_detections.json")) as f:
            golden = json.load(f)
        for layout in ENTRY_LAYOUTS:
            predictor = Predictor(arch, state_dict, num_classes=3, input_size=(160, 160),
                                  conf_thresh=0.25, iou_thresh=0.45, dtype=torch.float32,
                                  deploy=False, entry_layouts=layout, device=DEVICE)
            if predictor.deploy or predictor.serve.memory_format != LAYOUT_FORMATS[layout]:
                raise AssertionError(f"7f {arch} {layout}: deploy {predictor.deploy}, "
                                     f"{predictor.serve.memory_format}")
            zero_counts()
            with tempfile.TemporaryDirectory() as out_dir:
                results = predictor.predict_paths(fixture, out_dir, verbose=False)
            if launched(f"7f {arch} {layout}") != 1:
                raise AssertionError(f"7f {arch} {layout}: {select.launches} select launches "
                                     f"for 1 batch")
            launches += 1
            got = next(iter(results.values()))
            match_golden(got, golden)
            parts.append(f"golden {arch} {layout}: {len(got)} detections match "
                         f"(scores {[d['score'] for d in got]})")

    ema = restore_checkpoint(full["ckpt"])["state"]["ema"]
    _, _, _, val_images, _ = full["data"]
    paths = sorted(glob.glob(os.path.join(val_images, "*.jpg")))
    u8 = np.stack([decode_and_resize(p, IMG, IMG) for p in paths])
    kw = dict(num_classes=NC, input_size=(IMG, IMG), conf_thresh=1e-5, batch_size=BATCH,
              dtype=torch.float32, device=DEVICE)
    x = torch.from_numpy(u8[:BATCH]).to(DEVICE)

    def raw_maps(predictor):
        with torch.inference_mode(), full_f32():
            return predictor.model(predictor.serve.network_input(x))

    folded = Predictor("yolo-ms-xs", ema, deploy=True, entry_layouts="default", **kw)
    want = raw_maps(folded)
    del folded
    for layout in ENTRY_LAYOUTS:
        predictor = Predictor("yolo-ms-xs", ema, deploy=False, entry_layouts=layout, **kw)
        if predictor.deploy:
            raise AssertionError(f"7f 6c {layout}: the checkpoint was folded")
        maps_err = max((a - b).abs().max().item() for a, b in zip(raw_maps(predictor), want))
        if not maps_err <= EXPORT_MAPS_ATOL:
            raise AssertionError(f"7f 6c {layout}: unfolded raw maps differ from the folded "
                                 f"model's by {maps_err}")
        zero_counts()
        t0 = time.perf_counter()
        n_dets = 0
        for i in range(0, len(u8), BATCH):
            out = predictor.predict_batch(u8[i:i + BATCH])
            check_outputs(out, f"7f 6c {layout}")
            n_dets += int(out["valid"].sum())
        serve_s = time.perf_counter() - t0
        batches = math.ceil(len(u8) / BATCH)
        if launched(f"7f 6c {layout}") != batches:
            raise AssertionError(f"7f 6c {layout}: {select.launches} select launches for "
                                 f"{batches} batches")
        launches += batches
        parts.append(f"6c's EMA model {layout}: raw maps vs folded max abs err {maps_err:.3e}, "
                     f"{len(u8)} val images in {serve_s:.2f} s, {n_dets} detections, select "
                     f"launches {batches}")
        del predictor
    print(f"phase 7f Predictor(deploy=False) (BatchNorm unfolded, eval) f32 with TF32 off, "
          f"both entry layouts: " + "; ".join(parts))
    return launches


def preempt_child(root: str, exp: str, snipe: str, ckpt: str | None = None) -> int:
    """One run of the 7d drill (``chip_smoke.py --preempt-child ...``): the
    learning recipe cut to PREEMPT_EPOCHS epochs, SGD, f32 with TF32 off and
    PyTorch's deterministic algorithms (warning where an op has none), on
    the card; with ``snipe`` >= 0 it sends itself SIGTERM while that step is
    in flight; with ``ckpt`` it resumes from it. A run that ends writes its
    final state beside the data."""
    torch.use_deterministic_algorithms(True, warn_only=True)
    rank, ranked = get_rank(), world_size() > 1
    # under data parallelism (8c) each rank logs under its own directory, so
    # that what rank 1 writes shows (nothing)
    extra = {"log_dir": os.path.join(root, f"runs_rank{rank}")} if ranked else {}
    cfg = _learning_config(root, exp, epochs=PREEMPT_EPOCHS, optimizer="sgd",
                           learning_rate=0.01, weight_decay=5e-4, ema_decay=0.9999,
                           val_interval=1000,
                           scheduler={"type": "cosine", "cosine_t_max": PREEMPT_EPOCHS}, **extra)
    trainer = Trainer(cfg, verbose=False, device=DEVICE)
    if ckpt:
        trainer.resume(ckpt)
    steps = [trainer.start_epoch * len(trainer.train_loader) + trainer.start_step]
    inner = trainer._train_step

    def step(state, batch):
        metrics = inner(state, batch)
        if steps[0] == int(snipe):
            print(f"SIGNAL_AT {time.time():.6f}", file=sys.stderr, flush=True)
            os.kill(os.getpid(), signal.SIGTERM)
            if not (trainer._preempt_signum == signal.SIGTERM and trainer._step_active):
                raise AssertionError("7d: the signal was not deferred")
        steps[0] += 1
        return metrics

    trainer._train_step = step
    tag = exp + (f"_rank{rank}" if ranked else "")
    with _quiet(os.path.join(root, tag + ".log")):
        trainer.fit()
    torch.save(trainer.state.state_dict(), os.path.join(root, tag + "_final.pt"))
    return 0


def wait_children(procs: dict, timeout: float, phase: str) -> dict:
    """Exit code and host-clock exit time of each child process; a child
    still running at the timeout is killed and the phase fails."""
    ended, deadline = {}, time.time() + timeout
    try:
        while len(ended) < len(procs):
            if time.time() > deadline:
                raise AssertionError(f"{phase}: a child process did not end")
            for name, p in procs.items():
                if name not in ended and p.poll() is not None:
                    ended[name] = (p.returncode, time.time())
            time.sleep(0.01)
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    return ended


def phase_preempt(work: str) -> None:
    """7d: child processes on the card: U and U2 uninterrupted, P with
    SIGTERM inside step PREEMPT_SNIPE's in-flight window (the three side by
    side), then R resumed from P's preempt.ckpt. P exits 143 with the
    committed step as its cursor; R's final params, statistics and EMA
    equal U's within PREEMPT_TOL. U2 against U shows how far two runs of
    the same recipe part on the card."""
    root = os.path.join(work, "learn")
    env = dict(os.environ, CUBLAS_WORKSPACE_CONFIG=":4096:8")  # deterministic cuBLAS

    def start(exp, snipe=-1, *extra):
        log = open(os.path.join(root, exp + ".out"), "w")
        proc = subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--preempt-child", root, exp,
             str(snipe), *extra], cwd=ROOT, env=env, stdout=log, stderr=subprocess.STDOUT)
        log.close()
        return proc

    def wait(procs):
        return wait_children(procs, 300, "7d")

    def output(exp):
        with open(os.path.join(root, exp + ".out")) as f:
            return f.read()

    t0 = time.perf_counter()
    ended = wait({"u": start("pre_u"), "u2": start("pre_u2"), "p": start("pre_p", PREEMPT_SNIPE)})
    term = 128 + signal.SIGTERM
    if ended["u"][0] != 0 or ended["u2"][0] != 0 or ended["p"][0] != term:
        raise AssertionError(f"7d: exit codes U {ended['u'][0]}, U2 {ended['u2'][0]}, P "
                             f"{ended['p'][0]} (want 0, 0, {term})\n{output('pre_u')[-3000:]}\n"
                             f"{output('pre_p')[-3000:]}")
    signal_at = next(float(ln.split()[1]) for ln in output("pre_p").splitlines()
                     if ln.startswith("SIGNAL_AT"))
    exit_s = ended["p"][1] - signal_at
    ckpt = os.path.join(root, "runs", "pre_p", "weights", "preempt.ckpt")
    restored = restore_checkpoint(ckpt)
    cursor = (restored["epoch"], restored["step_in_epoch"], restored["state"]["step"])
    if cursor != (1, 1, PREEMPT_SNIPE + 1):
        raise AssertionError(f"7d: preempt.ckpt cursor (epoch, step in epoch, steps) {cursor}")
    ended = wait({"r": start("pre_r", -1, ckpt)})
    if ended["r"][0] != 0:
        raise AssertionError(f"7d: resumed run exit {ended['r'][0]}\n{output('pre_r')[-3000:]}")
    drill_s = time.perf_counter() - t0
    final = {e: torch.load(os.path.join(root, f"pre_{e}_final.pt"), weights_only=True)
             for e in ("u", "u2", "r")}
    want = final["u"]

    def compare(got, check):
        if got["step"] != want["step"]:
            raise AssertionError(f"7d: {got['step']} steps vs {want['step']}")
        worst = 0.0
        for part in ("model", "ema"):
            for k, v in want[part].items():
                if not v.is_floating_point():
                    continue
                err = (got[part][k] - v).abs().max().item()
                if check and not torch.allclose(got[part][k], v, **PREEMPT_TOL):
                    raise AssertionError(f"7d: resumed {part} {k} differs by {err}")
                worst = max(worst, err)
        return worst

    repeat = compare(final["u2"], check=False)
    worst = compare(final["r"], check=True)
    nondet = sorted({ln.split(" does not have a deterministic")[0].split()[-1]
                     for e in ("pre_u", "pre_u2", "pre_p", "pre_r") for ln in output(e).splitlines()
                     if "does not have a deterministic implementation" in ln})
    print(f"phase 7d preemption drill, learning recipe cut to {PREEMPT_EPOCHS} epochs x 2 steps, "
          f"SGD f32 (TF32 off, deterministic algorithms), 4 child processes on the card: "
          f"SIGTERM inside step {PREEMPT_SNIPE + 1}'s in-flight window -> exit {term}, "
          f"preempt.ckpt at epoch 1 step 1 ({PREEMPT_SNIPE + 1} steps committed), {exit_s:.3f} s "
          f"from signal to exit (host clock); resumed final params/statistics/EMA == "
          f"uninterrupted, max abs err {worst:.3e} (two uninterrupted runs: {repeat:.3e}); ops "
          f"without a deterministic implementation: {', '.join(nondet) or 'none'}; drill "
          f"{drill_s:.1f} s")


def phase_analyze(work: str) -> None:
    """7e: ``tools.analyze`` of yolo-ms-xs at 640² on the card."""
    with _quiet(os.path.join(work, "analyze.log")):
        info = analyze("yolo-ms-xs", num_classes=NC, img_size=IMG, device=DEVICE)
    stages = ", ".join(f"{k} {v:,}" for k, v in info["stage_params"].items())
    print(f"phase 7e analyze yolo-ms-xs nc={NC} {IMG}px on the card: {info['params']:,} params "
          f"({stages}), {info['flops'] / 1e9:.2f} GFLOPs/image (FlopCounterMode: 2 x MACs of "
          f"convs and matmuls only), {info['anchors']:,} anchors, staged == full")


# ---------------------------------------------------------------- phase 8

DP_RANKS = 2
DP_TIMEOUT = 300  # seconds for each group of child processes
# 8a: 6a's recipe for DP_STEPS steps, two ranks x 4 rows against one process
# x 8 on the card; the ranks' states are compared bit for bit
DP_STEPS = 3
# 8b: 6c's recipe and cut, global batch BATCH = DP_RANKS x 16, DP_FULL_STEPS
# steps, then validation of the 64 val images sharded over the ranks
DP_FULL_STEPS = 6
DP_FIRST_LOSS_RTOL = 1e-2
# 8a's validation: two ranks against one process (as tests/test_torch_parallel_trainer.py)
DP_MAP_ATOL = 1e-6


def _dp_spawn(work: str, tag: str, kind: str, world: int, *args: str,
              backend: str = "gloo") -> dict:
    """Start ``world`` ranks of ``chip_smoke.py --dp-child KIND BACKEND ARGS``
    with torchrun's variables (so the port's own init path runs) and
    deterministic cuBLAS; rank r's output goes to ``work/dp/TAG{r}.out``."""
    os.makedirs(os.path.join(work, "dp"), exist_ok=True)
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    procs = {}
    for r in range(world):
        env = dict(os.environ, RANK=str(r), LOCAL_RANK=str(r), WORLD_SIZE=str(world),
                   MASTER_ADDR="localhost", MASTER_PORT=str(port),
                   CUBLAS_WORKSPACE_CONFIG=":4096:8")
        log = open(os.path.join(work, "dp", f"{tag}{r}.out"), "w")
        procs[f"{tag}{r}"] = subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--dp-child", kind, backend, *args],
            cwd=ROOT, env=env, stdout=log, stderr=subprocess.STDOUT)
        log.close()
    return procs


def _dp_out(work: str, name: str) -> str:
    with open(os.path.join(work, "dp", f"{name}.out")) as f:
        return f.read()


def _dp_result(work: str, name: str) -> dict:
    found = [ln for ln in _dp_out(work, name).splitlines() if ln.startswith("DP ")]
    if not found:
        raise AssertionError(f"{name}: no result line\n{_dp_out(work, name)[-3000:]}")
    return json.loads(found[-1][3:])


def _dp_wait(work: str, procs: dict, phase: str, want_rc: int = 0,
             timeout: float = DP_TIMEOUT) -> dict:
    ended = wait_children(procs, timeout, phase)
    for name, (rc, _) in ended.items():
        if rc != want_rc:
            raise AssertionError(f"{phase}: rank {name} exit {rc} (want {want_rc})\n"
                                 + _dp_out(work, name)[-3000:])
    return ended


def _flat_state(state, moments: bool = True) -> torch.Tensor:
    """Params, statistics and EMA (6a's state), and the optimizer's moments
    unless ``moments`` is False, in one f32 vector."""
    parts = [state.params, state.stats, state.ema_params, state.ema_stats]
    parts += list(state.opt_state.values()) if moments else []
    return torch.cat([t.detach().float().reshape(-1) for t in parts])


def _dp_golden_batches() -> tuple[list, dict]:
    """8a's global batches (8 rows each, 6a's seeded kind) and a batch with
    a NaN pixel in row 5, one of rank 1's (as normalized f32 images, which
    the step takes as they are)."""
    batches = [_seeded_train_batch(8, 160, 3, seed=5 + i) for i in range(DP_STEPS)]
    nan = _seeded_train_batch(8, 160, 3, seed=5 + DP_STEPS)
    nan["images"] = device_normalize_images(nan["images"], torch.float32)
    nan["images"][5, 0, 0, 0] = float("nan")
    return batches, nan


def _golden_run(device, batches: list, nan: dict | None = None, group=None) -> dict:
    """6a's recipe from the golden yolov8-n, one f32 step per batch (data
    parallel over ``group`` when one is given): the metrics and the flat
    state after each; then, from the last state, the NaN batch, which must
    leave the state as it was. ``flat`` is 6a's state (the moments are sums
    of gradients, held only rank to rank)."""
    state, step = _sgd_state(device, load_npz(os.path.join(GOLDENS[0][1], "weights.npz")),
                             group)
    out = {"metrics": [], "flat": [], "moments": []}
    for b in batches:
        m = step(state, {k: v.to(device) for k, v in b.items()})
        out["metrics"].append({k: float(v) for k, v in m.items()})
        out["flat"].append(_flat_state(state, moments=False).cpu())
        out["moments"].append(_flat_state(state).cpu())
    if nan is not None:
        before = _flat_state(state)
        m = step(state, {k: v.to(device) for k, v in nan.items()})
        out["nan"] = {"metrics": {k: float(v) for k, v in m.items()},
                      "frozen": bool(torch.equal(before, _flat_state(state)))}
    return out


def _learned_validate(root: str, ckpt: str) -> dict:
    """``Trainer.validate`` of 6b's trained checkpoint over 6b's 32 images
    (sharded over the ranks under data parallelism, each rank logging under
    its own directory): mAP@0.5, the detection count over the global
    stream, and this process's ``select`` launches."""
    extra = {"log_dir": os.path.join(root, f"runs_rank{get_rank()}")} if world_size() > 1 else {}
    trainer = Trainer(_learning_config(root, "dp_val", **extra), verbose=False, device=DEVICE)
    trainer.resume(ckpt)
    before = counts()
    map50 = trainer.validate()
    return {"map50": map50, "detections": trainer._last_val_detections,
            "launches": launched("8 validate", before), "val_batches": len(trainer.val_loader),
            "sharded": trainer._val_images_local}


def _dp_child_steps(out_path: str, learn_root: str, ckpt: str) -> None:
    """8a (and 8d on two or more cards): this rank's rows of each batch,
    then the sharded validation of 6b's trained checkpoint."""
    batches, nan = _dp_golden_batches()
    res = _golden_run(rank_device(), [shard_batch(b) for b in batches], shard_batch(nan),
                      data_parallel_group())
    res["val"] = _learned_validate(learn_root, ckpt)
    torch.save(res, out_path.format(rank=get_rank()))


def phase_dp_equality(work: str, backend: str = "gloo") -> None:
    """8a: 6a's recipe (golden yolov8-n, 160², nc=3, f32 with TF32 off) for
    DP_STEPS steps in two ranks x 4 rows (deterministic algorithms) against
    one process x 8 in this one: loss terms within STEP_LOSS_RTOL and 6a's
    state (params, statistics, EMA) within STEP_STATE_TOL after each step;
    the two ranks' states, moments included, bitwise equal; a NaN pixel in
    rank 1's rows makes both ranks skip. Then 6b's trained checkpoint is
    validated in the two ranks (each serving half of every val batch, the
    detections gathered) and in this one process: the detection count
    equal and mAP@0.5 within DP_MAP_ATOL, so that a wrong rank order or a
    dropped row fails; one ``select`` launch per val batch per rank."""
    label = "8a" if backend == "gloo" else "8d"
    out_path = os.path.join(work, "dp", f"{label}_rank{{rank}}.pt")
    learn_root = os.path.join(work, "learn")
    ckpt = os.path.join(learn_root, "runs", "learn", "weights", "last.ckpt")
    procs = _dp_spawn(work, label, "8a", DP_RANKS, out_path, learn_root, ckpt, backend=backend)
    batches, _ = _dp_golden_batches()
    solo = _golden_run(DEVICE, batches)  # while the ranks start
    solo_val = _learned_validate(learn_root, ckpt)
    _dp_wait(work, procs, label)
    ranks = [torch.load(out_path.format(rank=r), weights_only=True) for r in range(DP_RANKS)]
    worst_loss = worst_state = between = 0.0
    for i in range(DP_STEPS):
        want = solo["metrics"][i]
        for r, res in enumerate(ranks):
            got = res["metrics"][i]
            if got["skipped_nonfinite"] or got["num_fg"] != want["num_fg"]:
                raise AssertionError(f"{label}: rank {r} step {i + 1}: {got} vs {want}")
            for k in ("loss_box", "loss_cls", "loss_dfl", "total_loss"):
                rel = abs(got[k] - want[k]) / abs(want[k])
                worst_loss = max(worst_loss, rel)
                if not rel <= STEP_LOSS_RTOL:
                    raise AssertionError(f"{label}: rank {r} step {i + 1} {k} {got[k]} vs "
                                         f"{want[k]}")
            flat, ref = res["flat"][i], solo["flat"][i]
            if not torch.allclose(flat, ref, **STEP_STATE_TOL):
                raise AssertionError(f"{label}: rank {r} state after step {i + 1} differs by "
                                     f"{(flat - ref).abs().max().item()}")
            worst_state = max(worst_state, (flat - ref).abs().max().item())
        between = max(between, (ranks[0]["moments"][i] - ranks[1]["moments"][i]).abs().max().item())
    if between != 0.0:
        raise AssertionError(f"{label}: the ranks' states differ by {between}")
    for r, res in enumerate(ranks):
        if not (res["nan"]["metrics"]["skipped_nonfinite"] == 1.0 and res["nan"]["frozen"]):
            raise AssertionError(f"{label}: rank {r} did not skip the NaN step: {res['nan']}")
    map_err = 0.0
    for r, res in enumerate(ranks):
        val = res["val"]
        map_err = max(map_err, abs(val["map50"] - solo_val["map50"]))
        if not (val["sharded"] and val["detections"] == solo_val["detections"] > 0
                and abs(val["map50"] - solo_val["map50"]) <= DP_MAP_ATOL
                and val["launches"] == val["val_batches"]):
            raise AssertionError(f"{label}: rank {r}'s sharded validation {val} vs one "
                                 f"process {solo_val}")
    print(f"phase {label} data parallel f32 on the card ({backend}, {DP_RANKS} ranks x 4 rows "
          f"vs one process x 8, deterministic algorithms), golden yolov8-n 160px, 6a's recipe, "
          f"{DP_STEPS} steps: loss terms max rel err {worst_loss:.2e} (<= {STEP_LOSS_RTOL}), "
          f"params/stats/EMA max abs err {worst_state:.2e}; the ranks' states max "
          f"|diff| {between:.1e} (bitwise equal); a NaN pixel in rank 1's rows: both ranks "
          f"skipped the step, state unchanged; 6b's trained checkpoint validated sharded over "
          f"the ranks ({ranks[0]['val']['val_batches']} val batches, select launches per rank "
          f"{', '.join(str(x['val']['launches']) for x in ranks)}): "
          f"{ranks[0]['val']['detections']} detections, mAP@0.5 {ranks[0]['val']['map50']:.6f} "
          f"on both ranks vs one process {solo_val['detections']} detections, "
          f"{solo_val['map50']:.6f} (max |diff| {map_err:.1e} <= {DP_MAP_ATOL})")


def _dp_child_full(root: str, images: str, ann: str, val_images: str, val_ann: str) -> None:
    """8b, one rank: 6c's recipe at the global batch, fit and validation,
    the collectives replayed alone at the step's sizes, peak memory."""
    import torch.distributed as dist

    rank = get_rank()
    cfg = _full_config(root, images, ann, val_images, val_ann, "dp")
    cfg.training.log_dir = os.path.join(root, f"runs_rank{rank}")  # what rank 1 writes shows
    trainer = Trainer(cfg, verbose=False)
    if len(trainer.train_loader) != DP_FULL_STEPS:
        raise AssertionError(f"8b: {len(trainer.train_loader)} steps per epoch")
    inner, events, metrics = trainer._train_step, [], []

    def timed_step(state, batch):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        m = inner(state, batch)
        end.record()
        events.append((start, end))
        metrics.append(m)
        return m

    trainer._train_step = timed_step
    dist.barrier()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    # counted run of the data-parallel training path
    zero_counts()
    syncs = all_reduce_sum.calls
    t0 = time.perf_counter()
    with _quiet(os.path.join(root, f"fit_rank{rank}.log")):
        trainer.fit()
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    launches, syncs = launched("8b fit"), all_reduce_sum.calls - syncs
    peak_gib = torch.cuda.max_memory_allocated() / 2**30

    def replay_ms(sizes, reps=5):
        """Host clock around all-reduces of f32 CUDA tensors of ``sizes``
        (the ranks start together; the card synchronized before and after)."""
        bufs = [torch.zeros(n, device=trainer.device) for n in sizes]
        times = []
        for _ in range(reps + 1):
            torch.cuda.synchronize()
            dist.barrier()
            t = time.perf_counter()
            for b in bufs:
                dist.all_reduce(b)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t) * 1e3)
        return statistics.median(times[1:])

    n_params = trainer.state.params.numel()
    bn = [2 * m.num_features + 1 for m in trainer.state.model.modules()
          if isinstance(m, BatchNorm2d)]
    grad_ms = replay_ms([n_params])
    bn_ms = replay_ms(bn * 2)  # one all-reduce forward, one backward, per layer
    result = trainer._last_val_result
    torch.save(_flat_state(trainer.state).cpu(), os.path.join(root, f"final_rank{rank}.pt"))
    print("DP " + json.dumps({
        "rank": rank, "metrics": [{k: float(v) for k, v in m.items()} for m in metrics],
        "step_ms": [s.elapsed_time(e) for s, e in events], "fit_s": fit_s,
        "launches": launches, "val_batches": len(trainer.val_loader),
        "val_rows": trainer.val_loader.local_batch_size,
        "syncs_per_step": syncs / DP_FULL_STEPS, "bn_layers": len(bn),
        "grad_mb": n_params * 4 / 1e6, "grad_ms": grad_ms, "bn_ms": bn_ms,
        "peak_gib": peak_gib, "map50": float(result.get("map_50", result["map"])),
        "local_batch": trainer.train_loader.local_batch_size,
    }), flush=True)


def phase_dp_full(work: str, full: dict) -> dict:
    """8b: yolo-ms-xs, nc=80, 640², bf16, global batch 32 = 2 ranks x 16 on
    the card (gloo), 6c's recipe and cut for DP_FULL_STEPS steps, then the
    sharded validation of 6c's 64 val images. The first step's loss against
    the one-process step on the same global batch (DP_FIRST_LOSS_RTOL); the
    ranks' states bitwise equal; the same mAP on both; one ``select`` launch
    per val batch per rank; files from rank 0 only."""
    root = os.path.join(work, "dp_full")
    images, ann = make_coco_dataset(os.path.join(root, "train"),
                                    num_images=DP_FULL_STEPS * BATCH, num_classes=NC,
                                    img_w=640, img_h=480, max_objects=12, seed=2)
    _, _, _, val_images, val_ann = full["data"]
    # one process, the same first global batch
    ref = Trainer(_full_config(root, images, ann, val_images, val_ann, "solo"), verbose=False)
    batches = ref.train_loader.epoch(0)
    first = ref._to_device(ref._bucket_gt(next(batches)))
    batches.close()
    solo_loss = float(ref._train_step(ref.state, first)["total_loss"])
    del ref, first
    torch.cuda.empty_cache()

    procs = _dp_spawn(work, "b", "8b", DP_RANKS, root, images, ann, val_images, val_ann)
    _dp_wait(work, procs, "8b")
    res = [_dp_result(work, f"b{r}") for r in range(DP_RANKS)]
    for r, x in enumerate(res):
        if len(x["metrics"]) != DP_FULL_STEPS or x["local_batch"] != BATCH // DP_RANKS:
            raise AssertionError(f"8b: rank {r} ran {len(x['metrics'])} steps of "
                                 f"{x['local_batch']} rows")
        for i, m in enumerate(x["metrics"]):
            if not all(math.isfinite(v) for v in m.values()):
                raise AssertionError(f"8b: rank {r} step {i + 1} not finite: {m}")
            if m["skipped_nonfinite"] != 0.0 or m["num_fg"] <= 0:
                raise AssertionError(f"8b: rank {r} step {i + 1} skipped or without "
                                     f"positives: {m}")
        if x["launches"] != x["val_batches"]:
            raise AssertionError(f"8b: rank {r} launched select {x['launches']} times for "
                                 f"{x['val_batches']} val batches")
    first_rel = abs(res[0]["metrics"][0]["total_loss"] - solo_loss) / abs(solo_loss)
    if not first_rel <= DP_FIRST_LOSS_RTOL:
        raise AssertionError(f"8b: first step loss {res[0]['metrics'][0]['total_loss']} vs the "
                             f"one-process {solo_loss}")
    finals = [torch.load(os.path.join(root, f"final_rank{r}.pt"), weights_only=True)
              for r in range(DP_RANKS)]
    between = (finals[0] - finals[1]).abs().max().item()
    if not torch.equal(finals[0], finals[1]):
        raise AssertionError(f"8b: the ranks' final states differ by {between}")
    if res[0]["map50"] != res[1]["map50"]:
        raise AssertionError(f"8b: mAP {res[0]['map50']} on rank 0, {res[1]['map50']} on 1")
    written = os.path.join(root, "runs_rank0", "dp", "weights", "last.ckpt")
    if os.path.exists(os.path.join(root, "runs_rank1")) or not os.path.exists(written):
        raise AssertionError("8b: rank 1 wrote files, or rank 0 wrote none")
    step_ms = statistics.median(res[0]["step_ms"][2:])
    fit_s = max(x["fit_s"] for x in res)
    fit_img_s = DP_FULL_STEPS * BATCH / fit_s
    peaks = ", ".join(f"{x['peak_gib']:.2f}" for x in res)
    per_rank = ", ".join(str(x["launches"]) for x in res)
    m0 = res[0]["metrics"]
    print(f"phase 8b data parallel yolo-ms-xs nc={NC} {IMG}px bf16, global bs {BATCH} = "
          f"{DP_RANKS} gloo ranks x {BATCH // DP_RANKS} on one card, coco_yolo_ms.yaml recipe, "
          f"{DP_FULL_STEPS} steps: all finite, none skipped, num_fg "
          f"{min(m['num_fg'] for m in m0):.0f}-{max(m['num_fg'] for m in m0):.0f}; first "
          f"step loss {m0[0]['total_loss']:.4f} vs one process {solo_loss:.4f} (rel "
          f"{first_rel:.2e}); ranks bitwise equal at the end (max |diff| {between:.1e}); "
          f"{step_ms:.3f} ms/step (CUDA events, median of steps 3-{DP_FULL_STEPS}; all "
          f"{', '.join(f'{t:.1f}' for t in res[0]['step_ms'])}) beside 6c's one-process "
          f"{full['step_ms']:.3f} ms/step at bs {BATCH} in this run; end to end "
          f"{fit_img_s:.1f} img/s ({DP_FULL_STEPS * BATCH} images over the whole fit's "
          f"{fit_s:.2f} s, validation and checkpoint included); "
          f"gradient all-reduce {res[0]['grad_mb']:.1f} MB f32 {res[0]['grad_ms']:.3f} ms; "
          f"BatchNorm all-reduces {res[0]['syncs_per_step']:.0f} per step ({res[0]['bn_layers']} "
          f"layers x 2) {res[0]['bn_ms']:.3f} ms in all (both replayed alone at the step's "
          f"sizes, host clock, median of 5); peak memory per rank {peaks} GiB; sharded "
          f"validation of {FULL_VAL_IMAGES} images ({res[0]['val_rows']} rows per rank per "
          f"batch): select launches per rank {per_rank} for "
          f"{res[0]['val_batches']} val batches, mAP@0.5 {res[0]['map50']:.4f} on both ranks; "
          f"only rank 0 wrote files")
    return {"launches": sum(x["launches"] for x in res), "solo_loss": solo_loss,
            "step_ms": step_ms, "peak_gib": [x["peak_gib"] for x in res],
            "data": (root, images, ann, val_images, val_ann)}


def phase_dp_preempt(work: str) -> None:
    """8c: 7d's drill in two ranks (global batch 16 = 2 x 8, deterministic
    algorithms): U and P side by side, SIGTERM to both of P's ranks while
    step PREEMPT_SNIPE + 1 is in flight; both exit 143, only rank 0 wrote
    ``preempt.ckpt``; R, two ranks resumed from it, ends equal to U."""
    root = os.path.join(work, "learn")
    term = 128 + signal.SIGTERM
    t0 = time.perf_counter()
    u = _dp_spawn(work, "u", "8c", DP_RANKS, root, "dp_u", "-1")
    p = _dp_spawn(work, "p", "8c", DP_RANKS, root, "dp_p", str(PREEMPT_SNIPE))
    ended_p = _dp_wait(work, p, "8c", want_rc=term)
    _dp_wait(work, u, "8c")
    exit_s = []
    for name in sorted(ended_p):
        signal_at = next(float(ln.split()[1]) for ln in _dp_out(work, name).splitlines()
                         if ln.startswith("SIGNAL_AT"))
        exit_s.append(ended_p[name][1] - signal_at)
    ckpt = os.path.join(root, "runs_rank0", "dp_p", "weights", "preempt.ckpt")
    if os.path.exists(os.path.join(root, "runs_rank1")) or not os.path.exists(ckpt):
        raise AssertionError("8c: preempt.ckpt not written by rank 0 alone")
    restored = restore_checkpoint(ckpt)
    cursor = (restored["epoch"], restored["step_in_epoch"], restored["state"]["step"])
    if cursor != (1, 1, PREEMPT_SNIPE + 1):
        raise AssertionError(f"8c: preempt.ckpt cursor (epoch, step in epoch, steps) {cursor}")
    _dp_wait(work, _dp_spawn(work, "r", "8c", DP_RANKS, root, "dp_r", "-1", ckpt), "8c")
    drill_s = time.perf_counter() - t0
    worst = 0.0
    for r in range(DP_RANKS):
        want, got = (torch.load(os.path.join(root, f"dp_{e}_rank{r}_final.pt"), weights_only=True)
                     for e in ("u", "r"))
        if got["step"] != want["step"]:
            raise AssertionError(f"8c: rank {r}: {got['step']} steps vs {want['step']}")
        for part in ("model", "ema"):
            for k, v in want[part].items():
                if not v.is_floating_point():
                    continue
                if not torch.allclose(got[part][k], v, **PREEMPT_TOL):
                    raise AssertionError(f"8c: rank {r} resumed {part} {k} differs")
                worst = max(worst, (got[part][k] - v).abs().max().item())
    print(f"phase 8c data parallel preemption drill, 7d's recipe in {DP_RANKS} gloo ranks x 8 "
          f"rows (deterministic algorithms): SIGTERM to both ranks inside step "
          f"{PREEMPT_SNIPE + 1}'s in-flight window -> both exit {term}, "
          f"{', '.join(f'{t:.3f}' for t in exit_s)} s from signal to exit (ranks 0, 1; host "
          f"clock); preempt.ckpt written by rank 0 alone at epoch 1 step 1; the two-rank "
          f"resume == the uninterrupted two-rank run, max abs err {worst:.3e}; drill "
          f"{drill_s:.1f} s")


def _dp_child_nccl() -> None:
    """8d on one card: a one-rank nccl group, one all-reduce, one step."""
    import torch.distributed as dist

    t = torch.arange(4.0, device=rank_device())
    dist.all_reduce(t)
    batches, _ = _dp_golden_batches()
    m = _golden_run(rank_device(), batches[:1])["metrics"][0]
    print("DP " + json.dumps({"backend": dist.get_backend(), "sum": t.tolist(),
                              "loss": m["total_loss"], "skipped": m["skipped_nonfinite"]}),
          flush=True)


def phase_nccl(work: str) -> None:
    """8d: over nccl, one rank per card: 8a when the host has two or more
    cards; with one, the refusal of a second rank on the card and a one-rank
    nccl group (init, one all-reduce, one train step)."""
    cards = torch.cuda.device_count()
    if cards >= DP_RANKS:
        phase_dp_equality(work, backend="nccl")
        return
    import torch.distributed as dist

    try:
        maybe_initialize_distributed("nccl", world_size=2, rank=1, local_rank=1,
                                     init_method="tcp://localhost:1")
        raise AssertionError("8d: nccl accepted two ranks on one card")
    except RuntimeError as e:
        refusal = str(e).split(";")[0]
    # the port's own refusal, before init (not a failed connection to the store)
    if "has no card of its own" not in refusal or dist.is_initialized():
        raise AssertionError(f"8d: not the port's refusal before init: {refusal}")
    _dp_wait(work, _dp_spawn(work, "d", "8d", 1, backend="nccl"), "8d")
    got = _dp_result(work, "d0")
    if got["backend"] != "nccl" or got["sum"] != [0.0, 1.0, 2.0, 3.0] or got["skipped"]:
        raise AssertionError(f"8d: {got}")
    print(f"phase 8d nccl on {cards} card: a second rank on the card is refused ({refusal}); "
          f"a one-rank nccl group: init, one all-reduce, one train step (loss "
          f"{got['loss']:.4f}); a two-rank NCCL run needs two cards, so NCCL speed across "
          f"cards is not measured here")


def dp_child(kind: str, backend: str, *args: str) -> int:
    """One rank of phase 8 or 10 (``chip_smoke.py --dp-child KIND BACKEND
    ...``, torchrun's variables in the environment)."""
    if kind != "8b":
        torch.use_deterministic_algorithms(True, warn_only=True)
    maybe_initialize_distributed(backend, device=DEVICE)
    # a preempted 8c rank exits 143 from inside the trainer
    {"8a": _dp_child_steps, "8b": _dp_child_full, "8c": preempt_child,
     "8d": _dp_child_nccl, "10": _sp_child}[kind](*args)
    leave_group()
    return 0


def _load_select_of(checkout: str):
    """The select module of another checkout; it builds that checkout's
    ``csrc/select.cu`` into that checkout's ``build/``."""
    path = os.path.join(checkout, "yolo_ms_tpu_torch", "ops", "kernels", "select.py")
    spec = importlib.util.spec_from_file_location("parent_select", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def phase_parent_ab(parent: str, flush: torch.Tensor, name: str) -> None:
    """The parent checkout's select kernel against this one at the serving
    shapes, on the same inputs, timed in turns (parent, this, this, parent;
    CUDA events, L2 flushed, median of 20 each): nc 80 in each layout and
    dtype, in bf16 also each scale alone on the split maps (the main path's)
    and the NCHW views; then the split bf16 maps of 5c (nc 10) and 5b (nc
    1,203). Loading the parent's module registers its ``torch.library`` op
    under this one's name, so each kernel is called through its own
    module's ``_launch`` (one launch for all scales), never through the op."""
    old = _load_select_of(parent)
    info = old.build()
    print(f"ab parent build: {info['seconds']:.2f} s")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(3)
    sides = dict(SCALE_SETS)["serving"]

    def turns(pairs):
        boxes, clss = [list(x) for x in zip(*pairs)]
        fns = {"parent": lambda: old._launch(boxes, clss, REG_MAX),
               "this": lambda: select_mod._launch(boxes, clss, REG_MAX)}
        times = {k: [] for k in fns}
        for who in ("parent", "this", "this", "parent"):
            times[who].append(cuda_ms(fns[who], 20, flush, cover=True))
        return fns, "; ".join(f"{k} " + "/".join(f"{t * 1e3:.1f}" for t in v) + " us"
                              for k, v in times.items())

    def case(pairs, label):
        fns, timed = turns(pairs)
        want = fns["this"]()
        routes = check_routes(pairs, f"ab {label}")
        got = fns["parent"]()
        torch.cuda.synchronize()
        if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
            raise AssertionError(f"ab {label}: parent and this disagree on mx/cid")
        ltrb_err = (got[2] - want[2]).abs().max().item()
        bound = bound_of(*select_bound(pairs, name))[0]
        print(f"ab select {label} B={BATCH} HW=6400/1600/400 (bound {bound * 1e3:.1f} us, ltrb "
              f"diff {ltrb_err:.1e}; parent routes {_route_names(old.select_scales.last_routes)}, "
              f"this {_route_names(routes)}): {timed}")

    for dtype in (torch.bfloat16, torch.float32):
        for layout in LAYOUTS:
            pairs = [_layout_views(gen, BATCH, s, s, NC, dtype, layout) for s in sides]
            case(pairs, f"{str(dtype)[6:]} {layout}")
            if dtype == torch.bfloat16 and layout in ("split", "nchw"):
                for box, cls in pairs:
                    print(f"ab select bf16 {layout} HW={box.shape[1]} alone: "
                          f"{turns([(box, cls)])[1]}")
    for phase, nc in (("5c", FINETUNE_NC), ("5b", WIDE_NC)):
        pairs = [_layout_views(gen, BATCH, s, s, nc, torch.bfloat16, "split") for s in sides]
        case(pairs, f"bf16 split nc={nc} ({phase}'s maps)")


# Edited copies of csrc/select.cu that --variants times against the kernel
# as built: name -> (a line of the source, the line put in its place, the
# (dtype, nc) of the split maps at the serving scales it is timed on, and
# whether its mx and cid must equal the kernel's)
SELECT_VARIANTS = {
    "copies alone (no compute)": (
        "    if (p.scale[locate(p, tile).scale].box.route == kTma)",
        "    if (true) {} else if (p.scale[locate(p, tile).scale].box.route == kTma)",
        [(torch.bfloat16, NC), (torch.float32, NC), (torch.bfloat16, FINETUNE_NC),
         (torch.bfloat16, 3), (torch.bfloat16, WIDE_NC)], False),
    "the wide route at every class count": (
        "  const bool ring = make_plan(elem_bytes, 4 * reg_max + nc, &plan);",
        "  const bool ring = false;",
        [(torch.bfloat16, nc) for nc in (256, 400, 640, 826, 1000, 1203, 1400, 1730)], True),
    "16 lanes a class row at 32-anchor tiles": (
        "      const int lane_shift = shift >= 6 ? 2 : 3;",
        "      const int lane_shift = shift >= 6 ? 2 : 4;",
        [(torch.bfloat16, nc) for nc in (826, 1203, 1730)], True),
    "32 lanes a class row at 32-anchor tiles": (
        "      const int lane_shift = shift >= 6 ? 2 : 3;",
        "      const int lane_shift = shift >= 6 ? 2 : 5;",
        [(torch.bfloat16, nc) for nc in (826, 1203, 1730)], True),
    "three CTAs an SM (75 KB each)": (
        "constexpr int kSmemTarget = 113 * 1024;  // two CTAs per SM",
        "constexpr int kSmemTarget = 75 * 1024;",
        [(torch.bfloat16, NC), (torch.bfloat16, FINETUNE_NC), (torch.float32, FINETUNE_NC)],
        True),
    "no class walk on quad tiles": (
        "    if (Quads) class_max_lanes<Rows16>(cls_s + ar * p.nc, j, 2, p.nc, &best, &id);",
        "    ;",
        [(torch.bfloat16, NC), (torch.bfloat16, FINETUNE_NC)], False),
    "no exp in the box sums": (
        "      const float e = expf(fmaxf(x - c, -60.f));",
        "      const float e = fmaxf(x - c, -60.f);",
        [(torch.bfloat16, NC), (torch.bfloat16, FINETUNE_NC)], True),
}


def phase_select_variants(flush: torch.Tensor, name: str) -> None:
    """Each of ``SELECT_VARIANTS`` built into the ignored build directory
    (all builds started together) and timed against the kernel as built, one
    launch for the three serving scales of split maps per call, in turns
    (kernel, variant, variant, kernel; CUDA events, L2 flushed by a write,
    median of 20 each), on each of its (dtype, nc); the two outputs must
    agree on mx and cid where the variant computes."""
    src = open(select_mod.SOURCE).read()
    os.makedirs(select_mod.BUILD_DIR, exist_ok=True)
    paths = {}
    for i, (label, (old, new, *_)) in enumerate(SELECT_VARIANTS.items()):
        if src.count(old) != 1:
            raise AssertionError(f"variant {label!r}: its line is not once in select.cu")
        paths[label] = os.path.join(select_mod.BUILD_DIR, f"select_variant_{i}.cu")
        with open(paths[label], "w") as f:
            f.write(src.replace(old, new))
    with concurrent.futures.ThreadPoolExecutor(len(paths)) as pool:
        built = {label: pool.submit(select_mod.build, path) for label, path in paths.items()}
        libs = {label: select_mod.bind(f.result()["path"]) for label, f in built.items()}
    kernel = select_mod._load()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(5)
    for label, (_, _, cases, same_classes) in SELECT_VARIANTS.items():
        for dtype, nc in cases:
            pairs = [_layout_views(gen, BATCH, s, s, nc, dtype, "split")
                     for s in dict(SCALE_SETS)["serving"]]
            boxes, clss = [list(x) for x in zip(*pairs)]
            bound = bound_of(*select_bound(pairs, name))[0]
            fns = {k: (lambda lib=lib: select_mod.launch_with(lib, boxes, clss, REG_MAX))
                   for k, lib in (("kernel", kernel), ("variant", libs[label]))}
            if same_classes:
                want, got = fns["kernel"](), fns["variant"]()
                torch.cuda.synchronize()
                if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
                    raise AssertionError(f"variant {label!r} nc={nc}: mx/cid differ")
            routes = {}
            times = {k: [] for k in fns}
            for who in ("kernel", "variant", "variant", "kernel"):
                times[who].append(cuda_ms(fns[who], 20, flush, cover=True))
                routes[who] = _route_names(select_scales.last_routes)
            print(f"variant select {label}: {str(dtype)[6:]} split nc={nc} B={BATCH} "
                  f"HW=6400/1600/400 (bound {bound * 1e3:.1f} us): " + "; ".join(
                      f"{k} ({routes[k]}) " + "/".join(f"{t * 1e3:.1f}" for t in v) + " us"
                      for k, v in times.items()))
            del pairs, boxes, clss, fns


# Edited copies of nms.cu: (label, [(line(s) of the kernel, replacement)],
# whether its keep and sweeps must equal the kernel's)
_NMS_BALANCED = (
    "  const long long total = first_entry(words, k);\n"
    "  int w = 0;\n"
    "  for (long long e = threadIdx.x; e < total; e += kThreads) {\n"
    "    while (first_entry(w + 1, k) <= e) ++w;\n"
    "    const int j0 = 32 * w, i = j0 + 1 + (int)(e - first_entry(w, k));\n")
_NMS_WHOLE_ROWS = (
    "  for (int e = threadIdx.x; e < words * k; e += kThreads) {\n"
    "    const int w = e / k, i = e - w * k, j0 = 32 * w;\n"
    "    if (j0 >= i) continue;\n")
_NMS_SKIP = "  if (inter == 0.0f && uni > 0.0f) return 0.0f > thresh;\n"
NMS_VARIANTS = {
    "no skip of the quotient where boxes do not intersect": ([(_NMS_SKIP, "")], True),
    "whole rows dealt to threads": ([(_NMS_BALANCED, _NMS_WHOLE_ROWS)], True),
    "both (the first design)": ([(_NMS_SKIP, ""), (_NMS_BALANCED, _NMS_WHOLE_ROWS)], True),
    "the overlap bits alone (no sweep)": ([("  bool more = true;", "  bool more = false;")],
                                          False),
}


def phase_nms_variants(name: str) -> None:
    """Each of ``NMS_VARIANTS`` built into the ignored build directory (all
    builds started together) and timed against the kernel as built, in
    turns (kernel, variant, variant, kernel; CUDA events behind a spin
    kernel, median of 10 each), on the flagship's NMS input (yolo-ms-xs,
    phase 5's seeded weights and first batch, conf 1e-5), on K 4,096 and on
    a 1,024-box chain; keep and sweeps must equal the kernel's where the
    variant computes them."""
    src = open(nms_mod.SOURCE).read()
    os.makedirs(nms_mod.BUILD_DIR, exist_ok=True)
    paths = {}
    for i, (label, (edits, _)) in enumerate(NMS_VARIANTS.items()):
        text = src
        for old, new in edits:
            if text.count(old) != 1:
                raise AssertionError(f"nms variant {label!r}: its lines are not once in nms.cu")
            text = text.replace(old, new)
        paths[label] = os.path.join(nms_mod.BUILD_DIR, f"nms_variant_{i}.cu")
        with open(paths[label], "w") as f:
            f.write(text)
    with concurrent.futures.ThreadPoolExecutor(len(paths)) as pool:
        built = {label: pool.submit(nms_mod.build, path) for label, path in paths.items()}
        libs = {label: nms_mod.bind(f.result()["path"]) for label, f in built.items()}
    kernel = nms_mod._load()
    predictor = Predictor("yolo-ms-xs", seeded_state_dict("yolo-ms-xs", NC, seed=1),
                          num_classes=NC, input_size=(IMG, IMG), conf_thresh=1e-5,
                          batch_size=BATCH, dtype=torch.bfloat16, device="cuda")
    nspy = NmsSpy()
    nspy.label = "flagship"
    with nspy.on():
        predictor.infer(torch.from_numpy(serve_batches()[0]).cuda())
    chain_b, chain_s = _nms_random(2, 1024, 2)
    chain_b[0], chain_s[0] = _nms_chain(1024)
    cases = {"flagship": nspy.inputs["flagship"],
             "K 4096": (*_nms_random(2, 4096, 1, pad=300, classes=4), NMS_IOU),
             "chain": (chain_b, chain_s, NMS_IOU)}
    for label, (_, same) in NMS_VARIANTS.items():
        parts = []
        for case, (boxes, scores, iou) in cases.items():
            fns = {k: (lambda lib=lib: nms_mod.launch_with(lib, boxes, scores, iou))
                   for k, lib in (("kernel", kernel), ("variant", libs[label]))}
            if same:
                want, got = fns["kernel"](), fns["variant"]()
                torch.cuda.synchronize()
                if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
                    raise AssertionError(f"nms variant {label!r} {case}: keep or sweeps differ")
            times = {k: [] for k in fns}
            for who in ("kernel", "variant", "variant", "kernel"):
                times[who].append(cuda_ms(fns[who], 10, cover=True))
            parts.append(f"{case} (bs {boxes.shape[0]}, K {boxes.shape[1]}): " + ", ".join(
                f"{k} " + "/".join(f"{t * 1e3:.1f}" for t in v) + " us" for k, v in times.items()))
        print(f"variant nms {label}: " + "; ".join(parts))
    del predictor


# ---------------------------------------------------------------- phase 9

# 9b: the program against Predictor.infer on the same batches, as phase 5's
# kernel tail against the plain tail
PROGRAM_BOX_ATOL = 1e-3  # px
PROGRAM_SCORE_RTOL = 1e-5
PROGRAM_TURNS = 2  # eager and traced tails, in turns: eager, traced, traced, eager
# 9c: a fresh interpreter serves the golden programs with no model code
PROGRAM_CHILD = r"""
import json, sys
import torch
from yolo_ms_tpu_torch.data.decode import decode_and_resize, decode_image
from yolo_ms_tpu_torch.infer.program import load_program
dets = {}
for arch, path, fixture in json.loads(sys.argv[1]):
    oh, ow = decode_image(fixture).shape[:2]
    x = torch.from_numpy(decode_and_resize(fixture, 160, 160)[None]).cuda()
    with torch.inference_mode():
        out = {k: v.cpu() for k, v in load_program(path)(x).items()}
    sx, sy = ow / 160, oh / 160
    dets[arch] = [
        {"class_id": int(out["classes"][0, j]),
         "score": round(float(out["scores"][0, j]), 4),
         "box_xyxy": [round(min(max(v * s, 0.0), lim), 2) for v, s, lim in
                      zip(out["boxes"][0, j].tolist(), (sx, sy, sx, sy), (ow, oh, ow, oh))]}
        for j in out["valid"][0].nonzero().flatten().tolist()
    ]
banned = sorted(m for m in sys.modules if m.startswith("yolo_ms_tpu_torch.models")
                or m.split(".")[0] in ("jax", "flax", "yolo_ms_tpu"))
print(json.dumps({"detections": dets, "banned": banned}))
"""


class _Tail(torch.nn.Module):
    """The serving tail alone (phase 5's settings), to export and time."""

    def forward(self, maps):
        return fused_postprocess(maps, NC, conf_thresh=1e-5, pre_nms_topk=1024, max_det=300)


def serving_profile(fn, calls: int = 3) -> dict:
    """``torch.profiler`` over ``calls`` calls of ``fn``, each waited for:
    per call, the wall time, the card's kernel time (busy), the device
    operations (kernels, copies, memsets) and the host's reads of a device
    value (``aten::_local_scalar_dense``, one stall each: the NMS stop
    tests). Where the profiler records no device time, busy reads 0."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
            torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / calls
    busy_us = ops = reads = 0
    for ev in prof.key_averages():
        if ev.device_type == DeviceType.CUDA:
            busy_us += ev.self_device_time_total
            ops += ev.count
        elif ev.key == "aten::_local_scalar_dense":
            reads += ev.count
    return {"wall_ms": wall_ms, "busy_ms": busy_us / 1e3 / calls, "ops": ops / calls,
            "reads": reads / calls}


def _export_cli(log: str, *args: str) -> float:
    """``tools.export`` with ``--program``; returns its seconds."""
    t0 = time.perf_counter()
    with _quiet(log):
        tools_export.main(list(args))
    return time.perf_counter() - t0


def _same_detections(got: dict, want: dict, label: str) -> tuple[float, float]:
    """``valid`` and ``classes`` equal, boxes within PROGRAM_BOX_ATOL px and
    scores within PROGRAM_SCORE_RTOL on the valid slots; returns the worst
    box and relative score errors."""
    v = want["valid"]
    if not (np.array_equal(got["valid"], v) and np.array_equal(got["classes"][v], want["classes"][v])):
        raise AssertionError(f"{label}: valid or classes differ")
    box_err = float(np.abs(got["boxes"][v] - want["boxes"][v]).max(initial=0.0))
    score_err = float((np.abs(got["scores"][v] - want["scores"][v])
                       / np.abs(want["scores"][v])).max(initial=0.0))
    if not (box_err <= PROGRAM_BOX_ATOL and score_err <= PROGRAM_SCORE_RTOL):
        raise AssertionError(f"{label}: boxes differ by {box_err} px, scores by {score_err}")
    return box_err, score_err


def phase_program(work: str, flagship: dict, full: dict) -> dict:
    """9: the exported serving program and the pipelined ``predict_paths``.

    a. ``tools.export --program`` of both trained goldens (160², nc=3,
       batch 1), and ``tools.export.run`` + ``export_program`` of phase 5's
       seeded yolo-ms-xs (nc=80, bs=32, 640², conf 1e-5);
    b. the flagship program on phase 5's 8 batches against
       ``Predictor.infer`` on the same batches (a counted run: one ``select``
       and one ``nms`` launch per call), its ms/batch on the host clock, and
       the tail alone exported and timed against the eager tail (CUDA
       events, in turns), then all four profiled (``serving_profile``),
       with the eager tail's plain NMS loop beside them: none of the four
       may read a device value, and the program, ``infer`` and the traced
       tail run once under ``torch.cuda.set_sync_debug_mode("error")``;
    c. a child interpreter serves the golden programs through
       ``load_program`` and must import no ``yolo_ms_tpu_torch.models``
       module; its detections match the golden ones;
    d. ``predict_paths`` over 6c's 384 training images (640x480) at bs=32
       640² bf16 with the flagship predictor, sequential and pipelined in
       turns: the same results and the same files; img/s of each."""
    root = os.path.join(work, "program")
    os.makedirs(root)
    log = os.path.join(root, "export.log")
    sd_path = os.path.join(root, "flagship_state_dict.ckpt")
    save_checkpoint(sd_path, flagship["state_dict"])
    prog = os.path.join(root, "flagship.pt2")
    # the CLI serves at conf 0.25, where random weights keep nothing: the
    # flagship goes through the CLI's two steps with phase 5's conf 1e-5
    t0 = time.perf_counter()
    with _quiet(log):
        folded = os.path.join(root, "flagship.ckpt")
        tools_export.run(sd_path, folded)
        info = tools_export.export_program(
            load_serving_state_dict(folded), "yolo-ms-xs", NC, prog, batch=BATCH,
            img_size=(IMG, IMG), conf_thresh=1e-5)
    export_s = time.perf_counter() - t0
    if info["memory_format"] != "channels_last":
        raise AssertionError(f"9a: the program was exported in {info['memory_format']}")
    golden_progs = []
    for arch, gdir in GOLDENS:
        path = os.path.join(root, f"golden_{arch}.pt2")
        _export_cli(log, "--checkpoint", os.path.join(gdir, "weights.npz"),
                    "--output", os.path.join(root, f"golden_{arch}.ckpt"), "--program", path,
                    "--arch", arch, "--num_classes", "3", "--img_size", "160", "160")
        golden_progs.append((arch, path, os.path.join(gdir, "fixture_000.png")))
    print(f"phase 9a tools.export --program: yolo-ms-xs nc={NC} bs={BATCH} {IMG}px bf16 conf "
          f"1e-5, entry_layouts=auto ({info['memory_format']}, the saved file read back with "
          f"its channels-last weights under torch {torch.__version__}), in {export_s:.2f} s "
          f"(checkpoint fold and save included), "
          f"{os.path.getsize(prog) / 1e6:.1f} MB; goldens "
          + ", ".join(f"{a} {os.path.getsize(p) / 1e6:.1f} MB" for a, p, _ in golden_progs))

    # 9b: the counted run of the program, every count at 0 just before
    predictor = flagship["predictor"]
    program = load_program(prog)
    if not_channels_last(program) or predictor.serve.memory_format != torch.channels_last:
        raise AssertionError("9b: the loaded program or the predictor is not channels-last")
    prog_convs = program_epilogues(program)
    if prog_convs != deploy_convs(predictor.model):
        raise AssertionError(f"9b: the program calls the epilogue {prog_convs} times, the model "
                             f"has {deploy_convs(predictor.model)} deploy convs")
    batches = serve_batches()
    x0 = torch.from_numpy(batches[0]).cuda()

    def serve(imgs):
        with torch.inference_mode():
            out = program(torch.from_numpy(imgs).to("cuda"))
            return {k: v.cpu().numpy() for k, v in out.items()}

    serve(batches[0])  # warm-up
    zero_counts()
    host_ms, outs = [], []
    for imgs in batches:
        t0 = time.perf_counter()
        outs.append(serve(imgs))
        host_ms.append((time.perf_counter() - t0) * 1e3)
    launches = launched("9b", program_convs=prog_convs)
    if launches != SERVE_BATCHES:
        raise AssertionError(f"9b: select launched {launches} times in {SERVE_BATCHES} "
                             f"program calls")
    box_err = score_err = 0.0
    for k, (imgs, got) in enumerate(zip(batches, outs)):
        check_outputs(got, "9b program")
        errs = _same_detections(got, predictor.predict_batch(imgs), f"9b batch {k}")
        box_err, score_err = max(box_err, errs[0]), max(score_err, errs[1])
    with torch.no_grad():
        raw = predictor.model(predictor.serve.network_input(x0), split_head=True)
        maps = [(b.permute(0, 2, 3, 1), c.permute(0, 2, 3, 1)) for b, c in raw]
        t0 = time.perf_counter()
        tail = torch.export.export(_Tail(), (maps,), strict=False).module()
        tail_export_s = time.perf_counter() - t0
    with torch.inference_mode():
        _same_detections({k: v.cpu().numpy() for k, v in tail(maps).items()},
                         {k: v.cpu().numpy() for k, v in _Tail()(maps).items()}, "9b tail")
        eager_ms, traced_ms = [], []
        for _ in range(PROGRAM_TURNS):
            eager_ms.append(cuda_ms(lambda: _Tail()(maps), 5))
            traced_ms.append(cuda_ms(lambda: tail(maps), 5))
            traced_ms.append(cuda_ms(lambda: tail(maps), 5))
            eager_ms.append(cuda_ms(lambda: _Tail()(maps), 5))
        program_ms = cuda_ms(lambda: program(x0), 5)
        # where the program's extra device time goes: the same input through
        # the program and the eager function, whole and tail alone, profiled
        sweeps0 = int(nms_fixed.sweeps)
        with profiler.recording():
            _Tail()(maps)
        sweeps = int(nms_fixed.sweeps) - sweeps0
        prof = {"program": serving_profile(lambda: program(x0)),
                "infer": serving_profile(lambda: predictor.infer(x0)),
                "tail traced": serving_profile(lambda: tail(maps)),
                "tail eager": serving_profile(lambda: _Tail()(maps))}
        with plain_nms():
            prof["tail eager, plain NMS loop"] = serving_profile(lambda: _Tail()(maps))
        # nothing in the serving function waits for the card: any operation
        # that would raises in this mode
        torch.cuda.set_sync_debug_mode("error")
        try:
            program(x0)
            predictor.infer(x0)
            tail(maps)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    for key in ("program", "infer", "tail traced", "tail eager"):
        if prof[key]["reads"]:
            raise AssertionError(f"9b: {key} read a device value {prof[key]['reads']} times "
                                 f"per call")
    med = statistics.median(host_ms)
    print(f"phase 9b program yolo-ms-xs bs={BATCH} {IMG}px bf16: {med:.3f} ms/batch (host "
          f"clock, median of {SERVE_BATCHES}, uint8 numpy in -> numpy out) beside phase 5's "
          f"predict_batch {flagship['host_ms']:.3f} ms; device {program_ms:.3f} ms per call "
          f"(CUDA events) beside phase 5's infer {flagship['infer_ms']:.3f} ms; post-process "
          f"alone, traced {' / '.join(f'{t:.3f}' for t in traced_ms)} ms against eager "
          f"{' / '.join(f'{t:.3f}' for t in eager_ms)} ms (CUDA events, in turns; the tail "
          f"exported in {tail_export_s:.2f} s); select and nms launches {launches} each in "
          f"{SERVE_BATCHES} calls; against Predictor.infer: valid and classes equal, boxes "
          f"max abs err {box_err:.3e} px, scores max rel err {score_err:.3e}; the program, "
          f"infer and the traced tail ran under torch.cuda.set_sync_debug_mode('error')")
    for name, p in prof.items():
        busy = f"{p['busy_ms']:.3f}" if p["busy_ms"] else "not measured"
        idle = f"{p['wall_ms'] - p['busy_ms']:.3f}" if p["busy_ms"] else "not measured"
        print(f"phase 9b torch.profiler {name}: {p['wall_ms']:.3f} ms wall per call, kernel "
              f"time {busy} ms, card idle {idle} ms, {p['ops']:.0f} device operations, "
              f"{p['reads']:.0f} host reads of a device value ({sweeps} NMS sweeps per call)")
    traced, eager = prof["tail traced"], prof["tail eager"]
    if traced["busy_ms"] and eager["busy_ms"]:
        gap = (traced["wall_ms"] - traced["busy_ms"]) - (eager["wall_ms"] - eager["busy_ms"])
        print(f"phase 9b traced tail's extra card idle {gap:.3f} ms per call = "
              f"{gap / max(sweeps, 1) * 1e3:.1f} us per NMS sweep")

    # 9c: a fresh interpreter with no model code
    env = dict(os.environ, PYTHONPATH=ROOT)
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-c", PROGRAM_CHILD, json.dumps(golden_progs)],
                          cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    child_s = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"9c: the serving child failed ({proc.returncode}):\n{proc.stderr}")
    child = json.loads(proc.stdout.strip().splitlines()[-1])
    print(f"phase 9c child interpreter served the golden programs in {child_s:.2f} s; "
          f"banned modules imported: {child['banned']}")
    if child["banned"]:
        raise AssertionError(f"9c: the serving child imported {child['banned']}")
    for arch, _, fixture in golden_progs:
        with open(os.path.join(os.path.dirname(fixture), "fixture_000_detections.json")) as f:
            match_golden(child["detections"][arch], json.load(f))
        print(f"phase 9c golden {arch} from its program: {len(child['detections'][arch])} "
              f"detections match (scores {[d['score'] for d in child['detections'][arch]]})")

    # 9d: predict_paths, sequential against pipelined, in turns
    _, images, _, _, _ = full["data"]
    n_images = len(glob.glob(os.path.join(images, "*.jpg")))
    dirs = {"sequential": os.path.join(root, "seq"), "pipelined": os.path.join(root, "pipe")}
    rates = {"sequential": [], "pipelined": []}
    zero_counts()
    results = {}
    for mode in ("sequential", "pipelined", "pipelined", "sequential"):
        t0 = time.perf_counter()
        serve_paths = (predictor.predict_paths if mode == "pipelined"
                       else predictor._predict_paths_sequential)
        got = serve_paths(images, dirs[mode], verbose=False)
        rates[mode].append(n_images / (time.perf_counter() - t0))
        if got != results.setdefault(mode, got) or got != results["sequential"]:
            raise AssertionError(f"9d: {mode} predict_paths results differ")
    pp_launches = launched("9d")
    if pp_launches != 4 * math.ceil(n_images / BATCH):
        raise AssertionError(f"9d: select launched {pp_launches} times in 4 runs of "
                             f"{n_images} images")
    names = sorted(os.listdir(dirs["sequential"]))
    if len(names) != 2 * n_images or names != sorted(os.listdir(dirs["pipelined"])):
        raise AssertionError("9d: the two runs wrote different files")
    for name in names:
        with open(os.path.join(dirs["sequential"], name), "rb") as a, \
                open(os.path.join(dirs["pipelined"], name), "rb") as b:
            if a.read() != b.read():
                raise AssertionError(f"9d: {name} differs between the two runs")
    n_dets = sum(len(d) for d in results["sequential"].values())
    print(f"phase 9d predict_paths yolo-ms-xs bs={BATCH} {IMG}px bf16 conf 1e-5 over "
          f"{n_images} 640x480 JPEGs (decode, serve, draw, write JPEG and JSON): sequential "
          f"{' / '.join(f'{r:.1f}' for r in rates['sequential'])} img/s, pipelined "
          f"{' / '.join(f'{r:.1f}' for r in rates['pipelined'])} img/s (host clock around "
          f"each call, in turns); select launches {pp_launches} in 4 runs; results equal "
          f"({n_dets} detections), {len(names)} files byte-equal")

    return {"program": launches, "predict_paths": pp_launches,
            "program_nchw": phase_program_default(root, folded, flagship, med)}


def phase_program_default(root: str, folded: str, flagship: dict, auto_ms: float) -> int:
    """9e: the flagship's folded checkpoint (9a's) exported with
    ``entry_layouts="default"``, the NCHW program, read back and held
    against ``Predictor(entry_layouts="default").infer`` on phase 5's
    batches by 9b's rules; a counted run: one ``select`` launch per call,
    each on the TMA route. Returns the launches."""
    log = os.path.join(root, "export.log")
    batches = serve_batches()
    prog_nchw = os.path.join(root, "flagship_nchw.pt2")
    t0 = time.perf_counter()
    with _quiet(log):
        info = tools_export.export_program(
            load_serving_state_dict(folded), "yolo-ms-xs", NC, prog_nchw, batch=BATCH,
            img_size=(IMG, IMG), conf_thresh=1e-5, entry_layouts="default")
    nchw_export_s = time.perf_counter() - t0
    if info["memory_format"] != "contiguous_format":
        raise AssertionError(f"9e: the NCHW program runs in {info['memory_format']}")
    nchw = load_program(prog_nchw)
    nchw_convs = program_epilogues(nchw)
    if nchw_convs != deploy_convs(flagship["predictor"].model):
        raise AssertionError(f"9e: the program calls the epilogue {nchw_convs} times")

    def serve_nchw(imgs):
        with torch.inference_mode():
            out = nchw(torch.from_numpy(imgs).to("cuda"))
            return {k: v.cpu().numpy() for k, v in out.items()}

    reference = Predictor("yolo-ms-xs", flagship["state_dict"], num_classes=NC,
                          input_size=(IMG, IMG), conf_thresh=1e-5, batch_size=BATCH,
                          dtype=torch.bfloat16, entry_layouts="default", device="cuda")
    serve_nchw(batches[0])  # warm-up
    zero_counts()
    nchw_ms, outs = [], []
    for imgs in batches:
        n = select.launches
        t0 = time.perf_counter()
        outs.append(serve_nchw(imgs))
        nchw_ms.append((time.perf_counter() - t0) * 1e3)
        if select.launches != n + 1 or select_scales.last_routes != [("tma", "tma")] * 3:
            raise AssertionError(f"9e: {select.launches - n} select launches, routes "
                                 f"{select_scales.last_routes}")
    nchw_launches = launched("9e", program_convs=nchw_convs)
    box_err = score_err = 0.0
    for k, (imgs, got) in enumerate(zip(batches, outs)):
        check_outputs(got, "9e program")
        errs = _same_detections(got, reference.predict_batch(imgs), f"9e batch {k}")
        box_err, score_err = max(box_err, errs[0]), max(score_err, errs[1])
    print(f"phase 9e program entry_layouts=default (contiguous NCHW) yolo-ms-xs bs={BATCH} "
          f"{IMG}px bf16 conf 1e-5: exported in {nchw_export_s:.2f} s, "
          f"{os.path.getsize(prog_nchw) / 1e6:.1f} MB; {statistics.median(nchw_ms):.3f} ms/batch "
          f"(host clock, median of {SERVE_BATCHES}) beside the auto program's {auto_ms:.3f}; "
          f"select launches {nchw_launches} in {SERVE_BATCHES} calls, each on the TMA route; "
          f"against Predictor(entry_layouts=\"default\").infer: valid and classes equal, boxes "
          f"max abs err {box_err:.3e} px, scores max rel err {score_err:.3e}")
    return nchw_launches


# ---------------------------------------------------------------- phase 10

# gloo ranks on the one card: 2 and then 4. 10a runs on the (world // 2, 2)
# mesh, 10c height-sharded over all the ranks, 10b on the 4 ranks' (2, 2)
SP_WORLDS = (2, 4)
SP_TIMEOUT = 400  # seconds for each group of ranks
# 10a: the JAX spatial test's rules (tests/test_spatial_sharding.py:152-177)
SP_LOSS_RTOL = 1e-5
SP_STEP2_FG = 2
SP_STEP2_LOSS_RTOL = 5e-2
SP_STEP2_PARAM_REL = 1e-2
# 10c: the serving tolerances of tests/test_spatial_sharding.py:49-55
SP_SCORE_RTOL = 1e-5
SP_BOX_TOL = dict(rtol=1e-4, atol=1e-3)
SP_FLAGSHIP_IMG = 1280
SP_SERVE_CALLS = 5  # per model; the first is a warm-up


def _sp_serve_cases() -> list:
    """10c's models: both trained goldens on their fixture (160², nc 3, conf
    0.25) and yolo-ms-xs with phase 5's seeded weights on one seeded 1280²
    image (nc 80, conf 1e-5), all served in f32 with TF32 off."""
    import cv2

    cases = []
    for arch, gdir in GOLDENS:
        bgr = cv2.imread(os.path.join(gdir, "fixture_000.png"))
        cases.append({"name": f"golden {arch}", "arch": arch, "nc": 3, "img": 160,
                      "conf": 0.25, "sd": load_npz(os.path.join(gdir, "weights.npz")),
                      "rgb": cv2.cvtColor(bgr, cv2.COLOR_BGR2RGB), "golden": gdir})
    u8 = np.random.default_rng(7).integers(
        0, 256, (1, SP_FLAGSHIP_IMG, SP_FLAGSHIP_IMG, 3), dtype=np.uint8)
    cases.append({"name": "yolo-ms-xs", "arch": "yolo-ms-xs", "nc": NC, "img": SP_FLAGSHIP_IMG,
                  "conf": 1e-5, "sd": seeded_state_dict("yolo-ms-xs", NC, seed=1), "u8": u8})
    return cases


def _sp_predictor(case: dict, device, max_det: int = 300) -> Predictor:
    return Predictor(case["arch"], case["sd"], num_classes=case["nc"],
                     input_size=(case["img"], case["img"]), conf_thresh=case["conf"],
                     iou_thresh=0.45, max_det=max_det, dtype=torch.float32, device=device)


def _sp_input(predictor: Predictor, case: dict):
    """One image as a uint8 batch on the predictor's device, and its meta."""
    if "rgb" in case:
        inp, meta = predictor._preprocess(case["rgb"])
        return torch.from_numpy(inp[None]).to(predictor.device), meta
    return torch.from_numpy(case["u8"]).to(predictor.device), None


def _sp_select_check(predictor: Predictor, x: torch.Tensor, label: str, mesh=None) -> dict:
    """``select_scales`` against ``select_scales_plain`` on the maps that 10c
    serves it (the head's split maps as [B, HW, C] views, f32): of one
    process, or on ``mesh`` those of the sharded forward, gathered to full
    height. These launches are not 10c's count."""
    rows = mesh.shards.rows(x.shape[1]) if mesh else contextlib.nullcontext()
    with torch.inference_mode(), full_f32(), rows:
        own = mesh.shards.own_rows(x, 1) if mesh else x
        raw = predictor.model(predictor.serve.network_input(own), split_head=True)
    pairs = [(b.permute(0, 2, 3, 1).flatten(1, 2), c.permute(0, 2, 3, 1).flatten(1, 2))
             for b, c in raw]
    err, routes, _ = compare_select(pairs, torch.float32, label)
    return {"err": err, "hw": [b.shape[1] for b, _ in pairs], "routes": _route_names(routes)}


def _sp_timed(fn, before=lambda: None) -> tuple[dict, list, float]:
    """SP_SERVE_CALLS calls of ``fn``: the last output, each call's select
    launches, and the median host-clock ms of the calls after the first."""
    times, launches = [], []
    for _ in range(SP_SERVE_CALLS):
        torch.cuda.synchronize()
        before()
        n, t0 = counts(), time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        launches.append(launched("10c", n))
    return {k: v.cpu() for k, v in out.items()}, launches, statistics.median(times[1:])


def _sp_child_steps(mesh) -> dict:
    """10a, one rank: 6a's recipe from the golden yolov8-n, two steps on this
    rank's part of 6a's batch of 8."""
    dev = rank_device()
    batch = hybrid_batch_sharding(mesh)(_seeded_train_batch(8, 160, 3, seed=5))
    state, step = _sgd_state(dev, load_npz(os.path.join(GOLDENS[0][1], "weights.npz")),
                             mesh=mesh)
    local = {k: v.to(dev) if torch.is_tensor(v) else v for k, v in batch.items()}
    out, before = {"metrics": [], "flat": [], "moments": []}, mesh.shards.exchanges
    for _ in range(2):
        m = step(state, local)
        out["metrics"].append({k: float(v) for k, v in m.items()})
        out["flat"].append(_flat_state(state, moments=False).cpu())
        out["moments"].append(_flat_state(state).cpu())
    out["exchanges"] = (mesh.shards.exchanges - before) / 2
    out["rows"] = list(local["images"].shape[:2])
    return out


def _sp_child_serve(mesh) -> dict:
    """10c, one rank: each model served height-sharded over the mesh's
    spatial group, the ranks starting each call together."""
    import torch.distributed as dist

    out = {}
    for case in _sp_serve_cases():
        predictor = _sp_predictor(case, rank_device())
        set_spatial_group(predictor.model, mesh)
        x, _ = _sp_input(predictor, case)
        before = mesh.shards.exchanges
        res, launches, ms = _sp_timed(lambda: serve_height_sharded(predictor.infer, x, mesh),
                                      dist.barrier)
        out[case["name"]] = {"out": res, "launches": launches, "ms": ms,
                             "exchanges": (mesh.shards.exchanges - before) / SP_SERVE_CALLS}
        if "golden" not in case:
            out[case["name"]]["select"] = _sp_select_check(
                predictor, x, f"10c {case['name']} S={mesh.spatial} rank {get_rank()}", mesh)
    return out


def _sp_child_full(root: str, images: str, ann: str, val_images: str, val_ann: str) -> dict:
    """10b, one rank: 8b's recipe, set and cut with ``parallel.spatial = 2``
    (a (2, 2) mesh), fit and validation; the halo exchanges of the third
    step recorded and replayed alone; peak memory."""
    import torch.distributed as dist

    rank = get_rank()
    cfg = _full_config(root, images, ann, val_images, val_ann, "sp")
    cfg.training.log_dir = os.path.join(root, f"sp_runs_rank{rank}")  # what others write shows
    cfg.parallel.spatial = 2
    trainer = Trainer(cfg, verbose=False)
    if len(trainer.train_loader) != DP_FULL_STEPS:
        raise AssertionError(f"10b: {len(trainer.train_loader)} steps per epoch")
    shards = trainer.mesh.shards
    inner, events, metrics = trainer._train_step, [], []
    send_recv, recorded, record = shards._send_recv, [], [False]

    def recording(sends, recvs):
        if record[0]:
            recorded.append(tuple({r: (t.shape, t.dtype) for r, t in d.items()}
                                  for d in (sends, recvs)))
        return send_recv(sends, recvs)

    def timed_step(state, batch):
        record[0] = len(events) == 2  # the third step
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        m = inner(state, batch)
        end.record()
        events.append((start, end))
        metrics.append(m)
        return m

    shards._send_recv = recording
    trainer._train_step = timed_step
    dist.barrier()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    # counted run of the hybrid training path
    zero_counts()
    exchanges, syncs = shards.exchanges, all_reduce_sum.calls
    t0 = time.perf_counter()
    with _quiet(os.path.join(root, f"sp_fit_rank{rank}.log")):
        trainer.fit()
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    launches = launched("10b fit")
    exchanges, syncs = shards.exchanges - exchanges, all_reduce_sum.calls - syncs
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    shards._send_recv = send_recv

    def zeros(spec):
        return {shards.ranks[r]: torch.zeros(shape, dtype=dt, device=trainer.device)
                for r, (shape, dt) in spec.items()}

    bufs = [(zeros(sends), zeros(recvs)) for sends, recvs in recorded]
    nbytes = sum(t.numel() * t.element_size() for pair in bufs for d in pair for t in d.values())
    times = []
    for _ in range(6):
        torch.cuda.synchronize()
        dist.barrier()
        t = time.perf_counter()
        for sends, recvs in bufs:
            exchange(sends, recvs, shards.group)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t) * 1e3)
    result = trainer._last_val_result
    torch.save(_flat_state(trainer.state).cpu(), os.path.join(root, f"sp_final_rank{rank}.pt"))
    return {
        "metrics": [{k: float(v) for k, v in m.items()} for m in metrics],
        "step_ms": [s.elapsed_time(e) for s, e in events], "fit_s": fit_s,
        "launches": launches, "val_batches": len(trainer.val_loader),
        "exchanges_per_step": exchanges / DP_FULL_STEPS, "syncs_per_step": syncs / DP_FULL_STEPS,
        "recorded": len(recorded), "halo_mb": nbytes / 1e6, "halo_ms": statistics.median(times[1:]),
        "halo_dtypes": sorted({str(dt) for s_, r_ in recorded for d in (s_, r_)
                               for _, dt in d.values()}),
        "peak_gib": peak_gib, "map50": float(result.get("map_50", result["map"])),
        "rows": [trainer.train_loader.local_batch_size, IMG // 2],
    }


def _sp_child(work: str, *data: str) -> None:
    """One rank of phase 10: 10a, 10c and, in 4 ranks, 10b; the results in
    ``work/sp/w{world}_rank{r}.pt``."""
    torch.set_num_threads(2)  # 4 ranks on the host's 8 cores
    world = world_size()
    res = {"10a": _sp_child_steps(make_mesh_2d(world // 2, 2)),
           "10c": _sp_child_serve(make_mesh_2d(1, world))}
    if world == 4:
        torch.use_deterministic_algorithms(False)  # 10b is timed, as 8b
        res["10b"] = _sp_child_full(*data)
    torch.save(res, os.path.join(work, "sp", f"w{world}_rank{get_rank()}.pt"))


def _sp_serve_reference() -> dict:
    """10c in one process on the card: each model's detections, every NMS
    survivor (``max_det`` = ``pre_nms_topk``), ms per image."""
    ref = {}
    for case in _sp_serve_cases():
        predictor = _sp_predictor(case, DEVICE)
        x, meta = _sp_input(predictor, case)
        out, launches, ms = _sp_timed(lambda: predictor.infer(x))
        pool = _sp_predictor(case, DEVICE, max_det=predictor.pre_nms_topk).infer(x)
        ref[case["name"]] = {"out": out, "ms": ms, "meta": meta, "predictor": predictor,
                             "pool": {k: v.cpu() for k, v in pool.items()},
                             "golden": case.get("golden")}
        if "golden" not in case:
            ref[case["name"]]["select"] = _sp_select_check(
                predictor, x, f"10c {case['name']} one process")
    return ref


def _sp_same(got: dict, want: dict, pool: dict, label: str) -> bool:
    """``got`` against one process's ``want`` at SP_SCORE_RTOL / SP_BOX_TOL:
    valid flags and scores slot by slot, and each detection a distinct
    one-process NMS survivor (``pool``) of the same class, box and score, so
    that near-equal scores may come in another order. True when bitwise
    equal."""
    g, w, p = ({k: v.numpy() for k, v in d.items()} for d in (got, want, pool))
    if not np.array_equal(g["valid"], w["valid"]):
        raise AssertionError(f"{label}: valid flags differ")
    for b in range(len(w["valid"])):
        v = w["valid"][b]
        if not np.allclose(g["scores"][b][v], w["scores"][b][v], rtol=SP_SCORE_RTOL, atol=0):
            raise AssertionError(f"{label}: scores differ")
        left = [(c, bx, sc) for c, bx, sc, ok in zip(p["classes"][b], p["boxes"][b],
                                                     p["scores"][b], p["valid"][b]) if ok]
        for c, bx, sc in zip(g["classes"][b][v], g["boxes"][b][v], g["scores"][b][v]):
            hit = next((i for i, (wc, wb, ws) in enumerate(left)
                        if wc == c and np.allclose(bx, wb, **SP_BOX_TOL)
                        and np.isclose(sc, ws, rtol=SP_SCORE_RTOL, atol=0)), None)
            if hit is None:
                raise AssertionError(f"{label}: no one-process detection of class {c}, box {bx}")
            left.pop(hit)
    return all(np.array_equal(g[k], w[k]) for k in g)


def phase_spatial(work: str, full: dict, dp: dict) -> dict:
    """Phase 10: hybrid data x spatial training and height-sharded serving
    in gloo ranks on the one card (2 ranks, then 4), against one process in
    this one."""
    os.makedirs(os.path.join(work, "sp"), exist_ok=True)
    batch = _seeded_train_batch(8, 160, 3, seed=5)
    solo = _golden_run(DEVICE, [batch, batch])
    serve_ref = _sp_serve_reference()
    root = dp["data"][0]
    ranks = {}
    for world in SP_WORLDS:
        t0 = time.perf_counter()
        _dp_wait(work, _dp_spawn(work, f"sp{world}_", "10", world, work, *dp["data"]),
                 f"10 ({world} ranks)", timeout=SP_TIMEOUT)
        ranks[world] = [torch.load(os.path.join(work, "sp", f"w{world}_rank{r}.pt"),
                                   weights_only=False) for r in range(world)]
        print(f"phase 10 {world} gloo ranks on one card: {time.perf_counter() - t0:.1f} s")

    # 10a: each rank against one process; the ranks bitwise equal
    n_params = sum(p.numel() for p in build_model("n", num_classes=3, device="cpu").parameters())
    for world in SP_WORLDS:
        res = [x["10a"] for x in ranks[world]]
        worst_loss = worst_state = 0.0
        for r, x in enumerate(res):
            got, want = x["metrics"], solo["metrics"]
            if got[0]["skipped_nonfinite"] or got[0]["num_fg"] != want[0]["num_fg"] or not (
                    want[0]["num_fg"] > 0):
                raise AssertionError(f"10a: rank {r} of {world} step 1 {got[0]} vs {want[0]}")
            for k in ("loss_box", "loss_cls", "loss_dfl", "total_loss"):
                rel = abs(got[0][k] - want[0][k]) / abs(want[0][k])
                worst_loss = max(worst_loss, rel)
                if not rel <= SP_LOSS_RTOL:
                    raise AssertionError(f"10a: rank {r} of {world} step 1 {k} {got[0][k]} vs "
                                         f"{want[0][k]}")
            if not torch.allclose(x["flat"][0], solo["flat"][0], **STEP_STATE_TOL):
                raise AssertionError(f"10a: rank {r} of {world} state after step 1 differs by "
                                     f"{(x['flat'][0] - solo['flat'][0]).abs().max().item()}")
            worst_state = max(worst_state, (x["flat"][0] - solo["flat"][0]).abs().max().item())
            a, b = x["flat"][1][:n_params], solo["flat"][1][:n_params]
            param_rel = float(torch.linalg.norm(a - b) / torch.linalg.norm(b))
            fg_gap = abs(got[1]["num_fg"] - want[1]["num_fg"])
            loss2_rel = abs(got[1]["total_loss"] - want[1]["total_loss"]) / abs(want[1]["total_loss"])
            if not (got[1]["num_fg"] > 0 and fg_gap <= SP_STEP2_FG
                    and loss2_rel <= SP_STEP2_LOSS_RTOL and param_rel < SP_STEP2_PARAM_REL):
                raise AssertionError(f"10a: rank {r} of {world} step 2: num_fg {got[1]['num_fg']} "
                                     f"vs {want[1]['num_fg']}, loss rel {loss2_rel}, params rel "
                                     f"{param_rel}")
        for x in res[1:]:
            if not all(torch.equal(a, b) for a, b in zip(x["moments"], res[0]["moments"])):
                raise AssertionError(f"10a: the {world} ranks' states differ")
        d = world // 2
        print(f"phase 10a hybrid data x spatial f32 (TF32 off, deterministic algorithms) on the "
              f"card, ({d}, 2) mesh = {world} gloo ranks, golden yolov8-n 160px, 6a's batch of 8 "
              f"and recipe, 2 steps vs one process: step 1 loss terms max rel err "
              f"{worst_loss:.2e} (<= {SP_LOSS_RTOL}), num_fg {res[0]['metrics'][0]['num_fg']:.0f} "
              f"equal, params/stats/EMA max abs err {worst_state:.2e}; step 2 num_fg "
              f"{res[0]['metrics'][1]['num_fg']:.0f} vs {solo['metrics'][1]['num_fg']:.0f}, loss "
              f"rel err {loss2_rel:.2e} (< {SP_STEP2_LOSS_RTOL}), params rel norm "
              f"{param_rel:.2e} (< {SP_STEP2_PARAM_REL}); the ranks' states bitwise equal; "
              f"{res[0]['rows'][0]} images x {res[0]['rows'][1]} rows per rank (the 5-row P5 map "
              f"split 2/3); {res[0]['exchanges']:.0f} exchanges per step per rank")

    # 10b: the 4 ranks' (2, 2) fit against one process's first step (8b's)
    res = [x["10b"] for x in ranks[4]]
    for r, x in enumerate(res):
        if len(x["metrics"]) != DP_FULL_STEPS:
            raise AssertionError(f"10b: rank {r} ran {len(x['metrics'])} steps")
        for i, m in enumerate(x["metrics"]):
            if not all(math.isfinite(v) for v in m.values()):
                raise AssertionError(f"10b: rank {r} step {i + 1} not finite: {m}")
            if m["skipped_nonfinite"] != 0.0 or m["num_fg"] <= 0:
                raise AssertionError(f"10b: rank {r} step {i + 1} skipped or without "
                                     f"positives: {m}")
        if x["launches"] != x["val_batches"]:
            raise AssertionError(f"10b: rank {r} launched select {x['launches']} times for "
                                 f"{x['val_batches']} val batches")
        if x["map50"] != res[0]["map50"]:
            raise AssertionError(f"10b: mAP {x['map50']} on rank {r}, {res[0]['map50']} on 0")
    first_rel = abs(res[0]["metrics"][0]["total_loss"] - dp["solo_loss"]) / abs(dp["solo_loss"])
    if not first_rel <= DP_FIRST_LOSS_RTOL:
        raise AssertionError(f"10b: first step loss {res[0]['metrics'][0]['total_loss']} vs the "
                             f"one-process {dp['solo_loss']}")
    finals = [torch.load(os.path.join(root, f"sp_final_rank{r}.pt"), weights_only=True)
              for r in range(4)]
    if not all(torch.equal(f, finals[0]) for f in finals[1:]):
        raise AssertionError("10b: the ranks' final states differ")
    written = os.path.join(root, "sp_runs_rank0", "sp", "weights", "last.ckpt")
    if not os.path.exists(written) or any(
            os.path.exists(os.path.join(root, f"sp_runs_rank{r}")) for r in (1, 2, 3)):
        raise AssertionError("10b: a rank other than 0 wrote files, or rank 0 wrote none")
    step_ms = statistics.median(res[0]["step_ms"][2:])
    fit_s = max(x["fit_s"] for x in res)
    m0 = res[0]["metrics"]
    peaks = ", ".join(f"{x['peak_gib']:.2f}" for x in res)
    print(f"phase 10b hybrid data x spatial yolo-ms-xs nc={NC} {IMG}px bf16, global bs {BATCH} "
          f"on a (2, 2) mesh = 4 gloo ranks on one card ({res[0]['rows'][0]} images x "
          f"{res[0]['rows'][1]} rows each), coco_yolo_ms.yaml recipe, {DP_FULL_STEPS} steps: all "
          f"finite, none skipped, num_fg {min(m['num_fg'] for m in m0):.0f}-"
          f"{max(m['num_fg'] for m in m0):.0f}; first step loss {m0[0]['total_loss']:.4f} vs "
          f"one process {dp['solo_loss']:.4f} (rel {first_rel:.2e}); ranks bitwise equal at the "
          f"end; {step_ms:.3f} ms/step (CUDA events, median of steps 3-{DP_FULL_STEPS}; all "
          f"{', '.join(f'{t:.1f}' for t in res[0]['step_ms'])}) beside 6c's one process "
          f"{full['step_ms']:.3f} and 8b's 2 x 16 {dp['step_ms']:.3f} ms/step in this run; end to "
          f"end {DP_FULL_STEPS * BATCH / fit_s:.1f} img/s ({DP_FULL_STEPS * BATCH} images over "
          f"the whole fit's {fit_s:.2f} s, validation and checkpoint included); halo exchanges "
          f"{res[0]['exchanges_per_step']:.0f} per step per rank, the third step's "
          f"{res[0]['recorded']} replayed alone {res[0]['halo_ms']:.3f} ms on rank 0 "
          f"({res[0]['halo_mb']:.2f} MB sent + received, {'/'.join(res[0]['halo_dtypes'])}, "
          f"host clock, median of 5); BatchNorm all-reduces {res[0]['syncs_per_step']:.0f} per "
          f"step; peak memory per rank {peaks} GiB "
          f"beside 8b's {', '.join(f'{g:.2f}' for g in dp['peak_gib'])} GiB; validation "
          f"sharded over data only ({res[0]['val_batches']} val batches, select launches per "
          f"rank {', '.join(str(x['launches']) for x in res)}), mAP@0.5 {res[0]['map50']:.4f} "
          f"on every rank; only rank 0 wrote files")

    # 10c: each model on S ranks against one process; the goldens' detections
    serve_launches = 0
    for world in SP_WORLDS:
        for name, ref in serve_ref.items():
            outs = [x["10c"][name] for x in ranks[world]]
            exact = True
            for r, x in enumerate(outs):
                exact &= _sp_same(x["out"], ref["out"], ref["pool"], f"10c {name} S={world} rank {r}")
                if x["launches"] != [1] * SP_SERVE_CALLS:
                    raise AssertionError(f"10c {name}: rank {r} select launches {x['launches']}")
                serve_launches += sum(x["launches"])
            n = int(ref["out"]["valid"].sum())
            matched = ""
            if ref["golden"]:
                with open(os.path.join(ref["golden"], "fixture_000_detections.json")) as f:
                    golden = json.load(f)
                for x in outs:
                    out = {k: v.numpy() for k, v in x["out"].items()}
                    match_golden(ref["predictor"]._to_detections(out, 0, ref["meta"]), golden)
                matched = ", the checked-in golden detections matched on every rank"
            if "select" in ref:
                hws = "/".join(str(hw) for hw in ref["select"]["hw"])
                matched = (f"; select vs select_scales_plain on the served f32 maps (B=1, HW "
                           f"{hws}, nc={NC}): mx, cid equal, ltrb max err "
                           f"{ref['select']['err']:.3e} one process, "
                           f"{max(x['select']['err'] for x in outs):.3e} on the {world} ranks' "
                           f"gathered maps (<= {LTRB_ATOL[torch.float32]}; route "
                           f"{ref['select']['routes']})")
            print(f"phase 10c serve {name} height-sharded over S={world} gloo ranks, f32 (TF32 "
                  f"off): {n} detections on every rank, equal to one process "
                  f"({'bitwise' if exact else 'within the tolerances'}){matched}; select launches "
                  f"1 per call per rank; {outs[0]['exchanges']:.0f} exchanges per call; "
                  f"{outs[0]['ms']:.3f} ms/image (host clock, median of {SP_SERVE_CALLS - 1}, "
                  f"rank 0) vs one process {ref['ms']:.3f} ms/image")
    return {"train_spatial_validate": sum(x["launches"] for x in res),
            "serve_height_sharded": serve_launches}


# ---------------------------------------------------------------- phase 11

BENCH_K, BENCH_REPS = 10, 3  # the CLI's defaults
BENCH_THREADS, BENCH_DEPTH = 8, 8


def _bench_line(r: dict) -> str:
    return (f"{r['steady_state_ms_per_batch']:.3f} ms/batch steady state "
            f"({r['steady_state_img_per_s']:.1f} img/s{', clamped' if r['steady_state_clamped'] else ''}), "
            f"{r['k_wall_ms_per_batch']:.3f} ms/batch K-wall ({r['k_wall_img_per_s']:.1f} img/s)")


def _bench_e2e_check(arch: str) -> str:
    """The e2e iteration 0 against a ``Predictor`` built here from the same
    seed-0 draws on the same images: at the benchmark's conf 0.25 and, so
    that detections exist, with both at conf 1e-5 (9b's rules)."""
    loop = benchmark.make_loop(arch, BATCH, "e2e", IMG, NC, device="cuda")
    model = init_model(build_model(arch, num_classes=NC, device="cpu"),
                       torch.Generator().manual_seed(0))
    images = np.random.default_rng(0).integers(0, 256, (BATCH, IMG, IMG, 3), dtype=np.uint8)
    x = torch.from_numpy(images).cuda()
    said = []
    for conf in (0.25, 1e-5):
        predictor = Predictor(arch, model.state_dict(), NC, input_size=(IMG, IMG),
                              conf_thresh=conf, batch_size=BATCH, dtype=torch.bfloat16,
                              device="cuda")
        loop.predictor.serve.conf_thresh = conf
        got = {k: v.cpu().numpy() for k, v in loop.run(0).items()}
        want = {k: v.cpu().numpy() for k, v in predictor.infer(x).items()}
        box_err, score_err = _same_detections(got, want, f"11a {arch} conf {conf}")
        said.append(f"conf {conf}: {int(want['valid'].sum())} detections, box err "
                    f"{box_err:.1e} px, score rel err {score_err:.1e}")
    return "; ".join(said)


def phase_benchmark(runs: list, full: dict) -> dict:
    """11: the benchmark CLI's functions (``tools/benchmark.py``) at full size.

    a. ``run_benchmark(arch, 32, "e2e")`` at 640², nc 80, K=10, reps 3, for
       both serving models: ``select.launches`` (set to 0 just before) equals
       the iterations run, warm-up included; iteration 0 equals
       ``Predictor.infer`` on the same weights and images;
    b. ``forward`` of yolo-ms-xs;
    c. ``train`` of yolo-ms-xs, through ``make_loop`` + ``_loop_rates`` +
       ``benchmark_report`` (``run_benchmark``'s body) so that every
       iteration's loss is kept: every one finite, and the step counter equal
       to the iterations run;
    d. ``run_streaming`` of yolo-ms-xs over the default 2,048-image fixture,
       8 decode threads, depth 8: ``select.launches`` equals the calls made
       (the warm-up, the device leg's warm call and batches, the sustained
       batches; ``run_streaming`` raises unless the sustained leg served every
       batch).
    """
    iters = benchmark.iterations_run(BENCH_K, BENCH_REPS)
    by_arch = {r["arch"]: r for r in runs}
    e2e_launches = 0
    for arch in SERVE_ARCHS:
        checked = _bench_e2e_check(arch)
        zero_counts()
        nms_fixed.sweeps = 0
        t0 = time.perf_counter()
        with profiler.recording():  # nms_fixed.sweeps tallies
            r = benchmark.run_benchmark(arch, BATCH, "e2e", IMG, NC, BENCH_K, BENCH_REPS,
                                        device="cuda")
        seconds = time.perf_counter() - t0
        launches, sweeps = launched(f"11a {arch}"), int(nms_fixed.sweeps)
        if launches != iters:
            raise AssertionError(f"11a {arch}: select launched {launches} times in {iters} "
                                 f"e2e iterations")
        e2e_launches += launches
        if (r["entry_layouts"], r["memory_format"]) != ("auto", "channels_last"):
            raise AssertionError(f"11a {arch}: served {r['entry_layouts']} in {r['memory_format']}")
        print(f"phase 11a benchmark e2e {arch} bs={BATCH} {IMG}px bf16 K={BENCH_K} "
              f"reps={BENCH_REPS}: {_bench_line(r)}; phase 5 infer {by_arch[arch]['infer_ms']:.3f} "
              f"ms (CUDA events); select launches {launches} in {iters} iterations; NMS sweeps "
              f"{sweeps / iters:.2f} per iteration; iteration 0 == Predictor.infer ({checked}); "
              f"{seconds:.1f} s; {json.dumps(r)}")

    r = benchmark.run_benchmark("yolo-ms-xs", BATCH, "forward", IMG, NC, BENCH_K, BENCH_REPS,
                                device="cuda")
    print(f"phase 11b benchmark forward yolo-ms-xs bs={BATCH} {IMG}px bf16 (unfolded): "
          f"{_bench_line(r)}; phase 5 normalize+forward (folded) "
          f"{by_arch['yolo-ms-xs']['fwd_ms']:.3f} ms; {json.dumps(r)}")

    loop = benchmark.make_loop("yolo-ms-xs", BATCH, "train", IMG, NC, device="cuda")
    losses = []

    def kept(i):
        losses.append(loop(i))
        return losses[-1]

    t0 = time.perf_counter()
    r = benchmark.benchmark_report(loop, "yolo-ms-xs", BATCH, IMG,
                                   benchmark._loop_rates(kept, BENCH_K, BENCH_REPS, loop.device))
    seconds = time.perf_counter() - t0
    losses = torch.stack(losses)
    if not (len(losses) == iters and bool(torch.isfinite(losses).all())):
        raise AssertionError(f"11c: {len(losses)} losses, finite: {torch.isfinite(losses).all()}")
    if int(loop.state.step) != iters:
        raise AssertionError(f"11c: step counter {int(loop.state.step)} after {iters} iterations")
    print(f"phase 11c benchmark train yolo-ms-xs bs={BATCH} {IMG}px bf16 autocast, Adam: "
          f"{_bench_line(r)}; phase 6c step alone {full['alone']['event_ms']:.3f} ms (CUDA "
          f"events); {iters} losses finite ({float(losses[0]):.4f} -> {float(losses[-1]):.4f}), "
          f"step counter {int(loop.state.step)}; {seconds:.1f} s; {json.dumps(r)}")
    del loop, losses

    zero_counts()
    nms_fixed.sweeps = 0
    t0 = time.perf_counter()
    with profiler.recording():  # nms_fixed.sweeps tallies
        r = benchmark.run_streaming("yolo-ms-xs", BATCH, IMG, NC, threads=BENCH_THREADS,
                                    depth=BENCH_DEPTH, device="cuda")
    seconds = time.perf_counter() - t0
    n_batches = r["n_images"] // BATCH
    calls = 2 + 2 * n_batches
    if (r["entry_layouts"], r["memory_format"]) != ("auto", "channels_last"):
        raise AssertionError(f"11d: served {r['entry_layouts']} in {r['memory_format']}")
    if launched("11d") != calls:
        raise AssertionError(f"11d: select launched {select.launches} times in {calls} calls")
    print(f"phase 11d benchmark streaming yolo-ms-xs bs={BATCH} {IMG}px bf16, {r['n_images']} "
          f"JPEGs, {BENCH_THREADS} threads, depth {BENCH_DEPTH}: sustained "
          f"{r['sustained_img_per_s']} img/s; legs: host decode {r['host_decode_img_per_s']} "
          f"img/s ({r['host_decode_cpu_s_per_img']} CPU-s/img, native_loader "
          f"{r['native_loader']}), H2D {r['h2d_img_per_s']} img/s ({r['h2d_mb_per_s']} MB/s), "
          f"device {r['device_only_img_per_s']} img/s; bound {r['bound']}; "
          f"cores_per_chip_derived {r['cores_per_chip_derived']}; select launches "
          f"{select.launches} in {calls} calls ({n_batches} batches served, sustained leg "
          f"complete); NMS sweeps {int(nms_fixed.sweeps) / calls:.2f} per call; {seconds:.1f} s; "
          f"{json.dumps(r)}")
    return {"benchmark_e2e": e2e_launches, "benchmark_streaming": calls}


# 11e: the probe for what native/build.sh needs, and where it builds
NATIVE_PROBE = "#include <cstdio>\n#include <jpeglib.h>\n#include <png.h>\nint main() { return 0; }\n"
NATIVE_BUILD = select_mod.BUILD_DIR


def _native_toolchain() -> str | None:
    """None where g++ compiles a file that includes jpeglib.h and png.h;
    else what is missing."""
    gxx = shutil.which("g++")
    if gxx is None:
        return "no g++ on the PATH"
    proc = subprocess.run([gxx, "-fsyntax-only", "-x", "c++", "-"], input=NATIVE_PROBE,
                          capture_output=True, text=True, timeout=120)
    if proc.returncode != 0:
        return f"g++ cannot compile jpeglib.h and png.h: {proc.stderr.strip()[-300:]}"
    return None


@contextlib.contextmanager
def _decoder(native: bool):
    """The native loader on (its library found again, after a build) or
    off (cv2), as ``native_loader.available()`` answers every caller."""
    saved = native_loader._LIB, native_loader._TRIED
    native_loader._LIB, native_loader._TRIED = None, not native
    try:
        if native_loader.available() != native:
            raise AssertionError(f"11e: the native loader is {'not ' * native}available")
        yield
    finally:
        native_loader._LIB, native_loader._TRIED = saved


def _detections(out: dict, i: int, size: tuple | None = None) -> list:
    """Image ``i``'s valid detections of a ``predict_batch`` output; with
    ``size`` (its original height and width) the boxes are scaled from the
    goldens' 160² input to it and clipped, as the golden files hold them."""
    v = out["valid"][i]
    dets = []
    for c, s, box in zip(out["classes"][i][v], out["scores"][i][v], out["boxes"][i][v]):
        box = [float(b) for b in box]
        if size is not None:
            oh, ow = size
            box = [min(max(b * lim / 160, 0.0), lim) for b, lim in zip(box, (ow, oh, ow, oh))]
        dets.append({"class_id": int(c), "score": float(s), "box_xyxy": box})
    return dets


def phase_native_streaming() -> dict:
    """11e: the ``native/`` loader and ``tools/benchmark.py --mode streaming
    --images DIR`` over 11d's 2,048-JPEG fixture. Probes for g++ with the
    libjpeg and libpng headers; where they are present, builds
    ``native/loader.cpp`` with ``native/build.sh`` into the port's ignored
    ``build/`` directory (a failed build fails the run) and runs the CLI
    with the native loader and then with cv2, else (printed on a line of
    its own; nothing is fetched) with cv2 alone: each run serves every
    batch (one ``select`` launch per call) and reports the decoder it used.
    With both: the first batch decoded by each, served as the streaming run
    serves it (seed-0 weights, conf 0.25), and both trained goldens'
    fixtures decoded and resized by each (160², f32, TF32 off, conf 0.25)
    must give the same detections by phase 4's rule (same count and class,
    IoU > 0.9, score within 0.02), the goldens also their checked-in
    ones."""
    missing = _native_toolchain()
    if missing is None:
        os.makedirs(NATIVE_BUILD, exist_ok=True)
        t0 = time.perf_counter()
        proc = subprocess.run(["sh", os.path.join(ROOT, "native", "build.sh"), NATIVE_BUILD],
                              capture_output=True, text=True, timeout=300)
        build_s = time.perf_counter() - t0
        if proc.returncode != 0:
            raise AssertionError(f"11e: native/build.sh failed ({proc.returncode}):\n"
                                 f"{proc.stderr}")
        with _decoder(True):
            lib = native_loader._LIB._name
    else:
        print(f"phase 11e native loader: not built on this machine, {missing}; nothing "
              f"fetched, the streaming run decodes with cv2")
    images = os.path.join(tempfile.gettempdir(), "yolo_ms_stream_fixture")
    argv = ["--arch", "yolo-ms-xs", "--batch", str(BATCH), "--img_size", str(IMG),
            "--mode", "streaming", "--images", images, "--threads", str(BENCH_THREADS),
            "--device", "cuda"]
    reports, launches = {}, 0
    for native in (True, False) if missing is None else (False,):
        with _decoder(native):
            zero_counts()
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                benchmark.main(argv)
            r = json.loads(buf.getvalue().strip().splitlines()[-1])
        calls = 2 + 2 * (r["n_images"] // BATCH)
        if r["native_loader"] != native or launched(f"11e native={native}") != calls:
            raise AssertionError(f"11e native={native}: native_loader {r['native_loader']}, "
                                 f"select launched {select.launches} times in {calls} calls")
        reports["native" if native else "cv2"] = r
        launches += calls

    def legs(r):
        return (f"decode {r['host_decode_img_per_s']} img/s at "
                f"{r['host_decode_cpu_s_per_img']} CPU-s/img, sustained "
                f"{r['sustained_img_per_s']} img/s, device {r['device_only_img_per_s']} img/s, "
                f"bound {r['bound']}, cores_per_chip_derived {r['cores_per_chip_derived']}")

    ran = (f"tools/benchmark.py --mode streaming --images {images} "
           f"({reports['cv2']['n_images']} JPEGs, bs={BATCH} {IMG}px bf16, {BENCH_THREADS} "
           f"threads)")
    if missing is not None:
        print(f"phase 11e {ran} with cv2: {legs(reports['cv2'])}; select launches {launches} "
              f"in {launches} calls, every batch served; {json.dumps(reports)}")
        return {"streaming_images": launches}

    # the same detections from either decoder
    exts = (".jpg", ".jpeg", ".png", ".bmp")
    first = sorted(os.path.join(images, f) for f in os.listdir(images)
                   if f.lower().endswith(exts))[:BATCH]
    decoded = {}
    for native in (True, False):
        with _decoder(native):
            decoded[native] = {
                "first": np.stack([decode_and_resize(p, IMG, IMG) for p in first]),
                **{arch: decode_and_resize(os.path.join(gdir, "fixture_000.png"), 160, 160)
                   for arch, gdir in GOLDENS}}
    diff = np.abs(decoded[True]["first"].astype(np.int16) - decoded[False]["first"])
    stream = benchmark._predictor(benchmark._seed_model("yolo-ms-xs", NC), "yolo-ms-xs", BATCH,
                                  IMG, NC, torch.device("cuda"), "auto")
    outs = {native: stream.predict_batch(decoded[native]["first"]) for native in (True, False)}
    n_first = 0
    for i in range(BATCH):
        got = _detections(outs[True], i)
        match_golden(got, _detections(outs[False], i))
        n_first += len(got)
    golden_parts = []
    for arch, gdir in GOLDENS:
        with open(os.path.join(gdir, "fixture_000_detections.json")) as f:
            golden = json.load(f)
        size = decode_image(os.path.join(gdir, "fixture_000.png")).shape[:2]
        predictor = Predictor(arch, load_npz(os.path.join(gdir, "weights.npz")), num_classes=3,
                              input_size=(160, 160), conf_thresh=0.25, iou_thresh=0.45,
                              dtype=torch.float32, device="cuda")
        dets = {native: _detections(predictor.predict_batch(decoded[native][arch][None]), 0,
                                    size) for native in (True, False)}
        match_golden(dets[True], dets[False])
        match_golden(dets[True], golden)
        match_golden(dets[False], golden)
        golden_parts.append(f"{arch} {len(dets[True])} (scores native "
                            f"{[round(d['score'], 4) for d in dets[True]]}, cv2 "
                            f"{[round(d['score'], 4) for d in dets[False]]})")
    print(f"phase 11e native loader built by native/build.sh in {build_s:.2f} s ({lib}); "
          f"{ran}, in turns: native: "
          f"{legs(reports['native'])}; cv2: {legs(reports['cv2'])}; select launches {launches} "
          f"in {launches} calls, every batch served; first batch native vs cv2 pixels max diff "
          f"{int(diff.max())}, {float((diff > 0).mean()) * 100:.2f} % differ, served at conf "
          f"0.25: {n_first} detections each, the same; goldens decoded and resized by each, "
          f"detections the same and the checked-in ones: {'; '.join(golden_parts)}; "
          f"{json.dumps(reports)}")
    return {"streaming_images": launches}


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--parent", help="another checkout whose select kernel to time against")
    parser.add_argument("--variants", action="store_true",
                        help="time the edited copies of select.cu and nms.cu in "
                             "SELECT_VARIANTS and NMS_VARIANTS")
    parser.add_argument("--preempt-child", nargs="+", help=argparse.SUPPRESS)
    parser.add_argument("--dp-child", nargs="+", help=argparse.SUPPRESS)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    watch_deploy_convs()
    if args.preempt_child:
        return preempt_child(*args.preempt_child)
    if args.dp_child:
        return dp_child(*args.dp_child)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    name = torch.cuda.get_device_name(0)
    print(f"phase 1 device: {name} ({smi}); torch {torch.__version__}, CUDA {torch.version.cuda}")

    # both kernels' nvcc at once
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        builds = [pool.submit(select_mod.build), pool.submit(nms_mod.build)]
        info, nms_info = (b.result() for b in builds)
    regs = [ln.strip() for ln in info["log"].splitlines() if "registers" in ln]
    plans = "; ".join(
        "{} nc={}: {route}, {tile} anchors per tile, {stages} stages, {smem_bytes} B shared per "
        "CTA, {ctas_per_sm} CTAs per SM on {sms} SMs, {lanes} lanes a class row".format(
            str(dt)[6:], nc, **select_mod.plan(dt, nc))
        for dt in (torch.bfloat16, torch.float32) for nc in PHASE3_NC
    )
    print(f"phase 2 build select.cu: {info['seconds']:.2f} s; {'; '.join(regs)}; plan: {plans}")
    nms_regs = [ln.strip() for ln in nms_info["log"].splitlines() if "registers" in ln]
    nms_plans = "; ".join("K={} {route}, {smem_bytes} B shared of {smem_limit}, {threads} "
                          "threads per CTA".format(k, **nms_mod.plan(k)) for k in NMS_PLAN_K)
    print(f"phase 2 build nms.cu (beside select.cu): {nms_info['seconds']:.2f} s; "
          f"{'; '.join(nms_regs)}; plan: {nms_plans}")

    flush = torch.empty(256 * 1024 * 1024, dtype=torch.uint8, device="cuda")
    if args.parent or args.variants:
        if args.parent:
            phase_parent_ab(args.parent, flush, name)
        if args.variants:
            phase_select_variants(flush, name)
            phase_nms_variants(name)
        print(smi)
        return 0

    worst = phase_kernel_vs_plain(flush, name)
    phase_nms_vs_plain(name)
    epi = phase_epilogue_vs_plain(flush, name)
    phase_cuda_tests()
    phase_goldens()

    runs = [serve_model(arch, flush) for arch in SERVE_ARCHS]
    for r in runs:
        print_serving(r)
    wide = serve_classes("yolo-ms-xs", WIDE_NC, "5b", flush, name)
    finetune = serve_classes(FINETUNE_ARCH, FINETUNE_NC, "5c", flush, name)

    with tempfile.TemporaryDirectory(prefix="chip_smoke_train_") as work:
        phase_step_parity()
        phase_learning(work)
        full = phase_full_width(work)
        tools = {"tools_test": phase_tools_test(work)}
        export_val = phase_export_val(work, full)
        tools["tools_val"] = export_val["launches"]
        tools["video"] = phase_video(work, full, export_val["bf16"])
        tools["serve_unfolded"] = phase_unfolded(full)
        phase_preempt(work)
        phase_analyze(work)
        phase_dp_equality(work)
        dp = phase_dp_full(work, full)
        tools["train_dp_validate"] = dp["launches"]
        phase_dp_preempt(work)
        phase_nccl(work)
        tools.update(phase_program(work, runs[0], full))
        tools.update(phase_spatial(work, full, dp))
    tools.update(phase_benchmark(runs, full))
    tools.update(phase_native_streaming())

    # one batch of the flagship, one launch of each kernel
    sel, nms_t = runs[0]["select"], runs[0]["nms"]
    bound_ms, bound_by = bound_of(sel["bytes_ms"], sel["ops_ms"])
    nms_bound_ms, nms_bound_by = bound_of(nms_t["bytes_ms"], nms_t["ops_ms"])
    worst = max([worst, wide["err"], finetune["err"]] + [r["select"]["err"] for r in runs])
    serve_launches = sum(r["launches"] for r in runs)
    tools["serve_wide"] = wide["launches"]
    tools["serve_finetune"] = finetune["launches"]
    # every path's count was checked equal for both kernels (``launched``)
    by_path = {"serve": serve_launches, "train_validate": full["launches"], **tools}
    kernels = [{
        "name": "select",
        "route": "cuda",
        "source": "yolo_ms_tpu_torch/csrc/select.cu",
        "replaces": "yolo_ms_tpu/ops/pallas/select.py:56",
        "launches": sum(by_path.values()),
        "launches_by_path": by_path,
        "max_abs_err": worst,
        "ms": sel["ms"],
        "plain_ms": sel["plain_ms"],
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,
    }, {
        "name": "nms",
        "route": "cuda",
        "source": "yolo_ms_tpu_torch/csrc/nms.cu",
        "replaces": "yolo_ms_tpu/ops/nms.py:75",
        "launches": sum(by_path.values()),
        "launches_by_path": by_path,
        "max_abs_err": NMS_CHECKS["err"],
        "ms": nms_t["ms"],
        "plain_ms": nms_t["plain_ms"],
        "bound_ms": nms_bound_ms,
        "bound_by": nms_bound_by,
        "library_ms": None,
    }, {
        "name": "conv_epilogue",
        "route": "cuda",
        "source": "yolo_ms_tpu_torch/csrc/epilogue.cu",
        "replaces": None,  # XLA fuses the deploy conv's bias and SiLU into the conv
        "launches": EPILOGUE["before"] + conv_epilogue.launches,
        "launches_by_path": EPILOGUE_BY_PATH,
        "replayed_per_call": {r["arch"]: r["replayed_epilogues"] for r in runs},
        "max_abs_err": epi["abs_err"],
        "max_rel_err": epi["err"],
        "ms": epi["ms"],
        "plain_ms": epi["plain_ms"],
        "bound_ms": epi["bound_ms"],
        "bound_by": "bytes",
        "library_ms": epi["library_ms"],
    }]
    print(f"nms kernel: {NMS_CHECKS['launches']} launches held against the plain version, "
          f"worst error {NMS_CHECKS['err']}")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
