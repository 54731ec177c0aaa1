"""The traced stretch: ``torch.profiler`` over a few calls, reduced to what
the per-layer readers take.

``capture(run, calls, images)`` runs ``run()`` (which makes ``calls`` calls
and waits for the card) inside the range ``portbench/stretch`` under the
profiler, with CPU and CUDA activities, and returns a ``Trace``:

- ``ops``: every device operation that starts inside the stretch, as
  ``Op(name, kind, start_ns, dur_ns, launch_ns)``: ``kind`` is ``kernel``,
  ``memcpy`` or ``memset``, ``launch_ns`` the host time of the call that
  enqueued it (the operator it is linked to, else its runtime call);
- ``ranges``: name -> [(start_ns, end_ns)] of every ``record_function``
  range (the program's ``train_step/*`` and the harness's ``portbench/*``);
- ``window_ns`` and ``busy_ns``: the stretch's length and the union of its
  device operations' intervals;
- ``calls``, ``images`` and ``extra`` (counters and bounds the driver adds).

Only these reductions are kept; no trace file is written.
"""

from __future__ import annotations

import bisect
import dataclasses
from collections import defaultdict

import torch

STRETCH = "portbench/stretch"
RANGES = ("portbench/", "train_step/")  # the harness's and the program's ranges


@dataclasses.dataclass
class Op:
    name: str
    kind: str
    start_ns: int
    dur_ns: int
    launch_ns: int


@dataclasses.dataclass
class Trace:
    ops: list
    ranges: dict
    host: list  # (start_ns, end_ns, name) of the main thread's operators
    window_ns: int
    busy_ns: int
    calls: int
    images: int
    extra: dict = dataclasses.field(default_factory=dict)

    def within(self, op: Op, name: str) -> bool:
        """Whether ``op`` was enqueued inside a range called ``name``."""
        return any(s <= op.launch_ns <= e for s, e in self.ranges.get(name, ()))

    def per_call_ms(self, ops) -> float:
        return sum(o.dur_ns for o in ops) / 1e6 / self.calls

    @property
    def window_s(self) -> float:
        return self.window_ns / 1e9

    def breakdown(self, top: int = 10) -> dict:
        """The device operations that took most time, and the longest idle
        gaps by what the host was doing: the innermost range open at the
        gap's start and the operator that enqueued the op that ended it."""
        by_name = defaultdict(int)
        for o in self.ops:
            by_name[o.name] += o.dur_ns
        device_ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        gaps = defaultdict(int)
        ops = sorted(self.ops, key=lambda o: o.start_ns)
        starts = [h[0] for h in self.host]
        s0, e0 = self.ranges[STRETCH][0]
        edge = s0
        for o in ops:
            if o.start_ns > edge:
                gaps[f"{self._open_range(edge)} -> {self._launcher(o, starts)}"] += o.start_ns - edge
            edge = max(edge, o.start_ns + o.dur_ns)
        if e0 > edge:
            gaps[f"{self._open_range(edge)} -> end"] += e0 - edge
        idle = sorted(gaps.items(), key=lambda kv: -kv[1])[:top]
        return {"device_ops": [[n[:120], v / 1e9] for n, v in device_ops],
                "idle_gaps": [[n[:120], v / 1e9] for n, v in idle]}

    def _open_range(self, t: int) -> str:
        best, width = STRETCH, None
        for name, spans in self.ranges.items():
            for s, e in spans:
                if s <= t <= e and (width is None or e - s < width):
                    best, width = name, e - s
        return best

    def _launcher(self, op: Op, starts: list) -> str:
        i = bisect.bisect_right(starts, op.launch_ns) - 1
        for j in range(i, max(-1, i - 256), -1):
            s, e, name = self.host[j]
            if s <= op.launch_ns <= e:
                return name
        return op.name


def _kind(name: str) -> str:
    if name.startswith("Memcpy"):
        return "memcpy"
    if name.startswith("Memset"):
        return "memset"
    return "kernel"


def _union_ns(intervals) -> int:
    total, edge = 0, None
    for s, e in sorted(intervals):
        if edge is None or s > edge:
            total += e - s
            edge = e
        elif e > edge:
            total += e - edge
            edge = e
    return total


def capture(run, calls: int, images: int) -> Trace:
    """``run()`` under the profiler inside ``portbench/stretch``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    # a build without CUDA traces the CPU alone (the rehearsal in tests/)
    activities = [a for a in (ProfilerActivity.CPU, ProfilerActivity.CUDA)
                  if a in torch.profiler.supported_activities()]
    with profile(activities=activities) as prof:
        with record_function(STRETCH):
            run()
            torch.cuda.synchronize()
    events = prof.profiler.kineto_results.events()
    # operators and CUDA runtime calls number their correlations apart
    op_at, runtime_at, ranges, host, device = {}, {}, defaultdict(list), [], []
    main = None
    for e in events:
        name, span = e.name(), (e.start_ns(), e.start_ns() + e.duration_ns())
        if e.device_type() != DeviceType.CPU:
            # the ranges' own spans on the device's timeline are no operations
            if not name.startswith(RANGES):
                device.append(e)
            continue
        if name.startswith("cu"):
            runtime_at.setdefault(e.correlation_id(), span[0])
            continue
        op_at.setdefault(e.correlation_id(), span[0])
        if name == STRETCH:
            main = e.start_thread_id()
        if name.startswith(RANGES):
            ranges[name].append(span)
        else:
            host.append((span[0], span[1], name, e.start_thread_id()))
    if STRETCH not in ranges:
        raise RuntimeError("the profiler recorded no stretch range")
    s0, e0 = ranges[STRETCH][0]
    ops = []
    for e in device:
        start = e.start_ns()
        if not s0 <= start <= e0:
            continue
        launch = op_at.get(e.linked_correlation_id(), runtime_at.get(e.correlation_id(), start))
        ops.append(Op(e.name(), _kind(e.name()), start, e.duration_ns(), launch))
    host = sorted((s, e, n) for s, e, n, tid in host if tid == main)
    busy = _union_ns((o.start_ns, min(o.start_ns + o.dur_ns, e0)) for o in ops)
    return Trace(ops=ops, ranges=dict(ranges), host=host, window_ns=e0 - s0, busy_ns=busy,
                 calls=calls, images=images)


class GcWatch:
    """Collections of Python's cyclic garbage collector while it is open:
    ``with GcWatch() as gc_watch: ...`` then ``gc_watch.summary()``."""

    def __init__(self):
        self.spans = []
        self._start = None

    def _callback(self, phase, info):
        import time

        if phase == "start":
            self._start = time.perf_counter()
        elif self._start is not None:
            self.spans.append((info["generation"], time.perf_counter() - self._start))
            self._start = None

    def __enter__(self):
        import gc

        gc.callbacks.append(self._callback)
        return self

    def __exit__(self, *exc):
        import gc

        gc.callbacks.remove(self._callback)

    def summary(self) -> str:
        by_gen = {}
        for gen, seconds in self.spans:
            n, total, worst = by_gen.get(gen, (0, 0.0, 0.0))
            by_gen[gen] = (n + 1, total + seconds, max(worst, seconds))
        return ", ".join(f"gen{g}: {n} collections, {t * 1e3:.3f} ms, longest {w * 1e3:.3f} ms"
                         for g, (n, t, w) in sorted(by_gen.items())) or "none"
