"""Tracing utilities, the port of ``yolo_ms_tpu/utils/profiler.py``.

- ``span(name, **counts)``: a span of the program's own host time, kept in
  memory. The serving path opens ``serve/predict_batch`` (``images``) ->
  ``serve/upload`` (``bytes``), ``serve/infer`` -> ``serve/normalize``,
  ``serve/model`` (``replayed``: 1 where ``infer/graphs.py`` replayed
  the forward from a CUDA graph, else 0; and what the forward's modules
  count, ``counted()`` below), ``serve/postprocess``, then
  ``serve/download`` (``bytes``); ``Trainer.fit`` opens
  ``fit/wait_batch`` and ``fit/step`` once per step. Spans are on inside
  ``recording()`` and while a ``torch.profiler`` runs; off, ``span``
  reads those two flags and returns one shared no-op object (no clock
  read, no allocation of a span). On,
  each span stores its name, start and end on ``time.time_ns()`` (the
  clock on which the profiler stamps its events), its parent, its call id
  (the id of the outermost span open on its thread, shared by every span of
  one call), its thread and its counts, in a buffer of the last
  ``MAX_SPANS`` spans. ``annotate(name, **counts)`` sets counts on the
  innermost open span from inside its block. ``spans()`` reads the buffer,
  ``clear()`` empties it.
  The recorder calls no profiler API, so no span reaches the profiler's
  events, the device's timeline included.
- ``counted()``: a block that yields a dict of what the modules of a
  forward count inside it on this thread (``add_counts``), whether spans
  are on or not; ``infer/graphs.py`` sets them on ``serve/model``. A
  forward of deploy structure counts ``conv_biased``, its BN-folded convs
  (``nn/blocks.py:ConvBnSiLU``), and ``conv_epilogues``, those whose bias
  and activation ran in the kernel of ``ops/kernels/epilogue.py``; one with
  attention (YOLOv12) ``attn_calls``, ``attn_rows``, ``attn_scores`` and
  ``attn_head_dim``, the shapes of its attention calls
  (``ops/attention.py``), not FLOPs. A block inside another counts for
  itself alone.
- ``trace(log_dir)``: a context manager around ``torch.profiler`` with the
  CPU activity, and the CUDA one where a card is present; on exit it writes
  a Chrome trace (``trace.json``, viewable in Perfetto or
  ``chrome://tracing``) into ``log_dir``, with the spans recorded in the
  block on a track of their own, on the profiler's time base. It yields the
  profiler, whose ``key_averages()`` can be read after the block.

The JAX package's ``enable_compilation_cache`` (a persistent XLA cache) has
no counterpart here: nothing compiled per shape outlives the process (the
serving forward's CUDA graphs, ``infer/graphs.py``, are captured in it). Its
named substitute is the nvcc build directory ``yolo_ms_tpu_torch/build/``,
which keeps the ``select`` kernel built from one run to the next.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import json
import os
import threading
import time

import torch
from torch.autograd import profiler as _autograd_profiler

MAX_SPANS = 1 << 16

_recording = False
_done: collections.deque = collections.deque(maxlen=MAX_SPANS)
_open = threading.local()  # .stack: the spans open on this thread, innermost last
_ids = itertools.count(1)


class Span:
    """One span: its name and counts, its id, the id of the span open around
    it on its thread (``parent``, None for none), the id of the outermost one
    (``call``, its own for none), its thread, and its start and end in ns on
    ``time.time_ns()``. Recorded when its block ends."""

    __slots__ = ("name", "counts", "id", "parent", "call", "thread", "start_ns", "end_ns")

    def __init__(self, name: str, counts: dict):
        self.name, self.counts = name, counts

    def __enter__(self):
        stack = getattr(_open, "stack", None)
        if stack is None:
            stack = _open.stack = []
        outer = stack[-1] if stack else None
        self.id = next(_ids)
        self.parent = outer.id if outer else None
        self.call = outer.call if outer else self.id
        self.thread = threading.get_ident()
        stack.append(self)
        self.start_ns = time.time_ns()
        return self

    def __exit__(self, *exc):
        self.end_ns = time.time_ns()
        _open.stack.pop()
        _done.append(self)
        return False


_NO_SPAN = contextlib.nullcontext()  # reusable: one shared object
_counting = threading.local()  # .counts: the dict of the innermost open counted() block


def spans_on() -> bool:
    """Whether spans are recorded now: inside ``recording()``, or while a
    ``torch.profiler`` runs."""
    return _recording or _autograd_profiler._is_profiler_enabled


def span(name: str, **counts):
    """A context manager: the span ``name`` with ``counts`` (e.g.
    ``bytes``) around the block, where spans are on; else the shared no-op."""
    if not spans_on():
        return _NO_SPAN
    return Span(name, counts)


def annotate(name: str, **counts) -> None:
    """Set ``counts`` on the innermost span open on this thread if it is
    called ``name``; nothing where spans are off, or another span is
    innermost."""
    stack = getattr(_open, "stack", None)
    if stack and stack[-1].name == name:
        stack[-1].counts.update(counts)


@contextlib.contextmanager
def counted():
    """Yields a dict that holds the counts made in the block on this thread
    (empty where none was made)."""
    outer = getattr(_counting, "counts", None)
    _counting.counts = counts = {}
    try:
        yield counts
    finally:
        _counting.counts = outer


def open_counts() -> dict | None:
    """The dict of the innermost ``counted()`` block open on this thread,
    or None."""
    return getattr(_counting, "counts", None)


def add_counts(**increments: int) -> None:
    """Add ``increments`` to the innermost open ``counted()`` block's
    counts; nothing outside one."""
    counts = getattr(_counting, "counts", None)
    if counts is None:
        return
    for key, n in increments.items():
        counts[key] = counts.get(key, 0) + n


@contextlib.contextmanager
def recording():
    """Spans on inside the block, with no profiler."""
    global _recording
    before, _recording = _recording, True
    try:
        yield
    finally:
        _recording = before


def spans() -> list[Span]:
    """The recorded spans still in the buffer, by start."""
    return sorted(_done, key=lambda s: (s.start_ns, s.id))


def clear() -> None:
    _done.clear()


_SPAN_PID = 1 << 22  # above Linux's largest pid: a process track of its own


def _chrome_events(recorded: list[Span], base_ns: int) -> list[dict]:
    """``recorded`` as Chrome trace events, in µs after ``base_ns``: a
    process ``program spans`` with a track per thread."""
    events = [{"ph": "M", "name": "process_name", "pid": _SPAN_PID,
               "args": {"name": "program spans"}}]
    tids = {}
    for s in recorded:
        if s.thread not in tids:
            tids[s.thread] = len(tids)
            events.append({"ph": "M", "name": "thread_name", "pid": _SPAN_PID,
                           "tid": tids[s.thread], "args": {"name": f"thread {s.thread}"}})
        events.append({"ph": "X", "cat": "program_span", "name": s.name, "pid": _SPAN_PID,
                       "tid": tids[s.thread], "ts": (s.start_ns - base_ns) / 1e3,
                       "dur": (s.end_ns - s.start_ns) / 1e3,
                       "args": {"id": s.id, "parent": s.parent, "call": s.call, **s.counts}})
    return events


@contextlib.contextmanager
def trace(log_dir: str):
    """``torch.profiler`` over the block; writes ``log_dir/trace.json`` with
    the block's spans beside the profiler's events."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir, "trace.json")
    start = time.time_ns()
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(path)
    with open(path) as f:
        chrome = json.load(f)
    recorded = [s for s in spans() if s.start_ns >= start]
    chrome["traceEvents"] += _chrome_events(recorded, chrome.get("baseTimeNanoseconds", 0))
    with open(path, "w") as f:
        json.dump(chrome, f)
