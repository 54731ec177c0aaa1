"""What the per-layer metrics read from the program's own spans.

The program records spans (``yolo_ms_tpu_torch/utils/profiler.py``) while a
``torch.profiler`` runs, so the traced stretch of ``trace.capture`` holds
the serving path's spans without a change to the harness: ``serve/upload``,
``serve/infer`` (``serve/normalize``, ``serve/model``,
``serve/postprocess``) and ``serve/download`` inside each
``serve/predict_batch``. They are stamped on ``time.time_ns()``, the clock
of the profiler's events, so they compare with ``Trace.ops`` as they are.
The readers take the spans of the main thread that lie inside the stretch.
A program without the recorder gives no spans, and every reader returns
None.
"""

from __future__ import annotations

import bisect
import threading
from collections import defaultdict

from portbench.trace import STRETCH

# the spans in which the host enqueues the serving function's device work
DISPATCH = ("serve/normalize", "serve/model", "serve/postprocess")


def stretch_spans(trace) -> list:
    """The program's spans on the main thread inside the stretch."""
    from yolo_ms_tpu_torch.utils import profiler

    recorded = getattr(profiler, "spans", None)
    if recorded is None or STRETCH not in trace.ranges:
        return []
    s0, e0 = trace.ranges[STRETCH][0]
    main = threading.main_thread().ident
    return [s for s in recorded() if s.thread == main and s0 <= s.start_ns and s.end_ns <= e0]


def host_ms(trace, name: str):
    """Host time inside the spans called ``name``, per call (ms)."""
    found = [s for s in stretch_spans(trace) if s.name == name]
    return sum(s.end_ns - s.start_ns for s in found) / 1e6 / trace.calls if found else None


def _merged(intervals) -> list:
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _outside(intervals, cut: list) -> list:
    """The parts of ``intervals`` outside every interval of ``cut`` (merged,
    sorted)."""
    ends = [e for _, e in cut]
    out = []
    for s, e in intervals:
        for cs, ce in cut[bisect.bisect_right(ends, s):]:
            if cs >= e:
                break
            if cs > s:
                out.append((s, cs))
            s = max(s, ce)
            if s >= e:
                break
        if s < e:
            out.append((s, e))
    return out


def idle_in_dispatch_pct(trace):
    """Share of the stretch in which no device operation runs while the
    innermost open program span is one of ``DISPATCH`` (%)."""
    found = stretch_spans(trace)
    if not any(s.name in DISPATCH for s in found):
        return None
    children = defaultdict(list)
    for s in found:
        if s.parent is not None:
            children[s.parent].append((s.start_ns, s.end_ns))
    innermost = []
    for s in found:
        if s.name in DISPATCH:
            innermost += _outside([(s.start_ns, s.end_ns)], _merged(children[s.id]))
    e0 = trace.ranges[STRETCH][0][1]
    busy = _merged((o.start_ns, min(o.start_ns + o.dur_ns, e0)) for o in trace.ops)
    idle = sum(e - s for s, e in _outside(innermost, busy))
    return idle / trace.window_ns * 100.0 if trace.window_ns else None
