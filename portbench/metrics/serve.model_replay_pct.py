"""Serving: share of the program's serve/model spans that replayed a CUDA graph (%)."""

from portbench.spans import stretch_spans


def read(trace):
    counted = [s.counts["replayed"] for s in stretch_spans(trace)
               if s.name == "serve/model" and "replayed" in s.counts]
    return sum(counted) / len(counted) * 100.0 if counted else None
