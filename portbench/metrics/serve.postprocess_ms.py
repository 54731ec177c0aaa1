"""Serving: device ms of the serving tail's kernels per call."""

from portbench.readers import postprocess_ms


def read(trace):
    return postprocess_ms(trace)
