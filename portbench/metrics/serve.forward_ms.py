"""Serving: device ms of the model's kernels per call."""

from portbench.readers import forward_ms


def read(trace):
    return forward_ms(trace)
