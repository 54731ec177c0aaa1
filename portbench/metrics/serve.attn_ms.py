"""Serving: device ms of the area attention's kernels per call."""

from portbench.attention import attn_ms


def read(trace):
    return attn_ms(trace)
