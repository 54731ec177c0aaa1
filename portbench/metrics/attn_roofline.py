"""Serving: the area attention's share of its roofline (%)."""

from portbench.attention import attn_roofline


def read(trace):
    return attn_roofline(trace)
