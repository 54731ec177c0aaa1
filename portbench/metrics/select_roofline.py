"""Serving: the select kernel's share of its roofline (%)."""

from portbench.readers import select_roofline


def read(trace):
    return select_roofline(trace)
