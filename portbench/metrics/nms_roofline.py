"""Serving: the NMS kernel's share of its roofline (%)."""

from portbench.readers import nms_roofline


def read(trace):
    return nms_roofline(trace)
