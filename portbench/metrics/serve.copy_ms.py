"""Serving: device ms of predict_batch's copies per call."""

from portbench.readers import copy_ms


def read(trace):
    return copy_ms(trace)
