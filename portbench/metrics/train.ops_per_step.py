"""Training: device operations per step."""

from portbench.readers import ops_per_call


def read(trace):
    return ops_per_call(trace)
