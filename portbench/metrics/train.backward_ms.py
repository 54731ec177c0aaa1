"""Training: device ms per step enqueued in train_step/backward."""

from portbench.readers import range_ms


def read(trace):
    return range_ms(trace, "train_step/backward")
