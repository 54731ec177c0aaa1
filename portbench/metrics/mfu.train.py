"""Training: 3 x forward FLOPs x img/s of the stretch over the bf16 peak (%)."""

from portbench.readers import mfu


def read(trace):
    return mfu(trace, 3)
