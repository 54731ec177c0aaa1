"""Training: share of the stretch with the device idle (%)."""

from portbench.readers import device_idle_pct


def read(trace):
    return device_idle_pct(trace)
