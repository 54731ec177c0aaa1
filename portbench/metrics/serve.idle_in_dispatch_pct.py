"""Serving: share of the stretch with the device idle while the program dispatches (%)."""

from portbench.spans import idle_in_dispatch_pct


def read(trace):
    return idle_in_dispatch_pct(trace)
