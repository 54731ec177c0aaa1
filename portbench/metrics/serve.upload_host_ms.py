"""Serving: host ms per call in the program's span serve/upload."""

from portbench.spans import host_ms


def read(trace):
    return host_ms(trace, "serve/upload")
