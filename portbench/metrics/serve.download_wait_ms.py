"""Serving: host ms per call in the program's span serve/download: the
queue's drain and the copy back."""

from portbench.spans import host_ms


def read(trace):
    return host_ms(trace, "serve/download")
