"""What the port's tests run under, defined once: the thread policy, and
no TensorFlow behind the trainers' TensorBoard writers.

A test worker runs torch beside the JAX runtime's own thread pool, the other
workers of a parallel run and the rank processes they start. torch's default
of one intra-op thread per core then oversubscribes the host, and the port's
files run several times slower. So every port test file imports this module:
the first import, at collection, pins the worker to ``THREADS`` intra-op
threads for the whole run, whatever the order of the files.

Each process a port test starts takes ``child_env()``, which gives it the
same count through ``OMP_NUM_THREADS``. The worker's own ``os.environ`` is
left as it is, so the JAX package's subprocess tests run as before.

``NullLogger`` stands in for a trainer's ``MetricLogger``, whose TensorBoard
writer imports TensorFlow where it is installed (~13 s a process); no port
test reads the scalars. The rank processes leave TensorFlow out themselves
(``sys.modules["tensorflow"] = None``).
"""

import os

import torch

# one thread beat two under the tier-1 command (ROADMAP.md, "Keep the runtime budget")
THREADS = 1

torch.set_num_threads(THREADS)


def child_env() -> dict:
    """A copy of ``os.environ`` with the policy's thread count, for a
    process that a port test starts."""
    env = dict(os.environ)
    env["OMP_NUM_THREADS"] = str(THREADS)
    return env


class NullLogger:
    """A ``MetricLogger`` that writes nothing."""

    def __init__(self, log_dir):
        pass

    def scalar(self, tag, value, step):
        pass

    def close(self):
        pass
