"""Multi-process data parallel training: process-group init and the host
collectives (``distributed.py``), the ``"data"`` layout (``mesh.py``) and a
two-rank dry run on the CPU (``dryrun.py``)."""
