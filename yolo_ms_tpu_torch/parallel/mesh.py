"""The data-parallel layout: a 1-D ``"data"`` group of ranks, one device each.

Port of ``yolo_ms_tpu/parallel/mesh.py:29-55``. The JAX package names a mesh
and lets GSPMD insert the collectives; here the ranks of the process group
are the ``"data"`` axis, each rank holds its rows of the global batch, and
the collectives are written out where the math needs them (BatchNorm
statistics in ``nn/blocks.py``, the loss normalizer and metrics in
``train/loss.py``, the gradient in ``train/trainer.py``).

The spatial (DP x SP) leg, ``make_mesh_2d`` / ``hybrid_batch_sharding`` /
``spatial_sharding``, needs a halo exchange written by hand around every
conv and pool; it is ROADMAP item A12 and raises here.
"""

from __future__ import annotations

from yolo_ms_tpu_torch.parallel.distributed import data_parallel_group, get_rank, world_size

_SPATIAL = (
    "the spatial (DP x SP) mesh is not ported yet (ROADMAP A12: a halo exchange "
    "written by hand around every conv and pool)"
)


def make_mesh():
    """The 1-D ``"data"`` group: the default process group when several
    processes run, None in one process."""
    return data_parallel_group()


def shard_batch(batch: dict) -> dict:
    """This rank's rows ``[rank * local, (rank + 1) * local)`` of a global
    host batch (every array with a leading batch dimension; other entries
    pass through)."""
    rank, world = get_rank(), world_size()
    out = {}
    for k, v in batch.items():
        if getattr(v, "ndim", 0) >= 1:
            if v.shape[0] % world:
                raise ValueError(f"{k}: batch {v.shape[0]} does not split over {world} ranks")
            local = v.shape[0] // world
            v = v[rank * local : (rank + 1) * local]
        out[k] = v
    return out


def make_mesh_2d(data: int, spatial: int, devices=None):
    raise NotImplementedError(_SPATIAL)


def hybrid_batch_sharding(mesh):
    raise NotImplementedError(_SPATIAL)


def spatial_sharding(mesh, axis_name: str = "data"):
    raise NotImplementedError(_SPATIAL)

