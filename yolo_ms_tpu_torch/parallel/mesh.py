"""The layouts of the ranks: the 1-D ``"data"`` group and the 2-D
(data, spatial) mesh.

Port of ``yolo_ms_tpu/parallel/mesh.py``. The JAX package names a mesh and
lets GSPMD insert the collectives; here the ranks of the process group are
the mesh, each rank holds its rows of the global batch (and, on a 2-D mesh,
its rows of the image height), and the collectives are written out where
the math needs them (BatchNorm statistics in ``nn/blocks.py``, the loss
normalizer and metrics in ``train/loss.py``, the gradient in
``train/trainer.py``, the halo exchanges in ``parallel/spatial.py``).

The JAX sharding functions return ``NamedSharding`` layouts of a global
array; their counterparts here return the slicers that cut this rank's part
out of a global host batch.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch
import torch.distributed as dist
from torch import nn

from yolo_ms_tpu_torch.nn.blocks import set_batch_norm_group, set_spatial_group
from yolo_ms_tpu_torch.parallel.distributed import (
    data_parallel_group,
    get_rank,
    rank_device,
    world_size,
)
from yolo_ms_tpu_torch.parallel.spatial import HeightShards


def make_mesh():
    """The 1-D ``"data"`` group: the default process group when several
    processes run, None in one process."""
    return data_parallel_group()


def _rows_of(batch: dict, index: int, count: int) -> dict:
    """Rows ``[index * local, (index + 1) * local)`` of every array of
    ``batch`` with a leading batch dimension (other entries pass through)."""
    out = {}
    for k, v in batch.items():
        if getattr(v, "ndim", 0) >= 1:
            if v.shape[0] % count:
                raise ValueError(f"{k}: batch {v.shape[0]} does not split over {count} ranks")
            local = v.shape[0] // count
            v = v[index * local : (index + 1) * local]
        out[k] = v
    return out


def shard_batch(batch: dict) -> dict:
    """This rank's rows ``[rank * local, (rank + 1) * local)`` of a global
    host batch (every array with a leading batch dimension; other entries
    pass through)."""
    return _rows_of(batch, get_rank(), world_size())


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A (data, spatial) grid of ranks: rank ``d * spatial + s`` sits at data
    row ``d`` and spatial index ``s``, row-major as the JAX mesh's
    ``np.reshape``.

    ``spatial_group`` holds the ranks of this rank's data row (one image
    row band each) and ``data_group`` the ranks at this rank's spatial index
    (one per data row); either is None where it would hold this rank alone.
    The world group (``data_parallel_group()``) spans both axes.
    ``shards`` is the spatial group's row partition and halo exchange.

    Which axis each reduction spans is the mesh's to say (``attach``), and
    ``train/trainer.py:make_train_step`` takes the gradient's group from it."""

    data: int
    spatial: int
    data_index: int
    spatial_index: int
    data_group: Any
    spatial_group: Any
    shards: HeightShards

    def attach(self, model: nn.Module, loss_fn):
        """Set every reduction of ``model`` and of its ``loss_fn``
        (``train/loss.py:DetectionLoss``) for this mesh: the BatchNorm
        statistics over the world (sums and counts, so both axes at once),
        the height-sharded sites over the spatial group
        (``nn/blocks.py:set_spatial_group``), and the loss normalizer and
        metrics over the data group (the spatial ranks of one data row
        compute copies of that row's loss; the world would count each
        ``spatial`` times). Returns the loss to train with: ``loss_fn``
        with the data group."""
        set_batch_norm_group(model, data_parallel_group())
        set_spatial_group(model, self)
        return dataclasses.replace(loss_fn, group=self.data_group)


def make_mesh_2d(data: int, spatial: int) -> Mesh:
    """The (data, spatial) mesh over every rank of the process group: batch
    over ``data``, image height over ``spatial``. Every rank must call it,
    with the same arguments: it creates each axis group on every rank, in
    one order."""
    world, rank = world_size(), get_rank()
    if world < data * spatial:
        raise ValueError(
            f"need {data * spatial} devices for a {data}x{spatial} mesh, have {world}")
    if world > data * spatial:
        raise ValueError(f"a {data}x{spatial} mesh must span all {world} ranks")
    d, s = divmod(rank, spatial)
    rows = [[i * spatial + j for j in range(spatial)] for i in range(data)]
    cols = [[i * spatial + j for i in range(data)] for j in range(spatial)]
    spatial_group = data_group = None
    if spatial > 1:
        for i, ranks in enumerate(rows):
            g = dist.new_group(ranks)
            spatial_group = g if i == d else spatial_group
    if data > 1:
        for j, ranks in enumerate(cols):
            g = dist.new_group(ranks)
            data_group = g if j == s else data_group
    if world > 1 and dist.get_backend() == "nccl":
        # NCCL makes a group's communicator at its first collective, which
        # every member must join; a batch of point-to-point messages
        # (parallel/distributed.py:exchange) may involve only some of them
        for g in (spatial_group, data_group):
            if g is not None:
                dist.all_reduce(torch.zeros(1, device=rank_device()), group=g)
    return Mesh(data, spatial, d, s, data_group, spatial_group,
                HeightShards(spatial_group, rows[d], s))


def hybrid_batch_sharding(mesh: Mesh) -> Callable[[dict], dict]:
    """The slicer of a global NHWC host batch onto this rank: the rows of
    its data row of every array (images ``[B@data, H@spatial]``, the GT
    ``[B@data]``, the same on every rank of a spatial group), and the
    image height as ``"height"``, which the sharded forward needs."""

    def slicer(batch: dict) -> dict:
        return spatial_sharding(mesh)(_rows_of(batch, mesh.data_index, mesh.data))

    return slicer


def spatial_sharding(mesh: Mesh) -> Callable[[dict], dict]:
    """The slicer of a host batch's NHWC ``images`` onto this rank's rows of
    the image height (``[B, H@spatial]``; every other entry passes through)
    and the image height as ``"height"``. The JAX function shards the
    height over the axis it is given; here it is always the mesh's
    spatial axis (a 1-D height split is the (1, S) mesh)."""

    def slicer(batch: dict) -> dict:
        images = batch["images"]
        return {**batch, "images": mesh.shards.own_rows(images, 1),
                "height": int(images.shape[1])}

    return slicer
