"""Multi-process initialization and the host-side collectives of data
parallel training.

Port of ``yolo_ms_tpu/parallel/distributed.py`` on ``torch.distributed``.
Call ``maybe_initialize_distributed()`` once at program start: under
``torchrun`` (``RANK`` / ``WORLD_SIZE`` / ``LOCAL_RANK`` / ``MASTER_ADDR`` /
``MASTER_PORT`` in the environment), or given explicit arguments, it joins
the process group; otherwise it returns False and everything below is a
one-process no-op.

Each rank drives one device: ``cuda:LOCAL_RANK`` (the CPU when the caller
asks for it). NCCL refuses two ranks on one card, so ranks may share a card
only under ``gloo``, whose collectives on CUDA tensors are staged through the
host; the mapping is printed at init. ``nccl`` with more local ranks than
cards raises: it is never swapped for ``gloo``.
"""

from __future__ import annotations

import datetime
import os

import torch
import torch.distributed as dist

# the device this process's rank drives, set by maybe_initialize_distributed
_RANK_DEVICE: torch.device | None = None


def maybe_initialize_distributed(
    backend: str | None = None,
    *,
    device: str | None = None,
    init_method: str | None = None,
    world_size: int | None = None,
    rank: int | None = None,
    local_rank: int | None = None,
) -> bool:
    """Join the process group when running several processes. Returns True
    when a group is (or already was) initialized, False when neither the
    environment nor the arguments name one.

    ``device`` is ``"cuda"`` (the default: the card, an error without one)
    or ``"cpu"``. ``backend`` defaults to ``nccl`` on CUDA and ``gloo`` on
    the CPU. Explicit arguments override torchrun's variables; the address
    defaults to ``tcp://MASTER_ADDR:MASTER_PORT``."""
    global _RANK_DEVICE
    if dist.is_initialized():
        return True
    env = os.environ
    if world_size is None and "WORLD_SIZE" not in env:
        return False
    world = int(world_size if world_size is not None else env["WORLD_SIZE"])
    rank = int(rank if rank is not None else env.get("RANK", 0))
    local_rank = int(local_rank if local_rank is not None else env.get("LOCAL_RANK", rank))
    if init_method is None:
        init_method = f"tcp://{env.get('MASTER_ADDR', 'localhost')}:{env['MASTER_PORT']}"

    dev = torch.device(device or "cuda")
    shared = False
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device available; pass device='cpu' to run the ranks on the CPU")
        backend = backend or "nccl"
        cards = torch.cuda.device_count()
        shared = local_rank >= cards
        if shared and backend == "nccl":
            raise RuntimeError(
                f"nccl: local rank {local_rank} has no card of its own ({cards} card(s) on "
                f"this host); NCCL refuses two ranks on one device. Start one rank per "
                f"card, or pass backend='gloo' to let ranks share a card")
        dev = torch.device("cuda", local_rank % cards)
        torch.cuda.set_device(dev)
    else:
        backend = backend or "gloo"
        if backend == "nccl":
            raise ValueError("the nccl backend needs CUDA devices; use gloo on the CPU")
    dist.init_process_group(backend, init_method=init_method, world_size=world, rank=rank)
    _RANK_DEVICE = dev
    print(f"rank {rank} of {world} ({backend}, local rank {local_rank}) on {dev}"
          + (", a card shared with other ranks" if shared else ""), flush=True)
    return True


def leave_group() -> None:
    """Destroy the process group, if one is up. Call it before the process
    exits: a group left to the interpreter's teardown can abort the process
    (``terminate called without an active exception``) instead of letting
    it exit with its own code."""
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()


def world_size() -> int:
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def get_rank() -> int:
    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def rank_device() -> torch.device | None:
    """The device this rank drives, or None without a process group."""
    return _RANK_DEVICE if dist.is_available() and dist.is_initialized() else None


def data_parallel_group():
    """The process group that data parallel training reduces over, or None
    in one process (then every layer runs its one-process path)."""
    return dist.group.WORLD if world_size() > 1 else None


def is_primary_process() -> bool:
    """True on the process that owns shared-filesystem writes (checkpoints,
    ``best_metric.json``, the config, TensorBoard events): rank 0, or the
    only process."""
    return get_rank() == 0


def _comm_device() -> torch.device:
    """Where a small host value travels: the card under nccl, else the CPU."""
    if dist.get_backend() == "nccl":
        return _RANK_DEVICE
    return torch.device("cpu")


def exchange(sends: dict, recvs: dict, group) -> None:
    """Point-to-point within ``group``: send ``sends[r]`` to (global) rank
    ``r`` and fill ``recvs[r]`` from rank ``r``, every message posted as one
    batch (``batch_isend_irecv``) and then waited for. Both sides must post
    matching pairs, in the same order on every rank. Under nccl the batch is
    one NCCL group, so that a send and a receive between the same two ranks
    cannot wait on each other on one stream; under gloo a CUDA tensor
    travels through the host (gloo's send and recv take CPU tensors only) in
    its own dtype. A failed message raises."""
    dev = _comm_device()
    staged = {r: b if b.device == dev else torch.empty_like(b, device=dev)
              for r, b in recvs.items()}
    outgoing = {r: t.to(dev).contiguous() for r, t in sends.items()}
    ops = [dist.P2POp(dist.irecv, b, r, group) for r, b in staged.items()]
    ops += [dist.P2POp(dist.isend, t, r, group) for r, t in outgoing.items()]
    for w in dist.batch_isend_irecv(ops) if ops else []:
        w.wait()
    for r, b in recvs.items():
        if staged[r] is not b:
            b.copy_(staged[r])


def global_max_int(value: int) -> int:
    """``max(value)`` over all processes, by one MAX all-reduce (one process:
    the identity). For per-batch choices every rank must make alike, such
    as the GT bucket of ``Trainer._bucket_gt``."""
    if world_size() == 1:
        return int(value)
    t = torch.tensor([int(value)], dtype=torch.int64, device=_comm_device())
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return int(t.item())


def barrier(tag: str, timeout_s: float = 600.0) -> None:
    """Rendezvous every process, raising after ``timeout_s`` with ``tag``
    and the ranks that did not arrive (``gloo``: ``monitored_barrier``;
    ``nccl``: a barrier bounded by the group's timeout). One process: a
    no-op."""
    if world_size() == 1:
        return
    if dist.get_backend() != "gloo":
        dist.barrier()
        return
    try:
        dist.monitored_barrier(timeout=datetime.timedelta(seconds=timeout_s))
    except RuntimeError as e:
        raise TimeoutError(f"barrier {tag!r}: {e}") from e


def process_info() -> dict:
    return {
        "process_index": get_rank(),
        "process_count": world_size(),
        "local_devices": 1,
        "global_devices": world_size(),
        "backend": dist.get_backend() if dist.is_initialized() else None,
        "device": str(_RANK_DEVICE) if _RANK_DEVICE is not None else None,
    }


class _AllReduceSum(torch.autograd.Function):
    """A SUM all-reduce whose backward is the SUM all-reduce of the incoming
    gradients: the rule of ``torch.distributed.nn.functional.all_reduce``
    (deprecated since torch 2.13), with a count of the collectives."""

    @staticmethod
    def forward(ctx, tensor, group):
        ctx.group = group
        out = tensor.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out, group=group)
        all_reduce_sum.calls += 1
        return out

    @staticmethod
    def backward(ctx, grad):
        return _AllReduceSum.apply(grad, ctx.group), None


def all_reduce_sum(tensor: torch.Tensor, group) -> torch.Tensor:
    """Differentiable SUM all-reduce (a new tensor). ``all_reduce_sum.calls``
    counts every collective it runs, forward and backward."""
    return _AllReduceSum.apply(tensor, group)


all_reduce_sum.calls = 0
