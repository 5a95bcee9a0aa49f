"""The shards of a multi-GPU render, and the process group they meet in.

Port of ``pathtracer_tpu/parallel/mesh.py:1-68``.  JAX makes one 1-D
``jax.sharding.Mesh`` over every device of every process and runs
``shard_map`` over it.  PyTorch runs one process per GPU (``torchrun``),
and the processes meet in ``torch.distributed``: NCCL on the card, gloo on
the CPU.  A :class:`Mesh` here is this process's part of the global shard
axis: its ordered local devices, one per shard it owns, its ``rank`` among
``world`` processes, and the global shard count ``size``.  Process ``r``
owns the global shards ``r * n_local + i``.  A device may repeat: its
shards then run one after another on it, which is how the tests stand in
for JAX's 8 virtual CPU devices (``tests/conftest.py:14-16``) and how one
H100 holds 4 shards.

Launch (one process per GPU; ``torchrun`` sets ``MASTER_ADDR``,
``MASTER_PORT``, ``WORLD_SIZE``, ``RANK`` and ``LOCAL_RANK``)::

    torchrun --nproc_per_node=<GPUs> -m pathtracer_tpu_torch.cli \\
        scene=scenes/cornell.txt --sharded

JAX's ``replicated`` / ``sharded_rows`` return ``NamedSharding``s, which
torch has no counterpart for: a shard's rows are a tensor on its device
(``parallel/sharded.py``).
"""

from __future__ import annotations

import dataclasses
import os
from datetime import timedelta

import torch

AXIS = "shard"

# how long a rendezvous or a collective may wait for the other processes
TIMEOUT = timedelta(minutes=10)


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This process's shards: ``devices[i]`` runs global shard
    ``rank * len(devices) + i`` of ``size``."""

    devices: tuple
    rank: int = 0
    world: int = 1

    @property
    def n_local(self) -> int:
        return len(self.devices)

    @property
    def size(self) -> int:
        return self.world * self.n_local

    @property
    def shard_ids(self) -> tuple:
        return tuple(self.rank * self.n_local + i for i in range(self.n_local))


def in_group() -> bool:
    """Whether this process has joined a process group."""
    return torch.distributed.is_available() and torch.distributed.is_initialized()


def group_size() -> tuple:
    """``(rank, world)`` of this process's group, ``(0, 1)`` without one."""
    if in_group():
        return torch.distributed.get_rank(), torch.distributed.get_world_size()
    return 0, 1


def collective_device() -> torch.device:
    """Where the group's collectives take their tensors: the current CUDA
    device under NCCL, the CPU under gloo."""
    if torch.distributed.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def all_reduce_sum(x: torch.Tensor) -> torch.Tensor:
    """``x`` summed over the group's processes (``x`` itself without a
    group; a group of one runs the collective all the same), on ``x``'s
    device."""
    if not in_group():
        return x
    buf = x.to(collective_device()).contiguous()
    torch.distributed.all_reduce(buf)
    return buf.to(x.device)


def all_gather_cat(x: torch.Tensor) -> torch.Tensor:
    """Every process's ``x`` (all of one shape) stacked in rank order:
    ``[world, *x.shape]`` on ``x``'s device."""
    if not in_group():
        return x[None]
    world = group_size()[1]
    buf = x.to(collective_device()).contiguous()
    parts = [torch.empty_like(buf) for _ in range(world)]
    torch.distributed.all_gather(parts, buf)
    return torch.stack(parts).to(x.device)


def _indexed(device: torch.device) -> torch.device:
    """``cuda`` as ``cuda:<current device>``, so that one card is one key."""
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


def make_mesh(devices=None) -> Mesh:
    """The mesh of this process: ``devices`` (repeats allowed), or with
    none every local CUDA device, or ``cuda:LOCAL_RANK`` in a process
    group.  Raises when no card is there (nothing falls back to the CPU)
    and when the processes of the group own different shard counts."""
    rank, world = group_size()
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "make_mesh() found no CUDA device; pass the devices, e.g. "
                "[torch.device('cpu')] * 8, to shard on the CPU"
            )
        if in_group():
            devices = [torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))]
        else:
            devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devices = tuple(_indexed(torch.device(d)) for d in devices)
    if not devices:
        raise ValueError("a mesh needs at least one device")
    if in_group():
        counts = all_gather_cat(torch.tensor([len(devices)]))
        if bool((counts != len(devices)).any()):
            raise ValueError(
                f"every process must own the same number of shards; the processes own "
                f"{counts.flatten().tolist()}"
            )
    return Mesh(devices=devices, rank=rank, world=world)


def initialize_distributed(device="cuda") -> bool:
    """Join the process group that ``torchrun``'s environment describes
    (``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``,
    ``LOCAL_RANK``): NCCL for ``cuda``, after binding the process to
    ``cuda:LOCAL_RANK``, gloo for ``cpu``.  Call it once per process before
    the first use of a device.  Returns True when it made the group (the
    caller then ends it with ``torch.distributed.destroy_process_group``),
    False when ``WORLD_SIZE`` is unset or a group exists.  Raises
    ``RuntimeError`` naming the missing variable when only one of
    ``WORLD_SIZE`` and ``RANK`` is set (``mesh.py:45-52``)."""
    has_world = "WORLD_SIZE" in os.environ
    has_rank = "RANK" in os.environ
    if has_world != has_rank:
        missing = "RANK" if has_world else "WORLD_SIZE"
        raise RuntimeError(
            "distributed launch misconfigured: WORLD_SIZE and RANK must be set "
            f"together; {missing} is missing"
        )
    dist = torch.distributed
    if not has_world or (dist.is_available() and dist.is_initialized()):
        return False
    kind = torch.device(device).type
    if kind == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
    dist.init_process_group(
        backend="nccl" if kind == "cuda" else "gloo",
        init_method="env://",
        world_size=int(os.environ["WORLD_SIZE"]),
        rank=int(os.environ["RANK"]),
        timeout=TIMEOUT,
    )
    return True
