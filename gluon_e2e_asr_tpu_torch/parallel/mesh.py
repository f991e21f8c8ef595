"""Data parallelism over ``torch.distributed``: one process per device.

Counterpart of ``gluon_e2e_asr_tpu/parallel/mesh.py``. There the batch
axis is sharded over a 1-D ``data`` mesh axis, the parameters are
replicated and the gradients are summed with ``psum``. Here each process
(a rank) holds the parameters, takes its contiguous block of the host
batch's rows (``shard_rows``, the role of ``P(DATA_AXIS)``) and sums the
gradients with one all-reduce (``all_reduce_sum``). Per-row results of
decoding come back in the global batch order (``gather_rows``).

Processes are launched with ``torchrun``, whose ``RANK``, ``WORLD_SIZE``,
``LOCAL_RANK`` and ``MASTER_ADDR`` say where each one stands; without
them a process is a world of one, with a process group of its own, so
both run the same code. At a world of one the collectives are the
identity and run nothing; above it they need the process group and
raise without one. NCCL serves CUDA devices and gloo the CPU. A
default group made before the call (two processes on one card join over
gloo, since NCCL refuses two ranks on one device) is adopted as it is.
Nothing falls back: a group that cannot be made, or a collective that
fails, raises.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Any, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

BACKENDS = {"cuda": "nccl", "cpu": "gloo"}


@dataclass(frozen=True)
class World:
    """This process's place among the data-parallel ranks. ``size`` alone
    says whether rows are split and collectives run (``size > 1``);
    ``group`` is None for a process outside any process group
    (``train.dp: false``), and a collective at ``size > 1`` needs it."""

    rank: int = 0
    size: int = 1
    local_rank: int = 0
    group: Any = None

    @property
    def is_main(self) -> bool:
        return self.rank == 0

    def collective_group(self):
        """The process group a collective runs over; raises at ``size > 1``
        without one (each rank would keep its partial sums)."""
        if self.group is None:
            raise RuntimeError(
                f"a world of {self.size} ranks without a process group: "
                "make it with init_data_parallel")
        return self.group

    def barrier(self) -> None:
        """Wait for every rank; nothing at a world of one."""
        if self.size > 1:
            dist.barrier(group=self.collective_group())


SINGLE = World()


def _env_int(name: str, default: int) -> int:
    value = os.environ.get(name)
    return default if value is None else int(value)


def init_data_parallel(device_type: str) -> World:
    """Join (or make) the default process group for ``device_type``
    (``cuda`` or ``cpu``) and return this process's ``World``. On CUDA the
    process's current device becomes ``cuda:LOCAL_RANK`` first: every
    kernel launches on the current device."""
    if device_type not in BACKENDS:
        raise ValueError(f"data parallelism runs on cuda or cpu, not "
                         f"{device_type!r}")
    rank, size = _env_int("RANK", 0), _env_int("WORLD_SIZE", 1)
    local_rank = _env_int("LOCAL_RANK", 0)
    if device_type == "cuda":
        torch.cuda.set_device(local_rank)
    if not dist.is_initialized():
        backend = BACKENDS[device_type]
        if "MASTER_ADDR" in os.environ:
            dist.init_process_group(backend, init_method="env://",
                                    rank=rank, world_size=size)
        elif size == 1:
            dist.init_process_group(backend, store=dist.HashStore(),
                                    rank=0, world_size=1)
        else:
            raise RuntimeError(
                f"WORLD_SIZE={size} without MASTER_ADDR: launch the ranks "
                "with torchrun")
    if (dist.get_rank(), dist.get_world_size()) != (rank, size):
        raise RuntimeError(
            f"the process group has rank {dist.get_rank()} of "
            f"{dist.get_world_size()}, the environment says {rank} of {size}")
    return World(rank, size, local_rank, dist.group.WORLD)


def shard_rows(x, rank: int, world: int):
    """Rank ``rank``'s contiguous block of the leading (batch) axis of
    ``x`` (a tensor or an array) split ``world`` ways."""
    n = x.shape[0]
    if n % world:
        raise ValueError(f"a batch of {n} rows does not split over {world} "
                         "ranks")
    per = n // world
    return x[rank * per:(rank + 1) * per]


def all_reduce_sum(tensors: Sequence[torch.Tensor], world: World) -> None:
    """Sum each of ``tensors`` over the ranks, in place: the tensors, in
    the order given, go into one flat buffer and one SUM. The identity at
    a world of one."""
    if world.size == 1:
        return
    group = world.collective_group()
    dtypes = {t.dtype for t in tensors}
    if len(dtypes) != 1:
        raise TypeError(f"all_reduce_sum takes one dtype, got {dtypes}")
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=group)
    offset = 0
    for t in tensors:
        t.copy_(flat[offset:offset + t.numel()].view_as(t))
        offset += t.numel()


def gather_rows(rows, world: World):
    """Every rank's per-row results (a list, or an array whose leading axis
    is the rows), concatenated in rank order: the global batch's rows in
    their order. The same on every rank; ``rows`` itself at a world of
    one."""
    if world.size == 1:
        return rows
    group = world.collective_group()
    parts: List[Optional[Any]] = [None] * world.size
    dist.all_gather_object(parts, rows, group=group)
    if isinstance(rows, np.ndarray):
        return np.concatenate(parts)
    return [r for part in parts for r in part]


def check_replicated(tensors: Sequence[torch.Tensor], world: World) -> None:
    """Raise unless ``tensors`` (the parameters) are equal on every rank,
    by one gather of each rank's checksum."""
    if world.size == 1:
        return
    s = float(sum(t.detach().double().sum()
                  + t.detach().double().square().sum() for t in tensors))
    sums = gather_rows([s], world)
    if len(set(sums)) > 1:
        raise RuntimeError(
            f"the parameters differ between ranks: checksums {sums} (each "
            "rank draws them from train.seed)")
