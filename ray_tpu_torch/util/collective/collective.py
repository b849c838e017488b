"""Public collective API.

Port of ``ray_tpu/util/collective/collective.py`` (reference:
python/ray/util/collective/collective.py — init_collective_group (:123),
create_collective_group (:160, declarative form), allreduce (:268),
barrier (:308), reduce/broadcast/allgather/reducescatter (:321-512),
send/recv (:541-625), GroupManager (:40)).

Backend "nccl" (the default) groups are in-process: one process drives
its GPUs, each op one NCCL call over a list of per-rank tensors; backend
"store" groups are cross-process, rendezvoused through a named
coordinator actor (the NCCLUniqueIDStore pattern).
"""

from __future__ import annotations

import threading
from typing import Any, Dict, List, Optional

from .types import (
    AllGatherOptions,
    AllReduceOptions,
    Backend,
    BarrierOptions,
    BroadcastOptions,
    RecvOptions,
    ReduceOp,
    ReduceOptions,
    ReduceScatterOptions,
    SendOptions,
)


class GroupManager:
    """Per-process registry of collective groups (reference :40)."""

    def __init__(self):
        self._groups: Dict[str, Any] = {}
        self._lock = threading.Lock()

    def create_group(
        self,
        backend: str,
        world_size: int,
        rank: int,
        group_name: str,
        **kwargs,
    ):
        backend = Backend(backend)
        with self._lock:
            if group_name in self._groups:
                raise RuntimeError(f"group {group_name!r} already initialized")
            if backend == Backend.NCCL:
                from .collective_group.nccl_group import NcclGroup

                group = NcclGroup(world_size, rank, group_name, **kwargs)
            else:
                from .collective_group.store_group import StoreGroup

                group = StoreGroup(world_size, rank, group_name)
            self._groups[group_name] = group
            return group

    def get_group(self, group_name: str):
        group = self._groups.get(group_name)
        if group is None:
            raise ValueError(
                f"collective group {group_name!r} is not initialized in this "
                "process; call init_collective_group first"
            )
        return group

    def is_group_initialized(self, group_name: str) -> bool:
        return group_name in self._groups

    def destroy_group(self, group_name: str) -> None:
        with self._lock:
            group = self._groups.pop(group_name, None)
        if group is not None:
            group.destroy_group()


_group_mgr = GroupManager()


def init_collective_group(
    world_size: int,
    rank: int,
    backend: str = "nccl",
    group_name: str = "default",
    **kwargs,
):
    """Initialize this process's membership in a collective group
    (reference :123). For backend='nccl' the process drives all
    ``world_size`` devices itself, and rank is a formality."""
    return _group_mgr.create_group(backend, world_size, rank, group_name, **kwargs)


def create_collective_group(
    actors: List[Any],
    world_size: int,
    ranks: List[int],
    backend: str = "store",
    group_name: str = "default",
):
    """Declarative form (reference :160): the driver initializes a group
    over existing actors. Each actor must expose an
    ``init_collective_group``-calling method or be a plain actor — we
    invoke the module API inside each via a closure task."""
    import ray_tpu_torch

    if len(actors) != len(ranks):
        raise ValueError("actors and ranks must align")

    def _init_in_actor(actor, rank):
        return actor.__ray_call__.remote(
            lambda self, ws=world_size, r=rank, b=backend, g=group_name: (
                init_collective_group(ws, r, backend=b, group_name=g)
                and None
            )
        )

    refs = []
    for actor, rank in zip(actors, ranks):
        refs.append(_init_in_actor(actor, rank))
    ray_tpu_torch.get(refs)


def is_group_initialized(group_name: str = "default") -> bool:
    return _group_mgr.is_group_initialized(group_name)


def destroy_collective_group(group_name: str = "default") -> None:
    _group_mgr.destroy_group(group_name)


def get_rank(group_name: str = "default") -> int:
    return _group_mgr.get_group(group_name).rank


def get_collective_group_size(group_name: str = "default") -> int:
    return _group_mgr.get_group(group_name).world_size


def get_group_handle(group_name: str = "default"):
    return _group_mgr.get_group(group_name)


def allreduce(tensor, group_name: str = "default", op: ReduceOp = ReduceOp.SUM):
    return _group_mgr.get_group(group_name).allreduce(
        tensor, AllReduceOptions(reduceOp=op)
    )


def reduce(
    tensor,
    dst_rank: int = 0,
    group_name: str = "default",
    op: ReduceOp = ReduceOp.SUM,
):
    return _group_mgr.get_group(group_name).reduce(
        tensor, ReduceOptions(reduceOp=op, root_rank=dst_rank)
    )


def broadcast(tensor, src_rank: int = 0, group_name: str = "default"):
    return _group_mgr.get_group(group_name).broadcast(
        tensor, BroadcastOptions(root_rank=src_rank)
    )


def allgather(tensor, group_name: str = "default"):
    return _group_mgr.get_group(group_name).allgather(tensor, AllGatherOptions())


def reducescatter(
    tensor, group_name: str = "default", op: ReduceOp = ReduceOp.SUM
):
    return _group_mgr.get_group(group_name).reducescatter(
        tensor, ReduceScatterOptions(reduceOp=op)
    )


def barrier(group_name: str = "default"):
    return _group_mgr.get_group(group_name).barrier(BarrierOptions())


def send(tensor, dst_rank: int, group_name: str = "default"):
    return _group_mgr.get_group(group_name).send(
        tensor, SendOptions(dst_rank=dst_rank)
    )


def recv(src_rank: int, group_name: str = "default"):
    return _group_mgr.get_group(group_name).recv(RecvOptions(src_rank=src_rank))
