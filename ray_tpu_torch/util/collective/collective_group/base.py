"""Abstract collective group.

Parity: python/ray/util/collective/collective_group/base_collective_group.py
(BaseGroup) and the compiled-graph Communicator ABC
(python/ray/experimental/channel/communicator.py:19) folded into one
interface: a group knows its world_size/rank and serves the full op set.
"""

from __future__ import annotations

from abc import ABC, abstractmethod
from typing import Any, List

from ..types import (
    AllGatherOptions,
    AllReduceOptions,
    BarrierOptions,
    BroadcastOptions,
    RecvOptions,
    ReduceOptions,
    ReduceScatterOptions,
    SendOptions,
)


class BaseGroup(ABC):
    def __init__(self, world_size: int, rank: int, group_name: str):
        self._world_size = world_size
        self._rank = rank
        self._group_name = group_name

    @property
    def world_size(self) -> int:
        return self._world_size

    @property
    def rank(self) -> int:
        return self._rank

    @property
    def group_name(self) -> str:
        return self._group_name

    @property
    @abstractmethod
    def backend(self) -> str: ...

    @abstractmethod
    def destroy_group(self) -> None: ...

    @abstractmethod
    def allreduce(self, tensors, opts: AllReduceOptions = AllReduceOptions()): ...

    @abstractmethod
    def barrier(self, opts: BarrierOptions = BarrierOptions()): ...

    @abstractmethod
    def reduce(self, tensors, opts: ReduceOptions = ReduceOptions()): ...

    @abstractmethod
    def broadcast(self, tensors, opts: BroadcastOptions = BroadcastOptions()): ...

    @abstractmethod
    def allgather(self, tensors, opts: AllGatherOptions = AllGatherOptions()): ...

    @abstractmethod
    def reducescatter(
        self, tensors, opts: ReduceScatterOptions = ReduceScatterOptions()
    ): ...

    @abstractmethod
    def send(self, tensors, opts: SendOptions): ...

    @abstractmethod
    def recv(self, tensors, opts: RecvOptions): ...
