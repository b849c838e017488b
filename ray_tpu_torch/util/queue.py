"""Distributed Queue backed by an async actor.

Parity: python/ray/util/queue.py — same API (put/get with block/timeout,
put_nowait/get_nowait, qsize/empty/full), implemented over an asyncio
actor so many producers/consumers block server-side without tying up
worker threads (the reference does exactly this with an async _QueueActor).
"""

from __future__ import annotations

from typing import Any, List, Optional


class Empty(Exception):
    pass


class Full(Exception):
    pass


class _QueueActor:
    def __init__(self, maxsize: int = 0):
        import asyncio

        self._q: "asyncio.Queue" = asyncio.Queue(maxsize=maxsize)

    async def put(self, item, timeout: Optional[float] = None) -> bool:
        import asyncio

        if timeout is None:
            await self._q.put(item)
            return True
        try:
            await asyncio.wait_for(self._q.put(item), timeout)
            return True
        except asyncio.TimeoutError:
            return False

    async def put_nowait(self, item) -> bool:
        try:
            self._q.put_nowait(item)
            return True
        except Exception:
            return False

    async def get(self, timeout: Optional[float] = None):
        import asyncio

        if timeout is None:
            return True, await self._q.get()
        try:
            return True, await asyncio.wait_for(self._q.get(), timeout)
        except asyncio.TimeoutError:
            return False, None

    async def get_nowait(self):
        try:
            return True, self._q.get_nowait()
        except Exception:
            return False, None

    async def qsize(self) -> int:
        return self._q.qsize()

    async def maxsize(self) -> int:
        return self._q.maxsize


class Queue:
    def __init__(self, maxsize: int = 0, *, actor_options: Optional[dict] = None):
        import ray_tpu_torch

        self.maxsize = maxsize
        cls = ray_tpu_torch.remote(_QueueActor)
        if actor_options:
            cls = cls.options(**actor_options)
        self.actor = cls.remote(maxsize)

    def put(self, item, block: bool = True, timeout: Optional[float] = None) -> None:
        import ray_tpu_torch

        if not block:
            if not ray_tpu_torch.get(self.actor.put_nowait.remote(item)):
                raise Full("queue is full")
            return
        if not ray_tpu_torch.get(self.actor.put.remote(item, timeout)):
            raise Full(f"put timed out after {timeout}s")

    def put_nowait(self, item) -> None:
        self.put(item, block=False)

    def get(self, block: bool = True, timeout: Optional[float] = None) -> Any:
        import ray_tpu_torch

        if not block:
            ok, item = ray_tpu_torch.get(self.actor.get_nowait.remote())
            if not ok:
                raise Empty("queue is empty")
            return item
        ok, item = ray_tpu_torch.get(self.actor.get.remote(timeout))
        if not ok:
            raise Empty(f"get timed out after {timeout}s")
        return item

    def get_nowait(self) -> Any:
        return self.get(block=False)

    def put_nowait_batch(self, items: List[Any]) -> None:
        for item in items:
            self.put_nowait(item)

    def get_nowait_batch(self, num_items: int) -> List[Any]:
        return [self.get_nowait() for _ in range(num_items)]

    def qsize(self) -> int:
        import ray_tpu_torch

        return ray_tpu_torch.get(self.actor.qsize.remote())

    def size(self) -> int:
        return self.qsize()

    def empty(self) -> bool:
        return self.qsize() == 0

    def full(self) -> bool:
        return self.maxsize > 0 and self.qsize() >= self.maxsize

    def shutdown(self) -> None:
        import ray_tpu_torch

        ray_tpu_torch.kill(self.actor)
