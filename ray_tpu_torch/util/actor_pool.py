"""ActorPool: map work over a fixed pool of actors.

Parity: python/ray/util/actor_pool.py:13 in the reference.
"""

from __future__ import annotations

from typing import Any, Callable, Iterable, List


class ActorPool:
    def __init__(self, actors: List[Any]):
        self._idle = list(actors)
        self._future_to_actor = {}
        self._index_to_future = {}
        self._next_task_index = 0
        self._next_return_index = 0
        self._pending_submits: List[tuple] = []

    def submit(self, fn: Callable, value: Any) -> None:
        if self._idle:
            actor = self._idle.pop()
            future = fn(actor, value)
            self._future_to_actor[future] = (self._next_task_index, actor)
            self._index_to_future[self._next_task_index] = future
            self._next_task_index += 1
        else:
            self._pending_submits.append((fn, value))

    def has_next(self) -> bool:
        return bool(self._index_to_future) or bool(self._pending_submits)

    def get_next(self, timeout: float | None = None) -> Any:
        from .. import get

        if self._next_return_index >= self._next_task_index and not self._pending_submits:
            raise StopIteration("No more results to get")
        while self._next_return_index not in self._index_to_future:
            self._maybe_drain()
        future = self._index_to_future.pop(self._next_return_index)
        self._next_return_index += 1
        _, actor = self._future_to_actor.pop(future)
        self._return_actor(actor)
        return get(future, timeout=timeout)

    def get_next_unordered(self, timeout: float | None = None) -> Any:
        from .. import get, wait

        if not self.has_next():
            raise StopIteration("No more results to get")
        while not self._future_to_actor:
            self._maybe_drain()
        ready, _ = wait(list(self._future_to_actor), num_returns=1, timeout=timeout)
        if not ready:
            raise TimeoutError("get_next_unordered timed out")
        future = ready[0]
        idx, actor = self._future_to_actor.pop(future)
        self._index_to_future.pop(idx, None)
        self._return_actor(actor)
        return get(future)

    def _return_actor(self, actor) -> None:
        self._idle.append(actor)
        self._maybe_drain()

    def _maybe_drain(self) -> None:
        while self._pending_submits and self._idle:
            fn, value = self._pending_submits.pop(0)
            self.submit(fn, value)

    @staticmethod
    def _submit_window():
        """Batched-send window for the submit burst: actor tasks can't
        share one SUBMIT_TASKS frame (each targets a different actor),
        but holding the client's count-based flush for the burst packs
        them into minimal wire frames."""
        from .._private import worker

        client = getattr(worker, "_client", None)
        if client is None:
            import contextlib

            return contextlib.nullcontext()
        return client.batch_window()

    def map(self, fn: Callable, values: Iterable[Any]):
        with self._submit_window():
            for v in values:
                self.submit(fn, v)
        while self.has_next():
            yield self.get_next()

    def map_unordered(self, fn: Callable, values: Iterable[Any]):
        with self._submit_window():
            for v in values:
                self.submit(fn, v)
        while self.has_next():
            yield self.get_next_unordered()

    def has_free(self) -> bool:
        return bool(self._idle)

    def pop_idle(self):
        return self._idle.pop() if self._idle else None

    def push(self, actor) -> None:
        self._return_actor(actor)
