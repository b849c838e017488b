"""multiprocessing.Pool drop-in over the distributed runtime.

Parity: python/ray/util/multiprocessing/ — the Pool API (map/starmap/
apply/async variants/imap) executing on cluster workers instead of local
forks, so existing Pool code scales past one host unchanged.
"""

from __future__ import annotations

from typing import Any, Callable, Iterable, List, Optional


class AsyncResult:
    def __init__(self, refs, single: bool):
        self._refs = refs
        self._single = single

    def get(self, timeout: Optional[float] = None):
        import ray_tpu_torch

        out = ray_tpu_torch.get(self._refs, timeout=timeout)
        return out[0] if self._single else out

    def wait(self, timeout: Optional[float] = None) -> None:
        import ray_tpu_torch

        ray_tpu_torch.wait(self._refs, num_returns=len(self._refs), timeout=timeout)

    def ready(self) -> bool:
        import ray_tpu_torch

        done, _ = ray_tpu_torch.wait(
            self._refs, num_returns=len(self._refs), timeout=0
        )
        return len(done) == len(self._refs)

    def successful(self) -> bool:
        if not self.ready():
            # multiprocessing contract: querying an unfinished result is
            # an error, not False
            raise ValueError("AsyncResult is not ready")
        try:
            self.get(timeout=0.001)
            return True
        except Exception:
            return False


class Pool:
    """Process pool on cluster workers (reference: util/multiprocessing).

    ``processes`` bounds in-flight submission on the lazy/sync paths
    (map/starmap/apply/imap*); the *_async methods submit their whole
    input eagerly, matching their return-immediately contract. The
    runtime's worker pool does the real scaling."""

    def __init__(self, processes: Optional[int] = None):
        import ray_tpu_torch

        if not ray_tpu_torch.is_initialized():
            ray_tpu_torch.init(ignore_reinit_error=True)
        self._ray = ray_tpu_torch
        self._processes = processes
        self._closed = False

    # -- sync ----------------------------------------------------------
    def map(self, func: Callable, iterable: Iterable) -> List[Any]:
        return list(self.imap(func, iterable))

    def starmap(self, func: Callable, iterable: Iterable) -> List[Any]:
        return list(self.imap(lambda pair: func(*pair), iterable))

    def apply(self, func: Callable, args: tuple = (), kwds: dict = None):
        return self.apply_async(func, args, kwds).get()

    # -- async ---------------------------------------------------------
    def _remote(self, func):
        import ray_tpu_torch

        return ray_tpu_torch.remote(func)

    def map_async(self, func: Callable, iterable: Iterable) -> AsyncResult:
        self._check_open()
        rf = self._remote(func)
        # whole input in one SUBMIT_TASKS frame; (x,) keeps single-arg
        # semantics even when x is itself a tuple
        return AsyncResult(rf.map([(x,) for x in iterable]), single=False)

    def starmap_async(self, func: Callable, iterable: Iterable) -> AsyncResult:
        self._check_open()
        rf = self._remote(func)
        return AsyncResult(rf.map([tuple(x) for x in iterable]), single=False)

    def apply_async(self, func: Callable, args: tuple = (),
                    kwds: dict = None) -> AsyncResult:
        self._check_open()
        rf = self._remote(func)
        return AsyncResult([rf.remote(*args, **(kwds or {}))], single=True)

    def _window(self) -> int:
        return self._processes or 64

    def imap(self, func: Callable, iterable: Iterable):
        """Lazy, windowed (stdlib imap consumes the iterable
        incrementally — so does this, keeping <= window in flight)."""
        self._check_open()
        from collections import deque

        rf = self._remote(func)
        it = iter(iterable)
        inflight: deque = deque()
        first: List[Any] = []
        try:
            while len(first) < self._window():
                first.append((next(it),))
        except StopIteration:
            pass
        # the initial window is the bursty part — ship it as one frame
        inflight.extend(rf.map(first))
        while inflight:
            yield self._ray.get(inflight.popleft())
            try:
                inflight.append(rf.remote(next(it)))
            except StopIteration:
                pass

    def imap_unordered(self, func: Callable, iterable: Iterable):
        self._check_open()
        rf = self._remote(func)
        it = iter(iterable)
        pending = set()
        exhausted = False
        while True:
            refill: List[Any] = []
            while not exhausted and len(pending) + len(refill) < self._window():
                try:
                    refill.append((next(it),))
                except StopIteration:
                    exhausted = True
            if refill:
                pending.update(rf.map(refill))
            if not pending:
                return
            done, _ = self._ray.wait(list(pending), num_returns=1, timeout=60)
            for ref in done:
                pending.discard(ref)
                yield self._ray.get(ref)

    # -- lifecycle ------------------------------------------------------
    def _check_open(self):
        if self._closed:
            raise ValueError("Pool is closed")

    def close(self) -> None:
        self._closed = True

    def terminate(self) -> None:
        self._closed = True

    def join(self) -> None:
        pass

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()
