"""@serve.batch — transparent request batching.

Parity: python/ray/serve/batching.py — an async method decorated with
@serve.batch collects concurrent calls into a list and invokes the
underlying function once per batch (max_batch_size or
batch_wait_timeout_s, whichever first). On TPU replicas this is the
lever that turns scalar requests into MXU-sized batches.
"""

from __future__ import annotations

import asyncio
import contextvars
import functools
import time
import weakref
from typing import Any, Callable, List, Optional

# every live batch queue in this replica process — Replica.stats() sums
# their depths into the "queued" load signal the controller scrapes
_QUEUES: "weakref.WeakSet[_BatchQueue]" = weakref.WeakSet()

# the ambient request deadline (monotonic, THIS process's clock), set by
# Replica.handle_request before the user callable runs. A @serve.batch
# wrapper reads it at submit so the batch loop can drop a member whose
# deadline expires while parked — before the batch executes — without
# poisoning the rest of the batch.
_deadline_ctx: contextvars.ContextVar[Optional[float]] = contextvars.ContextVar(
    "serve_request_deadline", default=None
)


def queued_total() -> int:
    """Requests parked in this process's batch queues right now."""
    total = 0
    for q in list(_QUEUES):
        if q.queue is not None:
            total += q.queue.qsize()
    return total


class _BatchQueue:
    def __init__(self, fn, max_batch_size: int, timeout_s: float):
        self.fn = fn
        self.max_batch_size = max_batch_size
        self.timeout_s = timeout_s
        self.queue: Optional[asyncio.Queue] = None
        self.task: Optional[asyncio.Task] = None
        _QUEUES.add(self)

    def _ensure(self):
        if self.queue is None:
            self.queue = asyncio.Queue()
            self.task = asyncio.get_running_loop().create_task(self._loop())

    async def submit(self, item) -> Any:
        from ..util import tracing as _tracing

        self._ensure()
        fut = asyncio.get_running_loop().create_future()
        # carry the submitter's trace context AND deadline into the
        # batch loop: the loop task was created from whichever request
        # arrived first and its ambient context is useless for later
        # members
        await self.queue.put(
            (item, fut, _tracing.current_context(), time.monotonic(),
             _deadline_ctx.get())
        )
        return await fut

    async def _loop(self):
        from ._private import observability as obs
        from ._private import payloads as _payloads

        while True:
            entry = await self.queue.get()
            batch = [entry]
            deadline = asyncio.get_running_loop().time() + self.timeout_s
            while len(batch) < self.max_batch_size:
                remaining = deadline - asyncio.get_running_loop().time()
                if remaining <= 0:
                    break
                try:
                    batch.append(
                        await asyncio.wait_for(self.queue.get(), timeout=remaining)
                    )
                except asyncio.TimeoutError:
                    break
            # pre-execute deadline check: a member that expired while
            # parked is dropped HERE — its future gets the expiry error
            # and it never reaches the user function, so an abandoned
            # request can't poison (or bloat) the batch it parked in
            t_exec = time.monotonic()
            deployment = obs.current_deployment()
            expired = [b for b in batch
                       if b[4] is not None and b[4] <= t_exec]
            if expired:
                from ray_tpu_torch.exceptions import RequestExpiredError

                for _, fut, _, _, _ in expired:
                    if not fut.done():
                        fut.set_exception(RequestExpiredError(deployment))
                    obs.count_expired(deployment)
                batch = [b for b in batch if b[4] is None or b[4] > t_exec]
                if not batch:
                    continue
            items = [b[0] for b in batch]
            futs = [b[1] for b in batch]
            obs.observe_batch(deployment, len(batch), self.max_batch_size)
            for _, _, ctx, t_enq, _ in batch:
                # one serve.batch_wait per traced member: parked from its
                # submit until the batch fired, nested under that
                # request's serve.execute span
                if ctx is not None:
                    obs.emit_span(
                        "serve.batch_wait", "serve.batch_wait",
                        ctx[0], ctx[1], t_enq, t_exec,
                        deployment=deployment,
                        batch_size=len(batch),
                        max_batch_size=self.max_batch_size,
                    )
            if _payloads.has_payload_refs(items):
                # zero-copy payload plane: ALL members' spilled bodies
                # resolve through ONE shared bulk get — the reason
                # replica.handle_request defers resolution for batch
                # targets. Off the event loop: the fetch may block on a
                # remote agent and must not park unrelated queues.
                # (After the batch_wait spans: their window ends at
                # t_exec, so the fetch slice stays payload_fetch's.)
                t_fetch0 = time.monotonic()
                items, n_fetched, fetched_bytes = (
                    await asyncio.get_running_loop().run_in_executor(
                        None, _payloads.resolve_batch_items, items
                    )
                )
                t_fetch1 = time.monotonic()
                for _, _, ctx, _, _ in batch:
                    # charged per traced member: the batch shares the
                    # wall-clock window, not N copies of the bytes
                    if ctx is not None:
                        obs.emit_span(
                            "serve.payload_fetch", "serve.payload_fetch",
                            ctx[0], ctx[1], t_fetch0, t_fetch1,
                            deployment=deployment, n=n_fetched,
                            nbytes=fetched_bytes, shared=len(batch),
                        )
            try:
                results = await self.fn(items)
                if len(results) != len(items):
                    raise ValueError(
                        f"@serve.batch function returned {len(results)} results "
                        f"for a batch of {len(items)}"
                    )
                for f, r in zip(futs, results):
                    if not f.done():
                        f.set_result(r)
            except Exception as e:
                for f in futs:
                    if not f.done():
                        f.set_exception(e)


def batch(
    _fn: Optional[Callable] = None,
    *,
    max_batch_size: int = 10,
    batch_wait_timeout_s: float = 0.01,
):
    """Decorator: async def method(self, items: List[T]) -> List[R]
    becomes callable with a single item."""

    def wrap(fn):
        attr = f"__batch_queue_{fn.__name__}"

        @functools.wraps(fn)
        async def wrapper(self_or_item, *args):
            # methods: first arg is self; functions: first arg is the item
            if args:
                self, item = self_or_item, args[0]
                bound = functools.partial(fn, self)
                holder = self
            else:
                item = self_or_item
                bound = fn
                holder = wrapper
            q = getattr(holder, attr, None)
            if q is None:
                q = _BatchQueue(bound, max_batch_size, batch_wait_timeout_s)
                setattr(holder, attr, q)
            return await q.submit(item)

        wrapper._is_serve_batch = True
        return wrapper

    if _fn is not None:
        return wrap(_fn)
    return wrap
