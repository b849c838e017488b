"""Replica actor: hosts one copy of a deployment's user callable.

Parity: python/ray/serve/_private/replica.py — wraps the user class,
counts ongoing requests (the router's load signal), health checks,
graceful reconfigure.
"""

from __future__ import annotations

import asyncio
import inspect
import threading
import time
from typing import Any, Dict, Optional, Tuple

# serve-scope chaos engine (slow_replica execute-latency injection),
# built once per replica process; None-cached when the plan is inert
_chaos_engine = None
_chaos_ready = False


def _chaos():
    global _chaos_engine, _chaos_ready
    if not _chaos_ready:
        from ..._private import chaos as chaos_mod

        _chaos_engine = chaos_mod.engine_for("serve")
        _chaos_ready = True
    return _chaos_engine


class Replica:
    def __init__(
        self,
        deployment_name: str,
        serialized_cls,  # the user class (cloudpickled through task args)
        init_args: Tuple,
        init_kwargs: Dict[str, Any],
        user_config: Any = None,
    ):
        self.deployment_name = deployment_name
        self._ongoing = 0
        self._lock = threading.Lock()
        self._total = 0
        from . import observability as obs

        # lets @serve.batch queues and multiplex wrappers (which never
        # see the Replica) tag their metrics with this deployment
        obs.set_current_deployment(deployment_name)
        # profiler attribution: this worker process's samples read
        # worker:serve:<deployment> instead of bare "worker"
        from ..._private import profiling as _profiling

        _profiling.set_process_label(f"serve:{deployment_name}")
        cls = serialized_cls
        if callable(cls) and not inspect.isclass(cls):
            # function deployment: wrap into a callable object
            fn = cls

            class _FnWrapper:
                def __call__(self, *a, **k):
                    return fn(*a, **k)

            self.instance = _FnWrapper()
        else:
            self.instance = cls(*init_args, **init_kwargs)
        if user_config is not None and hasattr(self.instance, "reconfigure"):
            self.instance.reconfigure(user_config)

    # -- introspection (router load probes, controller health checks) --
    def queue_len(self) -> int:
        return self._ongoing

    def stats(self) -> Dict[str, Any]:
        from ..batching import queued_total
        from ..multiplex import registered_model_ids

        return {
            "ongoing": self._ongoing,
            "total": self._total,
            "queued": queued_total(),
            "multiplexed_model_ids": registered_model_ids(),
        }

    def check_health(self) -> bool:
        fn = getattr(self.instance, "check_health", None)
        if fn is not None:
            fn()
        return True

    def reconfigure(self, user_config: Any) -> None:
        if hasattr(self.instance, "reconfigure"):
            self.instance.reconfigure(user_config)

    # -- request path --------------------------------------------------
    def handle_request(
        self,
        method_name: str,
        args: Tuple,
        kwargs: Dict,
        multiplexed_model_id: str = "",
        request_meta: Optional[Dict[str, Any]] = None,
    ):
        from ...util import tracing as _tracing
        from ..multiplex import _model_id_ctx
        from . import observability as obs
        from . import payloads as _payloads

        with self._lock:
            self._ongoing += 1
            self._total += 1
        # deadline propagation: the router stamped deadline_wall into
        # request_meta; convert to THIS process's monotonic clock (same
        # host, anchored wall offset). An already-expired request is
        # dropped HERE — before payload resolution and before the user
        # callable burns replica time.
        deadline_mono: Optional[float] = None
        if request_meta and "deadline_wall" in request_meta:
            t_now = time.monotonic()
            deadline_mono = t_now + (
                request_meta["deadline_wall"] - _tracing.wall_at(t_now)
            )
            if deadline_mono <= t_now:
                with self._lock:
                    self._ongoing -= 1
                obs.count_expired(self.deployment_name)
                from ray_tpu_torch.exceptions import RequestExpiredError

                raise RequestExpiredError(self.deployment_name)
        # slow_replica chaos: injected execute latency, drawn from the
        # serve-scope rng in request-arrival order
        eng = _chaos()
        if eng is not None:
            d = eng.execute_delay(self.deployment_name)
            if d > 0.0:
                time.sleep(d)
        # traced request: the worker's _ExecTrace pushed (trace_id,
        # execute-span-id) as the ambient context before dispatching this
        # actor method. serve.queue_wait back-fills the handle-enqueue ->
        # here gap (start reconstructed from the enq_wall stamp the
        # router sent along); serve.execute wraps the user callable.
        ctx = _tracing.current_context()
        exec_sid = None
        if ctx is not None:
            t_in = time.monotonic()
            if request_meta and "enq_wall" in request_meta:
                obs.emit_span(
                    "serve.queue_wait", "serve.queue_wait", ctx[0], ctx[1],
                    obs.mono_at_wall(request_meta["enq_wall"], t_in), t_in,
                    deployment=self.deployment_name,
                )
            exec_sid = _tracing.new_span_id()
        from ..batching import _deadline_ctx

        token = _model_id_ctx.set(multiplexed_model_id)
        dl_token = _deadline_ctx.set(deadline_mono)
        trace_token = (
            _tracing.push_context((ctx[0], exec_sid)) if exec_sid else None
        )
        t0 = time.monotonic()
        try:
            target = (
                self.instance
                if method_name == "__call__"
                else getattr(self.instance, method_name)
            )
            # zero-copy payload plane: bulk-resolve PayloadRef markers
            # (and top-level ObjectRefs — composition args) in ONE get
            # before the user callable runs; raw bodies arrive as
            # memoryviews over the mapped segment. @serve.batch targets
            # defer to the batch queue so the whole batch shares one
            # fetch (batching._BatchQueue._loop).
            if not _payloads.is_batch_target(target):
                t_fetch0 = time.monotonic()
                args, kwargs, n_fetched, fetched_bytes = (
                    _payloads.resolve_args(args, kwargs)
                )
                if n_fetched and ctx is not None:
                    obs.emit_span(
                        "serve.payload_fetch", "serve.payload_fetch",
                        ctx[0], ctx[1], t_fetch0, time.monotonic(),
                        deployment=self.deployment_name,
                        n=n_fetched, nbytes=fetched_bytes,
                    )
            result = target(*args, **kwargs)
            if inspect.iscoroutine(result):
                # the coroutine executes on the replica loop THREAD —
                # re-enter the model-id (and trace) context there, the
                # caller thread's contextvars don't cross
                async def _with_ctx(coro=result):
                    tok = _model_id_ctx.set(multiplexed_model_id)
                    # the deadline rides to the loop thread too, so a
                    # @serve.batch submit parks it alongside the member
                    dtok = _deadline_ctx.set(deadline_mono)
                    ttok = (
                        _tracing.push_context((ctx[0], exec_sid))
                        if exec_sid
                        else None
                    )
                    try:
                        return await coro
                    finally:
                        if ttok is not None:
                            _tracing.pop_context(ttok)
                        _deadline_ctx.reset(dtok)
                        _model_id_ctx.reset(tok)

                result = _run_coro(_with_ctx())
            # oversized raw results ride back as shm segments instead
            # of pickling through the hub (payloads.wrap_result)
            return _payloads.wrap_result(result)
        finally:
            if trace_token is not None:
                _tracing.pop_context(trace_token)
            if exec_sid is not None:
                obs.emit_span(
                    "serve.execute", "serve.execute", ctx[0], ctx[1],
                    t0, time.monotonic(), span_id=exec_sid,
                    deployment=self.deployment_name, method=method_name,
                )
            _deadline_ctx.reset(dl_token)
            _model_id_ctx.reset(token)
            with self._lock:
                self._ongoing -= 1

    def handle_request_streaming(
        self,
        method_name: str,
        args: Tuple,
        kwargs: Dict,
        multiplexed_model_id: str = "",
    ):
        """Generator variant: invoked with num_returns="streaming" so
        each yielded chunk becomes an incremental stream object
        (reference: Serve streaming responses over ObjectRefGenerator)."""
        from ..multiplex import _model_id_ctx

        with self._lock:
            self._ongoing += 1
            self._total += 1
        # no reset token: the executor drives one task at a time, and
        # generator frames don't carry their own context anyway
        _model_id_ctx.set(multiplexed_model_id)
        try:
            target = (
                self.instance
                if method_name == "__call__"
                else getattr(self.instance, method_name)
            )
            result = target(*args, **kwargs)

            async def _with_ctx(coro):
                # async steps execute on the replica loop THREAD; re-enter
                # the model-id context there (mirror of handle_request)
                tok = _model_id_ctx.set(multiplexed_model_id)
                try:
                    return await coro
                finally:
                    _model_id_ctx.reset(tok)

            if inspect.isgenerator(result):
                yield from result
            elif inspect.isasyncgen(result):
                # drain the async generator on the replica's loop
                while True:
                    try:
                        yield _run_coro(_with_ctx(result.__anext__()))
                    except StopAsyncIteration:
                        break
            else:
                if inspect.iscoroutine(result):
                    result = _run_coro(_with_ctx(result))
                yield result
        finally:
            with self._lock:
                self._ongoing -= 1


_loop: Optional[asyncio.AbstractEventLoop] = None
_loop_lock = threading.Lock()


def _run_coro(coro):
    """Run a coroutine from sync context on a persistent loop (user
    callables may be async — e.g. @serve.batch methods)."""
    global _loop
    with _loop_lock:
        if _loop is None:
            _loop = asyncio.new_event_loop()
            t = threading.Thread(target=_loop.run_forever, daemon=True, name="replica-aio")
            t.start()
    fut = asyncio.run_coroutine_threadsafe(coro, _loop)
    return fut.result()
