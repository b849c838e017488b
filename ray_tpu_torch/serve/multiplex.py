"""Model multiplexing: many models per deployment, LRU-cached per replica.

Parity: python/ray/serve/multiplex.py (`_ModelMultiplexWrapper`) +
api.py ``@serve.multiplexed`` / ``serve.get_multiplexed_model_id``.
The reference's replicas push their loaded-model-id set to the
controller, and routers prefer replicas already holding the requested
model. Here the model-id set rides the controller's existing batched
health-check ping (``Replica.stats``), and the handle's power-of-two
router restricts its candidate set to model-holding replicas when
``handle.options(multiplexed_model_id=...)`` is used.
"""

from __future__ import annotations

import asyncio
import contextvars
import functools
import inspect
import threading
from collections import OrderedDict
from typing import Any, Callable, List, Optional

_model_id_ctx: contextvars.ContextVar[str] = contextvars.ContextVar(
    "serve_multiplexed_model_id", default=""
)

# All wrappers live in the replica's worker process; the replica reports
# the union of their loaded ids through stats().
_registry_lock = threading.Lock()
_wrappers: List["_ModelMultiplexWrapper"] = []


def get_multiplexed_model_id() -> str:
    """Inside a request: the model id the caller routed with."""
    return _model_id_ctx.get()


def registered_model_ids() -> List[str]:
    with _registry_lock:
        wrappers = list(_wrappers)
    ids: List[str] = []
    for w in wrappers:
        ids.extend(w.model_ids())
    return ids


class _FnReporter:
    def __init__(self, fn):
        self._fn = fn

    def model_ids(self) -> List[str]:
        return list(self._fn())


def register_model_reporter(fn) -> Any:
    """Public hook for components with their own model caches (e.g. the
    LLM server's LoRA engines): ``fn() -> list[str]`` of loaded ids.
    Returns a handle for unregister_model_reporter."""
    reporter = _FnReporter(fn)
    with _registry_lock:
        _wrappers.append(reporter)
    return reporter


def unregister_model_reporter(handle) -> None:
    with _registry_lock:
        try:
            _wrappers.remove(handle)
        except ValueError:
            pass


class _ModelMultiplexWrapper:
    """Per-replica LRU of loaded models keyed by model id."""

    def __init__(self, load_fn: Callable, max_num_models: int):
        self._load_fn = load_fn
        self._max = max_num_models
        self._models: "OrderedDict[str, Any]" = OrderedDict()
        self._lock = threading.Lock()
        with _registry_lock:
            _wrappers.append(self)

    def model_ids(self) -> List[str]:
        with self._lock:
            return list(self._models)

    def load_model(self, owner, model_id: str) -> Any:
        if not model_id:
            raise ValueError(
                "multiplexed call without a model id — route with "
                "handle.options(multiplexed_model_id=...)"
            )
        with self._lock:
            if model_id in self._models:
                self._models.move_to_end(model_id)
                return self._models[model_id]
        # Load outside the lock (loads can be slow); last-write-wins on
        # a racing duplicate load of the same id.
        import time

        from ..util import tracing as _tracing
        from ._private import observability as obs

        ctx = _tracing.current_context()
        t0 = time.monotonic()
        model = self._load_fn(owner, model_id)
        if inspect.iscoroutine(model):
            model = _run_sync(model)
        # an LRU miss is the multiplexing cost: surface it as a span on
        # the traced request that paid it, and as a swap counter
        obs.count_model_swap(obs.current_deployment())
        if ctx is not None:
            obs.emit_span(
                "serve.multiplex_swap", "serve.multiplex_swap",
                ctx[0], ctx[1], t0, time.monotonic(),
                deployment=obs.current_deployment(), model_id=model_id,
            )
        with self._lock:
            self._models[model_id] = model
            self._models.move_to_end(model_id)
            while len(self._models) > self._max:
                evicted_id, evicted = self._models.popitem(last=False)
                del evicted  # drop our ref; __del__ frees TPU buffers
        return model


def _run_sync(coro):
    try:
        asyncio.get_running_loop()
    except RuntimeError:
        return asyncio.run(coro)
    # Called from inside an async replica: the caller should have
    # awaited; run in a fresh loop on a helper thread.
    out: dict = {}

    def _runner():
        out["v"] = asyncio.run(coro)

    t = threading.Thread(target=_runner)
    t.start()
    t.join()
    return out["v"]


def multiplexed(
    func: Optional[Callable] = None, *, max_num_models_per_replica: int = 3
):
    """Decorator for the model-loading method of a deployment.

    class Translator:
        @serve.multiplexed(max_num_models_per_replica=2)
        def get_model(self, model_id: str):
            return load(model_id)

        def __call__(self, text):
            model = self.get_model(serve.get_multiplexed_model_id())
            ...
    """

    def _wrap(fn: Callable):
        wrapper_holder: dict = {}

        @functools.wraps(fn)
        def wrapped(self, model_id: Optional[str] = None):
            mux = wrapper_holder.get("w")
            if mux is None:
                mux = _ModelMultiplexWrapper(fn, max_num_models_per_replica)
                wrapper_holder["w"] = mux
            return mux.load_model(self, model_id or get_multiplexed_model_id())

        wrapped.__serve_multiplexed__ = True
        return wrapped

    if func is not None:
        return _wrap(func)
    return _wrap
