"""Local testing mode: run a Serve app fully in-process, no cluster.

Parity: python/ray/serve/_private/local_testing_mode.py — the reference
instantiates each deployment's callable directly and wires handles to
plain method calls so unit tests run without any actors. Same here:
``serve.run(app, local_testing_mode=True)`` builds the bound graph
in-process; handles become `_LocalHandle`s whose responses resolve
synchronously (composition, multiplexing, streaming, and async methods
all work — just without processes or the controller).
"""

from __future__ import annotations

import asyncio
import inspect
from typing import Any, Dict


class _LocalResponse:
    """DeploymentResponse stand-in. Async results stay lazy: a pending
    coroutine is awaited by ``await resp`` (async callers) or run on a
    fresh loop by ``.result()`` (sync callers) — so local handles work
    from both worlds, like the real DeploymentHandle."""

    def __init__(self, value: Any = None, exc: BaseException = None, coro=None):
        self._value = value
        self._exc = exc
        self._coro = coro

    def _resolve_sync(self) -> None:
        if self._coro is None:
            return
        coro, self._coro = self._coro, None
        try:
            asyncio.get_running_loop()
        except RuntimeError:
            pass
        else:
            raise RuntimeError(
                "local handle .result() called inside a running event "
                "loop; use `await response` instead"
            )
        try:
            self._value = asyncio.run(coro)
        except BaseException as exc:
            self._exc = exc

    def result(self, timeout_s: float = None) -> Any:
        self._resolve_sync()
        if self._exc is not None:
            raise self._exc
        return self._value

    def _to_object_ref(self):
        return self.result()

    def __await__(self):
        async def _get():
            if self._coro is not None:
                coro, self._coro = self._coro, None
                try:
                    self._value = await coro
                except BaseException as exc:
                    self._exc = exc
            if self._exc is not None:
                raise self._exc
            return self._value

        return _get().__await__()


class _LocalResponseGenerator:
    """Streamed response: sync generators iterate directly; async
    generators drain on a fresh loop for sync callers and natively for
    async callers (the real replica supports both — replica.py
    handle_request_streaming)."""

    def __init__(self, gen=None, agen=None, coro=None):
        self._gen = gen
        self._agen = agen
        self._coro = coro  # plain async method under stream=True

    def __iter__(self):
        if self._coro is not None:
            coro, self._coro = self._coro, None
            yield asyncio.run(coro)
            return
        if self._agen is not None:
            async def _drain(agen=self._agen):
                return [item async for item in agen]

            yield from asyncio.run(_drain())
            return
        yield from self._gen

    async def __aiter__(self):
        if self._coro is not None:
            coro, self._coro = self._coro, None
            yield await coro
            return
        if self._agen is not None:
            async for item in self._agen:
                yield item
            return
        for item in self._gen:
            yield item


class _LocalHandle:
    """DeploymentHandle stand-in bound to one in-process instance."""

    def __init__(self, instance, method_name: str = "__call__"):
        self._instance = instance
        self._method = method_name
        self._stream = False
        self._model_id = ""

    def options(self, *, method_name=None, stream=None,
                multiplexed_model_id=None) -> "_LocalHandle":
        h = _LocalHandle(self._instance, method_name or self._method)
        h._stream = self._stream if stream is None else stream
        h._model_id = (
            self._model_id if multiplexed_model_id is None
            else multiplexed_model_id
        )
        return h

    def __getattr__(self, name: str):
        if name.startswith("_"):
            raise AttributeError(name)
        return _LocalMethodCaller(self, name)

    def remote(self, *args, **kwargs):
        return self._call(self._method, args, kwargs)

    def _call(self, method: str, args, kwargs):
        from ..multiplex import _model_id_ctx

        args = tuple(
            a.result() if isinstance(a, _LocalResponse) else a for a in args
        )
        kwargs = {
            k: (v.result() if isinstance(v, _LocalResponse) else v)
            for k, v in kwargs.items()
        }
        target = (
            self._instance
            if method == "__call__" and not inspect.isclass(self._instance)
            else getattr(self._instance, method)
        )
        token = _model_id_ctx.set(self._model_id)
        try:
            result = target(*args, **kwargs)
            if self._stream:
                if inspect.isasyncgen(result):
                    return _LocalResponseGenerator(agen=result)
                if inspect.isgenerator(result):
                    return _LocalResponseGenerator(gen=result)
                if inspect.iscoroutine(result):
                    # one-item stream, resolved lazily at iteration so
                    # errors surface at consumption and async callers
                    # can drive it on their own loop
                    return _LocalResponseGenerator(coro=result)
                return _LocalResponseGenerator(gen=iter([result]))
            if inspect.iscoroutine(result):
                # body runs later (at await/result): re-enter the model
                # id context around the actual execution
                async def _with_ctx(coro=result, mid=self._model_id):
                    tok = _model_id_ctx.set(mid)
                    try:
                        return await coro
                    finally:
                        _model_id_ctx.reset(tok)

                return _LocalResponse(coro=_with_ctx())
            return _LocalResponse(result)
        except BaseException as exc:  # surfaced on .result()
            return _LocalResponse(exc=exc)
        finally:
            _model_id_ctx.reset(token)


class _LocalMethodCaller:
    def __init__(self, handle: _LocalHandle, method: str):
        self._handle = handle
        self._method = method

    def remote(self, *args, **kwargs):
        return self._handle._call(self._method, args, kwargs)


def run_local(app) -> _LocalHandle:
    """Instantiate the bound graph in-process, depth-first, replacing
    nested Applications with local handles (composition parity)."""
    instances: Dict[str, Any] = {}

    def build(a) -> _LocalHandle:
        d = a.deployment
        if d.name not in instances:
            args = tuple(
                build(x) if _is_application(x) else x for x in a.args
            )
            kwargs = {
                k: (build(v) if _is_application(v) else v)
                for k, v in a.kwargs.items()
            }
            target = d.func_or_class
            if inspect.isclass(target):
                instance = target(*args, **kwargs)
            elif callable(target):
                instance = target  # function deployment
            else:
                raise TypeError(f"cannot deploy {target!r}")
            if d.user_config is not None and hasattr(instance, "reconfigure"):
                instance.reconfigure(d.user_config)
            instances[d.name] = instance
        return _LocalHandle(instances[d.name])

    return build(app)


def _is_application(x) -> bool:
    from .. import Application

    return isinstance(x, Application)
