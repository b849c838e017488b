"""Actors: stateful workers with ordered method-call semantics.

Parity: python/ray/actor.py in the reference (ActorClass :617,
ActorHandle :1287, ActorMethod :116). An actor pins a worker process for
its lifetime; calls are FIFO per-caller (ordered queue, reference:
src/ray/core_worker/transport/actor_task_submitter.h:78), optionally
concurrent via max_concurrency or asyncio for coroutine methods.
"""

from __future__ import annotations

import hashlib
from typing import Any, Dict, Optional

from ._private.ids import ActorID
from ._private.serialization import dumps_function
from .object_ref import ObjectRef
from .remote_function import (
    canonical_resources,
    encode_args,
    process_runtime_env,
    scheduling_options,
)


class ActorMethod:
    def __init__(self, handle: "ActorHandle", name: str, options: Optional[dict] = None):
        self._handle = handle
        self._name = name
        self._options = dict(options or {})

    def options(self, **opts) -> "ActorMethod":
        merged = dict(self._options)
        merged.update(opts)
        return ActorMethod(self._handle, self._name, merged)

    def remote(self, *args, **kwargs):
        from ._private import worker

        client = worker.get_client()
        args_kind, args_payload, deps, holds = encode_args(client, args, kwargs)
        # caller-supplied dependency pins (serve payload codec): ids of
        # objects referenced from INSIDE the args — e.g. payload markers
        # nested in handle_request's args tuple, which encode_args'
        # top-level scan can't see. Riding in arg_deps gets them the
        # same hub pin-while-in-flight protection spilled args have, so
        # a caller dropping its refs early can't free a payload the
        # replica hasn't fetched yet.
        extra_deps = self._options.get("_extra_arg_deps")
        if extra_deps:
            deps = deps + list(extra_deps)
        num_returns = self._options.get("num_returns", 1)
        options = scheduling_options(self._options)
        if num_returns == "streaming":
            from .object_ref import ObjectRefGenerator

            options["streaming"] = True
            if self._options.get("_generator_backpressure_num_objects"):
                options["_generator_backpressure_num_objects"] = self._options[
                    "_generator_backpressure_num_objects"
                ]
            task_id, _ = client.submit_actor_task(
                self._handle._actor_id,
                self._name,
                args_kind,
                args_payload,
                deps,
                0,
                options,
                return_task_id=True,
            )
            gen = ObjectRefGenerator(task_id)
            gen._hold = holds or None
            return gen
        return_ids = client.submit_actor_task(
            self._handle._actor_id,
            self._name,
            args_kind,
            args_payload,
            deps,
            num_returns,
            options,
        )
        refs = [ObjectRef(r, _owned=True) for r in return_ids]
        if holds:
            for r in refs:
                r._hold = holds
        return refs[0] if num_returns == 1 else refs

    def bind(self, *args, **kwargs):
        """Lazy DAG node (reference: ray.dag — actor.method.bind). The
        port has no ``dag/`` yet, so this raises until it does."""
        raise NotImplementedError(
            ".bind() needs ray_tpu_torch.dag, which is not ported yet "
            "(ROADMAP.md Queue A item 4)"
        )

    def __call__(self, *a, **k):
        raise TypeError(f"Actor method '{self._name}' must be called with .remote()")


class ActorHandle:
    def __init__(self, actor_id: ActorID, ready_ref: Optional[ObjectRef] = None):
        object.__setattr__(self, "_actor_id", actor_id)
        object.__setattr__(self, "_ready_ref", ready_ref)

    def __getattr__(self, name: str) -> ActorMethod:
        if name.startswith("__") and name.endswith("__") and name != "__ray_call__":
            raise AttributeError(name)
        return ActorMethod(self, name)

    def __ray_ready__(self) -> ObjectRef:
        return ActorMethod(self, "__ray_ready__").remote()

    def __repr__(self):
        return f"ActorHandle({self._actor_id.hex()})"

    def __hash__(self):
        return hash(self._actor_id)

    def __eq__(self, other):
        return isinstance(other, ActorHandle) and other._actor_id == self._actor_id

    def __reduce__(self):
        return (_rebuild_handle, (self._actor_id.binary(),))


def _rebuild_handle(actor_id_bytes: bytes) -> ActorHandle:
    return ActorHandle(ActorID(actor_id_bytes))


class ActorClass:
    def __init__(self, cls, options: Optional[Dict[str, Any]] = None):
        self._cls = cls
        self._options = dict(options or {})
        self._blob = None
        self._fn_id: Optional[str] = None
        self.__name__ = getattr(cls, "__name__", "Actor")
        self.__doc__ = getattr(cls, "__doc__", None)

    def options(self, **opts) -> "ActorClass":
        merged = dict(self._options)
        merged.update(opts)
        ac = ActorClass(self._cls, merged)
        ac._blob = self._blob
        ac._fn_id = self._fn_id
        return ac

    def _ensure_exported(self, client) -> str:
        if self._blob is None:
            self._blob = dumps_function(self._cls)
            digest = hashlib.sha1(self._blob).hexdigest()[:16]
            self._fn_id = f"{self.__name__}:{digest}"
        client.register_function(self._fn_id, self._blob)
        return self._fn_id

    def remote(self, *args, **kwargs) -> ActorHandle:
        from ._private import worker

        client = worker.get_client()
        opts = self._options
        fn_id = self._ensure_exported(client)
        args_kind, args_payload, deps, holds = encode_args(client, args, kwargs)
        resources = canonical_resources(opts, is_actor=True)
        options = scheduling_options(opts)
        process_runtime_env(client, opts, options)
        options["max_restarts"] = opts.get("max_restarts", 0)
        options["max_concurrency"] = opts.get("max_concurrency", 1)
        if opts.get("name"):
            options["name"] = opts["name"]
            options["namespace"] = opts.get("namespace")
        options["lifetime"] = opts.get("lifetime")
        actor_id, ready_id = client.create_actor(
            fn_id, args_kind, args_payload, deps, resources, options
        )
        ready_ref = ObjectRef(ready_id)
        # spilled creation args are hub-pinned for the actor's lifetime;
        # the twins on the ready ref let ownership GC reclaim them once
        # both the handle's ready ref is gone and the actor is dead
        ready_ref._hold = holds or None
        return ActorHandle(ActorID(actor_id.binary()), ready_ref)

    def __call__(self, *a, **k):
        raise TypeError(
            f"Actor class '{self.__name__}' cannot be instantiated directly; "
            f"use '{self.__name__}.remote()'."
        )
