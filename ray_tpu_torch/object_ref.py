"""ObjectRef: a future for a value in the distributed object store.

Parity: python/ray/includes/object_ref.pxi / ray.ObjectRef in the
reference. Refs are cheap value objects (an id); they re-bind to the
current process's core client when unpickled, so they can flow through
task args, actor calls, and nested data structures.
"""

from __future__ import annotations

import threading
from concurrent.futures import Future
from typing import Any, Optional

from ._private.ids import ObjectID


class ObjectRef:
    __slots__ = ("_id", "_bin", "_owned", "_shared", "_hold", "__weakref__")

    def __init__(self, object_id: ObjectID, *, _owned: bool = False):
        self._id = object_id
        # raw id bytes, cached at construction: wait() pop-loops rebuild
        # the id list of ~n refs per call (O(n^2) per drain), so the
        # per-ref cost there must be one slot load, not an attr+method
        # chain (single_client_wait_1k_refs)
        self._bin = object_id.binary()
        # strong refs this ref keeps alive: owned twins of args the
        # submitter spilled to the object store — when the caller drops
        # its last return ref, the twins die and ownership GC frees the
        # spilled args (the hub defers while the task is in flight)
        self._hold = None
        # Ownership GC (simplified form of the reference's
        # ReferenceCounter, reference_count.h:43): a ref created by this
        # process's own put()/task submission is "owned"; when the LAST
        # local handle to an owned, never-pickled ref dies, the hub
        # frees the object. Pickling makes borrowers possible, so a
        # shared ref is never auto-freed (it leaks like pre-GC — the
        # conservative direction).
        self._owned = _owned
        self._shared = False

    def binary(self) -> bytes:
        return self._bin

    def hex(self) -> str:
        return self._id.hex()

    def __hash__(self):
        return hash(self._id)

    def __eq__(self, other):
        return isinstance(other, ObjectRef) and other._id == self._id

    def __repr__(self):
        return f"ObjectRef({self._id.hex()})"

    def __reduce__(self):
        self._shared = True  # a copy may now exist anywhere: never auto-free
        return (_rebuild_ref, (self._id.binary(),))

    def __del__(self):
        if not getattr(self, "_owned", False) or getattr(self, "_shared", True):
            return
        try:
            from ._private import worker

            client = worker._client
            if client is not None and not client._closed:
                client.release_owned(self._bin)
        except Exception:
            pass  # interpreter teardown / connection already gone

    # -- convenience -----------------------------------------------------
    def get(self, timeout: Optional[float] = None) -> Any:
        from ._private import worker

        return worker.get(self, timeout=timeout)

    def future(self) -> Future:
        """A concurrent.futures.Future resolving to the object's value."""
        fut: Future = Future()

        def run():
            try:
                fut.set_result(self.get())
            except Exception as e:  # noqa: BLE001
                fut.set_exception(e)

        threading.Thread(target=run, daemon=True).start()
        return fut

    def __await__(self):
        """Support `await ref` inside async actors."""
        import asyncio

        return asyncio.wrap_future(self.future()).__await__()


def _rebuild_ref(id_bytes: bytes) -> ObjectRef:
    return ObjectRef(ObjectID(id_bytes))


class ObjectRefGenerator:
    """Incrementally-resolved refs from a `num_returns="streaming"` task.

    Parity: the reference's ObjectRefGenerator (_raylet.pyx:280) — sync
    and async iteration over ObjectRefs as the remote generator yields;
    a mid-stream exception surfaces as a final ref whose get() raises.
    """

    def __init__(self, task_id: bytes):
        self._task_id = task_id
        self._idx = 0

    def __iter__(self):
        return self

    def __next__(self) -> ObjectRef:
        from ._private import protocol as P
        from ._private import worker

        client = worker.get_client()
        reply = client.request(
            P.STREAM_NEXT, {"task_id": self._task_id, "index": self._idx}
        )
        if reply.get("end"):
            raise StopIteration
        self._idx += 1
        return ObjectRef(ObjectID(reply["object_id"]))

    def __aiter__(self):
        return self

    async def __anext__(self) -> ObjectRef:
        import asyncio

        def step():
            try:
                return self.__next__()
            except StopIteration:
                return None

        ref = await asyncio.to_thread(step)
        if ref is None:
            raise StopAsyncIteration
        return ref

    def __reduce__(self):
        return (ObjectRefGenerator, (self._task_id,))
