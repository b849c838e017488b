"""Zero-copy serve payload plane: large bodies ride the object plane.

The serve hot path used to pickle every request/response inline through
the hub: the handle shipped args as VAL_INLINE actor-call blobs and
results came back the same way, so a 1 MiB body paid multiple pickle
copies plus two rides through the hub reactor. This codec tiers the
transport by size ("The Big Send-off" argument): bodies at or below
RAY_TPU_TORCH_SERVE_INLINE_MAX (config "serve_inline_max", default 64 KiB)
keep the inline path — one hub round-trip beats a put + resolve for
small payloads — while anything STRICTLY larger spills onto the
direct object plane:

- Request side (handle.DeploymentHandle._route): oversized bytes /
  bytearray / memoryview / ndarray / CPU torch tensor values — top-level args/kwargs and
  one level inside dict args, which covers the ingress request dict's
  "body" — are put via the object plane (serialization.RawPayload makes
  the bytes ride out-of-band: ONE memcpy into shm, never a pickle
  stream) and replaced by PayloadRef markers. The spilled ids ride the
  actor call's arg_deps (the hub pins them while the call is in
  flight), and the owned twin refs live on the DeploymentResponse so
  ownership GC frees the segment when the caller drops the response.
- Replica side (replica.Replica.handle_request): markers and top-level
  ObjectRefs (composition args) resolve in ONE bulk client.get before
  the user callable runs; raw payloads arrive as zero-copy memoryviews
  over the mapped segment. @serve.batch targets defer resolution to the
  batch queue so ALL members of a batch share one fetch
  (batching._BatchQueue._loop).
- Response side: results larger than the threshold return wrapped in
  RawPayload, so the ordinary task-return path stores them as shm
  segments. DeploymentResponse.result() fetches with
  client.get(oneshot=True): local segments map zero-copy; remote ones
  pull straight from the owner's object agent
  (object_agent.pull_segment_bytes + object_store.decode_segment_bytes)
  without the full CoreClient install/replica/ref-count dance; any
  transfer error falls back to the standard fetch matrix, ending in the
  hub relay (chaos-safe: a mid-transfer agent death degrades to the
  relay, never fails the request).

Spans: the handle emits serve.payload_put around the spill and the
replica/batch loop emits serve.payload_fetch around the bulk resolve;
both stages are in tracing.STAGE_PRECEDENCE so analyze_trace partitions
stay exact.
"""

from __future__ import annotations

import sys
from typing import Any, Dict, List, Tuple

from ..._private.serialization import RawPayload, materialize_raw
from ...object_ref import ObjectRef

# bulk fetches issued by THIS process — one per resolve call that hit
# the wire, NOT one per payload. Tests assert a batch of N spilled
# requests bumps this once (the members-share-one-fetch contract).
FETCH_CALLS = 0


def inline_max() -> int:
    """Current spill threshold in bytes (values <= 0 disable spilling).
    Read through the config module attribute so a hub-triggered
    config.reload() (fresh env overrides) is observed."""
    from ..._private import config as _config

    try:
        return int(_config.RAY_TPU_TORCH_CONFIG.get("serve_inline_max", 64 * 1024))
    except (TypeError, ValueError):
        return 64 * 1024


class PayloadRef:
    """Marker standing in for one spilled payload inside a routed
    call's args: carries the object id (for the replica's bulk resolve
    and the dispatch's arg_deps pin) and the byte size (for spans).
    Pickles by reference — this module is importable in every
    process."""

    __slots__ = ("oid_bytes", "nbytes")

    def __init__(self, oid_bytes: bytes, nbytes: int):
        self.oid_bytes = oid_bytes
        self.nbytes = nbytes

    def __reduce__(self):
        return (PayloadRef, (self.oid_bytes, self.nbytes))

    def __repr__(self):
        return f"PayloadRef({self.oid_bytes.hex()}, {self.nbytes}B)"


def _numpy():
    try:
        import numpy as np

        return np
    except Exception:
        return None


def _cpu_tensor(v: Any) -> bool:
    """True for a strided CPU torch tensor, the counterpart of a
    non-object ndarray. Torch is looked up, never imported: a process
    that holds a tensor has it loaded already."""
    torch = sys.modules.get("torch")
    return (torch is not None and isinstance(v, torch.Tensor)
            and v.layout == torch.strided and v.device.type == "cpu")


def _payload_size(v: Any) -> int:
    """Spillable size of v, or -1 when v is not a raw payload."""
    if isinstance(v, (bytes, bytearray)):
        return len(v)
    if isinstance(v, memoryview):
        return v.nbytes
    np = _numpy()
    if np is not None and isinstance(v, np.ndarray) and v.dtype != object:
        return int(v.nbytes)
    if _cpu_tensor(v):
        return v.numel() * v.element_size()
    return -1


# ---------------------------------------------------------------- spill
def spill_args(
    args: tuple, kwargs: dict
) -> Tuple[tuple, dict, List[ObjectRef], List[bytes], int]:
    """Replace oversized raw payloads with PayloadRef markers, putting
    the bytes via the object plane. Returns (args, kwargs, holds,
    dep_ids, spilled_bytes):

    - holds: OWNED twin refs for fresh spills — the caller parks them
      on the DeploymentResponse so ownership GC frees the segments when
      the response is dropped (retry re-sends keep working meanwhile).
    - dep_ids: EVERY payload id in the call — fresh spills and
      pre-existing markers (a _reroute re-send) — for the dispatch's
      arg_deps, which the hub pins while the call is in flight.
    """
    limit = inline_max()
    holds: List[ObjectRef] = []
    dep_ids: List[bytes] = []
    spilled = [0]
    client_box: List[Any] = []

    def spill_one(v: Any, n: int) -> Any:
        if not client_box:
            from ..._private import worker

            client_box.append(worker._client)
        client = client_box[0]
        if client is None:
            return v  # no runtime: leave inline (e.g. bare unit tests)
        np = _numpy()
        if np is not None and isinstance(v, np.ndarray):
            # arrays keep dtype/shape: put the array itself — protocol-5
            # out-of-band pickling already makes the data zero-copy;
            # force_shm keeps the 64-100 KiB window off the inline path
            obj = v if v.flags["C_CONTIGUOUS"] else np.ascontiguousarray(v)
            oid = client.put_value(obj, force_shm=True, cache=False)
        elif _cpu_tensor(v):
            # a CPU tensor likewise: the runtime's tensor reducer sends
            # its bytes out of band and rebuilds dtype and shape
            obj = v if v.is_contiguous() else v.contiguous()
            oid = client.put_value(obj, force_shm=True, cache=False)
        else:
            oid = client.put_value(RawPayload(v), cache=False)
        holds.append(ObjectRef(oid, _owned=True))
        dep_ids.append(oid.binary())
        spilled[0] += n
        return PayloadRef(oid.binary(), n)

    def maybe_spill(v: Any) -> Any:
        if isinstance(v, PayloadRef):
            dep_ids.append(v.oid_bytes)  # retry re-send: re-pin only
            return v
        if limit > 0:
            n = _payload_size(v)
            if n > limit:
                return spill_one(v, n)
        return v

    def walk(v: Any) -> Any:
        v2 = maybe_spill(v)
        if v2 is not v:
            return v2
        if type(v) is dict:
            # one level into plain dicts: the ingress request dict
            # carries its body under "body"
            out = None
            for k, item in v.items():
                item2 = maybe_spill(item)
                if item2 is not item:
                    if out is None:
                        out = dict(v)
                    out[k] = item2
            return v if out is None else out
        return v

    args = tuple(walk(a) for a in args)
    kwargs = {k: walk(v) for k, v in kwargs.items()}
    return args, kwargs, holds, dep_ids, spilled[0]


# -------------------------------------------------------------- resolve
def _scan_value(v: Any, want: Dict[bytes, int]) -> bool:
    """Record every payload/ref id reachable from v (top level + one
    dict level); True when v needs a substitution pass."""
    if isinstance(v, PayloadRef):
        want[v.oid_bytes] = v.nbytes
        return True
    if isinstance(v, ObjectRef):
        want.setdefault(v._id.binary(), 0)
        return True
    if type(v) is dict:
        hit = False
        for item in v.values():
            if isinstance(item, PayloadRef):
                want[item.oid_bytes] = item.nbytes
                hit = True
            elif isinstance(item, ObjectRef):
                want.setdefault(item._id.binary(), 0)
                hit = True
        return hit
    return False


def _sub_value(v: Any, got: Dict[bytes, Any]) -> Any:
    if isinstance(v, PayloadRef):
        return materialize_raw(got[v.oid_bytes])
    if isinstance(v, ObjectRef):
        return got[v._id.binary()]
    if type(v) is dict:
        out = dict(v)
        for k, item in v.items():
            if isinstance(item, PayloadRef):
                out[k] = materialize_raw(got[item.oid_bytes])
            elif isinstance(item, ObjectRef):
                out[k] = got[item._id.binary()]
        return out
    return v


def _bulk_fetch(want: Dict[bytes, int]) -> Dict[bytes, Any]:
    global FETCH_CALLS
    from ..._private import worker
    from ..._private.ids import ObjectID

    client = worker.get_client()
    FETCH_CALLS += 1
    got: Dict[bytes, Any] = {}
    remote: List[bytes] = []
    store = getattr(client, "store", None)
    for b, nbytes in want.items():
        # Payload ids (nbytes > 0) are arg-deps-gated: the hub admitted
        # this task only after every payload was READY, so a same-node
        # segment is fully written — map it straight off the store and
        # skip the hub GET round trip. Composition ObjectRefs
        # (nbytes == 0) get no such guarantee (their producer may still
        # be writing the segment file), so they always go through get().
        if nbytes > 0 and store is not None:
            try:
                name = b.hex()
                if store.contains(name):
                    got[b] = store.get(name)
                    continue
            except Exception:
                pass
        remote.append(b)
    if remote:
        values = client.get([ObjectID(b) for b in remote], oneshot=True)
        got.update(zip(remote, values))
    return got


def resolve_args(args: tuple, kwargs: dict) -> Tuple[tuple, dict, int, int]:
    """Replica-side: substitute every PayloadRef (zero-copy memoryview)
    and top-level ObjectRef (composition arg) through ONE bulk get.
    Returns (args, kwargs, n_fetched, payload_bytes)."""
    want: Dict[bytes, int] = {}
    arg_hits = [_scan_value(a, want) for a in args]
    kw_hits = {k: _scan_value(v, want) for k, v in kwargs.items()}
    if not want:
        return args, kwargs, 0, 0
    got = _bulk_fetch(want)
    args = tuple(
        _sub_value(a, got) if hit else a for a, hit in zip(args, arg_hits)
    )
    kwargs = {
        k: (_sub_value(v, got) if kw_hits[k] else v) for k, v in kwargs.items()
    }
    return args, kwargs, len(want), sum(want.values())


def has_payload_refs(items: List[Any]) -> bool:
    """Cheap probe: does any batch member carry a marker/ref?"""
    for v in items:
        if isinstance(v, (PayloadRef, ObjectRef)):
            return True
        if type(v) is dict and any(
            isinstance(i, (PayloadRef, ObjectRef)) for i in v.values()
        ):
            return True
    return False


def resolve_batch_items(items: List[Any]) -> Tuple[List[Any], int, int]:
    """Batch-queue variant of resolve_args: EVERY member's payloads
    resolve through one shared fetch — N batched 1 MiB requests cost
    one get round-trip, not N."""
    want: Dict[bytes, int] = {}
    hits = [_scan_value(it, want) for it in items]
    if not want:
        return items, 0, 0
    got = _bulk_fetch(want)
    items = [
        _sub_value(it, got) if hit else it for it, hit in zip(items, hits)
    ]
    return items, len(want), sum(want.values())


def is_batch_target(target: Any) -> bool:
    """@serve.batch callables defer marker resolution to the batch
    queue (one shared fetch per batch, not one per member)."""
    if getattr(target, "_is_serve_batch", False):
        return True
    call = getattr(target, "__call__", None)
    return bool(getattr(call, "_is_serve_batch", False))


# ------------------------------------------------------------- response
def wrap_result(result: Any) -> Any:
    """Replica-side: wrap an oversized raw result so the task-return
    path stores it as a shm segment (encode_value never inlines a
    RawPayload) instead of pickling it back through the hub.
    memoryviews ALWAYS convert — they don't pickle: big ones wrap
    zero-copy, small ones collapse to bytes. ndarray results already
    ride out-of-band via the normal return path and stay untouched."""
    limit = inline_max()
    if isinstance(result, memoryview):
        if limit > 0 and result.nbytes > limit:
            return RawPayload(result)
        return bytes(result)
    if limit <= 0:
        return result
    if isinstance(result, (bytes, bytearray)) and len(result) > limit:
        return RawPayload(result)
    from ..response import Response as ServeResponse

    if isinstance(result, ServeResponse):
        body = result.body
        nbytes = (
            body.nbytes
            if isinstance(body, memoryview)
            else len(body) if isinstance(body, (bytes, bytearray)) else -1
        )
        new_body = None
        if nbytes > limit:
            new_body = RawPayload(body)
        elif isinstance(body, memoryview):
            new_body = bytes(body)
        if new_body is not None:
            import copy

            result = copy.copy(result)
            result.body = new_body
    return result


def unwrap_result(value: Any) -> Any:
    """Consumer-side (DeploymentResponse / proxy): collapse the
    RawPayload shapes to memoryviews. Large bodies STAY memoryviews —
    that is the zero-copy contract; callers needing bytes copy
    explicitly (serve.Response.body_bytes does)."""
    value = materialize_raw(value)
    from ..response import Response as ServeResponse

    if isinstance(value, ServeResponse):
        body = materialize_raw(value.body)
        if body is not value.body:
            value.body = body
    return value
