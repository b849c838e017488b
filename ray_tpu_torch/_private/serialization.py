"""Serialization for task args, results, and functions.

Mirrors the split the reference makes (reference:
python/ray/_private/serialization.py:122 SerializationContext):

- *functions/closures* go through cloudpickle (pickle-by-value), exported
  once per function and cached by the receiving worker (reference:
  python/ray/_private/function_manager.py:58).
- *data* goes through cloudpickle at protocol 5 with out-of-band buffers
  so numpy/jax arrays are not copied into the pickle stream. cloudpickle
  (not stdlib pickle) everywhere: importable objects serialize by
  reference at plain-pickle speed, while __main__-level functions and
  closures — which stdlib pickle would emit by reference and the worker
  could never import — serialize by value.

The wire format is a (header_bytes, [buffer, ...]) pair; buffers can be
placed into shared memory by the object store for zero-copy cross-process
transfer.

Frame codec (hub<->client<->agent framing, PR 2): every wire frame
carries a one-byte marker prefix —

- ``b"P"`` — stdlib pickle. The fast path: control frames are
  (msg_type, payload-dict) pairs of primitives/bytes, and stdlib
  pickle's C implementation serializes those ~2x faster than a
  CloudPickler round. Used by :func:`dumps_frame`.
- ``b"C"`` — cloudpickle. Used for anything that may capture user
  objects (:func:`dumps_inline` payload blobs, :func:`dumps_oob`
  headers), and as the automatic fallback when stdlib pickle raises
  on a frame (e.g. a ``__main__``-level lambda smuggled into a
  payload).

Both markers decode with ``pickle.loads`` (cloudpickle output IS
pickle bytecode); the split exists so the dump side can pick the cheap
encoder per frame. The ``__main__`` by-reference trap stays
impossible: arbitrary user values never ride a frame raw — task args
travel as ``dumps_inline`` blobs (remote_function.encode_args), values
as ``dumps_oob`` headers, functions as ``dumps_function`` blobs, and
pubsub data as ``dumps_inline`` blobs (client.publish) — all
cloudpickle-encoded *before* framing.

Torch tensors (the port's addition): ``dumps_oob`` and ``dumps_inline``
pickle with :class:`_Pickler`, whose ``reducer_override`` takes every
strided ``torch.Tensor`` (and ``nn.Parameter``) before torch's own
reducer, which would copy the storage into the pickle stream and revive
a CUDA tensor on whatever card the loader calls ``cuda``:

- a CPU tensor travels as one out-of-band buffer of its raw bytes (a
  uint8 view, so bf16, which has no numpy dtype, comes back as bf16)
  with its dtype, shape and ``requires_grad``; a non-contiguous tensor
  is made contiguous once, and the loader copies the bytes into a new
  tensor, so no tensor aliases a shared-memory segment it could write;
- a CUDA tensor is staged to the host to be stored and comes back on the
  loader's current CUDA device (``cuda:0`` under its own
  ``CUDA_VISIBLE_DEVICES``). A loader that sees no GPU raises and names
  the tensor's device; it never hands back a CPU tensor in its place.

Torch is imported only by a process that already holds a tensor: the
override looks it up in ``sys.modules``.
"""

from __future__ import annotations

import io
import os
import pickle
import pickletools
import sys
import warnings
from typing import Any, Dict, List, Optional, Sequence, Tuple

import cloudpickle

PICKLE5 = 5

# frame markers (see module docstring)
MARKER_PLAIN = b"P"
MARKER_CLOUD = b"C"
_KNOWN_MARKERS = (ord("P"), ord("C"))


def _torch():
    import torch

    return torch


def _tensor_payload(t) -> tuple:
    """(raw bytes as a PickleBuffer, dtype name, shape, requires_grad,
    is_parameter) of a tensor; a CUDA tensor is copied to the host."""
    torch = _torch()
    flat = t.detach().cpu().contiguous().reshape(-1)
    return (
        pickle.PickleBuffer(flat.view(torch.uint8).numpy()),
        str(t.dtype).rsplit(".", 1)[-1],
        tuple(t.shape),
        bool(t.requires_grad),
        type(t) is torch.nn.Parameter,
    )


def _rebuild_tensor(buf, dtype: str, shape: tuple, requires_grad: bool,
                    parameter: bool, device=None):
    torch = _torch()
    view = (buf.raw() if isinstance(buf, pickle.PickleBuffer) else memoryview(buf)).cast("B")
    out = torch.empty(view.nbytes, dtype=torch.uint8)
    if view.nbytes:
        with warnings.catch_warnings():
            # a mapped segment is read-only; it is only read here, by
            # torch's parallel copy (which spreads the page faults of a
            # large fresh tensor over its threads)
            warnings.simplefilter("ignore", UserWarning)
            out.copy_(torch.frombuffer(view, dtype=torch.uint8))
    out = out.view(getattr(torch, dtype)).reshape(shape)
    if device is not None:
        out = out.to(device)
    if parameter:
        return torch.nn.Parameter(out, requires_grad=requires_grad)
    return out.requires_grad_() if requires_grad else out


def _rebuild_cuda_tensor(payload: tuple, src_device: str):
    torch = _torch()
    if not torch.cuda.is_available():
        raise RuntimeError(
            f"this object holds a CUDA tensor (stored from {src_device}) and this "
            "process sees no GPU (CUDA_VISIBLE_DEVICES="
            f"{os.environ.get('CUDA_VISIBLE_DEVICES')!r}); ask for num_gpus to "
            "get it on a card"
        )
    return _rebuild_tensor(
        *payload, device=torch.device("cuda", torch.cuda.current_device())
    )


def _on_cuda(t) -> bool:
    return t.device.type == "cuda"


def _reduce_tensor(t):
    if _on_cuda(t):
        return _rebuild_cuda_tensor, (_tensor_payload(t), str(t.device))
    return _rebuild_tensor, _tensor_payload(t)


class _Pickler(cloudpickle.CloudPickler):
    """cloudpickle with the tensor reducer (module docstring)."""

    def reducer_override(self, obj):
        torch = sys.modules.get("torch")
        if (
            torch is not None
            and type(obj) in (torch.Tensor, torch.nn.Parameter)
            and obj.layout == torch.strided
            and obj.device.type in ("cpu", "cuda")
        ):
            return _reduce_tensor(obj)
        return super().reducer_override(obj)


def _dumps(obj: Any, buffer_callback=None) -> bytes:
    with io.BytesIO() as f:
        _Pickler(f, protocol=PICKLE5, buffer_callback=buffer_callback).dump(obj)
        return f.getvalue()


def dumps_oob(obj: Any) -> Tuple[bytes, List[pickle.PickleBuffer]]:
    """Serialize with out-of-band buffers. Returns (header, buffers).

    Always cloudpickle: plain pickle would serialize ``__main__``-level
    functions BY REFERENCE (module+qualname) — succeeding here and
    failing only at load time inside the worker, where ``__main__`` is
    the worker binary. cloudpickle pickles importable objects by
    reference (plain-pickle speed) and main/closure objects by value.
    """
    buffers: List[pickle.PickleBuffer] = []
    header = _dumps(obj, buffer_callback=buffers.append)
    return b"C" + header, buffers


def loads_oob(header: bytes, buffers: List[Any]) -> Any:
    return pickle.loads(header[1:], buffers=buffers)


class RawPayload:
    """Zero-copy carrier for one large raw buffer (bytes / bytearray /
    memoryview).

    Pickling emits the buffer OUT-OF-BAND (``pickle.PickleBuffer``), so
    a ``dumps_oob`` round produces a ~100-byte header plus the untouched
    buffer: ``put_raw`` memcpys it into the segment once, and a reader's
    ``loads_oob`` reconstructs a memoryview directly over the mapped
    bytes — the body is never copied into a pickle stream on either
    side. Plain ``bytes`` lack this property (no buffer-callback
    support in-band), which is why the serve payload codec
    (serve/_private/payloads.py) wraps them here before ``put_value``.
    The unpickled form IS the memoryview, not a RawPayload — consumers
    normalize with :func:`materialize_raw`.
    """

    __slots__ = ("view",)

    def __init__(self, data):
        view = data if isinstance(data, memoryview) else memoryview(data)
        if view.format != "B" or view.ndim != 1:
            view = view.cast("B")
        self.view = view

    @property
    def nbytes(self) -> int:
        return self.view.nbytes

    def __reduce_ex__(self, protocol):
        return (_rebuild_raw, (pickle.PickleBuffer(self.view),))


def _rebuild_raw(buf) -> memoryview:
    if isinstance(buf, pickle.PickleBuffer):
        buf = buf.raw()
    view = buf if isinstance(buf, memoryview) else memoryview(buf)
    if view.format != "B" or view.ndim != 1:
        view = view.cast("B")
    return view


def materialize_raw(value: Any) -> Any:
    """Collapse the two shapes a fetched RawPayload can take — the
    producer-process cache hit returns the wrapper itself, a real
    deserialization returns the rebuilt memoryview — into a memoryview."""
    if isinstance(value, RawPayload):
        return value.view
    return value


def dumps_function(fn: Any) -> bytes:
    """Serialize a function/class by value (closures included)."""
    return cloudpickle.dumps(fn)


def loads_function(blob: bytes) -> Any:
    return cloudpickle.loads(blob)


def dumps_inline(obj: Any) -> bytes:
    """One-shot serialize (no out-of-band buffers) for payload blobs
    that may capture arbitrary user objects (task args, error values,
    pubsub data). cloudpickle for the same by-reference trap as
    dumps_oob."""
    return MARKER_CLOUD + _dumps(obj)


def dumps_frame(obj: Any) -> bytes:
    """Serialize one wire frame: stdlib pickle fast path with automatic
    cloudpickle fallback.

    Frames are (msg_type, payload) pairs whose user-facing values are
    already pre-serialized bytes blobs (module docstring), so stdlib
    pickle's C encoder handles ~every frame; anything it rejects
    (a closure/lambda smuggled into a payload) falls back to
    cloudpickle's by-value treatment instead of failing the send.
    """
    try:
        return MARKER_PLAIN + pickle.dumps(obj, protocol=PICKLE5)
    except Exception:
        return MARKER_CLOUD + cloudpickle.dumps(obj, protocol=PICKLE5)


def loads_frame(blob: bytes) -> Any:
    """Decode a frame produced by dumps_frame OR dumps_inline (both
    markers are pickle bytecode; the marker is validated so a corrupt
    or unframed blob fails loudly here, not deep inside a handler)."""
    if not blob or blob[0] not in _KNOWN_MARKERS:
        raise ValueError(
            f"bad wire frame: unknown codec marker {blob[:1]!r}"
        )
    if len(blob) > 65536:
        # memoryview spares a full copy of large frames (inline puts
        # run right up to INLINE_THRESHOLD); for small ones the plain
        # slice is cheaper than building the view
        return pickle.loads(memoryview(blob)[1:])
    return pickle.loads(blob[1:])


def loads_inline(blob: bytes) -> Any:
    return pickle.loads(blob[1:])


# ------------------------------------------------------- frame splicing
# Template-spliced SUBMIT_TASKS frames (client hot path, round 3). A
# ``.remote()`` loop re-pickles the same fn_id / resources / options
# dict on every call; here the invariant *prefix* of the frame is
# pickled ONCE into raw opcode bytes and each call contributes only a
# hand-emitted fragment for its task id, arg blob, and deps. The spliced
# stream decodes with the ordinary ``loads_frame`` — the hub cannot
# tell a spliced frame from a ``dumps_frame`` one.
#
# Splice safety: a fragment cut out of ``pickle.dumps`` output is safe
# to embed in a foreign stream iff it never READS the memo (GET /
# BINGET / LONG_BINGET) — MEMOIZE ops only append and are harmless
# pollution, and mixed framed/unframed opcode runs are legal pickle.
# ``value_fragment`` verifies that once per template build with
# ``pickletools.genops``; the per-call emitters below never touch the
# memo at all. Anything unsafe (shared references inside options, an
# unpicklable value) returns None and the caller falls back to the
# plain ``dumps_frame`` path.

_PROTO5 = b"\x80\x05"
_FRAME_LEAD = 0x95  # FRAME opcode: 8-byte LE length follows
_MEMO_READS = frozenset(("GET", "BINGET", "LONG_BINGET"))


def _op_str(s: str) -> bytes:
    """SHORT_BINUNICODE / BINUNICODE push of a str."""
    raw = s.encode("utf-8", "surrogatepass")
    if len(raw) < 256:
        return b"\x8c" + bytes((len(raw),)) + raw
    return b"X" + len(raw).to_bytes(4, "little") + raw


def _op_bytes(b: bytes) -> bytes:
    """SHORT_BINBYTES / BINBYTES push of a bytes value."""
    if len(b) < 256:
        return b"C" + bytes((len(b),)) + b
    return b"B" + len(b).to_bytes(4, "little") + b


def _op_int(i: int) -> bytes:
    """BININT1/2/4 push of an int (LONG1 outside int32)."""
    if 0 <= i < 256:
        return b"K" + bytes((i,))
    if 0 <= i < 65536:
        return b"M" + i.to_bytes(2, "little")
    if -0x80000000 <= i <= 0x7FFFFFFF:
        return b"J" + i.to_bytes(4, "little", signed=True)
    enc = pickle.encode_long(i)
    return b"\x8a" + bytes((len(enc),)) + enc


def _op_bytes_list(items: Sequence[bytes]) -> bytes:
    """Push a list of bytes values (EMPTY_LIST or MARK..APPENDS)."""
    if not items:
        return b"]"
    return b"](" + b"".join(_op_bytes(b) for b in items) + b"e"


def value_fragment(obj: Any) -> Optional[bytes]:
    """Pickle ``obj`` into a splice-safe opcode fragment (PROTO/FRAME
    header and trailing STOP stripped), or None if the result reads the
    pickle memo and therefore cannot be embedded in a foreign stream."""
    try:
        blob = pickle.dumps(obj, protocol=PICKLE5)
        for op, _arg, _pos in pickletools.genops(blob):
            if op.name in _MEMO_READS:
                return None
    except Exception:
        return None
    body = blob[2:] if blob[:2] == _PROTO5 else blob
    if body and body[0] == _FRAME_LEAD:
        body = body[9:]
    if not body.endswith(b"."):
        return None
    return body[:-1]


def submit_frame_prefix(msg_type: str, fields: Dict[str, Any]) -> Optional[bytes]:
    """Precompute the invariant prefix of a ``(msg_type, payload)``
    frame: the payload dict is left OPEN (MARK not yet consumed) so the
    per-batch close can splice variable items into the same dict. None
    if any field value is not splice-safe."""
    parts = [_PROTO5, _op_str(msg_type), b"}("]
    for k, v in fields.items():
        frag = value_fragment(v)
        if frag is None:
            return None
        parts.append(_op_str(k))
        parts.append(frag)
    return b"".join(parts)


# per-call dict keys, emitted once (task_entry_fragment is the per-call
# hot path; re-encoding constant key strings there is exactly the waste
# this module exists to remove)
_K_TASK_ID = _op_str("task_id")
_K_ARGS_KIND = _op_str("args_kind")
_K_ARGS_PAYLOAD = _op_str("args_payload")
_K_ARG_DEPS = _op_str("arg_deps")
_K_RETURN_IDS = _op_str("return_ids")
_K_TASKS = _op_str("tasks")
_K_REQ_ID = _op_str("req_id")
_K_TRACE = _op_str("trace")


# precomputed opcode runs for the dominant task_entry_fragment shape
# (short ids, inline args, no deps, one return id) — this is THE
# per-call hot path, so the constant glue between the variable values
# is emitted once at import instead of five _op_* calls per task
_LEN1 = tuple(bytes((i,)) for i in range(256))
_ENTRY_HEAD = b"}(" + _K_TASK_ID + b"C"  # + len1 + task_id
_KIND_INLINE = _K_ARGS_KIND + _op_str("inline") + _K_ARGS_PAYLOAD
# empty arg_deps straight into a single short return id: ]e bracket the
# one-element return_ids list, u closes the task dict
_TAIL_NODEPS_1RET = _K_ARG_DEPS + b"]" + _K_RETURN_IDS + b"](C"


def task_entry_fragment(
    task_id: bytes,
    args_kind: str,
    args_payload: bytes,
    arg_deps: Sequence[bytes],
    return_ids: Sequence[bytes],
) -> bytes:
    """Hand-emit one SUBMIT_TASKS per-task dict as raw opcodes. Never
    touches the memo, so it splices into any prefix."""
    lp = len(args_payload)
    if (args_kind == "inline" and lp < 256 and not arg_deps
            and len(return_ids) == 1 and len(task_id) < 256
            and len(return_ids[0]) < 256):
        # fast shape: one join over mostly-precomputed runs
        rid = return_ids[0]
        return b"".join((
            _ENTRY_HEAD, _LEN1[len(task_id)], task_id,
            _KIND_INLINE, b"C", _LEN1[lp], args_payload,
            _TAIL_NODEPS_1RET, _LEN1[len(rid)], rid, b"eu",
        ))
    return b"".join((
        b"}(",
        _K_TASK_ID, _op_bytes(task_id),
        _K_ARGS_KIND, _op_str(args_kind),
        _K_ARGS_PAYLOAD, _op_bytes(args_payload),
        _K_ARG_DEPS, _op_bytes_list(arg_deps),
        _K_RETURN_IDS, _op_bytes_list(return_ids),
        b"u",
    ))


def close_submit_frame(
    prefix: bytes,
    task_frags: Sequence[bytes],
    req_id: Optional[int] = None,
    trace: Optional[Tuple[str, str]] = None,
) -> bytes:
    """Complete a spliced SUBMIT_TASKS wire frame: prefix + tasks list
    + optional req_id/trace, closing the payload dict and the
    (msg_type, payload) tuple. Returns marker-prefixed frame bytes
    ready for ``Connection.send_bytes``."""
    parts = [prefix, _K_TASKS, b"]("]
    parts.extend(task_frags)
    parts.append(b"e")
    if req_id is not None:
        parts.append(_K_REQ_ID)
        parts.append(_op_int(req_id))
    if trace is not None:
        parts.append(_K_TRACE)
        parts.append(_op_str(trace[0]))
        parts.append(_op_str(trace[1]))
        parts.append(b"\x86")
    parts.append(b"u\x86.")
    return MARKER_PLAIN + b"".join(parts)
