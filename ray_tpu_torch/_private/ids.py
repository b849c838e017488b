"""Unique identifiers for tasks, objects, and actors.

Design follows the reference's nested-ID scheme (reference:
src/ray/common/id.h and src/ray/design_docs/id_specification.md — JobID
4B ⊂ ActorID 16B ⊂ TaskID 24B ⊂ ObjectID 28B) but simplified: IDs here
are flat random byte strings. The nesting in the reference exists to
support distributed lineage reconstruction by-prefix; our control
service is authoritative for metadata, so flat IDs suffice and are
cheaper to generate and hash.
"""

from __future__ import annotations

import os
import binascii
import threading

_ID_LEN = 14  # bytes; 112 bits of randomness — collision-free in practice

# Batched entropy: os.urandom is a syscall, and ID generation sits on
# the submit hot path (TaskID + per-return ObjectID per call) — at 1k
# submits/s the per-call syscalls measurably steal GIL time from the
# in-process hub thread (BENCH_NOTE.md). One urandom refill serves 1024
# IDs; the bytes come from the same CSPRNG, so collision behavior is
# unchanged. Per-thread buffers keep this lock-free.
_ID_POOL_IDS = 1024
_entropy = threading.local()
if hasattr(os, "register_at_fork"):
    # a forked child must not replay the parent's pooled bytes (workers
    # here are spawned, not forked — this is defense in depth)
    os.register_at_fork(
        after_in_child=lambda: setattr(_entropy, "buf", None)
    )


def _pooled_id_bytes() -> bytes:
    buf = getattr(_entropy, "buf", None)
    pos = getattr(_entropy, "pos", 0)
    if buf is None or pos >= len(buf):
        buf = _entropy.buf = os.urandom(_ID_LEN * _ID_POOL_IDS)
        pos = 0
    _entropy.pos = pos + _ID_LEN
    return buf[pos:pos + _ID_LEN]


def id_slab(n: int) -> list:
    """``n`` raw id byte strings in one draw. A bulk submit needs
    N task ids + N*num_returns object ids up front; drawing them one
    at a time costs a pool-bookkeeping round per id and, every 1024
    ids, a syscall mid-loop. One sized urandom (plus whatever is left
    in the thread pool) amortizes both across the slab."""
    buf = getattr(_entropy, "buf", None)
    pos = getattr(_entropy, "pos", 0)
    if buf is None:
        buf, pos = b"", 0
    avail = (len(buf) - pos) // _ID_LEN
    out = [buf[pos + i * _ID_LEN: pos + (i + 1) * _ID_LEN]
           for i in range(min(n, avail))]
    _entropy.pos = pos + len(out) * _ID_LEN
    if len(out) < n:
        need = n - len(out)
        # refill covers the remainder AND leaves a full pool behind
        fresh = os.urandom(_ID_LEN * (need + _ID_POOL_IDS))
        out.extend(fresh[i * _ID_LEN: (i + 1) * _ID_LEN]
                   for i in range(need))
        _entropy.buf = fresh
        _entropy.pos = need * _ID_LEN
    return out


def id_pair() -> tuple:
    """Two pooled ids in one draw — the per-call ``.remote()`` shape
    (one task id + one return object id). Same entropy pool as
    ``id_slab``, minus the per-call slab bookkeeping: this sits on the
    client's batched-submit hot path (bench_core submit_path_overhead)."""
    buf = getattr(_entropy, "buf", None)
    pos = getattr(_entropy, "pos", 0)
    end = pos + 2 * _ID_LEN
    if buf is None or end > len(buf):
        buf = _entropy.buf = os.urandom(_ID_LEN * _ID_POOL_IDS)
        pos, end = 0, 2 * _ID_LEN
    _entropy.pos = end
    mid = pos + _ID_LEN
    return buf[pos:mid], buf[mid:end]


def span_id_hex() -> str:
    """16-hex-char tracing span/trace id from the same pooled entropy
    (util/tracing.py): span open is a hot path when runtime sampling is
    on, and a uuid.uuid4() per span costs an os.urandom syscall each."""
    return _pooled_id_bytes()[:8].hex()


class BaseID:
    __slots__ = ("_bytes", "_hash")

    def __init__(self, id_bytes: bytes):
        self._bytes = id_bytes
        self._hash = hash(id_bytes)

    @classmethod
    def generate(cls):
        return cls(_pooled_id_bytes())

    @classmethod
    def from_hex(cls, hex_str: str):
        return cls(binascii.unhexlify(hex_str))

    def binary(self) -> bytes:
        return self._bytes

    def hex(self) -> str:
        return self._bytes.hex()

    def __hash__(self):
        return self._hash

    def __eq__(self, other):
        return type(other) is type(self) and other._bytes == self._bytes

    def __repr__(self):
        return f"{type(self).__name__}({self._bytes.hex()})"

    def __reduce__(self):
        return (type(self), (self._bytes,))


class ObjectID(BaseID):
    pass


class TaskID(BaseID):
    pass


class ActorID(BaseID):
    pass


class NodeID(BaseID):
    pass


class WorkerID(BaseID):
    pass


class PlacementGroupID(BaseID):
    pass


class JobID(BaseID):
    pass
