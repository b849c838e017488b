"""Node-local shared-memory object store.

TPU-native re-think of the reference's plasma store (reference:
src/ray/object_manager/plasma/ — dlmalloc arena over mmap/shm, fd passing
via fling.cc, flatbuffer protocol). We get the same zero-copy property
with far less machinery by backing each large object with an mmap'ed
file under /dev/shm/<session>/ that every process on the node can map.
There is no socket protocol: object *placement* metadata lives in the
control hub; the bytes themselves are mapped directly.

Small objects (< INLINE_THRESHOLD, like the reference's
max_direct_call_object_size=100KB, reference: src/ray/common/
ray_config_def.h) never touch shm — they travel inline through the hub,
mirroring the reference's in-process CoreWorkerMemoryStore
(src/ray/core_worker/store_provider/memory_store/memory_store.h:45).

Wire layout of a segment:
    [8B u64 total_layout_size][8B u64 header_len][header bytes]
    per out-of-band buffer: [8B u64 buf_len][pad to 64B][buf bytes][pad]
Buffers are 64-byte aligned so numpy views are alignment-friendly.
The leading total word makes the layout SELF-TERMINATING: a segment
carved from a larger recycled/prewarmed pool file needs no exact-size
truncate (which frees the warm tail pages this pool exists to keep) —
readers parse to `total` and ignore any slack tail, and the word rides
along byte-identically through chunked streams and cross-node copies.
"""

from __future__ import annotations

import mmap
import os
import pickle
import struct
import threading
import uuid
from typing import Any, List, Optional, Tuple

from . import serialization

INLINE_THRESHOLD = 100 * 1024  # match reference max_direct_call_object_size
_ALIGN = 64

# Freed writer segments are recycled instead of unlinked: a put into
# already-faulted tmpfs pages is a plain memcpy (~7 GiB/s on one core
# here) while a fresh file pays page allocation + zeroing (~2.4 GiB/s).
# This is the same trick plasma gets from its pre-mmap'd dlmalloc arena
# (reference: src/ray/object_manager/plasma/ — the arena is faulted once
# and objects recycle its pages).
_POOL_MAX_BYTES = int(
    os.environ.get("RAY_TPU_TORCH_SEGMENT_POOL_BYTES", str(2 * 1024**3))
)
_POOL_MAX_SEGMENTS = 8


def _align(n: int) -> int:
    return (n + _ALIGN - 1) & ~(_ALIGN - 1)


def _advise_hugepage(mm: mmap.mmap) -> None:
    """Best-effort THP hint: on hosts with shmem THP enabled
    (/sys/kernel/mm/transparent_hugepage/shmem_enabled = advise) this
    roughly halves large-copy TLB pressure; everywhere else it's a
    no-op. Never fatal."""
    try:
        mm.madvise(mmap.MADV_HUGEPAGE)
    except (AttributeError, OSError, ValueError):
        pass


def _parse_segment(view: memoryview, cap: int) -> Tuple[bytes, List[memoryview]]:
    """Parse the put_raw wire layout out of `view` (a mapped segment or
    a pulled byte blob): returns (header, buffers) with every buffer a
    zero-copy sub-view of `view`. `cap` bounds the self-reported total
    so a truncated/padded source never reads past the real bytes."""
    (total,) = struct.unpack_from("<Q", view, 0)
    if not 16 <= total <= cap:
        total = cap  # defensive: never read past the mapping
    (hlen,) = struct.unpack_from("<Q", view, 8)
    header = bytes(view[16 : 16 + hlen])
    off = _align(16 + hlen)
    buffers: List[memoryview] = []
    while off < total:
        (blen,) = struct.unpack_from("<Q", view, off)
        off = _align(off + 8)
        buffers.append(view[off : off + blen])
        off = _align(off + blen)
    return header, buffers


def decode_segment_bytes(data) -> Any:
    """Deserialize a whole segment pulled as one byte blob WITHOUT
    installing it in any store — buffers stay views over `data`. This
    is the lightweight consumer path for one-shot serve payload pulls
    (object_agent.pull_segment_bytes): no store file, no replica
    registration, no ref-count bookkeeping. The caller must keep the
    returned value (its views pin `data`) alive only as long as needed."""
    view = data if isinstance(data, memoryview) else memoryview(data)
    if view.format != "B" or view.ndim != 1:
        view = view.cast("B")
    header, buffers = _parse_segment(view, view.nbytes)
    return serialization.loads_oob(header, buffers)


def _segment_layout(header: bytes, raws: List[memoryview]):
    """Compute (total_size, [(offset, part), ...]) for a segment.
    Parts are either bytes (metadata words) or the raw buffers."""
    parts: List[Tuple[int, Any]] = [
        (8, struct.pack("<Q", len(header))),
        (16, header),
    ]
    pos = 16 + len(header)
    for r in raws:
        pos = _align(pos)
        parts.append((pos, struct.pack("<Q", r.nbytes)))
        pos = _align(pos + 8)
        parts.append((pos, r))
        pos += r.nbytes
    total = _align(pos)
    parts.insert(0, (0, struct.pack("<Q", total)))
    return total, parts


def iter_segment_chunks(header: bytes, raws: List[memoryview],
                        chunk: int = 8 * 1024 * 1024):
    """Yield the byte stream of a segment (exactly the put_raw wire
    layout) in ~chunk-sized pieces without materializing the whole
    segment — the transport for shm-less clients streaming a large put
    to the hub (reference: util/client/server/dataservicer.py chunked
    PutObject). Returns (total_size, generator)."""
    total, parts = _segment_layout(header, raws)
    # every piece — padding included — funnels through the same
    # accumulate-and-flush loop, so acc never exceeds chunk regardless
    # of alignment gaps vs chunk size
    pieces: List[Any] = []
    pos = 0
    for off, part in parts:
        if off != pos:
            pieces.append(b"\x00" * (off - pos))
            pos = off
        mv = part if isinstance(part, memoryview) else memoryview(part)
        if mv.format != "B" or mv.ndim != 1:
            mv = mv.cast("B")
        pieces.append(mv)
        pos += mv.nbytes
    if pos != total:
        pieces.append(b"\x00" * (total - pos))

    def gen():
        acc = bytearray()
        for p in pieces:
            mv = memoryview(p)
            i, n = 0, mv.nbytes
            while i < n:
                take = min(chunk - len(acc), n - i)
                acc += mv[i:i + take]
                i += take
                if len(acc) >= chunk:
                    yield bytes(acc)
                    acc = bytearray()
        if acc:
            yield bytes(acc)

    return total, gen()


class MappedSegment:
    """An open mmap of one object segment; kept alive while views exist.

    `writable` means THIS process created the segment (put_raw) and is
    therefore its sole writer — only such segments may be recycled into
    the warm pool on free() (a reader recycling a segment another
    process also pooled would double-assign the same pages).
    `size` is the logical object size; the mmap may be longer when the
    segment was carved from a recycled file.
    `faulted` means this mapping's pages have been WRITTEN THROUGH (its
    PTEs are populated): a put into it is a pure memcpy (~8 GiB/s here)
    instead of 64Ki soft faults + memcpy (~1.4 GiB/s). The cold path
    writes via os.write — the file's pages exist but this mapping never
    faulted them — so only pool-path/prewarmed segments qualify."""

    __slots__ = ("path", "mm", "size", "writable", "faulted")

    def __init__(self, path: str):
        self.path = path
        fd = os.open(path, os.O_RDWR)
        try:
            st = os.fstat(fd)
            self.mm = mmap.mmap(fd, st.st_size)
        finally:
            os.close(fd)
        _advise_hugepage(self.mm)
        self.size = st.st_size
        self.writable = False
        self.faulted = False

    @classmethod
    def from_fd(cls, path: str, fd: int, size: int) -> "MappedSegment":
        """Map the WRITER'S OWN fd (before close): re-opening by path
        could observe a concurrent rewriter's fresh, incomplete file
        (speculative task retry of the same object id)."""
        seg = cls.__new__(cls)
        seg.path = path
        seg.mm = mmap.mmap(fd, size)
        _advise_hugepage(seg.mm)
        seg.size = size
        seg.writable = True
        seg.faulted = False
        return seg


def _write_all(fd: int, data) -> None:
    """write() can return short (and caps at ~2 GiB per call) — loop."""
    view = memoryview(data)
    written = 0
    while written < view.nbytes:
        written += os.write(fd, view[written:])


class ShmObjectStore:
    """Per-process facade over the node's /dev/shm session directory."""

    def __init__(self, session_dir: str):
        self.dir = os.path.join(session_dir, "objects")
        os.makedirs(self.dir, exist_ok=True)
        self._segments: dict[str, MappedSegment] = {}
        self._lock = threading.Lock()
        # warm-pool of recycled writer segments: [(mmap_len, seg), ...]
        self._pool: List[Tuple[int, MappedSegment]] = []
        self._pool_bytes = 0

    def _path(self, name: str) -> str:
        return os.path.join(self.dir, name)

    def _pool_take(self, total: int) -> Optional[MappedSegment]:
        """Pop the smallest pooled segment whose mmap covers `total`,
        preferring already-faulted mappings: a recycled cold-path
        segment (file pages warm, mapping unfaulted) must not best-fit
        its way ahead of a prewarmed/pool-written one — the faulted
        mapping copies ~5x faster (see MappedSegment.faulted)."""
        with self._lock:
            best = -1
            for i, (cap, seg) in enumerate(self._pool):
                if cap < total:
                    continue
                if best < 0:
                    best = i
                    continue
                bcap, bseg = self._pool[best]
                if (seg.faulted, -cap) > (bseg.faulted, -bcap):
                    best = i
            if best < 0:
                return None
            cap, seg = self._pool.pop(best)
            self._pool_bytes -= cap
            return seg

    def prewarm(self, nbytes: int) -> None:
        """Fault `nbytes` of anonymous pooled segments through their
        mappings (the plasma trick: the arena is faulted once at
        startup, objects recycle its pages). Called from a background
        thread at driver init, so by the first large put the pool
        already holds warm pages and the put is a single memcpy. Split
        into two segments when the budget allows: carving an object
        from a much-larger segment truncates away its warm tail, so
        right-sized halves beat one big arena. A pool-cap overflow or
        any OS error just skips the optimization."""
        if nbytes <= 0:
            return
        if nbytes >= 128 * 1024 * 1024:
            half = nbytes // 2
            self._prewarm_one(half)
            self._prewarm_one(nbytes - half)
        else:
            self._prewarm_one(nbytes)

    def _prewarm_one(self, nbytes: int) -> None:
        name = f".pool.{uuid.uuid4().hex}"
        path = os.path.join(self.dir, name)
        try:
            fd = os.open(path, os.O_CREAT | os.O_RDWR | os.O_EXCL, 0o600)
            try:
                os.truncate(fd, nbytes)
                seg = MappedSegment.from_fd(path, fd, nbytes)
            finally:
                os.close(fd)
            # fault every page by writing through the mapping (writes —
            # not reads — populate the PTEs; a read maps the shared
            # zero page and the first real write still faults)
            mm = seg.mm
            step = 8 * 1024 * 1024
            zeros = bytes(step)
            for off in range(0, nbytes, step):
                end = min(off + step, nbytes)
                mm[off:end] = zeros[: end - off]
            seg.faulted = True
        except OSError:
            try:
                os.unlink(path)
            except OSError:
                pass
            return
        with self._lock:
            if (
                self._pool_bytes + nbytes <= _POOL_MAX_BYTES
                and len(self._pool) < _POOL_MAX_SEGMENTS
            ):
                self._pool.append((nbytes, seg))
                self._pool_bytes += nbytes
                return
        try:
            os.unlink(path)
        except OSError:
            pass

    def _layout(self, header: bytes, raws: List[memoryview]):
        return _segment_layout(header, raws)

    def put(self, name: str, obj: Any) -> int:
        """Serialize obj into a new segment. Returns segment size."""
        header, buffers = serialization.dumps_oob(obj)
        return self.put_raw(name, header, [b.raw() for b in buffers])

    def put_raw(self, name: str, header: bytes, raws: List[memoryview]) -> int:
        """Write a segment from pre-serialized (header, buffers).

        Recycled path: memcpy into an already-faulted pooled segment
        (np.copyto for large buffers — the single-core tmpfs ceiling,
        ~7 GiB/s here). Cold path: sequential os.write, NOT mmap
        assignment — writing through a fresh mmap faults one page at a
        time while write() bulk-copies in the kernel."""
        total, parts = self._layout(header, raws)
        path = self._path(name)
        # a retried task may rewrite the same object id; the old segment
        # stays valid for existing mmaps after the unlink
        try:
            os.unlink(path)
        except FileNotFoundError:
            pass
        seg = self._pool_take(total)
        if seg is not None:
            # grow-only: the self-terminating layout lets readers
            # ignore a slack tail, so carving a smaller object from a
            # larger recycled file never truncates (truncating would
            # free exactly the warm tail pages the pool exists to keep)
            if os.path.getsize(seg.path) < total:
                os.truncate(seg.path, total)
            mm = seg.mm
            for off, part in parts:
                if isinstance(part, memoryview) and part.nbytes >= (1 << 16):
                    import numpy as np

                    src = part if part.format == "B" and part.ndim == 1 \
                        else part.cast("B")
                    np.copyto(
                        np.frombuffer(mm, np.uint8, src.nbytes, off),
                        np.frombuffer(src, np.uint8),
                    )
                else:
                    n = part.nbytes if isinstance(part, memoryview) else len(part)
                    mm[off:off + n] = bytes(part)
            os.rename(seg.path, path)
            seg.path = path
            seg.size = total
            # the copy above wrote the object's span through the mmap;
            # for recycled cold-path segments this is what faults them
            seg.faulted = True
        else:
            fd = os.open(path, os.O_CREAT | os.O_RDWR | os.O_EXCL, 0o600)
            try:
                pending: List[bytes] = []
                pos = 0
                for off, part in parts:
                    if off != pos:
                        pending.append(b"\x00" * (off - pos))
                        pos = off
                    if isinstance(part, memoryview):
                        # flush small parts, then bulk-write the buffer
                        if pending:
                            _write_all(fd, b"".join(pending))
                            pending = []
                        _write_all(
                            fd,
                            part.cast("B")
                            if part.format != "B" or part.ndim != 1
                            else part,
                        )
                    else:
                        pending.append(part)
                    pos += part.nbytes if isinstance(part, memoryview) else len(part)
                if pos != total:
                    pending.append(b"\x00" * (total - pos))
                if pending:
                    _write_all(fd, b"".join(pending))
                seg = MappedSegment.from_fd(path, fd, total)
            finally:
                os.close(fd)
        with self._lock:
            self._segments[name] = seg
        return total

    def get(self, name: str) -> Any:
        """Map the segment and deserialize zero-copy (buffers view the mmap)."""
        with self._lock:
            seg = self._segments.get(name)
            if seg is None:
                seg = MappedSegment(self._path(name))
                self._segments[name] = seg
        header, buffers = _parse_segment(memoryview(seg.mm), seg.size)
        return serialization.loads_oob(header, buffers)

    def write_segment(self, name: str, data: bytes) -> None:
        """Install a segment fetched from another node (byte-identical
        copy of the producer's file; get() then maps it locally). The
        tmp name is per-process: concurrent fetchers of the same object
        must not race each other's os.replace."""
        path = self._path(name)
        tmp = f"{path}.fetch.{os.getpid()}"
        with open(tmp, "wb") as f:
            f.write(data)
        os.replace(tmp, path)

    def contains(self, name: str) -> bool:
        return name in self._segments or os.path.exists(self._path(name))

    def drop_mapping(self, name: str) -> None:
        """Forget a READER mapping of a freed object. Writer segments
        keep their free()/pool recycle path untouched; reader mappings
        of remote or sibling-process segments have no pool value, and
        sustained serving (one mapped payload segment per request)
        would otherwise grow the table by one dead entry per request.
        The mmap pages stay alive while fetched views reference them —
        the buffer protocol keeps the exporting mmap pinned."""
        with self._lock:
            seg = self._segments.get(name)
            if seg is not None and not seg.writable:
                del self._segments[name]

    def free(self, name: str) -> None:
        with self._lock:
            seg = self._segments.pop(name, None)
            if seg is not None and seg.writable:
                cap = len(seg.mm)
                # advisory pre-check: skip the rename+unlink round-trip
                # when the pool is already full. Going stale here only
                # forgoes a recycle — the authoritative check before
                # insert below is what enforces the caps.
                no_room = (
                    self._pool_bytes + cap > _POOL_MAX_BYTES
                    or len(self._pool) >= _POOL_MAX_SEGMENTS
                )
        if seg is not None and seg.writable:
            # Recycle the warm pages under an anonymous name. Free means
            # "no live borrowers" (same contract as the reference's
            # ray._private.internal_api.free — objects are deleted even
            # if still referenced); a racing unlink by the hub just
            # defeats the recycle. Rename FIRST, then check pool room
            # and insert under ONE lock acquisition: checking under a
            # separate acquisition let two concurrent frees both pass
            # the byte-cap test and blow past _POOL_MAX_BYTES.
            if no_room:
                try:
                    os.unlink(seg.path)
                except OSError:
                    pass
                return
            pooled = os.path.join(self.dir, f".pool.{uuid.uuid4().hex}")
            try:
                os.rename(seg.path, pooled)
            except OSError:
                return  # hub already unlinked it; drop the segment
            seg.path = pooled
            with self._lock:
                if (
                    self._pool_bytes + cap <= _POOL_MAX_BYTES
                    and len(self._pool) < _POOL_MAX_SEGMENTS
                ):
                    self._pool.append((cap, seg))
                    self._pool_bytes += cap
                    return
            # pool is full after all: drop the renamed file (the mmap
            # stays valid for any live views)
            try:
                os.unlink(pooled)
            except OSError:
                pass
            return
        # The mmap stays valid for existing views even after unlink.
        try:
            os.unlink(self._path(name))
        except FileNotFoundError:
            pass

    def estimate_size(self, obj: Any) -> int:
        """Cheap size probe used to pick inline vs shm path."""
        try:
            import numpy as np

            if isinstance(obj, np.ndarray):
                return obj.nbytes
        except Exception:
            pass
        return -1  # unknown; caller serializes and checks
