"""Shared-memory ring channel (SPSC, fixed-shape numpy payloads).

Parity target: the reference's mutable-plasma channel
(python/ray/experimental/channel/shared_memory_channel.py:151 +
src/ray/core_worker/experimental_mutable_object_manager.h): a
pre-allocated buffer written in place per execution instead of
allocating/sealing a new object. Implementation: a ring of K slots in
one multiprocessing.shared_memory segment, with per-slot sequence
numbers for lock-free SPSC handoff (write seq = read seq + 1 protocol).

Two backends behind one API, chosen at create time and pinned in the
pickled descriptor: the C++ ring from ray_tpu_torch/_native/ring_channel.cpp
(the default — real atomics, GIL-released microsecond waits, like the
reference's C++ mutable-object channel; built with g++ at first use, and a
failed build raises) and this file's pure-numpy ring (500us polling floor),
used only when asked for: ``backend="py"``, or
``RAY_TPU_TORCH_DISABLE_NATIVE=1`` for the default. Segment names carry the
``ray_tpu_torch_ch_`` prefix.

Use between pinned actors (compiled-graph stages, data feeders):
  ch = ShmChannel.create(shape=(8, 1024), dtype="float32")
  # producer:  ch.write(arr)         (blocks when ring full)
  # consumer:  out = ch.read()       (blocks until next item)
Both ends attach from the serialized descriptor (picklable).
"""

from __future__ import annotations

import os
import time
from multiprocessing import shared_memory
from typing import Optional, Tuple

import numpy as np

_HDR_DTYPE = np.int64
_HDR_SLOTS = 2  # [write_seq, read_seq]


class ShmChannel:
    def __init__(
        self,
        name: str,
        shape: Tuple[int, ...],
        dtype: str,
        capacity: int,
        _create: bool = False,
        backend: Optional[str] = None,
    ):
        self.name = name
        self.shape = tuple(shape)
        self.dtype = np.dtype(dtype)
        self.capacity = capacity
        item_bytes = int(np.prod(self.shape)) * self.dtype.itemsize
        # Backend is fixed at create time and travels in the pickled
        # descriptor: both endpoints must agree on the segment layout.
        # "native" = the C++ ring (_native/ring_channel.cpp): real
        # acquire/release atomics + GIL-released microsecond waits;
        # "py" = this file's numpy ring.
        if backend is None:
            backend = "py" if os.environ.get("RAY_TPU_TORCH_DISABLE_NATIVE") else "native"
        if backend not in ("native", "py"):
            raise ValueError(f"unknown channel backend {backend!r}")
        self.backend = backend
        if backend == "native":
            from ray_tpu_torch._native import ring_native

            mod = ring_native()  # builds on first use; raises if it cannot
            self._mod = mod
            self._item_bytes = item_bytes
            if _create:
                self._ring = mod.create("/" + name, item_bytes, capacity)
            else:
                self._ring = mod.attach("/" + name)
            self._shm = None
            return
        hdr_bytes = _HDR_SLOTS * np.dtype(_HDR_DTYPE).itemsize
        seq_bytes = capacity * np.dtype(_HDR_DTYPE).itemsize
        total = hdr_bytes + seq_bytes + capacity * item_bytes
        if _create:
            self._shm = shared_memory.SharedMemory(
                name=name, create=True, size=total
            )
            self._shm.buf[:total] = b"\x00" * total
        else:
            self._shm = shared_memory.SharedMemory(name=name)
            # Python 3.12's resource_tracker would unlink the segment
            # when ANY attaching process exits, killing the channel for
            # every other endpoint (no track=False until 3.13) — only
            # the creator owns cleanup
            try:
                from multiprocessing import resource_tracker

                resource_tracker.unregister(self._shm._name, "shared_memory")
            except Exception:
                pass
        buf = self._shm.buf
        self._hdr = np.frombuffer(buf, _HDR_DTYPE, count=_HDR_SLOTS)
        self._slot_seq = np.frombuffer(
            buf, _HDR_DTYPE, count=capacity, offset=hdr_bytes
        )
        self._data = np.frombuffer(
            buf,
            self.dtype,
            count=capacity * int(np.prod(self.shape)),
            offset=hdr_bytes + seq_bytes,
        ).reshape(capacity, *self.shape)

    # -- lifecycle -----------------------------------------------------
    @classmethod
    def create(
        cls,
        shape: Tuple[int, ...],
        dtype: str = "float32",
        capacity: int = 2,
        backend: Optional[str] = None,
    ) -> "ShmChannel":
        import uuid

        name = f"ray_tpu_torch_ch_{uuid.uuid4().hex[:12]}"
        return cls(name, shape, dtype, capacity, _create=True, backend=backend)

    def __reduce__(self):
        return (
            ShmChannel,
            (self.name, self.shape, str(self.dtype), self.capacity, False,
             self.backend),
        )

    def close(self, unlink: bool = False) -> None:
        if self.backend == "native":
            self._ring = None  # capsule destructor munmaps
            if unlink:
                try:
                    self._mod.unlink("/" + self.name)
                except OSError:
                    pass
            return
        # release numpy views before closing the mapping
        self._hdr = None
        self._slot_seq = None
        self._data = None
        try:
            self._shm.close()
        except BufferError:
            pass  # a view still exported somewhere; mapping dies with us
        if unlink:
            try:
                self._shm.unlink()
            except FileNotFoundError:
                pass

    def __del__(self):
        # drop numpy views BEFORE SharedMemory.__del__ tries to unmap,
        # otherwise interpreter shutdown in attached processes raises
        # BufferError("cannot close exported pointers exist")
        try:
            self.close()
        except Exception:
            pass

    # -- SPSC protocol -------------------------------------------------
    def write(self, arr: np.ndarray, timeout_s: float = 30.0) -> None:
        """Copy arr into the next slot; blocks while the ring is full."""
        arr = np.ascontiguousarray(arr, dtype=self.dtype)
        if arr.shape != self.shape:
            raise ValueError(f"channel expects shape {self.shape}, got {arr.shape}")
        if self.backend == "native":
            self._mod.write(self._ring, arr.data, float(timeout_s))
            return
        deadline = time.monotonic() + timeout_s
        w = int(self._hdr[0])
        while w - int(self._hdr[1]) >= self.capacity:  # ring full
            if time.monotonic() > deadline:
                raise TimeoutError("channel full: reader not draining")
            time.sleep(0.0005)
        slot = w % self.capacity
        self._data[slot] = arr
        self._slot_seq[slot] = w + 1  # publish AFTER the payload write
        self._hdr[0] = w + 1

    def read(self, timeout_s: float = 30.0) -> np.ndarray:
        """Copy the next item out; blocks until the writer publishes."""
        if self.backend == "native":
            out = np.empty(self.shape, self.dtype)
            self._mod.read_into(self._ring, out.data, float(timeout_s))
            return out
        deadline = time.monotonic() + timeout_s
        r = int(self._hdr[1])
        slot = r % self.capacity
        while int(self._slot_seq[slot]) != r + 1:
            if time.monotonic() > deadline:
                raise TimeoutError("channel empty: writer not producing")
            time.sleep(0.0005)
        out = np.array(self._data[slot], copy=True)
        self._hdr[1] = r + 1
        return out

    def try_read(self) -> Optional[np.ndarray]:
        if self.backend == "native":
            out = np.empty(self.shape, self.dtype)
            if self._mod.try_read_into(self._ring, out.data):
                return out
            return None
        r = int(self._hdr[1])
        if int(self._slot_seq[r % self.capacity]) != r + 1:
            return None
        return self.read(timeout_s=0.001)
