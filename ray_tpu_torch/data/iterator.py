"""Batch iteration with prefetch + device staging.

Parity: python/ray/data/iterator.py + _internal/block_batching/ (format
conversion, prefetching). With ``device_put`` (a ``torch.device`` or a
string) every numeric numpy column of a batch becomes a tensor on that
device, and the prefetch thread stages the next batch while the current
one is being consumed, which is how a training loop hides input latency
behind compute.

On a CUDA device a column is copied into pinned host memory, then to the
card with ``non_blocking=True`` on a side stream that the staging thread
owns, and an event is recorded after the copies. Before a batch is
handed out, the consumer's current stream waits on that event and every
tensor is ``record_stream``-ed to it, so the batch is never read before
its copy has landed and its memory is never reused while the consumer's
work on it is still queued. ``device_put="cpu"`` gives CPU tensors (a
copy of the block, no pinning). A CUDA device without a GPU raises;
nothing falls back to the CPU.
"""

from __future__ import annotations

import queue
import threading
from typing import Any, Iterator, List, Optional

import numpy as np

from .block import Block, BlockAccessor

_SENTINEL = object()


def _rebatch(block_refs, batch_size: Optional[int], drop_last: bool) -> Iterator[Block]:
    """Coalesce/slice streamed blocks into exact-size batches."""
    import ray_tpu_torch

    buf: List[Block] = []
    buffered = 0
    for ref in block_refs:
        block = ray_tpu_torch.get(ref)
        n = BlockAccessor.for_block(block).num_rows()
        if n == 0:
            continue
        if batch_size is None:
            yield block
            continue
        buf.append(block)
        buffered += n
        while buffered >= batch_size:
            merged = BlockAccessor.concat(buf)
            acc = BlockAccessor.for_block(merged)
            yield acc.slice(0, batch_size)
            rest = acc.slice(batch_size, acc.num_rows())
            buf = [rest]
            buffered = BlockAccessor.for_block(rest).num_rows()
    if batch_size is None:
        return
    if buffered and not drop_last:
        merged = BlockAccessor.concat(buf)
        if BlockAccessor.for_block(merged).num_rows():
            yield merged


class _Stager:
    """Numeric numpy columns of a batch -> tensors on ``device``. Owns the
    side stream of a CUDA device; built in the thread that stages."""

    def __init__(self, device):
        import torch

        self.torch = torch
        self.device = torch.device(device)
        self.stream = None
        if self.device.type == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError(
                    f"device_put={device!r}: no CUDA device available; pass "
                    "device_put='cpu' to stage on the CPU"
                )
            if self.device.index is None:
                self.device = torch.device("cuda", torch.cuda.current_device())
            self.stream = torch.cuda.Stream(self.device)

    @staticmethod
    def _numeric(v) -> bool:
        return isinstance(v, np.ndarray) and v.dtype != object and v.dtype.kind in "biufc"

    def __call__(self, batch):
        torch = self.torch
        if not isinstance(batch, dict):
            return batch, None
        if self.stream is None:
            return {k: torch.from_numpy(np.array(v, order="C", copy=True))
                    if self._numeric(v) else v for k, v in batch.items()}, None
        out = {}
        with torch.cuda.stream(self.stream):
            for k, v in batch.items():
                if not self._numeric(v):
                    out[k] = v
                    continue
                host = torch.empty(v.shape, dtype=torch.from_numpy(np.empty(0, v.dtype)).dtype,
                                   pin_memory=True)
                host.numpy()[...] = v  # the block may be a read-only mapping
                out[k] = host.to(self.device, non_blocking=True)
            ready = torch.cuda.Event()
            ready.record(self.stream)
        return out, (ready, self.device)


def _hand_over(staged):
    """The batch of a (batch, (event, device)) pair, ordered after its
    copies on the consumer's current stream of that device."""
    batch, ready = staged
    if ready is None:
        return batch
    import torch

    event, device = ready
    stream = torch.cuda.current_stream(device)
    stream.wait_event(event)
    for v in batch.values():
        if isinstance(v, torch.Tensor):
            v.record_stream(stream)
    return batch


def _drain(q: "queue.Queue") -> None:
    """Drop every queued batch (a staged batch holds device memory)."""
    while True:
        try:
            q.get_nowait()
        except queue.Empty:
            return


def iter_batches(
    block_refs,
    *,
    batch_size: Optional[int],
    batch_format: str,
    prefetch_batches: int,
    drop_last: bool,
    device_put: Any = None,
) -> Iterator[Any]:
    def produce() -> Iterator[Any]:
        stage = _Stager(device_put) if device_put is not None else None
        for block in _rebatch(block_refs, batch_size, drop_last):
            batch = BlockAccessor.for_block(block).to_batch(batch_format)
            yield stage(batch) if stage is not None else (batch, None)

    if prefetch_batches <= 0:
        for staged in produce():
            yield _hand_over(staged)
        return

    q: "queue.Queue" = queue.Queue(maxsize=prefetch_batches)
    err: List[BaseException] = []
    stop = threading.Event()

    def worker():
        try:
            for item in produce():
                # bounded put that aborts if the consumer abandoned the
                # iterator (otherwise this thread would pin prefetched
                # device batches for the life of the process)
                while not stop.is_set():
                    try:
                        q.put(item, timeout=0.2)
                        break
                    except queue.Full:
                        continue
                del item
                if stop.is_set():
                    return
        except BaseException as e:  # surfaced on the consumer side
            err.append(e)
        finally:
            while not stop.is_set():  # consumer still listening
                try:
                    q.put(_SENTINEL, timeout=0.2)
                    break
                except queue.Full:
                    continue
            if stop.is_set():
                _drain(q)

    t = threading.Thread(target=worker, daemon=True, name="data-prefetch")
    t.start()
    try:
        while True:
            item = q.get()
            if item is _SENTINEL:
                break
            yield _hand_over(item)
            del item
        if err:
            raise err[0]
    finally:
        stop.set()
        _drain(q)
