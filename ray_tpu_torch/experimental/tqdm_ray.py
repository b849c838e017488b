"""Distributed progress bars.

Parity: python/ray/experimental/tqdm_ray.py — the reference emits
magic-token JSON lines on worker stdout which a driver-side
``BarManager`` demultiplexes into real tqdm bars. Here worker bars
publish state records over the hub's pubsub plane (channel
``__tqdm__``) — the same transport worker logs already ride — and the
driver renders them; driver-local bars render directly. No dependency
on the real tqdm package.
"""

from __future__ import annotations

import os
import sys
import threading
import time
import uuid as _uuid
from typing import Any, Dict, Iterable, Optional

_THROTTLE_S = 0.1
CHANNEL = "__tqdm__"

_mgr_lock = threading.Lock()
_manager: Optional["BarManager"] = None


def _get_manager() -> "BarManager":
    global _manager
    with _mgr_lock:
        if _manager is None:
            _manager = BarManager()
        return _manager


class BarManager:
    """Driver-side renderer: one status line per live bar.

    The reference stacks real tqdm instances by position; this renders
    equivalent `desc: n/total` lines, throttled, overwriting in place
    when stderr is a tty and falling back to plain prints otherwise.
    """

    def __init__(self):
        self._bars: Dict[str, Dict[str, Any]] = {}
        self._lock = threading.Lock()
        self._last_draw = 0.0
        self._tty = sys.stderr.isatty()

    def process_state_update(self, rec: Dict[str, Any]) -> None:
        with self._lock:
            if rec.get("closed"):
                bar = self._bars.pop(rec["uuid"], None)
                if bar is not None:
                    self._draw(final=self._fmt(rec))
                return
            self._bars[rec["uuid"]] = rec
            now = time.monotonic()
            if now - self._last_draw >= _THROTTLE_S:
                self._last_draw = now
                self._draw()

    @staticmethod
    def _fmt(rec: Dict[str, Any]) -> str:
        total = rec.get("total")
        frac = f"{rec['x']}/{total}" if total else str(rec["x"])
        pid = rec.get("pid")
        src = f" (pid={pid})" if pid and pid != os.getpid() else ""
        return f"{rec.get('desc') or 'it'}{src}: {frac}"

    def _draw(self, final: Optional[str] = None) -> None:
        lines = [self._fmt(r) for r in self._bars.values()]
        if final is not None:
            sys.stderr.write(("\r" if self._tty else "") + final + "\n")
        elif self._tty and len(lines) == 1:
            sys.stderr.write("\r" + lines[0] + "\x1b[K")
        else:
            for line in lines:
                sys.stderr.write(line + "\n")
        sys.stderr.flush()


def _driver_subscribe(client) -> None:
    """Wired up by worker.init alongside the log subscription."""
    client.subscribe(CHANNEL, _get_manager().process_state_update)


class tqdm:
    """Drop-in subset of tqdm's API, safe inside remote tasks/actors."""

    def __init__(
        self,
        iterable: Optional[Iterable] = None,
        desc: str = "",
        total: Optional[int] = None,
        position: Optional[int] = None,
    ):
        self._iterable = iterable
        self._desc = desc
        if total is None and iterable is not None:
            try:
                total = len(iterable)  # type: ignore[arg-type]
            except TypeError:
                total = None
        self._total = total
        self._position = position
        self._x = 0
        self._uuid = _uuid.uuid4().hex
        self._closed = False
        self._last_pub = 0.0
        self._publish(force=True)

    # -- tqdm API -----------------------------------------------------
    def update(self, n: int = 1) -> None:
        self._x += n
        self._publish()

    def set_description(self, desc: str) -> None:
        self._desc = desc
        self._publish()

    def refresh(self) -> None:
        self._publish(force=True)

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        self._publish(force=True)

    def __iter__(self):
        assert self._iterable is not None, "no iterable passed to tqdm()"
        try:
            for item in self._iterable:
                yield item
                self.update(1)
        finally:
            self.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # -- transport ----------------------------------------------------
    def _state(self) -> Dict[str, Any]:
        return {
            "uuid": self._uuid,
            "desc": self._desc,
            "total": self._total,
            "x": self._x,
            "pos": self._position,
            "pid": os.getpid(),
            "closed": self._closed,
        }

    def _publish(self, force: bool = False) -> None:
        now = time.monotonic()
        if not force and now - self._last_pub < _THROTTLE_S:
            return
        self._last_pub = now
        from ray_tpu_torch._private import worker as _worker

        if _worker._is_worker and _worker.is_initialized():
            try:
                _worker.get_client().publish(CHANNEL, self._state())
                return
            except Exception:
                pass
        _get_manager().process_state_update(self._state())


def safe_print(*args, **kwargs) -> None:
    """Print without corrupting in-place bar redraws (reference
    tqdm_ray.safe_print): emit a newline first if a tty bar is live."""
    mgr = _manager
    if mgr is not None and mgr._tty and mgr._bars:
        sys.stderr.write("\n")
    print(*args, **kwargs)
