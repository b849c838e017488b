"""Durable KV store backend for the hub.

Parity: the reference GCS chooses a storage backend at startup —
in-memory or Redis for fault tolerance (gcs/gcs_server/gcs_server.h
StorageType, gcs/store_client/redis_store_client.h); the internal KV
(function table, Serve/Tune metadata, usage tags) survives a GCS
restart. Here the durable backend is a local append-only log +
snapshot (no Redis in a TPU pod's trust domain; the head's disk is
the natural store). Enable with ``ray_tpu_torch.init(_kv_store_path=...)``
or RAY_TPU_TORCH_KV_STORE_PATH; a restarted head reloads the table and
compacts the log.

Format: snapshot file = pickled dict; log file = pickled ("put", k, v)
/ ("del", k) records appended per mutation. Torn tails (crash mid-
append) are detected and dropped on load.
"""

from __future__ import annotations

import os
import pickle
import struct
from typing import Dict, Optional

_LEN = struct.Struct("<I")


class FileKvStore:
    def __init__(self, path: str, fsync: bool = False):
        self.dir = path
        os.makedirs(path, exist_ok=True)
        self._snap_path = os.path.join(path, "kv.snapshot")
        self._log_path = os.path.join(path, "kv.log")
        self._fsync = fsync
        self._log = None  # opened by load()
        # exclusive owner lock: a second hub opening the same store would
        # truncate the log out from under the first (load() -> compact
        # reopens 'wb'), interleaving appends and corrupting replay
        import fcntl

        self._lock_f = open(os.path.join(path, "kv.lock"), "w")
        try:
            fcntl.flock(self._lock_f, fcntl.LOCK_EX | fcntl.LOCK_NB)
        except OSError:
            self._lock_f.close()
            raise RuntimeError(
                f"KV store {path!r} is already owned by another live hub"
            )

    # -- recovery ------------------------------------------------------
    def load(self) -> Dict[bytes, bytes]:
        """Snapshot + replayed log -> table; then compact (rewrite the
        snapshot, truncate the log) so recovery cost stays bounded."""
        kv: Dict[bytes, bytes] = {}
        if os.path.exists(self._snap_path):
            try:
                with open(self._snap_path, "rb") as f:
                    kv = pickle.load(f)
            except Exception:
                kv = {}
        if os.path.exists(self._log_path):
            with open(self._log_path, "rb") as f:
                while True:
                    hdr = f.read(_LEN.size)
                    if len(hdr) < _LEN.size:
                        break
                    (n,) = _LEN.unpack(hdr)
                    blob = f.read(n)
                    if len(blob) < n:
                        break  # torn tail from a crash mid-append
                    try:
                        rec = pickle.loads(blob)
                    except Exception:
                        break
                    if rec[0] == "put":
                        kv[rec[1]] = rec[2]
                    elif rec[0] == "del":
                        kv.pop(rec[1], None)
        self._compact(kv)
        return kv

    def _compact(self, kv: Dict[bytes, bytes]) -> None:
        tmp = self._snap_path + ".tmp"
        with open(tmp, "wb") as f:
            pickle.dump(kv, f, protocol=pickle.HIGHEST_PROTOCOL)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self._snap_path)
        self._log = open(self._log_path, "wb")

    # -- mutation log --------------------------------------------------
    def _append(self, rec) -> None:
        if self._log is None:
            self._log = open(self._log_path, "ab")
        blob = pickle.dumps(rec, protocol=pickle.HIGHEST_PROTOCOL)
        self._log.write(_LEN.pack(len(blob)) + blob)
        self._log.flush()
        if self._fsync:
            os.fsync(self._log.fileno())

    def record_put(self, key: bytes, value: bytes) -> None:
        self._append(("put", key, value))

    def record_del(self, key: bytes) -> None:
        self._append(("del", key))

    def close(self) -> None:
        if self._log is not None:
            try:
                self._log.close()
            except OSError:
                pass
            self._log = None
        if self._lock_f is not None:
            try:
                self._lock_f.close()  # releases the flock
            except OSError:
                pass
            self._lock_f = None


def open_store(path: Optional[str], fsync: bool = False) -> Optional[FileKvStore]:
    if not path:
        return None
    return FileKvStore(path, fsync=fsync)
