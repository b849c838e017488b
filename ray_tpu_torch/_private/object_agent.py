"""Per-node object-plane endpoint: out-of-band bulk object transfer.

The hub reactor is the control plane; routing multi-GB segment bytes
through it serializes every transfer behind one thread and every other
message behind the transfer (the exact failure mode "The Big Send-off"
describes for control-plane collectives). This agent is the data plane:
one listener per node, owned by the hub process on the head node and by
node_agent.py on remote hosts, serving two verbs over the PR 2 wire
codec (serialization.dumps_frame / loads_frame):

  ("obj_get", {name, fallback_spill_dir?})
      -> ("obj_data", {data, total, last})  * k   (8 MiB chunks)
      -> ("obj_error", {error})                   (missing/unreadable)

  ("obj_put", {name, data, last})  * k
      -> ("obj_put_ok", {size}) | ("obj_error", {error})
      Chunks append into a connection-private tmp file that is
      os.replace'd into the objects dir on the last chunk, so readers
      never observe a partial segment and a failed stream leaves
      nothing behind.

Consumers resolve the endpoint once through the hub's ownership
directory (protocol.RESOLVE_OBJECT) and cache it; any transfer error
falls back to the hub-relay path (FETCH_OBJECT / PUT_CHUNK), so the
agent can die mid-stream without losing data — only bandwidth.

Reference analogue: src/ray/object_manager/object_manager.h (push/pull
between plasma stores over its own RPC service, never through the GCS).

Chaos hook: a ``close_after:N`` directive in the RAY_TPU_TORCH_CHAOS_PLAN
(legacy alias: RAY_TPU_TORCH_CHAOS_OBJECT_AGENT="close_after:N") closes every
connection after serving N data chunks — the tier-1 harness for
"serving peer dies mid-transfer" (tests/test_object_plane.py). The
agent hosts the "object_agent" scope of the chaos engine (chaos.py).
"""

from __future__ import annotations

import os
import threading
from multiprocessing.connection import Listener
from typing import Optional, Tuple

from . import protocol as P
from .debug import log_exc
from .serialization import dumps_frame, loads_frame

CHUNK = 8 * 1024 * 1024


def pull_segment_bytes(endpoint: str, name: str) -> bytes:
    """One-shot direct pull of a whole segment into memory.

    The lightweight consumer path for serve response payloads
    (serve/_private/payloads.py): a proxy/handle reading a one-shot
    response body has no use for the full CoreClient fetch dance —
    store install, REPLICA_ADDED registration, resolve caching,
    connection pooling — so this helper opens ONE connection, streams
    the segment, and returns the assembled bytes (decode with
    object_store.decode_segment_bytes). Raises on ANY irregularity;
    callers fall back to the full client fetch path, which ends in the
    hub relay.
    """
    from .client import connect_hub

    conn = connect_hub(endpoint)
    try:
        conn.send_bytes(dumps_frame((P.OBJ_GET, {"name": name})))
        out = bytearray()
        total = None
        while True:
            msg_type, p = loads_frame(conn.recv_bytes())
            if msg_type == P.OBJ_ERROR:
                raise OSError(p.get("error") or "agent fetch failed")
            if msg_type != P.OBJ_DATA:
                raise OSError(f"unexpected frame {msg_type}")
            out += p["data"]
            total = p.get("total", total)
            if p.get("last"):
                break
        if total is not None and len(out) != total:
            raise OSError(
                f"short object-agent stream: {len(out)}/{total} bytes"
            )
        return bytes(out)
    finally:
        try:
            conn.close()
        except Exception:
            pass


class ObjectAgent:
    """Serve shm-segment reads/writes for one node's object directory.

    Thread-per-connection blocking IO: transfers are few and long, the
    per-chunk work is kernel bulk copies that release the GIL, and a
    slow peer then stalls only its own thread — a property no control-
    plane reactor (the single hub loop, or a reactor shard in the
    RAY_TPU_TORCH_HUB_SHARDS>1 topology, hub_shards.py) should offer: bulk
    bytes on a reactor thread would park every peer's dispatch behind a
    memcpy.
    """

    def __init__(self, objects_dir: str, spill_dir: str = "",
                 host: str = "127.0.0.1", port: int = 0,
                 unix_path: Optional[str] = None):
        self.objects_dir = objects_dir
        self.spill_dir = spill_dir
        if unix_path is not None:
            self.listener = Listener(unix_path, family="AF_UNIX")
            self.endpoint = unix_path
        else:
            self.listener = Listener((host, port), family="AF_INET")
            lhost, lport = self.listener.address
            self.endpoint = f"tcp://{lhost}:{lport}"
        # transfer counters, sampled by the owner's heartbeat into the
        # ray_tpu_object_direct_* builtin metrics. Plain ints mutated
        # under _stats_lock: serving threads increment, the hub/agent
        # heartbeat thread reads.
        self._stats_lock = threading.Lock()
        self.bytes_served = 0
        self.bytes_received = 0
        self.transfers = 0
        from . import chaos as _chaos_mod

        eng = _chaos_mod.engine_for("object_agent")
        self._chaos = eng
        self._chaos_close_after = eng.close_after if eng is not None else 0
        self._closed = False
        self._accept_thread = threading.Thread(
            target=self._accept_loop, daemon=True, name="object-agent-accept"
        )
        self._accept_thread.start()

    # ------------------------------------------------------------- serving
    def _accept_loop(self) -> None:
        while not self._closed:
            try:
                conn = self.listener.accept()
            except OSError:
                return  # listener closed
            except Exception:
                if self._closed:
                    return
                log_exc("object agent accept error")
                continue
            threading.Thread(
                target=self._serve_conn, args=(conn,), daemon=True,
                name="object-agent-conn",
            ).start()

    def _path(self, name: str) -> Optional[str]:
        """Resolve a segment name inside the objects/spill dirs only —
        a peer-supplied name must not escape them."""
        if not name or os.sep in name or name.startswith("."):
            return None
        path = os.path.join(self.objects_dir, name)
        if os.path.exists(path):
            return path
        if self.spill_dir:
            spilled = os.path.join(self.spill_dir, name)
            if os.path.exists(spilled):
                return spilled
        return path  # open() will raise; caller reports obj_error

    def _serve_conn(self, conn) -> None:
        chunks_left = self._chaos_close_after or -1
        put_state: Optional[Tuple[str, str, object]] = None  # (name, tmp, file)
        try:
            while True:
                msg_type, p = loads_frame(conn.recv_bytes())
                if msg_type == P.OBJ_GET:
                    chunks_left = self._serve_get(conn, p, chunks_left)
                    if chunks_left == 0:
                        self._chaos.record("close_after")
                        return  # chaos: simulated mid-stream death
                elif msg_type == P.OBJ_PUT:
                    put_state = self._serve_put(conn, p, put_state)
                    if chunks_left > 0:
                        chunks_left -= 1
                        if chunks_left == 0:
                            self._chaos.record("close_after")
                            return  # chaos: simulated mid-stream death
                else:
                    conn.send_bytes(dumps_frame(
                        (P.OBJ_ERROR, {"error": f"unknown verb {msg_type}"})
                    ))
        except (EOFError, OSError, ValueError):
            pass  # peer gone / torn frame: drop the connection
        except Exception:
            log_exc("object agent connection error")
        finally:
            if put_state is not None:
                # incomplete inbound stream: drop the partial tmp file
                try:
                    put_state[2].close()
                    os.unlink(put_state[1])
                except OSError:
                    pass
            try:
                conn.close()
            except Exception:
                pass

    def _serve_get(self, conn, p, chunks_left: int) -> int:
        path = self._path(p.get("name", ""))
        try:
            f = open(path, "rb") if path else None
            if f is None:
                raise OSError("bad segment name")
        except OSError as err:
            conn.send_bytes(dumps_frame((P.OBJ_ERROR, {"error": str(err)})))
            return chunks_left
        with f:
            total = os.fstat(f.fileno()).st_size
            sent = 0
            while True:
                data = f.read(CHUNK)
                sent += len(data)
                last = sent >= total
                conn.send_bytes(dumps_frame(
                    (P.OBJ_DATA, {"data": data, "total": total, "last": last})
                ))
                if chunks_left > 0:
                    chunks_left -= 1
                    if chunks_left == 0:
                        return 0  # chaos trip: caller closes the conn
                if last:
                    break
        with self._stats_lock:
            self.bytes_served += total
            self.transfers += 1
        return chunks_left

    def _serve_put(self, conn, p, put_state):
        name = p.get("name", "")
        safe = name and os.sep not in name and not name.startswith(".")
        if put_state is None:
            if not safe:
                conn.send_bytes(dumps_frame(
                    (P.OBJ_ERROR, {"error": f"bad segment name {name!r}"})
                ))
                return None
            os.makedirs(self.objects_dir, exist_ok=True)
            tmp = os.path.join(
                self.objects_dir, f".direct.{threading.get_ident():x}.{name}"
            )
            put_state = (name, tmp, open(tmp, "wb"))
        elif put_state[0] != name:
            conn.send_bytes(dumps_frame(
                (P.OBJ_ERROR, {"error": "interleaved puts on one connection"})
            ))
            return put_state
        put_state[2].write(p["data"])
        if p.get("last"):
            name, tmp, f = put_state
            size = f.tell()
            f.close()
            os.replace(tmp, os.path.join(self.objects_dir, name))
            with self._stats_lock:
                self.bytes_received += size
                self.transfers += 1
            conn.send_bytes(dumps_frame((P.OBJ_PUT_OK, {"size": size})))
            return None
        return put_state

    # ------------------------------------------------------------ lifecycle
    def stats(self) -> dict:
        with self._stats_lock:
            return {
                "bytes_served": self.bytes_served,
                "bytes_received": self.bytes_received,
                "transfers": self.transfers,
            }

    def close(self) -> None:
        self._closed = True
        try:
            self.listener.close()
        except Exception:
            pass
