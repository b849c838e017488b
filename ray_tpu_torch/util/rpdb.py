"""Remote pdb: breakpoints inside tasks/actors, attachable from the driver.

Parity: python/ray/util/rpdb.py — the reference's ``ray.util.pdb
.set_trace()`` opens a socket-backed pdb in the worker, advertises it
in internal KV, and ``ray debug`` connects a terminal. Same design:
``set_trace()`` listens on an ephemeral TCP port, registers
``__rpdb:<uuid>`` → {host, port, pid} in hub KV, and blocks until a
debugger attaches; ``list_breakpoints()`` / ``connect()`` are the
driver side (the reference's CLI loop, minus curses).
"""

from __future__ import annotations

import json
import os
import pdb
import socket
import sys
import uuid as _uuid
from typing import Dict, List, Optional

_KV_PREFIX = b"__rpdb:"


class _RemotePdb(pdb.Pdb):
    """Pdb over an accepted socket connection (reference _PdbWrap)."""

    def __init__(self, sock: socket.socket):
        self._sock = sock
        self._fh = sock.makefile("rw", buffering=1)
        super().__init__(stdin=self._fh, stdout=self._fh)
        self.use_rawinput = False
        self.prompt = "(ray_tpu_torch-pdb) "

    def close(self):
        try:
            self._fh.close()
            self._sock.close()
        except OSError:
            pass

    # Detach (close the socket) when the user resumes the program —
    # there is no later point to hook: after `continue` the worker is
    # back in user code and nothing else touches the debugger object.
    def do_continue(self, arg):
        ret = super().do_continue(arg)
        if not self.breaks:
            self.close()
        return ret

    do_c = do_cont = do_continue

    def do_quit(self, arg):
        ret = super().do_quit(arg)
        self.close()
        return ret

    do_q = do_exit = do_quit

    def __del__(self):
        self.close()


def _register(entry_uuid: str, port: int) -> None:
    from ray_tpu_torch._private import worker

    client = worker.get_client()
    meta = {
        "host": os.environ.get("RAY_TPU_TORCH_NODE_IP", "127.0.0.1"),
        "port": port,
        "pid": os.getpid(),
    }
    client.kv_put(_KV_PREFIX + entry_uuid.encode(), json.dumps(meta).encode())


def _deregister(entry_uuid: str) -> None:
    from ray_tpu_torch._private import worker

    try:
        worker.get_client().kv_del(_KV_PREFIX + entry_uuid.encode())
    except Exception:
        pass


def set_trace(frame=None) -> None:
    """Block this task at a breakpoint until a debugger attaches."""
    entry_uuid = _uuid.uuid4().hex[:8]
    listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    try:
        listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        listener.bind(("0.0.0.0", 0))
        listener.listen(1)
        port = listener.getsockname()[1]
        _register(entry_uuid, port)
        print(
            f"ray_tpu_torch breakpoint {entry_uuid} waiting on port {port} "
            f"(pid={os.getpid()}); attach with ray_tpu_torch.util.rpdb.connect()",
            file=sys.stderr,
        )
        conn, _ = listener.accept()
    finally:
        listener.close()
        _deregister(entry_uuid)
    dbg = _RemotePdb(conn)
    # Must be the last statement: Pdb.set_trace(frame) arms tracing and
    # returns immediately — the first stop is the next line event, which
    # must be in the caller's frame, not in a finally block here.
    dbg.set_trace(frame or sys._getframe().f_back)


def post_mortem() -> None:
    """Debug the exception currently being handled (reference
    rpdb.post_mortem via RAY_PDB_POST_MORTEM)."""
    exc = sys.exc_info()[2]
    if exc is None:
        raise RuntimeError("post_mortem() called with no active exception")
    entry_uuid = _uuid.uuid4().hex[:8]
    listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    listener.bind(("0.0.0.0", 0))
    listener.listen(1)
    _register(entry_uuid, listener.getsockname()[1])
    try:
        conn, _ = listener.accept()
    finally:
        listener.close()
        _deregister(entry_uuid)
    dbg = _RemotePdb(conn)
    try:
        dbg.interaction(None, exc)
    finally:
        dbg.close()


def list_breakpoints() -> List[Dict]:
    """Active breakpoints cluster-wide (the reference's `ray debug`
    selection list)."""
    from ray_tpu_torch._private import worker

    client = worker.get_client()
    out = []
    for key in client.kv_keys(_KV_PREFIX):
        raw = client.kv_get(key)
        if raw:
            meta = json.loads(raw)
            meta["uuid"] = key[len(_KV_PREFIX):].decode()
            out.append(meta)
    return out


def connect(
    breakpoint_uuid: Optional[str] = None,
    stdin=None,
    stdout=None,
) -> None:
    """Attach the current terminal (or the given streams — used by
    tests) to a waiting breakpoint and relay until the session ends."""
    bps = list_breakpoints()
    if not bps:
        raise RuntimeError("no active ray_tpu_torch breakpoints")
    if breakpoint_uuid is not None:
        bps = [b for b in bps if b["uuid"] == breakpoint_uuid]
        if not bps:
            raise RuntimeError(f"breakpoint {breakpoint_uuid} not found")
    meta = bps[0]
    sock = socket.create_connection((meta["host"], meta["port"]), timeout=30)
    t = None
    try:
        stdin = stdin if stdin is not None else sys.stdin
        stdout = stdout if stdout is not None else sys.stdout
        fh = sock.makefile("rw", buffering=1)
        import threading

        def _pump_out():
            try:
                for line in fh:
                    stdout.write(line)
                    stdout.flush()
            except (OSError, ValueError):
                pass

        t = threading.Thread(target=_pump_out, daemon=True)
        t.start()
        for line in stdin:
            try:
                fh.write(line)
                fh.flush()
            except (OSError, ValueError):
                break
    finally:
        # Drain remaining debugger output first: the remote end closes
        # the socket when the session finishes (continue/quit), which
        # ends the pump; closing before that loses the tail.
        if t is not None:
            t.join(timeout=10)
        try:
            sock.close()
        except OSError:
            pass
