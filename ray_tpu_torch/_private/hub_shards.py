"""Multi-reactor control plane: per-client reactor shards.

With ``RAY_TPU_TORCH_HUB_SHARDS`` > 1 the hub stops being one epoll reactor in
one thread and becomes N **reactor shards** plus one **state plane**:

    client conns ──┐
                   ├── shard 0 (thread: selector + wire codec + outbox)──┐
    client conns ──┘                                                     │
    client conns ──── shard 1 ───────────────────────────────────────────┤
        ...                                                              │ SPSC rings
    client conns ──── shard N-1 ─────────────────────────────────────────┤
                                                                         ▼
                          state plane (thread: scheduler+fairsched service,
                                       object-directory service, timers,
                                       flight recorder, metrics registry)

Each accepted connection is owned by exactly one shard: that shard's
selector polls it, that shard decodes its inbound frames (the PR 2 wire
codec fast path runs there), and that shard — and only that shard —
writes its outbound frames.  The scheduler (+ fairsched) and the object
directory live behind the state plane as single-thread-owned *state
services*: shards reach them exclusively through an in-process message
ring (``ShardRing``) — never by touching hub attributes (graftlint
GL010 polices exactly that).  Replies flow back the same way: the state
plane batches per-peer messages (the PR 2 outbox shape) and hands each
batch to the owning shard's outbound ring for encode + send.

Why one ordered ring per shard rather than one ring per (shard,
service): the wire protocol relies on per-connection FIFO (HELLO before
the first PUT decides ``_conn_node``; REGISTER_FUNCTION must precede a
SUBMIT_TASK naming the fn; STREAM_YIELD must precede STREAM_END).  A
connection's messages split across two independently-drained queues can
reorder across the service boundary, so the shard's dispatch table
*tags* each message with its owning service and the single ring
preserves arrival order end-to-end; the services themselves stay
single-consumer (SPSC holds: one shard producer, one state-plane
consumer per ring).

``RAY_TPU_TORCH_HUB_SHARDS=1`` (the default resolves to
``min(4, os.cpu_count())``, i.e. 1 on single-core hosts) keeps the
original single-reactor ``Hub._run`` loop — byte-for-byte the same wire
behavior, zero new threads.

Reference: this is the GCS/raylet split (gcs_server.h owning global
state, per-node raylets owning client traffic, reached by RPC) re-done
natively inside one process, per the PAPER.md L3/L4 layer map.
"""

from __future__ import annotations

import os
import selectors
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional

from .debug import log_exc
from .serialization import dumps_frame, loads_frame

# ---------------------------------------------------------------- routing
# msg_type -> owning state service.  The scheduler service owns task and
# actor placement, fairsched (jobs/tenants/quota/preemption), placement
# groups, nodes/workers, and introspection; the object-directory service
# owns the object/ownership tables, streams, kv, and pubsub fan-out.
# Shards build their per-connection dispatch tables from this map; an
# unknown message type defaults to the scheduler service (matching the
# monolithic hub, where unknown types are dropped by the handler table).
SCHEDULER_MSGS = frozenset({
    "hello", "submit_task", "submit_tasks", "task_done", "create_actor",
    "actor_ready",
    "submit_actor_task", "kill_actor", "cancel", "create_pg", "remove_pg",
    "pg_ready", "get_actor", "register_job", "register_node",
    "worker_exited", "node_heartbeat", "register_function", "get_function",
    "cluster_resources", "list_state", "shutdown", "span_record",
    "metric_record", "profile_batch", "stack_request", "stack_reply",
})
OBJECT_MSGS = frozenset({
    "put", "get", "wait", "free", "release_owned", "resolve_object",
    "replica_added", "subscribe_ready", "fetch_object", "obj_read_reply",
    "put_chunk", "stream_yield", "stream_end", "stream_next",
    "stream_credit", "kv_put", "kv_get", "kv_del", "kv_keys",
    "subscribe", "publish", "log_record",
})
SERVICE_OF: Dict[str, str] = {mt: "scheduler" for mt in SCHEDULER_MSGS}
SERVICE_OF.update({mt: "objects" for mt in OBJECT_MSGS})

# internal ring sentinels (never valid wire msg_types)
CONN_LOST = "__conn_lost__"
SHARD_EVENT = "__shard_event__"


def resolve_shard_count(config_value: int = 0) -> int:
    """0 = auto: min(4, cpu count). Clamped to >= 1."""
    n = int(config_value or 0)
    if n <= 0:
        n = min(4, os.cpu_count() or 1)
    return max(1, n)


class ShardRing:
    """SPSC message ring: ONE producer thread appends, ONE consumer
    thread drains.  deque append/popleft are GIL-atomic, so the ring
    itself needs no lock; ``wake`` signals the consumer (an Event.set
    for the state plane, a self-pipe write for a shard)."""

    __slots__ = ("_q", "_wake")

    def __init__(self, wake):
        self._q = deque()
        self._wake = wake

    def push(self, item) -> None:
        self._q.append(item)
        self._wake()

    def drain(self) -> list:
        q = self._q
        out = []
        while q:
            try:
                out.append(q.popleft())
            except IndexError:  # pragma: no cover - single consumer
                break
        return out

    def __len__(self) -> int:
        return len(self._q)


class StateService:
    """One single-thread-owned slice of hub state (scheduler+fairsched,
    or the object directory).  Everything it owns is mutated only on
    the state-plane thread; shards deliver work through the ring and
    this dispatch seam — the only supported way in (GL010)."""

    __slots__ = ("name", "_dispatch", "processed")

    def __init__(self, name: str, dispatch):
        self.name = name
        self._dispatch = dispatch  # bound hub handler (state-plane only)
        self.processed = 0

    def handle(self, conn, msg_type: str, payload) -> None:
        self.processed += 1
        self._dispatch(conn, msg_type, payload)


class ShardStats:
    """Per-shard reactor counters, written ONLY by the shard thread.
    The state plane reads them at scrape time (_merge_shard_metrics) —
    plain int/float loads, safe under the GIL — and renders them as
    builtin series with a ``shard`` label."""

    __slots__ = (
        "wakeups", "drain_saturated", "frames_sent", "flush_buckets",
        "flush_sum", "flush_count", "conns", "accepted", "backpressure",
    )

    # messages coalesced per outbound frame — THE shared constant (the
    # hub's _FLUSH_BOUNDS aliases this) so single-reactor and per-shard
    # flush histograms always carry identical boundaries
    FLUSH_BOUNDS = (1.0, 4.0, 16.0, 64.0, 128.0, 512.0)

    def __init__(self):
        self.wakeups = 0
        self.drain_saturated = 0
        self.frames_sent = 0
        self.flush_buckets = [0] * len(self.FLUSH_BOUNDS)
        self.flush_sum = 0.0
        self.flush_count = 0
        self.conns = 0
        self.accepted = 0
        self.backpressure = 0

    def observe_flush(self, n_msgs: int) -> None:
        self.frames_sent += 1
        self.flush_sum += n_msgs
        self.flush_count += 1
        for i, b in enumerate(self.FLUSH_BOUNDS):
            if n_msgs <= b:
                self.flush_buckets[i] += 1
                break


class ReactorShard(threading.Thread):
    """One reactor thread owning a subset of the hub's connections.

    Owns: its selector, its wake pipe, the sockets assigned to it, the
    wire codec for those sockets (decode inbound, encode outbound), and
    its per-connection dispatch table (msg_type -> state-service tag).

    Does NOT own — and must never touch (GL010) — any scheduler/object
    /fairsched/registry state: every decoded message is pushed onto
    ``state_ring`` and every reply arrives pre-batched on ``outbound``.

    Shard 0 additionally owns the accept socket and deals new
    connections round-robin to all shards via their ``adopt`` API.
    """

    def __init__(self, idx: int, state_ring: ShardRing, drain_budget: int,
                 listener=None, trace_on: bool = False):
        super().__init__(daemon=True, name=f"ray-tpu-hub-shard-{idx}")
        self.idx = idx
        self.stats = ShardStats()
        self._state_ring = state_ring
        self._drain_budget = drain_budget
        # runtime tracing live in this session? If so, stamp traced
        # inbound messages with the decode time so the state plane can
        # attribute ring-wait latency (it emits the span — this thread
        # only annotates the payload it already owns, GL010-clean).
        # False (sampling off) keeps the drain loop byte-identical.
        self._trace_on = trace_on
        self._listener = listener  # shard 0 only
        self._accept_seq = 0
        self.peers: List["ReactorShard"] = []  # set by the hub before start
        # control ring: ("adopt", conn) from the accepting shard
        self._inbox = ShardRing(self._wake)
        # outbound ring: (conn, [(msg_type, payload), ...]) batches from
        # the state plane; this shard encodes one frame per batch
        self.outbound = ShardRing(self._wake)
        self._wake_r, self._wake_w = os.pipe()
        os.set_blocking(self._wake_w, False)
        self._stopping = False
        # per-connection dispatch tables, built from the shared service
        # map; attached per-conn at adopt time so a future per-conn
        # override (e.g. a read-only client) costs nothing extra here
        self._routes: Dict[str, str] = dict(SERVICE_OF)
        self._conn_routes: Dict[Any, Dict[str, str]] = {}
        self._sel: Optional[selectors.BaseSelector] = None

    # ------------------------------------------------------------- control
    def _wake(self) -> None:
        try:
            os.write(self._wake_w, b"\0")
        except (BlockingIOError, OSError):
            pass  # pipe full = a wake is already pending; or shutting down

    def adopt(self, conn) -> None:
        """Hand a connection to this shard (called by the accepting
        shard, or by the hub for bookkeeping-free test injection)."""
        self._inbox.push(("adopt", conn))

    def expel(self, conn) -> None:
        """State plane -> this shard: forcibly drop one owned conn
        (chaos conn_kill / heartbeat-miss eviction). The unregister must
        happen on THIS thread (it owns the selector); cleanup flows back
        as CONN_LOST exactly like an organic EOF, and the state plane
        closes the socket after its registry sweep."""
        self._inbox.push(("expel", conn))

    def post(self, conn, msgs: list) -> None:
        """State plane -> this shard: one per-peer batch to encode+send."""
        self.outbound.push((conn, msgs))

    def stop(self) -> None:
        self._stopping = True
        self._wake()

    # -------------------------------------------------------------- reactor
    def run(self) -> None:  # pragma: no cover - exercised via Hub tests
        try:
            self._run_reactor()
        except Exception:
            log_exc(f"hub shard {self.idx} FATAL error")
            self._state_ring.push(
                (None, None, SHARD_EVENT,
                 {"kind": "shard_fatal", "shard": self.idx})
            )
            # a dead shard must not strand its peers: report every owned
            # connection lost so the state plane cleans their registries
            # and closes the sockets (clients see EOF instead of hanging
            # on a reactor that will never poll them again), and stops
            # posting replies into this shard's never-drained ring
            for conn in list(self._conn_routes):
                self._conn_routes.pop(conn, None)
                self._state_ring.push((conn, None, CONN_LOST, None))
        finally:
            sel = self._sel
            if sel is not None:
                try:
                    sel.close()
                except Exception:
                    pass
            # wake-pipe fds are NOT closed here: the state plane may
            # still call post()->_wake(), and writing into a recycled
            # fd number would corrupt whatever stream reused it. The
            # hub closes them via close_wakeups() after joining us.

    def close_wakeups(self) -> None:
        """Release the wake pipe. Only safe once no thread can call
        post()/adopt()/stop() on this shard again (hub teardown, after
        join) — a write into a recycled fd number is stream corruption."""
        for fd in (self._wake_r, self._wake_w):
            try:
                os.close(fd)
            except OSError:
                pass

    def _run_reactor(self) -> None:
        sel = self._sel = selectors.DefaultSelector()
        sel.register(self._wake_r, selectors.EVENT_READ, "__wake__")
        if self._listener is not None:
            lsock = self._listener._listener._socket
            sel.register(lsock, selectors.EVENT_READ, "__accept__")
        while True:
            events = sel.select(None)
            self.stats.wakeups += 1
            # backpressure check ONCE per wake: while the state plane is
            # behind the high-water mark, skip reading sockets (the fds
            # stay level-triggered readable; kernel buffers throttle the
            # peers) but keep accepting, adopting, and — crucially —
            # flushing outbound, since delivering replies is what lets
            # clients progress and the backlog drain.
            throttled = len(self._state_ring) > self.RING_HIGH_WATER
            if throttled:
                self.stats.backpressure += 1
            for key, _mask in events:
                tag = key.data
                if tag == "__wake__":
                    try:
                        os.read(self._wake_r, 65536)
                    except OSError:
                        pass
                elif tag == "__accept__":
                    self._accept()
                elif not throttled:
                    self._drain_conn(tag)
            self._drain_inbox(sel)
            self._flush_outbound()
            if self._stopping:
                self._flush_outbound()  # anything posted since the wake
                return
            if throttled:
                time.sleep(0.001)  # one nap per wake, replies already out

    def _accept(self) -> None:
        try:
            conn = self._listener.accept()
        except Exception:
            log_exc(f"hub shard {self.idx} accept error")
            return
        target = self.peers[self._accept_seq % len(self.peers)]
        self._accept_seq += 1
        self.stats.accepted += 1
        if target is self:
            self._register(self._sel, conn)
        else:
            target.adopt(conn)

    def _drain_inbox(self, sel) -> None:
        for op, conn in self._inbox.drain():
            if op == "adopt":
                self._register(sel, conn)
            elif op == "expel" and conn in self._conn_routes:
                self._drop_conn(conn)

    def _register(self, sel, conn) -> None:
        try:
            sel.register(conn, selectors.EVENT_READ, conn)
        except Exception:
            log_exc(f"hub shard {self.idx} register error")
            return
        self._conn_routes[conn] = self._routes
        self.stats.conns += 1

    def _drop_conn(self, conn) -> None:
        """EOF/error: leave the selector, tell the state plane.  The
        state plane closes the socket after its cleanup so the fd can't
        be reused by a racing accept while service state still maps it."""
        sel = self._sel
        if sel is not None:
            try:
                sel.unregister(conn)
            except (KeyError, ValueError, OSError):
                pass
        if self._conn_routes.pop(conn, None) is not None:
            self.stats.conns -= 1
        self._state_ring.push((conn, None, CONN_LOST, None))

    # state-ring high-water mark: the monolithic reactor bounded
    # in-flight work by handling inline (kernel socket buffers were the
    # queue); N decoding shards feeding one state plane need an explicit
    # bound or a submit storm grows the ring without limit (GL005's bug
    # class). Enforced once per reactor wake in _run_reactor.
    RING_HIGH_WATER = 8192

    def _drain_conn(self, conn) -> None:
        """Drain one peer's burst — the same bounded-fairness shape as
        the monolithic reactor — but every decoded message is routed to
        its state service's queue instead of being handled here."""
        routes = self._conn_routes.get(conn)
        if routes is None:
            routes = self._routes
        push = self._state_ring.push
        budget = self._drain_budget
        try:
            while True:
                blob = conn.recv_bytes()
                msg_type, payload = loads_frame(blob)
                if self._trace_on:
                    self._stamp_trace(msg_type, payload)
                # the dispatch table tags the message with its owning
                # state service; "batch" frames stay intact (tag None —
                # the state plane routes the inner messages, and the
                # chaos-drop hook checks the OUTER type, exactly as in
                # the single-reactor path)
                push((conn, routes.get(msg_type), msg_type, payload))
                budget -= len(payload) if msg_type == "batch" else 1
                if budget <= 0:
                    if conn.poll(0):
                        self.stats.drain_saturated += 1
                    break
                if not conn.poll(0):
                    break
        except (EOFError, OSError):
            self._drop_conn(conn)
        except Exception:
            log_exc(f"hub shard {self.idx} reactor error (dropping conn)")
            self._drop_conn(conn)

    @staticmethod
    def _stamp_trace(msg_type: str, payload) -> None:
        """Annotate traced messages with this shard's decode time so
        the state plane can emit the ring-wait span (hub._ring_wait_span
        pops the stamp). Runs only with tracing live; touches nothing
        but the payload this shard just decoded."""
        now = time.monotonic()
        if msg_type == "batch":
            for _mt, pl in payload:
                if type(pl) is dict and "trace" in pl:
                    pl["_ring_t"] = now
        elif type(payload) is dict and "trace" in payload:
            payload["_ring_t"] = now

    def _flush_outbound(self) -> None:
        for conn, msgs in self.outbound.drain():
            self.stats.observe_flush(len(msgs))
            try:
                if len(msgs) == 1:
                    conn.send_bytes(dumps_frame(msgs[0]))
                else:
                    conn.send_bytes(dumps_frame(("batch", msgs)))
            except (OSError, BrokenPipeError, EOFError):
                pass  # peer is going away; its read side will EOF soon
            except Exception:
                # an unpicklable reply must cost that one frame, never
                # the shard thread (which owns every other peer here)
                log_exc(f"hub shard {self.idx} outbound encode error")
