"""Core client: the per-process endpoint talking to the control hub.

This is the analogue of the reference's CoreWorker (reference:
src/ray/core_worker/core_worker.h:166) — one instance per driver or
worker process. It owns:
  - the hub connection + a reader thread that demultiplexes inbound
    messages (task assignments vs request replies),
  - the local view of the shm object store,
  - an inline-object cache (objects are immutable, so caching is safe).

Both the driver and workers use this same class; workers additionally
run an executor loop (worker_process.py) fed from `task_queue`.

Submit templates and auto-batching (client hot path, round 3): a plain
``.remote()`` call no longer builds or pickles a payload dict. The
RemoteFunction's template caches the invariant frame PREFIX — fn_id,
canonical resources, job-stamped scheduling options, the pipeline
flag — as raw pickle opcodes (serialization.submit_frame_prefix), and
``submit_batched`` splices only the per-call task id, arg blob, and
deps (serialization.task_entry_fragment) into a pending SUBMIT_TASKS
frame. Calls to the same template within
``submit_autobatch_window_us`` coalesce into ONE bulk frame, drained
by the flusher timer, by capacity (_AB_MAX), or by ANY other outbound
message — so per-connection FIFO holds against interleaved singles,
actor calls, and puts. ObjectRefs return synchronously before the
flush; delivery rides the same _unacked_bulk retransmit + hub
per-task dedup contract as submit_many. A drain that catches exactly
one buffered call degrades to the classic SUBMIT_TASK frame (same hub
handler as window=0, no bulk ack machinery), so sync round trips
don't pay the batch tax. The window only delays the wire flush, never
the caller.
"""

from __future__ import annotations

import contextlib
import itertools
import os
import queue
import random
import threading
import time
from concurrent.futures import Future
from multiprocessing.connection import Client as MpClient
from typing import Any, Dict, List, Optional, Sequence, Tuple

from .. import exceptions
from . import protocol as P
from .debug import log_exc
from .ids import ActorID, ObjectID, TaskID, id_pair, id_slab
from .object_store import INLINE_THRESHOLD, ShmObjectStore
from .serialization import (
    close_submit_frame,
    dumps_frame,
    dumps_inline,
    loads_frame,
    loads_inline,
    task_entry_fragment,
)


# Per-CALL job identity override for worker processes: an actor with
# max_concurrency > 1 serves callers from different tenants at once, so
# identity must live in the execution context (one per pool thread /
# asyncio task), never in shared CoreClient fields — or caller A's
# nested submits get stamped with caller B's tenant and quota.
# worker_process._adopt_job_identity sets it; _stamp_job reads it first.
from contextvars import ContextVar

_job_identity: ContextVar = ContextVar("ray_tpu_job_identity", default=None)


def connect_hub(addr: str):
    """Dial the hub: "tcp://host:port" (cluster mode) or an AF_UNIX path."""
    if addr.startswith("tcp://"):
        host, port = addr[6:].rsplit(":", 1)
        return MpClient((host, int(port)), family="AF_INET")
    return MpClient(addr, family="AF_UNIX")


class CoreClient:
    def __init__(self, hub_addr: str, session_dir: str, role: str, worker_id: str):
        self.role = role
        self.worker_id = worker_id
        self.session_dir = session_dir
        self.node_id = os.environ.get("RAY_TPU_TORCH_NODE_ID", "node0")
        # effective hostname for same-host transfer decisions: the
        # simulated-cluster harness fakes per-node hostnames, so two
        # "nodes" on one machine still exercise the socket path
        import socket as _socket

        self.hostname = (
            os.environ.get("RAY_TPU_TORCH_NODE_HOSTNAME") or _socket.gethostname()
        )
        self.store = ShmObjectStore(session_dir)
        self.conn = connect_hub(hub_addr)
        # fault injection (chaos.py): this process's scope of the
        # cluster chaos plan — outbound message drop/delay/dup. None
        # (the default) keeps the send paths at one attribute load.
        from . import chaos as _chaos_mod

        self._chaos = _chaos_mod.engine_for(
            "worker" if role == "worker" else "client"
        )
        # retransmit backoff knobs from the config table
        # (request_retry_period_s / request_retry_max_s env or .set()
        # overrides). Instance attrs shadow the class defaults only on
        # an explicit non-default override, so tests can still
        # monkeypatch the class attributes. period <= 0 = retransmit
        # OFF (requests wait on their first send), matching the repo's
        # 0-disables convention.
        from .config import RAY_TPU_TORCH_CONFIG as _cfg
        from .config import _DEFAULTS as _cfg_defaults

        try:
            stock = float(_cfg_defaults["request_retry_period_s"])
            base = float(_cfg.get("request_retry_period_s", stock))
            if base != stock:
                self._RETRY_PERIOD_S = base
            stock = float(_cfg_defaults["request_retry_max_s"])
            cap = float(_cfg.get("request_retry_max_s", stock))
            if cap != stock:
                self._RETRY_MAX_S = cap
        except (TypeError, ValueError, KeyError):
            pass  # malformed override: keep the defaults
        self._send_lock = threading.Lock()
        self._send_buf: List[tuple] = []
        self._buf_evt = threading.Event()
        # adaptive outbound coalescing (mirrors the hub's outbox
        # batching): the inline-flush threshold starts small so a
        # trickle of messages drains promptly, widens ×2 each time a
        # burst fills the window (fewer syscalls per message while the
        # producer is outrunning the drain), and decays when timer
        # flushes see small batches. _buf_cost tracks payload bytes for
        # size-aware flushing — a few large puts must not wait out the
        # message-count window.
        self._coalesce_msgs = 32
        self._buf_cost = 0
        # >0 while inside batch_window(): count-based flushes are held
        # so a caller-visible burst (ActorPool.map) leaves as few
        # frames as possible; the byte ceiling still applies.
        self._window_depth = 0
        # transparent auto-batching (see module docstring): spliced
        # task fragments pending under _send_lock, keyed by the
        # template prefix OBJECT (same template+identity reuses the
        # same cached bytes, so `is` is the batch key) and the trace
        # context of the calls. Drained by _drain_autobatch_locked.
        try:
            window_us = int(_cfg.get("submit_autobatch_window_us", 300))
        except (TypeError, ValueError):
            window_us = 300
        self._ab_window_s = max(0.0, window_us / 1e6)
        self._ab_prefix: Optional[bytes] = None
        self._ab_base: Optional[dict] = None
        self._ab_trace: Optional[tuple] = None
        self._ab_frags: List[bytes] = []
        # singleton fast path: the (task_id, kind, payload, deps, rid)
        # of the FIRST buffered call, kept only while it is alone — a
        # one-call drain degrades to the classic SUBMIT_TASK frame and
        # skips the bulk ack machinery (see _drain_autobatch_locked)
        self._ab_single: Optional[tuple] = None
        # bulk-submit ack tracking: req_id -> [future, payload,
        # next_resend_t, backoff]. SUBMIT_TASKS is fire-and-forget for
        # the caller, so the flusher thread owns the retransmit
        # schedule (see _scan_unacked); the hub's per-task dedup makes
        # replays safe. FIFO-bounded.
        self._unacked_bulk: Dict[int, list] = {}
        # registration epoch: RemoteFunction memoizes its export
        # against this value, so a reconnect (shutdown + re-init = a
        # NEW CoreClient with a fresh epoch) naturally invalidates
        # every cached registration
        self.client_epoch = next(CoreClient._EPOCH_COUNTER)
        # ownership-GC release ids, appended from ObjectRef.__del__.
        # __del__ can run at ANY allocation point — including while THIS
        # thread already holds _send_lock (GC during dumps_inline) — so
        # the only safe operation there is a plain list.append (GIL-
        # atomic, lock-free). The flusher thread drains it.
        self._release_buf: List[bytes] = []
        self._req_counter = itertools.count()
        self._pending: Dict[int, Future] = {}
        self._pending_lock = threading.Lock()
        self._obj_cache: Dict[bytes, Any] = {}
        self._obj_cache_lock = threading.Lock()
        # object ids known ready (from wait replies); insertion-ordered
        # for FIFO bounding. Cleared per-id by free().
        self._known_ready: Dict[bytes, bool] = {}
        self._seen_fns: Dict[str, Any] = {}
        self.task_queue: "queue.Queue" = queue.Queue()
        self.cancelled_tasks: set = set()  # task_ids to drop at dequeue
        # client mode (ray_tpu_torch.init(address=...)): no shared shm with
        # the cluster — small puts travel inline through the hub
        # connection, large ones chunk-stream into the head-node store
        # (encode_value / _fetch_segment_chunked)
        self.inline_only = False
        # ---- out-of-band object plane (object_agent.py): resolve an
        # object's location once through the hub directory, then move
        # the bytes peer<->peer over the owner node's object-agent
        # endpoint. Any direct-path error falls back to the hub relay.
        self._direct_enabled = os.environ.get(
            "RAY_TPU_TORCH_OBJECT_DIRECT", "1"
        ).lower() not in ("0", "false", "no")
        # oid -> RESOLVE_OBJECT reply; invalidated by the __obj_freed__
        # and __node_down__ pubsub channels, FIFO-bounded like
        # _known_ready (insertion-ordered dict)
        self._resolve_cache: Dict[bytes, dict] = {}
        # endpoint -> [idle connection, ...]; a transfer checks a
        # connection out for its whole duration (the agent serves one
        # verb at a time per connection)
        self._agent_pool: Dict[str, List[Any]] = {}
        self._agent_pool_lock = threading.Lock()
        # head node's object-agent endpoint for direct puts:
        # None = not resolved yet, "" = unavailable (stay on the relay)
        self._head_agent_endpoint: Optional[str] = None
        # ---- readiness push: wait() subscribes once per unknown ref
        # set; the hub pushes ready ids as tasks finish (P.READY_PUSH),
        # the reader thread records them in _known_ready and pokes this
        # event to re-scan any parked wait()
        self._ready_push = os.environ.get(
            "RAY_TPU_TORCH_READY_PUSH", "1"
        ).lower() not in ("0", "false", "no")
        self._ready_evt = threading.Event()
        # ids this client has already registered for push (cross-call
        # memo): a pop-loop's dry calls must not re-send the same 1k-id
        # subscription per push batch. Entries leave when the push
        # arrives (_on_ready_push) or on free; a stalled wait clears
        # its ids to force a re-sync (_wait_push retry period).
        self._ready_subscribed: set = set()
        # ---- runtime tracing (util/tracing.py): head-sampling rate for
        # this process's API calls. 0 (the default) keeps the hot paths
        # nearly untouched: _tracing_live() gates all tracing work
        # behind one attribute load + one contextvar read, and no
        # "trace" field ever enters a payload.
        from ..util import tracing as _tracing

        self._trace_rate = _tracing.runtime_sample_rate()
        self._trace_on = self._trace_rate > 0.0
        # pre-bound span-record send path: the sampled hot path builds
        # its record inline and calls these bound symbols instead of
        # re-importing util.tracing and re-reading os.getpid() per span
        # (the tracing_overhead bench row measures exactly this loop)
        self._pid = os.getpid()
        self._wall_at = _tracing.wall_at
        from .ids import span_id_hex as _span_id_hex

        self._span_id_hex = _span_id_hex
        # ambient-context probe, bound once: even with THIS process's
        # sampling off, a live trace context (a traced task executing
        # here while only the submitting driver samples — the hub and
        # worker span paths are payload-driven) must keep stitching
        self._trace_ctx = _tracing.current_context
        # return-object id -> (trace_id, submit_span_id) for sampled
        # submits, so the get() that collects a traced task's result
        # joins its trace. FIFO-bounded like _resolve_cache.
        self._trace_refs: Dict[bytes, tuple] = {}
        # multi-tenant scheduling identity (set by register_job): every
        # submit/PG-create from this client is stamped with it so the
        # hub's fairsched engine can order/quota/preempt per tenant
        self.job_id: Optional[str] = None
        self.tenant: Optional[str] = None
        self.priority: int = 0
        # pubsub: channel -> callback(data); callbacks run on the reader
        # thread, so keep them light (print/enqueue)
        self.subscriptions: Dict[str, Any] = {}
        self._closed = False
        # inbound dispatch table (the hub-side _handlers symmetric):
        # resolved once here instead of a per-message if/elif chain on
        # the reader thread
        self._inbound_handlers = {
            P.REPLY: self._on_reply,
            P.PUBSUB_MSG: self._on_pubsub_msg,
            P.CANCEL_TASK: self._on_cancel_task,
            P.READY_PUSH: self._on_ready_push,
            P.STACK_DUMP: self._on_stack_dump,
        }
        self.send(P.HELLO, {"role": role, "worker_id": worker_id,
                            "pid": os.getpid(), "node_id": self.node_id})
        # shm frees anywhere in the cluster invalidate the local wait()
        # readiness cache (otherwise a freed object reports ready here
        # indefinitely; the follow-up get would raise ObjectLostError)
        self.subscriptions["__obj_freed__"] = self._on_objs_freed
        self.send(P.SUBSCRIBE, {"channel": "__obj_freed__"})
        # node loss invalidates cached object locations (stale-endpoint
        # reads must fail over to re-resolve / hub relay, never hang on
        # a dead host)
        self.subscriptions["__node_down__"] = self._on_node_down
        self.send(P.SUBSCRIBE, {"channel": "__node_down__"})
        self._reader = threading.Thread(target=self._read_loop, daemon=True, name="core-client-reader")
        self._reader.start()

        self._flusher = threading.Thread(target=self._flush_loop, daemon=True, name="core-client-flusher")
        self._flusher.start()

        # sampling profiler (profiling.py): with RAY_TPU_TORCH_PROFILE_HZ at
        # its default 0 this creates NOTHING — no thread, no wire
        # frames (the tier-1 zero-cost guard asserts it). Batches ride
        # the buffered async channel like metric records. In the local
        # driver the hub thread may already own the process sampler;
        # first caller wins either way.
        from . import profiling as _profiling

        _profiling.maybe_start(role, self._profile_sink)

    def start_prewarm(self, store_cap: float = 0.0) -> None:
        """Kick the background warm-pool prewarm (driver only; see
        object_store.prewarm). Disabled when the node runs a bounded
        object store — pool files live outside the cap's accounting,
        and a capped deployment is memory-constrained by definition."""
        from .config import RAY_TPU_TORCH_CONFIG

        nbytes = int(os.environ.get(
            "RAY_TPU_TORCH_SEGMENT_PREWARM_BYTES",
            RAY_TPU_TORCH_CONFIG.segment_prewarm_bytes,
        ))
        if nbytes > 0 and store_cap <= 0 and not self.inline_only:
            threading.Thread(
                target=self.store.prewarm, args=(nbytes,),
                daemon=True, name="segment-prewarm",
            ).start()

    # ------------------------------------------------------------------ wire
    #
    # Two send paths: `send` (immediate, flushes any buffered messages first
    # so total order is preserved) and `send_async` (buffered). Buffering
    # coalesces submit storms into one syscall + one hub wakeup per batch —
    # this matters because the hub thread shares the driver's GIL; without
    # batching every message pays a GIL handoff (~sys.getswitchinterval()).
    def send(self, msg_type: str, payload: dict) -> None:
        if self._chaos is not None:
            # 0 = injected drop (the retransmit layer must recover),
            # 2 = duplicate delivery (hub dedup/idempotency must hold)
            n = self._chaos.outbound_send(msg_type)
            if n == 0:
                return
            if n == 2:
                self._send_one(msg_type, payload)  # the duplicate
        self._send_one(msg_type, payload)

    def _send_one(self, msg_type: str, payload: dict) -> None:
        with self._send_lock:
            if self._ab_frags:
                # FIFO: the pending auto-batch predates this message
                self._drain_autobatch_locked()
            if self._send_buf:
                buf, self._send_buf = self._send_buf, []
                self._buf_cost = 0
                buf.append((msg_type, payload))
                self.conn.send_bytes(dumps_frame(("batch", buf)))
            else:
                self.conn.send_bytes(dumps_frame((msg_type, payload)))

    def send_async(self, msg_type: str, payload: dict,
                   cost: int = 0) -> None:
        """Buffered send. ``cost`` is the caller's estimate of the
        payload's wire size when it knows it (put_value passes the
        encoded value size); the buffer flushes early once accumulated
        cost crosses _COALESCE_MAX_BYTES, so big payloads don't sit
        out the message-count window."""
        dup = False
        if self._chaos is not None:
            k = self._chaos.outbound_send(msg_type)
            if k == 0:
                return
            dup = k == 2
        with self._send_lock:
            if self._ab_frags:
                # FIFO: older auto-batched submits leave first
                self._drain_autobatch_locked()
            was_empty = not self._send_buf
            self._send_buf.append((msg_type, payload))
            if dup:
                # duplicate appended under the SAME acquisition so the
                # buffer-empty wake below still fires for this batch
                self._send_buf.append((msg_type, payload))
            self._buf_cost += cost
            if ((len(self._send_buf) >= self._coalesce_msgs
                    and self._window_depth == 0)
                    or self._buf_cost >= self._COALESCE_MAX_BYTES):
                buf, self._send_buf = self._send_buf, []
                self._buf_cost = 0
                if len(buf) >= self._coalesce_msgs:
                    # the producer filled the window before the flusher
                    # woke: widen it so a sustained burst pays fewer
                    # syscalls (and fewer hub wakeups) per message
                    self._coalesce_msgs = min(
                        self._coalesce_msgs * 2, self._COALESCE_CEIL
                    )
                self.conn.send_bytes(dumps_frame(("batch", buf)))
                return
        if was_empty:
            self._buf_evt.set()

    def flush(self) -> None:
        with self._send_lock:
            if self._ab_frags:
                # drain BEFORE the release buffer: an owner-GC release
                # must never overtake the submit that referenced the id
                self._drain_autobatch_locked()
            if self._release_buf:
                # swap-then-drain: concurrent __del__ appends land either
                # in the drained list (sent now) or the fresh one (next
                # flush) — nothing is lost, no lock needed on their side
                drained = self._release_buf
                self._release_buf = []
                self._send_buf.append(
                    (P.RELEASE_OWNED, {"object_ids": drained})
                )
            if self._send_buf:
                buf, self._send_buf = self._send_buf, []
                self._buf_cost = 0
                self.conn.send_bytes(dumps_frame(("batch", buf)))
                if len(buf) * 4 <= self._coalesce_msgs:
                    # a timer/explicit drain caught a small batch: the
                    # burst is over — decay the window so the next
                    # trickle of messages flushes promptly again
                    self._coalesce_msgs = max(
                        self._COALESCE_FLOOR, self._coalesce_msgs // 2
                    )

    @contextlib.contextmanager
    def batch_window(self):
        """Hold count-based coalescing flushes while a caller-visible
        burst is produced (ActorPool.map submits N actor tasks that
        cannot ride a SUBMIT_TASKS frame); on exit the whole burst is
        drained in one flush. The byte ceiling still flushes mid-window
        so a burst of large payloads can't buffer unboundedly. Safe to
        nest; the background flusher may still drain on its timer, which
        only costs an extra frame, never reorders (per-conn FIFO)."""
        with self._send_lock:
            self._window_depth += 1
        try:
            yield
        finally:
            with self._send_lock:
                self._window_depth -= 1
            self.flush()

    def submit_batched(self, prefix: bytes, base: dict, args_kind: str,
                       args_payload: bytes, arg_deps: List[bytes],
                       trace_ctx: Optional[tuple] = None) -> bytes:
        """One plain ``.remote()`` call riding the auto-batch window:
        splice a hand-emitted task fragment under the template's frame
        prefix and return the return-object id immediately. The frame
        ships on the next drain — flusher timer (_ab_window_s), the
        _AB_MAX capacity bound, or any other outbound message (FIFO).
        A different template or trace context drains the pending batch
        first, so one frame only ever carries one template's calls."""
        tid, rid = id_pair()
        frag = task_entry_fragment(tid, args_kind, args_payload,
                                   arg_deps, (rid,))
        if trace_ctx is not None:
            # outside _send_lock (takes _obj_cache_lock); remembered
            # against the ambient context — the batch span minted at
            # drain time is this call's sibling, not known yet
            self._trace_remember((rid,), trace_ctx)
        first = False
        with self._send_lock:
            if self._ab_frags and (self._ab_prefix is not prefix
                                   or self._ab_trace != trace_ctx):
                self._drain_autobatch_locked()
            self._ab_prefix = prefix
            self._ab_base = base
            self._ab_trace = trace_ctx
            self._ab_frags.append(frag)
            if len(self._ab_frags) == 1:
                self._ab_single = (tid, args_kind, args_payload,
                                   arg_deps, rid)
            else:
                self._ab_single = None
            if len(self._ab_frags) >= self._AB_MAX:
                self._drain_autobatch_locked()
            else:
                first = len(self._ab_frags) == 1
        if first:
            # wake the flusher so the window countdown starts now
            self._buf_evt.set()
        return rid

    def _drain_autobatch_locked(self) -> None:
        """Ship the pending auto-batch as ONE SUBMIT_TASKS frame.
        _send_lock is HELD: no send()/send_async()/flush() calls from
        here (plain Lock — re-entry deadlocks); span records append
        straight onto _send_buf. Any already-buffered messages are
        older than the batch and flush FIRST (per-conn FIFO)."""
        frags = self._ab_frags
        if not frags:
            return
        # the *_locked contract: every caller already holds _send_lock
        self._ab_frags = []  # graftlint: disable=GL001
        prefix = self._ab_prefix
        base = self._ab_base
        single = self._ab_single if len(frags) == 1 else None
        tr = self._ab_trace
        self._ab_prefix = None  # graftlint: disable=GL001
        self._ab_base = None  # graftlint: disable=GL001
        self._ab_single = None  # graftlint: disable=GL001
        self._ab_trace = None  # graftlint: disable=GL001
        t0 = time.monotonic()
        if single is not None and base is not None and tr is None:
            # a lone call in the window degrades to the CLASSIC
            # single-task frame: same hub handler and chaos surface as
            # the window=0 path, no req_id/ack/retransmit bookkeeping —
            # a sync .remote()+get() round trip must not pay the bulk
            # ack tax for a batch of one
            tid, kind, blob, deps, rid = single
            frame = dumps_frame((P.SUBMIT_TASK, {
                "task_id": tid,
                "fn_id": base["fn_id"],
                "args_kind": kind,
                "args_payload": blob,
                "arg_deps": deps,
                "return_ids": [rid],
                "resources": base["resources"],
                "options": base["options"],
            }))
            if self._send_buf:
                buf, self._send_buf = self._send_buf, []
                self._buf_cost = 0  # graftlint: disable=GL001 — _send_lock held (caller)
                self.conn.send_bytes(dumps_frame(("batch", buf)))
            if self._chaos is not None:
                n = self._chaos.outbound_send(P.SUBMIT_TASK)
                if n == 0:
                    return
                if n == 2:
                    self.conn.send_bytes(frame)
            self.conn.send_bytes(frame)
            return
        req_id = None
        fut: Optional[Future] = None
        if self._RETRY_PERIOD_S > 0:
            req_id = next(self._req_counter)
            fut = Future()
            with self._pending_lock:
                self._pending[req_id] = fut
        span_id = self._span_id_hex() if tr is not None else None
        frame = close_submit_frame(
            prefix, frags, req_id=req_id,
            trace=(tr[0], span_id) if tr is not None else None,
        )
        if fut is not None:
            wait_s, nxt = self._retry_delay(self._RETRY_PERIOD_S)
            while len(self._unacked_bulk) >= 256:
                # FIFO bound, as in submit_many: eviction only loses
                # retransmit coverage, the ack still resolves the future
                self._unacked_bulk.pop(
                    next(iter(self._unacked_bulk)), None)
            self._unacked_bulk[req_id] = [
                fut, frame, time.monotonic() + wait_s, nxt,
            ]
        if self._send_buf:
            buf, self._send_buf = self._send_buf, []
            self._buf_cost = 0  # graftlint: disable=GL001 — _send_lock held (caller)
            self.conn.send_bytes(dumps_frame(("batch", buf)))
        send = True
        if self._chaos is not None:
            n = self._chaos.outbound_send(P.SUBMIT_TASKS)
            if n == 0:
                send = False  # injected drop: the retransmit entry recovers
            elif n == 2:
                self.conn.send_bytes(frame)
        if send:
            self.conn.send_bytes(frame)
        if tr is not None:
            # ONE client.submit span per drained batch (the submit_many
            # shape); buffered directly — send_async would re-lock
            rec = self._span_rec(
                "client.submit", "submit", tr[0], span_id, tr[1],
                t0, time.monotonic(), n=len(frags),
            )
            self._send_buf.append((P.SPAN_RECORD, rec))  # graftlint: disable=GL001

    def _resend_raw(self, frame: bytes) -> None:
        """Retransmit a pre-encoded SUBMIT_TASKS frame (flusher
        thread, _scan_unacked). Replays carry no FIFO obligation — the
        original send established order — but chaos still sees a
        logical submit_tasks send."""
        if self._chaos is not None:
            n = self._chaos.outbound_send(P.SUBMIT_TASKS)
            if n == 0:
                return
            if n == 2:
                with self._send_lock:
                    self.conn.send_bytes(frame)
        with self._send_lock:
            self.conn.send_bytes(frame)

    def _flush_loop(self) -> None:
        # Catches stray buffered messages right after a burst ends
        # (send latency is event-driven: send_async sets _buf_evt on the
        # first buffered message). The wait timeout doubles as the drain
        # cadence for the lock-free release buffer (__del__ can't signal
        # the event: Event.set takes a lock, and __del__ may preempt a
        # thread that already holds it) — 50ms while releases are
        # flowing, backed off to 250ms when idle so a big cluster of
        # idle workers doesn't burn the core with timer wakeups.
        while not self._closed:
            timeout = 0.05 if self._release_buf else 0.25
            fired = self._buf_evt.wait(timeout=timeout)
            self._buf_evt.clear()
            if fired:
                if self._ab_frags:
                    # an auto-batch window is open: let the burst
                    # accumulate for its full window before draining
                    time.sleep(self._ab_window_s)
                elif len(self._send_buf) >= 8:
                    # a burst is mid-flight: one scheduler quantum lets
                    # the producer coalesce more before we drain. Below
                    # that, the old unconditional nap only ADDED latency
                    # to a lone urgent message — skip it.
                    time.sleep(0.0005)
            try:
                self._scan_unacked()
                self.flush()
            except (OSError, BrokenPipeError):
                return

    def _scan_unacked(self) -> None:
        """Retransmit bulk submits whose ack never came (flusher
        thread). A SUBMIT_TASKS frame dropped on the wire would
        otherwise lose N tasks silently — the hub acks each batch via
        REPLY(req_id), and any batch still unacked past its jittered
        backoff deadline is re-sent whole (per-task dedup in
        _on_submit_tasks makes the replay idempotent)."""
        if not self._unacked_bulk:
            return
        now = time.monotonic()
        acked = None
        for req_id, entry in list(self._unacked_bulk.items()):
            if entry[0].done():
                if acked is None:
                    acked = []
                acked.append(req_id)
            elif now >= entry[2]:
                wait_s, entry[3] = self._retry_delay(entry[3])
                entry[2] = now + wait_s
                if type(entry[1]) is bytes:
                    # auto-batched entry: the spliced frame was kept
                    # verbatim — replay it raw (no re-encode)
                    self._resend_raw(entry[1])
                else:
                    self.send_async(P.SUBMIT_TASKS, entry[1])
        if acked is not None:
            for req_id in acked:
                self._unacked_bulk.pop(req_id, None)

    def _read_loop(self) -> None:
        try:
            while True:
                try:
                    blob = self.conn.recv_bytes()
                except TypeError:
                    # Connection.close() from another thread nulls the fd
                    # mid-recv (os.read(None, ...)) — same benign shutdown
                    # race as EOFError. Only the recv call gets this
                    # treatment; a TypeError in dispatch below is a real bug
                    # and must propagate.
                    raise EOFError("connection closed during recv")
                msg_type, payload = loads_frame(blob)
                if msg_type == "batch":
                    # hub reactor coalesces its per-peer sends (hub._send):
                    # one loads_frame already covered the whole batch.
                    # Hoist the table load out of the inner loop and
                    # memoize the handler across runs of one msg_type
                    # (bulk replies arrive as long same-type runs), and
                    # fold every READY_PUSH in the frame into a single
                    # vector apply — one cache-lock acquisition and one
                    # event set per frame instead of per message.
                    handlers = self._inbound_handlers
                    put = self.task_queue.put
                    ready_ids = None
                    last_mt = None
                    h = None
                    for mt, pl in payload:
                        if mt != last_mt:
                            last_mt = mt
                            h = handlers.get(mt)
                        if mt == P.READY_PUSH:
                            if ready_ids is None:
                                ready_ids = []
                            ready_ids.extend(pl.get("ready", ()))
                        elif h is not None:
                            h(pl)
                        else:
                            put((mt, pl))
                    if ready_ids is not None:
                        self._apply_ready(ready_ids)
                    continue
                self._dispatch_inbound(msg_type, payload)
        except (EOFError, OSError):
            self._fail_pending("hub connection lost")
        except Exception:
            # A dispatch bug used to kill the reader thread bare, which
            # hangs every pending future forever. Surface the bug AND
            # fail the futures loudly, then re-raise so it stays visible
            # as a crash rather than being silently swallowed (GL002).
            log_exc("client reader error")
            self._fail_pending("client reader crashed (see stderr)")
            raise

    def _fail_pending(self, why: str) -> None:
        self._closed = True
        self._ready_evt.set()  # unpark push-waiting wait() loops
        with self._pending_lock:
            pending, self._pending = self._pending, {}
        for fut in pending.values():
            if not fut.done():
                fut.set_exception(ConnectionError(why))
        self.task_queue.put((P.KILL, {}))

    def _on_objs_freed(self, oids) -> None:
        """Runs on the reader thread (pubsub callback): drop freed ids
        from the readiness and location caches."""
        with self._obj_cache_lock:
            for oid in oids:
                self._known_ready.pop(oid, None)
                self._resolve_cache.pop(oid, None)
                self._ready_subscribed.discard(oid)
        # drop reader mappings of the freed segments OUTSIDE the cache
        # lock (store has its own; never nest them). Serve payloads map
        # one segment per request — without this the mapping table grows
        # one dead entry per request served.
        for oid in oids:
            self.store.drop_mapping(oid.hex())

    def _on_node_down(self, data) -> None:
        """Runs on the reader thread: a node died — every cached
        location pointing at it is stale, and pooled connections to its
        object agent are dead."""
        node_id = (data or {}).get("node_id")
        if not node_id:
            return
        endpoints = set()
        with self._obj_cache_lock:
            for oid in [
                o for o, info in self._resolve_cache.items()
                if info.get("node_id") == node_id
            ]:
                info = self._resolve_cache.pop(oid)
                if info.get("endpoint"):
                    endpoints.add(info["endpoint"])
        with self._agent_pool_lock:
            for ep in endpoints:
                for conn in self._agent_pool.pop(ep, []):
                    try:
                        conn.close()
                    except Exception:
                        pass

    def _on_ready_push(self, payload) -> None:
        """Runs on the reader thread: the hub pushed a batch of
        newly-ready object ids (readiness subscription, _wait_push)."""
        self._apply_ready(payload.get("ready", ()))

    def _apply_ready(self, ids) -> None:
        """Mark a vector of object ids ready (reader thread). The
        batch-decode path in _read_loop funnels every READY_PUSH of a
        frame through one call, so a bulk submit's completion storm
        costs one lock round trip instead of one per push."""
        with self._obj_cache_lock:
            known = self._known_ready
            subscribed = self._ready_subscribed
            for b in ids:
                known[b] = True
                subscribed.discard(b)
            while len(known) > 65536:
                known.pop(next(iter(known)), None)
        self._ready_evt.set()

    def _dispatch_inbound(self, msg_type, payload):
        # table dispatch, mirroring the hub's {msg_type: bound_method}
        # map (built in __init__); anything unrecognized is a task
        # assignment (worker role) or control message for the executor.
        h = self._inbound_handlers.get(msg_type)
        if h is not None:
            h(payload)
        else:
            self.task_queue.put((msg_type, payload))

    def _on_reply(self, payload):
        req_id = payload["req_id"]
        with self._pending_lock:
            fut = self._pending.pop(req_id, None)
        if fut is not None:
            fut.set_result(payload)

    def _on_pubsub_msg(self, payload):
        cb = self.subscriptions.get(payload["channel"])
        if cb is None:
            return
        # client-published user data rides as an opaque cloudpickle
        # blob (see publish()); hub-internal channels push plain data
        blob = payload.get("blob")
        if blob is not None:
            try:
                data = loads_inline(blob)
            except Exception:
                # a blob this subscriber can't decode (publisher-only
                # module etc.) must not kill the reader thread, but
                # dropping it silently makes the loss undebuggable
                log_exc(
                    f"undecodable pubsub blob on channel "
                    f"{payload.get('channel')!r} (message dropped)"
                )
                return
        else:
            data = payload["data"]
        try:
            cb(data)
        except Exception:
            pass

    def _profile_sink(self, batch: dict) -> None:
        """Sampler flush target (profiling.Sampler, its own daemon
        thread): folded stacks ride the async buffer to the hub. Never
        raises — a half-closed connection must not kill the sampler."""
        if self._closed:
            return
        try:
            self.send_async(P.PROFILE_BATCH, batch)
        except Exception:
            pass

    def _on_stack_dump(self, payload):
        """Reader-thread handler for a brokered `ray_tpu stack` dump.
        Deliberately NOT routed through the task queue: the executor
        being wedged is exactly when a dump is wanted."""
        from . import profiling as _profiling

        try:
            self.send(P.STACK_REPLY, {
                "token": payload.get("token"),
                "pid": os.getpid(),
                "threads": _profiling.dump_threads(),
            })
        except Exception:
            pass

    def stack_dump(self, target: str = "hub", timeout: float = 10.0) -> dict:
        """All-thread stack dump of one runtime process (`ray_tpu
        stack`): target is "hub", a worker id, or a worker pid. The hub
        answers for itself inline and brokers worker targets over their
        control connection (STACK_DUMP/STACK_REPLY)."""
        return self.request(
            P.STACK_REQUEST, {"target": str(target)}, timeout=timeout
        )

    def _on_cancel_task(self, payload):
        # reader-thread fast path: mark before the executor
        # dequeues it AND resolve the caller immediately —
        # the executor may be busy for a long time before it
        # ever sees the queued message (it drops it silently
        # at dequeue; a late duplicate TASK_DONE is ignored
        # because error objects are first-write-wins)
        self.cancelled_tasks.add(payload["task_id"])
        if payload.get("return_ids"):
            blob = dumps_inline(
                exceptions.TaskCancelledError("task was cancelled")
            )
            self.send(
                P.TASK_DONE,
                {
                    "task_id": payload["task_id"],
                    "returns": [
                        (oid, P.VAL_ERROR, blob, 0)
                        for oid in payload["return_ids"]
                    ],
                },
            )

    # Request types safe to retransmit when a reply is slow/lost: reads
    # and idempotent writes. Lost-message tolerance is what the chaos
    # tests (RAY_TPU_TORCH_CHAOS_DROP) exercise — the reference gets the same
    # property from its retryable gRPC client (rpc/retryable_grpc_client.h).
    _RETRY_SAFE = {
        P.GET, P.WAIT, P.KV_GET, P.KV_PUT, P.KV_KEYS, P.KV_DEL,
        P.GET_ACTOR, P.GET_FUNCTION, P.LIST_STATE, P.CLUSTER_RESOURCES,
        P.PG_READY, P.STREAM_NEXT, P.STREAM_CREDIT, P.FETCH_OBJECT,
        P.REGISTER_JOB,  # idempotent upsert keyed by job_id
        P.RESOLVE_OBJECT,   # pure read of the location directory
        P.SUBSCRIBE_READY,  # idempotent watcher registration
    }
    # Retransmit cadence: capped exponential backoff with full jitter
    # (reference: rpc/retryable_grpc_client.h's exponential backoff —
    # the previous fixed ~2s re-send turned every hub stall into a
    # synchronized retransmit storm from the whole client herd, and is
    # exactly the shape graftlint GL011 now flags). _RETRY_PERIOD_S is
    # the base delay; doubles per resend up to _RETRY_MAX_S.
    _RETRY_PERIOD_S = 2.0
    _RETRY_MAX_S = 30.0

    # adaptive-coalescing bounds (send_async): the window floor keeps
    # per-message overhead amortized at least 16-way under sustained
    # load; the ceiling bounds burst latency and frame size; the byte
    # cap flushes early when large payloads (put_value) stack up
    _COALESCE_FLOOR = 16
    _COALESCE_CEIL = 512
    _COALESCE_MAX_BYTES = 1 << 20
    # auto-batch capacity bound: a window's worth of spliced submits
    # drains early past this many tasks (bounds frame size and the
    # all-or-nothing retransmit unit)
    _AB_MAX = 1024

    # process-wide client generation counter (see self.client_epoch)
    _EPOCH_COUNTER = itertools.count(1)

    def _retry_delay(self, delay: float,
                     cap: Optional[float] = None) -> Tuple[float, float]:
        """(this wait's jittered duration, next backoff step). Full
        jitter on [base/2, base] keeps the mean cadence near base while
        desynchronizing retransmit herds. `cap` bounds the growth
        (default: the retransmit ceiling; _wait_push resyncs cap at 8s
        so a lost push costs seconds, not the full ceiling)."""
        if cap is None:
            cap = self._RETRY_MAX_S
        return delay * (0.5 + 0.5 * random.random()), min(cap, delay * 2.0)

    def request(self, msg_type: str, payload: dict, timeout: Optional[float] = None) -> dict:
        import time as _time
        from concurrent.futures import wait as _fut_wait

        req_id = next(self._req_counter)
        fut: Future = Future()
        with self._pending_lock:
            self._pending[req_id] = fut
        payload = dict(payload, req_id=req_id)
        self.send(msg_type, payload)
        retryable = msg_type in self._RETRY_SAFE and not (
            msg_type == P.KV_PUT and not payload.get("overwrite", True)
        )
        if not retryable or self._RETRY_PERIOD_S <= 0:
            # period <= 0 = retransmit disabled: park on the first send
            # (a zero base must not degenerate into a busy-spin flood)
            return fut.result(timeout=timeout)
        deadline = None if timeout is None else _time.monotonic() + timeout
        delay = self._RETRY_PERIOD_S
        while True:
            remaining, delay = self._retry_delay(delay)
            if deadline is not None:
                remaining = min(remaining, deadline - _time.monotonic())
                if remaining <= 0:
                    raise TimeoutError(f"{msg_type} request timed out")
            # Non-raising wait: chunk expiry must be distinguishable from
            # an EXTERNAL TimeoutError (e.g. a test-harness SIGALRM) —
            # concurrent.futures.TimeoutError IS builtins.TimeoutError, so
            # an except here would swallow cancellation and spin forever.
            _fut_wait([fut], timeout=remaining)
            if fut.done():
                return fut.result()
            if self._closed:
                raise ConnectionError("hub connection lost")
            # reply lost or hub slow: retransmit the same req_id (a
            # duplicate reply finds no pending future and is dropped;
            # the hub's _inflight_reqs dedup keeps one parked waiter —
            # and one traced span — per logical request regardless of
            # how many resends the backoff schedule produces)
            self.send(msg_type, payload)

    # -------------------------------------------------------- runtime tracing
    # All methods below are reached only behind `if self._tracing_live():`
    # — with sampling off and no ambient context (the default) the
    # submit/get/put hot paths pay one attribute load plus one
    # contextvar read each.
    def _tracing_live(self) -> bool:
        return self._trace_on or self._trace_ctx() is not None
    def _trace_begin(self):
        """(trace_id, parent_span_id) for a new sampled operation:
        inherit the ambient context (a user span, or a traced task's
        execute scope in a worker — that's how nested submits stitch),
        else head-sample a fresh trace."""
        from ..util import tracing as _t

        ctx = _t.current_context()
        if ctx is not None:
            return ctx
        r = self._trace_rate
        if r >= 1.0 or random.random() < r:
            return (_t.new_span_id(), None)
        return None

    def _span_rec(self, name: str, stage: str, trace_id: str,
                  span_id: str, parent_id, t0: float, t1: float,
                  **attrs) -> dict:
        """Build one finished runtime span record against the pre-bound
        clock anchor — no per-span import, getpid(), or intermediate
        attrs dict."""
        a = {"stage": stage}
        for k, v in attrs.items():
            a[k] = str(v)
        wall_at = self._wall_at
        return {
            "name": name,
            "trace_id": trace_id,
            "span_id": span_id,
            "parent_id": parent_id,
            "start": wall_at(t0),
            "end": wall_at(t1),
            "pid": self._pid,
            "node_id": self.node_id,
            "attrs": a,
        }

    def _trace_emit(self, name: str, stage: str, trace_id: str,
                    span_id: str, parent_id, t0: float, t1: float,
                    **attrs) -> None:
        """Ship one finished runtime span to the hub (batched onto the
        existing connection; never raises into the traced path)."""
        rec = self._span_rec(name, stage, trace_id, span_id, parent_id,
                             t0, t1, **attrs)
        try:
            self.send_async(P.SPAN_RECORD, rec)
        except Exception:
            pass

    def _traced_send(self, msg_type: str, payload: dict, span_name: str,
                     stage: str, tr: tuple, remember_ids=(),
                     t0: Optional[float] = None, **attrs) -> None:
        """One sampled request: mint the span id, attach the trace
        context to the payload, ship it, emit the client-side span, and
        remember the return ids so a later get() joins the trace.
        `t0` lets the span start before payload encoding (put path)."""
        span_id = self._span_id_hex()
        if t0 is None:
            t0 = time.monotonic()
        payload["trace"] = (tr[0], span_id)
        self.send_async(msg_type, payload)
        self._trace_emit(span_name, stage, tr[0], span_id, tr[1],
                         t0, time.monotonic(), **attrs)
        if remember_ids:
            self._trace_remember(remember_ids, (tr[0], span_id))

    def _trace_remember(self, return_ids, ctx: tuple) -> None:
        # under the cache lock like every other client-side cache: a
        # multi-threaded driver evicting concurrently (or racing a
        # free()) must not KeyError inside the user's submit
        with self._obj_cache_lock:
            refs = self._trace_refs
            for oid in return_ids:
                refs[oid] = ctx
            while len(refs) > 4096:  # FIFO bound; eviction = untraced get
                refs.pop(next(iter(refs)), None)

    def _trace_for_ids(self, oid_list) -> Optional[tuple]:
        """Trace context for a get/fetch: ambient first, else the
        remembered submit context of any requested ref."""
        from ..util import tracing as _t

        ctx = _t.current_context()
        if ctx is not None:
            return ctx
        refs = self._trace_refs
        if not refs:
            return None
        for oid in oid_list:
            ctx = refs.get(oid)
            if ctx is not None:
                return ctx
        return None

    # --------------------------------------------------------------- objects
    def put_value(self, obj: Any, object_id: Optional[ObjectID] = None,
                  force_shm: bool = False, cache: bool = True) -> ObjectID:
        oid = object_id or ObjectID.generate()
        tr = self._trace_begin() if self._tracing_live() else None
        if tr is None:
            kind, payload, size = self.encode_value(oid, obj, force_shm=force_shm)
            self.send_async(
                P.PUT,
                {"object_id": oid.binary(), "kind": kind,
                 "payload": payload, "size": size},
                cost=size if kind == P.VAL_INLINE else 0,
            )
        else:
            t0 = time.monotonic()  # the put span covers the encode too
            kind, payload, size = self.encode_value(oid, obj, force_shm=force_shm)
            self._traced_send(
                P.PUT,
                {"object_id": oid.binary(), "kind": kind,
                 "payload": payload, "size": size},
                "client.put", "put", tr,
                remember_ids=[oid.binary()], t0=t0, size=size,
            )
        if kind == P.VAL_SHM and cache:
            # cache the deserialized original to avoid a re-map on local
            # get. The serve payload codec passes cache=False: the
            # producer never re-reads its own request payload, and 4096
            # cached MiB-scale bodies would pin gigabytes.
            with self._obj_cache_lock:
                self._obj_cache[oid.binary()] = obj
        return oid

    # client-mode puts above this size stream to the hub in chunks and
    # land in the HEAD node's shm store as ordinary VAL_SHM objects
    # (reference: util/client/server/dataservicer.py chunked PutObject);
    # below it they ride inline through the connection as before
    CLIENT_CHUNK_THRESHOLD = 4 * 1024 * 1024
    FETCH_CHUNK = 8 * 1024 * 1024

    def encode_value(self, oid: ObjectID, obj: Any,
                     force_shm: bool = False) -> Tuple[str, Any, int]:
        """Encode a value for transport: inline bytes or shm segment name."""
        from .serialization import RawPayload, dumps_oob

        header, buffers = dumps_oob(obj)
        nbytes = len(header) + sum(b.raw().nbytes for b in buffers)
        # RawPayload (and force_shm=True) is an explicit object-plane
        # request (serve payload codec): never inline it, even below
        # INLINE_THRESHOLD or inside the client-mode CHUNK window — the
        # whole point is one memcpy into shm instead of a pickle ride
        # through the hub
        if not force_shm and not isinstance(obj, RawPayload) and (
            nbytes < INLINE_THRESHOLD
            or (self.inline_only and nbytes < self.CLIENT_CHUNK_THRESHOLD)
        ):
            if buffers:
                blob = dumps_inline((header, [b.raw().tobytes() for b in buffers]))
            else:
                blob = dumps_inline((header, []))
            return P.VAL_INLINE, blob, nbytes
        name = oid.hex()
        if self.inline_only:
            # Stream the segment into the HEAD node's store. Preferred
            # path: out-of-band direct put to the head's object agent —
            # the bytes never enter the hub reactor; the caller's PUT
            # message then flips the object ready. Fallback: PUT_CHUNK
            # relay through the hub (the last chunk makes the object
            # ready cluster-side; the duplicate PUT the caller sends
            # afterwards is a no-op: _object_ready ignores already-ready
            # objects).
            from .object_store import iter_segment_chunks

            raws = [b.raw() for b in buffers]
            fallback = None
            if self._direct_enabled:
                try:
                    self._direct_put(name, *iter_segment_chunks(header, raws))
                    return P.VAL_SHM, name, nbytes
                except Exception as err:
                    fallback = f"{type(err).__name__}: {err}"
            total, chunks = iter_segment_chunks(header, raws)
            sent = 0
            for piece in chunks:
                msg = {
                    "object_id": oid.binary(), "name": name,
                    "offset": sent, "data": piece,
                }
                if fallback is not None and sent == 0:
                    msg["fallback"] = fallback
                sent += len(piece)
                msg["last"] = sent >= total
                self.send(P.PUT_CHUNK, msg)
            return P.VAL_SHM, name, nbytes
        self.store.put_raw(name, header, [b.raw() for b in buffers])
        return P.VAL_SHM, name, nbytes

    def _head_endpoint(self) -> str:
        """The head node's object-agent endpoint for direct puts
        (cached; "" = head serves no agent, stay on the relay)."""
        ep = self._head_agent_endpoint
        if ep is None:
            reply = self.request(P.RESOLVE_OBJECT, {"node_id": "node0"})
            ep = self._head_agent_endpoint = reply.get("endpoint") or ""
        return ep

    def _direct_put(self, name: str, total: int, chunks) -> None:
        """Stream a large client-mode put out-of-band to the head's
        object agent. Raises on ANY irregularity; the caller falls back
        to the PUT_CHUNK hub relay."""
        endpoint = self._head_endpoint()
        if not endpoint:
            raise OSError("head node serves no object agent")
        conn = self._agent_checkout(endpoint)
        ok = False
        try:
            sent = 0
            for piece in chunks:
                sent += len(piece)
                conn.send_bytes(dumps_frame((P.OBJ_PUT, {
                    "name": name, "data": piece, "last": sent >= total,
                })))
            msg_type, p = loads_frame(conn.recv_bytes())
            if msg_type == P.OBJ_ERROR:
                raise OSError(p.get("error") or "agent put failed")
            if msg_type != P.OBJ_PUT_OK:
                raise OSError(f"unexpected frame {msg_type}")
            ok = True
        finally:
            if ok:
                self._agent_checkin(endpoint, conn)
            else:
                try:
                    conn.close()
                except Exception:
                    pass

    def decode_value(self, oid_bytes: bytes, kind: str, payload: Any) -> Any:
        if kind == P.VAL_INLINE:
            header, bufs = loads_inline(payload)
            from .serialization import loads_oob

            return loads_oob(header, bufs)
        if kind == P.VAL_SHM:
            try:
                return self.store.get(payload)
            except FileNotFoundError:
                # segment lives on another node: resolve its location
                # once and pull it DIRECTLY from the owner's object
                # agent (out-of-band object plane), falling back to the
                # hub-relay chunked fetch on any transfer error
                # (reference: object manager pull + ownership
                # directory). Every path streams in chunks so a
                # multi-GB get never materializes twice in one process.
                self._fetch_segment(oid_bytes, payload)
                return self.store.get(payload)
        if kind == P.VAL_ERROR:
            err = loads_inline(payload)
            raise err
        raise ValueError(f"unknown value kind {kind}")

    def _decode_oneshot(self, oid_bytes: bytes, kind: str, payload: Any) -> Any:
        """One-shot consumer decode (serve payload codec). A VAL_SHM
        segment that is NOT already mapped locally is pulled straight
        from the owner's object agent into memory and decoded over the
        pulled bytes (object_store.decode_segment_bytes) — no store
        install, no REPLICA_ADDED registration, no mapping left behind
        for a value read exactly once. Local segments (the same-node
        common case: driver and replicas share one objects dir) take
        the ordinary zero-copy store.get via decode_value, which is
        also the fallback on ANY pull irregularity — its fetch matrix
        ends in the hub relay, so a dead agent degrades, never fails."""
        if kind == P.VAL_SHM and not self.store.contains(payload):
            info = self._resolve_object(oid_bytes) if self._direct_enabled else None
            if (
                info
                and info.get("endpoint")
                and not (
                    info.get("hostname") == self.hostname
                    and info.get("path")
                    and os.path.isfile(info["path"])
                )
            ):
                try:
                    from .object_agent import pull_segment_bytes
                    from .object_store import decode_segment_bytes

                    blob = pull_segment_bytes(info["endpoint"], payload)
                    return decode_segment_bytes(blob)
                except Exception:
                    self._invalidate_resolve(oid_bytes, info.get("endpoint"))
        return self.decode_value(oid_bytes, kind, payload)

    # ------------------------------------------- out-of-band object plane
    def _resolve_object(self, oid_bytes: bytes) -> Optional[dict]:
        """Query (and cache) the hub's ownership/location directory.
        Returns None when the object has no resolvable shm location."""
        with self._obj_cache_lock:
            info = self._resolve_cache.get(oid_bytes)
        if info is not None:
            return info
        reply = self.request(P.RESOLVE_OBJECT, {"object_id": oid_bytes})
        if reply.get("error") or not reply.get("name"):
            return None
        if reply.get("spilled"):
            # relay territory (restore-under-accounting); uncached so a
            # later fetch re-resolves the post-restore location
            return None
        info = {
            "name": reply["name"],
            "node_id": reply.get("node_id"),
            "endpoint": reply.get("endpoint"),
            "hostname": reply.get("hostname"),
            "path": reply.get("path"),
        }
        with self._obj_cache_lock:
            cache = self._resolve_cache
            cache[oid_bytes] = info
            while len(cache) > 4096:  # FIFO bound; eviction = re-resolve
                cache.pop(next(iter(cache)))
        return info

    def _invalidate_resolve(self, oid_bytes: bytes, endpoint: Optional[str]) -> None:
        with self._obj_cache_lock:
            self._resolve_cache.pop(oid_bytes, None)
        if endpoint:
            with self._agent_pool_lock:
                for conn in self._agent_pool.pop(endpoint, []):
                    try:
                        conn.close()
                    except Exception:
                        pass

    def _agent_checkout(self, endpoint: str):
        with self._agent_pool_lock:
            pool = self._agent_pool.get(endpoint)
            if pool:
                return pool.pop()
        return connect_hub(endpoint)

    def _agent_checkin(self, endpoint: str, conn) -> None:
        with self._agent_pool_lock:
            pool = self._agent_pool.setdefault(endpoint, [])
            if len(pool) < 4:
                pool.append(conn)
                return
        try:
            conn.close()
        except Exception:
            pass

    def _direct_pull(self, endpoint: str, name: str, dst_tmp: str) -> None:
        """Stream one segment from a peer's object agent into dst_tmp.
        Raises on ANY irregularity; the caller falls back to the relay."""
        conn = self._agent_checkout(endpoint)
        ok = False
        try:
            conn.send_bytes(dumps_frame((P.OBJ_GET, {"name": name})))
            with open(dst_tmp, "wb") as f:
                while True:
                    msg_type, p = loads_frame(conn.recv_bytes())
                    if msg_type == P.OBJ_ERROR:
                        raise OSError(p.get("error") or "agent fetch failed")
                    if msg_type != P.OBJ_DATA:
                        raise OSError(f"unexpected frame {msg_type}")
                    f.write(p["data"])
                    if p.get("last"):
                        break
            ok = True
        finally:
            if ok:
                self._agent_checkin(endpoint, conn)
            else:
                try:
                    conn.close()
                except Exception:
                    pass

    def _fetch_segment(self, oid_bytes: bytes, name: str) -> None:
        tr = self._trace_for_ids((oid_bytes,)) if self._tracing_live() else None
        if tr is None:
            return self._fetch_segment_impl(oid_bytes, name)
        from ..util.tracing import new_span_id

        span_id = new_span_id()
        t0 = time.monotonic()
        try:
            return self._fetch_segment_impl(oid_bytes, name)
        finally:
            # one span per installed segment: direct object-agent pull,
            # same-host file copy, and the hub-relay fallback all count
            # as the object plane's "transfer" stage
            self._trace_emit(
                "client.fetch_segment", "transfer", tr[0], span_id,
                tr[1], t0, time.monotonic(), object=oid_bytes.hex(),
            )

    def _fetch_segment_impl(self, oid_bytes: bytes, name: str) -> None:
        """Install a remote segment into the local store: same-host
        file copy when the producer's objects dir is visible on this
        machine, direct object-agent stream otherwise, hub relay as the
        fallback of last resort (transfer-path matrix in the README)."""
        fallback_reason = None
        if self._direct_enabled:
            info = self._resolve_object(oid_bytes)
            if info is not None:
                tmp = (
                    self.store._path(name)
                    + f".fetch.{os.getpid()}.{threading.get_ident()}"
                )
                try:
                    src = None
                    if info.get("hostname") == self.hostname:
                        # producer's store is on THIS machine: its
                        # segment file is directly readable
                        cand = info.get("path")
                        if cand and cand != self.store._path(name) \
                                and os.path.isfile(cand):
                            src = cand
                    if src is not None:
                        # same-host shm: the producer's segment is a
                        # local file — copy at memcpy speed, no sockets
                        import shutil

                        shutil.copyfile(src, tmp)
                    elif info.get("endpoint"):
                        self._direct_pull(info["endpoint"], info["name"], tmp)
                    else:
                        raise OSError("no object-agent endpoint")
                    os.replace(tmp, self.store._path(name))
                    if not self.inline_only:
                        # this node's shared store now holds a replica;
                        # the directory can serve later consumers from it
                        # (a client-mode scratch dir is private — not a
                        # replica anyone else could read)
                        self.send_async(P.REPLICA_ADDED, {
                            "object_id": oid_bytes, "node_id": self.node_id,
                        })
                    return
                except Exception as err:  # fall back to the hub relay
                    fallback_reason = f"{type(err).__name__}: {err}"
                    self._invalidate_resolve(oid_bytes, info.get("endpoint"))
                finally:
                    try:
                        os.unlink(tmp)
                    except OSError:
                        pass
        self._fetch_segment_chunked(oid_bytes, name, fallback=fallback_reason)

    def _fetch_segment_chunked(self, oid_bytes: bytes, name: str,
                               fallback: Optional[str] = None) -> None:
        """Pull a remote segment into the local store through the hub
        relay in FETCH_CHUNK slices (reference: dataservicer.py chunked
        GetObject). Idempotent offset reads, so the retry-safe request
        path applies per chunk. `fallback` carries the direct-transfer
        failure reason so the hub records the object_transfer_fallback
        event and bumps ray_tpu_object_fallbacks_total."""
        # pid AND thread id: two threads get()ing the same not-yet-local
        # ref fetch independently; same bytes, last replace wins
        tmp = (
            self.store._path(name)
            + f".fetch.{os.getpid()}.{threading.get_ident()}"
        )
        off, total = 0, None
        try:
            with open(tmp, "wb") as f:
                while total is None or off < total:
                    req = {
                        "object_id": oid_bytes,
                        "offset": off,
                        "length": self.FETCH_CHUNK,
                    }
                    if fallback is not None and off == 0:
                        req["fallback"] = fallback
                    reply = self.request(P.FETCH_OBJECT, req)
                    data = reply.get("data")
                    if data is None or (not data and off < (total or 1)):
                        with self._obj_cache_lock:
                            self._known_ready.pop(oid_bytes, None)
                        raise exceptions.ObjectLostError(
                            f"object {oid_bytes.hex()} unavailable: "
                            f"{reply.get('error')}"
                        ) from None
                    f.write(data)
                    off += len(data)
                    total = reply.get("total", off)
            os.replace(tmp, self.store._path(name))
        finally:
            try:
                os.unlink(tmp)
            except OSError:
                pass

    def get(self, object_ids: Sequence[ObjectID], timeout: Optional[float] = None,
            oneshot: bool = False) -> List[Any]:
        if not self._tracing_live():
            return self._get(object_ids, timeout, oneshot=oneshot)
        ids = [o.binary() for o in object_ids]
        tr = self._trace_for_ids(ids)
        if tr is None:
            return self._get(object_ids, timeout, oneshot=oneshot)
        from ..util.tracing import new_span_id

        span_id = new_span_id()
        t0 = time.monotonic()
        err = None
        try:
            return self._get(object_ids, timeout, trace=(tr[0], span_id),
                             oneshot=oneshot)
        except BaseException as exc:
            err = type(exc).__name__
            raise
        finally:
            attrs = {"n": len(ids)}
            if err is not None:
                attrs["error"] = err
            # the get span ENVELOPS the wait for the result; the
            # analyzer charges only its tail past the last runtime
            # stage to "result_return"
            self._trace_emit(
                "client.get", "result_return", tr[0], span_id, tr[1],
                t0, time.monotonic(), **attrs,
            )
            if err != "GetTimeoutError":
                # terminal get: a LATER re-get of the same (now cached)
                # ref must not re-emit and stretch the finished trace's
                # end-to-end window; a timed-out get keeps its entries
                # so the retry still stitches
                with self._obj_cache_lock:
                    for b in ids:
                        self._trace_refs.pop(b, None)

    def _get(self, object_ids: Sequence[ObjectID],
             timeout: Optional[float] = None,
             trace: Optional[tuple] = None,
             oneshot: bool = False) -> List[Any]:
        out: Dict[bytes, Any] = {}
        missing = []
        with self._obj_cache_lock:
            for oid in object_ids:
                if oid.binary() in self._obj_cache:
                    out[oid.binary()] = self._obj_cache[oid.binary()]
                else:
                    missing.append(oid)
        if missing:
            req = {"object_ids": [o.binary() for o in missing], "timeout": timeout}
            if trace is not None:
                req["trace"] = trace
            reply = self.request(
                P.GET,
                req,
                timeout=None,
            )
            if reply.get("timeout"):
                raise exceptions.GetTimeoutError(
                    f"get() timed out after {timeout}s waiting for {len(missing)} objects"
                )
            errs = []
            for oid_bytes, kind, payload in reply["values"]:
                if kind == P.VAL_ERROR:
                    errs.append(loads_inline(payload))
                    out[oid_bytes] = ("__err__", errs[-1])
                elif oneshot:
                    # one-shot consumer semantics (serve payloads): the
                    # value is read exactly once, so never insert it into
                    # the cache — sustained serving would otherwise pin
                    # thousands of dead MiB-scale bodies there
                    out[oid_bytes] = self._decode_oneshot(oid_bytes, kind, payload)
                else:
                    val = self.decode_value(oid_bytes, kind, payload)
                    out[oid_bytes] = val
                    with self._obj_cache_lock:
                        if len(self._obj_cache) >= 4096:
                            # crude half-eviction keeps the cache bounded
                            for k in list(self._obj_cache)[:2048]:
                                del self._obj_cache[k]
                        self._obj_cache[oid_bytes] = val
            if errs:
                raise errs[0]
        return [out[o.binary()] for o in object_ids]

    def wait(
        self,
        object_ids: Sequence[ObjectID],
        num_returns: int,
        timeout: Optional[float],
        fetch_local: bool = True,
    ) -> Tuple[List[bytes], List[bytes]]:
        ids = [o.binary() for o in object_ids]
        ready_pos, not_ready_pos = self.wait_pos(ids, num_returns, timeout)
        return [ids[i] for i in ready_pos], [ids[i] for i in not_ready_pos]

    def _scan_ready(self, ids: List[bytes], num_returns: int) -> List[int]:
        """Positions of locally-known-ready ids, stopping at
        num_returns hits. Readiness is monotonic except for
        cross-client frees and node-loss reconstruction; in those rare
        races the follow-up get() blocks through reconstruction or
        raises ObjectLostError — the same TOCTOU a hub round-trip reply
        has (decode_value un-caches on loss)."""
        known = self._known_ready
        cache = self._obj_cache
        ready: List[int] = []
        with self._obj_cache_lock:
            for i, b in enumerate(ids):
                if b in known or b in cache:
                    ready.append(i)
                    if len(ready) >= num_returns:
                        break
        return ready

    def wait_pos(
        self,
        ids: List[bytes],
        num_returns: int,
        timeout: Optional[float],
    ) -> Tuple[List[int], List[int]]:
        """wait() by POSITION in `ids` — the pop-loop shape (1k refs,
        num_returns=1, re-called per pop) stays O(n) per call instead
        of O(n) dict builds on every layer above.

        Fast path: the local readiness cache, fed by READY_PUSH.
        Slow path: ONE readiness subscription for the unknown ids (the
        hub replies with the already-ready subset and pushes the rest
        as producing tasks finish), then park on _ready_evt. The
        periodic re-subscribe below makes lost pushes (chaos drops,
        hub restart races) cost one retry period, not a hang."""
        num_returns = min(num_returns, len(ids))
        if num_returns <= 0:
            return [], list(range(len(ids)))
        ready = self._scan_ready(ids, num_returns)
        if len(ready) < num_returns:
            if not self._ready_push:
                ready = self._wait_request(ids, num_returns, timeout)
            else:
                ready = self._wait_push(ids, num_returns, timeout)
        rset = set(ready)
        return ready, [i for i in range(len(ids)) if i not in rset]

    def _wait_request(self, ids, num_returns, timeout) -> List[int]:
        """Classic parked-WAIT request path (RAY_TPU_TORCH_READY_PUSH=0)."""
        reply = self.request(
            P.WAIT,
            {"object_ids": ids, "num_returns": num_returns, "timeout": timeout},
        )
        known = self._known_ready
        with self._obj_cache_lock:
            for b in reply["ready"]:
                known[b] = True
            for b in reply.get("also_ready", ()):
                known[b] = True
            while len(known) > 65536:  # FIFO cap; eviction costs a re-ask
                known.pop(next(iter(known)), None)
        rset = set(reply["ready"])
        return [i for i, b in enumerate(ids) if b in rset][:num_returns]

    def _wait_push(self, ids, num_returns, timeout) -> List[int]:
        deadline = (
            None if timeout is None else time.monotonic() + timeout
        )
        # re-subscribe cadence backs off like the request retransmit
        # path (pushes are the primary wake; the periodic resync only
        # covers lost pushes) — capped low so a genuinely lost push
        # costs seconds, not the full retransmit ceiling. The resync
        # must stay alive even with retransmits disabled (period <= 0):
        # a lost push with no re-subscribe is a permanent hang.
        base = self._RETRY_PERIOD_S if self._RETRY_PERIOD_S > 0 else 2.0
        resync = base
        # index-keyed pending set: ready positions accumulate across
        # wakes and each wake re-tests ONLY the still-pending ids. The
        # previous shape rescanned the full ref list on every push wake
        # — O(n) per wake, O(n^2) across a 1k-ref wait whose
        # completions stream in one push at a time.
        pending = dict(enumerate(ids))
        ready: List[int] = []
        known = self._known_ready
        cache = self._obj_cache
        subscribed = self._ready_subscribed
        while True:
            self._ready_evt.clear()
            with self._obj_cache_lock:
                hit: List[int] = []
                for i, b in pending.items():
                    if b in known or b in cache:
                        hit.append(i)
                        if len(ready) + len(hit) >= num_returns:
                            break
                for i in hit:
                    del pending[i]
                    ready.append(i)
                if len(ready) >= num_returns:
                    # positions in ascending order, matching the
                    # single-scan contract wait_pos callers rely on
                    ready.sort()
                    return ready
                # register any pending id not already covered by a live
                # subscription (cross-call memo: a pop-loop subscribes
                # each id ONCE total, not once per dry call); the reply
                # carries the subset that is already ready hub-side
                need = [b for b in pending.values() if b not in subscribed]
            if self._closed:
                raise ConnectionError("hub connection lost")
            if need:
                reply = self.request(
                    P.SUBSCRIBE_READY, {"object_ids": need}
                )
                with self._obj_cache_lock:
                    rdy = reply.get("ready", ())
                    for b in rdy:
                        known[b] = True
                    rdy = set(rdy)
                    subscribed.update(b for b in need if b not in rdy)
                    while len(known) > 65536:
                        known.pop(next(iter(known)), None)
                    # hard bound: ids whose producers never finish would
                    # pin the memo; past the cap, drop it wholesale (the
                    # cost is one redundant re-subscribe per waiter)
                    if len(subscribed) > 131072:
                        subscribed.clear()
                continue  # re-scan with the reply folded in
            remaining, backed_off = self._retry_delay(resync, cap=8.0)
            if deadline is not None:
                remaining = min(remaining, deadline - time.monotonic())
                if remaining <= 0:
                    ready.sort()
                    return ready
            if not self._ready_evt.wait(remaining):
                # a full resync period with no push: drop the pending
                # ids from the memo so the next pass re-subscribes —
                # the reply re-syncs readiness even if pushes were lost
                # (chaos) — and back the period off (no fixed-interval
                # retransmit)
                resync = backed_off
                with self._obj_cache_lock:
                    subscribed.difference_update(pending.values())
            else:
                # pushes are flowing again: later losses should re-sync
                # at the base cadence, not the backed-off one
                resync = base
                if len(pending) >= 256:
                    # push debounce for BIG waits: completions stream
                    # one push at a time, and on a busy single-core
                    # host every wake of this thread steals the GIL
                    # from the hub thread mid-dispatch (they share this
                    # process for local drivers). One short sleep
                    # batches the next few pushes into a single
                    # wake/scan instead of one wake per completed task;
                    # small waits (and the TAIL of big ones) stay
                    # latency-exact.
                    time.sleep(0.002)

    def free(self, object_ids: Sequence[ObjectID]) -> None:
        with self._obj_cache_lock:
            for o in object_ids:
                self._obj_cache.pop(o.binary(), None)
                self._known_ready.pop(o.binary(), None)
                self._resolve_cache.pop(o.binary(), None)
                self._trace_refs.pop(o.binary(), None)
        for o in object_ids:
            # drop any locally-fetched copy of a remote segment too
            self.store.free(o.hex())
        self.send_async(P.FREE, {"object_ids": [o.binary() for o in object_ids]})

    def release_owned(self, oid: bytes) -> None:
        """Owner dropped its last local handle to a never-shared ref:
        the hub may free the object (ownership GC; reference analogue:
        ReferenceCounter RemoveLocalReference -> eviction).

        Called from ObjectRef.__del__ — must stay lock-free (plain
        append only); the flusher thread ships the batch. __del__ may
        preempt a thread that already holds our locks, so taking one
        here can deadlock — flush()'s swap-then-drain tolerates the
        unlocked append."""
        self._release_buf.append(oid)  # graftlint: disable=GL001

    # ------------------------------------------------------------------ jobs
    def register_job(
        self,
        job_id: str,
        tenant: str = "default",
        priority: int = 0,
        quota: Optional[Dict[str, float]] = None,
    ) -> None:
        """Register this client's scheduling identity with the hub's
        multi-tenant policy engine (fairsched): tenant id, priority,
        optional resource quota. Later submits are stamped with it."""
        self.job_id = job_id
        self.tenant = tenant or "default"
        self.priority = int(priority or 0)
        self.request(P.REGISTER_JOB, {
            "job_id": job_id, "tenant": self.tenant,
            "priority": self.priority,
            # tri-state: None = keep the tenant's existing cap;
            # {} = explicitly lift it; a dict = replace it
            "quota": None if quota is None else dict(quota),
        })

    def _current_job_identity(self) -> tuple:
        """(job_id, tenant, priority) in effect for a submit from this
        thread/context right now — the execution context's identity
        (set per task/actor call in workers) over the client-wide
        registered one. Submit templates key their spliced prefix on
        this tuple so an identity change rebuilds the baked options."""
        ident = _job_identity.get()
        if ident is None:
            ident = (self.job_id, self.tenant, self.priority)
        return ident

    def _stamp_job(self, options: dict) -> None:
        """Attach the job identity to a submit's options (per-call
        priority=/tenant= overrides win via setdefault)."""
        job_id, tenant, priority = self._current_job_identity()
        explicit_tenant = options.get("tenant")
        if explicit_tenant and explicit_tenant != tenant:
            # per-call tenant OVERRIDE: this is deliberately not the
            # registered job's work — attaching its job_id/priority
            # would account another tenant's traffic to this job
            return
        # each field stamps independently: a per-call priority= without
        # any registered job (job_id None) must still follow nested
        # submits, or fanned-out work escapes quota/priority
        if job_id is not None:
            options.setdefault("job_id", job_id)
        if tenant:
            options.setdefault("tenant", tenant)
        if priority:
            options.setdefault("priority", priority)

    # ----------------------------------------------------------------- tasks
    def register_function(self, fn_id: str, blob: bytes) -> None:
        if fn_id not in self._seen_fns:
            # per-process memo of exported fn digests (content-bounded)
            self._seen_fns[fn_id] = True  # graftlint: disable=GL009
            self.send_async(P.REGISTER_FUNCTION, {"fn_id": fn_id, "blob": blob})

    def submit_task(
        self,
        fn_id: str,
        args_kind: str,
        args_payload: Any,
        arg_dep_ids: List[bytes],
        num_returns: int,
        resources: Dict[str, float],
        options: dict,
        return_task_id: bool = False,
    ):
        task_id = TaskID.generate()
        return_ids = [ObjectID.generate() for _ in range(num_returns)]
        self._stamp_job(options)
        payload = {
            "task_id": task_id.binary(),
            "fn_id": fn_id,
            "args_kind": args_kind,
            "args_payload": args_payload,
            "arg_deps": arg_dep_ids,
            "return_ids": [r.binary() for r in return_ids],
            "resources": resources,
            "options": options,
        }
        tr = self._trace_begin() if self._tracing_live() else None
        if tr is None:
            self.send_async(P.SUBMIT_TASK, payload)
        else:
            self._traced_send(
                P.SUBMIT_TASK, payload, "client.submit", "submit", tr,
                remember_ids=payload["return_ids"], fn_id=fn_id,
            )
        if return_task_id:
            return task_id.binary(), return_ids
        return return_ids

    def submit_many(
        self,
        fn_id: str,
        encoded: List[tuple],
        num_returns: int,
        resources: Dict[str, float],
        options: dict,
    ) -> Tuple[List[bytes], List[List[bytes]]]:
        """Ship N homogeneous tasks in ONE P.SUBMIT_TASKS wire frame
        (RemoteFunction.map). ``encoded`` is [(args_kind, args_payload,
        arg_dep_ids), ...]; fn_id/resources/options are shared by every
        task and travel once in the outer payload. All task and return
        ids are drawn in one slab from the entropy pool. Returns
        (task_ids, return_ids_per_task) as raw bytes.

        Delivery: the hub acks the batch via REPLY(req_id); an unacked
        batch is retransmitted by the flusher (_scan_unacked) and
        deduplicated per task on the hub, so a chaos-dropped frame
        loses nothing. With retransmit disabled (period <= 0) the send
        is fire-and-forget like submit_task."""
        n = len(encoded)
        self._stamp_job(options)
        slab = id_slab(n * (1 + num_returns))
        task_ids = slab[:n]
        rid_rows = [
            slab[n + i * num_returns: n + (i + 1) * num_returns]
            for i in range(n)
        ]
        payload = {
            "fn_id": fn_id,
            "resources": resources,
            "options": options,
            "tasks": [
                {
                    "task_id": task_ids[i],
                    "args_kind": e[0],
                    "args_payload": e[1],
                    "arg_deps": e[2],
                    "return_ids": rid_rows[i],
                }
                for i, e in enumerate(encoded)
            ],
        }
        if self._RETRY_PERIOD_S > 0:
            req_id = next(self._req_counter)
            payload["req_id"] = req_id
            fut: Future = Future()
            with self._pending_lock:
                self._pending[req_id] = fut
            wait_s, nxt = self._retry_delay(self._RETRY_PERIOD_S)
            while len(self._unacked_bulk) >= 256:
                # FIFO bound: an evicted entry just loses retransmit
                # coverage; its ack (if it comes) still resolves the
                # pending future and is dropped there
                self._unacked_bulk.pop(
                    next(iter(self._unacked_bulk)), None)
            self._unacked_bulk[req_id] = [
                fut, payload, time.monotonic() + wait_s, nxt,
            ]
        tr = self._trace_begin() if self._tracing_live() else None
        if tr is None:
            self.send_async(P.SUBMIT_TASKS, payload)
        else:
            # ONE client.submit span for the whole batch; the hub fans
            # it out to N hub.admit children (_on_submit_tasks)
            self._traced_send(
                P.SUBMIT_TASKS, payload, "client.submit", "submit", tr,
                remember_ids=[r for row in rid_rows for r in row],
                fn_id=fn_id, n=n,
            )
        return task_ids, rid_rows

    def create_actor(
        self,
        fn_id: str,
        args_kind: str,
        args_payload: Any,
        arg_dep_ids: List[bytes],
        resources: Dict[str, float],
        options: dict,
    ) -> Tuple[ActorID, ObjectID]:
        actor_id = ActorID.generate()
        ready_id = ObjectID.generate()
        self._stamp_job(options)
        payload = {
            "actor_id": actor_id.binary(),
            "fn_id": fn_id,
            "args_kind": args_kind,
            "args_payload": args_payload,
            "arg_deps": arg_dep_ids,
            "ready_id": ready_id.binary(),
            "resources": resources,
            "options": options,
        }
        if options.get("name"):
            # Named creation is synchronous so duplicate names raise here,
            # matching the reference (actor.py _remote name check via GCS).
            reply = self.request(P.CREATE_ACTOR, payload)
            if reply.get("error"):
                raise ValueError(reply["error"])
        else:
            self.send(P.CREATE_ACTOR, payload)
        return actor_id, ready_id

    def submit_actor_task(
        self,
        actor_id: ActorID,
        method_name: str,
        args_kind: str,
        args_payload: Any,
        arg_dep_ids: List[bytes],
        num_returns: int,
        options: dict,
        return_task_id: bool = False,
    ):
        task_id = TaskID.generate()
        return_ids = [ObjectID.generate() for _ in range(num_returns)]
        # actor calls carry no resources (no quota charge), but the
        # identity must ride along so submits NESTED inside the method
        # inherit it (worker_process._adopt_job_identity)
        self._stamp_job(options)
        payload = {
            "task_id": task_id.binary(),
            "actor_id": actor_id.binary(),
            "method": method_name,
            "args_kind": args_kind,
            "args_payload": args_payload,
            "arg_deps": arg_dep_ids,
            "return_ids": [r.binary() for r in return_ids],
            "options": options,
        }
        tr = self._trace_begin() if self._tracing_live() else None
        if tr is None:
            self.send_async(P.SUBMIT_ACTOR_TASK, payload)
        else:
            self._traced_send(
                P.SUBMIT_ACTOR_TASK, payload, "client.submit_actor",
                "submit", tr, remember_ids=payload["return_ids"],
                method=method_name,
            )
        if return_task_id:
            return task_id.binary(), return_ids
        return return_ids

    def kill_actor(self, actor_id: ActorID, no_restart: bool = True) -> None:
        self.send(P.KILL_ACTOR, {"actor_id": actor_id.binary(), "no_restart": no_restart})

    def cancel(self, object_id: ObjectID, force: bool = False) -> None:
        self.send(P.CANCEL, {"object_id": object_id.binary(), "force": force})

    # -------------------------------------------------------------- metadata
    def kv_put(self, key: bytes, value: bytes, overwrite: bool = True) -> bool:
        return self.request(P.KV_PUT, {"key": key, "value": value, "overwrite": overwrite})["ok"]

    def kv_get(self, key: bytes) -> Optional[bytes]:
        return self.request(P.KV_GET, {"key": key})["value"]

    def kv_del(self, key: bytes) -> bool:
        return self.request(P.KV_DEL, {"key": key})["ok"]

    def kv_keys(self, prefix: bytes) -> List[bytes]:
        return self.request(P.KV_KEYS, {"prefix": prefix})["keys"]

    def get_named_actor(self, name: str, namespace: Optional[str] = None):
        reply = self.request(P.GET_ACTOR, {"name": name, "namespace": namespace})
        return reply.get("actor_id")

    def create_placement_group(
        self,
        bundles,
        strategy: str,
        name: str = "",
        tenant: Optional[str] = None,
        priority: Optional[int] = None,
    ) -> bytes:
        payload = {"bundles": bundles, "strategy": strategy, "name": name}
        # explicit overrides land BEFORE stamping: _stamp_job must see
        # a tenant override to know not to attach this job's identity
        if tenant is not None:
            payload["tenant"] = tenant
        if priority is not None:
            payload["priority"] = int(priority)
        self._stamp_job(payload)
        reply = self.request(P.CREATE_PG, payload)
        if reply.get("error"):
            raise ValueError(reply["error"])
        return reply["pg_id"]

    def remove_placement_group(self, pg_id: bytes) -> None:
        self.send(P.REMOVE_PG, {"pg_id": pg_id})

    def pg_ready(self, pg_id: bytes, timeout: Optional[float] = None) -> bool:
        reply = self.request(P.PG_READY, {"pg_id": pg_id, "timeout": timeout})
        return reply["ready"]

    def list_state(self, kind: str, **params) -> list:
        # extra params pass through to the hub's _on_list_state (e.g.
        # trace_id narrows kind="traces" to one trace's spans)
        return self.request(P.LIST_STATE, dict(params, kind=kind))["items"]

    def cluster_resources(self, available: bool = False) -> dict:
        return self.request(P.CLUSTER_RESOURCES, {"available": available})["resources"]

    def subscribe(self, channel: str, callback) -> None:
        """Push-based pubsub (reference: GCS pubsub channels)."""
        self.subscriptions[channel] = callback
        self.send(P.SUBSCRIBE, {"channel": channel})

    def publish(self, channel: str, data) -> None:
        # pre-serialize user data with cloudpickle so the plain-pickle
        # frame codec never meets a raw __main__-level object; the hub
        # forwards the blob opaque and the subscriber unwraps it
        # (_on_pubsub_msg)
        self.send_async(P.PUBLISH, {"channel": channel, "blob": dumps_inline(data)})

    def close(self) -> None:
        if not self._closed:
            self._closed = True
            self._ready_evt.set()  # unpark any push-waiting wait()
            with self._agent_pool_lock:
                pools, self._agent_pool = self._agent_pool, {}
            for conns in pools.values():
                for c in conns:
                    try:
                        c.close()
                    except Exception:
                        pass
            try:
                # Half-close the stream BEFORE closing the fd: the reader
                # thread is blocked in os.read() and that in-flight read
                # keeps the open file description alive past conn.close(),
                # so no FIN ever reaches the hub — which then keeps this
                # connection (and every registry keyed on it: fairsched
                # jobs, subscriptions, ready-watches) until process exit.
                # shutdown() on a dup'd handle tears the stream down under
                # the blocked read: the reader sees EOF immediately and
                # the hub's reactor (or owning shard) gets its disconnect.
                import socket as _socket

                fd = os.dup(self.conn.fileno())
                try:
                    s = _socket.socket(fileno=fd)
                except OSError:
                    os.close(fd)
                else:
                    try:
                        s.shutdown(_socket.SHUT_RDWR)
                    except OSError:
                        pass
                    s.close()
            except Exception:
                pass
            try:
                self.conn.close()
            except Exception:
                pass
