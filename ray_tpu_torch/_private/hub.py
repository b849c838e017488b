"""Control hub: node registry, object directory, scheduler, actor manager.

This one component plays the roles the reference splits across three
processes — the GCS server (reference: src/ray/gcs/gcs_server/
gcs_server.h:90), the per-node raylet (src/ray/raylet/node_manager.h:122)
and its ClusterTaskManager/LocalTaskManager (src/ray/raylet/scheduling/),
and the plasma metadata plane. On a TPU host the control plane does not
need to be distributed the way Ray's is (scheduling decisions are
node-local; cross-host coordination happens through jax.distributed and
the collective layer), so an event-loop hub gives us the same semantics
with none of the cross-process consistency machinery.

Threading model: ONE state-plane thread owns all state (no locks); it
multiplexes timeouts through a deadline heap. Connection I/O has two
shapes, selected by RAY_TPU_TORCH_HUB_SHARDS (config "hub_shards", default
min(4, cpu count)):

  - shards == 1: the state-plane thread IS the reactor — it owns every
    socket too, the same single-reactor shape as the raylet's
    instrumented asio loop (reference: src/ray/common/asio/
    instrumented_io_context.h). This path is byte-for-byte the pre-shard
    behavior.
  - shards > 1: N reactor-shard threads own the sockets + wire codec
    (hub_shards.py) and reach the scheduler / object-directory state
    services over SPSC message rings — the GCS/raylet split re-done
    natively in one process. State stays single-threaded either way.

Scheduling: resource-based admission (CPU/TPU/custom resources +
placement-group bundle accounting) then dispatch to an idle worker from
the pool, spawning new workers on demand up to a cap — mirroring the
reference's lease-based WorkerPool flow (src/ray/raylet/worker_pool.h,
local_task_manager.cc:124 DispatchScheduledTasksToWorkers) without the
lease round-trip: the hub pushes tasks straight to workers.

Fault tolerance: worker death is detected by connection EOF (the raylet
uses SIGCHLD, reference: src/ray/raylet/worker_pool.cc); running tasks
are retried per max_retries, actors restarted per max_restarts
(reference: src/ray/gcs/gcs_server/gcs_actor_manager.h:96,569).

Port of ``ray_tpu/_private/hub.py``: GPUs are the pinned accelerator. A
task or actor that asks for ``num_gpus=n`` holds the "GPU" resource and
gets n GPU ids from the node's free pool where the reference hands out
TPU chip ids (the fields keep their ``tpu_chips`` names so the two files
stay comparable). The ids stay pinned to the worker for its life; a
fresh worker that has run no user code is preferred for them, since its
CUDA state is untouched. Fractional requests truncate (``int(...)``) as
TPU requests do, and the SLICE (ICI) placement stays inert because the
GPU manager reports no chip coordinates.
"""

from __future__ import annotations

import heapq
import itertools
import os
import selectors
import subprocess
import sys
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from multiprocessing.connection import Listener
from typing import Any, Dict, List, Optional, Set, Tuple

from . import protocol as P
from .debug import log_exc, proc_rss_bytes
from .fairsched import FairScheduler, QuotaInfeasibleError
from .hub_shards import ShardStats as _ShardStats
from .ids import WorkerID
from .serialization import (
    dumps_frame,
    dumps_inline,
    loads_frame,
    loads_inline,
)

# Fault injection (reference: src/ray/rpc/rpc_chaos.h env-selected
# per-method failure, grown into a seeded deterministic plan): the hub
# hosts the "hub" scope of the chaos engine — message drop/delay/dup at
# the dispatch seam, timed conn/worker faults, node partitions. See
# chaos.py for the RAY_TPU_TORCH_CHAOS_PLAN grammar; with no plan the engine
# is None and every injection point is one attribute load.
from . import chaos as _chaos_mod


@dataclass
class ObjEntry:
    ready: bool = False
    kind: str = ""
    payload: Any = None
    size: int = 0
    node_id: str = "node0"  # producer node (VAL_SHM segments live there)
    spilled: bool = False  # primary copy moved to disk (LRU eviction)
    # ownership/location directory (reference: the ownership table +
    # object directory, src/ray/core_worker/reference_count.h +
    # object_manager/ownership_object_directory.h): nodes holding a
    # byte-identical copy installed by a direct fetch. The owner
    # (node_id) is implicit; replicas let RESOLVE_OBJECT fail over when
    # the owner dies. None until the first replica (the common case
    # allocates nothing).
    replicas: Optional[Set[str]] = None
    # (conn, req_id) waiters registered by pending GETs
    task_waiters: List[bytes] = field(default_factory=list)  # task_ids blocked on this obj
    # dependency pins: in-flight tasks (and live actors, for creation
    # args) holding this object alive against ownership-GC release.
    # Mirrors the reference's "submitted task references"
    # (src/ray/core_worker/reference_count.h) without per-borrower
    # bookkeeping: the hub sees every submit, so it counts directly.
    pins: int = 0
    release_pending: bool = False  # owner released while pinned
    # leak attribution (`ray_tpu memory`): the process holding the
    # ObjectRef — the submitter for task returns, the putter for puts
    # ("driver" / "client-N" / a worker id; "" = placeholder entry).
    # created_t is the entry's birth (monotonic), so age is a duration
    # per GL008; display code converts to seconds-old at list time.
    owner: str = ""
    created_t: float = field(default_factory=time.monotonic)


@dataclass
class NodeEntry:
    """One host in the cluster. The head host ("node0") is managed by
    the hub itself (workers are direct subprocesses); remote hosts are
    managed by a node agent (node_agent.py) reached over TCP — the
    reference's raylet registering with the GCS
    (src/ray/gcs/gcs_server/gcs_node_manager.h)."""

    node_id: str
    hostname: str
    ip: str
    session_dir: str
    total: Dict[str, float]
    avail: Dict[str, float]
    free_tpu_chips: Set[int] = field(default_factory=set)
    # ICI topology: chip id -> mesh coordinate (empty = unknown); the
    # SLICE strategy reserves coordinate-contiguous chips from it
    chip_coords: Dict[int, tuple] = field(default_factory=dict)
    # chips reserved by ready SLICE placement groups: out of the free
    # pool, placeable only via their PG bundle
    pg_reserved_chips: Set[int] = field(default_factory=set)
    max_workers: int = 4
    agent_conn: Any = None  # None => head node (hub-local spawning)
    alive: bool = True
    spawning: int = 0
    # how many of the in-flight spawns were requested FOR ACTOR wants —
    # pooled-task spawns must not eat the actor quota for a round
    spawning_actor: int = 0
    # shm object-store budget (reference: plasma eviction_policy.h LRU +
    # external_storage.py spilling): bytes of live segments vs the cap
    store_cap: float = 0.0  # 0 = unlimited
    store_used: float = 0.0
    # out-of-band object plane: this node's object_agent endpoint
    # ("tcp://host:port" or an AF_UNIX path; "" = agent disabled —
    # transfers to/from this node ride the hub relay)
    object_endpoint: str = ""
    # monotonic stamp of the last agent heartbeat; the heartbeat-miss
    # watchdog declares the node dead past the configured threshold
    # (reference: gcs_node_manager heartbeat timeout). 0 = head node /
    # never heartbeated.
    last_heartbeat_t: float = 0.0


@dataclass
class TaskSpec:
    task_id: bytes
    fn_id: str
    args_kind: str
    args_payload: Any
    return_ids: List[bytes]
    resources: Dict[str, float]
    options: dict
    deps_remaining: int = 0
    retries_left: int = 0
    is_actor_create: bool = False
    actor_id: Optional[bytes] = None  # for actor tasks
    method: Optional[str] = None
    ready_id: Optional[bytes] = None  # actor creation ready object
    # arg object ids pinned for this task's lifetime (cleared on unpin
    # so finalization paths can safely run more than once)
    pinned_deps: List[bytes] = field(default_factory=list)
    # distributed tracing: (trace_id, client_submit_span_id) when the
    # submit was head-sampled (util/tracing.py). None = untraced — every
    # span-emission site gates on it, so the default path adds nothing.
    trace: Optional[tuple] = None
    # submitting process's label (_conn_label) — flows onto the task's
    # return objects as their owner for `ray_tpu memory` attribution
    owner: str = ""
    # submitted through the bulk SUBMIT_TASKS frame (RemoteFunction.map):
    # the caller declared a homogeneous throughput-oriented fan-out, so
    # the scheduler may pipeline it behind busy workers. Individually
    # submitted tasks keep strict work-stealing placement (lowest
    # latency to first execution) and never pipeline.
    bulk: bool = False


@dataclass
class WorkerEntry:
    worker_id: str
    conn: Any = None
    proc: Any = None
    # the worker's own os.getpid(), reported in its HELLO — the only
    # pid the head has for agent-spawned workers (proc lives on the
    # remote node agent, so proc.pid is unavailable here)
    pid: Optional[int] = None
    node_id: str = "node0"
    runtime_env_hash: str = ""  # workers only serve matching runtime envs
    spawned_for_actor: bool = False  # purpose of the spawn (quota math)
    # gang preemption in progress: this worker is being killed to free
    # its gang's reservation; its task requeues / its actor restarts
    # WITHOUT burning the retry/restart budget
    preempted: bool = False
    state: str = "starting"  # starting | idle | busy | actor | dead
    # dispatch pipeline: FIFO of tasks assigned to this worker. The head
    # is executing; followers sit in the worker process's own task queue
    # (it drains sequentially), so TASK_DONE/EXEC frames coalesce instead
    # of paying a wake+syscall round-trip per task. Plain tasks only —
    # see _find_pipeline_worker for the eligibility gate.
    assigned: deque = field(default_factory=deque)
    pipe_ok: bool = False  # every task in `assigned` is pipeline-eligible
    actor_id: Optional[bytes] = None
    seen_fns: Set[str] = field(default_factory=set)
    tpu_chips: Tuple[int, ...] = ()  # chips assigned to the current task
    # jax binds devices at first import, so once a worker has run a TPU task
    # its chips are pinned for the worker's lifetime; the scheduler only
    # reuses it for tasks wanting the same chip count (chip affinity).
    pinned_chips: Optional[Tuple[int, ...]] = None
    # tracing: monotonic spawn-request/HELLO stamps; the first traced
    # task dispatched onto a freshly spawned worker attributes the
    # spawn window to its trace as a "spawn" stage span (once)
    spawned_t: float = 0.0
    connected_t: float = 0.0
    spawn_span_done: bool = False
    # dispatch generation: bumped by every _send_exec so a per-task
    # timeout timer armed for attempt N can never kill attempt N+1 of
    # the SAME (retried, hence identical) TaskSpec on this worker
    exec_gen: int = 0

    # `current_task` predates the pipeline: it is now a view of the
    # assigned queue's head. The setter keeps the single-assignment
    # call sites working — assigning replaces the whole queue. (Not an
    # annotated attribute, so the dataclass machinery ignores it.)
    @property
    def current_task(self) -> Optional[TaskSpec]:
        return self.assigned[0] if self.assigned else None

    @current_task.setter
    def current_task(self, spec: Optional[TaskSpec]) -> None:
        self.assigned.clear()
        if spec is not None:
            self.assigned.append(spec)


@dataclass
class ActorEntry:
    actor_id: bytes
    fn_id: str
    args_kind: str
    args_payload: Any
    resources: Dict[str, float]
    options: dict
    ready_id: bytes
    state: str = "pending"  # pending | alive | restarting | dead
    worker_id: Optional[str] = None
    name: str = ""
    restarts_left: int = 0
    pending_calls: deque = field(default_factory=deque)
    inflight: Dict[bytes, TaskSpec] = field(default_factory=dict)  # task_id -> spec
    pool: Optional[tuple] = None  # resource pool holding the actor's lifetime resources
    # creation-arg object pins, held for the actor's lifetime so a
    # restart can replay the creation args; released when the actor is
    # permanently dead
    creation_pins: List[bytes] = field(default_factory=list)


@dataclass
class PGEntry:
    pg_id: bytes
    bundles: List[Dict[str, float]]
    strategy: str
    name: str = ""
    ready: bool = True
    # multi-tenant scheduling identity (fairsched): the creating job's
    # tenant/priority decide who may preempt whom
    tenant: str = "default"
    priority: int = 0
    job_id: str = ""
    seq: int = 0  # creation order (newest-first victim selection)
    # set on a preempted PG: stand aside from re-reserving until the
    # beneficiary reservation (pg_id) is ready or gone, so the victim
    # cannot re-grab the chips it was just preempted off of. The
    # monotonic deadline bounds the stand-aside: a beneficiary that
    # never seats (mis-estimated feasibility) must not starve its
    # victims forever.
    yield_to: Optional[bytes] = None
    yield_until: float = 0.0
    # last time THIS entry ATTEMPTED preemption (monotonic): the 50ms
    # pg_ready poll must not turn a stuck reservation into a kill storm
    last_preempt_t: float = 0.0
    # rounds of victims this entry has shed without seating: capped so
    # a misestimated reservation cannot kill/restart the same gangs
    # every backoff window forever
    preempt_rounds: int = 0
    # per-bundle available resources (bundle reservations are exclusive)
    bundle_avail: List[Dict[str, float]] = field(default_factory=list)
    # node each bundle was reserved on (set when ready)
    bundle_nodes: List[str] = field(default_factory=list)
    # SLICE only: the specific ICI-contiguous chip ids reserved per
    # bundle; tasks scheduled into bundle i run on exactly these chips
    bundle_chips: List[tuple] = field(default_factory=list)


@dataclass
class StreamEntry:
    """State of one streaming-generator task (reference:
    core_worker streaming generator + ObjectRefGenerator _raylet.pyx:280):
    yielded object ids in order, consumer cursor for backpressure, and
    waiters blocked on indices not yet produced."""

    oids: List[bytes] = field(default_factory=list)
    ended: bool = False
    consumed: int = 0
    next_waiters: Dict[int, List[Tuple[Any, int]]] = field(default_factory=dict)
    credit_waiters: List[Tuple[int, Any, int]] = field(default_factory=list)


@dataclass
class GetReq:
    conn: Any
    req_id: int
    remaining: Set[bytes]
    all_ids: List[bytes]
    deadline: Optional[float] = None
    done: bool = False


@dataclass
class WaitReq:
    conn: Any
    req_id: int
    ids: List[bytes]
    num_returns: int
    deadline: Optional[float] = None
    done: bool = False
    # incremental ready counter: arrivals bump this instead of re-scanning
    # all ids (a 1k-ref wait used to cost O(n) per arrival = O(n^2) total)
    n_ready: int = 0


def _sum_bundle_resources(bundles: List[Dict[str, float]]) -> Dict[str, float]:
    """Fold a PG's bundles into one total-resource dict."""
    total: Dict[str, float] = {}
    for b in bundles:
        for k, v in b.items():
            total[k] = total.get(k, 0.0) + v
    return total


def _find_chip_path(coords: Dict[int, tuple], free: Set[int],
                    length: int) -> Optional[List[int]]:
    """A simple path of `length` chips through the free subset of the
    ICI mesh (neighbors differ by 1 in exactly one coordinate — v5e 2D
    meshes don't wrap below pod scale). Splitting such a path into
    consecutive chunks yields per-bundle chip sets that are each
    ICI-connected, which is what SLICE promises.

    Bounded DFS with deterministic seed order (lexicographic coords) —
    exact for the single-host sizes this runs on (<=8 chips per host on
    v5e; a few hundred at most), bailing out after a fixed step budget
    so a fragmented big mesh can't stall the hub reactor.
    """
    usable = [c for c in free if c in coords]
    if length <= 0 or len(usable) < length:
        return None
    if length == 1:
        return [min(usable, key=lambda c: coords[c])]
    by_coord = {coords[c]: c for c in usable}

    def neighbors(c: int):
        base = coords[c]
        for dim in range(len(base)):
            for d in (-1, 1):
                nb = list(base)
                nb[dim] += d
                n = by_coord.get(tuple(nb))
                if n is not None:
                    yield n

    budget = 50_000
    for seed in sorted(usable, key=lambda c: coords[c]):
        stack = [(seed, (seed,))]
        while stack and budget > 0:
            budget -= 1
            node, path = stack.pop()
            if len(path) == length:
                return list(path)
            for n in neighbors(node):
                if n not in path:
                    stack.append((n, path + (n,)))
        if budget <= 0:
            break
    return None


class Hub:
    def __init__(
        self,
        session_dir: str,
        resources: Dict[str, float],
        max_workers: Optional[int] = None,
        tpu_chip_ids: Optional[List[int]] = None,
        tpu_chip_coords: Optional[Dict[int, tuple]] = None,
        worker_env: Optional[Dict[str, str]] = None,
        tcp: bool = False,
        host: str = "127.0.0.1",
        port: int = 0,
        object_store_memory: Optional[float] = None,
        kv_store_path: Optional[str] = None,
    ):
        import socket as _socket
        import tempfile as _tempfile

        if object_store_memory is None:
            object_store_memory = float(
                os.environ.get("RAY_TPU_TORCH_OBJECT_STORE_MEMORY", 0)
            )
        self.spill_dir = os.environ.get("RAY_TPU_TORCH_SPILL_DIR") or os.path.join(
            _tempfile.gettempdir(), "ray_tpu_torch_spill_" + os.path.basename(session_dir)
        )

        # config table + chaos are re-read per hub so tests can set env
        # after first import (reference: ray_config_def.h + rpc_chaos.h)
        from . import config as _config_mod

        _config_mod.reload()
        self.config = _config_mod.RAY_TPU_TORCH_CONFIG
        # None (no plan / nothing for the hub scope) = inert fault
        # plane: _handle/_handle_sharded pay one attribute load
        self._chaos = _chaos_mod.engine_for("hub")
        self.session_dir = session_dir
        os.makedirs(session_dir, exist_ok=True)
        if tcp:
            # Cluster mode: node agents and their workers dial in over
            # TCP (the AF_UNIX hub cannot leave the host — VERDICT r1).
            self.listener = Listener((host, port), family="AF_INET")
            lhost, lport = self.listener.address
            self.addr = f"tcp://{lhost}:{lport}"
        else:
            self.addr = os.path.join(session_dir, "hub.sock")
            self.listener = Listener(self.addr, family="AF_UNIX")
        self.max_workers = max_workers or max(4, int(resources.get("CPU", 4)))
        self.worker_env = dict(worker_env or {})
        head = NodeEntry(
            node_id="node0",
            hostname=_socket.gethostname(),
            ip=host,
            session_dir=session_dir,
            total=dict(resources),
            avail=dict(resources),
            free_tpu_chips=set(tpu_chip_ids or []),
            chip_coords=dict(tpu_chip_coords or {}),
            max_workers=self.max_workers,
            agent_conn=None,
            store_cap=object_store_memory,
        )
        self.nodes: Dict[str, NodeEntry] = {"node0": head}
        self.agent_conns: Dict[Any, str] = {}  # agent conn -> node_id
        # per-node LRU of live shm segments (oid -> size), oldest first
        from collections import OrderedDict as _OD

        self._lru: Dict[str, "_OD[bytes, int]"] = {"node0": _OD()}

        self.objects: Dict[bytes, ObjEntry] = {}
        self.functions: Dict[str, bytes] = {}
        self.tasks: Dict[bytes, TaskSpec] = {}  # pending+runnable normal tasks
        # Runnable tasks are queued per scheduling class (resource shape ×
        # placement pool), the reference's SchedulingKey idea (src/ray/
        # core_worker/transport/normal_task_submitter.h:45-58): placement is
        # tried only at each class's head, so a blocked class never costs a
        # scan and heterogeneous classes never block each other.
        self.runnable: Dict[tuple, deque] = {}
        self.workers: Dict[str, WorkerEntry] = {}
        self.conn_to_worker: Dict[Any, str] = {}
        # driver/client conns in HELLO order (value = (arrival seq,
        # monotonic HELLO stamp)): deterministic victim ordering for
        # chaos conn_kill, pruned on disconnect. The driver conn is
        # never a victim (killing it is session teardown by design —
        # driver fate-sharing), and neither is a conn younger than the
        # grace period below (a kill landing between a client's HELLO
        # and its first request reply tests the race, not recovery).
        self.client_conns: Dict[Any, tuple] = {}
        self._client_conn_seq = itertools.count()
        # dispatch generation counter for per-task execute timeouts
        self._exec_seq = itertools.count(1)
        self.actors: Dict[bytes, ActorEntry] = {}
        self.named_actors: Dict[Tuple[str, str], bytes] = {}
        # permanently-dead actor ids, FIFO: beyond the cap the oldest
        # tombstones leave the actor tables (GL009: handler-grown
        # registries need a pruning edge; the reference likewise caps
        # its dead-actor cache, gcs_actor_manager maxDestroyedActors)
        self._dead_actors: deque = deque()
        self.pgs: Dict[bytes, PGEntry] = {}
        # multi-tenant scheduling policy: priority + fair-share
        # ordering, quota admission, gang preemption (fairsched.py).
        # Inert (O(1) no-ops) until the first job/tenant registers.
        self.fairsched = FairScheduler()
        self._tenant_gauges: Dict[str, dict] = {}
        # durable KV backend (reference: GCS StorageType in-memory vs
        # redis — gcs_server.h; here an append-log + snapshot on the
        # head's disk, _private/store.py). None = in-memory only.
        from .store import open_store

        # explicit argument wins over the machine-wide env default, and
        # the store takes an exclusive flock so two hubs can't interleave
        # appends into one log
        self._kv_store = open_store(
            kv_store_path or os.environ.get("RAY_TPU_TORCH_KV_STORE_PATH"),
            fsync=os.environ.get("RAY_TPU_TORCH_KV_STORE_FSYNC", "")
            in ("1", "true", "yes"),
        )
        self.kv: Dict[bytes, bytes] = (
            self._kv_store.load() if self._kv_store else {}
        )
        self.get_reqs: List[GetReq] = []
        self.obj_get_waiters: Dict[bytes, List[GetReq]] = {}
        self.obj_wait_waiters: Dict[bytes, List[WaitReq]] = {}
        # readiness-push subscriptions (SUBSCRIBE_READY/READY_PUSH):
        # oid -> conns to push to when it becomes ready, plus the
        # reverse index for O(subscribed) disconnect pruning. Entries
        # leave on push, free, and disconnect.
        self._ready_watchers: Dict[bytes, List[Any]] = {}
        self._ready_watch_conns: Dict[int, Set[bytes]] = {}
        # retransmit dedup: clients resend slow GET/WAIT requests every
        # ~2s (lost-reply tolerance); while the original is still parked
        # here, the resend must NOT register a second full waiter set.
        # Keyed by (id(conn), req_id); purged on reply and on disconnect.
        self._inflight_reqs: Dict[Tuple[int, int], Any] = {}
        self.dep_waiters: Dict[bytes, List[TaskSpec]] = {}
        self.timers: List[Tuple[float, int, Any]] = []  # (deadline, seq, callback)
        self._timer_seq = itertools.count()
        self._fetch_seq = itertools.count()
        # fid -> (conn, request payload, node_id); the payload keeps its
        # req_id/offset/length so a node-death replay preserves chunk
        # identity
        self._pending_fetches: Dict[int, Tuple[Any, dict, str]] = {}
        # in-progress chunked client puts: (conn id, name) -> open file
        self._client_puts: Dict[Tuple[int, str], Any] = {}
        self._spawn_wants: Dict[str, int] = {}
        self.streams: Dict[bytes, StreamEntry] = {}
        self.subscribers: Dict[str, List[Any]] = {}  # channel -> conns
        # lineage: producer TaskSpec per shm object, for reconstruction
        # after node loss (reference: task_manager.h lineage pinning +
        # object_recovery_manager.h:43 re-executing the producing task)
        self._lineage: Dict[bytes, TaskSpec] = {}
        self._lineage_order: deque = deque()
        # ownership GC: refs released before their producing task
        # finished — freed the moment the value arrives. Insertion-
        # ordered dict so the (rare) entries for ids that never
        # materialize can be evicted oldest-first.
        self._released_early: Dict[bytes, bool] = {}
        self._reconstruct_waiters: Dict[bytes, List[Tuple[Any, dict]]] = {}
        self._reconstructing: Set[bytes] = set()
        self._ended_streams: deque = deque()  # consumed stream ids, FIFO
        # observability plane (reference: stats/metric.h registry +
        # core_worker/task_event_buffer.h -> GCS task events)
        self.metrics: Dict[Tuple[str, tuple], dict] = {}
        # flight recorder: bounded structured log of runtime events
        # (node up/down, worker exits, retries, spills, stream failures
        # ...) for post-mortem debugging — the built-in replacement for
        # grepping stderr, per "Collective Communication for 100k+
        # GPUs" (arxiv 2510.20171): at pod scale a bounded in-memory
        # recorder dumped on crash is what makes failures debuggable.
        # Exposed as list_state("events"), `ray_tpu events`, dashboard
        # /api/events, and dump_flight_recorder() on fatal error.
        self.events: deque = deque(maxlen=int(self.config.runtime_events_max))
        self._event_seq = itertools.count()
        self.task_events: deque = deque(maxlen=int(self.config.task_events_max))
        self._task_event_index: Dict[bytes, dict] = {}
        # tracing spans — user spans AND the runtime's own stage spans
        # (reference: ray.util.tracing's opentelemetry spans; here they
        # land in the same timeline). The flat deque feeds the
        # chrome-trace timeline; _trace_index groups the same records
        # per trace_id for list_state("traces") / the critical-path
        # analyzer — both bounded (oldest trace evicted whole).
        self.spans: deque = deque(maxlen=int(self.config.task_events_max))
        self._trace_index: Dict[str, list] = {}
        # running per-trace summaries, maintained span-by-span so the
        # list_state("traces") overview never rescans 512x1024 span
        # dicts on the state-plane thread (evicted with the trace)
        self._trace_summaries: Dict[str, dict] = {}
        self._trace_max = 512          # distinct traces kept
        self._trace_span_max = 1024    # spans kept per trace
        # return-object id -> trace ctx for traced tasks in flight: the
        # readiness push that unparks the caller's wait() stitches into
        # the trace through this map (popped on push; FIFO-bounded)
        self._traced_oids: Dict[bytes, tuple] = {}
        # whether runtime tracing can be live at all — only consulted
        # by reactor shards to decide whether to stamp ring-entry times
        # (the state plane itself is payload-driven: a "trace" field in
        # the message is the signal, so client-mode tracing works even
        # when the head's own env has sampling off)
        from ..util.tracing import make_runtime_record, runtime_sample_rate

        self._trace_on = runtime_sample_rate() > 0.0
        # pre-bound record builder: _emit_runtime_span runs per traced
        # hub stage — the per-call `from ..util.tracing import ...`
        # lookup was measurable at sampling 1.0 (tracing_overhead row)
        self._make_runtime_record = make_runtime_record
        # ---- sampling profiler (profiling.py): folded collapsed-stack
        # counts from every process's PROFILE_BATCH flushes, keyed
        # (pid, proc kind, thread domain, stage, task, stack). Bounded
        # at profile_store_max distinct keys; overflow samples are
        # counted in _profile_drops, never stored (GL009).
        self.profile_samples: Dict[tuple, int] = {}
        self.profile_procs: Dict[int, dict] = {}
        self._profile_drops = 0
        # the hub process's OWN sampler (started in _seed_timers when
        # config-gated on) hands batches over through this SPSC ring:
        # sampler thread appends, control thread drains on a timer —
        # the same single-writer hand-off as the shard rings (GL013)
        self._profile_inbox: deque = deque()
        self._profiler = None
        # parked `ray_tpu stack` requests awaiting a worker's
        # STACK_REPLY: token -> (requester conn, req_id, worker, pid);
        # bounded and timer-expired
        self._stack_waiters: Dict[int, tuple] = {}
        self._stack_token = itertools.count(1)
        self.driver_conn = None
        self._running = True
        self._dispatching = False
        self._dispatch_pending = False
        self._pg_counter = itertools.count(1)
        self._outbox: Dict[Any, List[tuple]] = {}
        # message dispatch table, built once: {msg_type: bound _on_*
        # method}. The reactor used to resolve handlers per message via
        # getattr(self, f"_on_{msg_type}") — an f-string build plus a
        # dynamic lookup on the hottest path in the system (graftlint
        # GL007 now guards against reintroducing that shape).
        self._handlers: Dict[str, Any] = {
            name[len("_on_"):]: getattr(self, name)
            for name in dir(type(self))
            if name.startswith("_on_")
        }
        # persistent reactor selector (epoll on Linux); fds are
        # registered on accept and unregistered on disconnect instead
        # of rebuilding the interest set every tick. Created by _run —
        # it lives and dies with the reactor thread.
        self._selector: Optional[selectors.BaseSelector] = None
        # ---- multi-reactor mode (hub_shards.py): with n_shards > 1,
        # connection I/O moves to N reactor-shard threads and THIS
        # thread becomes the state plane, hosting the scheduler and
        # object-directory services behind per-shard SPSC rings.
        from .hub_shards import StateService, resolve_shard_count

        self.n_shards = resolve_shard_count(self.config.get("hub_shards", 0))
        self._shards: list = []           # ReactorShard, sharded mode only
        self._shard_rings: list = []      # shard -> state-plane rings
        self._conn_shard: Dict[Any, int] = {}  # conn -> owning shard idx
        self._state_evt = threading.Event()
        # the two internally-owned state services; both execute on the
        # state-plane thread (single consumer), reached by message only
        self.state_services = {
            "scheduler": StateService("scheduler", self._dispatch_msg),
            "objects": StateService("objects", self._dispatch_msg),
        }
        # messages drained from one peer per reactor wake before other
        # ready peers get a turn (a batch frame charges its message
        # count); the selector is level-triggered, so residual input
        # re-arms the fd and the burst continues next wake (bounded
        # fairness, not starvation). 256 = two full client batches.
        self._drain_budget = 256
        # builtin runtime metrics (ray_tpu_* namespace) record straight
        # into self.metrics — the hub IS the registry, so no RPC to
        # itself (reference: src/ray/stats/metric_defs.cc ray_* series
        # from every component). Gated: RAY_TPU_TORCH_BUILTIN_METRICS=0 drops
        # the per-message timing AND keeps the registry clean.
        self._builtin_metrics = bool(self.config.builtin_metrics)
        # per-msg-type (counter, latency histogram) entries, cached so
        # the dispatch hot path pays one dict lookup, not registry math
        self._msg_metrics: Dict[str, tuple] = {}
        self._node_gauges: Dict[str, tuple] = {}
        self._seed_builtin_metrics()
        # out-of-band object plane: the head node's data-plane endpoint
        # (object_agent.py). Bulk segment bytes move through it —
        # threads of their own — so a multi-GB transfer never parks the
        # reactor behind a memcpy. Remote hosts run one inside their
        # node agent and register its endpoint.
        self.object_agent = None
        if self.config.object_agent:
            from .object_agent import ObjectAgent

            try:
                if tcp:
                    self.object_agent = ObjectAgent(
                        os.path.join(session_dir, "objects"),
                        spill_dir=self.spill_dir, host=host,
                    )
                else:
                    self.object_agent = ObjectAgent(
                        os.path.join(session_dir, "objects"),
                        spill_dir=self.spill_dir,
                        unix_path=os.path.join(session_dir, "object_agent.sock"),
                    )
                head.object_endpoint = self.object_agent.endpoint
            except OSError:
                log_exc("head object agent failed to start (relay only)")
        self._shutdown_evt = threading.Event()
        self.thread = threading.Thread(
            target=self._run if self.n_shards == 1 else self._run_sharded,
            daemon=True, name="ray-tpu-hub",
        )

    # ------------------------------------------------------------------ wire
    def start(self):
        self.thread.start()

    def _send(self, conn, msg_type: str, payload: dict):
        """Buffered send: messages accumulate per connection and are
        flushed once per drained inbound burst (up to _drain_budget
        messages) — one pickle + one syscall per peer per burst, so a
        submit storm produces one batched reply frame instead of one
        send per task. A blocking pipe write to a slow peer then
        stalls the reactor once per burst — the same reason the
        reference's raylet sends through an asio write queue."""
        q = self._outbox.get(conn)
        if q is None:
            q = self._outbox[conn] = []
        q.append((msg_type, payload))

    def _flush_outbox(self):
        if not self._outbox:
            return
        outbox, self._outbox = self._outbox, {}
        if self._shards:
            # sharded mode: each peer's socket has exactly ONE writer —
            # its owning reactor shard. Hand the batch over; the shard
            # encodes the frame (wire codec on the shard thread) and
            # counts the flush in its per-shard stats.
            shard_of = self._conn_shard
            shards = self._shards
            for conn, msgs in outbox.items():
                idx = shard_of.get(conn)
                if idx is None:
                    # peer never spoke (or already disconnected): there
                    # is no owner to write through — drop rather than
                    # interleave bytes into another shard's stream
                    continue
                shards[idx].post(conn, msgs)
            return
        for conn, msgs in outbox.items():
            self._bm_flushes["value"] += 1
            self._bm_observe(self._bm_flush_size, float(len(msgs)))
            try:
                if len(msgs) == 1:
                    conn.send_bytes(dumps_frame(msgs[0]))
                else:
                    conn.send_bytes(dumps_frame(("batch", msgs)))
            except (OSError, BrokenPipeError, EOFError):
                pass

    def _reply(self, conn, req_id: int, **payload):
        self._send(conn, P.REPLY, dict(payload, req_id=req_id))

    def _run(self):
        """The reactor: one persistent epoll/kqueue selector owns every
        fd for the hub's lifetime (the reference's asio io_context,
        instrumented_io_context.h). The previous shape re-registered
        every connection with a throwaway selector per tick
        (multiprocessing.connection.wait builds one internally) —
        O(conns) epoll_ctl syscalls per wake; now registration happens
        once per accept and teardown once per disconnect, and a wake
        costs a single epoll_wait regardless of fan-in."""
        self._seed_timers()
        self._record_event("hub_start", addr=self.addr)
        self.fairsched.bind_owner()  # single-owner discipline tripwire
        sel = self._selector = selectors.DefaultSelector()
        lsock = self.listener._listener._socket  # raw fd for readiness polling
        sel.register(lsock, selectors.EVENT_READ, None)  # data=None => accept
        try:
            self._reactor_loop(sel)
        except Exception:
            # anything escaping the per-connection guards is fatal to
            # the control plane: capture the post-mortem before the
            # session's state evaporates with this thread
            log_exc("hub reactor FATAL error")
            try:
                path = self.dump_flight_recorder("fatal_reactor_error")
                sys.stderr.write(f"[ray_tpu_torch] flight recorder dumped to {path}\n")
            except Exception:
                log_exc("flight recorder dump failed")
        # teardown
        self._teardown_runtime()
        if self.object_agent is not None:
            self.object_agent.close()
        try:
            self.listener.close()
        except Exception:
            pass
        try:
            sel.close()
        except Exception:
            pass
        self._shutdown_evt.set()

    def _reactor_loop(self, sel) -> None:
        while self._running:
            now = time.monotonic()
            while self.timers and self.timers[0][0] <= now:
                _, _, cb = heapq.heappop(self.timers)
                try:
                    cb()
                except Exception:
                    log_exc("hub timer error")
            self._flush_outbox()
            timeout = None
            if self.timers:
                timeout = max(0.0, self.timers[0][0] - time.monotonic())
            events = sel.select(timeout)
            self._bm_wakeups["value"] += 1
            for key, _mask in events:
                conn = key.data
                if conn is None:
                    try:
                        conn = self.listener.accept()
                        sel.register(conn, selectors.EVENT_READ, conn)
                    except Exception:
                        log_exc("hub accept error")
                    continue
                try:
                    # Drain this peer's burst to exhaustion — bounded:
                    # after _drain_budget frames, other ready peers get
                    # their turn and the level-triggered selector
                    # re-arms this fd for the remainder. Replies are
                    # buffered across the whole burst and flushed ONCE,
                    # so a 128-task submit storm produces one batched
                    # reply frame per peer instead of 128 sends.
                    budget = self._drain_budget
                    while True:
                        blob = conn.recv_bytes()
                        msg_type, payload = loads_frame(blob)
                        try:
                            self._handle(conn, msg_type, payload)
                        except Exception:
                            # A handler bug must never kill the control plane.
                            log_exc(f"hub handler error on {msg_type}")
                        # budget is counted in MESSAGES, not frames — a
                        # ("batch", [...]) frame carries up to 128, and
                        # charging it as 1 would let one peer hold the
                        # reactor for 128x the intended fairness bound
                        budget -= len(payload) if msg_type == "batch" else 1
                        if budget <= 0:
                            if conn.poll(0):
                                self._bm_drain_sat["value"] += 1
                            break
                        if not conn.poll(0):
                            break
                    self._flush_outbox()
                except (EOFError, OSError):
                    self._safe_disconnect(conn)
                except Exception:
                    # a stray bug in the recv/dispatch path must cost
                    # one connection, never the reactor thread — every
                    # client in the session hangs if this loop dies
                    log_exc("hub reactor error (dropping conn)")
                    self._safe_disconnect(conn)

    # ------------------------------------------------ sharded control plane
    def _seed_timers(self) -> None:
        """Periodic jobs shared by BOTH control-plane topologies — a
        timer added here runs with shards=1 and shards>1 alike."""
        self._add_timer(self.config.worker_reap_period_s, self._reap_workers)
        if self.config.memory_usage_threshold > 0:
            self._add_timer(
                self.config.memory_monitor_period_s, self._memory_monitor
            )
        if self.config.node_heartbeat_period_s > 0:
            self._add_timer(
                self.config.node_heartbeat_period_s, self._head_heartbeat
            )
            if self.config.node_heartbeat_miss_threshold > 0:
                self._add_timer(
                    self.config.node_heartbeat_period_s,
                    self._check_node_heartbeats,
                )
        if self._chaos is not None:
            # (re-)anchor the schedule clock to the control plane start
            self._chaos.arm()
            if self._chaos.timed:
                self._add_timer(0.05, self._chaos_tick)
        # hub-process sampler (profiling.py; default off — with
        # profile_hz 0 maybe_start creates nothing and no timer is
        # armed). In the local driver the process sampler may already
        # belong to the driver client; first caller wins and both sinks
        # see the same threads.
        from . import profiling as _profiling

        self._profiler = _profiling.maybe_start(
            "hub", self._profile_inbox.append,
            hz=self.config.get("profile_hz", 0.0),
            budget=self.config.get("profile_overhead_budget", 0.03),
            flush_period=self.config.get("profile_flush_period_s", 1.0),
        )
        if self._profiler is not None:
            self._add_timer(
                self._profiler.flush_period, self._drain_profile_inbox
            )

    def _teardown_runtime(self) -> None:
        """Shared epilogue: stop workers/agents and flush the last
        replies (both topologies run this before closing their I/O)."""
        for w in self.workers.values():
            self._kill_worker(w)
        for conn in list(self.agent_conns):
            self._send(conn, P.KILL, {})
        self._flush_outbox()
        # Drop pending one-shot timers: after teardown their callbacks
        # would fire into freed worker/agent tables (GL016).
        self.timers.clear()
        if self._profiler is not None:
            from . import profiling as _profiling

            _profiling.stop()
            self._profiler = None

    def _run_sharded(self):
        """State-plane main loop (n_shards > 1): reactor shards own the
        sockets; this thread owns every table and both state services.
        Mirrors _run's lifecycle (timers, fatal-error flight dump,
        teardown) with socket I/O delegated to the shards."""
        from .hub_shards import ReactorShard, ShardRing

        self._seed_timers()
        self._record_event("hub_start", addr=self.addr, shards=self.n_shards)
        self.fairsched.bind_owner()  # this thread IS the state plane
        rings = self._shard_rings = [
            ShardRing(self._state_evt.set) for _ in range(self.n_shards)
        ]
        shards = self._shards = [
            ReactorShard(
                i, rings[i], self._drain_budget,
                listener=self.listener if i == 0 else None,
                trace_on=self._trace_on,
            )
            for i in range(self.n_shards)
        ]
        for s in shards:
            s.peers = shards
        for s in shards:
            s.start()
        try:
            self._state_loop(rings)
        except Exception:
            log_exc("hub state plane FATAL error")
            try:
                path = self.dump_flight_recorder("fatal_state_plane_error")
                sys.stderr.write(f"[ray_tpu_torch] flight recorder dumped to {path}\n")
            except Exception:
                log_exc("flight recorder dump failed")
        # teardown — the shared epilogue, then stop the shards (each
        # flushes its outbound ring once more so the KILLs get out)
        self._teardown_runtime()
        for s in shards:
            s.stop()
        for s in shards:
            s.join(timeout=2.0)
        for s in shards:
            if not s.is_alive():
                # nothing can post to a joined shard: safe to release
                # its wake pipe (closing earlier risks a write into a
                # recycled fd number)
                s.close_wakeups()
        if self.object_agent is not None:
            self.object_agent.close()
        try:
            self.listener.close()
        except Exception:
            pass
        for conn in list(self._conn_shard):
            try:
                conn.close()
            except Exception:
                pass
        self._conn_shard.clear()
        self._shutdown_evt.set()

    def _state_loop(self, rings) -> None:
        from .hub_shards import CONN_LOST, SHARD_EVENT

        services = self.state_services
        while self._running:
            now = time.monotonic()
            while self.timers and self.timers[0][0] <= now:
                _, _, cb = heapq.heappop(self.timers)
                try:
                    cb()
                except Exception:
                    log_exc("hub timer error")
            self._flush_outbox()
            timeout = None
            if self.timers:
                timeout = max(0.0, self.timers[0][0] - time.monotonic())
            self._state_evt.wait(timeout)
            self._state_evt.clear()
            self._bm_wakeups["value"] += 1
            for idx, ring in enumerate(rings):
                for conn, service, msg_type, payload in ring.drain():
                    if msg_type == CONN_LOST:
                        self._conn_shard.pop(conn, None)
                        self._safe_disconnect(conn)
                        continue
                    if msg_type == SHARD_EVENT:
                        fields = dict(payload)
                        kind = fields.pop("kind")
                        self._record_event(kind, **fields)
                        if kind == "shard_fatal":
                            # a dead shard would otherwise half-kill the
                            # hub: accepts stop (shard 0) or 1-in-N new
                            # conns adopt into a ring nobody drains.
                            # Fail LOUDLY like the single-reactor fatal
                            # path: dump the post-mortem and tear the
                            # session down so every peer sees EOF.
                            log_exc_msg = (
                                f"[ray_tpu_torch] hub shard {fields.get('shard')} "
                                "died; shutting the control plane down\n"
                            )
                            sys.stderr.write(log_exc_msg)
                            try:
                                path = self.dump_flight_recorder(
                                    "shard_fatal")
                                sys.stderr.write(
                                    f"[ray_tpu_torch] flight recorder dumped "
                                    f"to {path}\n")
                            except Exception:
                                log_exc("flight recorder dump failed")
                            self._running = False
                        continue
                    self._conn_shard[conn] = idx
                    try:
                        # per-frame guard, like the single-reactor loop:
                        # a handler bug costs one frame, never the plane
                        self._handle_sharded(conn, service, msg_type,
                                             payload, services)
                    except Exception:
                        log_exc(f"hub state-plane error on {msg_type}")
            self._flush_outbox()

    def _handle_sharded(self, conn, service, msg_type, payload,
                        services) -> None:
        """_handle's sharded twin: route one shard-delivered message to
        its state service. Chaos shares _handle's single decision point
        (outer msg_type only, on the state-plane thread — so the seeded
        decision sequence is identical under both topologies); batch
        frames fan their inner messages out to each message's owning
        service, preserving arrival order. The only intended divergence
        from _handle is the per-service accounting seam
        (StateService.handle)."""
        trace_on = self._trace_on  # shards only stamp when sampling is on
        if trace_on:
            # pop ring stamps BEFORE the chaos seam: the ring crossing
            # already happened (the span is valid even for a frame chaos
            # then drops), and a delayed/dup redelivery must not carry a
            # stale stamp into its handler
            if msg_type == "batch":
                for _mt, pl in payload:
                    if type(pl) is dict and "_ring_t" in pl:
                        self._ring_wait_span(conn, pl)
            elif type(payload) is dict and "_ring_t" in payload:
                self._ring_wait_span(conn, payload)
        if self._chaos is not None and self._chaos_intercept(
            conn, msg_type, payload
        ):
            return  # injected drop/delay (redelivery is timer-driven)
        if msg_type == "batch":
            for mt, pl in payload:
                self._route_to_service(conn, mt, pl)
            return
        services.get(service, services["scheduler"]).handle(
            conn, msg_type, payload
        )

    def _route_to_service(self, conn, msg_type, payload) -> None:
        """Route one (non-batch) message to its owning StateService by
        SERVICE_OF — the ONE ownership rule batch fan-out and chaos
        redelivery share. (The non-batch ring path routes by the
        shard's service tag instead, which the shard derived from the
        same table.)"""
        from .hub_shards import SERVICE_OF

        svc = self.state_services[
            "objects" if SERVICE_OF.get(msg_type) == "objects"
            else "scheduler"
        ]
        svc.handle(conn, msg_type, payload)

    def _ring_wait_span(self, conn, payload: dict) -> None:
        """A traced message crossed a shard's SPSC ring: the owning
        shard stamped its decode time (hub_shards._stamp_trace, the
        shard's ONLY involvement — it never touches this span store,
        GL010); the delta to now is the ring-wait stage."""
        t_ring = payload.pop("_ring_t", None)
        tr = payload.get("trace")
        if t_ring is None or tr is None:
            return
        req_id = payload.get("req_id")
        if req_id is not None and (id(conn), req_id) in self._inflight_reqs:
            return  # retransmit of a parked request: one crossing span
        self._emit_runtime_span(
            "shard.ring_wait", "ring_wait", (tr[0], tr[1]),
            t_ring, time.monotonic(),
        )

    def _merge_shard_metrics(self) -> None:
        """Fold per-shard reactor counters (written only by their shard
        threads; read-only here) into the registry as shard-labelled
        builtin series, plus per-service message counts. Called at
        scrape time (list_state("metrics") / flight dump) so the hot
        path never pays for the merge. Single-reactor mode keeps the
        original untagged series untouched."""
        if not self._shards or not self._builtin_metrics:
            return
        for s in self._shards:
            # scrape-time read of the shard's monotonic counters: each
            # field is written only by its shard thread and is a plain
            # int (GIL-atomic load) — worst case one bump stale, never
            # torn. The documented merge-at-scrape pattern (README
            # "sharded control plane"), not a missing lock.
            st = s.stats  # graftlint: disable=GL013 — scrape-time monotonic counter read
            tags = (("shard", str(s.idx)),)
            self._bm(
                "ray_tpu_hub_reactor_wakeups_total", "counter",
                "reactor selector wake-ups", tags,
            )["value"] = float(st.wakeups)
            self._bm(
                "ray_tpu_hub_drain_budget_saturated_total", "counter",
                "bursts cut off by the per-peer drain budget with input "
                "still pending", tags,
            )["value"] = float(st.drain_saturated)
            self._bm(
                "ray_tpu_hub_outbox_flushes_total", "counter",
                "per-peer outbox flushes (one frame each)", tags,
            )["value"] = float(st.frames_sent)
            self._bm(
                "ray_tpu_hub_shard_conns", "gauge",
                "connections owned by this reactor shard", tags,
            )["value"] = float(st.conns)
            m = self._bm(
                "ray_tpu_hub_outbox_flush_messages", "histogram",
                "messages coalesced per outbox flush", tags,
                _ShardStats.FLUSH_BOUNDS,
            )
            m["sum"] = st.flush_sum
            m["count"] = st.flush_count
            for pair, c in zip(m["buckets"], st.flush_buckets):
                pair[1] = c
        for name, svc in self.state_services.items():
            self._bm(
                "ray_tpu_state_service_messages_total", "counter",
                "messages handled by this state service",
                (("service", name),),
            )["value"] = float(svc.processed)

    def _head_heartbeat(self) -> None:
        """Self-sample the head node's gauges (remote hosts report the
        same numbers via node-agent heartbeats, _on_node_heartbeat)."""
        head = self.nodes.get("node0")
        if head is not None:
            rss = self._worker_rss(os.getpid()) + sum(
                self._worker_rss(w.proc.pid)
                for w in self.workers.values()
                if w.proc is not None and w.node_id == "node0"
            )
            try:
                load = os.getloadavg()[0]
            except OSError:
                load = 0.0
            self._node_stat_gauges(
                "node0",
                rss_bytes=float(rss),
                cpu_load_1m=load,
                n_workers=float(sum(
                    1 for w in self.workers.values() if w.node_id == "node0"
                )),
            )
            self._bm_store_gauge(head)
            if self.object_agent is not None:
                self._object_direct_gauges("node0", self.object_agent.stats())
        self._add_timer(self.config.node_heartbeat_period_s, self._head_heartbeat)

    def _node_stat_gauges(self, node_id: str, **stats: float) -> None:
        tags = (("node_id", node_id),)
        for name, value in stats.items():
            self._bm(f"ray_tpu_node_{name}", "gauge",
                     "node-agent heartbeat stat", tags)["value"] = value

    def _on_node_heartbeat(self, conn, p):
        node = self.nodes.get(p.get("node_id", ""))
        if node is None or not node.alive:
            return
        node.last_heartbeat_t = time.monotonic()
        self._node_stat_gauges(
            node.node_id,
            rss_bytes=float(p.get("rss_bytes", 0.0)),
            cpu_load_1m=float(p.get("cpu_load_1m", 0.0)),
            n_workers=float(p.get("n_workers", 0.0)),
        )
        if p.get("object_agent"):
            self._object_direct_gauges(node.node_id, p["object_agent"])
        self._bm_store_gauge(node)

    def _add_timer(self, delay: float, cb):
        heapq.heappush(self.timers, (time.monotonic() + delay, next(self._timer_seq), cb))

    # ------------------------------------------- builtin runtime metrics
    # handler latencies are tens of µs; placement can take seconds when
    # a worker must spawn; flush sizes are message counts. The flush
    # bounds are THE shared constant (hub_shards.ShardStats) so the
    # per-shard bucket merge in _merge_shard_metrics can never zip
    # against mismatched boundaries.
    _LATENCY_BOUNDS = (50e-6, 200e-6, 1e-3, 5e-3, 25e-3, 0.1, 1.0)
    _PLACEMENT_BOUNDS = (1e-3, 5e-3, 25e-3, 0.1, 0.5, 2.0, 10.0)
    _FLUSH_BOUNDS = _ShardStats.FLUSH_BOUNDS

    def _bm(self, name: str, mtype: str, description: str = "",
            tags: tuple = (), boundaries: tuple = ()) -> dict:
        """Get-or-create a builtin registry entry — the same dict shape
        _on_metric_record aggregates into, so builtin series ride the
        existing snapshot()/prometheus_text()/dashboard surfaces for
        free. With builtin metrics disabled the entry is a detached
        dict: update paths stay branch-free, the registry stays clean."""
        if not self._builtin_metrics:
            return {"name": name, "type": mtype, "description": description,
                    "tags": tags, "value": 0.0, "sum": 0.0, "count": 0,
                    "buckets": [[b, 0] for b in boundaries]}
        key = (name, tags)
        m = self.metrics.get(key)
        if m is None:
            m = self.metrics[key] = {
                "name": name, "type": mtype, "description": description,
                "tags": tags, "value": 0.0, "sum": 0.0, "count": 0,
                "buckets": [[b, 0] for b in boundaries],
            }
        return m

    @staticmethod
    def _bm_observe(m: dict, value: float) -> None:
        m["sum"] += value
        m["count"] += 1
        for pair in m["buckets"]:
            if value <= pair[0]:
                pair[1] += 1
                break

    def _seed_builtin_metrics(self) -> None:
        """Pre-register the untagged builtin series (and cache direct
        entry references for the hot paths) so a scrape sees the full
        catalog at zero even before the first increment."""
        bm = self._bm
        self._bm_wakeups = bm(
            "ray_tpu_hub_reactor_wakeups_total", "counter",
            "reactor selector wake-ups")
        self._bm_drain_sat = bm(
            "ray_tpu_hub_drain_budget_saturated_total", "counter",
            "bursts cut off by the per-peer drain budget with input "
            "still pending")
        self._bm_flushes = bm(
            "ray_tpu_hub_outbox_flushes_total", "counter",
            "per-peer outbox flushes (one frame each)")
        self._bm_flush_size = bm(
            "ray_tpu_hub_outbox_flush_messages", "histogram",
            "messages coalesced per outbox flush",
            boundaries=self._FLUSH_BOUNDS)
        self._bm_queue_depth = bm(
            "ray_tpu_scheduler_queue_depth", "gauge",
            "runnable tasks queued across scheduling classes")
        self._bm_placement = bm(
            "ray_tpu_scheduler_placement_latency_seconds", "histogram",
            "submit-to-dispatch latency", boundaries=self._PLACEMENT_BOUNDS)
        self._bm_placed = bm(
            "ray_tpu_scheduler_tasks_placed_total", "counter",
            "tasks dispatched to a worker")
        self._bm_spawns = bm(
            "ray_tpu_scheduler_worker_spawns_total", "counter",
            "worker processes spawned")
        self._bm_task_fail = bm(
            "ray_tpu_tasks_failed_total", "counter",
            "tasks failed past their retry budget")
        self._bm_task_retry = bm(
            "ray_tpu_tasks_retried_total", "counter",
            "task retries (worker death or retry_exceptions)")
        self._bm_spills = bm(
            "ray_tpu_object_store_spilled_total", "counter",
            "shm segments spilled to disk")
        self._bm_restores = bm(
            "ray_tpu_object_store_restored_total", "counter",
            "spilled segments restored to shm")
        self._bm_credit_stalls = bm(
            "ray_tpu_stream_credit_stalls_total", "counter",
            "streaming-generator producers parked on backpressure credit")
        self._bm_events_total = bm(
            "ray_tpu_events_total", "counter",
            "flight-recorder events recorded")
        self._bm_preemptions = bm(
            "ray_tpu_sched_preemptions_total", "counter",
            "gangs (placement groups / tasks) preempted for "
            "higher-priority reservations")
        self._bm_pending_quota = bm(
            "ray_tpu_sched_pending_quota", "gauge",
            "tasks parked at admission by their tenant's quota")
        self._bm_obj_fallbacks = bm(
            "ray_tpu_object_fallbacks_total", "counter",
            "direct object transfers that fell back to the hub relay")
        # (oid, kind, reason) seen recently — a retransmitted first
        # chunk must not double-count its transfer's fallback
        self._fallback_seen: Dict[tuple, bool] = {}

    def _record_fallback(self, oid: bytes, reason: str, kind: str) -> None:
        """One direct-path transfer failed over to the hub relay:
        flight-recorder event + ray_tpu_object_fallbacks_total."""
        key = (oid, kind, reason)
        if key in self._fallback_seen:
            return  # retransmit of the same flagged chunk
        self._fallback_seen[key] = True
        while len(self._fallback_seen) > 1024:
            self._fallback_seen.pop(next(iter(self._fallback_seen)))
        self._bm_obj_fallbacks["value"] += 1
        self._record_event(
            "object_transfer_fallback",
            object_id=oid.hex() if isinstance(oid, bytes) else str(oid),
            op=kind, reason=str(reason)[:200],
        )

    def _object_direct_gauges(self, node_id: str, stats: dict) -> None:
        """Per-node out-of-band transfer counters (served + received
        bytes move through object agents, never this reactor — the
        numbers arrive on heartbeats)."""
        tags = (("node_id", node_id),)
        self._bm("ray_tpu_object_direct_bytes", "counter",
                 "bytes moved over the out-of-band object plane",
                 tags)["value"] = float(
            stats.get("bytes_served", 0) + stats.get("bytes_received", 0)
        )
        self._bm("ray_tpu_object_direct_transfers_total", "counter",
                 "completed out-of-band object transfers",
                 tags)["value"] = float(stats.get("transfers", 0))

    def _bm_store_gauge(self, node: NodeEntry) -> None:
        g = self._node_gauges.get(node.node_id)
        if g is None:
            tags = (("node_id", node.node_id),)
            g = self._node_gauges[node.node_id] = (
                self._bm("ray_tpu_object_store_bytes", "gauge",
                         "live shm segment bytes", tags),
                self._bm("ray_tpu_node_chips_in_use", "gauge",
                         "TPU chips not in the node's free pool", tags),
            )
        g[0]["value"] = node.store_used
        g[1]["value"] = float(
            node.total.get("GPU", 0.0)
        ) - len(node.free_tpu_chips)

    # ------------------------------------------------ flight recorder
    @staticmethod
    def _trace_fields(spec) -> dict:
        """Flight-recorder cross-link: when the task at hand is traced,
        its events (task_retry/task_failed/preemption/...) carry the
        trace_id so `ray_tpu events` and `ray_tpu trace` join up."""
        if spec is not None and spec.trace is not None:
            return {"trace_id": spec.trace[0]}
        return {}

    def _record_event(self, kind: str, **fields) -> None:
        ev = {"seq": next(self._event_seq), "ts": time.time(), "kind": kind}
        ev.update(fields)
        self.events.append(ev)
        self._bm_events_total["value"] += 1

    def _flight_doc(self, reason: str) -> dict:
        try:
            self._merge_shard_metrics()
        except Exception:
            pass  # post-mortem must survive a half-torn-down shard set
        return {
            "reason": reason,
            "dumped_at": time.time(),
            "shards": self.n_shards,
            # copy every row: json.dump runs AFTER the retry window, so
            # handing it live dicts the reactor still mutates would
            # reintroduce the mid-iteration crash the retry guards
            "events": [dict(e) for e in self.events],
            "metrics": [
                dict(m, tags=[list(t) for t in m["tags"]],
                     buckets=[list(b) for b in m["buckets"]])
                for m in list(self.metrics.values())
            ],
            "nodes": [
                {"node_id": n.node_id, "alive": n.alive, "ip": n.ip,
                 "resources": dict(n.total), "available": dict(n.avail),
                 "store_used": n.store_used}
                for n in list(self.nodes.values())
            ],
            "workers": [
                {"worker_id": w.worker_id, "state": w.state,
                 "node_id": w.node_id,
                 "pid": w.proc.pid if w.proc else None}
                for w in list(self.workers.values())
            ],
            "tasks": [dict(e) for e in list(self.task_events)[-200:]],
        }

    def dump_flight_recorder(self, reason: str = "manual") -> str:
        """Write events + registry + cluster tables to disk for
        post-mortem (called on reactor fatal error and head SIGTERM;
        RAY_TPU_TORCH_FLIGHT_RECORDER_PATH overrides the session-dir default).

        Callable from any thread: the reactor keeps mutating these
        structures while a SIGTERM handler or driver snapshots them, so
        a mid-iteration resize (RuntimeError) is retried — losing the
        post-mortem exactly when the system is busy defeats its point."""
        import json as _json

        path = (self.config.get("flight_recorder_path") or "").strip()
        if not path:
            path = os.path.join(self.session_dir, "flight_recorder.json")
        for attempt in range(4):
            try:
                doc = self._flight_doc(reason)
                break
            except RuntimeError:
                if attempt == 3:
                    raise
                time.sleep(0.05)
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            _json.dump(doc, f, default=str)
        os.replace(tmp, path)
        return path

    # ------------------------------------------------- fault injection
    # (chaos.py engine, hub scope). All methods below are reached only
    # behind `if self._chaos is not None` — the inert default costs one
    # attribute load per inbound frame.
    def _chaos_trace(self, msg_type: str, payload) -> dict:
        """trace_id cross-link for a fault event, when the victim
        message is traced — a fault then shows up inside its victim's
        trace via the PR 8 events<->trace join."""
        if msg_type != "batch" and type(payload) is dict:
            tr = payload.get("trace")
            if tr is not None:
                return {"trace_id": tr[0]}
        return {}

    def _chaos_intercept(self, conn, msg_type: str, payload) -> bool:
        """The ONE message-fault decision point both topologies share:
        drop/delay/dup are decided against the frame's OUTER msg_type
        (batch frames fault whole, never per inner message), and a
        partitioned node's conns are blackholed wholesale. Returns True
        when the frame must NOT be dispatched now."""
        eng = self._chaos
        if eng.partitions:
            nid = self.agent_conns.get(conn)
            if nid is None:
                wid = self.conn_to_worker.get(conn)
                if wid is not None:
                    w = self.workers.get(wid)
                    nid = w.node_id if w is not None else None
            if nid is not None and eng.partition_active(nid):
                eng.record("partition_drop", node_id=nid, msg_type=msg_type)
                self._record_event(
                    "chaos_partition_drop", node_id=nid, msg_type=msg_type,
                )
                return True
        act = eng.message_action(msg_type)
        if act is None:
            return False
        kind = act[0]
        if kind == "drop":
            self._record_event(
                "chaos_drop", msg_type=msg_type,
                **self._chaos_trace(msg_type, payload),
            )
            return True
        if kind == "delay":
            self._record_event(
                "chaos_delay", msg_type=msg_type, delay_s=round(act[1], 6),
                **self._chaos_trace(msg_type, payload),
            )
            self._add_timer(
                act[1],
                lambda c=conn, mt=msg_type, pl=payload:
                    self._dispatch_after_chaos(c, mt, pl),
            )
            return True
        # dup: deliver the duplicate first, then fall through to the
        # normal dispatch — exercises the retransmit-dedup and
        # idempotent-handler paths exactly like a replayed frame
        self._record_event(
            "chaos_dup", msg_type=msg_type,
            **self._chaos_trace(msg_type, payload),
        )
        self._dispatch_after_chaos(conn, msg_type, payload)
        return False

    def _dispatch_after_chaos(self, conn, msg_type: str, payload) -> None:
        """Chaos-exempt redelivery (the delayed copy / the duplicate):
        a second engine pass would re-draw and could delay forever.
        Sharded mode routes through the owning StateService so the
        per-service accounting seam counts redelivered frames exactly
        like first deliveries (timers run on the state-plane thread,
        the services' single owner)."""
        if getattr(conn, "closed", False):
            # the peer disconnected inside the delay window (both
            # topologies close the conn in _safe_disconnect): replaying
            # now would re-register the dead conn in stateful handlers
            # (_on_hello inserting it into client_conns/workers), and
            # no second CONN_LOST ever prunes it
            return
        try:
            if self._shards:
                if msg_type == "batch":
                    for mt, pl in payload:
                        self._route_to_service(conn, mt, pl)
                else:
                    self._route_to_service(conn, msg_type, payload)
            elif msg_type == "batch":
                for mt, pl in payload:
                    self._dispatch_msg(conn, mt, pl)
            else:
                self._dispatch_msg(conn, msg_type, payload)
        except Exception:
            log_exc(f"hub handler error on {msg_type} (chaos redelivery)")

    def _chaos_tick(self) -> None:
        """Execute due timed faults (conn_kill / worker_kill /
        worker_hang) against the live cluster tables; a fault with no
        eligible victim yet is deferred, not dropped — the schedule is
        the plan's, the victims are whatever the cluster offers."""
        eng = self._chaos
        for fault in list(eng.due_faults()):
            try:
                self._apply_timed_fault(eng, fault)
            except Exception:
                log_exc(f"chaos fault {fault.kind} failed")
                eng.consume(fault, fault.count - fault.fired)
        if eng.timed:
            self._add_timer(0.05, self._chaos_tick)

    def _apply_timed_fault(self, eng, fault) -> None:
        if fault.kind == "conn_kill":
            if fault.arg == "worker":
                victims = [
                    w.conn
                    for _, w in sorted(self.workers.items())
                    if w.conn is not None
                ]
            else:
                # established (post-grace) non-driver clients, oldest
                # first: a kill inside the HELLO->first-reply window
                # would test the connect race, not recovery
                now = time.monotonic()
                victims = [
                    c for c, (_seq, t0) in sorted(
                        self.client_conns.items(), key=lambda kv: kv[1][0]
                    )
                    if c is not self.driver_conn and now - t0 >= 0.5
                ]
            if not victims:
                eng.defer(fault)
                return
            eng.record("conn_kill", role=fault.arg)
            self._record_event("chaos_conn_kill", role=fault.arg)
            eng.consume(fault)
            self._expel_conn(victims[0])
            return
        # worker_kill / worker_hang: busy plain-task workers first (a
        # fault plane exists to hit in-flight work), then actors, then
        # idle pool members — ordered by worker id within each tier
        hang = fault.kind == "worker_hang"
        _tier = {"busy": 0, "actor": 1}

        def _reachable(w) -> bool:
            # hub-local proc handle, or a live agent that holds one
            # (remote faults ride P.KILL_WORKER with a sig field)
            if w.proc is not None:
                return True
            node = self.nodes.get(w.node_id)
            return (node is not None and node.alive
                    and node.agent_conn is not None)

        candidates = sorted(
            (w for w in self.workers.values()
             if w.conn is not None and _reachable(w)
             and w.state in ("busy", "actor", "idle")),
            key=lambda w: (_tier.get(w.state, 2), w.worker_id),
        )
        want = fault.count - fault.fired
        if not candidates:
            eng.defer(fault)
            return
        for w in candidates[:want]:
            spec = w.current_task
            fields = {
                "worker_id": w.worker_id, "node_id": w.node_id,
                **self._trace_fields(spec),
            }
            if spec is not None:
                fields["task_id"] = spec.task_id.hex()
            eng.record(fault.kind, worker_id=w.worker_id)
            self._record_event(f"chaos_{fault.kind}", **fields)
            eng.consume(fault)
            # "stop" = SIGSTOP: the process stalls mid-instruction but
            # its socket stays open — only the hung-worker watchdog /
            # per-task timeout_s can recover this. No _expel_conn here:
            # chaos leaves discovery to the runtime's own recovery.
            self._deliver_worker_signal(w, "stop" if hang else "kill")
        if fault.fired < fault.count:
            eng.defer(fault)

    def _expel_conn(self, conn) -> None:
        """Forcibly drop one peer connection (chaos conn_kill, or the
        heartbeat-miss watchdog evicting a partitioned node's agent).
        The peer sees EOF; registries clean up through the normal
        disconnect path."""
        if self._shards:
            idx = self._conn_shard.get(conn)
            if idx is not None:
                # the owning shard must do the unregister (its selector,
                # its thread); cleanup comes back as CONN_LOST
                self._shards[idx].expel(conn)
                return
        self._safe_disconnect(conn)

    def _check_node_heartbeats(self) -> None:
        """Heartbeat-miss node death (reference: GcsNodeManager's
        heartbeat timeout): an agent whose heartbeats stopped — network
        partition, frozen host — is declared dead after the configured
        number of missed periods; its conn is expelled so the normal
        node-death path (task retry elsewhere, reconstruction,
        __node_down__ invalidation) runs. Conn EOF remains the fast
        path; this catches the silent half-open case."""
        period = self.config.node_heartbeat_period_s
        limit = self.config.node_heartbeat_miss_threshold * period
        now = time.monotonic()
        for node in list(self.nodes.values()):
            if node.agent_conn is None or not node.alive:
                continue
            if node.last_heartbeat_t and now - node.last_heartbeat_t > limit:
                missed = (now - node.last_heartbeat_t) / period
                sys.stderr.write(
                    f"[ray_tpu_torch] node {node.node_id}: no heartbeat for "
                    f"{missed:.1f} periods; declaring it dead\n"
                )
                self._record_event(
                    "node_heartbeat_miss", node_id=node.node_id,
                    missed_periods=round(missed, 1),
                )
                self._expel_conn(node.agent_conn)
        self._add_timer(period, self._check_node_heartbeats)

    # -------------------------------------------------------------- dispatch
    def _handle(self, conn, msg_type: str, payload):
        """Table dispatch against the {msg_type: bound_method} map built
        in __init__ (no per-message reflection — GL007)."""
        if self._chaos is not None and self._chaos_intercept(
            conn, msg_type, payload
        ):
            return  # injected drop/delay (redelivery is timer-driven)
        if msg_type == "batch":
            for mt, pl in payload:
                self._dispatch_msg(conn, mt, pl)
            return
        self._dispatch_msg(conn, msg_type, payload)

    def _dispatch_msg(self, conn, msg_type: str, payload) -> None:
        handler = self._handlers.get(msg_type)
        if handler is None:
            return
        if not self._builtin_metrics:
            handler(conn, payload)
            return
        mm = self._msg_metrics.get(msg_type)
        if mm is None:
            tags = (("type", msg_type),)
            mm = self._msg_metrics[msg_type] = (
                self._bm("ray_tpu_hub_messages_total", "counter",
                         "messages handled, by type", tags),
                self._bm("ray_tpu_hub_handler_latency_seconds", "histogram",
                         "handler wall time, by message type", tags,
                         self._LATENCY_BOUNDS),
            )
        t0 = time.perf_counter()
        handler(conn, payload)
        dt = time.perf_counter() - t0
        mm[0]["value"] += 1
        self._bm_observe(mm[1], dt)

    def _ordered_nodes(self) -> List[NodeEntry]:
        """Alive nodes, head first (the hybrid policy's prefer-local)."""
        out = []
        head = self.nodes.get("node0")
        if head is not None and head.alive:
            out.append(head)
        for nid in sorted(self.nodes):
            n = self.nodes[nid]
            if n.alive and n is not head:
                out.append(n)
        return out

    def _node_worker_count(self, node_id: str) -> int:
        """Workers counted against the node's POOLED task-worker cap —
        actor-bound workers don't count (actors always get processes;
        the reference likewise grows its pool for actors rather than
        letting pinned actors starve task execution)."""
        return sum(
            1 for w in self.workers.values()
            if w.node_id == node_id
            and w.actor_id is None
            and not (
                w.current_task is not None and w.current_task.is_actor_create
            )
        )

    def _on_hello(self, conn, p):
        if p["role"] == "worker":
            wid = p["worker_id"]
            w = self.workers.get(wid)
            if w is None:
                w = WorkerEntry(worker_id=wid, node_id=p.get("node_id", "node0"))
                self.workers[wid] = w
            w.conn = conn
            w.state = "idle"
            w.pid = p.get("pid")
            w.connected_t = time.monotonic()
            self.conn_to_worker[conn] = wid
            node = self.nodes.get(w.node_id)
            if node is not None:
                node.spawning = max(0, node.spawning - 1)
                if w.spawned_for_actor:
                    node.spawning_actor = max(0, node.spawning_actor - 1)
            self._dispatch()
        elif p["role"] == "driver":
            self.driver_conn = conn
            self.client_conns[conn] = (
                next(self._client_conn_seq), time.monotonic(),
            )
        elif p["role"] == "client":
            # a remote driver (Ray Client parity) — its disconnect must
            # NOT tear the session down. Tracked (HELLO order) so chaos
            # conn_kill has a deterministic victim ordering.
            self.client_conns[conn] = (
                next(self._client_conn_seq), time.monotonic(),
            )

    def _on_register_node(self, conn, p):
        node = NodeEntry(
            node_id=p["node_id"],
            hostname=p["hostname"],
            ip=p["ip"],
            session_dir=p["session_dir"],
            total=dict(p["resources"]),
            avail=dict(p["resources"]),
            free_tpu_chips=set(p.get("tpu_chip_ids", [])),
            chip_coords={
                int(k): tuple(v)
                for k, v in (p.get("tpu_chip_coords") or {}).items()
            },
            max_workers=p.get("max_workers") or 4,
            agent_conn=conn,
            store_cap=float(p.get("store_cap") or 0),
            object_endpoint=p.get("object_endpoint") or "",
            last_heartbeat_t=time.monotonic(),
        )
        # dead nodes stay as tombstones for introspection/lineage
        self.nodes[node.node_id] = node  # graftlint: disable=GL009
        self.agent_conns[conn] = node.node_id
        self._record_event(
            "node_up", node_id=node.node_id, hostname=node.hostname,
            ip=node.ip, resources=dict(node.total),
        )
        self._reply(conn, p["req_id"], ok=True)
        self._dispatch()

    def _on_worker_exited(self, conn, p):
        """Agent-reported child death before the worker ever connected
        (post-connect deaths surface as conn EOF)."""
        w = self.workers.get(p["worker_id"])
        if w is not None and w.conn is None:
            node = self.nodes.get(w.node_id)
            if node is not None:
                node.spawning = max(0, node.spawning - 1)
                if w.spawned_for_actor:
                    node.spawning_actor = max(0, node.spawning_actor - 1)
            sys.stderr.write(
                f"[ray_tpu_torch] worker {w.worker_id} on {w.node_id} exited with "
                f"code {p.get('code')} before connecting\n"
            )
            self._record_event(
                "worker_spawn_failed", worker_id=w.worker_id,
                node_id=w.node_id, code=p.get("code"),
            )
            self.workers.pop(w.worker_id, None)
            self._dispatch()

    # ----- objects
    def _conn_node(self, conn) -> str:
        wid = self.conn_to_worker.get(conn)
        if wid is not None:
            w = self.workers.get(wid)
            if w is not None:
                return w.node_id
        return "node0"  # driver and hub live on the head node

    def _conn_label(self, conn) -> str:
        """Stable human-readable identity of a peer for ownership
        attribution: a worker id, "driver", "client-N" (HELLO order),
        or "hub" for hub-internal calls (conn=None)."""
        if conn is None:
            return "hub"
        wid = self.conn_to_worker.get(conn)
        if wid is not None:
            return wid
        if conn is self.driver_conn:
            return "driver"
        ent = self.client_conns.get(conn)
        if ent is not None:
            return f"client-{ent[0]}"
        return ""

    def _owner_alive(self, owner: str) -> bool:
        """Does the owning process still hold a live control conn? A
        ready object whose owner is gone can never be released by
        owner-side GC — `ray_tpu memory --leak-suspects` keys on this.
        Unknown/placeholder owners count as alive (no false alarms)."""
        if not owner or owner == "hub":
            return True
        if owner == "driver":
            return self.driver_conn is not None
        if owner.startswith("client-"):
            return any(
                f"client-{seq}" == owner
                for seq, _t in self.client_conns.values()
            )
        w = self.workers.get(owner)
        return w is not None and w.conn is not None

    def _on_put(self, conn, p):
        tr = p.get("trace")
        if tr is None:
            self._object_ready(
                p["object_id"], p["kind"], p["payload"], p.get("size", 0),
                node_id=self._conn_node(conn), owner=self._conn_label(conn),
            )
            return
        t0 = time.monotonic()
        self._object_ready(
            p["object_id"], p["kind"], p["payload"], p.get("size", 0),
            node_id=self._conn_node(conn), owner=self._conn_label(conn),
        )
        self._emit_runtime_span(
            "hub.put", "put", (tr[0], tr[1]), t0, time.monotonic(),
            object_id=p["object_id"].hex(), size=p.get("size", 0),
        )

    def _object_ready(self, oid: bytes, kind: str, payload: Any, size: int,
                      node_id: str = "node0", owner: str = ""):
        e = self.objects.get(oid)
        if e is None:
            e = self.objects[oid] = ObjEntry()
        if owner and not e.owner:
            e.owner = owner
        if e.ready:
            return
        e.ready, e.kind, e.payload, e.size = True, kind, payload, size
        e.node_id = node_id
        if kind == P.VAL_SHM and size > 0:
            self._account_segment(oid, e)
        self._reconstructing.discard(oid)
        # serve fetches that were parked on reconstruction: replay the
        # ORIGINAL request payload — a chunked fetch keeps its
        # offset/length, so the reply slots into the client's
        # reassembly exactly where the pre-death chunk would have
        for wconn, req in self._reconstruct_waiters.pop(oid, []):
            self._on_fetch_object(wconn, req)
        # unblock task dependencies
        for spec in self.dep_waiters.pop(oid, []):
            spec.deps_remaining -= 1
            if spec.deps_remaining == 0:
                if spec.method is not None:
                    actor = self.actors.get(spec.actor_id)
                    if actor is None or actor.state == "dead":
                        from ..exceptions import ActorDiedError

                        blob = dumps_inline(ActorDiedError(msg="Actor is dead."))
                        for roid in spec.return_ids:
                            self._object_ready(roid, P.VAL_ERROR, blob, 0)
                        self._unpin_deps(spec)
                    else:
                        self._route_actor_call(actor, spec)
                else:
                    self._enqueue_runnable(spec)
        # fulfill GET waiters
        for req in self.obj_get_waiters.pop(oid, []):
            if req.done:
                continue
            req.remaining.discard(oid)
            if not req.remaining:
                self._fulfill_get(req)
        # readiness push: one P.READY_PUSH per subscribed conn (batched
        # into that peer's next outbox flush alongside everything else)
        self._push_ready(oid)
        # fulfill WAIT waiters (registration is per-occurrence, so a req
        # appearing k times in the list gets k increments — consistent
        # with duplicate ids in the original request)
        for req in self.obj_wait_waiters.pop(oid, []):
            if req.done:
                continue
            req.n_ready += 1
            if req.n_ready >= req.num_returns:
                self._fulfill_wait(req)
        # ownership GC: the owner released this ref before the value
        # arrived — nothing can fetch it, free right away (unless an
        # in-flight task pinned it as an arg)
        if self._released_early.pop(oid, None):
            if e.pins > 0:
                e.release_pending = True
            else:
                self._free_ids([oid])
        self._dispatch()

    # ---- shm budget: LRU accounting + disk spill (reference: plasma
    # eviction_policy.h + _private/external_storage.py:72 filesystem spill)
    def _account_segment(self, oid: bytes, e: ObjEntry):
        node = self.nodes.get(e.node_id)
        if node is None:
            return
        lru = self._lru.setdefault(e.node_id, __import__("collections").OrderedDict())
        if oid not in lru:
            node.store_used += e.size
        lru[oid] = e.size
        lru.move_to_end(oid)
        self._maybe_spill(node)
        self._bm_store_gauge(node)

    def _touch_segment(self, oid: bytes, e: ObjEntry):
        lru = self._lru.get(e.node_id)
        if lru is not None and oid in lru:
            lru.move_to_end(oid)

    def _drop_segment_accounting(self, oid: bytes, e: ObjEntry):
        lru = self._lru.get(e.node_id)
        if lru is not None:
            size = lru.pop(oid, None)
            if size is not None:
                node = self.nodes.get(e.node_id)
                if node is not None:
                    node.store_used = max(0.0, node.store_used - size)
                    self._bm_store_gauge(node)

    def _maybe_spill(self, node: NodeEntry):
        if node.store_cap <= 0 or node.store_used <= node.store_cap:
            return
        lru = self._lru.get(node.node_id)
        if not lru:
            return
        # oldest-first until under the cap; never spill the newest entry
        # (it may be the object being created right now)
        victims = []
        for oid in list(lru.keys())[:-1]:
            if node.store_used <= node.store_cap:
                break
            size = lru.pop(oid)
            node.store_used = max(0.0, node.store_used - size)
            victims.append(oid)
        for oid in victims:
            e = self.objects.get(oid)
            if e is None or e.spilled:
                continue
            e.spilled = True
            self._bm_spills["value"] += 1
            self._record_event(
                "spill", object_id=oid.hex(), size=e.size,
                node_id=node.node_id,
            )
            if node.agent_conn is None:
                os.makedirs(self.spill_dir, exist_ok=True)
                src = os.path.join(node.session_dir, "objects", e.payload)
                try:
                    import shutil as _sh

                    # shutil.move: tmpfs -> disk crosses filesystems, where
                    # os.replace would raise EXDEV
                    _sh.move(src, os.path.join(self.spill_dir, e.payload))
                except OSError as err:
                    sys.stderr.write(f"[ray_tpu_torch] spill failed: {err}\n")
                    e.spilled = False
            else:
                self._send(node.agent_conn, "obj_spill", {"name": e.payload})

    def _fulfill_get(self, req: GetReq):
        req.done = True
        self._inflight_reqs.pop((id(req.conn), req.req_id), None)
        values = []
        for oid in req.all_ids:
            e = self.objects[oid]
            if e.kind == P.VAL_SHM:
                self._touch_segment(oid, e)
            values.append((oid, e.kind, e.payload))
        self._reply(req.conn, req.req_id, values=values)

    def _on_get(self, conn, p):
        tr = p.get("trace")
        if tr is None or (id(conn), p["req_id"]) in self._inflight_reqs:
            # untraced, or a ~2s retransmit of a still-parked request:
            # one hub.get span per logical get, not one per resend (a
            # get parked on a 60s task would otherwise burn ~30 spans
            # of the trace's cap)
            return self._handle_get(conn, p)
        # handler time only — a parked GET's wait belongs to the
        # producing task's stages, not to this span
        t0 = time.monotonic()
        try:
            return self._handle_get(conn, p)
        finally:
            self._emit_runtime_span(
                "hub.get", "get", (tr[0], tr[1]), t0, time.monotonic(),
                n=len(p.get("object_ids", ())),
            )

    def _handle_get(self, conn, p):
        key = (id(conn), p["req_id"])
        if key in self._inflight_reqs:
            return  # retransmit of a still-parked request; reply will come
        ids = p["object_ids"]
        missing = {oid for oid in ids if not self.objects.get(oid, ObjEntry()).ready}
        req = GetReq(conn=conn, req_id=p["req_id"], remaining=missing, all_ids=ids)
        if not missing:
            self._fulfill_get(req)
            return
        self._inflight_reqs[key] = req
        for oid in missing:
            if oid not in self.objects:
                self.objects[oid] = ObjEntry()
            self.obj_get_waiters.setdefault(oid, []).append(req)
        timeout = p.get("timeout")
        if timeout is not None:
            def expire(req=req):
                if not req.done:
                    req.done = True
                    self._inflight_reqs.pop((id(req.conn), req.req_id), None)
                    self._unregister_get_waiter(req)
                    self._reply(req.conn, req.req_id, timeout=True)
            self._add_timer(timeout, expire)

    def _unregister_get_waiter(self, req: GetReq):
        """Expired GETs must leave the per-object waiter lists, or
        requests on never-created objects accumulate forever (r1 Weak
        finding: hub waiter leak)."""
        for oid in req.remaining:
            lst = self.obj_get_waiters.get(oid)
            if lst is not None:
                try:
                    lst.remove(req)
                except ValueError:
                    pass
                if not lst:
                    del self.obj_get_waiters[oid]

    def _unregister_wait_waiter(self, req: WaitReq):
        for oid in req.ids:
            lst = self.obj_wait_waiters.get(oid)
            if lst is not None:
                try:
                    lst.remove(req)
                except ValueError:
                    pass
                if not lst:
                    del self.obj_wait_waiters[oid]

    def _fulfill_wait(self, req: WaitReq, expired: bool = False):
        """One final O(n) pass to build the reply; all intermediate
        progress was tracked incrementally in req.n_ready."""
        ready_all = []
        for oid in req.ids:
            e = self.objects.get(oid)
            if e is not None and e.ready:
                ready_all.append(oid)
        if not expired and len(ready_all) < req.num_returns:
            # a counted-ready object reverted (freed, or un-readied by
            # node-loss reconstruction) after the initial scan; rebuild
            # the incremental state and keep waiting (rare path)
            self._unregister_wait_waiter(req)
            req.n_ready = len(ready_all)
            for oid in req.ids:
                if oid not in self.objects:
                    self.objects[oid] = ObjEntry()
                if not self.objects[oid].ready:
                    self.obj_wait_waiters.setdefault(oid, []).append(req)
            return
        req.done = True
        self._inflight_reqs.pop((id(req.conn), req.req_id), None)
        self._unregister_wait_waiter(req)
        ready = ready_all[: req.num_returns]
        rset = set(ready)
        self._reply(
            req.conn,
            req.req_id,
            ready=ready,
            not_ready=[o for o in req.ids if o not in rset],
            # readiness beyond the quota: the client caches these so a
            # wait() pop-loop drains locally instead of round-tripping
            # per ref (the reference serves the same case from the core
            # worker's local memory store)
            also_ready=ready_all[req.num_returns:],
        )

    def _on_wait(self, conn, p):
        key = (id(conn), p["req_id"])
        if key in self._inflight_reqs:
            return  # retransmit of a still-parked request; reply will come
        ids = p["object_ids"]
        req = WaitReq(
            conn=conn,
            req_id=p["req_id"],
            ids=ids,
            num_returns=min(p["num_returns"], len(ids)),
        )
        for oid in ids:
            e = self.objects.get(oid)
            if e is not None and e.ready:
                req.n_ready += 1
        if req.n_ready >= req.num_returns:
            self._fulfill_wait(req)
            return
        self._inflight_reqs[key] = req
        for oid in ids:
            if oid not in self.objects:
                self.objects[oid] = ObjEntry()
            if not self.objects[oid].ready:
                self.obj_wait_waiters.setdefault(oid, []).append(req)
        timeout = p.get("timeout")
        if timeout is not None:
            def expire(req=req):
                if not req.done:
                    self._fulfill_wait(req, expired=True)
            self._add_timer(timeout, expire)

    def _on_release_owned(self, conn, p):
        """Ownership GC: the owner's last local handle died with the ref
        never pickled, so no other holder can exist. Free immediately if
        the value is ready; otherwise remember and free on arrival
        (the producing task may still be running)."""
        for oid in p["object_ids"]:
            e = self.objects.get(oid)
            if e is None or not e.ready:
                self._released_early[oid] = True
                while len(self._released_early) > 100_000:
                    self._released_early.pop(
                        next(iter(self._released_early))
                    )
                continue
            if e.pins > 0:
                # in-flight task (or live actor) still depends on this
                # object: defer the free to the last unpin
                e.release_pending = True
                continue
            if (
                self.obj_get_waiters.get(oid)
                or self.obj_wait_waiters.get(oid)
                or self.dep_waiters.get(oid)
            ):
                continue  # defensive: someone is mid-get; keep it
            self._free_ids([oid])

    def _unpin_deps(self, spec: Optional[TaskSpec]):
        """Drop a finalized task's dependency pins; free objects whose
        owner already released them. Idempotent (pinned_deps is
        consumed) so overlapping finalization paths are safe."""
        if spec is None or not spec.pinned_deps:
            return
        deps, spec.pinned_deps = spec.pinned_deps, []
        self._unpin_ids(deps)

    def _unpin_ids(self, ids: List[bytes]):
        for oid in ids:
            e = self.objects.get(oid)
            if e is None:
                continue
            e.pins -= 1
            if e.pins <= 0 and e.release_pending and e.ready:
                self._free_ids([oid])

    def _on_free(self, conn, p):
        self._free_ids(p["object_ids"])

    def _free_ids(self, object_ids):
        freed_shm = []
        for oid in object_ids:
            e = self.objects.pop(oid, None)
            self._drop_ready_watch(oid)
            if e and e.kind == P.VAL_SHM:
                freed_shm.append(oid)
                self._drop_segment_accounting(oid, e)
                # unlink on EVERY node: cross-node fetches install copies
                # under the same segment name on consumer hosts
                for path in (
                    os.path.join(self.session_dir, "objects", e.payload),
                    os.path.join(self.spill_dir, e.payload),
                ):
                    try:
                        os.unlink(path)
                    except OSError:
                        pass
                for node in self.nodes.values():
                    if node.alive and node.agent_conn is not None:
                        self._send(node.agent_conn, P.OBJ_UNLINK,
                                   {"name": e.payload})
        # clients cache wait()-readiness locally (_known_ready); shm
        # frees invalidate those entries so a freed object stops
        # reporting ready. Inline frees are deliberately not broadcast —
        # they dominate free traffic (every small task return) and their
        # values are usually already cached client-side.
        if freed_shm and self.subscribers.get("__obj_freed__"):
            self._publish("__obj_freed__", freed_shm)

    # ----- out-of-band object plane: ownership/location directory
    def _on_resolve_object(self, conn, p):
        """Where does an object live? Returns the owner node's (or, if
        the owner died, a replica's) segment name, object-agent
        endpoint, and local file path so the consumer can move the
        bytes WITHOUT the hub (object_agent.py). Clients cache the
        reply; __obj_freed__ / __node_down__ pubsub invalidate it.
        A {node_id} query (no object_id) resolves just that node's
        endpoint — used by client-mode direct puts to find the head."""
        oid = p.get("object_id")
        if oid is None:
            node = self.nodes.get(p.get("node_id", ""))
            self._reply(conn, p["req_id"],
                        endpoint=node.object_endpoint if node else "")
            return
        e = self.objects.get(oid)
        if e is None or not e.ready or e.kind != P.VAL_SHM:
            self._reply(conn, p["req_id"], error="no such segment")
            return
        node = self.nodes.get(e.node_id)
        if node is None or not node.alive:
            node = None
            for nid in sorted(e.replicas or ()):
                cand = self.nodes.get(nid)
                if cand is not None and cand.alive:
                    node = cand
                    break
            if node is None:
                # owner and every replica are gone: the relay path owns
                # reconstruction (_on_fetch_object lineage rerun)
                self._reply(conn, p["req_id"], error="object location lost")
                return
        payload = {
            "name": e.payload,
            "node_id": node.node_id,
            "endpoint": node.object_endpoint,
            "hostname": node.hostname,
            "path": os.path.join(node.session_dir, "objects", e.payload),
            # spilled objects stay on the relay: the hub's fetch path
            # owns the restore-under-accounting step (and a same-node
            # consumer must not quietly duplicate a spilled segment
            # outside the store cap's books)
            "spilled": e.spilled,
        }
        self._reply(conn, p["req_id"], **payload)

    def _on_replica_added(self, conn, p):
        """A direct fetch installed a copy on the sender's node: record
        it so resolution can fail over if the owner dies. Replica sets
        die with their ObjEntry (free/GC) — no separate pruning."""
        e = self.objects.get(p.get("object_id"))
        node_id = p.get("node_id")
        if e is None or not e.ready or e.kind != P.VAL_SHM or not node_id:
            return
        if node_id != e.node_id:
            if e.replicas is None:
                e.replicas = set()
            e.replicas.add(node_id)

    # ----- readiness push (SUBSCRIBE_READY -> READY_PUSH)
    def _on_subscribe_ready(self, conn, p):
        """Register the connection for a readiness push on each not-yet
        -ready id; reply with the subset that is already ready. The
        push fires from _object_ready, so a wait() pop-loop costs one
        subscription instead of a round trip per poll."""
        ready = []
        watched = self._ready_watch_conns.setdefault(id(conn), set())
        for oid in p["object_ids"]:
            e = self.objects.get(oid)
            if e is not None and e.ready:
                ready.append(oid)
                continue
            if e is None:
                self.objects[oid] = ObjEntry()
            watchers = self._ready_watchers.setdefault(oid, [])
            if conn not in watchers:
                watchers.append(conn)
                watched.add(oid)
        if not watched:
            self._ready_watch_conns.pop(id(conn), None)
        self._reply(conn, p["req_id"], ready=ready)

    def _push_ready(self, oid: bytes) -> None:
        watchers = self._ready_watchers.pop(oid, None)
        if not watchers:
            return
        if self._traced_oids:
            tr = self._traced_oids.pop(oid, None)
            if tr is not None:
                # near-instant marker: when the hub told the waiting
                # client its traced result was ready (readiness push)
                now = time.monotonic()
                self._emit_runtime_span(
                    "hub.ready_push", "ready_push", tr, now, now,
                    object_id=oid.hex(), n_watchers=len(watchers),
                )
        for conn in watchers:
            self._send(conn, P.READY_PUSH, {"ready": [oid]})
            watched = self._ready_watch_conns.get(id(conn))
            if watched is not None:
                watched.discard(oid)
                if not watched:
                    self._ready_watch_conns.pop(id(conn), None)

    def _drop_ready_watch(self, oid: bytes) -> None:
        """Forget watchers of a freed id (no push: the object will
        never become ready; waiters re-sync on their retry period)."""
        for conn in self._ready_watchers.pop(oid, ()):
            watched = self._ready_watch_conns.get(id(conn))
            if watched is not None:
                watched.discard(oid)
                if not watched:
                    self._ready_watch_conns.pop(id(conn), None)

    def _on_fetch_object(self, conn, p):
        """Cross-node shm fetch: the consumer's local store misses, so the
        bytes are pulled from the producer node through the control plane
        (the reference's object manager push/pull, simplified: metadata
        and transfer share the hub connection — fine for control-plane
        sizes; TPU bulk tensors ride ICI collectives, not the store)."""
        if p.get("fallback"):
            # first relay chunk of a failed direct transfer: record it
            # (once per transfer — only offset 0 carries the flag)
            self._record_fallback(p["object_id"], p["fallback"], "fetch")
        oid = p["object_id"]
        if oid in self._reconstructing:
            # a fetch racing an in-flight lineage rerun (the backoff
            # retransmit of the very request that triggered it, or a
            # second consumer): the entry is marked not-ready for the
            # whole reconstruction window, so falling through to the
            # "no such segment" reply would turn a recoverable wait
            # into ObjectLostError at the client. Park it beside the
            # fetch that started the rerun (idempotent per req_id).
            waiters = self._reconstruct_waiters.setdefault(oid, [])
            if not any(
                w[0] is conn and w[1]["req_id"] == p["req_id"]
                for w in waiters
            ):
                waiters.append((conn, self._park_fetch_payload(p)))
                # same give-up bound as the kick-off fetch: a rerun
                # that never completes must fail these waiters too
                self._add_timer(60.0, lambda oid=oid: self._reconstruct_give_up(oid))
            return
        e = self.objects.get(oid)
        if e is None or not e.ready or e.kind != P.VAL_SHM:
            self._reply(conn, p["req_id"], data=None, error="no such segment")
            return
        node = self.nodes.get(e.node_id)
        if node is None or not node.alive:
            # primary copy died with its node: reconstruct by re-running
            # the producing task (reference: ObjectRecoveryManager)
            spec = self._lineage.get(p["object_id"])
            if spec is not None:
                self._reconstruct_waiters.setdefault(oid, []).append(
                    (conn, self._park_fetch_payload(p))
                )
                self._add_timer(
                    60.0, lambda oid=oid: self._reconstruct_give_up(oid)
                )
                if p["object_id"] not in self._reconstructing:
                    self._reconstructing.update(spec.return_ids)
                    for roid in spec.return_ids:
                        entry = self.objects.get(roid)
                        if entry is not None:
                            self._drop_segment_accounting(roid, entry)
                            entry.ready = False
                            entry.spilled = False
                    spec.retries_left = max(spec.retries_left, 1)
                    spec.options.pop("_pool", None)
                    self.tasks[spec.task_id] = spec
                    self._enqueue_runnable(spec)
                return
            self._reply(conn, p["req_id"], data=None,
                        error=f"object lost: node {e.node_id} is gone")
            return
        same_node = self._conn_node(conn) == e.node_id
        if e.spilled and same_node:
            # the consumer will reinstall the segment into this node's
            # shm anyway — restore it under accounting (possibly spilling
            # colder objects) so the cap stays authoritative
            if node.agent_conn is None:
                try:
                    import shutil as _sh

                    _sh.move(
                        os.path.join(self.spill_dir, e.payload),
                        os.path.join(node.session_dir, "objects", e.payload),
                    )
                    e.spilled = False
                except OSError:
                    pass
            else:
                self._send(node.agent_conn, P.OBJ_RESTORE, {"name": e.payload})
                e.spilled = False
            if not e.spilled:
                self._bm_restores["value"] += 1
                self._account_segment(p["object_id"], e)
        offset = p.get("offset")
        length = p.get("length")
        if node.agent_conn is None:
            path = os.path.join(
                self.spill_dir if e.spilled else
                os.path.join(node.session_dir, "objects"),
                e.payload,
            )
            try:
                with open(path, "rb") as f:
                    if offset is None:
                        data, total = f.read(), None
                    else:
                        # chunked streaming for shm-less clients
                        # (reference: dataservicer.py chunked GetObject)
                        total = os.fstat(f.fileno()).st_size
                        f.seek(offset)
                        data = f.read(length)
            except OSError as err:
                self._reply(conn, p["req_id"], data=None, error=str(err))
                return
            self._reply(conn, p["req_id"], data=data, total=total)
            return
        fid = next(self._fetch_seq)
        self._pending_fetches[fid] = (
            conn, self._park_fetch_payload(p), node.node_id
        )
        self._send(node.agent_conn, P.OBJ_READ,
                   {"fetch_id": fid, "name": e.payload,
                    "offset": offset, "length": length})

    def _on_obj_read_reply(self, conn, p):
        waiter = self._pending_fetches.pop(p["fetch_id"], None)
        if waiter is None:
            return
        self._reply(waiter[0], waiter[1]["req_id"], data=p.get("data"),
                    error=p.get("error"), total=p.get("total"))

    # ----- chunked client puts (shm-less client -> head-node store;
    # reference: util/client/server/dataservicer.py PutObject chunking)
    def _on_put_chunk(self, conn, p):
        e = self.objects.get(p["object_id"])
        if e is not None and e.ready:
            # replayed chunk after the stream completed (retransmit of
            # a lost-reply tail): the first `last` already sealed the
            # segment synchronously, so anything arriving now must not
            # reopen the stream or clobber the installed file
            return
        if p.get("fallback"):
            self._record_fallback(p["object_id"], p["fallback"], "put")
        name = p["name"]
        key = (id(conn), name)
        objdir = os.path.join(self.session_dir, "objects")
        tmp = os.path.join(objdir, f".client.{key[0]:x}.{name}")
        st = self._client_puts.get(key)
        try:
            if st is None:
                os.makedirs(objdir, exist_ok=True)
                st = self._client_puts[key] = open(tmp, "wb")
            if isinstance(st, tuple):  # stream already failed
                raise OSError(st[1])
            # explicit offset makes replays idempotent: a retransmitted
            # chunk seeks back and rewrites the same bytes instead of
            # appending them again (and the final size below is
            # tell() = offset+len of the true last chunk, so offset
            # accounting can't double-advance either)
            if p.get("offset") is not None:
                st.seek(p["offset"])
            st.write(p["data"])
        except OSError as err:
            # poison the stream: later chunks are dropped and the LAST
            # chunk publishes an error object so the producer's
            # follow-up get/consume surfaces the failure instead of a
            # truncated segment
            if not isinstance(st, tuple):
                try:
                    if st is not None:
                        st.close()
                    os.unlink(tmp)
                except OSError:
                    pass
            self._client_puts[key] = ("failed", str(err))
            if p.get("last"):
                self._client_puts.pop(key, None)
                self._object_ready(
                    p["object_id"], P.VAL_ERROR,
                    dumps_inline(OSError(
                        f"client put of {name} failed hub-side: {err}"
                    )), 0,
                )
            return
        if p.get("last"):
            self._client_puts.pop(key, None)
            size = st.tell()
            st.close()
            os.replace(tmp, os.path.join(objdir, name))
            self._object_ready(
                p["object_id"], P.VAL_SHM, name, size, node_id="node0"
            )

    @staticmethod
    def _park_fetch_payload(p: dict) -> dict:
        """The request payload to replay after reconstruction: keep
        req_id/offset/length (chunk identity), drop the fallback flag —
        the original delivery already recorded the transfer fallback."""
        req = dict(p)
        req.pop("fallback", None)
        return req

    def _reconstruct_give_up(self, oid: bytes) -> None:
        """Reconstruction watchdog: a rerun left unplaceable (resources
        gone) or stuck past the 60s budget fails its parked fetches
        instead of hanging them forever."""
        for wconn, req in self._reconstruct_waiters.pop(oid, []):
            self._reply(wconn, req["req_id"], data=None,
                        error="object lost: reconstruction timed out")
        self._reconstructing.discard(oid)

    def _fail_fetches_for_node(self, node_id: str):
        """Relay fetches in flight to a node that just died: replay each
        one through _on_fetch_object, which now sees the dead node and
        either parks it on a lineage rerun (reconstruction) or fails it
        with an explicit error — never a silent hang (clients wait with
        timeout=None)."""
        stale = [fid for fid, w in self._pending_fetches.items() if w[2] == node_id]
        for fid in stale:
            conn, req, _ = self._pending_fetches.pop(fid)
            if req["object_id"] in self._lineage:
                self._on_fetch_object(conn, req)
            else:
                self._reply(conn, req["req_id"], data=None,
                            error=f"object lost: node {node_id} died mid-fetch")

    # ----- streaming generators
    def _stream(self, task_id: bytes) -> StreamEntry:
        s = self.streams.get(task_id)
        if s is None:
            s = self.streams[task_id] = StreamEntry()
        return s

    def _on_stream_yield(self, conn, p):
        s = self._stream(p["task_id"])
        idx = len(s.oids)
        self._object_ready(
            p["object_id"], p["kind"], p["payload"], p.get("size", 0),
            node_id=self._conn_node(conn),
        )
        s.oids.append(p["object_id"])
        for wconn, req_id in s.next_waiters.pop(idx, []):
            s.consumed = max(s.consumed, idx + 1)
            self._reply(wconn, req_id, object_id=p["object_id"])
        self._wake_credit_waiters(s)

    def _on_stream_end(self, conn, p):
        s = self._stream(p["task_id"])
        if p.get("error") is not None:
            self._task_event(p["task_id"], state="FAILED",
                             finished_at=time.time(),
                             t_finished=time.monotonic())
            self._record_event(
                "stream_failure", task_id=p["task_id"].hex(),
                yielded=len(s.oids),
            )
            # the N+1-th ref carries the error (reference semantics)
            from .ids import ObjectID

            err_oid = ObjectID.generate().binary()
            self._object_ready(err_oid, P.VAL_ERROR, p["error"], 0)
            idx = len(s.oids)
            s.oids.append(err_oid)
            for wconn, req_id in s.next_waiters.pop(idx, []):
                self._reply(wconn, req_id, object_id=err_oid)
        s.ended = True
        for idx, waiters in list(s.next_waiters.items()):
            if idx >= len(s.oids):
                for wconn, req_id in waiters:
                    self._reply(wconn, req_id, end=True)
                del s.next_waiters[idx]
        # release any backpressured producer (it is done anyway)
        self._wake_credit_waiters(s, force=True)

    def _end_stream_with_error(self, task_id: bytes, err_blob) -> None:
        # _stream (not .get): a task failing before its first yield AND
        # before the consumer's first next() must still leave an ended
        # stream, or that first next() parks forever
        s = self._stream(task_id)
        if s.ended:
            return
        self._on_stream_end(None, {"task_id": task_id, "error": err_blob})

    def _on_stream_next(self, conn, p):
        s = self._stream(p["task_id"])
        idx = p["index"]
        if idx < len(s.oids):
            s.consumed = max(s.consumed, idx + 1)
            self._reply(conn, p["req_id"], object_id=s.oids[idx])
            self._wake_credit_waiters(s)
        elif s.ended:
            self._reply(conn, p["req_id"], end=True)
            # consumer reached the end: drop the payload index (objects
            # have their own lifecycle) and cap retained tombstones so
            # the registry cannot grow without bound
            if s.oids:
                s.oids = []
                self._ended_streams.append(p["task_id"])
                while len(self._ended_streams) > 10000:
                    old = self._ended_streams.popleft()
                    self.streams.pop(old, None)
        else:
            s.next_waiters.setdefault(idx, []).append((conn, p["req_id"]))

    def _on_stream_credit(self, conn, p):
        s = self._stream(p["task_id"])
        if s.consumed >= p["min_consumed"] or s.ended:
            self._reply(conn, p["req_id"], ok=True)
        else:
            self._bm_credit_stalls["value"] += 1
            s.credit_waiters.append((p["min_consumed"], conn, p["req_id"]))

    def _wake_credit_waiters(self, s: StreamEntry, force: bool = False):
        still = []
        for min_consumed, conn, req_id in s.credit_waiters:
            if force or s.consumed >= min_consumed:
                self._reply(conn, req_id, ok=True)
            else:
                still.append((min_consumed, conn, req_id))
        s.credit_waiters = still

    # ----- tracing spans (reference: ray.util.tracing + the task-event
    # pipeline; here one store serves the timeline AND the per-trace
    # critical-path queries)
    def _on_span_record(self, conn, p):
        """Finished tracing span from any process (util/tracing.py)."""
        self._record_span(p)

    def _record_span(self, rec: dict) -> None:
        self.spans.append(rec)
        tid = rec.get("trace_id")
        if not tid:
            return
        idx = self._trace_index
        summaries = self._trace_summaries
        lst = idx.get(tid)
        if lst is None:
            lst = idx[tid] = []
            summaries[tid] = {
                "trace_id": tid, "n_spans": 0,
                "start": rec["start"], "end": rec["end"],
                "root": rec.get("name", ""), "rooted": False,
                "procs": set(),
            }
            while len(idx) > self._trace_max:  # FIFO: oldest trace out
                old = next(iter(idx))
                idx.pop(old)
                summaries.pop(old, None)
        if len(lst) < self._trace_span_max:
            lst.append(rec)
            summ = summaries.get(tid)
            if summ is not None:
                summ["n_spans"] += 1
                if rec["start"] < summ["start"]:
                    summ["start"] = rec["start"]
                if rec["end"] > summ["end"]:
                    summ["end"] = rec["end"]
                if rec.get("parent_id") is None and not summ["rooted"]:
                    # the first parentless span is the trace root; until
                    # one arrives the first span's name stands in
                    summ["root"] = rec.get("name", "")
                    summ["rooted"] = True
                summ["procs"].add((rec.get("node_id"), rec.get("pid")))

    def _emit_runtime_span(self, name: str, stage: str, trace: tuple,
                           t0: float, t1: float,
                           parent: Optional[str] = None,
                           **attrs) -> str:
        """Record one hub-side runtime span (state-plane thread only —
        in sharded mode shards funnel their measurements through the
        ring instead of calling this, GL010). Returns the span id so a
        caller can parent further spans under it."""
        rec = self._make_runtime_record(
            name, stage, trace[0],
            parent if parent is not None else trace[1],
            t0, t1, node_id="node0", **attrs,
        )
        self._record_span(rec)
        return rec["span_id"]

    def _on_metric_record(self, conn, p):
        key = (p["name"], p["tags"])
        m = self.metrics.get(key)
        if m is None:
            # cardinality is bounded by distinct (name, tags) series —
            # a scrape registry, not a per-request table
            m = self.metrics[key] = {  # graftlint: disable=GL009
                "name": p["name"],
                "type": p["type"],
                "description": p.get("description", ""),
                "tags": p["tags"],
                "value": 0.0,
                "sum": 0.0,
                "count": 0,
                # defensively re-sort: first-match bucketing below is
                # only correct on ascending boundaries (the Histogram
                # constructor validates, but raw senders bypass it)
                "buckets": [[b, 0] for b in sorted(p.get("boundaries", ()))],
            }
        elif m["type"] != p["type"]:
            # first-wins: the record still lands in the original entry
            # (unchanged semantics), but the conflict is no longer
            # silent — one flight-recorder event per (name, tags) key
            if not m.get("type_conflict"):
                m["type_conflict"] = True
                self._record_event(
                    "metric_type_conflict", name=p["name"],
                    registered=m["type"], attempted=p["type"],
                )
        op = p["op"]
        if op == "add":
            m["value"] += p["value"]
        elif op == "set":
            m["value"] = p["value"]
        elif op == "observe":
            m["sum"] += p["value"]
            m["count"] += 1
            for pair in m["buckets"]:
                if p["value"] <= pair[0]:
                    pair[1] += 1
                    break

    # ----- sampling profiler ingest (profiling.py): every process's
    # sampler folds locally and flushes PROFILE_BATCH once a flush
    # period; the hub is the aggregation point list_state("profile")
    # and `ray_tpu profile` read from.
    def _drain_profile_inbox(self) -> None:
        # hub's own sampler hands batches over via the SPSC inbox
        # (sampler thread appends, this thread drains) — same
        # discipline as the shard rings
        while True:
            try:
                batch = self._profile_inbox.popleft()
            except IndexError:
                break
            self._on_profile_batch(None, batch)
        if self._profiler is not None:
            self._add_timer(
                self._profiler.flush_period, self._drain_profile_inbox
            )

    def _on_profile_batch(self, conn, p):
        pid = p.get("pid")
        kind = p.get("kind") or "?"
        samples = p.get("samples") or {}
        cap = int(self.config.get("profile_store_max", 4096) or 4096)
        for key, n in samples.items():
            if not (isinstance(key, tuple) and len(key) == 4):
                continue
            skey = (pid, kind) + key
            if skey in self.profile_samples:
                self.profile_samples[skey] += n
            elif len(self.profile_samples) < cap:
                # bounded by profile_store_max with drops counter below
                self.profile_samples[skey] = n  # graftlint: disable=GL009
            else:
                # cap reached: count what we shed so the CLI can say
                # "N samples dropped" instead of silently under-reporting
                self._profile_drops += n
        while len(self.profile_procs) >= 256 and pid not in self.profile_procs:
            self.profile_procs.pop(next(iter(self.profile_procs)))
        self.profile_procs[pid] = {
            "kind": kind,
            "overhead": float(p.get("overhead") or 0.0),
            "hz": float(p.get("hz") or 0.0),
            "last_t": time.monotonic(),
        }
        self._bm(
            "ray_tpu_profiler_overhead_ratio", "gauge",
            "sampling profiler self-overhead (sample-pass time / wall)",
            (("pid", str(pid)),),
        )["value"] = float(p.get("overhead") or 0.0)

    # ----- remote stack dumps (`ray_tpu stack`): works with the
    # profiler OFF — the hub dumps its own threads inline; a worker
    # dump parks the request on a token and forwards STACK_DUMP, whose
    # STACK_REPLY is matched back here (timer-expired, bounded).
    def _on_stack_request(self, conn, p):
        target = str(p.get("target") or "hub")
        req_id = p.get("req_id")
        if target in ("hub", "head") or target == str(os.getpid()):
            from . import profiling as _profiling

            self._reply(
                conn, req_id, target="hub", pid=os.getpid(),
                threads=_profiling.dump_threads(),
            )
            return
        w = None
        for wid, entry in self.workers.items():
            if wid == target or wid.startswith(target):
                w = entry
                break
        if w is None and target.isdigit():
            for entry in self.workers.values():
                if entry.pid == int(target):
                    w = entry
                    break
        if w is None or w.conn is None:
            self._reply(
                conn, req_id, target=target, threads=[],
                error=f"no live worker matches {target!r}",
            )
            return
        if len(self._stack_waiters) >= 256:
            tok0 = next(iter(self._stack_waiters))
            self._stack_timeout(tok0)
        token = next(self._stack_token)
        self._stack_waiters[token] = (  # graftlint: disable=GL009
            conn, req_id, w.worker_id, w.pid,
        )
        self._send(w.conn, P.STACK_DUMP, {"token": token})
        self._add_timer(5.0, lambda t=token: self._stack_timeout(t))

    def _stack_timeout(self, token: int) -> None:
        waiter = self._stack_waiters.pop(token, None)
        if waiter is None:
            return
        conn, req_id, wid, _pid = waiter
        self._reply(
            conn, req_id, target=wid, threads=[],
            error=f"stack dump of {wid} timed out",
        )

    def _on_stack_reply(self, conn, p):
        waiter = self._stack_waiters.pop(p.get("token"), None)
        if waiter is None:
            return  # late reply after timeout — already answered
        rconn, req_id, wid, wpid = waiter
        self._reply(
            rconn, req_id, target=wid,
            pid=p.get("pid") or wpid,
            threads=p.get("threads") or [],
        )

    # ----- task events (reference: core_worker/task_event_buffer.h;
    # feeds list_state("tasks") + the chrome-trace timeline)
    def _task_event(self, task_id: bytes, **fields) -> dict:
        ev = self._task_event_index.get(task_id)
        if ev is None:
            ev = {"task_id": task_id.hex()}
            self._task_event_index[task_id] = ev
            self.task_events.append(ev)
            # dicts are insertion-ordered: evict oldest in O(1) per event
            # (materializing the key list here was O(n) per TASK once the
            # index filled — it halved actor-call throughput after 20k
            # lifetime tasks)
            while len(self._task_event_index) > self.task_events.maxlen:
                self._task_event_index.pop(
                    next(iter(self._task_event_index))
                )
        ev.update(fields)
        return ev

    # ----- pubsub (reference: src/ray/pubsub/publisher.h:300 — here a
    # direct push over the subscriber's persistent connection)
    def _on_subscribe(self, conn, p):
        # channel-name cardinality bounded; conns pruned on disconnect
        subs = self.subscribers.setdefault(p["channel"], [])  # graftlint: disable=GL009
        if conn not in subs:
            subs.append(conn)

    def _on_publish(self, conn, p):
        # client-published user data arrives pre-serialized as a
        # cloudpickle "blob" (client.publish) so the plain-pickle frame
        # codec never sees raw user objects; it is forwarded opaque and
        # unwrapped by the subscribing client's reader
        self._publish(p["channel"], p.get("data"), blob=p.get("blob"))

    def _publish(self, channel: str, data=None, blob=None) -> None:
        # dead conns are pruned by _handle_disconnect; _send tolerates
        # races with a closing socket
        if blob is not None:
            body = {"channel": channel, "blob": blob}
        else:
            # hub-internal publishes (__logs__, __obj_freed__) are
            # plain dicts/lists of primitives — frame-codec safe as-is
            body = {"channel": channel, "data": data}
        for sub in self.subscribers.get(channel, ()):
            self._send(sub, P.PUBSUB_MSG, body)

    def _on_log_record(self, conn, p):
        # worker stdout/stderr lines fan out to log subscribers (the
        # reference's log_monitor -> driver pattern)
        wid = self.conn_to_worker.get(conn, "?")
        self._publish("__logs__", dict(p, worker_id=wid))

    # ----- jobs (multi-tenant scheduling registry)
    def _on_register_job(self, conn, p):
        """Register a driver/job's scheduling identity: tenant id,
        priority, optional quota (fairsched). Called from
        init(job_config=...) and by submitted jobs; pruned when the
        registering connection goes away (_handle_disconnect)."""
        entry = self.fairsched.register_job(
            p.get("job_id") or f"job-{id(conn):x}",
            tenant=p.get("tenant") or "default",
            priority=self.fairsched.priority_of(p),
            quota=p.get("quota"),  # tri-state: None keeps the old cap
            conn_id=id(conn),
        )
        self._record_event(
            "job_registered", job_id=entry.job_id, tenant=entry.tenant,
            priority=entry.priority, quota=dict(entry.quota),
        )
        # a lowered quota can strand parked work that now exceeds the
        # cap outright — fail it loudly rather than wedge the queue
        cap = self.fairsched.tenants.get(entry.tenant)
        for spec in self.fairsched.pop_infeasible(entry.tenant):
            self._fail_task(spec, ValueError(
                f"task requires {spec.resources} but tenant "
                f"'{entry.tenant}' quota is now "
                f"{cap.quota if cap else {}} — it can never be admitted"
            ))
        self._refresh_pending_quota_gauge()
        self._reply(conn, p["req_id"], ok=True)
        self._dispatch()  # a quota change can unblock parked work

    # ----- functions
    def _on_register_function(self, conn, p):
        # content-addressed export table: retries and late-spawning
        # workers may fetch any registered fn for the session's life
        self.functions[p["fn_id"]] = p["blob"]  # graftlint: disable=GL009

    def _on_get_function(self, conn, p):
        self._reply(conn, p["req_id"], blob=self.functions.get(p["fn_id"]))

    # ----- kv
    def _on_kv_put(self, conn, p):
        if not p.get("overwrite", True) and p["key"] in self.kv:
            self._reply(conn, p["req_id"], ok=False)
            return
        self.kv[p["key"]] = p["value"]
        if self._kv_store is not None:
            self._kv_store.record_put(p["key"], p["value"])
        self._reply(conn, p["req_id"], ok=True)

    def _on_kv_get(self, conn, p):
        self._reply(conn, p["req_id"], value=self.kv.get(p["key"]))

    def _on_kv_del(self, conn, p):
        ok = self.kv.pop(p["key"], None) is not None
        if ok and self._kv_store is not None:
            self._kv_store.record_del(p["key"])
        self._reply(conn, p["req_id"], ok=ok)

    def _on_kv_keys(self, conn, p):
        prefix = p["prefix"]
        self._reply(conn, p["req_id"], keys=[k for k in self.kv if k.startswith(prefix)])

    # ----- tasks
    def _on_submit_task(self, conn, p):
        if p["task_id"] in self._task_event_index:
            # duplicate delivery (chaos dup / a replayed frame): the
            # task is already pending, running, or done — admitting a
            # second TaskSpec would double-run it and double-charge
            # quota. Ids are client-generated and unique, so a re-seen
            # id is always a duplicate, never a new task.
            return
        spec = TaskSpec(
            task_id=p["task_id"],
            fn_id=p["fn_id"],
            args_kind=p["args_kind"],
            args_payload=p["args_payload"],
            return_ids=p["return_ids"],
            resources=p["resources"],
            options=p["options"],
            retries_left=p["options"].get("max_retries", 3),
            owner=self._conn_label(conn),
        )
        tr = p.get("trace")
        if tr is None:
            self._admit(spec, p.get("arg_deps", []))
            return
        # sampled submit: the admit span covers dep registration, quota
        # admission, and any synchronous dispatch pass it triggers
        spec.trace = (tr[0], tr[1])
        t0 = time.monotonic()
        self._admit(spec, p.get("arg_deps", []))
        self._emit_runtime_span(
            "hub.admit", "admit", spec.trace, t0, time.monotonic(),
            task_id=spec.task_id.hex(),
        )

    def _on_submit_tasks(self, conn, p):
        """Bulk admission: N homogeneous tasks from ONE wire frame
        (client.submit_many / RemoteFunction.map). Shared fields
        (fn_id/resources/options) are hoisted into the outer payload;
        the batch is admitted in one pass — one fairsched fold over
        the deps-clear specs, one dedup-index insert per task, and a
        SINGLE scheduler wake at the end instead of N. Per-conn FIFO
        holds: tasks enter the runnable queues in list order, exactly
        as N sequential SUBMIT_TASKs would."""
        fn_id = p["fn_id"]
        resources = p["resources"]
        base_opts = p["options"]
        retries = base_opts.get("max_retries", 3)
        tr = p.get("trace")
        t0 = time.monotonic()
        owner_label = self._conn_label(conn)
        fresh: List[TaskSpec] = []
        for t in p["tasks"]:
            if t["task_id"] in self._task_event_index:
                # replayed batch (retransmit after a lost ack) or chaos
                # dup: every already-seen task is pending/running/done
                continue
            spec = TaskSpec(
                task_id=t["task_id"],
                fn_id=fn_id,
                args_kind=t["args_kind"],
                args_payload=t["args_payload"],
                return_ids=t["return_ids"],
                resources=resources,
                # per-task copy: fairsched stamps _fs_counted and the
                # scheduler mutates options in place — sharing the
                # frame's dict across specs would cross-contaminate
                options=dict(base_opts),
                retries_left=retries,
                owner=owner_label,
                # bulk pipelining is an opt-IN the explicit bulk paths
                # (map/submit_many) keep by default; auto-batched plain
                # .remote() frames splice "pipeline": False so strict
                # per-call placement semantics survive the batching
                bulk=p.get("pipeline", True),
            )
            if tr is not None:
                spec.trace = (tr[0], tr[1])
            self._admit(spec, t["arg_deps"], enqueue=False)
            if spec.deps_remaining == 0:
                fresh.append(spec)
        if fresh:
            try:
                verdicts = self.fairsched.admit_many(fresh)
            except QuotaInfeasibleError as err:
                for spec in fresh:
                    self.tasks[spec.task_id] = spec
                    self._fail_task(spec, ValueError(str(err)))
                verdicts = None
            if verdicts is not None:
                parked = False
                for spec, ok in zip(fresh, verdicts):
                    if ok:
                        self._enqueue_ready(spec, dispatch=False)
                    else:
                        self.tasks[spec.task_id] = spec
                        self._task_event(spec.task_id,
                                         state="PENDING_QUOTA")
                        parked = True
                if parked:
                    self._refresh_pending_quota_gauge()
        if tr is not None:
            # one client.submit span fans out to N hub.admit children;
            # each child gets a 1/N slice of the admission window so
            # the per-stage durations still partition wall time
            t1 = time.monotonic()
            n = max(len(p["tasks"]), 1)
            dt = (t1 - t0) / n
            for i, t in enumerate(p["tasks"]):
                self._emit_runtime_span(
                    "hub.admit", "admit", (tr[0], tr[1]),
                    t0 + i * dt, t0 + (i + 1) * dt,
                    task_id=t["task_id"].hex(),
                )
        req_id = p.get("req_id")
        if req_id is not None:
            self._reply(conn, req_id, ok=True, admitted=len(fresh))
        self._dispatch()

    def _admit(self, spec: TaskSpec, deps: List[bytes],
               enqueue: bool = True):
        pending = 0
        for dep in deps:
            e = self.objects.get(dep)
            if e is None:
                e = self.objects[dep] = ObjEntry()
            e.pins += 1
            spec.pinned_deps.append(dep)
            if not e.ready:
                pending += 1
                self.dep_waiters.setdefault(dep, []).append(spec)
        spec.deps_remaining = pending
        self.tasks[spec.task_id] = spec
        # lifecycle stamps: wall clocks (submitted_at/...) are display
        # timestamps for the timeline; the t_* monotonic twins are what
        # durations (queue wait, run time) are computed from — wall
        # deltas step with NTP (graftlint GL008 guards the distinction)
        ev = self._task_event(
            spec.task_id, name=spec.fn_id or (spec.method or ""),
            state="PENDING_ARGS" if pending else "PENDING_SCHEDULING",
            submitted_at=time.time(), t_submit=time.monotonic(),
        )
        if spec.trace is not None:
            # the trace id rides the task event so flight-recorder
            # entries (retry/fail/preempt) and the timeline cross-link
            ev["trace_id"] = spec.trace[0]
        if pending == 0 and enqueue:
            self._enqueue_runnable(spec)

    def _sched_class(self, spec: TaskSpec) -> tuple:
        pg = spec.options.get("placement_group")
        res_key = tuple(sorted(spec.resources.items()))
        # tenant and priority terminate the tuple — fairsched's class
        # ordering reads them positionally (class_order_key)
        return (res_key, pg[0] if pg else None, pg[1] if pg else None,
                spec.options.get("runtime_env_hash", ""),
                spec.options.get("tenant") or "default",
                self.fairsched.priority_of(spec.options))

    def _enqueue_runnable(self, spec: TaskSpec):
        try:
            admitted = self.fairsched.admit(spec)
        except QuotaInfeasibleError as err:
            # the request exceeds the quota outright: it could never be
            # admitted — fail loudly instead of parking forever (and
            # wedging the tenant's FIFO queue behind it)
            self.tasks[spec.task_id] = spec
            self._fail_task(spec, ValueError(str(err)))
            return
        if not admitted:
            # over-quota: parked in the tenant's pending_quota queue;
            # re-admitted by _dispatch_once as finishing work frees room
            self.tasks[spec.task_id] = spec
            self._task_event(spec.task_id, state="PENDING_QUOTA")
            self._refresh_pending_quota_gauge()
            return
        self._enqueue_ready(spec)

    def _refresh_pending_quota_gauge(self) -> None:
        self._bm_pending_quota["value"] = float(
            self.fairsched.parked_count()
        )

    def _enqueue_ready(self, spec: TaskSpec, dispatch: bool = True):
        key = self._sched_class(spec)
        q = self.runnable.get(key)
        if q is None:
            q = self.runnable[key] = deque()
        q.append(spec)
        # deps resolved: the task is now scheduler-visible (a retry
        # re-stamps, so the breakdown reflects the latest attempt)
        ev = self._task_event_index.get(spec.task_id)
        if ev is not None:
            ev["t_queued"] = time.monotonic()
        if dispatch:
            self._dispatch()

    def _resources_fit(self, need: Dict[str, float], avail: Dict[str, float]) -> bool:
        return all(avail.get(k, 0.0) + 1e-9 >= v for k, v in need.items())

    def _acquire(self, need: Dict[str, float], avail: Dict[str, float]):
        for k, v in need.items():
            avail[k] = avail.get(k, 0.0) - v

    def _release(self, need: Dict[str, float], avail: Dict[str, float]):
        for k, v in need.items():
            avail[k] = avail.get(k, 0.0) + v

    def _effective_pools(self, spec: TaskSpec):
        """Resource pools this task draws from: node-wide, or a PG bundle."""
        pg = spec.options.get("placement_group")
        if pg:
            pg_id, bundle_idx = pg
            entry = self.pgs.get(pg_id)
            if entry is None:
                return None  # PG removed; fail the task
            if not entry.ready:
                self._try_reserve_pg(entry)
                if not entry.ready:
                    return []  # PG not reserved yet: task must queue
            if bundle_idx is not None and bundle_idx >= len(entry.bundles):
                return None  # invalid bundle index; fail the task
            if bundle_idx is None or bundle_idx < 0:
                # any bundle with room
                for i, avail in enumerate(entry.bundle_avail):
                    if self._resources_fit(spec.resources, avail):
                        return [("pg", entry, i)]
                return []
            return [("pg", entry, bundle_idx)]
        return [("node", None, None)]

    def _candidate_nodes(self, spec: TaskSpec) -> Optional[List[NodeEntry]]:
        """Nodes this task may run on (node-pool path): head-first order,
        restricted by NodeAffinitySchedulingStrategy when present.
        Returns None when a HARD affinity target is dead/unknown — the
        task must fail, not queue forever (reference:
        node_affinity_scheduling_policy fails infeasible hard affinity)."""
        affinity = spec.options.get("node_affinity")
        nodes = self._ordered_nodes()
        if affinity:
            node_id, soft = affinity
            pinned = [n for n in nodes if n.node_id == node_id]
            if pinned:
                return pinned
            if not soft:
                return None
        return nodes

    def _dispatch(self):
        # Non-reentrant: placement can fail tasks, which marks objects ready,
        # which can trigger nested _dispatch calls — those just set a flag and
        # the outer frame loops again over consistent state.
        if self._dispatching:
            self._dispatch_pending = True
            return
        self._dispatching = True
        try:
            while True:
                self._dispatch_pending = False
                self._dispatch_once()
                if not self._dispatch_pending:
                    break
        finally:
            self._dispatching = False

    def _dispatch_once(self):
        # Head-only placement per scheduling class: O(#classes) per event.
        self._spawn_wants = {}
        empty_keys = []
        # re-admit quota-parked work that now fits (finishing tasks
        # freed admitted usage since the last pass)
        unparked = self.fairsched.pop_admissible()
        if unparked:
            for spec in unparked:
                self._task_event(spec.task_id, state="PENDING_SCHEDULING")
                self._enqueue_ready(spec, dispatch=False)
            self._refresh_pending_quota_gauge()
        classes = list(self.runnable.items())
        if len(classes) > 1:
            # policy order: priority first, then the tenant furthest
            # below its weighted fair share. The sort is stable, so
            # same-priority/same-tenant classes keep insertion order —
            # and a blocked class never stops the walk: every class
            # still gets its head-of-queue placement attempt per pass
            # (no head-of-line blocking across classes).
            classes.sort(
                key=lambda kv: self.fairsched.class_order_key(kv[0])
            )
        for key, q in classes:
            while q:
                self._last_spawn_node = None
                placed = self._try_place(q[0], qlen=len(q))
                if placed in ("placed", "failed"):
                    q.popleft()
                else:
                    # the whole class is blocked; if the head wanted a
                    # worker, the rest of the queue wants one too (keeps
                    # warm-up spawning parallel, not one-per-pass). Each
                    # want carries ITS OWN spec's actor flag — the head's
                    # flag must not leak onto queued plain tasks (that
                    # would bypass the pooled-worker cap). Enumerate at
                    # most max_workers wants: spawning can never exceed
                    # the pool cap in one pass, and walking the WHOLE
                    # queue here made every dispatch event O(queue) — a
                    # 1k-task burst on a saturated pool went quadratic.
                    if self._last_spawn_node is not None and len(q) > 1:
                        nd = self.nodes.get(self._last_spawn_node)
                        cap = nd.max_workers if nd is not None else 32
                        # +64 headroom so actor gangs (uncapped by the
                        # pool) larger than max_workers still spawn in
                        # few waves; gangs beyond the bound progress
                        # wave-by-wave as spawned workers connect
                        self._spawn_wants.setdefault(
                            self._last_spawn_node, []
                        ).extend(
                            (s.options.get("runtime_env"),
                             s.options.get("runtime_env_hash", ""),
                             s.is_actor_create)
                            for s in itertools.islice(q, 1, 65 + cap)
                        )
                    break
            if not q:
                empty_keys.append(key)
        for key in empty_keys:
            if not self.runnable.get(key):
                self.runnable.pop(key, None)
        self._bm_queue_depth["value"] = float(
            sum(len(q) for q in self.runnable.values())
        )
        # spawn workers where placement deferred for lack of an idle
        # worker. max_workers caps the POOLED task-worker count; actor
        # creations always get a process (actors pin workers for life —
        # capping them would deadlock gangs larger than the pool, where
        # the reference just grows its worker pool).
        for node_id, wants in self._spawn_wants.items():
            node = self.nodes.get(node_id)
            if node is None or not node.alive:
                continue
            n_actor = sum(1 for _, _, ia in wants if ia)
            # in-flight ACTOR-purposed spawns satisfy actor wants (so a
            # boot-storm doesn't respawn every dispatch round), and
            # pooled-purposed spawns offset pooled wants — per-purpose
            # counters so pooled spawns can't starve actor wants
            actor_quota = max(0, n_actor - node.spawning_actor)
            spawning_pooled = max(0, node.spawning - node.spawning_actor)
            budget = max(
                0,
                min(
                    (len(wants) - n_actor) - spawning_pooled,
                    node.max_workers - self._node_worker_count(node_id),
                ),
            )
            for renv, renv_hash, is_actor in wants:
                if is_actor:
                    if actor_quota > 0:
                        actor_quota -= 1
                        self._spawn_worker(node, runtime_env=renv,
                                           renv_hash=renv_hash,
                                           for_actor=True)
                elif budget > 0:
                    budget -= 1
                    self._spawn_worker(node, runtime_env=renv,
                                       renv_hash=renv_hash)

    # ----- dispatch pipelining: when the pool is saturated and the
    # backlog is deep, plain tasks queue directly behind busy workers
    # (bounded depth) instead of waiting for an idle one. The worker's
    # own task queue serializes execution, its _send_done coalesces the
    # TASK_DONE replies, and the hub outbox batches the EXEC frames —
    # on a syscall-bound box this is the difference between one wire
    # round-trip per task and one per DEPTH tasks.
    _PIPE_DEPTH = 16  # head + followers a worker may hold
    # engage only under a real backlog: short queues keep strict
    # one-task-per-worker placement (no follower can strand behind a
    # slow head; latency-sensitive interactive submits are unaffected)
    _PIPE_MIN_QUEUE = 16

    def _pipeline_ok(self, spec: TaskSpec) -> bool:
        """Only plain tasks pipeline: no actors (worker becomes the
        actor), no TPU (chip assignment is per-dispatch), no streaming
        (backpressure credits assume one producer per worker), no
        execute deadline (the timer would count worker-queue wait), no
        placement group (bundle accounting is head-only). Only BULK
        submissions (RemoteFunction.map) opt in at all — the caller
        declared a throughput-oriented fan-out; individually submitted
        tasks keep strict one-task-per-worker work-stealing."""
        o = spec.options
        return (
            spec.bulk
            and not spec.is_actor_create
            and spec.actor_id is None
            and not spec.resources.get("GPU", 0)
            and not o.get("streaming")
            and not o.get("timeout_s")
            and not o.get("placement_group")
            and not self.config.task_timeout_default_s
        )

    def _find_pipeline_worker(self, spec: TaskSpec, nodes) -> Optional[WorkerEntry]:
        """Least-loaded busy worker that can take `spec` as a follower:
        same runtime env, head holding an IDENTICAL resource dict (the
        promotion in _on_task_done swaps head resources exactly), every
        assigned task pipeline-eligible, and depth headroom."""
        allowed = {n.node_id for n in nodes}
        need_env = spec.options.get("runtime_env_hash", "")
        best = None
        for w in self.workers.values():
            if (
                w.state != "busy" or not w.pipe_ok or not w.assigned
                or w.actor_id is not None
                or w.node_id not in allowed
                or w.runtime_env_hash != need_env
                or len(w.assigned) >= self._PIPE_DEPTH
                or w.assigned[0].resources != spec.resources
            ):
                continue
            if best is None or len(w.assigned) < len(best.assigned):
                best = w
        return best

    def _try_place(self, spec: TaskSpec, qlen: int = 1) -> str:
        pools = self._effective_pools(spec)
        if pools is None:
            self._fail_task(spec, ValueError("placement group was removed"))
            return "failed"
        if not pools:
            return "defer"
        kind, entry, bidx = pools[0]
        n_chips = int(spec.resources.get("GPU", 0))
        chip_pool = None
        if kind == "pg":
            node = self.nodes.get(entry.bundle_nodes[bidx])
            if node is None or not node.alive:
                return "defer"  # bundle's node is gone; waits for recovery
            avail = entry.bundle_avail[bidx]
            if not self._resources_fit(spec.resources, avail):
                return "defer"
            if entry.bundle_chips:
                # SLICE: the task runs on the bundle's reserved chips
                chip_pool = entry.bundle_chips[bidx]
            candidates = [(node, avail)]
        else:
            allowed = self._candidate_nodes(spec)
            if allowed is None:
                self._fail_task(spec, ValueError(
                    "hard NodeAffinitySchedulingStrategy target "
                    f"{spec.options.get('node_affinity')} is not alive"))
                return "failed"
            candidates = [
                (n, n.avail)
                for n in allowed
                if self._resources_fit(spec.resources, n.avail)
            ]
            if not candidates:
                # node resources exhausted (every unit held by a running
                # task): the only way forward without pipelining is to
                # wait for a TASK_DONE. Queue behind a busy worker when
                # the backlog justifies it — the follower acquires the
                # head's resources at promotion, so accounting stays
                # exact and nothing oversubscribes.
                if qlen >= self._PIPE_MIN_QUEUE and self._pipeline_ok(spec):
                    w = self._find_pipeline_worker(spec, allowed)
                    if w is not None:
                        self._send_exec(w, spec, (), pipelined=True)
                        return "placed"
                return "defer"
        for node, avail in candidates:
            worker, chips = self._find_idle_worker(
                spec, n_chips, node, chip_pool=chip_pool
            )
            if worker is None:
                continue
            self._acquire(spec.resources, avail)
            spec.options["_pool"] = (
                ("pg", entry.pg_id, bidx) if kind == "pg"
                else ("node", node.node_id, None)
            )
            if chips and worker.pinned_chips is None:
                # pin: chips leave the node's free pool for the worker's life
                node.free_tpu_chips.difference_update(chips)
                worker.pinned_chips = chips
            self._send_exec(worker, spec, chips)
            if spec.is_actor_create:
                # the actor just pinned a pool member for life; restore
                # the pool to its prior size so the next task burst
                # doesn't pay cold worker-spawn latency (reference: the
                # raylet prestarts replacement workers when actors take
                # pool members, worker_pool.cc PrestartWorkers). Every
                # claim replenishes — gating on worker warmth let a
                # burst of actor creations drain the pool to zero (each
                # replacement is fresh, so its claim replenished
                # nothing).
                # _node_worker_count already includes the WorkerEntry
                # rows of in-flight ("starting") spawns, so adding
                # node.spawning here double-counted them: a burst of k
                # claims replenished only ~k/2 workers and the NEXT task
                # burst paid the missing interpreter spawns in-band
                # (observed as a 3x-slow first wait_1k round)
                pooled = self._node_worker_count(node.node_id)
                if pooled < node.max_workers:
                    # replenish with the SAME runtime env the claimed
                    # worker served, or env-specific bursts still stall
                    self._spawn_worker(
                        node,
                        runtime_env=spec.options.get("runtime_env"),
                        renv_hash=spec.options.get("runtime_env_hash", ""),
                    )
            return "placed"
        # Resources fit somewhere but no idle worker: request one where a
        # NEW worker could actually serve the task — for TPU tasks that
        # means the node still has n free chips (chips pinned to existing
        # idle workers don't help a fresh process). SLICE bundle tasks
        # draw from the bundle's reserved chips, which live OUTSIDE the
        # node free pool — count the unpinned ones instead.
        for node, _ in candidates:
            if chip_pool is not None:
                live_pinned = {
                    c
                    for w in self.workers.values()
                    if w.node_id == node.node_id and w.pinned_chips
                    for c in w.pinned_chips
                }
                spawnable = (
                    sum(1 for c in chip_pool if c not in live_pinned)
                    >= n_chips
                )
            else:
                spawnable = len(node.free_tpu_chips) >= n_chips
            if n_chips == 0 or spawnable:
                self._spawn_wants.setdefault(node.node_id, []).append(
                    (spec.options.get("runtime_env"),
                     spec.options.get("runtime_env_hash", ""),
                     spec.is_actor_create)
                )
                self._last_spawn_node = node.node_id
                break
        return "defer"

    def _find_idle_worker(self, spec: TaskSpec, n_chips: int,
                          node: NodeEntry, chip_pool: Optional[tuple] = None):
        """Pick an idle worker ON THIS NODE; TPU tasks require chip
        affinity (a worker pinned to exactly n chips, or a fresh worker +
        n free chips on the node). With chip_pool (a SLICE bundle's
        reserved chips) the task must land on exactly those chips."""
        need_env = spec.options.get("runtime_env_hash", "")
        if n_chips > 0:
            fresh = None
            pool_set = set(chip_pool) if chip_pool is not None else None
            for w in self.workers.values():
                if (w.state != "idle" or w.node_id != node.node_id
                        or w.runtime_env_hash != need_env):
                    continue
                if w.pinned_chips is not None and len(w.pinned_chips) == n_chips:
                    if pool_set is not None and not set(w.pinned_chips) <= pool_set:
                        continue  # pinned outside this bundle's slice
                    return w, w.pinned_chips
                # port: prefer a worker that has run no user code — its
                # CUDA state is untouched when CUDA_VISIBLE_DEVICES is set
                if w.pinned_chips is None and (
                    fresh is None or (fresh.seen_fns and not w.seen_fns)
                ):
                    fresh = w
            if pool_set is not None:
                # reserved chips are free iff no live worker pins them
                # (they never sit in node.free_tpu_chips)
                live_pinned = {
                    c
                    for w in self.workers.values()
                    if w.node_id == node.node_id and w.pinned_chips
                    for c in w.pinned_chips
                }
                open_chips = [c for c in chip_pool if c not in live_pinned]
                if fresh is not None and len(open_chips) >= n_chips:
                    return fresh, tuple(open_chips[:n_chips])
                return None, ()
            if fresh is not None and len(node.free_tpu_chips) >= n_chips:
                return fresh, tuple(sorted(node.free_tpu_chips))[:n_chips]
            return None, ()
        best = None
        for w in self.workers.values():
            if (w.state != "idle" or w.node_id != node.node_id
                    or w.runtime_env_hash != need_env):
                continue
            # prefer non-TPU-pinned workers for CPU tasks, and fn cache hits
            if spec.fn_id in w.seen_fns and w.pinned_chips is None:
                return w, ()
            if best is None or (best.pinned_chips is not None and w.pinned_chips is None):
                best = w
        return best, ()

    def _send_exec(self, worker: WorkerEntry, spec: TaskSpec,
                   chips: Tuple[int, ...], pipelined: bool = False):
        worker.state = "busy"
        if pipelined:
            # follower: queue behind the executing head. The worker
            # process drains its task queue sequentially, and its
            # _send_done batches TASK_DONEs whenever more work is
            # queued — this is what turns a deep backlog into few
            # frames instead of a wake+syscall round-trip per task.
            worker.assigned.append(spec)
        else:
            worker.current_task = spec
            worker.tpu_chips = chips
            worker.pipe_ok = self._pipeline_ok(spec)
        now_mono = time.monotonic()
        ev = self._task_event(
            spec.task_id, state="RUNNING", started_at=time.time(),
            t_scheduled=now_mono,
            worker_id=worker.worker_id, node_id=worker.node_id,
        )
        self._bm_placed["value"] += 1
        if self.fairsched.tenants:
            self.fairsched.charge_dispatch(spec)
            self._update_tenant_gauges()
        # measure from the LATEST queue entry (retries re-stamp
        # t_queued), falling back to submit — a retry of a 10s task
        # must not record a 10s "placement"
        t0 = ev.get("t_queued") or ev.get("t_submit")
        if t0 is not None:
            self._bm_observe(self._bm_placement, now_mono - t0)
        dispatch_span = None
        if spec.trace is not None:
            # the queue-wait span: admit (or the latest retry's
            # re-queue) -> this dispatch; worker-side spans parent
            # under its id so the trace reads submit -> queue -> exec
            dispatch_span = self._emit_runtime_span(
                "hub.sched", "queue_wait", spec.trace,
                t0 if t0 is not None else now_mono, now_mono,
                task_id=spec.task_id.hex(), worker_id=worker.worker_id,
            )
            if (not worker.spawn_span_done and worker.spawned_t
                    and worker.connected_t
                    and (t0 is None or worker.connected_t >= t0)):
                # this dispatch waited on the worker's process spawn:
                # charge the spawn window to the trace (once per worker)
                worker.spawn_span_done = True
                self._emit_runtime_span(
                    "hub.worker_spawn", "spawn", spec.trace,
                    worker.spawned_t, worker.connected_t,
                    parent=dispatch_span, worker_id=worker.worker_id,
                )
        fn_blob = None
        if spec.fn_id not in worker.seen_fns:
            fn_blob = self.functions.get(spec.fn_id)
            worker.seen_fns.add(spec.fn_id)
        msg = P.EXEC_ACTOR_CREATE if spec.is_actor_create else P.EXEC_TASK
        exec_payload = {
                "task_id": spec.task_id,
                "fn_id": spec.fn_id,
                "fn_blob": fn_blob,
                "args_kind": spec.args_kind,
                "args_payload": spec.args_payload,
                "return_ids": spec.return_ids,
                "tpu_chips": chips,
                "actor_id": spec.actor_id,
                "ready_id": spec.ready_id,
                "options": {
                    k: v for k, v in spec.options.items()
                    # tenant/priority/job_id ride along so NESTED
                    # submits from inside the task inherit the job's
                    # scheduling identity (quota/fairness/priority
                    # must not be escapable by fanning out subtasks)
                    if k in ("max_concurrency", "streaming",
                             "_generator_backpressure_num_objects",
                             "_restarted", "placement_group",
                             "tenant", "priority", "job_id")
                },
        }
        if dispatch_span is not None:
            # worker spans (arg fetch / execute / result store) parent
            # under the dispatch span; nested submits inherit the trace
            exec_payload["trace"] = (spec.trace[0], dispatch_span)
        self._send(worker.conn, msg, exec_payload)
        # per-task execute deadline: options(timeout_s=...) wins, else
        # the cluster-wide hung-worker watchdog default (0 = off). A
        # one-shot timer per dispatch — the default path arms nothing.
        timeout_s = spec.options.get("timeout_s") or (
            self.config.task_timeout_default_s
        )
        # pipelined specs never reach here with a deadline
        # (_pipeline_ok excludes them): a timer armed at queue-behind
        # time would count worker-queue wait against the execute budget
        if timeout_s and timeout_s > 0 and not pipelined:
            worker.exec_gen = gen = next(self._exec_seq)
            self._add_timer(
                float(timeout_s),
                lambda w=worker, s=spec, g=gen, t=float(timeout_s):
                    self._check_exec_timeout(w, s, g, t),
            )

    def _check_exec_timeout(self, worker: WorkerEntry, spec: TaskSpec,
                            gen: int, timeout_s: float) -> None:
        """The task dispatched at generation `gen` is still running on
        `worker` past its deadline: SIGKILL the worker (a hung —
        SIGSTOP'd, deadlocked, livelocked — process ignores the
        cooperative KILL and never EOFs on its own) and let the normal
        worker-death path retry the task against its crash-retry budget
        (a timeout IS a crash, unlike a preemption — the task may hang
        every time), or fail it with TaskTimeoutError once exhausted."""
        if (
            self.workers.get(worker.worker_id) is not worker
            or worker.exec_gen != gen
            or worker.current_task is not spec
            or worker.state not in ("busy", "actor")
        ):
            return  # that dispatch already finished (or was retried)
        spec.options["_timed_out"] = timeout_s
        self._record_event(
            "task_timeout", task_id=spec.task_id.hex(),
            worker_id=worker.worker_id, timeout_s=timeout_s,
            **self._trace_fields(spec),
        )
        self._force_kill_worker(worker)

    def _deliver_worker_signal(self, w: WorkerEntry, sig: str) -> None:
        """Route "kill"/"stop" to a worker's process wherever its proc
        handle lives: hub-local Popen, or its node agent via
        P.KILL_WORKER's sig field. "kill" is SIGKILL, never SIGTERM —
        a SIGSTOP'd or wedged worker queues SIGTERM forever."""
        import signal as _signal

        try:
            if w.proc is not None:
                if sig == "stop":
                    os.kill(w.proc.pid, _signal.SIGSTOP)
                else:
                    w.proc.kill()
                return
            node = self.nodes.get(w.node_id)
            if node is not None and node.agent_conn is not None:
                self._send(node.agent_conn, P.KILL_WORKER,
                           {"worker_id": w.worker_id, "sig": sig})
        except (OSError, ProcessLookupError):
            pass

    def _force_kill_worker(self, w: WorkerEntry) -> None:
        """SIGKILL the stalled target (watchdog/timeout recovery path —
        chaos worker_hang sends SIGSTOP, so only SIGKILL terminates)."""
        self._deliver_worker_signal(w, "kill")
        # drop the conn ourselves: the EOF from the kill arrives
        # eventually, but expelling now makes recovery latency the
        # timer's, not the kernel's
        if w.conn is not None:
            self._expel_conn(w.conn)

    def _worker_pythonpath(self) -> str:
        # Propagate the driver's import paths so workers can import ray_tpu
        # and user modules regardless of cwd (the reference ships PYTHONPATH
        # to workers through the runtime env / worker command line).
        pkg_parent = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
        paths = [pkg_parent] + [p for p in sys.path if p]
        if os.environ.get("PYTHONPATH"):
            paths.append(os.environ["PYTHONPATH"])
        return os.pathsep.join(dict.fromkeys(paths))

    def _spawn_worker(self, node: NodeEntry, runtime_env=None,
                      renv_hash: str = "", for_actor: bool = False):
        import json as _json

        wid = WorkerID.generate().hex()
        node.spawning += 1
        self._bm_spawns["value"] += 1
        if for_actor:
            node.spawning_actor += 1
        renv_json = _json.dumps(runtime_env) if runtime_env else ""
        if node.agent_conn is not None:
            # remote host: the node agent forks the worker there
            self.workers[wid] = WorkerEntry(
                worker_id=wid, state="starting", node_id=node.node_id,
                runtime_env_hash=renv_hash, spawned_for_actor=for_actor,
                spawned_t=time.monotonic(),
            )
            env = dict(
                self.worker_env,
                RAY_TPU_TORCH_HUB_ADDR=self.addr,
                RAY_TPU_TORCH_WORKER_ID=wid,
                PYTHONPATH=self._worker_pythonpath(),
            )
            if renv_json:
                env["RAY_TPU_TORCH_RUNTIME_ENV"] = renv_json
            self._send(
                node.agent_conn, P.SPAWN_WORKER,
                {"worker_id": wid, "env": env},
            )
            return
        env = dict(os.environ)
        env.update(self.worker_env)
        env["RAY_TPU_TORCH_HUB_ADDR"] = self.addr
        env["RAY_TPU_TORCH_SESSION_DIR"] = self.session_dir
        env["RAY_TPU_TORCH_WORKER_ID"] = wid
        env["RAY_TPU_TORCH_NODE_ID"] = node.node_id
        env["PYTHONPATH"] = self._worker_pythonpath()
        if renv_json:
            env["RAY_TPU_TORCH_RUNTIME_ENV"] = renv_json
        proc = subprocess.Popen(
            [sys.executable, "-m", "ray_tpu_torch._private.worker_process"],
            env=env,
            cwd=os.getcwd(),
        )
        self.workers[wid] = WorkerEntry(
            worker_id=wid, proc=proc, state="starting", node_id=node.node_id,
            runtime_env_hash=renv_hash, spawned_for_actor=for_actor,
            spawned_t=time.monotonic(),
        )

    def _reap_workers(self):
        """Detect spawned workers that died before connecting (e.g. import
        failure) so the scheduler doesn't wait on them forever."""
        dead = [
            w
            for w in self.workers.values()
            if w.proc is not None and w.proc.poll() is not None and w.conn is None
        ]
        for w in dead:
            sys.stderr.write(
                f"[ray_tpu_torch] worker {w.worker_id} exited with code {w.proc.returncode} "
                f"before connecting\n"
            )
            self._record_event(
                "worker_spawn_failed", worker_id=w.worker_id,
                node_id=w.node_id, code=w.proc.returncode,
            )
            node = self.nodes.get(w.node_id)
            if node is not None:
                node.spawning = max(0, node.spawning - 1)
                if w.spawned_for_actor:
                    node.spawning_actor = max(0, node.spawning_actor - 1)
            self.workers.pop(w.worker_id, None)
        if dead:
            self._dispatch()
        self._add_timer(self.config.worker_reap_period_s, self._reap_workers)

    _worker_rss = staticmethod(proc_rss_bytes)

    def _memory_monitor(self):
        """Kill local workers whose RSS exceeds the per-worker cap
        (reference: common/memory_monitor.h feeding the raylet's
        worker-killing policy, worker_killing_policy.cc — we use its
        newest-first ordering: the most recently started offender dies,
        preserving long-running work)."""
        cap = self.config.memory_usage_threshold
        offenders = [
            w for w in self.workers.values()
            if w.proc is not None and w.conn is not None
            and self._worker_rss(w.proc.pid) > cap
        ]
        if offenders:
            from ..exceptions import OutOfMemoryError

            victim = offenders[-1]  # newest registered
            sys.stderr.write(
                f"[ray_tpu_torch] memory monitor: worker {victim.worker_id} rss "
                f"exceeds {cap:.0f} bytes; killing\n"
            )
            self._record_event(
                "oom_kill", worker_id=victim.worker_id,
                node_id=victim.node_id,
                rss=self._worker_rss(victim.proc.pid), cap=cap,
            )
            spec = victim.current_task
            if spec is not None:
                # OOM kills don't burn crash retries silently: fail fast
                spec.retries_left = 0
                spec.options["_oom"] = True
            self._kill_worker(victim)
        self._add_timer(self.config.memory_monitor_period_s, self._memory_monitor)

    def _on_task_done(self, conn, p):
        wid = self.conn_to_worker.get(conn)
        worker = self.workers.get(wid) if wid else None
        spec = self.tasks.pop(p["task_id"], None)
        ispec = None  # actor-call spec (lives in actor.inflight, not tasks)
        if (
            worker is not None and worker.state == "busy"
            and worker.current_task is not None
            and worker.current_task.task_id == p["task_id"]
        ):
            # identity-gated, not state-gated: a DUPLICATE task_done
            # (chaos dup / replayed frame) whose first copy already
            # freed this worker — and whose _dispatch may have put a
            # NEW task on it — must not reset the worker under that
            # task (which would double-book it and disarm its
            # exec-timeout guard)
            worker.assigned.popleft()
            if worker.assigned:
                # pipelined follower promotes to head: it takes over the
                # node resources the finished head releases just below
                # (same scheduling class ⇒ identical resource dict), so
                # the swap is exact — avail dips negative for the few
                # lines until _release_task_resources restores it, with
                # no reader in between. _pool presence is the
                # "resources acquired" marker release keys off.
                nh = worker.assigned[0]
                if "_pool" not in nh.options:
                    node = self.nodes.get(worker.node_id)
                    if node is not None:
                        self._acquire(nh.resources, node.avail)
                        nh.options["_pool"] = ("node", worker.node_id, None)
            else:
                worker.state = "idle"
                worker.tpu_chips = ()  # chips stay pinned to the worker (affinity)
        if spec is not None:
            self._release_task_resources(spec)
            if spec.actor_id is not None:
                actor = self.actors.get(spec.actor_id)
                if actor is not None:
                    actor.inflight.pop(p["task_id"], None)
        elif worker is not None and worker.actor_id:
            actor = self.actors.get(worker.actor_id)
            if actor is not None:
                ispec = actor.inflight.pop(p["task_id"], None)
        tr = None
        for s in (spec, ispec):
            if s is not None and s.trace is not None:
                tr = s.trace
                break
        node_id = worker.node_id if worker is not None else "node0"
        if self._maybe_retry_app_error(spec, p["returns"]):
            self._dispatch()
            return
        t_done0 = 0.0
        if tr is not None:
            # the returns become ready below; readiness pushes to
            # subscribed waiters stitch in through this map (past the
            # retry check — a retried task's returns never materialize)
            traced = self._traced_oids
            for oid, _k, _pl, _s in p["returns"]:
                traced[oid] = tr
            while len(traced) > 4096:  # FIFO bound (untraced push = ok)
                traced.pop(next(iter(traced)))
            t_done0 = time.monotonic()
        if spec is not None:
            # final completion: the quota admission charge comes back
            # (retries above keep it — the task is still in the system)
            self.fairsched.release_admission(spec.task_id)
        if spec is not None and not spec.is_actor_create:
            # actor-creation pins persist for the actor's lifetime
            # (restart replays the creation args); everything else
            # unpins on final completion
            self._unpin_deps(spec)
        if spec is not None and spec.actor_id is None and not spec.is_actor_create:
            for oid, kind, _, _ in p["returns"]:
                if kind == P.VAL_SHM:
                    if oid not in self._lineage:
                        self._lineage_order.append(oid)
                        while len(self._lineage_order) > 10000:
                            self._lineage.pop(self._lineage_order.popleft(), None)
                    self._lineage[oid] = spec
        prev_ev = self._task_event_index.get(p["task_id"], {})
        failed = (
            any(kind == P.VAL_ERROR for _, kind, _, _ in p["returns"])
            or prev_ev.get("state") == "FAILED"
        )
        ev = self._task_event(
            p["task_id"], state="FAILED" if failed else "FINISHED",
            finished_at=time.time(), t_finished=time.monotonic(),
        )
        if failed:
            # application error published to the caller (retries, if
            # any, were already consumed or not requested)
            self._bm_task_fail["value"] += 1
            self._record_event(
                "task_failed", task_id=p["task_id"].hex(),
                name=ev.get("name", ""),
                **({"trace_id": ev["trace_id"]} if "trace_id" in ev else {}),
            )
        owner_spec = spec if spec is not None else ispec
        owner_label = owner_spec.owner if owner_spec is not None else ""
        for oid, kind, payload, size in p["returns"]:
            self._object_ready(oid, kind, payload, size, node_id=node_id,
                               owner=owner_label)
        if tr is not None:
            # completion handling: return registration + readiness
            # fan-out (get/wait waiters, pushes) for this task
            self._emit_runtime_span(
                "hub.complete", "complete", tr, t_done0, time.monotonic(),
                task_id=p["task_id"].hex(),
            )
        self._dispatch()

    def _maybe_retry_app_error(self, spec, returns) -> bool:
        """retry_exceptions (reference: @ray.remote(retry_exceptions=...)):
        application errors normally publish immediately; with the option
        set (True, or a list of exception types) the task re-enqueues
        against its retry budget instead."""
        if (
            spec is None
            or spec.is_actor_create
            or spec.actor_id is not None
            or spec.retries_left <= 0
            or not spec.options.get("retry_exceptions")
            or not any(kind == P.VAL_ERROR for _, kind, _, _ in returns)
        ):
            return False
        allowed = spec.options["retry_exceptions"]
        if isinstance(allowed, bytes):
            # exception-class list ships as a cloudpickle blob
            # (remote_function.scheduling_options); unwrap once and
            # cache — retries re-enter this method
            try:
                allowed = loads_inline(allowed)
            except Exception:
                return False
            spec.options["retry_exceptions"] = allowed
        if isinstance(allowed, (list, tuple)):
            try:
                payload = next(
                    pl for _, kind, pl, _ in returns if kind == P.VAL_ERROR
                )
                err = loads_inline(payload)
                cause = getattr(err, "cause", None)
                match = isinstance(err, tuple(allowed)) or isinstance(
                    cause, tuple(allowed)
                )
            except Exception:
                match = False
            if not match:
                return False
        spec.retries_left -= 1
        self.tasks[spec.task_id] = spec
        self._task_event(spec.task_id, state="PENDING_RETRY")
        self._bm_task_retry["value"] += 1
        self._record_event(
            "task_retry", task_id=spec.task_id.hex(), reason="app_error",
            retries_left=spec.retries_left, **self._trace_fields(spec),
        )
        self._enqueue_runnable(spec)
        return True

    def _update_tenant_gauges(self) -> None:
        """Per-tenant share-of-running-work gauges (fairsched)."""
        tenants = self.fairsched.tenants
        total = sum(t.rate for t in tenants.values())
        for name, t in tenants.items():
            g = self._tenant_gauges.get(name)
            if g is None:
                g = self._tenant_gauges[name] = self._bm(
                    "ray_tpu_tenant_running_share", "gauge",
                    "tenant's share of currently running work "
                    "(chips, else CPUs)", (("tenant", name),))
            g["value"] = (t.rate / total) if total > 0 else 0.0
        for name in [n for n in self._tenant_gauges if n not in tenants]:
            # dropped tenant: delete the series (zeroing it would leak
            # one gauge per tenant name ever seen under client churn —
            # the registry-growth class GL009 polices)
            self._tenant_gauges.pop(name)
            self.metrics.pop(
                ("ray_tpu_tenant_running_share", (("tenant", name),)), None
            )

    def _release_task_resources(self, spec: TaskSpec):
        # the dispatch interval ends whenever the resources release
        # (done, failed, retried, preempted) — fold the fair-share
        # clock; the quota charge is released separately at FINAL
        # completion (release_admission). Settle is UNGATED: even with
        # every tenant pruned (driver churn), the task's _running entry
        # must pop or the engine leaks one per in-flight task (GL009).
        self.fairsched.settle(spec.task_id)
        # unconditionally: settle/release may have pruned the LAST
        # tenant, and the gauge sweep is what deletes its stale series
        self._update_tenant_gauges()
        pool = spec.options.pop("_pool", None)
        if pool is None:
            return
        kind, owner, bidx = pool
        if kind == "node":
            node = self.nodes.get(owner)
            if node is not None:
                self._release(spec.resources, node.avail)
        else:
            entry = self.pgs.get(owner)
            if entry is not None:
                self._release(spec.resources, entry.bundle_avail[bidx])

    def _fail_task(self, spec: TaskSpec, err: Exception):
        from .serialization import dumps_inline as d

        blob = d(err)
        for oid in spec.return_ids:
            self._object_ready(oid, P.VAL_ERROR, blob, 0)
        if spec.ready_id:
            self._object_ready(spec.ready_id, P.VAL_ERROR, blob, 0)
        if spec.options.get("streaming"):
            self._end_stream_with_error(spec.task_id, blob)
        self._task_event(spec.task_id, state="FAILED", finished_at=time.time(),
                         t_finished=time.monotonic(), error=str(err)[:200])
        self._bm_task_fail["value"] += 1
        self._record_event(
            "task_give_up", task_id=spec.task_id.hex(),
            name=spec.fn_id or (spec.method or ""), error=str(err)[:200],
            **self._trace_fields(spec),
        )
        self.tasks.pop(spec.task_id, None)
        self.fairsched.settle(spec.task_id)
        self.fairsched.release_admission(spec.task_id)
        self._unpin_deps(spec)
        if spec.is_actor_create and spec.actor_id is not None:
            # a failed CREATION must kill the actor entry too, or
            # queued method calls park in pending_calls forever with
            # the actor wedged in state "pending"
            actor = self.actors.get(spec.actor_id)
            if actor is not None and actor.state != "dead":
                actor.state = "dead"
                self._drain_actor_queue_with_error(actor)

    # ----- actors
    def _on_create_actor(self, conn, p):
        if p["actor_id"] in self.actors:
            # duplicate delivery: the entry exists — re-admitting the
            # creation spec would spawn a second worker for the same
            # actor id. (Named duplicates from DIFFERENT clients carry
            # different actor_ids and still hit the name check below.)
            return
        options = p["options"]
        entry = ActorEntry(
            actor_id=p["actor_id"],
            fn_id=p["fn_id"],
            args_kind=p["args_kind"],
            args_payload=p["args_payload"],
            resources=p["resources"],
            options=options,
            ready_id=p["ready_id"],
            name=options.get("name") or "",
            restarts_left=options.get("max_restarts", 0),
        )
        name = options.get("name")
        if name:
            key = (options.get("namespace") or "default", name)
            if key in self.named_actors and self.actors.get(self.named_actors[key], None) and self.actors[self.named_actors[key]].state != "dead":
                self._reply(conn, p["req_id"], error=f"Actor with name '{name}' already exists")
                return
            self.named_actors[key] = entry.actor_id
            self._reply(conn, p["req_id"], error=None)
        self.actors[entry.actor_id] = entry
        spec = TaskSpec(
            task_id=p["actor_id"],  # creation task id == actor id
            fn_id=p["fn_id"],
            args_kind=p["args_kind"],
            args_payload=p["args_payload"],
            return_ids=[],
            resources=p["resources"],
            options=dict(options),
            is_actor_create=True,
            actor_id=p["actor_id"],
            ready_id=p["ready_id"],
            owner=self._conn_label(conn),
        )
        self._admit(spec, p.get("arg_deps", []))

    def _on_actor_ready(self, conn, p):
        wid = self.conn_to_worker.get(conn)
        worker = self.workers.get(wid)
        actor = self.actors.get(p["actor_id"])
        spec = self.tasks.pop(p["actor_id"], None)
        if actor is None or worker is None:
            return
        if p.get("error") is not None:
            # constructor raised: actor is dead on arrival
            actor.state = "dead"
            self._task_event(
                p["actor_id"], state="FAILED",
                finished_at=time.time(), t_finished=time.monotonic(),
            )
            if spec is not None:
                self._release_task_resources(spec)
                self._unpin_deps(spec)
            worker.state = "idle"
            worker.actor_id = None
            worker.tpu_chips = ()  # chips remain pinned to the worker
            self._object_ready(actor.ready_id, P.VAL_ERROR, p["error"], 0)
            self._drain_actor_queue_with_error(actor)
            self._dispatch()
            return
        actor.state = "alive"
        actor.worker_id = wid
        self._task_event(
            p["actor_id"], state="FINISHED",
            finished_at=time.time(), t_finished=time.monotonic(),
        )
        # the creation spec is finalized but its arg pins must survive
        # for the actor's lifetime (restart replays the creation args):
        # transfer them to the actor entry. A restart's respawn spec
        # skips _admit, so pins are never doubled.
        if spec is not None and spec.pinned_deps:
            actor.creation_pins.extend(spec.pinned_deps)
            spec.pinned_deps = []
        worker.state = "actor"
        worker.actor_id = actor.actor_id
        worker.current_task = None
        # Actor creation resources stay held for the actor's lifetime.
        actor.pool = spec.options.get("_pool") if spec is not None else None
        self._object_ready(actor.ready_id, P.VAL_INLINE, dumps_inline((b"P\x80\x05N.", [])), 0)
        while actor.pending_calls:
            call = actor.pending_calls.popleft()
            self._forward_actor_call(actor, call)
        self._dispatch()

    def _on_submit_actor_task(self, conn, p):
        if p["task_id"] in self._task_event_index:
            return  # duplicate delivery: the call is already in flight
        actor = self.actors.get(p["actor_id"])
        spec = TaskSpec(
            task_id=p["task_id"],
            fn_id="",
            args_kind=p["args_kind"],
            args_payload=p["args_payload"],
            return_ids=p["return_ids"],
            resources={},
            options=p["options"],
            actor_id=p["actor_id"],
            method=p["method"],
            owner=self._conn_label(conn),
        )
        tr = p.get("trace")
        if tr is not None:
            spec.trace = (tr[0], tr[1])
        if actor is None or actor.state == "dead":
            from ..exceptions import ActorDiedError

            blob = dumps_inline(ActorDiedError(msg="Actor is dead."))
            for oid in spec.return_ids:
                self._object_ready(oid, P.VAL_ERROR, blob, 0)
            return
        deps = p.get("arg_deps", [])
        pending = 0
        for dep in deps:
            e = self.objects.get(dep)
            if e is None:
                e = self.objects[dep] = ObjEntry()
            e.pins += 1
            spec.pinned_deps.append(dep)
            if not e.ready:
                pending += 1
                self.dep_waiters.setdefault(dep, []).append(spec)
        spec.deps_remaining = pending
        spec.options["_actor_call"] = True
        ev = self._task_event(
            spec.task_id, name=spec.method or "",
            state="PENDING_ARGS" if pending else "PENDING_ACTOR",
            submitted_at=time.time(), t_submit=time.monotonic(),
        )
        if spec.trace is not None:
            ev["trace_id"] = spec.trace[0]
        if pending:
            self.tasks[spec.task_id] = spec
            return
        self._route_actor_call(actor, spec)

    def _route_actor_call(self, actor: ActorEntry, spec: TaskSpec):
        if actor.state == "alive":
            self._forward_actor_call(actor, spec)
        else:
            actor.pending_calls.append(spec)

    def _forward_actor_call(self, actor: ActorEntry, spec: TaskSpec):
        worker = self.workers.get(actor.worker_id)
        if worker is None or worker.conn is None:
            actor.pending_calls.append(spec)
            return
        actor.inflight[spec.task_id] = spec
        now_mono = time.monotonic()
        ev = self._task_event(
            spec.task_id, name=spec.method or "", state="RUNNING",
            started_at=time.time(), t_scheduled=now_mono,
            worker_id=worker.worker_id,
            node_id=worker.node_id, actor_id=actor.actor_id.hex(),
        )
        exec_payload = {
            "task_id": spec.task_id,
            "actor_id": actor.actor_id,
            "method": spec.method,
            "args_kind": spec.args_kind,
            "args_payload": spec.args_payload,
            "return_ids": spec.return_ids,
            "options": {
                k: v for k, v in spec.options.items()
                if k in ("streaming",
                         "_generator_backpressure_num_objects",
                         "tenant", "priority", "job_id")
            },
        }
        if spec.trace is not None:
            # actor calls have no runnable-queue phase; the queue_wait
            # span covers submit-arrival -> forward (dep waits and
            # pending_calls parking included)
            t0 = ev.get("t_submit")
            dispatch_span = self._emit_runtime_span(
                "hub.actor_route", "queue_wait", spec.trace,
                t0 if t0 is not None else now_mono, now_mono,
                task_id=spec.task_id.hex(), method=spec.method or "",
            )
            exec_payload["trace"] = (spec.trace[0], dispatch_span)
        self._send(worker.conn, P.EXEC_ACTOR_TASK, exec_payload)
        # execute deadline for actor calls too (method.options(timeout_s=)
        # or the cluster-wide watchdog): a hung actor worker never EOFs,
        # and without this every queued call on it wedges forever. The
        # kill takes the whole worker — under max_concurrency that is
        # the deadline's documented blast radius — and the normal death
        # path fails in-flight calls with ActorDiedError and restarts
        # the actor per its budget.
        timeout_s = spec.options.get("timeout_s") or (
            self.config.task_timeout_default_s
        )
        if timeout_s and timeout_s > 0:
            self._add_timer(
                float(timeout_s),
                lambda a=actor, w=worker, s=spec, t=float(timeout_s):
                    self._check_actor_exec_timeout(a, w, s, t),
            )

    def _check_actor_exec_timeout(self, actor: ActorEntry, worker: WorkerEntry,
                                  spec: TaskSpec, timeout_s: float) -> None:
        """The actor call is still in flight on the same incarnation
        past its deadline: SIGKILL the (possibly hung) worker; the
        worker-death path surfaces ActorDiedError to in-flight callers
        and restarts the actor per max_restarts."""
        if (
            actor.inflight.get(spec.task_id) is not spec
            or actor.worker_id != worker.worker_id
            or self.workers.get(worker.worker_id) is not worker
        ):
            return  # completed, or a different incarnation by now
        self._record_event(
            "task_timeout", task_id=spec.task_id.hex(),
            worker_id=worker.worker_id, actor_id=actor.actor_id.hex(),
            timeout_s=timeout_s, **self._trace_fields(spec),
        )
        self._force_kill_worker(worker)

    def _drain_actor_queue_with_error(self, actor: ActorEntry):
        from ..exceptions import ActorDiedError

        blob = dumps_inline(ActorDiedError(msg="The actor died before this call could run."))
        while actor.pending_calls:
            spec = actor.pending_calls.popleft()
            for oid in spec.return_ids:
                self._object_ready(oid, P.VAL_ERROR, blob, 0)
            if spec.options.get("streaming"):
                self._end_stream_with_error(spec.task_id, blob)
            self._unpin_deps(spec)
        for spec in actor.inflight.values():
            for oid in spec.return_ids:
                self._object_ready(oid, P.VAL_ERROR, blob, 0)
            if spec.options.get("streaming"):
                self._end_stream_with_error(spec.task_id, blob)
            self._unpin_deps(spec)
        actor.inflight.clear()
        # the actor is permanently dead here on every call path: drop
        # the creation-arg pins, release its quota admission, and push
        # a tombstone — beyond the cap the oldest dead actors leave the
        # registry (handler-grown tables must prune: graftlint GL009)
        self._unpin_ids(actor.creation_pins)
        actor.creation_pins = []
        self.fairsched.settle(actor.actor_id)
        self.fairsched.release_admission(actor.actor_id)
        self._dead_actors.append(actor.actor_id)
        while len(self._dead_actors) > 10000:
            old_id = self._dead_actors.popleft()
            old = self.actors.get(old_id)
            if old is None or old.state != "dead":
                continue  # reused id or resurrected entry: keep it
            self.actors.pop(old_id, None)
            key = (old.options.get("namespace") or "default", old.name)
            if old.name and self.named_actors.get(key) == old_id:
                self.named_actors.pop(key, None)

    def _on_kill_actor(self, conn, p):
        actor = self.actors.get(p["actor_id"])
        if actor is None:
            return
        if p.get("no_restart", True):
            actor.restarts_left = 0
        worker = self.workers.get(actor.worker_id) if actor.worker_id else None
        if worker is not None:
            self._kill_worker(worker)
            self._worker_died(worker)
        elif p.get("no_restart", True):
            from ..exceptions import ActorDiedError

            # Constructor may already be running on a worker that hasn't
            # reported ACTOR_READY yet — kill that worker.
            for w in list(self.workers.values()):
                if w.current_task is not None and w.current_task.actor_id == actor.actor_id:
                    self._kill_worker(w)
                    self._worker_died(w)
                    return
            # Otherwise the creation is still queued: cancel it outright.
            spec = self.tasks.pop(actor.actor_id, None)
            if spec is not None:
                key = self._sched_class(spec)
                q = self.runnable.get(key)
                if q is not None and spec in q:
                    q.remove(spec)
                # the creation may be quota-parked instead of runnable
                if self.fairsched.unpark(spec):
                    self._refresh_pending_quota_gauge()
                self._unpin_deps(spec)
            actor.state = "dead"
            blob = dumps_inline(ActorDiedError(msg="The actor was killed before it started."))
            self._object_ready(actor.ready_id, P.VAL_ERROR, blob, 0)
            self._drain_actor_queue_with_error(actor)
            self._dispatch()

    def _kill_worker(self, w: WorkerEntry):
        if w.conn is not None:
            self._send(w.conn, P.KILL, {})
        if w.proc is not None:
            try:
                w.proc.terminate()
            except Exception:
                pass

    # ----- worker failure handling
    def _safe_disconnect(self, conn):
        """_handle_disconnect behind a last-resort guard: it runs from
        the reactor's except paths, where a raising cleanup would kill
        the hub thread (the very bug class it is cleaning up after)."""
        # drop the fd from the persistent selector FIRST — after
        # conn.close() the fileobj can't resolve its fileno, and a
        # stale registration would collide with a new accept that
        # reuses the fd number
        sel = self._selector
        if sel is not None:
            try:
                sel.unregister(conn)
            except (KeyError, ValueError, OSError):
                pass  # never registered, or already gone
        try:
            self._handle_disconnect(conn)
        except Exception:
            log_exc("hub disconnect cleanup error")
        finally:
            # the broad-except path reaches here with the socket still
            # live; without a close the peer never sees EOF and blocks
            # in recv forever (and the hub leaks the fd). Last line of
            # defense: nothing here may raise.
            try:
                conn.close()
            except Exception:
                pass

    def _handle_disconnect(self, conn):
        # (the selector registration — the poll interest set — is
        # dropped by _safe_disconnect before this runs)
        self._outbox.pop(conn, None)
        cid_ = id(conn)
        for key in [k for k in self._client_puts if k[0] == cid_]:
            f = self._client_puts.pop(key)
            if isinstance(f, tuple):
                # ('failed', msg) tombstone from _on_put_chunk — the
                # file is already closed and unlinked; touching .name
                # here used to raise AttributeError and kill the hub
                # thread on a mid-chunked-put disconnect
                continue
            try:
                name = f.name
                f.close()
                os.unlink(name)
            except OSError:
                pass
        for subs in self.subscribers.values():
            if conn in subs:
                subs.remove(conn)
        cid = id(conn)
        for key in [k for k in self._inflight_reqs if k[0] == cid]:
            del self._inflight_reqs[key]
        # readiness subscriptions die with the connection
        for oid in self._ready_watch_conns.pop(cid, ()):
            watchers = self._ready_watchers.get(oid)
            if watchers is not None:
                try:
                    watchers.remove(conn)
                except ValueError:
                    pass
                if not watchers:
                    del self._ready_watchers[oid]
        self.client_conns.pop(conn, None)
        self.fairsched.drop_conn(cid)
        # prune per-tenant gauges for tenants the drop removed (the
        # charge/settle sites are gated on live tenants and would
        # otherwise leave a stale last-value series forever)
        self._update_tenant_gauges()
        node_id = self.agent_conns.pop(conn, None)
        if node_id is not None:
            self._node_died(node_id)
            return
        wid = self.conn_to_worker.pop(conn, None)
        if wid is None:
            if conn is self.driver_conn:
                # driver died: shut the whole session down
                self._record_event("driver_disconnect")
                self._running = False
            else:
                # a remote client (Ray Client parity) going away is a
                # normal-but-notable event: its pending gets died with it
                self._record_event("client_disconnect")
            return
        worker = self.workers.pop(wid, None)
        if worker is None:
            return
        self._worker_died(worker)

    def _node_died(self, node_id: str):
        """Agent connection lost: the host is gone. Its workers' sockets
        EOF independently and go through _worker_died (task retry, actor
        restart — now free to land on surviving nodes). Reference:
        GcsNodeManager::OnNodeFailure."""
        node = self.nodes.get(node_id)
        if node is None:
            return
        node.alive = False
        node.agent_conn = None
        node.avail = {}
        node.spawning = 0
        node.spawning_actor = 0
        sys.stderr.write(f"[ray_tpu_torch] node {node_id} died\n")
        self._record_event(
            "node_down", node_id=node_id, hostname=node.hostname,
            workers=sum(1 for w in self.workers.values()
                        if w.node_id == node_id),
        )
        # zero the dead node's gauges: a scrape must not keep showing
        # last-heartbeat RSS/load for a host that no longer exists
        self._node_stat_gauges(
            node_id, rss_bytes=0.0, cpu_load_1m=0.0, n_workers=0.0,
        )
        g = self._node_gauges.get(node_id)
        if g is not None:
            g[0]["value"] = 0.0  # store bytes
            g[1]["value"] = 0.0  # chips in use
        self._fail_fetches_for_node(node_id)
        # invalidate client-side location caches: any resolve pointing
        # at this node is stale and must re-resolve (replica or relay)
        if self.subscribers.get("__node_down__"):
            self._publish("__node_down__", {"node_id": node_id})
        self._dispatch()

    def _worker_died(self, worker: WorkerEntry):
        from ..exceptions import ActorDiedError, WorkerCrashedError

        worker.state = "dead"
        self._record_event(
            "worker_exit", worker_id=worker.worker_id,
            node_id=worker.node_id,
            actor_id=worker.actor_id.hex() if worker.actor_id else None,
            mid_task=worker.current_task is not None,
        )
        self.workers.pop(worker.worker_id, None)
        self.conn_to_worker.pop(worker.conn, None)
        wnode = self.nodes.get(worker.node_id)
        if worker.pinned_chips and wnode is not None:
            # chips reserved by a live SLICE PG stay out of the free
            # pool — they become placeable again through their bundle
            # (placement checks live-worker pins, not the free pool)
            wnode.free_tpu_chips.update(
                set(worker.pinned_chips) - wnode.pg_reserved_chips
            )
        spec = worker.current_task
        if spec is not None and spec.is_actor_create:
            # actor died mid-constructor: release the creation resources
            self._release_task_resources(spec)
        if spec is not None and not spec.is_actor_create:
            self._release_task_resources(spec)
            if spec.options.get("_cancelled"):
                from ..exceptions import TaskCancelledError

                self._fail_task(spec, TaskCancelledError("task was cancelled"))
            elif spec.options.get("_oom"):
                from ..exceptions import OutOfMemoryError

                self._fail_task(spec, OutOfMemoryError(
                    "worker exceeded the per-worker memory threshold "
                    f"({self.config.memory_usage_threshold:.0f} bytes)"))
            elif spec.options.pop("_preempted", False):
                # gang preemption: requeue with lineage intact WITHOUT
                # burning the crash-retry budget (the task did nothing
                # wrong; the scheduler took its chips back)
                self._bm_task_retry["value"] += 1
                self._record_event(
                    "task_retry", task_id=spec.task_id.hex(),
                    reason="preempted", retries_left=spec.retries_left,
                    **self._trace_fields(spec),
                )
                self._task_event(spec.task_id, state="PENDING_RETRY")
                self._enqueue_runnable(spec)
            elif spec.options.get("_timed_out"):
                # execute deadline (options(timeout_s=) / hung-worker
                # watchdog): the watchdog killed the worker. Retry
                # against the crash budget; past it, the error names
                # the timeout rather than a generic crash.
                timeout_s = spec.options.pop("_timed_out")
                if spec.retries_left > 0:
                    spec.retries_left -= 1
                    self._bm_task_retry["value"] += 1
                    self._record_event(
                        "task_retry", task_id=spec.task_id.hex(),
                        reason="timeout", retries_left=spec.retries_left,
                        **self._trace_fields(spec),
                    )
                    self._task_event(spec.task_id, state="PENDING_RETRY")
                    self._enqueue_runnable(spec)
                else:
                    from ..exceptions import TaskTimeoutError

                    self._fail_task(spec, TaskTimeoutError(
                        f"task exceeded its execute deadline of "
                        f"{timeout_s}s and its retry budget; the stalled "
                        f"worker was killed"
                    ))
            elif spec.retries_left > 0:
                spec.retries_left -= 1
                self._bm_task_retry["value"] += 1
                self._record_event(
                    "task_retry", task_id=spec.task_id.hex(),
                    reason="worker_died", retries_left=spec.retries_left,
                    **self._trace_fields(spec),
                )
                self._enqueue_runnable(spec)
            else:
                self._fail_task(spec, WorkerCrashedError("worker died while executing task"))
        if len(worker.assigned) > 1:
            # pipelined followers never started executing: requeue them
            # WITHOUT burning the crash-retry budget (only the head was
            # running). They hold no node resources until promotion, so
            # _release_task_resources only settles their fairshare clock.
            followers = list(worker.assigned)[1:]
            worker.assigned.clear()
            if spec is not None:
                worker.assigned.append(spec)  # head: handled above
            self._record_event(
                "pipeline_requeue", worker_id=worker.worker_id,
                count=len(followers),
            )
            for f in followers:
                self._release_task_resources(f)
                self._task_event(f.task_id, state="PENDING_RETRY")
                self._enqueue_runnable(f)
        if worker.actor_id or (spec is not None and spec.is_actor_create):
            actor_id = worker.actor_id or spec.actor_id
            actor = self.actors.get(actor_id)
            if actor is not None:
                if spec is not None and spec.is_actor_create and spec.pinned_deps:
                    # constructor died before _on_actor_ready transferred
                    # the creation-arg pins: move them to the actor entry
                    # so a restart keeps the args and permanent death
                    # (_drain_actor_queue_with_error) releases them
                    actor.creation_pins.extend(spec.pinned_deps)
                    spec.pinned_deps = []
                # release actor lifetime resources to the pool they came from
                if actor.state == "alive":
                    if actor.pool is not None and actor.pool[0] == "pg":
                        entry = self.pgs.get(actor.pool[1])
                        if entry is not None:
                            self._release(actor.resources, entry.bundle_avail[actor.pool[2]])
                    else:
                        home = self.nodes.get(
                            actor.pool[1] if actor.pool else worker.node_id
                        )
                        if home is not None:
                            self._release(actor.resources, home.avail)
                    actor.pool = None
                    self.fairsched.settle(actor.actor_id)
                if actor.restarts_left != 0 or worker.preempted:
                    # preemption restarts through this same path but
                    # never burns the restart budget (existing
                    # actor_restart machinery, reference semantics)
                    if actor.restarts_left > 0 and not worker.preempted:
                        actor.restarts_left -= 1
                    actor.state = "restarting"
                    actor.worker_id = None
                    self._record_event(
                        "actor_restart", actor_id=actor.actor_id.hex(),
                        name=actor.name, restarts_left=actor.restarts_left,
                    )
                    # in-flight calls fail; queued calls run on the new incarnation
                    blob = dumps_inline(ActorDiedError(msg="Actor died; call was in flight."))
                    for s in actor.inflight.values():
                        for oid in s.return_ids:
                            self._object_ready(oid, P.VAL_ERROR, blob, 0)
                        if s.options.get("streaming"):
                            self._end_stream_with_error(s.task_id, blob)
                        self._unpin_deps(s)
                    actor.inflight.clear()
                    respawn_opts = dict(actor.options)
                    # the new incarnation can tell it is a restart
                    # (get_runtime_context().was_current_actor_reconstructed)
                    respawn_opts["_restarted"] = True
                    respawn = TaskSpec(
                        task_id=actor.actor_id,
                        fn_id=actor.fn_id,
                        args_kind=actor.args_kind,
                        args_payload=actor.args_payload,
                        return_ids=[],
                        resources=actor.resources,
                        options=respawn_opts,
                        is_actor_create=True,
                        actor_id=actor.actor_id,
                        ready_id=actor.ready_id,
                    )
                    self.tasks[respawn.task_id] = respawn
                    self._enqueue_runnable(respawn)
                else:
                    actor.state = "dead"
                    self._drain_actor_queue_with_error(actor)
            else:
                # actor entry already gone: nothing can restart, drop
                # any creation-arg pins still on the spec
                self._unpin_deps(spec)
        self._dispatch()

    def _on_cancel(self, conn, p):
        """Cancel a task by one of its return objects. Queued tasks are
        dequeued and failed; RUNNING tasks are interrupted — SIGINT for
        the cooperative path, worker kill for force=True (reference:
        ray.cancel force semantics, core_worker CancelTask)."""
        oid = p["object_id"]
        force = p.get("force", False)
        from ..exceptions import TaskCancelledError

        for q in self.runnable.values():
            for spec in q:
                if oid in spec.return_ids:
                    q.remove(spec)
                    self.tasks.pop(spec.task_id, None)
                    self._fail_task(spec, TaskCancelledError("task was cancelled"))
                    return
        # quota-parked tasks (fairsched pending_quota)
        for spec in self.fairsched.parked_specs():
            if oid in spec.return_ids:
                self.fairsched.unpark(spec)
                self._refresh_pending_quota_gauge()
                self.tasks.pop(spec.task_id, None)
                self._fail_task(spec, TaskCancelledError("task was cancelled"))
                return
        # queued actor calls
        for actor in self.actors.values():
            for spec in list(actor.pending_calls):
                if oid in spec.return_ids:
                    actor.pending_calls.remove(spec)
                    self._fail_task(spec, TaskCancelledError("task was cancelled"))
                    return
        # actor calls already forwarded to the worker: mark them
        # cancelled worker-side (the worker drops them at dequeue; the
        # one currently executing cannot be cooperatively stopped)
        for actor in self.actors.values():
            for spec in actor.inflight.values():
                if oid in spec.return_ids:
                    worker = self.workers.get(actor.worker_id)
                    if worker is not None and worker.conn is not None:
                        self._send(worker.conn, P.CANCEL_TASK,
                                   {"task_id": spec.task_id,
                                    "return_ids": spec.return_ids})
                    return
        # pipelined followers queued in a worker's own task queue: drop
        # at dequeue (CANCEL_TASK marks it worker-side) and fail here —
        # they never started, hold no node resources, and need no
        # interrupt
        for w in self.workers.values():
            for spec in list(w.assigned)[1:]:
                if oid in spec.return_ids:
                    w.assigned.remove(spec)
                    if w.conn is not None:
                        self._send(w.conn, P.CANCEL_TASK,
                                   {"task_id": spec.task_id,
                                    "return_ids": spec.return_ids})
                    self.tasks.pop(spec.task_id, None)
                    self._fail_task(spec, TaskCancelledError("task was cancelled"))
                    return
        # running task: interrupt its worker
        for w in self.workers.values():
            spec = w.current_task
            if spec is not None and oid in spec.return_ids:
                spec.options["_cancelled"] = True
                spec.retries_left = 0
                if force:
                    self._kill_worker(w)
                elif w.proc is not None:
                    import signal

                    try:
                        w.proc.send_signal(signal.SIGINT)
                    except Exception:
                        pass
                # running on a remote node without force: best-effort
                # no-op (the reference likewise cannot interrupt
                # arbitrary native code without force)
                return

    # ----- placement groups
    def _on_create_pg(self, conn, p):
        from .ids import PlacementGroupID

        bundles = p["bundles"]
        strategy = p["strategy"]
        if strategy == "SLICE":
            # SLICE must fail loudly where it cannot deliver its promise
            # (ICI-contiguous chips), never degrade to SPREAD silently
            for b in bundles:
                t = b.get("GPU", 0)
                if t != int(t) or int(t) < 1:
                    self._reply(
                        conn, p["req_id"],
                        error="SLICE bundles must request whole TPU "
                              f"chips (>=1); got {b}",
                        pg_id=None,
                    )
                    return
            if not any(
                n.alive and n.chip_coords for n in self.nodes.values()
            ):
                self._reply(
                    conn, p["req_id"],
                    error="SLICE requires ICI topology, but no alive "
                          "node reports chip coordinates (set "
                          "TPU_TOPOLOGY or TPU_CHIP_COORDS)",
                    pg_id=None,
                )
                return
        if strategy == "STRICT_SPREAD" and len(bundles) > len(
            [n for n in self.nodes.values() if n.alive]
        ):
            self._reply(
                conn, p["req_id"],
                error=f"STRICT_SPREAD needs {len(bundles)} nodes, have "
                      f"{sum(1 for n in self.nodes.values() if n.alive)}",
                pg_id=None,
            )
            return
        pg_id = PlacementGroupID.generate().binary()
        # PG reservations hold resources exclusively — they count
        # against the tenant's quota like admitted tasks (and tasks
        # placed INTO the PG are exempt, so nothing double-counts).
        # Over-quota reservations fail fast instead of queueing.
        quota_err = self.fairsched.charge_reservation(
            pg_id, p.get("tenant") or "default",
            _sum_bundle_resources(bundles),
        )
        if quota_err is not None:
            self._reply(conn, p["req_id"], error=quota_err, pg_id=None)
            return
        entry = PGEntry(
            pg_id=pg_id,
            bundles=bundles,
            strategy=strategy,
            name=p.get("name", ""),
            ready=False,
            bundle_avail=[dict(b) for b in bundles],
            tenant=p.get("tenant") or "default",
            priority=self.fairsched.priority_of(p),
            job_id=p.get("job_id") or "",
            seq=next(self._pg_counter),
        )
        self.pgs[pg_id] = entry
        self._try_reserve_pg(entry)
        self._reply(conn, p["req_id"], pg_id=pg_id)

    def _try_reserve_pg(self, entry: PGEntry):
        """Reserve a PG's bundles, preempting lower-priority gangs when
        the reservation cannot fit (fairsched). A freshly-preempted PG
        stands aside (yield_to) until its beneficiary's reservation
        lands, so victims can't re-grab the chips they were taken off."""
        if entry.ready:
            return
        if entry.yield_to is not None:
            ben = self.pgs.get(entry.yield_to)
            if (
                ben is not None
                and not ben.ready
                and time.monotonic() < entry.yield_until
            ):
                return
            # beneficiary seated, vanished, or overstayed its window
            # (it may never become schedulable): stop standing aside
            entry.yield_to = None
        self._reserve_pg_attempt(entry)
        if entry.ready:
            return
        # Preemption sweep under the dispatch guard: _worker_died runs
        # _dispatch at the end of every victim kill, and on the
        # _on_create_pg/_on_pg_ready entry paths (outside a _dispatch
        # frame) that dispatch would re-place freed chips — or requeue
        # gang tasks into the still-ready victim PG — before the
        # beneficiary's re-reservation gets its turn, defeating the
        # preemption. Holding the flag defers those dispatches to one
        # pass AFTER the reservation retry.
        was_dispatching = self._dispatching
        self._dispatching = True
        try:
            preempted = self._preempt_for_pg(entry)
            if preempted:
                # victims died synchronously on this thread: their
                # chips and resources are back — retry right now
                entry.preempt_rounds += 1
                self._reserve_pg_attempt(entry)
        finally:
            self._dispatching = was_dispatching
        if entry.ready:
            entry.preempt_rounds = 0
        if preempted and not was_dispatching:
            self._dispatch()  # run the kills' deferred dispatch work

    def _reserve_pg_attempt(self, entry: PGEntry):
        """Assign each bundle to a node and acquire its resources — the
        reference's 2-phase GcsPlacementGroupScheduler collapsed to one
        atomic pass over the hub's authoritative node table
        (gcs_placement_group_scheduler.h:122; bundle packing policies
        src/ray/raylet/scheduling/policy/bundle_scheduling_policy.h)."""
        if entry.ready:
            return
        nodes = self._ordered_nodes()
        if not nodes:
            return
        if entry.strategy == "SLICE":
            self._try_reserve_slice(entry, nodes)
            return
        snap = {n.node_id: dict(n.avail) for n in nodes}
        assign: List[str] = []
        if entry.strategy in ("PACK", "STRICT_PACK"):
            total = _sum_bundle_resources(entry.bundles)
            for n in nodes:
                if self._resources_fit(total, snap[n.node_id]):
                    assign = [n.node_id] * len(entry.bundles)
                    break
            if not assign and entry.strategy == "STRICT_PACK":
                return  # stays pending until one node can host everything
        if not assign:
            # SPREAD / STRICT_SPREAD / PACK-fallback: greedy round-robin,
            # STRICT_SPREAD additionally requires distinct nodes
            distinct = entry.strategy == "STRICT_SPREAD"
            used: Set[str] = set()
            start = 0
            for b in entry.bundles:
                placed_on = None
                for off in range(len(nodes)):
                    n = nodes[(start + off) % len(nodes)]
                    if distinct and n.node_id in used:
                        continue
                    if self._resources_fit(b, snap[n.node_id]):
                        placed_on = n.node_id
                        break
                if placed_on is None:
                    return  # infeasible now; stays pending
                self._acquire(b, snap[placed_on])
                used.add(placed_on)
                assign.append(placed_on)
                start += 1
        # commit: move resources from the nodes into the bundles
        for b, nid in zip(entry.bundles, assign):
            self._acquire(b, self.nodes[nid].avail)
        entry.bundle_nodes = assign
        entry.ready = True

    def _try_reserve_slice(self, entry: PGEntry, nodes: List[NodeEntry]):
        """SLICE: reserve ICI-contiguous chips. One host => one simple
        path through the free-chip mesh split into per-bundle chunks;
        bigger gangs => one bundle per host, each host-contiguous (the
        cross-host hop rides DCN either way, so only intra-host
        contiguity matters). The reference has no equivalent — its TPU
        story stops at pod-name gang resources
        (python/ray/_private/accelerators/tpu.py:352-375)."""
        need = [int(b.get("GPU", 0)) for b in entry.bundles]
        total = sum(need)
        topo_nodes = [n for n in nodes if n.chip_coords]
        # 1) whole gang on one host, one contiguous path
        total_res = _sum_bundle_resources(entry.bundles)
        for n in topo_nodes:
            if not self._resources_fit(total_res, n.avail):
                continue
            path = _find_chip_path(n.chip_coords, n.free_tpu_chips, total)
            if path is None:
                continue
            i = 0
            chunks = []
            for k in need:
                chunks.append(tuple(path[i:i + k]))
                i += k
            self._commit_slice(entry, [n.node_id] * len(need), chunks)
            return
        # 2) one bundle per host, distinct hosts, each chunk contiguous
        # (preferred over mixed packing: bundle ranks map 1:1 onto
        # hosts, the layout multihost jobs expect)
        if len(topo_nodes) >= len(entry.bundles):
            plan: List[Tuple[NodeEntry, tuple]] = []
            used: Set[str] = set()
            feasible = True
            for b, k in zip(entry.bundles, need):
                found = None
                for n in topo_nodes:
                    if n.node_id in used:
                        continue
                    if not self._resources_fit(b, n.avail):
                        continue
                    path = _find_chip_path(
                        n.chip_coords, n.free_tpu_chips, k
                    )
                    if path is not None:
                        found = (n, tuple(path))
                        break
                if found is None:
                    feasible = False
                    break
                used.add(found[0].node_id)
                plan.append(found)
            if feasible:
                self._commit_slice(
                    entry,
                    [n.node_id for n, _ in plan],
                    [chunk for _, chunk in plan],
                )
                return
        # 3) mixed packing: k bundles per host, each bundle's chunk
        # host-contiguous. Greedy largest-first over per-host planned
        # copies of free chips/resources — places gangs that fragment
        # past cases 1 and 2 (e.g. 3x2-chip bundles on one fragmented
        # 8-chip host, or 4 bundles over 2 hosts).
        order = sorted(range(len(need)), key=lambda i: -need[i])
        planned_free = {n.node_id: set(n.free_tpu_chips) for n in topo_nodes}
        planned_avail = {n.node_id: dict(n.avail) for n in topo_nodes}
        mixed: List[Optional[Tuple[str, tuple]]] = [None] * len(need)
        for idx in order:
            b, k = entry.bundles[idx], need[idx]
            for n in topo_nodes:
                if not self._resources_fit(b, planned_avail[n.node_id]):
                    continue
                if k == 0:
                    mixed[idx] = (n.node_id, ())
                    self._acquire(b, planned_avail[n.node_id])
                    break
                path = _find_chip_path(
                    n.chip_coords, planned_free[n.node_id], k
                )
                if path is None:
                    continue
                mixed[idx] = (n.node_id, tuple(path))
                self._acquire(b, planned_avail[n.node_id])
                planned_free[n.node_id].difference_update(path)
                break
            if mixed[idx] is None:
                return  # infeasible now; stays pending
        self._commit_slice(
            entry,
            [a[0] for a in mixed],
            [a[1] for a in mixed],
        )

    def _commit_slice(self, entry: PGEntry, assign: List[str],
                      chunks: List[tuple]):
        for b, nid, chunk in zip(entry.bundles, assign, chunks):
            node = self.nodes[nid]
            self._acquire(b, node.avail)
            node.free_tpu_chips.difference_update(chunk)
            node.pg_reserved_chips.update(chunk)
        entry.bundle_nodes = assign
        entry.bundle_chips = chunks
        entry.ready = True

    def _on_remove_pg(self, conn, p):
        entry = self.pgs.pop(p["pg_id"], None)
        if entry is not None:
            self._release_pg_reservation(entry)
            self.fairsched.release_admission(entry.pg_id)
        self._dispatch()

    def _release_pg_reservation(self, entry: PGEntry):
        """Return a ready PG's bundles (and SLICE chips) to their nodes
        and reset the entry to the unreserved state. Used by PG removal
        and by gang preemption (where the entry stays registered so the
        victim can re-reserve later)."""
        if not entry.ready:
            return
        for b, nid in zip(entry.bundles, entry.bundle_nodes):
            node = self.nodes.get(nid)
            if node is not None and node.alive:
                self._release(b, node.avail)
        if entry.bundle_chips:
            for nid, chunk in zip(entry.bundle_nodes, entry.bundle_chips):
                node = self.nodes.get(nid)
                if node is None:
                    continue
                node.pg_reserved_chips.difference_update(chunk)
                # chips pinned by IDLE pooled workers come back
                # immediately (kill the worker — its jax binding is
                # useless outside the removed PG); busy/actor
                # workers release theirs on death (see _worker_died)
                pinned = set()
                for w in list(self.workers.values()):
                    if w.node_id != nid or not w.pinned_chips:
                        continue
                    if (
                        w.state == "idle"
                        and w.actor_id is None
                        and set(w.pinned_chips) & set(chunk)
                    ):
                        self._kill_worker(w)
                        self._worker_died(w)
                        continue
                    pinned.update(w.pinned_chips)
                node.free_tpu_chips.update(set(chunk) - pinned)
        entry.ready = False
        entry.bundle_avail = [dict(b) for b in entry.bundles]
        entry.bundle_nodes = []
        entry.bundle_chips = []

    # ----- gang preemption (fairsched)
    # one window bounds both sides of a preemption: a beneficiary may
    # not preempt again, and its victims stand aside (yield_to), for
    # this long — so a mis-estimated reservation can neither kill-storm
    # nor starve its victims past the window
    _PREEMPT_BACKOFF_S = 10.0
    # and after this many victim rounds without seating, the
    # beneficiary stops preempting entirely (preemption_gave_up event)
    _PREEMPT_MAX_ROUNDS = 2

    def _preempt_for_pg(self, entry: PGEntry) -> bool:
        """A reservation cannot fit: reclaim capacity from strictly
        lower-priority work — whole gangs (ready PGs) or single running
        plain tasks, lowest priority first, never partial gangs. The
        kills ride the existing retry/restart machinery, so preempted
        tasks requeue with lineage intact and preempted actors restart
        (actor_restart path). Returns True if anything was preempted."""
        pri = int(entry.priority or 0)
        now = time.monotonic()
        if now - entry.last_preempt_t < self._PREEMPT_BACKOFF_S:
            # this reservation already attempted preemption recently —
            # the 50ms pg_ready poll must not turn a stuck reservation
            # into a rolling kill storm (or a repeated O(workers+pgs)
            # candidate sweep)
            return False
        if entry.preempt_rounds >= self._PREEMPT_MAX_ROUNDS:
            # shed victims twice and still not seated: the feasibility
            # estimate is wrong for this cluster shape — stop
            # destroying lower-priority work (recorded once below)
            if entry.preempt_rounds == self._PREEMPT_MAX_ROUNDS:
                entry.preempt_rounds += 1
                self._record_event(
                    "preemption_gave_up", pg_id=entry.pg_id.hex(),
                    tenant=entry.tenant, priority=entry.priority,
                    rounds=self._PREEMPT_MAX_ROUNDS,
                )
            return False
        # arm the backoff for EVERY attempt — including one that finds
        # no candidates — so a reservation waiting on its 50ms poll
        # pays this sweep at most once per window
        entry.last_preempt_t = now
        pg_cands = [
            g for g in self.pgs.values()
            if g.ready and g is not entry and int(g.priority or 0) < pri
        ]
        task_cands: List[Tuple[WorkerEntry, TaskSpec]] = []
        for w in self.workers.values():
            spec = w.current_task
            if (
                spec is None
                or spec.is_actor_create
                or spec.options.get("placement_group")
            ):
                continue  # PG-resident work dies with its gang, not alone
            if self.fairsched.priority_of(spec.options) < pri:
                task_cands.append((w, spec))
        if not pg_cands and not task_cands:
            return False
        need_chips = sum(int(b.get("GPU", 0)) for b in entry.bundles)
        max_bundle = max(
            entry.bundles, key=lambda b: int(b.get("GPU", 0)),
            default={},
        )
        need_res = _sum_bundle_resources(entry.bundles)
        free_by_node: Dict[str, int] = {}
        avail_by_node: Dict[str, Dict[str, float]] = {}
        for n in self.nodes.values():
            if not n.alive:
                continue
            free_by_node[n.node_id] = len(n.free_tpu_chips)
            avail_by_node[n.node_id] = dict(n.avail)
        victim_pgs, victim_tasks = self.fairsched.preemption_victims(
            pri, need_chips, max_bundle, need_res, pg_cands,
            task_cands, free_by_node, avail_by_node,
        )
        for w, spec in victim_tasks:
            self._bm_preemptions["value"] += 1
            self.fairsched.note_preemption(spec.options)
            self._record_event(
                "preemption", gang="task", task_id=spec.task_id.hex(),
                tenant=spec.options.get("tenant") or "default",
                priority=self.fairsched.priority_of(spec.options),
                by_pg=entry.pg_id.hex(), by_priority=pri,
                by_tenant=entry.tenant, **self._trace_fields(spec),
            )
            spec.options["_preempted"] = True
            w.preempted = True
            self._kill_worker(w)
            self._worker_died(w)
        for pg in victim_pgs:
            self._preempt_pg(pg, entry)
        return bool(victim_pgs or victim_tasks)

    def _preempt_pg(self, victim: PGEntry, beneficiary: PGEntry):
        """Preempt one whole gang: kill every worker running a task or
        hosting an actor placed in the victim PG (their specs requeue /
        actors restart without burning budgets), then release the
        reservation. The victim stands aside (yield_to) until the
        beneficiary's reservation is ready, then re-reserves and its
        requeued gang resumes."""
        self._bm_preemptions["value"] += 1
        self.fairsched.note_preemption(
            {"tenant": victim.tenant, "job_id": victim.job_id}
        )
        self._record_event(
            "preemption", gang="pg", pg_id=victim.pg_id.hex(),
            name=victim.name, tenant=victim.tenant,
            priority=victim.priority, by_pg=beneficiary.pg_id.hex(),
            by_priority=beneficiary.priority, by_tenant=beneficiary.tenant,
        )
        victim.yield_to = beneficiary.pg_id
        victim.yield_until = time.monotonic() + self._PREEMPT_BACKOFF_S
        for w in list(self.workers.values()):
            spec = w.current_task
            in_gang = False
            if spec is not None:
                pgopt = spec.options.get("placement_group")
                in_gang = bool(pgopt) and pgopt[0] == victim.pg_id
            if not in_gang and w.actor_id:
                actor = self.actors.get(w.actor_id)
                in_gang = (
                    actor is not None
                    and actor.pool is not None
                    and actor.pool[0] == "pg"
                    and actor.pool[1] == victim.pg_id
                )
            if not in_gang:
                continue
            if spec is not None and not spec.is_actor_create:
                spec.options["_preempted"] = True
            w.preempted = True
            self._kill_worker(w)
            self._worker_died(w)
        self._release_pg_reservation(victim)

    def _on_pg_ready(self, conn, p):
        entry = self.pgs.get(p["pg_id"])
        if entry is None:
            self._reply(conn, p["req_id"], ready=False)
            return
        self._try_reserve_pg(entry)
        if entry.ready:
            self._reply(conn, p["req_id"], ready=True)
            return
        deadline = time.monotonic() + (p.get("timeout") or 3600.0)
        req_id = p["req_id"]

        def poll(entry=entry, conn=conn, req_id=req_id, deadline=deadline):
            self._try_reserve_pg(entry)
            if entry.ready:
                self._reply(conn, req_id, ready=True)
            elif time.monotonic() > deadline:
                self._reply(conn, req_id, ready=False)
            else:
                self._add_timer(0.05, poll)

        self._add_timer(0.05, poll)

    # ----- introspection
    def _on_get_actor(self, conn, p):
        key = (p.get("namespace") or "default", p["name"])
        aid = self.named_actors.get(key)
        if aid is not None and self.actors.get(aid) and self.actors[aid].state == "dead":
            aid = None
        self._reply(conn, p["req_id"], actor_id=aid)

    def _on_cluster_resources(self, conn, p):
        res: Dict[str, float] = {}
        for n in self.nodes.values():
            if not n.alive:
                continue
            src_pool = n.avail if p.get("available") else n.total
            for k, v in src_pool.items():
                res[k] = res.get(k, 0.0) + v
        self._reply(conn, p["req_id"], resources=res)

    def _on_list_state(self, conn, p):
        kind = p["kind"]
        items: List[dict] = []
        if kind == "actors":
            for a in self.actors.values():
                items.append(
                    {
                        "actor_id": a.actor_id.hex(),
                        "state": a.state.upper(),
                        "name": a.name,
                        "resources": a.resources,
                    }
                )
        elif kind == "workers":
            for w in self.workers.values():
                items.append({
                    "worker_id": w.worker_id, "state": w.state,
                    "node_id": w.node_id,
                    "pid": w.proc.pid if w.proc else w.pid,
                })
        elif kind == "tasks":
            items = list(self.task_events)
        elif kind == "events":
            items = list(self.events)
        elif kind == "traces":
            tid = p.get("trace_id")
            if tid:
                # one trace's raw spans (the CLI/dashboard run the
                # critical-path analyzer client-side on these)
                items = [dict(s) for s in self._trace_index.get(tid, ())]
            else:
                # running summaries (maintained in _record_span): the
                # overview never rescans every stored span dict
                for summ in self._trace_summaries.values():
                    items.append({
                        "trace_id": summ["trace_id"],
                        "n_spans": summ["n_spans"],
                        "start": summ["start"],
                        # anchored-monotonic stamps (util/tracing
                        # wall_at), so the difference IS a duration
                        "duration_s": summ["end"] - summ["start"],
                        "root": summ["root"],
                        "processes": len(summ["procs"]),
                    })
        elif kind == "metrics":
            self._merge_shard_metrics()
            for m in self.metrics.values():
                items.append(dict(m, buckets=[list(b) for b in m["buckets"]]))
        elif kind == "shards":
            # control-plane topology: one row per reactor shard plus a
            # row per state service (sharded mode; a single-reactor hub
            # reports its one implicit shard)
            if self._shards:
                for s in self._shards:
                    # same scrape-time monotonic-counter read as
                    # _merge_shard_metrics (see the note there)
                    st = s.stats  # graftlint: disable=GL013 — scrape-time monotonic counter read
                    items.append({
                        "shard": s.idx, "conns": st.conns,
                        "accepted": st.accepted, "wakeups": st.wakeups,
                        "frames_sent": st.frames_sent,
                        "drain_saturated": st.drain_saturated,
                        "backpressure": st.backpressure,
                    })
                for name, svc in self.state_services.items():
                    items.append({
                        "service": name, "processed": svc.processed,
                    })
            else:
                # same semantics as a shard's st.conns: every registered
                # socket (workers, agents, drivers, clients) — derived
                # from the live selector map minus the listener entry
                sel = self._selector
                n_conns = (
                    max(0, len(sel.get_map()) - 1) if sel is not None else 0
                )
                items.append({
                    "shard": 0,
                    "conns": n_conns,
                    "wakeups": int(self._bm_wakeups["value"]),
                    "frames_sent": int(self._bm_flushes["value"]),
                })
        elif kind == "timeline":
            # chrome://tracing "complete" events (reference: ray.timeline
            # via GCS task events -> chrome trace). Wall stamps position
            # the slices; durations come from the monotonic t_* twins
            # (GL008: a wall-clock delta is not a duration).
            now_mono = time.monotonic()
            for ev in self.task_events:
                if "started_at" not in ev:
                    continue
                t_sched = ev.get("t_scheduled")
                t_fin = ev.get("t_finished")
                dur_s = 0.0
                if t_sched is not None:
                    dur_s = (t_fin if t_fin is not None else now_mono) - t_sched
                items.append({
                    "name": ev.get("name", ""),
                    "cat": "task",
                    "ph": "X",
                    "ts": ev["started_at"] * 1e6,
                    "dur": max(0.0, dur_s * 1e6),
                    "pid": ev.get("node_id", "node0"),
                    "tid": ev.get("worker_id", ""),
                    "args": {"task_id": ev["task_id"],
                             "state": ev.get("state")},
                })
                # state-transition slice: the queued phase rendered
                # alongside the run slice so a saturated scheduler is
                # visible at a glance. Same fallback chain as the
                # placement metric and summarize_tasks: retries
                # re-stamp t_queued, and the first attempt's RUN time
                # must not render as the retry's queue wait. The slice
                # is end-aligned to the dispatch moment (started_at).
                t0 = ev.get("t_queued") or ev.get("t_submit")
                if (t0 is not None and t_sched is not None
                        and "submitted_at" in ev):
                    qdur = max(0.0, (t_sched - t0) * 1e6)
                    items.append({
                        "name": f"{ev.get('name', '')} [queued]",
                        "cat": "task_state",
                        "ph": "X",
                        "ts": ev["started_at"] * 1e6 - qdur,
                        "dur": qdur,
                        "pid": ev.get("node_id", "node0"),
                        "tid": ev.get("worker_id", ""),
                        "args": {"task_id": ev["task_id"],
                                 "transition": "SUBMITTED->RUNNING"},
                    })
            for sp in self.spans:
                items.append({
                    "name": sp.get("name", ""),
                    "cat": "span",
                    "ph": "X",
                    "ts": sp["start"] * 1e6,
                    "dur": max(0.0, (sp["end"] - sp["start"]) * 1e6),
                    "pid": sp.get("node_id", "node0"),
                    "tid": f"pid={sp.get('pid', '')}",
                    "args": {
                        "trace_id": sp.get("trace_id"),
                        "span_id": sp.get("span_id"),
                        "parent_id": sp.get("parent_id"),
                        **(sp.get("attrs") or {}),
                    },
                })
        elif kind == "placement_groups":
            for g in self.pgs.values():
                items.append({
                    "pg_id": g.pg_id.hex(),
                    "strategy": g.strategy,
                    "ready": g.ready,
                    "bundles": g.bundles,
                    "bundle_nodes": list(g.bundle_nodes),
                    "bundle_chips": [list(c) for c in g.bundle_chips],
                })
        elif kind == "objects":
            now_mono = time.monotonic()
            for oid, e in self.objects.items():
                items.append({
                    "object_id": oid.hex(), "ready": e.ready,
                    "size": e.size, "kind": e.kind,
                    "node_id": e.node_id,
                    "owner": e.owner,
                    "owner_alive": self._owner_alive(e.owner),
                    "age_s": max(0.0, now_mono - e.created_t),
                    "pins": e.pins,
                    "spilled": e.spilled,
                })
        elif kind == "profile":
            # folded profiler samples + per-process sampler meta rows.
            # Task names join through the task-event index (both sides
            # key on hex task ids).
            names: Dict[str, str] = {}
            for ev in self.task_events:
                nm = ev.get("name")
                if nm:
                    names[ev["task_id"]] = nm
            for skey, n in self.profile_samples.items():
                pid, pkind, domain, stage, task, stack = skey
                items.append({
                    "pid": pid, "kind": pkind, "thread": domain,
                    "stage": stage, "task_id": task,
                    "task_name": names.get(task, ""),
                    "stack": stack, "samples": n,
                })
            now_mono = time.monotonic()
            for pid, meta in self.profile_procs.items():
                items.append({
                    "proc": True, "pid": pid, "kind": meta["kind"],
                    "overhead": meta["overhead"], "hz": meta["hz"],
                    "idle_s": max(0.0, now_mono - meta["last_t"]),
                    "drops": self._profile_drops,
                })
        elif kind == "demand":
            # pending resource demand by shape (reference: the load the
            # raylet reports to the GCS for the autoscaler,
            # autoscaler/v2 ClusterStatus.resource_demands)
            shapes: Dict[tuple, int] = {}
            for q in self.runnable.values():
                for spec in q:
                    key = tuple(sorted(spec.resources.items()))
                    shapes[key] = shapes.get(key, 0) + 1
            for key, count in shapes.items():
                items.append({"shape": dict(key), "count": count})
            # quota-parked work is visible but flagged: the autoscaler
            # must NOT buy nodes for demand an admission quota blocks
            # (post-quota demand, not raw queue depth)
            pshapes: Dict[tuple, int] = {}
            for spec in self.fairsched.parked_specs():
                key = tuple(sorted(spec.resources.items()))
                pshapes[key] = pshapes.get(key, 0) + 1
            for key, count in pshapes.items():
                items.append({
                    "shape": dict(key), "count": count,
                    "pending_quota": True,
                })
        elif kind == "chaos":
            # fault-injection plane: the active plan + trigger counts
            # first, then recent fault events from the flight recorder
            # (chaos_* kinds plus the recovery events they provoke)
            if self._chaos is not None:
                snap = self._chaos.snapshot()
                items.append({
                    "plan": snap["plan"], "seed": snap["seed"],
                    "armed": snap["armed"],
                    "elapsed_s": snap["elapsed_s"],
                    "counts": snap["counts"],
                    "pending_timed": snap["pending_timed"],
                    "partitions": snap["partitions"],
                })
            fault_kinds = ("task_timeout", "node_heartbeat_miss")
            for ev in self.events:
                k = ev.get("kind", "")
                if k.startswith("chaos_") or k in fault_kinds:
                    items.append(dict(ev))
        elif kind == "jobs":
            items = self.fairsched.job_table()
        elif kind == "tenants":
            items = self.fairsched.tenant_table()
        elif kind == "nodes":
            for n in self.nodes.values():
                items.append(
                    {
                        "node_id": n.node_id,
                        "hostname": n.hostname,
                        "ip": n.ip,
                        "alive": n.alive,
                        "resources": dict(n.total),
                        "available": dict(n.avail),
                    }
                )
        elif kind == "serve":
            # pivot the serve metric series into one row per
            # (deployment, route): counters/gauges flatten to scalars,
            # histograms keep {sum, count, buckets} so the client side
            # (util/state.summarize_serve) can estimate percentiles and
            # batch efficiency without a second scrape
            self._merge_shard_metrics()
            prefix = "ray_tpu_torch_serve_"
            rows: Dict[tuple, dict] = {}
            for (mname, tags), m in self.metrics.items():
                if not mname.startswith(prefix):
                    continue
                tagmap = dict(tags)
                key = (tagmap.get("deployment", ""), tagmap.get("route", ""))
                row = rows.setdefault(
                    key, {"deployment": key[0], "route": key[1]}
                )
                short = mname[len(prefix):]
                if m["type"] == "histogram":
                    row[short] = {
                        "sum": m["sum"],
                        "count": m["count"],
                        "buckets": [list(b) for b in m["buckets"]],
                    }
                else:
                    row[short] = m["value"]
            items = [rows[k] for k in sorted(rows)]
        self._reply(conn, p["req_id"], items=items)

    def _on_shutdown(self, conn, p):
        self._running = False

    def shutdown(self, timeout: float = 5.0):
        self._running = False
        # wake router via a self-connection
        try:
            from .client import connect_hub

            c = connect_hub(self.addr)
            c.close()
        except Exception:
            pass
        self._shutdown_evt.wait(timeout)
        for w in self.workers.values():
            if w.proc is not None:
                try:
                    w.proc.terminate()
                    w.proc.wait(timeout=1)
                except Exception:
                    try:
                        w.proc.kill()
                    except Exception:
                        pass
        if self._kv_store is not None:
            self._kv_store.close()
