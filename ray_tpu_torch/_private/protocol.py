"""Wire protocol between clients (driver/workers) and the control hub.

The reference splits control flow across gRPC services (GCS, raylet,
worker-to-worker; reference: src/ray/protobuf/*.proto, 21 files). On a
TPU host the control plane is node-local, so we use framed pickle over
AF_UNIX sockets (multiprocessing.connection) — one hub, star topology.
Bulk data never rides these messages; it goes through the shm object
store (object_store.py).

The hub end of every connection may be a single reactor or one of N
reactor shards (RAY_TPU_TORCH_HUB_SHARDS, hub_shards.py); the protocol is
identical either way — sharding is invisible on the wire. The only
per-connection guarantee clients rely on is FIFO delivery of their own
messages, which each owning shard preserves end-to-end.

Every message is a (msg_type:str, payload:dict) pair encoded with
serialization.dumps_frame. Frames carry a one-byte codec marker:
``b"P"`` (stdlib pickle — the fast path; control frames are dicts of
primitives/bytes) or ``b"C"`` (cloudpickle — payload blobs, and the
automatic fallback for any frame stdlib pickle rejects). Both decode
via serialization.loads_frame. Several messages may be coalesced into
one ("batch", [(msg_type, payload), ...]) frame by either side
(client send_async buffering; hub outbox flush).
"""

# client -> hub
HELLO = "hello"
SUBMIT_TASK = "submit_task"
SUBMIT_TASKS = "submit_tasks"  # N homogeneous tasks in ONE frame
                               # (RemoteFunction.map / submit_many /
                               # the client's transparent auto-batch):
                               # {fn_id, resources, options, tasks:
                               # [{task_id, args_kind, args_payload,
                               # arg_deps, return_ids}, ...], req_id}.
                               # The shared fields are hoisted out of
                               # the per-task dicts; the hub acks via
                               # REPLY(req_id) so the client can
                               # retransmit a dropped batch (per-task
                               # dedup on task_id makes replay safe).
                               # Optional "pipeline": False (spliced by
                               # auto-batched frames) keeps the batch
                               # out of bulk worker pipelining — plain
                               # .remote() placement semantics; absent
                               # = True for the explicit bulk paths.
                               # Auto-batched frames are SPLICED from a
                               # cached opcode prefix plus hand-emitted
                               # per-task fragments (serialization.py)
                               # — indistinguishable on the wire from a
                               # dumps_frame encoding of the same dict
PUT = "put"
GET = "get"
WAIT = "wait"
FREE = "free"
RELEASE_OWNED = "release_owned"  # owner-side GC: the last local handle
                                 # died with the ref never pickled, so
                                 # no other holder can exist — free the
                                 # object(s). Batched client-side (rides
                                 # the next flush's "batch" frame)
CREATE_ACTOR = "create_actor"
SUBMIT_ACTOR_TASK = "submit_actor_task"
KILL_ACTOR = "kill_actor"
CANCEL = "cancel"
REGISTER_FUNCTION = "register_function"
GET_FUNCTION = "get_function"
KV_PUT = "kv_put"
KV_GET = "kv_get"
KV_DEL = "kv_del"
KV_KEYS = "kv_keys"
CREATE_PG = "create_pg"
REMOVE_PG = "remove_pg"
PG_READY = "pg_ready"
GET_ACTOR = "get_actor"
LIST_STATE = "list_state"
CLUSTER_RESOURCES = "cluster_resources"
SHUTDOWN = "shutdown"
REGISTER_JOB = "register_job"  # driver/job -> hub: scheduling identity
                               # {job_id, tenant, priority, quota} for
                               # the fairsched policy engine (multi-
                               # tenant priority/fair-share/preemption)

# worker -> hub
TASK_DONE = "task_done"
ACTOR_READY = "actor_ready"

# any process -> hub: one finished tracing span (util/tracing.py — user
# spans and the runtime's own stage spans share this message; the hub
# indexes them per trace_id for list_state("traces")). Distributed
# trace CONTEXT does not get its own message: a sampled request carries
# an optional "trace": (trace_id, parent_span_id) field inside the
# SUBMIT_TASK / SUBMIT_ACTOR_TASK / GET / PUT payload, and the hub
# forwards (trace_id, its-dispatch-span-id) in EXEC_* payloads so
# worker-side spans and nested submits stitch into the same trace.
# Absent the field (sampling off, the default) every path is untouched.
SPAN_RECORD = "span_record"

# any process -> hub: one util.metrics recording (counter inc / gauge
# set / histogram observe); the hub folds it into its metric registry
METRIC_RECORD = "metric_record"

# any process -> hub: one flush of the sampling profiler's locally
# folded stacks (profiling.py — opt-in via RAY_TPU_TORCH_PROFILE_HZ, default
# off: with the sampler never started this message type never appears
# on the wire). Payload: {pid, kind ("driver"/"worker"/"hub"/...),
# samples: {collapsed-stack-key: count}, overhead, hz} — the hub folds
# the deltas into its bounded profile store (list_state("profile"))
# and exports the per-process overhead ratio as a builtin gauge.
PROFILE_BATCH = "profile_batch"

# on-demand all-thread stack dumps (`ray_tpu stack`, reference: `ray
# stack` / py-spy dump). No profiler needed — the dump reads
# sys._current_frames() at request time.
STACK_REQUEST = "stack_request"  # client -> hub: {target, req_id} where
                                 # target is "hub", a worker id, or a
                                 # pid; hub-target answered inline,
                                 # otherwise forwarded as STACK_DUMP
STACK_DUMP = "stack_dump"        # hub -> worker/client: {token} — dump
                                 # your threads and reply STACK_REPLY
STACK_REPLY = "stack_reply"      # process -> hub: {token, threads:
                                 # [{thread, daemon, frames}, ...]} —
                                 # routed back to the parked requester

# streaming generators (reference: _raylet.pyx:280 ObjectRefGenerator)
STREAM_YIELD = "stream_yield"    # worker -> hub: one yielded value
STREAM_END = "stream_end"        # worker -> hub: generator exhausted/raised
STREAM_NEXT = "stream_next"      # client -> hub: resolve the i-th ref
STREAM_CREDIT = "stream_credit"  # worker -> hub: backpressure wait

# node agent <-> hub (multi-host: one agent per host, reference analogue
# src/ray/raylet/node_manager.h:122 registering with the GCS)
REGISTER_NODE = "register_node"
NODE_HEARTBEAT = "node_heartbeat"  # agent -> hub: cpu/rss/worker gauges
SPAWN_WORKER = "spawn_worker"      # hub -> agent: fork a worker process
WORKER_EXITED = "worker_exited"    # agent -> hub: child died pre-connect
KILL_WORKER = "kill_worker"        # hub -> agent: SIGKILL a worker (task
                                   # timeout / hung-worker watchdog — a
                                   # stalled process ignores the
                                   # cooperative KILL message)
OBJ_READ = "obj_read"              # hub -> agent: read a shm segment
OBJ_READ_REPLY = "obj_read_reply"  # agent -> hub: segment bytes
OBJ_UNLINK = "obj_unlink"          # hub -> agent: free a shm segment
OBJ_SPILL = "obj_spill"            # hub -> agent: move a segment to disk
OBJ_RESTORE = "obj_restore"        # hub -> agent: move it back to shm
FETCH_OBJECT = "fetch_object"      # client -> hub: pull a remote segment
                                   # (optional offset/length for chunked
                                   # streaming to shm-less clients). The
                                   # hub-RELAY path: the out-of-band
                                   # object plane (RESOLVE_OBJECT +
                                   # object_agent.py) is tried first and
                                   # falls back here; a "fallback" field
                                   # on the first chunk records the
                                   # object_transfer_fallback event
PUT_CHUNK = "put_chunk"            # client -> hub: one slice of a large
                                   # put streamed over the connection
                                   # (reference: util/client/server/
                                   # dataservicer.py chunked PutObject).
                                   # Carries an explicit "offset" so a
                                   # replayed chunk (retransmit after a
                                   # lost reply) rewrites the same bytes
                                   # instead of corrupting the segment

# ---- out-of-band object plane (reference: the ownership directory +
# PullManager/object-manager direct transfer split, src/ray/
# object_manager/ + core_worker/reference_count.h ownership): bulk
# object bytes move peer<->peer over per-node object_agent endpoints
# (object_agent.py), NOT through the hub reactor; the hub only answers
# location queries and tracks the replica set.
RESOLVE_OBJECT = "resolve_object"  # client -> hub: where does this shm
                                   # object live? -> {name, size, node_id,
                                   # endpoint, path, spilled}. Clients
                                   # cache the answer; the cache is
                                   # invalidated by the __obj_freed__ and
                                   # __node_down__ pubsub channels
REPLICA_ADDED = "replica_added"    # client -> hub (async): a direct fetch
                                   # installed a copy of the segment on
                                   # this node; the directory adds it to
                                   # the object's replica set

# client <-> object agent, on the agent's own endpoint (never the hub
# conn). Same dumps_frame framing; request/response, replies read
# inline by the caller rather than through a dispatch table.
OBJ_GET = "obj_get"        # client -> agent: stream me a segment
OBJ_DATA = "obj_data"      # agent -> client: one 8 MiB chunk {data,
                           # total, last}
OBJ_PUT = "obj_put"        # client -> agent: one inbound chunk {name,
                           # data, last}
OBJ_PUT_OK = "obj_put_ok"  # agent -> client: whole put landed {size}
OBJ_ERROR = "obj_error"    # agent -> client: fetch/put failed {error};
                           # the caller falls back to the hub relay

# ---- readiness push (reference: the core worker's object-ready
# callbacks from the local memory store instead of polling GCS): a
# wait() over not-ready refs subscribes ONCE; the hub pushes ready sets
# as producing tasks finish, so a 1k-ref pop-loop costs one
# subscription plus pushes instead of a round trip per poll.
SUBSCRIBE_READY = "subscribe_ready"  # client -> hub: {object_ids} ->
                                     # reply {ready: [...]} for the
                                     # already-ready subset; the rest are
                                     # registered for push
READY_PUSH = "ready_push"            # hub -> client: {ready: [oids]}

# hub -> worker
EXEC_TASK = "exec_task"
EXEC_ACTOR_CREATE = "exec_actor_create"
EXEC_ACTOR_TASK = "exec_actor_task"
KILL = "kill"
CANCEL_TASK = "cancel_task"  # hub -> worker: drop a queued task

# pubsub (reference: src/ray/pubsub/ long-poll publisher; here
# subscribers hold persistent conns so publish is a direct push)
SUBSCRIBE = "subscribe"      # client -> hub: {channel}
PUBLISH = "publish"          # client -> hub -> subscribers: {channel, blob}
                             # blob = dumps_inline(user data) — opaque to
                             # the hub, unwrapped by the subscriber; only
                             # hub-INTERNAL publishes use a plain {channel,
                             # data} body (primitives only — raw user
                             # objects must never ride a frame unblobbed)
PUBSUB_MSG = "pubsub_msg"    # hub -> subscriber push
LOG_RECORD = "log_record"    # worker -> hub: stdout/stderr line batch

# hub -> client
REPLY = "reply"

# object value kinds (in GET replies and TASK_DONE returns)
VAL_INLINE = "inline"  # payload = serialized bytes
VAL_SHM = "shm"  # payload = segment name
VAL_ERROR = "error"  # payload = serialized exception
