"""Framework-wide config table with env overrides.

Parity: src/ray/common/ray_config_def.h (224 RAY_CONFIG entries read
from RAY_xxx env vars) — a single typed table every subsystem reads
instead of scattering magic numbers. Override any knob with
RAY_TPU_TORCH_<NAME>=<value>; values are parsed to the default's type.
"""

from __future__ import annotations

import os
from typing import Any, Dict

_DEFAULTS: Dict[str, Any] = {
    # object plane
    "inline_object_threshold": 100 * 1024,   # plasma-vs-inline cutoff
    "object_store_memory": 0.0,              # 0 = unlimited (no spill)
    # out-of-band object plane (object_agent.py): per-node data-plane
    # endpoints + the hub's ownership/location directory. object_agent
    # turns the serving side on; object_direct turns the consuming side
    # (resolve-then-pull / direct put) on — with either off, transfers
    # ride the hub-relay path exactly as before.
    "object_agent": True,
    "object_direct": True,
    # readiness push: wait() over not-ready refs subscribes once and the
    # hub pushes ready sets; off = the classic parked-WAIT request path
    "ready_push": True,
    # serve data plane: request/response payloads strictly larger than
    # this spill onto the direct object plane (serve/_private/
    # payloads.py) instead of riding VAL_INLINE through the hub;
    # 0 disables spilling. Deliberately below inline_object_threshold:
    # a serve payload crosses the wire twice (handle->replica,
    # replica->consumer), so the object plane pays off earlier.
    "serve_inline_max": 64 * 1024,
    # HTTP ingress request-body cap (aiohttp client_max_size). The
    # payload plane makes multi-MiB bodies routine; aiohttp's 1 MiB
    # default would 413 them at the front door.
    "serve_http_max_body": 1 << 30,
    # serve resilience: end-to-end request deadline (seconds). Born at
    # the router, rides request_meta to the replica and batch queue,
    # and bounds every blocking wait on the way (the proxy's result()
    # and the router's no-replica wait derive from it — no more literal
    # 60 s / 30 s). 0 = no deadline. Per-request override:
    # handle.options(request_timeout_s=...).
    "serve_request_timeout_s": 60.0,
    # admission control: cap on a handle's outstanding (routed, not yet
    # settled) requests per deployment; past it, new requests shed
    # immediately with a retriable error (HTTP 503) instead of queueing
    # into a timeout. 0 = unlimited. Per-deployment override:
    # @serve.deployment(max_queued_requests=N).
    "serve_max_queued_requests": 0,
    # router-side replica health ejection: a replica failing this many
    # consecutive requests is removed from the candidate set and
    # re-probed with jittered exponential backoff until healthy again
    "serve_ejection_failures": 3,
    "serve_probe_base_s": 0.25,     # ejected-replica re-probe backoff base
    "serve_probe_max_s": 5.0,       # ...and ceiling
    # transparent replica-retry budget (replica died mid-request):
    # bounded attempts with growing jittered delay, deadline-capped
    "serve_retry_attempts": 3,
    "serve_retry_base_s": 0.05,
    # driver-side warm segment pool: pre-create + pre-fault this many
    # bytes of pooled tmpfs segments in the background at init, so the
    # FIRST large put already memcpys into faulted pages (the plasma
    # arena trick). Split into two segments (each serves one put up to
    # half the budget; the default's 264 MiB halves cover 256 MiB-class
    # objects with slack, so carving one truncates away only a few MiB
    # of warm tail pages). 0 = off.
    "segment_prewarm_bytes": 2 * 264 * 1024 * 1024,
    # control plane: reactor shard count for the hub. 0 = auto
    # (min(4, cpu count)); 1 = the original single-reactor loop
    # (byte-for-byte identical wire behavior); N>1 = N reactor shard
    # threads + a state-plane thread (hub_shards.py)
    "hub_shards": 0,
    # scheduling / workers
    "worker_reap_period_s": 1.0,
    "max_pending_spawns_per_node": 32,
    # rpc: retry-safe requests retransmit with capped exponential
    # backoff + jitter — period is the base delay (0 = retransmit OFF:
    # requests park on their first send), max is the backoff ceiling
    "request_retry_period_s": 2.0,
    "request_retry_max_s": 30.0,
    "client_batch_max": 128,
    # transparent auto-batching: plain .remote() calls to the same
    # template that land within this window (microseconds) ship as ONE
    # SUBMIT_TASKS frame through the bulk ABI (client.py
    # submit_batched). ObjectRefs still return synchronously; the
    # window only delays the WIRE flush. 0 disables — every call rides
    # the classic per-call SUBMIT_TASK frame; batch_window()/map()
    # still batch explicitly either way.
    "submit_autobatch_window_us": 300,
    # memory monitor (reference: common/memory_monitor.h + raylet
    # worker_killing_policy.cc) — kill the newest worker past the cap
    "memory_monitor_period_s": 1.0,
    "memory_usage_threshold": 0.0,           # bytes/worker; 0 = disabled
    # observability
    "task_events_max": 20000,
    "runtime_events_max": 2000,          # flight-recorder ring size
    "builtin_metrics": True,             # ray_tpu_* runtime self-metrics
    # sampling profiler (profiling.py): wall-clock sample rate in Hz for
    # the per-process daemon sampler. 0 (the default) = the sampler
    # thread is never created and no PROFILE_BATCH frames exist on the
    # wire — the only residue is one env read at process start. Workers
    # and clients read the RAY_TPU_TORCH_PROFILE_HZ env directly (like
    # chaos_plan: they never run reload()).
    "profile_hz": 0.0,
    "profile_overhead_budget": 0.03,     # self-overhead ratio past which
                                         # the sampler halves its rate
                                         # (auto-clamp; 0 = never clamp)
    "profile_flush_period_s": 1.0,       # local fold -> hub batch cadence
    "profile_store_max": 4096,           # hub cap on distinct folded
                                         # stacks kept per process
    "node_heartbeat_period_s": 2.0,      # per-node gauge cadence; 0 = off
    "flight_recorder_path": "",          # "" = <session_dir>/flight_recorder.json
    # fault tolerance (reference: num_heartbeats_timeout in
    # ray_config_def.h — the GCS declares a raylet dead after N missed
    # heartbeats; here the threshold counts node_heartbeat_period_s
    # periods, so 15 * 2s = 30s matches the reference default)
    "node_heartbeat_miss_threshold": 15,  # missed periods -> node death; 0 = off
    # hung-worker watchdog: every dispatched task gets this execute
    # deadline unless it carries its own options(timeout_s=...); past
    # it the worker is SIGKILLed and the task retries per its budget
    # (a SIGSTOP'd/hung worker never EOFs on its own). 0 = off.
    "task_timeout_default_s": 0.0,
    # fault injection: documents RAY_TPU_TORCH_CHAOS_PLAN (chaos.py grammar;
    # RAY_TPU_TORCH_CHAOS_DROP / RAY_TPU_TORCH_CHAOS_OBJECT_AGENT stay as legacy
    # aliases). chaos.py reads the ENV directly, not this snapshot:
    # engines are built in worker/agent/client processes that never
    # run reload(), and a plan baked into a stale snapshot would
    # resurrect faults after the env was cleared.
    "chaos_plan": "",
}


class _Config:
    def __init__(self):
        self._values: Dict[str, Any] = {}
        for key, default in _DEFAULTS.items():
            env = os.environ.get(f"RAY_TPU_TORCH_{key.upper()}")
            if env is None:
                self._values[key] = default
            else:
                self._values[key] = self._parse(env, default)

    @staticmethod
    def _parse(raw: str, default: Any) -> Any:
        if isinstance(default, bool):
            return raw.lower() in ("1", "true", "yes")
        if isinstance(default, int):
            return int(float(raw))
        if isinstance(default, float):
            return float(raw)
        return raw

    def __getattr__(self, key: str) -> Any:
        try:
            return self._values[key]
        except KeyError:
            raise AttributeError(key) from None

    def get(self, key: str, default: Any = None) -> Any:
        return self._values.get(key, default)

    def set(self, key: str, value: Any) -> None:
        """Test/driver override (before the consuming subsystem starts)."""
        self._values[key] = value

    def snapshot(self) -> Dict[str, Any]:
        return dict(self._values)


RAY_TPU_TORCH_CONFIG = _Config()


def reload() -> None:
    """Re-read env overrides (a new Hub calls this so per-test env
    changes take effect without a fresh interpreter)."""
    global RAY_TPU_TORCH_CONFIG
    RAY_TPU_TORCH_CONFIG = _Config()
