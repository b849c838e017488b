"""State API: list + summarize cluster entities.

Parity: python/ray/util/state/api.py (:784 list_*, :1359-1425
summarize_*) over the hub's live tables instead of a dashboard
aggregator head.
"""

from __future__ import annotations

from collections import Counter
from typing import Any, Dict, List, Optional


def _client():
    from ray_tpu_torch._private import worker

    return worker.get_client()


def list_actors(filters: Optional[list] = None) -> List[dict]:
    return _apply_filters(_client().list_state("actors"), filters)

def list_tasks(filters: Optional[list] = None) -> List[dict]:
    return _apply_filters(_client().list_state("tasks"), filters)

def list_workers(filters: Optional[list] = None) -> List[dict]:
    return _apply_filters(_client().list_state("workers"), filters)

def list_nodes(filters: Optional[list] = None) -> List[dict]:
    return _apply_filters(_client().list_state("nodes"), filters)

def list_objects(filters: Optional[list] = None) -> List[dict]:
    return _apply_filters(_client().list_state("objects"), filters)

def list_placement_groups(filters: Optional[list] = None) -> List[dict]:
    return _apply_filters(_client().list_state("placement_groups"), filters)

def list_events(filters: Optional[list] = None) -> List[dict]:
    """Flight-recorder runtime events (node up/down, worker exits,
    retries, spills, ...) — the hub's bounded post-mortem log."""
    return _apply_filters(_client().list_state("events"), filters)

def list_jobs(filters: Optional[list] = None) -> List[dict]:
    """Registered scheduler jobs (fairsched): tenant, priority, quota,
    submit/dispatch/preemption counters. Distinct from the entrypoint
    job table (job_submission.JobSubmissionClient.list_jobs)."""
    return _apply_filters(_client().list_state("jobs"), filters)

def list_shards(filters: Optional[list] = None) -> List[dict]:
    """Control-plane topology: one row per reactor shard (conns,
    wakeups, frames sent) plus one per state service (messages
    processed). A single-reactor hub reports its one implicit shard
    (hub_shards.py; RAY_TPU_TORCH_HUB_SHARDS)."""
    return _apply_filters(_client().list_state("shards"), filters)


def list_tenants(filters: Optional[list] = None) -> List[dict]:
    """Per-tenant scheduling accounting: quota vs admitted usage,
    fair-share clock, share of running work, pending_quota depth."""
    return _apply_filters(_client().list_state("tenants"), filters)


def list_chaos(filters: Optional[list] = None) -> List[dict]:
    """Fault-injection plane (chaos.py): the active RAY_TPU_TORCH_CHAOS_PLAN
    with per-fault trigger counts (first row, present only when a plan
    is set), then recent fault events from the flight recorder —
    chaos_* kinds, plus the recovery events task_timeout and
    node_heartbeat_miss, which appear whether or not the fault was
    injected (a real hang or partition lands here too)."""
    return _apply_filters(_client().list_state("chaos"), filters)


def list_traces(filters: Optional[list] = None) -> List[dict]:
    """Sampled distributed traces (util/tracing.py runtime spans): one
    summary row per trace_id — span count, start, duration, root span
    name, number of distinct processes. Use get_trace() for spans."""
    return _apply_filters(_client().list_state("traces"), filters)


def list_serve(filters: Optional[list] = None) -> List[dict]:
    """Serve-plane SLO rows: one per (deployment, route) pivoted from
    the builtin metric registry — request/error/timeout counters,
    latency + batch histograms ({sum, count, buckets}), live load
    gauges. summarize_serve() turns these into percentiles."""
    return _apply_filters(_client().list_state("serve"), filters)


def list_profile(filters: Optional[list] = None) -> List[dict]:
    """Folded profiler samples aggregated at the hub (profiling.py):
    one row per distinct (pid, process kind, thread domain, stage,
    task, collapsed stack) with its sample count, plus one meta row per
    reporting process (proc=True: kind, hz, self-overhead ratio).
    Empty unless RAY_TPU_TORCH_PROFILE_HZ > 0 somewhere in the cluster."""
    return _apply_filters(_client().list_state("profile"), filters)


def get_trace(trace_id: str) -> List[dict]:
    """All recorded spans of one trace, raw (feed these through
    ray_tpu_torch.util.tracing.analyze_trace for the critical-path view)."""
    return _client().list_state("traces", trace_id=trace_id)


def summarize_trace(trace_id: str) -> Dict[str, Any]:
    """Critical-path breakdown of one trace: per-stage durations,
    dominant stage, untracked remainder (util/tracing.analyze_trace)."""
    from ray_tpu_torch.util.tracing import analyze_trace

    return analyze_trace(get_trace(trace_id))


def _apply_filters(items: List[dict], filters: Optional[list]) -> List[dict]:
    """filters: [(key, "=" | "!=", value), ...] (reference filter shape)."""
    if not filters:
        return items
    out = []
    for item in items:
        ok = True
        for key, op, value in filters:
            got = item.get(key)
            if op == "=" and got != value:
                ok = False
            elif op == "!=" and got == value:
                ok = False
        if ok:
            out.append(item)
    return out


def _percentiles(values: List[float]) -> Optional[Dict[str, float]]:
    """Nearest-rank p50/p95/p99 — small-n friendly, no numpy needed."""
    if not values:
        return None
    vs = sorted(values)

    def rank(p: float) -> float:
        return vs[min(len(vs) - 1, int(round(p / 100.0 * (len(vs) - 1))))]

    return {"p50": rank(50), "p95": rank(95), "p99": rank(99),
            "max": vs[-1], "count": len(vs)}


def summarize_tasks() -> Dict[str, Any]:
    """Counts by state and by function, plus the lifecycle latency
    breakdown (reference: summarize_tasks): queue-wait is submit ->
    dispatch-to-worker, run-time is dispatch -> done, both computed
    from the hub's monotonic t_* stamps."""
    events = _client().list_state("tasks")
    by_state = Counter(e.get("state", "UNKNOWN") for e in events)
    by_func: Dict[str, Counter] = {}
    queue_waits: List[float] = []
    run_times: List[float] = []
    for e in events:
        name = (e.get("name") or "unknown").split(":")[0]
        by_func.setdefault(name, Counter())[e.get("state", "UNKNOWN")] += 1
        # queue wait starts at the LATEST queue entry (retries re-stamp
        # t_queued; actor calls have no queued phase and fall back to
        # t_submit) so the breakdown reflects the final attempt
        t0 = e.get("t_queued") or e.get("t_submit")
        t_sched, t_fin = e.get("t_scheduled"), e.get("t_finished")
        if t0 is not None and t_sched is not None:
            queue_waits.append(max(0.0, t_sched - t0))
        if t_sched is not None and t_fin is not None:
            run_times.append(max(0.0, t_fin - t_sched))
    return {
        "total": len(events),
        "by_state": dict(by_state),
        "by_func_name": {k: dict(v) for k, v in by_func.items()},
        "queue_wait_s": _percentiles(queue_waits),
        "run_time_s": _percentiles(run_times),
    }


def _hist_percentile(buckets: List[list], count: int, p: float) -> Optional[float]:
    """Percentile estimate from histogram buckets: the upper bound of
    the bucket where the cumulative count crosses p% of observations
    (Prometheus histogram_quantile style, upper-bound conservative).
    Observations above the largest boundary report that boundary."""
    if not count or not buckets:
        return None
    target = p / 100.0 * count
    cum = 0
    for bound, c in buckets:
        cum += c
        if cum >= target:
            return bound
    return buckets[-1][0]


def summarize_serve() -> Dict[str, Any]:
    """Per-deployment serve SLO summary: request/error/timeout counts
    and latency p50/p95/p99 per route (estimated from histogram
    buckets), live load gauges (ongoing/queued/replicas), drain-vs-drop
    teardown counters, and batch efficiency (mean actual/max batch
    size, 1.0 = every batch full)."""
    deployments: Dict[str, Any] = {}
    for row in list_serve():
        dep = deployments.setdefault(row["deployment"], {
            "requests": 0, "errors": 0, "timeouts": 0,
            "ongoing": 0, "queued": 0, "replicas": 0,
            "drained": 0, "dropped": 0, "model_swaps": 0,
            "shed": 0, "expired": 0, "ejections": 0,
            "batch_efficiency": None,
            "routes": {},
        })
        rstats: Dict[str, Any] = {
            "requests": int(row.get("requests_total", 0)),
            "errors": int(row.get("errors_total", 0)),
            "timeouts": int(row.get("timeouts_total", 0)),
            "latency_s": None,
        }
        lat = row.get("request_latency_seconds")
        if lat and lat["count"]:
            rstats["latency_s"] = {
                "p50": _hist_percentile(lat["buckets"], lat["count"], 50),
                "p95": _hist_percentile(lat["buckets"], lat["count"], 95),
                "p99": _hist_percentile(lat["buckets"], lat["count"], 99),
                "mean": lat["sum"] / lat["count"],
                "count": lat["count"],
            }
        dep["routes"][row["route"]] = rstats
        dep["requests"] += rstats["requests"]
        dep["errors"] += rstats["errors"]
        dep["timeouts"] += rstats["timeouts"]
        # per-deployment series (gauges, batch + teardown counters) are
        # recorded without a route tag and so ride the route="" row
        if "ongoing_requests" in row:
            dep["ongoing"] = int(row["ongoing_requests"])
        if "queue_depth" in row:
            dep["queued"] = int(row["queue_depth"])
        if "replicas" in row:
            dep["replicas"] = int(row["replicas"])
        dep["drained"] += int(row.get("drained_requests_total", 0))
        dep["dropped"] += int(row.get("dropped_requests_total", 0))
        dep["model_swaps"] += int(row.get("model_swaps_total", 0))
        # overload/resilience counters: shed (admission refusals) and
        # expired (deadline drops) are disjoint from drained/dropped —
        # shed requests were never admitted, expired ones never ran
        dep["shed"] += int(row.get("shed_total", 0))
        dep["expired"] += int(row.get("expired_requests_total", 0))
        dep["ejections"] += int(row.get("ejections_total", 0))
        ratio = row.get("batch_ratio")
        if ratio and ratio["count"]:
            dep["batch_efficiency"] = ratio["sum"] / ratio["count"]
    return {"deployments": deployments}


def summarize_actors() -> Dict[str, Any]:
    actors = _client().list_state("actors")
    return {
        "total": len(actors),
        "by_state": dict(Counter(a["state"] for a in actors)),
    }


def leak_suspects(min_age_s: float = 60.0,
                  objects: Optional[List[dict]] = None) -> List[dict]:
    """Ready objects that look leaked: their owning process is gone
    (nothing can ever release the ref), no in-flight task pins them,
    and they have been alive at least min_age_s. Backs
    `ray_tpu_torch memory --leak-suspects`."""
    if objects is None:
        objects = _client().list_state("objects")
    return [
        o for o in objects
        if o.get("ready")
        and not o.get("owner_alive", True)
        and not o.get("pins", 0)
        and o.get("age_s", 0.0) >= min_age_s
    ]


def summarize_objects() -> Dict[str, Any]:
    objects = _client().list_state("objects")
    ready = [o for o in objects if o.get("ready")]
    by_owner: Dict[str, Dict[str, Any]] = {}
    for o in ready:
        ow = by_owner.setdefault(o.get("owner") or "?", {
            "count": 0, "size_bytes": 0,
        })
        ow["count"] += 1
        ow["size_bytes"] += o.get("size", 0)
    return {
        "total": len(objects),
        "ready": len(ready),
        "total_size_bytes": sum(o.get("size", 0) for o in ready),
        "spilled": sum(1 for o in ready if o.get("spilled")),
        "by_owner": by_owner,
        "leak_suspects": len(leak_suspects(objects=objects)),
    }
