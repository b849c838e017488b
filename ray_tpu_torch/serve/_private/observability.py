"""Serve-plane observability: request spans + per-route SLO metrics.

Parity: python/ray/serve/_private/metrics_utils.py + the request-context
propagation in serve/_private/replica.py — the reference stamps every
request with a RequestContext and exports per-deployment counters and
latency histograms through the metrics agent. Here both halves ride the
runtime's EXISTING planes (no new message types):

**Spans** extend the runtime-trace catalog into the request path —
``serve.proxy_recv`` -> ``serve.route`` -> (task-layer submit/execute
spans) -> ``serve.queue_wait`` -> ``serve.execute`` (with
``serve.batch_wait`` / ``serve.multiplex_swap`` nested inside) ->
``serve.response_return``. Sampling is the same head gate as every
other runtime span (``RAY_TPU_TORCH_TRACE_SAMPLE`` / ``RAY_TPU_TORCH_TRACING``,
default 0 = no work at all), the trace context crosses the
proxy->replica hop inside the ordinary actor-call payload, and finished
spans ship as the existing ``SPAN_RECORD`` message.

**Metrics** are ordinary ``METRIC_RECORD`` series tagged
``(deployment, route)`` aggregating in the hub registry, so they land
in ``snapshot()`` / ``prometheus_text()`` / the dashboard for free and
the hub's ``list_state("serve")`` branch can pivot them into one row
per deployment.

Every emitter here is fire-and-forget and exception-proof: serving must
never fail because observability did.
"""

from __future__ import annotations

import time
from typing import Any, Dict, Optional, Tuple

from ..._private import protocol as P
from ...util import tracing as _tracing

# Latency boundaries sized for serving (sub-ms cache hits through
# multi-second LLM generations). Shared by every serve latency series so
# the hub can merge per-route histograms bucket-by-bucket.
LATENCY_BOUNDS: Tuple[float, ...] = (
    0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
    0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0,
)
# Batch occupancy (actual/max batch size) in (0, 1].
BATCH_RATIO_BOUNDS: Tuple[float, ...] = (
    0.125, 0.25, 0.375, 0.5, 0.625, 0.75, 0.875, 1.0,
)

REQUESTS_TOTAL = "ray_tpu_torch_serve_requests_total"
LATENCY_HIST = "ray_tpu_torch_serve_request_latency_seconds"
ERRORS_TOTAL = "ray_tpu_torch_serve_errors_total"
TIMEOUTS_TOTAL = "ray_tpu_torch_serve_timeouts_total"
ONGOING_GAUGE = "ray_tpu_torch_serve_ongoing_requests"
QUEUE_DEPTH_GAUGE = "ray_tpu_torch_serve_queue_depth"
REPLICA_GAUGE = "ray_tpu_torch_serve_replicas"
BATCH_SIZE_HIST = "ray_tpu_torch_serve_batch_size"
BATCH_RATIO_HIST = "ray_tpu_torch_serve_batch_ratio"
MODEL_SWAPS_TOTAL = "ray_tpu_torch_serve_model_swaps_total"
DRAINED_TOTAL = "ray_tpu_torch_serve_drained_requests_total"
DROPPED_TOTAL = "ray_tpu_torch_serve_dropped_requests_total"
SHED_TOTAL = "ray_tpu_torch_serve_shed_total"
EXPIRED_TOTAL = "ray_tpu_torch_serve_expired_requests_total"
EJECTIONS_TOTAL = "ray_tpu_torch_serve_ejections_total"

# The deployment this replica process hosts (set by Replica.__init__):
# lets @serve.batch queues — which only see the bound user function —
# tag their metrics without threading the name through the decorator.
_current_deployment: str = ""


def set_current_deployment(name: str) -> None:
    global _current_deployment
    _current_deployment = name


def current_deployment() -> str:
    return _current_deployment


def _client():
    from ..._private import worker

    if not worker.is_initialized():
        return None
    try:
        return worker.get_client()
    except Exception:
        return None


# ------------------------------------------------------------------ spans
def sampling_live() -> bool:
    """One cheap gate for the serve hot path: an ambient trace context
    (this request is already traced) or this process head-samples."""
    if _tracing.current_context() is not None:
        return True
    client = _client()
    return client is not None and client._trace_on


def begin_trace() -> Optional[Tuple[str, Optional[str]]]:
    """(trace_id, parent_span_id) for one serve request, or None when
    unsampled. Inherits the ambient context (a traced caller — e.g. a
    composed deployment calling a child handle) before head-sampling a
    fresh trace, mirroring CoreClient._trace_begin."""
    ctx = _tracing.current_context()
    if ctx is not None:
        return ctx
    client = _client()
    if client is None or not client._trace_on:
        return None
    import random

    r = client._trace_rate
    if r >= 1.0 or random.random() < r:
        return (_tracing.new_span_id(), None)
    return None


def emit_span(
    name: str,
    stage: str,
    trace_id: str,
    parent_id: Optional[str],
    t0_mono: float,
    t1_mono: float,
    span_id: Optional[str] = None,
    **attrs: Any,
) -> Optional[str]:
    """Ship one finished serve span on the existing SPAN_RECORD path.
    Returns the span id (so callers can parent further spans), or None
    when no client is connected. Record built inline — same fast shape
    as CoreClient._trace_emit, no intermediate attr-dict copies."""
    client = _client()
    if client is None:
        return None
    a: Dict[str, str] = {"stage": stage}
    for k, v in attrs.items():
        a[k] = str(v)
    sid = span_id or _tracing.new_span_id()
    rec = {
        "name": name,
        "trace_id": trace_id,
        "span_id": sid,
        "parent_id": parent_id,
        "start": _tracing.wall_at(t0_mono),
        "end": _tracing.wall_at(t1_mono),
        "pid": client._pid,
        "node_id": client.node_id,
        "attrs": a,
    }
    try:
        client.send_async(P.SPAN_RECORD, rec)
    except Exception:
        pass
    return sid


def mono_at_wall(wall: float, now_mono: Optional[float] = None) -> float:
    """Invert tracing.wall_at for a wall stamp taken in ANOTHER process
    on the same host: the monotonic instant (in THIS process's clock)
    that renders to that wall time. Lets the replica open its
    serve.queue_wait span at the handle's enqueue moment."""
    now = time.monotonic() if now_mono is None else now_mono
    return now - max(0.0, _tracing.wall_at(now) - wall)


# ----------------------------------------------------------------- metrics
def _record(name: str, mtype: str, value: float, op: str,
            tags: Tuple[Tuple[str, str], ...],
            boundaries: Tuple[float, ...] = (),
            description: str = "") -> None:
    client = _client()
    if client is None:
        return
    payload = {
        "name": name,
        "type": mtype,
        "description": description,
        "value": float(value),
        "tags": tags,
        "op": op,
    }
    if boundaries:
        payload["boundaries"] = boundaries
    try:
        client.send_async(P.METRIC_RECORD, payload)
    except Exception:
        pass


def _tags(deployment: str, route: str = "") -> Tuple[Tuple[str, str], ...]:
    # sorted tuple-of-pairs, matching util/metrics.Metric._record so the
    # hub registry keys line up regardless of which path recorded first
    return (("deployment", deployment), ("route", route))


def count_request(deployment: str, route: str = "") -> None:
    _record(REQUESTS_TOTAL, "counter", 1.0, "add", _tags(deployment, route),
            description="serve requests routed")


def observe_latency(deployment: str, route: str, seconds: float) -> None:
    _record(LATENCY_HIST, "histogram", seconds, "observe",
            _tags(deployment, route), boundaries=LATENCY_BOUNDS,
            description="serve end-to-end request latency")


def count_error(deployment: str, route: str = "") -> None:
    _record(ERRORS_TOTAL, "counter", 1.0, "add", _tags(deployment, route),
            description="serve requests failed")


def count_timeout(deployment: str, route: str = "") -> None:
    _record(TIMEOUTS_TOTAL, "counter", 1.0, "add", _tags(deployment, route),
            description="serve requests timed out")


def observe_batch(deployment: str, batch_size: int, max_batch_size: int) -> None:
    """One executed batch: absolute size + occupancy ratio. Efficiency
    (= mean actual/max) is the ratio histogram's sum/count."""
    t = _tags(deployment)
    _record(BATCH_SIZE_HIST, "histogram", float(batch_size), "observe", t,
            boundaries=(1.0, 2.0, 4.0, 8.0, 16.0, 32.0, 64.0, 128.0),
            description="serve batch sizes")
    _record(BATCH_RATIO_HIST, "histogram",
            batch_size / float(max_batch_size or 1), "observe", t,
            boundaries=BATCH_RATIO_BOUNDS,
            description="serve batch occupancy (actual/max batch size)")


def count_model_swap(deployment: str) -> None:
    _record(MODEL_SWAPS_TOTAL, "counter", 1.0, "add", _tags(deployment),
            description="multiplexed model loads (LRU misses)")


def set_deployment_gauges(deployment: str, ongoing: int, queued: int,
                          replicas: int) -> None:
    """Controller-side, once per reconcile: live load per deployment."""
    t = _tags(deployment)
    _record(ONGOING_GAUGE, "gauge", float(ongoing), "set", t,
            description="requests executing across replicas")
    _record(QUEUE_DEPTH_GAUGE, "gauge", float(queued), "set", t,
            description="requests parked in replica batch queues")
    _record(REPLICA_GAUGE, "gauge", float(replicas), "set", t,
            description="live replicas")


def count_drained(deployment: str, n: int) -> None:
    if n > 0:
        _record(DRAINED_TOTAL, "counter", float(n), "add", _tags(deployment),
                description="in-flight requests drained before replica teardown")


def count_dropped(deployment: str, n: int) -> None:
    if n > 0:
        _record(DROPPED_TOTAL, "counter", float(n), "add", _tags(deployment),
                description="in-flight requests dropped at replica teardown")


# Shed / expired / ejected are DISJOINT from drained / dropped by
# construction: a shed request never reaches a replica (refused at
# admission), an expired one is dropped before its user callable runs,
# and both are also disjoint from each other — the router sheds before
# it stamps a deadline. Drain accounting at teardown therefore only
# ever sees admitted, unexpired in-flight work.
def count_shed(deployment: str, route: str = "") -> None:
    _record(SHED_TOTAL, "counter", 1.0, "add", _tags(deployment, route),
            description="requests shed at admission (max_queued_requests)")


def count_expired(deployment: str, route: str = "") -> None:
    _record(EXPIRED_TOTAL, "counter", 1.0, "add", _tags(deployment, route),
            description="requests whose deadline passed before execute")


def count_ejection(deployment: str) -> None:
    _record(EJECTIONS_TOTAL, "counter", 1.0, "add", _tags(deployment),
            description="replicas ejected from the router after "
                        "consecutive failures")
