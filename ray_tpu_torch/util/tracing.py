"""Distributed tracing: user spans AND the runtime's own spans.

Parity: python/ray/util/tracing/ — the reference hooks opentelemetry
spans around every API call and propagates the otel context in task
metadata. Here spans are framework-native and come in two layers:

**User spans** (this module's public API): a contextvar carries
(trace_id, span_id) for nesting, finished spans batch to the hub over
the client's existing connection, and they render in the same
chrome-trace ``timeline()`` as task events (cat="span").

    from ray_tpu_torch.util import tracing

    tracing.enable()
    with tracing.span("preprocess", rows=1000):
        ...
    ctx = tracing.current_context()      # ship to another process
    # in a task:  with tracing.context(ctx), tracing.span("stage2"): ...

**In the profiler's trace**: while a ``torch.profiler`` records, every
span, with tracing on or off, is also a ``record_function`` range: a
``user_annotation`` in the Chrome trace, on the clock of the kernels
launched inside it. The train step (``parallel/train_step.py``) and the
Llama block (``models/llama.py``) open such spans.

**Runtime spans**: with head sampling on (``RAY_TPU_TORCH_TRACE_SAMPLE=0..1``,
or ``RAY_TPU_TORCH_TRACING=1`` which forces 1.0), the runtime traces itself —
trace context rides SUBMIT/actor-call/GET/PUT/object-transfer messages
and every stage emits a span (client encode+send, shard ring wait,
scheduler admit/queue/spawn, worker arg-fetch/execute/result-store,
readiness push, result return), stitched into one trace per task chain.
Traces are queryable via ``list_state("traces")`` /
``ray_tpu trace <id>`` / dashboard ``GET /api/traces`` and fed through
:func:`analyze_trace`, the critical-path analyzer that names the
dominant stage. The default sample rate is 0: no context rides the
wire and no runtime span is ever built.

Clock discipline (graftlint GL008, which covers this file): span
start/end are positioned in wall time for cross-process stitching, but
every DURATION comes from ``time.monotonic()`` — each process anchors
its monotonic clock to wall time exactly once at import
(``_MONO_ANCHOR``/``_WALL_ANCHOR``) and renders a monotonic stamp as
``wall_anchor + (mono - mono_anchor)``, so an NTP step mid-span can
never produce a negative or inflated duration.
"""

from __future__ import annotations

import contextlib
import contextvars
import os
import sys
import time
from typing import Any, Dict, List, Optional, Tuple

# one wall anchor per process: all span timestamps are monotonic stamps
# re-based onto this anchor (same-host processes share the wall clock,
# so cross-process spans land on one coherent timeline)
_MONO_ANCHOR = time.monotonic()
_WALL_ANCHOR = time.time()

_enabled = os.environ.get("RAY_TPU_TORCH_TRACING", "") in ("1", "true", "yes")
# (trace_id, span_id) of the innermost open span — user spans AND the
# runtime's execute span share this, so nested submits from inside a
# traced task inherit the trace and user spans parent under it
_ctx: contextvars.ContextVar[Optional[Tuple[str, str]]] = contextvars.ContextVar(
    "ray_tpu_trace_ctx", default=None
)


def wall_at(mono: float) -> float:
    """Render a time.monotonic() stamp as an anchored wall timestamp."""
    return _WALL_ANCHOR + (mono - _MONO_ANCHOR)


def new_span_id() -> str:
    """16-hex-char span/trace id from the per-thread entropy pool
    (_private/ids.py) — span open is a hot path under sampling, and a
    uuid4() per span costs an os.urandom syscall each."""
    from ray_tpu_torch._private.ids import span_id_hex

    return span_id_hex()


def runtime_sample_rate() -> float:
    """Head-sampling probability for RUNTIME spans. RAY_TPU_TORCH_TRACING=1
    forces 1.0; otherwise RAY_TPU_TORCH_TRACE_SAMPLE in [0, 1]; default 0
    keeps the hot path free of any tracing work."""
    if os.environ.get("RAY_TPU_TORCH_TRACING", "") in ("1", "true", "yes"):
        return 1.0
    raw = os.environ.get("RAY_TPU_TORCH_TRACE_SAMPLE", "")
    if not raw:
        return 0.0
    try:
        rate = float(raw)
    except ValueError:
        return 0.0
    return min(1.0, max(0.0, rate))


def enable() -> None:
    global _enabled
    _enabled = True


def disable() -> None:
    global _enabled
    _enabled = False


def is_enabled() -> bool:
    return _enabled


def current_context() -> Optional[Tuple[str, str]]:
    """(trace_id, span_id) to hand to another process (the reference
    propagates the otel context in task metadata)."""
    return _ctx.get()


@contextlib.contextmanager
def context(ctx: Optional[Tuple[str, str]]):
    """Adopt a remote parent context for spans opened inside."""
    token = _ctx.set(tuple(ctx) if ctx else None)
    try:
        yield
    finally:
        _ctx.reset(token)


def push_context(ctx: Tuple[str, str]):
    """Non-contextmanager form for the runtime (worker execute scope):
    returns the reset token for pop_context."""
    return _ctx.set(tuple(ctx))


def pop_context(token) -> None:
    _ctx.reset(token)


def make_runtime_record(
    name: str,
    stage: str,
    trace_id: str,
    parent_id: Optional[str],
    t0_mono: float,
    t1_mono: float,
    span_id: Optional[str] = None,
    node_id: Optional[str] = None,
    attrs: Optional[Dict[str, Any]] = None,
    **extra: Any,
) -> Dict[str, Any]:
    """Build one runtime span record from monotonic stamps. The record
    schema matches user spans, plus attrs["stage"] — the key the
    critical-path analyzer groups by. Attributes whose keys collide
    with the positional params (e.g. "name") go through `attrs`."""
    a = {"stage": stage}
    for src in (attrs, extra):
        if src:
            for k, v in src.items():
                a[k] = str(v)
    return {
        "name": name,
        "trace_id": trace_id,
        "span_id": span_id or new_span_id(),
        "parent_id": parent_id,
        "start": wall_at(t0_mono),
        "end": wall_at(t1_mono),
        "pid": os.getpid(),
        "node_id": node_id or os.environ.get("RAY_TPU_TORCH_NODE_ID", "head"),
        "attrs": a,
    }


def _emit(record: Dict[str, Any]) -> None:
    from ray_tpu_torch._private import protocol as P
    from ray_tpu_torch._private import worker

    if not worker.is_initialized():
        return
    try:
        worker.get_client().send_async(P.SPAN_RECORD, record)
    except Exception:
        pass  # tracing must never take down the traced code


def _profiler():
    """``torch.autograd.profiler`` while a torch profiler records, else
    None. torch is looked up in ``sys.modules``, never imported here."""
    prof = sys.modules.get("torch.autograd.profiler")
    return prof if prof is not None and prof._is_profiler_enabled else None


@contextlib.contextmanager
def span(name: str, **attrs: Any):
    """Record a span around the block: a record for the hub while tracing
    is on, and a ``record_function`` range while a torch profiler records
    (a ``user_annotation`` in its trace, on the kernels' clock, on any
    thread the profiler follows). With neither, two flag checks and no
    record, clock or range."""
    prof = _profiler()
    if not _enabled:
        if prof is None:
            yield None
        else:
            with prof.record_function(name):
                yield None
        return
    parent = _ctx.get()
    trace_id = parent[0] if parent else new_span_id()
    span_id = new_span_id()
    token = _ctx.set((trace_id, span_id))
    start = time.monotonic()
    error: Optional[str] = None
    try:
        with prof.record_function(name) if prof is not None else contextlib.nullcontext():
            yield (trace_id, span_id)
    except BaseException as exc:
        error = type(exc).__name__
        raise
    finally:
        _ctx.reset(token)
        end = time.monotonic()
        record = {
            "name": name,
            "trace_id": trace_id,
            "span_id": span_id,
            "parent_id": parent[1] if parent else None,
            "start": wall_at(start),
            "end": wall_at(end),
            "pid": os.getpid(),
            "node_id": os.environ.get("RAY_TPU_TORCH_NODE_ID", "head"),
            "attrs": {k: str(v) for k, v in attrs.items()},
        }
        if error is not None:
            record["attrs"]["error"] = error
        _emit(record)


def traced(name: Optional[str] = None):
    """Decorator form: ``@tracing.traced()`` wraps calls in a span."""

    def wrap(fn):
        import functools
        import inspect

        span_name = name or getattr(fn, "__qualname__", fn.__name__)

        if inspect.iscoroutinefunction(fn):
            # the span must cover the awaited body, not the instant
            # coroutine construction — and the context must be live
            # while the body executes so child spans parent correctly
            @functools.wraps(fn)
            async def ainner(*args, **kwargs):
                with span(span_name):
                    return await fn(*args, **kwargs)

            return ainner

        @functools.wraps(fn)
        def inner(*args, **kwargs):
            with span(span_name):
                return fn(*args, **kwargs)

        return inner

    return wrap


# --------------------------------------------------- critical-path analysis
# Stage catalog: every runtime span carries attrs["stage"] drawn from
# this set. Precedence resolves overlap — when two stages cover the same
# instant (a worker spawn inside the queue wait; client.submit
# overlapping the hub's admit), the timeline slice is charged to the
# HIGHER-precedence (more specific) stage, so per-stage durations
# partition the trace instead of double-counting.
STAGE_PRECEDENCE: Dict[str, int] = {
    "submit": 10,        # client: encode + hand the SUBMIT to the wire
    "ring_wait": 40,     # sharded hub: decoded frame parked on the SPSC ring
    "admit": 50,         # hub: dep registration + quota admission
    "queue_wait": 20,    # hub: runnable-queue wait, admit -> dispatch
    "spawn": 30,         # hub: worker process spawn inside the queue wait
    "arg_fetch": 60,     # worker: decode + dependency resolution
    "execute": 60,       # worker: the user function body
    "result_store": 60,  # worker: encode + store returns
    "complete": 50,      # hub: TASK_DONE handling
    "ready_push": 55,    # hub: readiness push to subscribed waiters
    "result_return": 15, # client: tail of get() after the hub finished
    "transfer": 45,      # object plane: segment fetch (direct or relay)
    "put": 35,           # put path (client encode/stream + hub handler)
    "get": 35,           # hub GET handler
    # ---- serve data plane (serve/_private/observability.py). The serve
    # spans ENVELOP the task-layer spans of the underlying actor call,
    # so precedence places them around the existing catalog instead of
    # double-counting it: serve.queue_wait sits BELOW every task stage
    # (it spans enqueue -> replica start, and must only be charged the
    # genuinely-waiting slices no narrower stage covers), serve.execute
    # sits ABOVE worker execute (the replica's request handling IS the
    # user body there), and batch-wait/multiplex-swap sit above
    # serve.execute so time parked inside the handler is named for what
    # it actually was. dominant_stage then answers the serving question
    # directly: router vs queue vs batch-wait vs execute.
    "serve.queue_wait": 5,       # enqueue -> replica start, uncovered gap
    "serve.proxy_recv": 22,      # ingress: recv + parse + route match
    "serve.response_return": 24, # ingress: response encode + write
    "serve.route": 25,           # handle: replica wait + pick + dispatch
    "serve.execute": 70,         # replica: the user callable
    "serve.batch_wait": 75,      # @serve.batch: parked awaiting a batch
    "serve.multiplex_swap": 78,  # multiplex: LRU-miss model load
    # zero-copy payload plane (serve/_private/payloads.py):
    # payload_put wraps the handle-side spill (put_value of the raw
    # body) — above put=35 so the slice names the serve intent, below
    # ring/transfer so genuine object-plane work keeps its name;
    # payload_fetch wraps the replica-side bulk resolve — above
    # serve.execute=70 (it happens inside the handler envelope and is
    # I/O, not user code), below batch_wait so parked members still
    # charge their park correctly.
    "serve.payload_put": 38,     # handle: spill request body to object plane
    "serve.payload_fetch": 72,   # replica: bulk-resolve payload refs
    # ---- Podracer RL loops (rllib/podracer). These are user-level
    # spans emitted inside the actor/learner task bodies, so they sit
    # ABOVE worker execute (60): within a Podracer task the RL phase is
    # the more specific name for the slice. env_step (the acting scan)
    # vs learner_update (the SGD step) is the question analyze_trace
    # answers — actor-bound or learner-bound. traj_handoff (learner-
    # side ingestion of handed-off fragments) and param_sync (actor-
    # side KV fetch / learner-side KV publish) name the cross-slice
    # coupling costs; they sit above env_step/learner_update because
    # both occur as narrower phases inside the same task bodies and
    # must not be double-charged to the enclosing RL phase.
    "podracer.env_step": 71,
    "podracer.learner_update": 71,
    "podracer.traj_handoff": 74,
    "podracer.param_sync": 74,
}


def _stage_of(s: Dict[str, Any]) -> Optional[str]:
    return (s.get("attrs") or {}).get("stage")


def analyze_trace(spans: List[Dict[str, Any]]) -> Dict[str, Any]:
    """Critical-path breakdown of one trace: which stage did the time
    go to? Overlapping stage spans are resolved by STAGE_PRECEDENCE
    (each instant charged to exactly one stage), ``result_return`` is
    recomputed as the tail of the enveloping client get span past the
    last runtime stage, and whatever no span covers is reported as
    ``untracked_s`` — stages + untracked always sum to end_to_end_s.

    The input is whatever the hub retained — a trace truncated by
    eviction or a crashing process can contain orphan spans (parent_id
    never recorded; irrelevant here, the sweep does not walk parents),
    spans missing or corrupting their start/end stamps, and
    zero-duration stages. Malformed spans are dropped (counted in
    ``malformed_spans``) and the analysis proceeds on the rest — a
    partial report, never an exception."""
    raw = spans

    def _ok(s: Any) -> bool:
        if not isinstance(s, dict):
            return False
        a, b = s.get("start"), s.get("end")
        return (
            isinstance(a, (int, float)) and isinstance(b, (int, float))
            and not isinstance(a, bool) and not isinstance(b, bool)
            and b >= a
        )

    spans = [s for s in raw if _ok(s)]
    if not spans:
        return {"trace_id": None, "n_spans": len(raw), "end_to_end_s": 0.0,
                "stages": {}, "dominant_stage": None, "untracked_s": 0.0,
                "processes": [], "malformed_spans": len(raw)}
    t_start = min(s["start"] for s in spans)
    t_end = max(s["end"] for s in spans)
    e2e = max(0.0, t_end - t_start)
    intervals: List[Tuple[float, float, str]] = []
    tails: List[Tuple[float, float]] = []  # result_return envelopes
    last_stage_end = t_start
    for s in spans:
        stage = _stage_of(s)
        if stage is None:
            continue  # user span: positions in the trace, not a stage
        if stage == "result_return":
            # client.get envelops the whole wait; only its tail past
            # the last runtime stage is genuinely "returning the result"
            tails.append((s["start"], s["end"]))
            continue
        intervals.append((s["start"], s["end"], stage))
        last_stage_end = max(last_stage_end, s["end"])
    if tails:
        # clamp to the LATEST get span's own start too: a get() issued
        # long after the task finished must not book the driver's idle
        # time between completion and the call as result_return
        tail_start, tail_end = max(tails, key=lambda se: se[1])
        tail_start = max(tail_start, last_stage_end)
        if tail_end > tail_start:
            intervals.append((tail_start, tail_end, "result_return"))
    # sweep line: charge each elementary slice to the highest-precedence
    # active stage
    stages: Dict[str, float] = {}
    covered = 0.0
    if intervals:
        edges = sorted({t for iv in intervals for t in iv[:2]})
        for lo, hi in zip(edges, edges[1:]):
            if hi <= lo:
                continue
            active = [st for (a, b, st) in intervals if a <= lo and b >= hi]
            if not active:
                continue
            winner = max(active, key=lambda st: STAGE_PRECEDENCE.get(st, 0))
            stages[winner] = stages.get(winner, 0.0) + (hi - lo)
            covered += hi - lo
    dominant = max(stages, key=stages.get) if stages else None
    return {
        "trace_id": spans[0].get("trace_id"),
        "n_spans": len(raw),
        "malformed_spans": len(raw) - len(spans),
        "end_to_end_s": e2e,
        "stages": {
            st: {"dur_s": dur, "share": (dur / e2e) if e2e > 0 else 0.0}
            for st, dur in sorted(
                stages.items(), key=lambda kv: -kv[1]
            )
        },
        "dominant_stage": dominant,
        "untracked_s": max(0.0, e2e - covered),
        "processes": sorted(
            {f"{s.get('node_id', '?')}/pid={s.get('pid', '?')}"
             for s in spans}
        ),
    }


__all__ = [
    "enable",
    "disable",
    "is_enabled",
    "span",
    "traced",
    "current_context",
    "context",
    "push_context",
    "pop_context",
    "new_span_id",
    "runtime_sample_rate",
    "make_runtime_record",
    "wall_at",
    "analyze_trace",
    "STAGE_PRECEDENCE",
]
