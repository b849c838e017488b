"""DeploymentHandle: the caller-side router.

Parity: python/ray/serve/handle.py + _private/router.py:321 +
replica_scheduler/pow_2_scheduler.py:52 — requests route to the replica
with the shorter queue among two random choices (power of two choices),
tracked by caller-side outstanding counts and corrected by periodic
replica-list refresh. ``.remote()`` returns a DeploymentResponse future
(composable: passing a response as an argument chains on its result).
"""

from __future__ import annotations

import random
import threading
import time
from typing import Any, Dict, List, Optional

_REFRESH_PERIOD_S = 1.0

# serve-scope chaos engine (route_partition refresh blackhole), built
# once per routing process; None-cached when the plan is inert
_chaos_engine = None
_chaos_ready = False


def _serve_chaos():
    global _chaos_engine, _chaos_ready
    if not _chaos_ready:
        from .._private import chaos as chaos_mod

        _chaos_engine = chaos_mod.engine_for("serve")
        _chaos_ready = True
    return _chaos_engine


def _cfg():
    from .._private.config import RAY_TPU_TORCH_CONFIG

    return RAY_TPU_TORCH_CONFIG


def _rid(replica) -> bytes:
    """Stable identity of a replica actor across handle refreshes."""
    return replica._actor_id.binary()


class DeploymentResponse:
    """Future for one request (parity: serve.handle.DeploymentResponse).

    Holds the routing context so a request that landed on a replica torn
    down mid-flight (redeploy, scale-down, crash) is transparently
    re-routed — the reference's router likewise reschedules on replica
    death rather than surfacing ActorDiedError to the caller. The retry
    budget is bounded (``serve_retry_attempts``) with growing jittered
    backoff, and every blocking wait is capped by the request deadline.
    """

    def __init__(self, ref, handle=None, method=None, args=(), kwargs=None):
        self._ref = ref
        self._handle = handle
        self._method = method
        self._args = args
        self._kwargs = kwargs or {}
        # routed replica id (ejection accounting) + request deadline
        # (monotonic; every result()/await wait derives from it)
        self._rid: Optional[bytes] = None
        self._deadline_mono: Optional[float] = None
        # owned twin refs of payloads spilled onto the object plane for
        # this request (serve/_private/payloads.py). Living here — not
        # on the task ref — they survive _reroute's ref swap, and
        # ownership GC frees the segments when the caller drops the
        # response.
        self._payload_holds = None
        # SLO accounting (serve/_private/observability.py): routed-at
        # stamp for the latency histogram; recorded once, on the first
        # result()/await that settles the request
        self._t0 = time.monotonic()
        self._recorded = False

    def _record_outcome(self, error: Optional[str]) -> None:
        if self._recorded or self._handle is None:
            return
        self._recorded = True
        from ._private import observability as obs

        dep = self._handle.deployment_name
        route = getattr(self._handle, "_metric_route", "")
        if error is None:
            obs.observe_latency(dep, route, time.monotonic() - self._t0)
        elif error == "timeout":
            obs.count_timeout(dep, route)
        else:
            obs.count_error(dep, route)

    def _reroute(self) -> None:
        """Re-send this request to a live replica and adopt the new ref
        (so composition and repeat result() calls follow the retry).
        The original deadline rides along — a retry never extends it.

        NOTE: this makes delivery at-least-once — a replica that died
        mid-execution may have run side effects before the retry. Same
        tradeoff as a load-balancing proxy; stateful non-idempotent
        deployments should disable retries by catching ActorDiedError
        upstream or keying requests idempotently.
        """
        self._handle._refresh(force=True)
        fresh = self._handle._route(
            self._method, self._args, self._kwargs,
            _retry_deadline=self._deadline_mono,
        )
        self._ref = fresh._ref
        self._rid = fresh._rid

    def _note_failure(self) -> None:
        if self._handle is not None and self._rid is not None:
            self._handle._note_failure(self._rid)

    def _note_success(self) -> None:
        if self._handle is not None and self._rid is not None:
            self._handle._note_success(self._rid)

    def _remaining_s(self) -> Optional[float]:
        """Seconds until the request deadline; None when undeadlined.
        Raises GetTimeoutError (recorded as a timeout) once expired."""
        if self._deadline_mono is None:
            return None
        remaining = self._deadline_mono - time.monotonic()
        if remaining <= 0:
            from ray_tpu_torch.exceptions import GetTimeoutError

            self._record_outcome("timeout")
            raise GetTimeoutError(
                f"request to deployment "
                f"{getattr(self._handle, 'deployment_name', '?')!r} "
                f"exceeded its deadline"
            )
        return remaining

    def _retry_delay(self, attempt: int) -> float:
        """Growing jittered backoff for transparent replica retries,
        capped by the remaining deadline."""
        base = float(_cfg().get("serve_retry_base_s", 0.05))
        delay = base * (2 ** attempt) * (0.5 + random.random())
        if self._deadline_mono is not None:
            delay = min(
                delay, max(0.0, self._deadline_mono - time.monotonic())
            )
        return delay

    def result(self, timeout_s: Optional[float] = None) -> Any:
        from ray_tpu_torch.exceptions import ActorDiedError, GetTimeoutError

        from .._private import worker
        from ._private import payloads as _payloads

        budget = max(0, int(_cfg().get("serve_retry_attempts", 3)))
        attempt = 0
        while True:
            remaining = self._remaining_s()
            t = (
                remaining
                if timeout_s is None
                else (timeout_s if remaining is None else min(timeout_s, remaining))
            )
            try:
                # one-shot consumer get: a large (shm) response maps
                # zero-copy when local and pulls straight from the
                # owner's object agent when remote — never installed
                # into the value cache (payloads.py)
                value = worker.get_client().get(
                    [self._ref._id], timeout=t, oneshot=True
                )[0]
            except ActorDiedError:
                self._note_failure()
                if self._handle is None or attempt >= budget:
                    self._record_outcome("error")
                    raise
                time.sleep(self._retry_delay(attempt))
                attempt += 1
                self._reroute()
            except GetTimeoutError:
                self._record_outcome("timeout")
                raise
            except BaseException:
                self._record_outcome("error")
                raise
            else:
                self._note_success()
                self._record_outcome(None)
                return _payloads.unwrap_result(value)

    def _to_object_ref(self):
        return self._ref

    def __await__(self):
        import asyncio

        from ray_tpu_torch.exceptions import ActorDiedError, GetTimeoutError

        from ._private import payloads as _payloads

        async def _get():
            budget = max(0, int(_cfg().get("serve_retry_attempts", 3)))
            attempt = 0
            while True:
                remaining = self._remaining_s()
                try:
                    if remaining is None:
                        value = await self._ref
                    else:

                        async def _awaited():
                            return await self._ref

                        try:
                            value = await asyncio.wait_for(
                                _awaited(), timeout=remaining
                            )
                        except asyncio.TimeoutError:
                            self._record_outcome("timeout")
                            raise GetTimeoutError(
                                "request exceeded its deadline"
                            ) from None
                except ActorDiedError:
                    self._note_failure()
                    if self._handle is None or attempt >= budget:
                        self._record_outcome("error")
                        raise
                    await asyncio.sleep(self._retry_delay(attempt))
                    attempt += 1
                    # _reroute blocks (controller RPC + replica wait):
                    # keep it off the event loop
                    await asyncio.to_thread(self._reroute)
                except BaseException:
                    self._record_outcome("error")
                    raise
                else:
                    self._note_success()
                    self._record_outcome(None)
                    return _payloads.unwrap_result(value)

        return _get().__await__()


class DeploymentResponseGenerator:
    """Iterates a streaming deployment call's yielded values (parity:
    serve's DeploymentResponseGenerator over an ObjectRefGenerator)."""

    def __init__(self, ref_gen):
        self._ref_gen = ref_gen

    def __iter__(self):
        import ray_tpu_torch

        for ref in self._ref_gen:
            yield ray_tpu_torch.get(ref)

    async def __aiter__(self):
        import ray_tpu_torch

        async for ref in self._ref_gen:
            yield await ref


class DeploymentHandle:
    def __init__(self, deployment_name: str, method_name: str = "__call__"):
        self.deployment_name = deployment_name
        self.method_name = method_name
        self._stream = False
        self._model_id = ""
        # metrics "route" tag: ingress proxies stamp their matched route
        # prefix here; direct handle calls report route=""
        self._metric_route = ""
        self._model_map: Dict[bytes, List[str]] = {}
        self._replicas: List[Any] = []
        self._outstanding: Dict[int, int] = {}
        self._inflight: Dict[Any, int] = {}  # ref -> replica id
        self._refreshed = 0.0
        self._lock = threading.Lock()
        # admission control: deployment cap learned from the controller
        # at refresh (None until learned -> config default applies)
        self._max_queued: Optional[int] = None
        # per-request deadline override (None -> serve_request_timeout_s)
        self._request_timeout_s: Optional[float] = None
        # health ejection: consecutive-failure streaks and the ejected
        # set (rid -> replica handle, kept out of the candidate pool
        # while a background prober re-checks it with backoff)
        self._fail_streaks: Dict[bytes, int] = {}
        self._ejected: Dict[bytes, Any] = {}
        self._prober: Optional[threading.Thread] = None

    def __reduce__(self):
        # handles travel inside deployment init args (composition);
        # router state is per-process and rebuilt on first use
        return (DeploymentHandle, (self.deployment_name, self.method_name))

    # -- API -----------------------------------------------------------
    def options(
        self,
        *,
        method_name: Optional[str] = None,
        stream: Optional[bool] = None,
        multiplexed_model_id: Optional[str] = None,
        request_timeout_s: Optional[float] = None,
    ) -> "DeploymentHandle":
        h = DeploymentHandle(self.deployment_name, method_name or self.method_name)
        h._replicas = self._replicas
        h._outstanding = self._outstanding
        # inflight refs ride along with the outstanding counts: a view
        # must be able to credit back completions another view routed,
        # or the shared queue-depth estimate only ever grows (and the
        # admission gate sheds forever)
        h._inflight = self._inflight
        h._refreshed = self._refreshed
        h._stream = self._stream if stream is None else stream
        h._model_id = (
            self._model_id if multiplexed_model_id is None else multiplexed_model_id
        )
        h._model_map = self._model_map
        h._metric_route = self._metric_route
        h._max_queued = self._max_queued
        h._request_timeout_s = (
            self._request_timeout_s
            if request_timeout_s is None
            else request_timeout_s
        )
        # ejection state is shared: an options() view routing to the
        # same deployment must not resurrect an ejected replica
        h._fail_streaks = self._fail_streaks
        h._ejected = self._ejected
        return h

    def __getattr__(self, name: str):
        if name.startswith("_"):
            raise AttributeError(name)
        return _MethodCaller(self, name)

    def remote(self, *args, **kwargs) -> DeploymentResponse:
        return self._route(self.method_name, args, kwargs)

    # -- routing -------------------------------------------------------
    def _controller(self):
        import ray_tpu_torch

        from ._private.controller import CONTROLLER_NAME

        return ray_tpu_torch.get_actor(CONTROLLER_NAME)

    def _refresh(self, force: bool = False) -> None:
        now = time.monotonic()
        with self._lock:
            if not force and now - self._refreshed < _REFRESH_PERIOD_S and self._replicas:
                return
            self._refreshed = now
        # route_partition chaos: the refresh RPC is blackholed for the
        # window — the handle keeps routing on its stale cached set
        # (forced refreshes, e.g. a retry's, are eaten too)
        eng = _serve_chaos()
        if eng is not None and eng.route_partition_active(self.deployment_name):
            eng.record("route_partition", deployment=self.deployment_name)
            return
        import ray_tpu_torch

        ctrl = self._controller()
        info = ray_tpu_torch.get(ctrl.get_routing_info.remote(self.deployment_name))
        replicas = info["replicas"]
        model_map = (
            ray_tpu_torch.get(ctrl.get_multiplex_map.remote(self.deployment_name))
            if self._model_id
            else {}
        )
        with self._lock:
            self._model_map = model_map
            self._replicas = replicas
            self._max_queued = info.get("max_queued_requests", 0)
            # keyed by the STABLE actor id — ActorHandle objects are
            # re-created on every refresh deserialization, so id() keys
            # would zero the load accounting each second
            self._outstanding = {
                _rid(r): self._outstanding.get(_rid(r), 0) for r in replicas
            }
            # a replaced replica leaves the ejected set with its rid —
            # the controller already swapped in a successor
            live = {_rid(r) for r in replicas}
            for rid in list(self._ejected):
                if rid not in live:
                    self._ejected.pop(rid, None)
                    self._fail_streaks.pop(rid, None)

    def _route(
        self, method: str, args, kwargs, _retry_deadline: Optional[float] = None
    ) -> DeploymentResponse:
        from ray_tpu_torch.exceptions import RequestExpiredError, RequestShedError

        from ..util import tracing as _tracing

        from ._private import observability as obs

        # serve.route spans the whole router hop: replica wait + pick +
        # dispatch. Inherits the proxy's trace (ambient context) or
        # head-samples a fresh one for direct handle calls.
        tr = obs.begin_trace()
        t_route0 = time.monotonic()
        # the request deadline is born HERE (config default or
        # handle.options(request_timeout_s=...)); a transparent retry
        # passes the original in — rerouting never extends it
        if _retry_deadline is not None:
            deadline_mono: Optional[float] = _retry_deadline
        else:
            timeout_s = self._request_timeout_s
            if timeout_s is None:
                timeout_s = float(_cfg().get("serve_request_timeout_s", 60.0))
            deadline_mono = (
                t_route0 + timeout_s if timeout_s and timeout_s > 0 else None
            )
        # admission control: outstanding (routed, unsettled) requests
        # vs the deployment cap — past it, shed NOW, before any payload
        # spill or replica wait. Retries skip the gate: their request
        # was already admitted once. Shed accounting is disjoint from
        # everything downstream (a shed request is never counted
        # routed, drained, dropped, or expired).
        self._refresh()
        if _retry_deadline is None:
            cap = self._max_queued
            if not cap:
                cap = int(_cfg().get("serve_max_queued_requests", 0))
            if cap and cap > 0:
                self._reconcile_inflight()
                with self._lock:
                    queued = sum(self._outstanding.values())
                if queued >= cap:
                    obs.count_shed(self.deployment_name, self._metric_route)
                    raise RequestShedError(self.deployment_name, queued, cap)
        # unwrap composed responses: pass the underlying ref so the
        # downstream replica receives the resolved value (model
        # composition, reference handle.py DeploymentResponse chaining)
        args = tuple(
            a._to_object_ref() if isinstance(a, DeploymentResponse) else a
            for a in args
        )
        kwargs = {
            k: (v._to_object_ref() if isinstance(v, DeploymentResponse) else v)
            for k, v in kwargs.items()
        }
        # zero-copy data plane: oversized raw payloads (top-level args/
        # kwargs + one level into dict args, covering the ingress request
        # dict's "body") spill onto the direct object plane and travel as
        # PayloadRef markers; the replica bulk-resolves them. Streaming
        # calls skip the codec — handle_request_streaming has no resolve
        # pass.
        payload_holds: List[Any] = []
        payload_deps: List[bytes] = []
        if not self._stream:
            from ._private import payloads as _payloads

            t_spill0 = time.monotonic()
            args, kwargs, payload_holds, payload_deps, spilled_bytes = (
                _payloads.spill_args(args, kwargs)
            )
            if payload_holds and tr is not None:
                obs.emit_span(
                    "serve.payload_put", "serve.payload_put", tr[0], tr[1],
                    t_spill0, time.monotonic(),
                    deployment=self.deployment_name,
                    n=len(payload_holds), nbytes=spilled_bytes,
                )
        # replica wait bounded by the request deadline (was a literal
        # 30 s): an expired request fails fast instead of parking
        wait_deadline = (
            deadline_mono
            if deadline_mono is not None
            else t_route0 + float(_cfg().get("serve_request_timeout_s", 60.0))
        )
        delay = 0.02
        while True:
            self._refresh()
            with self._lock:
                replicas = [
                    r for r in self._replicas if _rid(r) not in self._ejected
                ]
                if not replicas and self._replicas:
                    # every replica ejected: fail open on the full set
                    # rather than refusing all traffic on a router-local
                    # health guess
                    replicas = list(self._replicas)
            if replicas:
                break
            if time.monotonic() > wait_deadline:
                obs.count_expired(self.deployment_name, self._metric_route)
                raise RequestExpiredError(
                    self.deployment_name,
                    f"no live replicas for deployment "
                    f"{self.deployment_name!r} within the request deadline",
                )
            time.sleep(delay)
            delay = min(0.25, delay * 1.5)
        self._reconcile_inflight()
        if self._model_id:
            # model affinity (reference pow_2_scheduler multiplex rank):
            # pick among replicas already holding the model; fall back
            # to the full set (the chosen replica then loads it)
            with self._lock:
                holders = [
                    r
                    for r in replicas
                    if self._model_id in self._model_map.get(_rid(r), ())
                ]
            if holders:
                replicas = holders
        replica = self._pick(replicas)
        rid = _rid(replica)
        if self._stream:
            # streamed responses flow as an ObjectRefGenerator; no
            # transparent replica retry (a half-consumed stream is not
            # transparently re-executable), and no _outstanding
            # accounting — there is no single completion ref to credit
            # the count back against
            ref_gen = replica.handle_request_streaming.options(
                num_returns="streaming"
            ).remote(method, args, kwargs, self._model_id)
            return DeploymentResponseGenerator(ref_gen)
        with self._lock:
            self._outstanding[rid] = self._outstanding.get(rid, 0) + 1
        obs.count_request(self.deployment_name, self._metric_route)
        handle_request = replica.handle_request
        if payload_deps:
            # spilled payload ids ride the dispatch's arg_deps: the hub
            # pins them while the call is in flight, so a caller dropping
            # the response (and its holds) early can't free a payload the
            # replica hasn't fetched yet
            handle_request = handle_request.options(_extra_arg_deps=payload_deps)
        # request_meta always rides now: the deadline propagates to the
        # replica (pre-execute expiry check) and its batch queue; the
        # enqueue wall stamp is added only when traced
        meta: Optional[Dict[str, Any]] = None
        if deadline_mono is not None:
            meta = {"deadline_wall": _tracing.wall_at(deadline_mono)}
        if tr is None:
            ref = handle_request.remote(
                method, args, kwargs, self._model_id, meta
            )
        else:
            # the enqueue wall stamp rides as an ordinary pickled arg;
            # the replica opens serve.queue_wait at this instant. The
            # ambient push makes the task-layer submit span (and the
            # replica's execute chain) parent under serve.route.
            route_sid = _tracing.new_span_id()
            meta = dict(meta or {})
            meta["enq_wall"] = _tracing.wall_at(time.monotonic())
            token = _tracing.push_context((tr[0], route_sid))
            try:
                ref = handle_request.remote(
                    method, args, kwargs, self._model_id, meta
                )
            finally:
                _tracing.pop_context(token)
            obs.emit_span(
                "serve.route", "serve.route", tr[0], tr[1],
                t_route0, time.monotonic(), span_id=route_sid,
                deployment=self.deployment_name, method=method,
            )
        with self._lock:
            self._inflight[ref] = rid
        resp = DeploymentResponse(ref, self, method, args, kwargs)
        resp._rid = rid
        resp._deadline_mono = deadline_mono
        if payload_holds:
            resp._payload_holds = payload_holds
        return resp

    def _pick(self, replicas: List[Any]):
        """Power-of-two-choices on caller-side outstanding counts."""
        if len(replicas) == 1:
            return replicas[0]
        a, b = random.sample(replicas, 2)
        with self._lock:
            la = self._outstanding.get(_rid(a), 0)
            lb = self._outstanding.get(_rid(b), 0)
        return a if la <= lb else b

    def _reconcile_inflight(self) -> None:
        """Lazily credit finished requests back to their replicas (a
        zero-timeout wait on the next route, instead of a watcher thread
        per request — the reference likewise folds completion accounting
        into the router's request path)."""
        import ray_tpu_torch

        with self._lock:
            refs = list(self._inflight.keys())
        if not refs:
            return
        done, _ = ray_tpu_torch.wait(refs, num_returns=len(refs), timeout=0)
        with self._lock:
            for ref in done:
                rid = self._inflight.pop(ref, None)
                if rid is not None and self._outstanding.get(rid, 0) > 0:
                    self._outstanding[rid] -= 1

    # -- health ejection ----------------------------------------------
    def _note_failure(self, rid: bytes) -> None:
        """One failed/timed-out request on a replica. At
        ``serve_ejection_failures`` consecutive failures the replica
        leaves the candidate set and a background prober re-checks it
        with jittered exponential backoff until healthy (or dead)."""
        threshold = int(_cfg().get("serve_ejection_failures", 3))
        if threshold <= 0:
            return
        with self._lock:
            streak = self._fail_streaks.get(rid, 0) + 1
            self._fail_streaks[rid] = streak
            if streak < threshold or rid in self._ejected:
                return
            replica = next(
                (r for r in self._replicas if _rid(r) == rid), None
            )
            if replica is None:
                self._fail_streaks.pop(rid, None)
                return
            self._ejected[rid] = replica
        from ._private import observability as obs

        obs.count_ejection(self.deployment_name)
        self._ensure_prober()

    def _note_success(self, rid: bytes) -> None:
        with self._lock:
            self._fail_streaks.pop(rid, None)

    def _ensure_prober(self) -> None:
        with self._lock:
            if self._prober is not None and self._prober.is_alive():
                return
            self._prober = threading.Thread(
                target=self._probe_ejected,
                daemon=True,
                name=f"serve-probe-{self.deployment_name}",
            )
            self._prober.start()

    def _probe_ejected(self) -> None:
        """Re-probe ejected replicas until each recovers (restored to
        the candidate set) or turns out dead (left out for good — the
        controller replaces it). Exits when the ejected set drains."""
        import ray_tpu_torch
        from ray_tpu_torch.exceptions import ActorDiedError

        base = float(_cfg().get("serve_probe_base_s", 0.25))
        cap = float(_cfg().get("serve_probe_max_s", 5.0))
        delay = base
        while True:
            with self._lock:
                targets = dict(self._ejected)
            if not targets:
                return
            time.sleep(delay * (0.5 + random.random()))
            delay = min(cap, delay * 2.0)
            for rid, replica in targets.items():
                try:
                    # probes are deliberately sequential: each replica
                    # gets its own verdict + bounded timeout
                    ray_tpu_torch.get(replica.check_health.remote(), timeout=2.0)  # graftlint: disable=GL004,GL017 — sequential health probe with a fixed per-replica budget
                except ActorDiedError:
                    # really dead: stop probing; the reconcile loop
                    # replaces it and _refresh prunes the rid
                    with self._lock:
                        self._ejected.pop(rid, None)
                        self._fail_streaks.pop(rid, None)
                except Exception:
                    continue  # still unhealthy: keep backing off
                else:
                    with self._lock:
                        self._ejected.pop(rid, None)
                        self._fail_streaks.pop(rid, None)
                    delay = base


class _MethodCaller:
    def __init__(self, handle: DeploymentHandle, method: str):
        self._handle = handle
        self._method = method

    def remote(self, *args, **kwargs) -> DeploymentResponse:
        return self._handle._route(self._method, args, kwargs)
