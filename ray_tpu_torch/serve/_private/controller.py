"""ServeController: the reconcile loop.

Parity: python/ray/serve/_private/controller.py:86 + deployment_state.py
— a singleton named actor holding target state {deployment -> config},
reconciling replica actors toward it, running autoscaling, and serving
discovery (the reference broadcasts routing tables via LongPollHost; on
the single-host runtime handles pull the replica list and refresh on
miss/failure, which has the same eventual-consistency semantics without
the long-poll machinery).
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

CONTROLLER_NAME = "__serve_controller"
_RECONCILE_PERIOD_S = 0.25


def drain_accounting(
    initial: List[int], final: List[int]
) -> Tuple[int, int]:
    """(drained, dropped) from per-victim in-flight counts at drain
    start vs kill time. Booked PER VICTIM — ``max(0, initial - final)``
    drained plus ``final`` dropped — so a victim whose load *rose*
    during the drain window (stale handles kept routing to it) books
    its kill-time in-flight as dropped without subtracting the growth
    from some other victim's drain count. The old aggregate-sum form
    (``drained = sum(initial) - sum(final)``) double-counted exactly
    that case: late arrivals inflated ``final``, deflating every
    victim's drain credit at once — and shed requests never appear in
    either number (they are refused at admission, before any replica
    queue). Every admitted in-flight request lands in exactly one
    bucket."""
    drained = sum(max(0, i - f) for i, f in zip(initial, final))
    dropped = sum(final)
    return drained, dropped


@dataclass
class DeploymentInfo:
    name: str
    cls: Any
    init_args: tuple
    init_kwargs: dict
    num_replicas: int = 1
    max_ongoing_requests: int = 16
    # admission control: cap on outstanding routed requests per handle;
    # 0 = fall back to the serve_max_queued_requests config knob
    max_queued_requests: int = 0
    ray_actor_options: Dict[str, Any] = field(default_factory=dict)
    user_config: Any = None
    autoscaling_config: Optional[Dict[str, Any]] = None
    route_prefix: Optional[str] = None
    version: int = 0


class ServeController:
    def __init__(self):
        self._deployments: Dict[str, DeploymentInfo] = {}
        self._replicas: Dict[str, List[Any]] = {}  # name -> actor handles
        self._replica_versions: Dict[str, List[int]] = {}
        self._ping_misses: Dict[bytes, int] = {}  # consecutive health misses
        # replicas that have answered a ping: a replica whose constructor
        # still runs (a model loading onto its card) is not yet missing
        # pings (Ray Serve health-checks RUNNING replicas only)
        self._answered: set = set()
        # deployment -> {replica id -> loaded multiplexed model ids};
        # refreshed from the same batched ping (multiplex routing info)
        self._model_ids: Dict[str, Dict[bytes, List[str]]] = {}
        self._lock = threading.RLock()
        self._shutdown = threading.Event()
        # serve-scope chaos (replica_kill timed faults execute here, on
        # the reconcile tick; None when the plan is inert)
        from ..._private import chaos as chaos_mod

        self._chaos = chaos_mod.engine_for("serve")
        self._thread = threading.Thread(
            target=self._reconcile_loop, daemon=True, name="serve-reconcile"
        )
        self._thread.start()

    # -- API (called by serve.run / handles / proxy) -------------------
    def deploy(self, info: DeploymentInfo) -> None:
        with self._lock:
            prev = self._deployments.get(info.name)
            info.version = (prev.version + 1) if prev else 0
            self._deployments[info.name] = info

    def delete_deployment(self, name: str) -> None:
        with self._lock:
            self._deployments.pop(name, None)

    def get_replicas(self, name: str) -> List[Any]:
        with self._lock:
            return list(self._replicas.get(name, []))

    def get_routing_info(self, name: str) -> Dict[str, Any]:
        """One RPC with everything a handle's refresh needs: the live
        replica set plus the deployment's admission cap."""
        with self._lock:
            info = self._deployments.get(name)
            return {
                "replicas": list(self._replicas.get(name, [])),
                "max_queued_requests": (
                    info.max_queued_requests if info else 0
                ),
            }

    def get_multiplex_map(self, name: str) -> Dict[bytes, List[str]]:
        """replica id -> loaded model ids (router model-affinity info;
        reference: multiplexed_replicas broadcast via LongPollHost)."""
        with self._lock:
            return {
                rid: list(ids)
                for rid, ids in self._model_ids.get(name, {}).items()
            }

    def list_deployments(self) -> Dict[str, Dict[str, Any]]:
        with self._lock:
            return {
                n: {
                    "num_replicas": d.num_replicas,
                    "live_replicas": len(self._replicas.get(n, [])),
                    "route_prefix": d.route_prefix,
                    "version": d.version,
                }
                for n, d in self._deployments.items()
            }

    def get_routes(self) -> Dict[str, str]:
        with self._lock:
            return {
                d.route_prefix: n
                for n, d in self._deployments.items()
                if d.route_prefix
            }

    def shutdown(self) -> None:
        self._shutdown.set()
        with self._lock:
            names = list(self._deployments)
            self._deployments.clear()
        for name in names:
            self._scale_to(name, None, 0)

    def ready(self) -> bool:
        """True when every deployment has its target replica count."""
        with self._lock:
            return all(
                len(self._replicas.get(n, [])) >= d.num_replicas
                for n, d in self._deployments.items()
            )

    # -- reconcile ----------------------------------------------------
    def _reconcile_loop(self) -> None:
        while not self._shutdown.is_set():
            try:
                self._reconcile_once()
            except Exception:
                import traceback

                traceback.print_exc()
            self._autoscale()
            try:
                self._run_chaos()
            except Exception:
                pass
            self._shutdown.wait(_RECONCILE_PERIOD_S)

    def _run_chaos(self) -> None:
        """Execute due serve-scope timed faults (replica_kill): victim
        drawn from the serve rng over the deployment's live set, so a
        fixed seed kills the same replica index at the same tick."""
        eng = self._chaos
        if eng is None or not eng.timed:
            return
        import ray_tpu_torch

        for fault in eng.due_faults():
            if fault.kind != "replica_kill":
                eng.consume(fault, fault.count - fault.fired)
                continue
            with self._lock:
                live = list(self._replicas.get(fault.arg, []))
            if not live:
                eng.defer(fault)
                continue
            idx = eng.rng.randrange(len(live))
            victim = live[idx]
            eng.record(
                "replica_kill", deployment=fault.arg, victim_index=idx,
                at_s=fault.at,
            )
            eng.consume(fault)
            try:
                ray_tpu_torch.kill(victim)
            except Exception:
                pass

    def chaos_snapshot(self) -> Dict[str, Any]:
        """The serve chaos engine's state (fired events, pending timed
        schedule) — the determinism probe for seeded serve soaks."""
        return self._chaos.snapshot() if self._chaos is not None else {}

    def _reconcile_once(self) -> None:
        import ray_tpu_torch

        with self._lock:
            targets = dict(self._deployments)
        for name, info in targets.items():
            live = self._replicas.get(name, [])
            versions = self._replica_versions.get(name, [])
            # health checks: ONE parallel ping round per deployment per
            # reconcile (was one blocking round-trip per replica —
            # O(replicas) control latency, r1 Weak finding). A slow
            # replica is only retired after 3 consecutive missed pings
            # (reference: health_check_failure_threshold), and only once
            # it has answered one; a replica given up on is killed, so
            # that the cards pinned to it return to the pool.
            refs = [actor.stats.remote() for actor in live]
            done, _ = ray_tpu_torch.wait(  # graftlint: disable=GL017 — control-plane health sweep on a fixed cadence, no request deadline exists here
                refs, num_returns=len(refs), timeout=5.0
            ) if refs else ([], [])
            done_set = set(done)
            alive, alive_vers = [], []
            victims: List[Any] = []
            given_up: List[Any] = []
            ongoing_sum = queued_sum = 0
            with self._lock:
                model_map = self._model_ids.setdefault(name, {})
            for actor, ver, ref in zip(live, versions, refs):
                rid = actor._actor_id.binary()
                if ref in done_set:
                    try:
                        stats = ray_tpu_torch.get(ref)
                        mux = stats.get("multiplexed_model_ids") or []
                        with self._lock:
                            if mux or rid in model_map:
                                model_map[rid] = list(mux)
                        ongoing_sum += int(stats.get("ongoing", 0))
                        queued_sum += int(stats.get("queued", 0))
                        healthy = True
                        self._ping_misses.pop(rid, None)
                        self._answered.add(rid)
                    except Exception:
                        healthy = False
                elif rid not in self._answered:
                    healthy = True  # still being constructed
                else:
                    misses = self._ping_misses.get(rid, 0) + 1
                    self._ping_misses[rid] = misses
                    healthy = misses < 3
                if not healthy:
                    self._ping_misses.pop(rid, None)
                    given_up.append(actor)
                    continue
                # version bump (redeploy): retire old-code replicas —
                # deferred past the routing-table update so they drain
                # in-flight requests instead of dying mid-request
                if ver == info.version:
                    alive.append(actor)
                    alive_vers.append(ver)
                else:
                    victims.append(actor)
            while len(alive) < info.num_replicas:
                actor = self._start_replica(info)
                alive.append(actor)
                alive_vers.append(info.version)
            while len(alive) > info.num_replicas:
                victims.append(alive.pop())
                alive_vers.pop()
            with self._lock:
                self._replicas[name] = alive
                self._replica_versions[name] = alive_vers
                alive_rids = {a._actor_id.binary() for a in alive}
                for rid in list(model_map):
                    if rid not in alive_rids:
                        del model_map[rid]
            for actor in given_up:
                try:
                    ray_tpu_torch.kill(actor)
                except Exception:
                    pass
            # routing table now excludes the victims: drain, then kill
            self._retire_replicas(name, victims)
            from . import observability as obs

            obs.set_deployment_gauges(
                name, ongoing_sum, queued_sum, len(alive)
            )
        # GC deleted deployments
        with self._lock:
            for name in list(self._replicas):
                if name not in targets:
                    self._scale_to(name, None, 0)
            for name in list(self._model_ids):
                if name not in targets:
                    del self._model_ids[name]
            live_rids = {
                a._actor_id.binary()
                for actors in self._replicas.values()
                for a in actors
            }
        # miss counters only for replicas that still exist (retired
        # generations would otherwise leak entries forever). Pruned
        # outside the lock: _ping_misses is reconcile-thread-only state,
        # only _replicas needs self._lock.
        for rid in list(self._ping_misses):
            if rid not in live_rids:
                del self._ping_misses[rid]
        self._answered &= live_rids

    def _start_replica(self, info: DeploymentInfo):
        import ray_tpu_torch
        from .replica import Replica

        opts = dict(info.ray_actor_options or {})
        opts.setdefault("num_cpus", 0.1)
        opts["max_concurrency"] = max(2, info.max_ongoing_requests)
        replica_cls = ray_tpu_torch.remote(Replica)
        actor = replica_cls.options(**opts).remote(
            info.name, info.cls, info.init_args, info.init_kwargs, info.user_config
        )
        return actor

    def _retire_replicas(self, name: str, victims: List[Any]) -> None:
        """Graceful teardown: drain in-flight requests, then kill.

        Callers must have removed the victims from self._replicas FIRST
        (so routers stop sending new work), though handles cache the
        replica list for up to a second — the drain window absorbs that
        too. Polls each victim's queue_len (ongoing + batch-parked, the
        same load signal the router uses) until idle or
        RAY_TPU_TORCH_SERVE_DRAIN_TIMEOUT_S elapses; whatever is still
        in-flight at the deadline is dropped with the kill. Both
        outcomes are counted (drained vs dropped) so a chaos run can
        quantify graceful degradation.
        """
        import os

        import ray_tpu_torch

        from . import observability as obs

        if not victims:
            return

        def _load(actor) -> int:
            try:
                return int(ray_tpu_torch.get(actor.queue_len.remote(), timeout=2.0))  # graftlint: disable=GL017 — retirement drain probe; a dead replica must read as empty quickly
            except Exception:
                return 0  # dead/unreachable: nothing left to drain

        timeout_s = float(os.environ.get("RAY_TPU_TORCH_SERVE_DRAIN_TIMEOUT_S", "5"))
        deadline = time.monotonic() + timeout_s
        initial = [_load(a) for a in victims]
        pending = [a for a, n in zip(victims, initial) if n > 0]
        while pending and time.monotonic() < deadline:
            pending = [a for a in pending if _load(a) > 0]
            if pending:
                time.sleep(0.05)
        still_pending = {id(a) for a in pending}
        final = [
            _load(a) if id(a) in still_pending else 0 for a in victims
        ]
        drained, dropped = drain_accounting(initial, final)
        obs.count_drained(name, drained)
        obs.count_dropped(name, dropped)
        for actor in victims:
            try:
                ray_tpu_torch.kill(actor)
            except Exception:
                pass

    def _scale_to(self, name: str, info, n: int) -> None:
        with self._lock:
            live = self._replicas.get(name, [])
            keep, drop = live[:n], live[n:]
            if n == 0:
                self._replicas.pop(name, None)
                self._replica_versions.pop(name, None)
            else:
                self._replicas[name] = keep
                self._replica_versions[name] = self._replica_versions.get(name, [])[:n]
        self._retire_replicas(name, drop)

    # -- autoscaling ---------------------------------------------------
    def _autoscale(self) -> None:
        """Target-ongoing-requests autoscaling (reference:
        serve/_private/autoscaling_state.py + autoscaling_policy.py:
        desired = ceil(total_ongoing / target_per_replica), clamped)."""
        import math

        import ray_tpu_torch

        with self._lock:
            targets = {
                n: d for n, d in self._deployments.items() if d.autoscaling_config
            }
        for name, info in targets.items():
            cfg = info.autoscaling_config
            replicas = self.get_replicas(name)
            if not replicas:
                continue
            try:
                loads = ray_tpu_torch.get(  # graftlint: disable=GL017 — autoscaler metrics poll on its own cadence, not a request path
                    [r.queue_len.remote() for r in replicas], timeout=5.0
                )
            except Exception:
                continue
            total = sum(loads)
            target_per = cfg.get("target_ongoing_requests", 2)
            desired = max(1, math.ceil(total / max(target_per, 1e-9)))
            desired = min(
                cfg.get("max_replicas", 1), max(cfg.get("min_replicas", 1), desired)
            )
            if desired != info.num_replicas:
                with self._lock:
                    if name in self._deployments:
                        self._deployments[name].num_replicas = desired
