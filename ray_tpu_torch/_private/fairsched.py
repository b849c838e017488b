"""Multi-tenant scheduling policy: priority, fair share, quotas.

The hub's dispatch layer is single-tenant FIFO: runnable tasks queue
per scheduling class and classes are visited in insertion order, so one
greedy driver can starve every other client of TPU chips indefinitely.
This module is the policy engine that sits between submission and that
per-class dispatch (the shape multi-tenant accelerator clusters need —
"On Scheduling Ring-All-Reduce Learning Jobs in Multi-Tenant GPU
Clusters", arxiv 2207.07817):

- **Jobs / tenants**: every driver (or submitted job) may register a
  ``JobEntry`` — tenant id, integer priority, optional resource quota —
  at ``init(job_config=...)`` / ``job submit`` time. The registry is
  pruned when the registering connection goes away (graftlint GL009
  guards hub-side registries against unpruned growth).
- **Ordering**: runnable scheduling classes are ordered by
  ``(-priority, weighted fair-share usage)`` instead of raw FIFO.
  Fair-share usage is accumulated work-seconds (chips, else CPUs, of
  dispatched tasks x wall time, from an injectable clock so tests are
  deterministic), normalized by the tenant's quota weight — the tenant
  furthest below its share dispatches first.
- **Quotas**: enforced at admission. A task that would push its
  tenant's admitted usage over quota parks in a per-tenant
  ``pending_quota`` queue instead of entering the runnable set (so it
  is invisible to the autoscaler's demand view), and is re-admitted as
  soon as finishing work frees room.
- **Preemption** (policy half): when a higher-priority job's placement
  group / SLICE reservation cannot fit, :meth:`preemption_victims`
  selects victim gangs — whole placement groups or single running
  tasks, lowest priority first, never partial gangs. The hub executes
  the kill through the existing retry/restart machinery so preempted
  work requeues with lineage intact (gang scheduling makes preemption
  the only way to reclaim a contiguous ICI slice — "Podracer
  architectures for scalable RL", arxiv 2104.06272).

Everything here runs on the hub's reactor thread: no locks, and the
whole module stays inert (O(1) no-ops on the hot path) until the first
job/tenant registers.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Deque, Dict, List, Optional, Tuple

DEFAULT_TENANT = "default"

# fair-share usage half-life: consumption this old counts half. Bounds
# how long historical usage can bias the deficit ordering against a
# tenant (and, with the entry baseline in _tenant(), how long a
# newcomer's advantage lasts).
USAGE_HALFLIFE_S = 600.0


class QuotaInfeasibleError(Exception):
    """The task's resource request exceeds its tenant's quota outright —
    it could never be admitted even on a fully idle tenant. Raised at
    admission so the submit fails loudly instead of parking forever
    (and wedging the tenant's FIFO pending_quota queue behind it)."""


@dataclass
class JobEntry:
    """One registered driver/job (the hub-side registry row)."""

    job_id: str
    tenant: str = DEFAULT_TENANT
    priority: int = 0
    quota: Dict[str, float] = field(default_factory=dict)
    # id(conn) of the registering connection; the registry is pruned in
    # the hub's disconnect path keyed on this (GL009: a message-handler
    # registry must have a cleanup edge)
    conn_id: Optional[int] = None
    submitted: int = 0
    dispatched: int = 0
    preempted: int = 0


@dataclass
class TenantEntry:
    """Aggregate accounting per tenant (quota + fair-share state)."""

    name: str
    # resource caps; empty = unlimited. Units: the hub's resource units
    # (whole TPU chips, CPU cores, bytes of "memory").
    quota: Dict[str, float] = field(default_factory=dict)
    # admitted-but-not-finished usage (charged at admission, released
    # at final task completion / permanent actor death)
    admitted: Dict[str, float] = field(default_factory=dict)
    # fair-share clock: accumulated work-seconds of dispatched tasks.
    # `rate` is the current aggregate work of running tasks; usage_s is
    # folded forward from rate_since whenever rate changes, so the live
    # value at time t is usage_s + rate * (t - rate_since) in O(1).
    usage_s: float = 0.0
    rate: float = 0.0
    rate_since: float = 0.0
    # tasks parked at admission because the tenant is over quota
    parked: Deque[Any] = field(default_factory=deque)
    n_preempted: int = 0

    def live_usage(self, now: float) -> float:
        """Accumulated usage with exponential decay (half-life
        USAGE_HALFLIFE_S): old consumption fades, so the deficit
        ordering reflects the recent past — a tenant that ran alone
        for an hour is not owed an hour of starvation once a
        competitor shows up."""
        dt = max(0.0, now - self.rate_since)
        decay = 0.5 ** (dt / USAGE_HALFLIFE_S) if dt > 0 else 1.0
        return self.usage_s * decay + self.rate * dt

    def weight(self) -> float:
        """Fair-share weight from the quota's primary resource (chips,
        else CPUs); quota-less tenants weigh 1.0 (equal share)."""
        w = self.quota.get("GPU") or self.quota.get("CPU") or 0.0
        return w if w > 0 else 1.0


def _work(resources: Dict[str, float]) -> float:
    """The scalar work rate a dispatched task charges its tenant's
    fair-share clock with: chips if it holds any, else CPUs, else a
    nominal 1.0 so zero-resource tasks still register."""
    return (
        resources.get("GPU", 0.0)
        or resources.get("CPU", 0.0)
        or 1.0
    )


class FairScheduler:
    """Policy engine owned by (and only touched from) the scheduler
    state service — the hub's state-plane thread (with the sharded
    control plane, hub_shards.py, reactor shards never call in here;
    they deliver messages over the rings and this engine runs behind
    them, so quota/priority ordering stays globally consistent no
    matter which shard a submit arrived on).

    ``clock`` is injectable for deterministic tests (defaults to
    ``time.monotonic``).
    """

    def __init__(self, clock=time.monotonic):
        self.clock = clock
        self.jobs: Dict[str, JobEntry] = {}
        self.tenants: Dict[str, TenantEntry] = {}
        # task_id -> (tenant, resources) quota charge, for idempotent
        # release (retries must not re-charge, double releases must not
        # under-count)
        self._admitted: Dict[bytes, Tuple[str, Dict[str, float]]] = {}
        # task_id -> (tenant, work) running fair-share interval
        self._running: Dict[bytes, Tuple[str, float]] = {}
        self.preemptions = 0
        # single-owner discipline: the state plane binds itself before
        # the first message and mutating entry points cheaply verify it
        # (a reactor shard mutating policy state is the GL010 bug class
        # — this is the runtime tripwire for the same invariant)
        self._owner_ident: Optional[int] = None

    def bind_owner(self) -> None:
        """Called by the owning thread (hub state plane) at loop start."""
        self._owner_ident = threading.get_ident()

    def _assert_owner(self) -> None:
        # sits on the per-submit admit() path once tenants exist: two
        # attribute loads and a compare, nothing heavier
        if (
            self._owner_ident is not None
            and threading.get_ident() != self._owner_ident
        ):
            raise RuntimeError(
                "FairScheduler mutated off its owner thread — state "
                "services are single-threaded; route through the "
                "shard ring instead (see hub_shards.py)"
            )

    # ------------------------------------------------------------ registry
    def active(self) -> bool:
        return bool(self.tenants)

    def register_job(
        self,
        job_id: str,
        tenant: str = DEFAULT_TENANT,
        priority: int = 0,
        quota: Optional[Dict[str, float]] = None,
        conn_id: Optional[int] = None,
    ) -> JobEntry:
        """``quota`` is tri-state: None = no opinion (the tenant's
        existing cap, if any, stands); a dict — INCLUDING the empty
        dict — is declared and wins (one quota per tenant, shared by
        all its jobs, last declaration wins; ``quota={}`` lifts an
        earlier cap)."""
        self._assert_owner()
        tenant = tenant or DEFAULT_TENANT
        entry = self.jobs.get(job_id)
        if entry is None:
            entry = self.jobs[job_id] = JobEntry(job_id=job_id)
        entry.tenant = tenant
        entry.priority = int(priority or 0)
        entry.quota = {
            k: float(v) for k, v in (quota or {}).items()
        }
        entry.conn_id = conn_id
        t = self._tenant(tenant)
        if quota is not None:
            t.quota = dict(entry.quota)
        return entry

    def drop_conn(self, conn_id: int) -> List[str]:
        """Prune jobs registered by a connection that went away. Tenant
        aggregates survive while they still hold admitted work or
        parked tasks (the accounting must outlive the registering
        socket); fully-idle tenants with no remaining jobs are dropped
        so the registry cannot grow without bound under client churn."""
        gone = [j for j, e in self.jobs.items() if e.conn_id == conn_id]
        for job_id in gone:
            del self.jobs[job_id]
        live_tenants = {e.tenant for e in self.jobs.values()}
        for name in [n for n in self.tenants if n not in live_tenants]:
            t = self.tenants[name]
            if not t.parked and not any(t.admitted.values()):
                del self.tenants[name]
        return gone

    def _tenant(self, name: str) -> TenantEntry:
        t = self.tenants.get(name)
        if t is None:
            now = self.clock()
            # entry baseline: a newcomer starts at the LOWEST incumbent
            # usage, not zero — otherwise it would monopolize contended
            # chips until it caught up with everyone's history
            base = min(
                (x.live_usage(now) for x in self.tenants.values()),
                default=0.0,
            )
            t = self.tenants[name] = TenantEntry(
                name=name, usage_s=base, rate_since=now
            )
        return t

    # --------------------------------------------------------- spec helpers
    @staticmethod
    def tenant_of(options: dict) -> str:
        return options.get("tenant") or DEFAULT_TENANT

    @staticmethod
    def priority_of(options: dict) -> int:
        try:
            return int(options.get("priority") or 0)
        except (TypeError, ValueError):
            return 0

    def _note_submit(self, options: dict) -> None:
        if options.get("_fs_counted"):
            return  # retries re-enter admit(); count each task once
        options["_fs_counted"] = True
        job = self.jobs.get(options.get("job_id") or "")
        if job is not None:
            job.submitted += 1

    # ------------------------------------------------------------ admission
    def admit(self, spec) -> bool:
        """Quota gate. True = runnable now; False = parked in the
        tenant's pending_quota queue (caller must not enqueue). Charges
        the tenant's admitted usage on success — idempotent per task,
        so retries re-admit for free."""
        if not self.tenants:
            return True  # no quotas/jobs registered: stay inert
        self._assert_owner()
        if spec.task_id in self._admitted:
            return True  # retry of already-admitted work
        tenant_name = self.tenant_of(spec.options)
        self._note_submit(spec.options)
        t = self.tenants.get(tenant_name)
        if t is None or not t.quota:
            return True  # unregistered or unlimited tenant
        infeasible = {
            k: cap for k, cap in t.quota.items()
            if spec.resources.get(k, 0.0) > cap + 1e-9
        }
        if infeasible:
            raise QuotaInfeasibleError(
                f"task requires {spec.resources} but tenant "
                f"'{tenant_name}' quota caps {infeasible} — it can never "
                "be admitted; shrink the request or raise the quota"
            )
        if spec.options.get("placement_group"):
            # PG-resident tasks draw from their gang's bundles, whose
            # capacity was already quota-charged when the reservation
            # was admitted (charge_reservation) — charging the task
            # too would double-count and wedge the tenant
            return True
        if t.parked or not self._fits_quota(t, spec.resources):
            # park behind any already-parked work even if THIS spec
            # would fit: re-admission is FIFO per tenant, and letting
            # fresh small tasks slip past a parked big one would starve
            # the queue head forever
            t.parked.append(spec)
            return False
        self._charge_admission(t, spec)
        return True

    def admit_many(self, specs) -> List[bool]:
        """One admission fold for a homogeneous batch (bulk submit:
        same fn, same resources, same tenant/options shape). Verdict
        per spec, same semantics as admit() called in order — but the
        inert-case check, owner assert, tenant lookup, and the
        infeasibility screen run ONCE per batch instead of once per
        task. Parking stays FIFO: the first spec that doesn't fit
        parks, and everything after it parks behind it."""
        if not self.tenants or not specs:
            return [True] * len(specs)
        self._assert_owner()
        head = specs[0]
        tenant_name = self.tenant_of(head.options)
        t = self.tenants.get(tenant_name)
        if t is not None and t.quota:
            # homogeneous resources: one infeasible spec means the
            # whole batch can never run — fail it in one raise
            infeasible = {
                k: cap for k, cap in t.quota.items()
                if head.resources.get(k, 0.0) > cap + 1e-9
            }
            if infeasible:
                raise QuotaInfeasibleError(
                    f"task requires {head.resources} but tenant "
                    f"'{tenant_name}' quota caps {infeasible} — it can "
                    "never be admitted; shrink the request or raise "
                    "the quota"
                )
        out: List[bool] = []
        for spec in specs:
            if spec.task_id in self._admitted:
                out.append(True)
                continue
            self._note_submit(spec.options)
            if (t is None or not t.quota
                    or spec.options.get("placement_group")):
                out.append(True)
            elif t.parked or not self._fits_quota(t, spec.resources):
                t.parked.append(spec)
                out.append(False)
            else:
                self._charge_admission(t, spec)
                out.append(True)
        return out

    def charge_reservation(
        self,
        key: bytes,
        tenant_name: str,
        resources: Dict[str, float],
    ) -> Optional[str]:
        """Quota-charge a placement-group reservation at creation (the
        resources are held exclusively whether or not tasks run in
        them). Returns an error string when the tenant's quota cannot
        accommodate it — reservations fail fast rather than queue.
        Released by release_admission(pg_id) on removal."""
        if not self.tenants:
            return None
        t = self.tenants.get(tenant_name or DEFAULT_TENANT)
        if t is None or not t.quota:
            return None
        if not self._fits_quota(t, resources):
            return (
                f"placement group needs {resources} but tenant "
                f"'{t.name}' has "
                f"{ {k: v for k, v in t.admitted.items() if v > 1e-9} } "
                f"admitted against quota {t.quota}"
            )
        self._admitted[key] = (t.name, dict(resources))
        for k, v in resources.items():
            t.admitted[k] = t.admitted.get(k, 0.0) + v
        return None

    @staticmethod
    def _fits_quota(t: TenantEntry, need: Dict[str, float]) -> bool:
        return all(
            t.admitted.get(k, 0.0) + need.get(k, 0.0) <= cap + 1e-9
            for k, cap in t.quota.items()
        )

    def _charge_admission(self, t: TenantEntry, spec) -> None:
        self._admitted[spec.task_id] = (t.name, dict(spec.resources))
        for k, v in spec.resources.items():
            t.admitted[k] = t.admitted.get(k, 0.0) + v

    def release_admission(self, task_id: bytes) -> None:
        """Final completion/failure (or permanent actor death, or PG
        removal): return the quota charge and wake the admission
        queue. Idempotent. Prunes the tenant once it is fully idle
        with no registered jobs left (a conn that dropped mid-flight
        must not orphan its TenantEntry — and its gauge — forever)."""
        charge = self._admitted.pop(task_id, None)
        if charge is None:
            return
        tenant_name, resources = charge
        t = self.tenants.get(tenant_name)
        if t is None:
            return
        for k, v in resources.items():
            t.admitted[k] = max(0.0, t.admitted.get(k, 0.0) - v)
        if (
            not t.parked
            and not any(v > 1e-9 for v in t.admitted.values())
            and not any(
                j.tenant == tenant_name for j in self.jobs.values()
            )
        ):
            del self.tenants[tenant_name]

    def pop_admissible(self) -> List[Any]:
        """Parked specs that now fit their tenant's quota, in FIFO
        order per tenant (head-of-queue only: quota order is part of
        the fairness contract)."""
        out: List[Any] = []
        for t in self.tenants.values():
            while t.parked and self._fits_quota(t, t.parked[0].resources):
                spec = t.parked.popleft()
                self._charge_admission(t, spec)
                out.append(spec)
        return out

    def pop_infeasible(self, tenant_name: str) -> List[Any]:
        """Parked specs that exceed the tenant's CURRENT quota outright
        (possible after a re-registration lowered it): remove and
        return them so the hub can fail them loudly — left in place
        they would wedge the FIFO queue forever."""
        t = self.tenants.get(tenant_name)
        if t is None or not t.quota:
            return []
        bad = [
            s for s in t.parked
            if any(
                s.resources.get(k, 0.0) > cap + 1e-9
                for k, cap in t.quota.items()
            )
        ]
        for s in bad:
            t.parked.remove(s)
        return bad

    def unpark(self, spec) -> bool:
        """Remove a parked spec (cancellation path)."""
        for t in self.tenants.values():
            try:
                t.parked.remove(spec)
                return True
            except ValueError:
                continue
        return False

    def parked_count(self) -> int:
        return sum(len(t.parked) for t in self.tenants.values())

    def parked_specs(self) -> List[Any]:
        return [s for t in self.tenants.values() for s in t.parked]

    # ------------------------------------------------------ usage accounting
    def charge_dispatch(self, spec) -> None:
        """A task left the queue for a worker: start its fair-share
        interval (actors keep it open for their whole lifetime)."""
        if not self.tenants or spec.task_id in self._running:
            return
        tenant_name = self.tenant_of(spec.options)
        job = self.jobs.get(spec.options.get("job_id") or "")
        if job is not None:
            job.dispatched += 1
        if tenant_name not in self.tenants:
            return  # unregistered tenant: no fair-share state to keep
        t = self.tenants[tenant_name]
        w = _work(spec.resources)
        self._fold(t)
        t.rate += w
        self._running[spec.task_id] = (tenant_name, w)

    def settle(self, task_id: bytes) -> None:
        """The task's resources were released (done, failed, retried,
        preempted, actor died): close its fair-share interval."""
        rec = self._running.pop(task_id, None)
        if rec is None:
            return
        tenant_name, w = rec
        t = self.tenants.get(tenant_name)
        if t is None:
            return
        self._fold(t)
        t.rate = max(0.0, t.rate - w)

    def _fold(self, t: TenantEntry) -> None:
        now = self.clock()
        t.usage_s = t.live_usage(now)
        t.rate_since = now

    # -------------------------------------------------------------- ordering
    def class_order_key(self, sched_class: tuple):
        """Sort key for runnable scheduling classes: higher priority
        first, then the tenant furthest below its weighted fair share.
        The class tuple ends with (..., tenant, priority) — see
        Hub._sched_class. Python's sort is stable, so equal keys keep
        queue insertion order (single-tenant behavior is unchanged)."""
        tenant, priority = sched_class[-2], sched_class[-1]
        t = self.tenants.get(tenant)
        deficit = 0.0
        if t is not None:
            deficit = t.live_usage(self.clock()) / t.weight()
        return (-priority, deficit)

    # ------------------------------------------------------------ preemption
    def preemption_victims(
        self,
        beneficiary_priority: int,
        need_chips: int,
        max_bundle: Dict[str, float],
        need_resources: Dict[str, float],
        ready_pgs: List[Any],
        running_tasks: List[Tuple[Any, Any]],
        free_chips_by_node: Dict[str, int],
        avail_by_node: Dict[str, Dict[str, float]],
    ) -> Tuple[List[Any], List[Tuple[Any, Any]]]:
        """Select victim gangs for a reservation that cannot fit.

        Candidates are ready placement groups and running plain tasks
        whose priority is STRICTLY below the beneficiary's; gangs are
        whole PGs (never individual bundles). Lowest priority bleeds
        first; within a priority, single tasks die before whole gangs
        (one retry loses less work than a gang restart), and among
        gangs the newest dies first (LIFO — the least sunk cost).
        Selection is greedy
        and NODE-AWARE: it stops once (a) cluster-wide freed
        chips+resources close the whole-gang gap AND (b) some single
        node can seat the LARGEST bundle whole — chips and its other
        resources co-located. Two 2-chip victims on different hosts
        cannot seat a 4-chip single-node bundle, and shedding them
        would be work lost for naught; if no victim set reaches
        feasibility, nothing is preempted. (Multi-bundle packing and
        ICI fragmentation within a node are still approximated; the
        reservation retry is the authority, and the hub's
        preempt-rounds cap bounds repeated misestimates.)
        Returns (victim_pgs, victim_tasks)."""
        cands: List[Tuple[tuple, str, Any]] = []
        for pg in ready_pgs:
            pri = int(getattr(pg, "priority", 0) or 0)
            if pri >= beneficiary_priority:
                continue
            # gangs sort AFTER single tasks within a priority (a whole
            # PG restart loses far more work than one task retry);
            # among gangs the newest dies first
            cands.append(((pri, 1, -getattr(pg, "seq", 0)), "pg", pg))
        for worker, spec in running_tasks:
            pri = self.priority_of(spec.options)
            if pri >= beneficiary_priority:
                continue
            cands.append(((pri, 0, 0), "task", (worker, spec)))
        cands.sort(key=lambda c: c[0])
        free_by_node = dict(free_chips_by_node)
        freed_res: Dict[str, Dict[str, float]] = {}
        avail_total: Dict[str, float] = {}
        for av in avail_by_node.values():
            for k, v in av.items():
                avail_total[k] = avail_total.get(k, 0.0) + v
        res_gap = {
            k: v - avail_total.get(k, 0.0)
            for k, v in need_resources.items()
            if k != "GPU" and v > avail_total.get(k, 0.0) + 1e-9
        }
        max_bundle_chips = int(max_bundle.get("GPU", 0))

        def feasible() -> bool:
            if res_gap:
                return False
            if need_chips > 0 and sum(free_by_node.values()) < need_chips:
                return False
            # co-location: one node must seat the largest bundle whole
            for nid in set(free_by_node) | set(avail_by_node):
                if free_by_node.get(nid, 0) < max_bundle_chips:
                    continue
                av = avail_by_node.get(nid, {})
                fr = freed_res.get(nid, {})
                if all(
                    av.get(k, 0.0) + fr.get(k, 0.0) >= v - 1e-9
                    for k, v in max_bundle.items()
                    if k != "GPU"
                ):
                    return True
            return False

        def take(nid: str, chips: int, resources: Dict[str, float]) -> None:
            free_by_node[nid] = free_by_node.get(nid, 0) + chips
            node_res = freed_res.setdefault(nid, {})
            for k, v in resources.items():
                if k == "GPU":
                    continue
                node_res[k] = node_res.get(k, 0.0) + v
                if k in res_gap:
                    res_gap[k] -= v
                    if res_gap[k] <= 1e-9:
                        del res_gap[k]

        def useful(chips: int, resources: Dict[str, float]) -> bool:
            # a victim must free something the reservation actually
            # lacks: chips, or a resource still in the cluster-wide
            # gap. (Freeing co-location-only resources on exactly the
            # chip node is NOT chased — conservatively preempting
            # nothing beats killing innocents on the wrong node.)
            if chips > 0:
                return True
            return any(k in res_gap for k in resources)

        victim_pgs: List[Any] = []
        victim_tasks: List[Tuple[Any, Any]] = []
        for _key, kind, victim in cands:
            if feasible():
                break
            if kind == "pg":
                pg = victim
                # chips freed per bundle: the reserved SLICE chunk when
                # there is one, else the bundle's TPU request —
                # PACK/SPREAD gangs hold chips through node avail and
                # worker pins, not bundle_chips, and must still be
                # creditable victims
                chunks = pg.bundle_chips or [()] * len(pg.bundles)
                freed = [
                    (b, nid, max(len(chunk), int(b.get("GPU", 0))))
                    for b, nid, chunk in zip(
                        pg.bundles, pg.bundle_nodes, chunks
                    )
                ]
                if not any(useful(c, b) for b, _, c in freed):
                    continue  # frees nothing the gap needs
                victim_pgs.append(pg)
                for b, nid, chips in freed:
                    take(nid, chips, b)
            else:
                worker, spec = victim
                freed_chips = len(worker.pinned_chips or ())
                if not useful(freed_chips, spec.resources):
                    continue
                victim_tasks.append(victim)
                take(worker.node_id, freed_chips, spec.resources)
        if not feasible():
            # even preempting every lower-priority gang cannot fit the
            # reservation: preempt nothing (don't shed work for naught)
            return [], []
        return victim_pgs, victim_tasks

    def note_preemption(self, options: dict) -> None:
        self.preemptions += 1
        t = self.tenants.get(self.tenant_of(options))
        if t is not None:
            t.n_preempted += 1
        job = self.jobs.get(options.get("job_id") or "")
        if job is not None:
            job.preempted += 1

    # ---------------------------------------------------------- introspection
    def job_table(self) -> List[dict]:
        return [
            {
                "job_id": e.job_id,
                "tenant": e.tenant,
                "priority": e.priority,
                "quota": dict(e.quota),
                "submitted": e.submitted,
                "dispatched": e.dispatched,
                "preempted": e.preempted,
            }
            for e in self.jobs.values()
        ]

    def tenant_table(self) -> List[dict]:
        now = self.clock()
        total_rate = sum(t.rate for t in self.tenants.values())
        return [
            {
                "tenant": t.name,
                "quota": dict(t.quota),
                "admitted": {
                    k: v for k, v in t.admitted.items() if v > 1e-9
                },
                "usage_s": round(t.live_usage(now), 6),
                "running_work": t.rate,
                "share": (t.rate / total_rate) if total_rate > 0 else 0.0,
                "pending_quota": len(t.parked),
                "preempted": t.n_preempted,
            }
            for t in self.tenants.values()
        ]
