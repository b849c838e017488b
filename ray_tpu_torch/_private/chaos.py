"""Deterministic fault-injection plane.

One seeded engine replaces the scattered ``RAY_TPU_TORCH_CHAOS_*`` env
parsers (the probabilistic hub drop hook and the object agent's bespoke
``close_after`` parser). The reference gets the same property from
``src/ray/rpc/rpc_chaos.h`` (env-selected per-method RPC failure); the
schedule-determinism discipline follows FoundationDB-style simulation
testing: a fault plan plus a seed IS the failure scenario, so a soak
run that finds a bug is reproducible by re-running the same plan.

Plan grammar (``RAY_TPU_TORCH_CHAOS_PLAN``, ``;``-separated directives)::

    seed=<int>                              rng seed (default 0)
    drop:[scope.]<msg_type>@<p>             drop the message with prob p
    delay:[scope.]<msg_type>@<lo>-<hi>[@p]  delay handling by U(lo, hi)
    dup:[scope.]<msg_type>@<p>              deliver the message twice
    conn_kill:<role>[@<t>]                  kill one client|worker conn at t
    worker_kill:<n>[@<t>]                   SIGKILL n workers at t
    worker_hang:<n>[@<t>]                   SIGSTOP n workers at t (stall,
                                            not death — the watchdog or a
                                            per-task timeout_s must recover)
    partition:<node_id>@<t1>-<t2>           blackhole the node's inbound
                                            (heartbeats AND data) in [t1,t2)
    close_after:<n>                         object agents close every conn
                                            after serving n data chunks
                                            (mid-stream transfer death)
    replica_kill:<dep>[@<t>]                kill one serve replica of the
                                            deployment at t (victim drawn
                                            from the serve rng)
    slow_replica:<dep>@<lo>-<hi>[@p]        inject U(lo, hi) execute
                                            latency into the deployment's
                                            replicas (per request, prob p)
    route_partition:<dep>@<t1>-<t2>         blackhole router replica-list
                                            refresh for the deployment in
                                            [t1,t2) — handles run on their
                                            stale cached set

Durations accept ``10ms``, ``1.5s``, bare seconds, and the ``t+2s``
spelling (the ``t+`` prefix is cosmetic — all times are offsets from
engine arm). Example::

    seed=7;drop:submit_task@0.05;delay:get@10ms-50ms;conn_kill:client@t+2s;\
worker_hang:1;partition:node2@3s-5s

Scopes pick the process that injects the fault: ``hub`` (default — the
message is dropped/delayed/duplicated at the control plane's dispatch
seam, identically under both reactor topologies), ``client`` (a driver
or Ray-Client process intercepts its own outbound sends), ``worker``
(a worker's outbound sends, plus the pseudo message type ``exec`` which
stalls the task body before it runs), and ``agent`` (a node agent's
outbound sends — ``drop:agent.node_heartbeat@1`` is heartbeat
suppression without a full partition). Timed faults (conn_kill,
worker_kill, worker_hang, partition) execute only in the hub. The
``serve`` scope owns the serve-plane verbs: ``replica_kill`` executes
in the serve controller's reconcile loop, ``slow_replica`` in replica
processes, and ``route_partition`` in every routing handle.

Legacy aliases keep working: ``RAY_TPU_TORCH_CHAOS_DROP="get:0.4,..."``
translates to hub ``drop:`` rules and
``RAY_TPU_TORCH_CHAOS_OBJECT_AGENT="close_after:N"`` to ``close_after:N``.

Determinism contract: decisions come from one ``random.Random`` seeded
with ``(seed, scope)``, drawn once per rule-matched message in arrival
order. At hub scope arrivals are processed by a single thread, so an
identical message sequence yields an identical fault sequence; the
timed-fault schedule is a pure function of the plan. With no plan set
every injection point is gated on a cached ``None`` — zero per-message
work.
"""

from __future__ import annotations

import os
import random
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

SCOPES = ("hub", "client", "worker", "agent", "object_agent", "serve")

# timed-fault kinds (hub-executed), in the grammar's spelling
TIMED_KINDS = ("conn_kill", "worker_kill", "worker_hang")
# timed-fault kinds the serve controller executes (serve scope)
SERVE_TIMED_KINDS = ("replica_kill",)


class PlanError(ValueError):
    """Malformed RAY_TPU_TORCH_CHAOS_PLAN directive."""


@dataclass
class Rule:
    """One message-fault rule: drop/delay/dup on a msg_type at a scope."""

    kind: str            # "drop" | "delay" | "dup"
    scope: str           # "hub" | "client" | "worker" | "agent"
    msg_type: str
    prob: float = 1.0
    lo: float = 0.0      # delay window (seconds)
    hi: float = 0.0


@dataclass
class TimedFault:
    """One scheduled fault: fires once at ``at`` seconds after arm.
    ``arg`` is the victim selector (conn role, or worker count)."""

    kind: str            # "conn_kill" | "worker_kill" | "worker_hang"
    at: float
    arg: str = ""
    count: int = 1
    fired: int = 0       # victims already taken (worker_kill:3 fires 3x)


@dataclass
class Plan:
    seed: int = 0
    rules: List[Rule] = field(default_factory=list)
    timed: List[TimedFault] = field(default_factory=list)
    partitions: Dict[str, List[Tuple[float, float]]] = field(
        default_factory=dict
    )
    # deployment -> blackhole windows for router replica-list refresh
    route_partitions: Dict[str, List[Tuple[float, float]]] = field(
        default_factory=dict
    )
    close_after: int = 0
    text: str = ""


def _duration(tok: str) -> float:
    """'10ms' / '1.5s' / '2' / 't+2s' -> seconds."""
    tok = tok.strip()
    if tok.startswith("t+"):
        tok = tok[2:]
    try:
        if tok.endswith("ms"):
            return float(tok[:-2]) / 1000.0
        if tok.endswith("s"):
            return float(tok[:-1])
        return float(tok)
    except ValueError:
        raise PlanError(f"bad duration {tok!r}") from None


def _window(tok: str) -> Tuple[float, float]:
    """'10ms-50ms' / '3s-5s' -> (lo, hi) seconds."""
    lo, sep, hi = tok.partition("-")
    if not sep:
        raise PlanError(f"expected <lo>-<hi> window, got {tok!r}")
    a, b = _duration(lo), _duration(hi)
    if b < a:
        raise PlanError(f"window {tok!r} ends before it starts")
    return a, b


def _scoped(target: str) -> Tuple[str, str]:
    """'client.get' -> ('client', 'get'); bare 'get' -> ('hub', 'get')."""
    scope, dot, mt = target.partition(".")
    if dot and scope in SCOPES:
        return scope, mt
    return "hub", target


def parse_plan(text: str) -> Plan:
    plan = Plan(text=text.strip())
    for raw in text.split(";"):
        d = raw.strip()
        if not d:
            continue
        if d.startswith("seed="):
            try:
                plan.seed = int(d[5:])
            except ValueError:
                raise PlanError(f"bad seed {d!r}") from None
            continue
        verb, sep, rest = d.partition(":")
        verb = verb.strip()
        if not sep:
            raise PlanError(f"bad directive {d!r}")
        if verb in ("drop", "dup"):
            target, sep2, prob = rest.partition("@")
            scope, mt = _scoped(target.strip())
            if scope == "worker" and mt == "exec":
                # the exec pseudo-type is a stall hook, not a message:
                # there is nothing to drop or duplicate, and silently
                # accepting the rule would record phantom faults
                raise PlanError(
                    f"worker.exec supports only delay: (a stall): {d!r}"
                )
            try:
                p = float(prob) if sep2 else 1.0
            except ValueError:
                raise PlanError(f"bad probability in {d!r}") from None
            plan.rules.append(Rule(verb, scope, mt, prob=p))
        elif verb == "delay":
            parts = rest.split("@")
            if len(parts) < 2:
                raise PlanError(f"delay needs a window: {d!r}")
            scope, mt = _scoped(parts[0].strip())
            lo, hi = _window(parts[1])
            try:
                p = float(parts[2]) if len(parts) > 2 else 1.0
            except ValueError:
                raise PlanError(f"bad probability in {d!r}") from None
            plan.rules.append(Rule("delay", scope, mt, prob=p, lo=lo, hi=hi))
        elif verb == "conn_kill":
            role, _sep2, at = rest.partition("@")
            role = role.strip()
            if role not in ("client", "worker"):
                raise PlanError(f"conn_kill role must be client|worker: {d!r}")
            plan.timed.append(TimedFault(
                "conn_kill", _duration(at) if at else 1.0, arg=role,
            ))
        elif verb in ("worker_kill", "worker_hang"):
            n, _sep2, at = rest.partition("@")
            try:
                count = max(1, int(n))
            except ValueError:
                raise PlanError(f"bad count in {d!r}") from None
            plan.timed.append(TimedFault(
                verb, _duration(at) if at else 1.0, count=count,
            ))
        elif verb == "partition":
            node, sep2, win = rest.partition("@")
            if not sep2:
                raise PlanError(f"partition needs @<t1>-<t2>: {d!r}")
            plan.partitions.setdefault(node.strip(), []).append(_window(win))
        elif verb == "replica_kill":
            dep, _sep2, at = rest.partition("@")
            dep = dep.strip()
            if not dep:
                raise PlanError(f"replica_kill needs a deployment: {d!r}")
            plan.timed.append(TimedFault(
                "replica_kill", _duration(at) if at else 1.0, arg=dep,
            ))
        elif verb == "slow_replica":
            parts = rest.split("@")
            dep = parts[0].strip()
            if len(parts) < 2 or not dep:
                raise PlanError(
                    f"slow_replica needs <dep>@<lo>-<hi>: {d!r}"
                )
            lo, hi = _window(parts[1])
            try:
                p = float(parts[2]) if len(parts) > 2 else 1.0
            except ValueError:
                raise PlanError(f"bad probability in {d!r}") from None
            plan.rules.append(
                Rule("slow_replica", "serve", dep, prob=p, lo=lo, hi=hi)
            )
        elif verb == "route_partition":
            dep, sep2, win = rest.partition("@")
            dep = dep.strip()
            if not sep2 or not dep:
                raise PlanError(
                    f"route_partition needs <dep>@<t1>-<t2>: {d!r}"
                )
            plan.route_partitions.setdefault(dep, []).append(_window(win))
        elif verb == "close_after":
            try:
                plan.close_after = max(1, int(rest))
            except ValueError:
                raise PlanError(f"bad close_after in {d!r}") from None
        else:
            raise PlanError(f"unknown chaos verb {verb!r}")
    plan.timed.sort(key=lambda f: f.at)
    return plan


def plan_text_from_env(environ=None) -> str:
    """The effective plan: RAY_TPU_TORCH_CHAOS_PLAN plus the legacy aliases
    (RAY_TPU_TORCH_CHAOS_DROP / RAY_TPU_TORCH_CHAOS_OBJECT_AGENT) appended as
    equivalent directives, so pre-plan deployments keep working."""
    # deliberately env-only (NOT the config table): engines are built
    # in worker/agent/client processes that never run config.reload(),
    # and a plan baked into a stale config snapshot would resurrect
    # faults after the env was cleared. The env var IS the contract.
    env = os.environ if environ is None else environ
    parts = []
    plan = (env.get("RAY_TPU_TORCH_CHAOS_PLAN") or "").strip()
    if plan:
        parts.append(plan)
    legacy_drop = (env.get("RAY_TPU_TORCH_CHAOS_DROP") or "").strip()
    for part in legacy_drop.split(","):
        if ":" in part:
            mt, prob = part.rsplit(":", 1)
            try:
                float(prob)
            except ValueError:
                continue
            parts.append(f"drop:{mt.strip()}@{prob}")
    legacy_agent = (env.get("RAY_TPU_TORCH_CHAOS_OBJECT_AGENT") or "").strip()
    if legacy_agent.startswith("close_after:"):
        try:
            n = int(legacy_agent.split(":", 1)[1])
        except ValueError:
            n = 0
        if n > 0:
            parts.append(f"close_after:{n}")
    return ";".join(parts)


class ChaosEngine:
    """The per-process injection engine: scope-filtered rules from one
    shared plan, a seeded rng, per-fault trigger counters, and a
    bounded recent-event log (surfaced via ``list_state("chaos")`` and
    the ``ray_tpu chaos`` CLI)."""

    def __init__(self, plan_text: str, scope: str = "hub"):
        self.plan = parse_plan(plan_text)
        self.scope = scope
        # scope-filtered rule index: msg_type -> rules, checked per
        # message. Scopes other than this process's contribute nothing.
        # slow_replica rules live in their own index (keyed by
        # deployment, consulted by execute_delay — not a message fault).
        self.rules: Dict[str, List[Rule]] = {}
        self.slow_rules: Dict[str, List[Rule]] = {}
        for r in self.plan.rules:
            if r.scope != scope:
                continue
            if r.kind == "slow_replica":
                self.slow_rules.setdefault(r.msg_type, []).append(r)
            else:
                self.rules.setdefault(r.msg_type, []).append(r)
        if scope == "hub":
            self.timed = [
                f for f in self.plan.timed if f.kind in TIMED_KINDS
            ]
        elif scope == "serve":
            self.timed = [
                f for f in self.plan.timed if f.kind in SERVE_TIMED_KINDS
            ]
        else:
            self.timed = []
        self.partitions = self.plan.partitions if scope == "hub" else {}
        self.route_partitions = (
            self.plan.route_partitions if scope == "serve" else {}
        )
        self.close_after = (
            self.plan.close_after if scope == "object_agent" else 0
        )
        # (seed, scope) keeps sibling processes' draw sequences
        # independent — a worker consuming draws must not shift the
        # hub's schedule
        self.rng = random.Random(f"{self.plan.seed}:{scope}")
        self.counts: Dict[str, int] = {}
        self.events: deque = deque(maxlen=256)
        self._t0: Optional[float] = None

    @property
    def active(self) -> bool:
        """Does this scope have anything to inject? Inactive engines
        are replaced by None so the hot path pays one attribute load."""
        return bool(
            self.rules or self.slow_rules or self.timed
            or self.partitions or self.route_partitions or self.close_after
        )

    # ------------------------------------------------------------ lifecycle
    def arm(self, now: Optional[float] = None) -> None:
        """Start the timed-fault/partition clock (monotonic)."""
        self._t0 = time.monotonic() if now is None else now

    def elapsed(self, now: Optional[float] = None) -> float:
        if self._t0 is None:
            return 0.0
        return (time.monotonic() if now is None else now) - self._t0

    # ------------------------------------------------------------- messages
    def message_action(self, msg_type: str):
        """One decision per matched message: None (pass), ("drop",),
        ("delay", seconds), or ("dup",). Draw order is arrival order,
        so a fixed message sequence yields a fixed fault sequence."""
        rules = self.rules.get(msg_type)
        if not rules:
            return None
        for r in rules:
            if r.prob < 1.0 and self.rng.random() >= r.prob:
                continue
            if r.kind == "drop":
                self.record("drop", msg_type=msg_type)
                return ("drop",)
            if r.kind == "dup":
                self.record("dup", msg_type=msg_type)
                return ("dup",)
            d = r.lo if r.hi <= r.lo else self.rng.uniform(r.lo, r.hi)
            self.record("delay", msg_type=msg_type, delay_s=round(d, 6))
            return ("delay", d)
        return None

    def outbound_send(self, msg_type: str) -> int:
        """message_action applied to an outbound send — the ONE
        decision-to-action mapping every sender scope (client, worker,
        agent) shares: 0 = drop the send, 1 = send, 2 = send twice. A
        delay stalls the calling thread inline (issuance latency, the
        sender-side analogue of a slow link)."""
        act = self.message_action(msg_type)
        if act is None:
            return 1
        kind = act[0]
        if kind == "drop":
            return 0
        if kind == "delay":
            time.sleep(act[1])
            return 1
        return 2

    # --------------------------------------------------------- timed faults
    def due_faults(self, now: Optional[float] = None) -> List[TimedFault]:
        """Timed faults whose deadline passed (left in the schedule;
        the executor pops victims via ``consume``/``defer``)."""
        t = self.elapsed(now)
        return [f for f in self.timed if f.at <= t and f.fired < f.count]

    def consume(self, fault: TimedFault, n: int = 1) -> None:
        fault.fired += n
        if fault.fired >= fault.count:
            try:
                self.timed.remove(fault)
            except ValueError:
                pass

    def defer(self, fault: TimedFault, by: float = 0.25) -> None:
        """No eligible victim yet (e.g. worker_kill before any worker
        spawned): retry the fault a beat later."""
        fault.at = self.elapsed() + by

    def partition_active(self, node_id: str,
                         now: Optional[float] = None) -> bool:
        wins = self.partitions.get(node_id)
        if not wins:
            return False
        t = self.elapsed(now)
        return any(lo <= t < hi for lo, hi in wins)

    # ---------------------------------------------------------- serve scope
    def execute_delay(self, deployment: str) -> float:
        """slow_replica draw for one request on this deployment's
        replica: injected execute latency in seconds (0.0 = none).
        Draws ride the scope rng in arrival order, so a fixed request
        sequence yields a fixed delay sequence."""
        rules = self.slow_rules.get(deployment)
        if not rules:
            return 0.0
        for r in rules:
            if r.prob < 1.0 and self.rng.random() >= r.prob:
                continue
            d = r.lo if r.hi <= r.lo else self.rng.uniform(r.lo, r.hi)
            self.record("slow_replica", deployment=deployment,
                        delay_s=round(d, 6))
            return d
        return 0.0

    def route_partition_active(self, deployment: str,
                               now: Optional[float] = None) -> bool:
        """Is the router-refresh blackhole window open for this
        deployment? Handles keep serving their stale cached replica
        set for the duration."""
        wins = self.route_partitions.get(deployment)
        if not wins:
            return False
        t = self.elapsed(now)
        return any(lo <= t < hi for lo, hi in wins)

    # ------------------------------------------------------------ reporting
    def record(self, kind: str, **fields) -> None:
        self.counts[kind] = self.counts.get(kind, 0) + 1
        ev = {"t": round(self.elapsed(), 4), "kind": kind}
        ev.update(fields)
        self.events.append(ev)

    def snapshot(self) -> dict:
        return {
            "plan": self.plan.text,
            "seed": self.plan.seed,
            "scope": self.scope,
            "armed": self._t0 is not None,
            "elapsed_s": round(self.elapsed(), 3) if self._t0 else 0.0,
            "counts": dict(self.counts),
            "pending_timed": [
                {"kind": f.kind, "at_s": f.at, "arg": f.arg,
                 "count": f.count, "fired": f.fired}
                for f in self.timed
            ],
            "partitions": {
                n: [list(w) for w in wins]
                for n, wins in self.partitions.items()
            },
            "route_partitions": {
                n: [list(w) for w in wins]
                for n, wins in self.route_partitions.items()
            },
            "close_after": self.close_after,
            "events": list(self.events),
        }


def engine_for(scope: str, environ=None) -> Optional[ChaosEngine]:
    """The ONE constructor every injection point uses: returns an armed
    engine when the plan has faults for this scope, else None — the
    cached-None check is the entire cost of an inert fault plane."""
    text = plan_text_from_env(environ)
    if not text:
        return None
    eng = ChaosEngine(text, scope=scope)
    if not eng.active:
        return None
    eng.arm()
    return eng
