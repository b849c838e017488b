"""`python -m ray_tpu_torch` — the cluster CLI.

Parity: the reference's `ray` CLI (python/ray/scripts/scripts.py:
start/stop/status/timeline/memory/debug), the state CLI
(`ray list ...`, python/ray/util/state/state_cli.py) and the job CLI
(`ray job submit/status/logs/stop/list`,
python/ray/dashboard/modules/job/cli.py). One argparse tree, no
external CLI framework.

Port of ``ray_tpu/scripts.py``: ``--num-gpus`` takes the place of
``--num-tpus`` (the head's ``init(num_gpus=...)``, a node agent's
``RAY_TPU_TORCH_NUM_GPUS``), ``status`` shows a ``gpu`` column, and the
head's address and pid live under ``~/.ray_tpu_torch``, so neither
package's ``stop`` reaches the other's head.

    python -m ray_tpu_torch start --head --port 7777        # head (blocks)
    python -m ray_tpu_torch start --address tcp://ip:7777   # join as a node
    python -m ray_tpu_torch status
    python -m ray_tpu_torch list actors
    python -m ray_tpu_torch jobs                            # tenants vs quota
    python -m ray_tpu_torch summary tasks
    python -m ray_tpu_torch trace                           # sampled traces
    python -m ray_tpu_torch trace <trace_id>                # critical path
    python -m ray_tpu_torch chaos                           # fault injection
    python -m ray_tpu_torch timeline --output /tmp/tl.json
    python -m ray_tpu_torch memory --leak-suspects
    python -m ray_tpu_torch stack <worker-id|hub|pid>       # remote stacks
    python -m ray_tpu_torch profile --duration 5 --fold out.txt
    python -m ray_tpu_torch job submit -- python train.py
    python -m ray_tpu_torch job logs <id>
    python -m ray_tpu_torch debug
    python -m ray_tpu_torch stop
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import sys
import time
from typing import List, Optional

_STATE_DIR = os.path.join(os.path.expanduser("~"), ".ray_tpu_torch")
_ADDR_FILE = os.path.join(_STATE_DIR, "head_address")
_PID_FILE = os.path.join(_STATE_DIR, "head_pid")


# ------------------------------------------------------------------ helpers
def _resolve_address(explicit: Optional[str]) -> Optional[str]:
    if explicit:
        return explicit
    env = os.environ.get("RAY_TPU_TORCH_ADDRESS")
    if env:
        return env
    try:
        with open(_ADDR_FILE) as f:
            return f.read().strip() or None
    except OSError:
        return None


def _connect(args) -> None:
    import ray_tpu_torch

    addr = _resolve_address(getattr(args, "address", None))
    if addr is None:
        raise SystemExit(
            "no cluster address: pass --address, set RAY_TPU_TORCH_ADDRESS, or "
            "run `python -m ray_tpu_torch start --head` first"
        )
    ray_tpu_torch.init(address=addr, ignore_reinit_error=True)


def _print_table(rows: List[dict], columns: List[str]) -> None:
    if not rows:
        print("(none)")
        return
    widths = {
        c: max(len(c), *(len(str(r.get(c, ""))) for r in rows)) for c in columns
    }
    header = "  ".join(c.upper().ljust(widths[c]) for c in columns)
    print(header)
    print("-" * len(header))
    for r in rows:
        print("  ".join(str(r.get(c, "")).ljust(widths[c]) for c in columns))


# ------------------------------------------------------------------ commands
def cmd_start(args) -> None:
    os.makedirs(_STATE_DIR, exist_ok=True)
    if args.head:
        import ray_tpu_torch

        if args.hub_shards is not None:
            # the hub reads config at construction; env is the handoff
            os.environ["RAY_TPU_TORCH_HUB_SHARDS"] = str(args.hub_shards)
        ctx = ray_tpu_torch.init(
            num_cpus=args.num_cpus,
            num_gpus=args.num_gpus,
            max_workers=args.max_workers,
            _tcp_hub=True,
            _hub_host=args.host,
            _hub_port=args.port,
        )
        addr = ctx.address_info["address"]
        with open(_ADDR_FILE, "w") as f:
            f.write(addr)
        with open(_PID_FILE, "w") as f:
            f.write(str(os.getpid()))
        print(f"ray_tpu_torch head started at {addr}")
        print("connect with: ray_tpu_torch.init(address=" + repr(addr) + ")")
        print("stop with: python -m ray_tpu_torch stop")

        def _on_sigterm(signum, frame):
            # post-mortem before dying: dump the flight recorder (the
            # hub thread is still alive here), then reuse the Ctrl-C
            # teardown path below
            from ray_tpu_torch._private import worker as _worker

            if _worker._hub is not None:
                try:
                    path = _worker._hub.dump_flight_recorder("sigterm")
                    print(f"flight recorder dumped to {path}", flush=True)
                except Exception:
                    pass
            raise KeyboardInterrupt

        signal.signal(signal.SIGTERM, _on_sigterm)
        # Head blocks for its lifetime (reference: ray start --block; a
        # non-blocking daemonizing head adds nothing on one host where
        # drivers embed the hub in-process anyway). Exits on Ctrl-C /
        # SIGTERM, or when the hub reactor stops — a wire-level
        # SHUTDOWN (`ray_tpu_torch stop` from a remote operator) must bring
        # the whole process down, not leave a zombie head with a dead
        # reactor.
        try:
            from ray_tpu_torch._private import worker as _worker

            while _worker._hub is not None and _worker._hub.thread.is_alive():
                _worker._hub.thread.join(timeout=3.0)
        except KeyboardInterrupt:
            pass
        finally:
            # Ctrl-C is the normal way to stop a blocking head: leaving
            # the address/pid files behind would point later CLI calls
            # at a dead endpoint (or a recycled pid)
            for path in (_PID_FILE, _ADDR_FILE):
                try:
                    os.unlink(path)
                except OSError:
                    pass
        return
    # join an existing cluster as a node agent (reference: ray start
    # --address=...)
    addr = _resolve_address(args.address)
    if addr is None:
        raise SystemExit("start: need --head or --address tcp://host:port")
    from ray_tpu_torch._private.session import new_session_dir

    node_id = args.node_id or f"cli-node-{os.getpid()}"
    # a pre-set RAY_TPU_TORCH_SESSION_DIR is honored (deployments may point
    # cleanup/co-located tooling at a known path)
    session_dir = os.environ.get("RAY_TPU_TORCH_SESSION_DIR") or new_session_dir(
        f"ray_tpu_torch_{node_id}"
    )
    env = dict(os.environ)
    env.update(
        RAY_TPU_TORCH_HUB_ADDR=addr,
        RAY_TPU_TORCH_NODE_ID=node_id,
        RAY_TPU_TORCH_SESSION_DIR=session_dir,
        RAY_TPU_TORCH_NUM_CPUS=str(args.num_cpus or (os.cpu_count() or 1)),
    )
    if args.num_gpus is not None:
        env["RAY_TPU_TORCH_NUM_GPUS"] = str(args.num_gpus)
    os.execve(
        sys.executable,
        [sys.executable, "-m", "ray_tpu_torch._private.node_agent"],
        env,
    )


def cmd_stop(args) -> None:
    try:
        with open(_PID_FILE) as f:
            pid = int(f.read().strip())
    except (OSError, ValueError):
        # No local pid (the head runs remotely, or another user started
        # it): ask the hub itself over the wire. SHUTDOWN flips the
        # reactor's running flag; the hub tears the session down exactly
        # as it would on SIGINT.
        addr = _resolve_address(getattr(args, "address", None))
        if addr is None:
            raise SystemExit("no recorded head pid (was `start --head` used?)")
        from ._private import protocol as P
        from ._private.client import connect_hub
        from ._private.serialization import dumps_frame

        try:
            conn = connect_hub(addr)
            try:
                conn.send_bytes(dumps_frame((P.SHUTDOWN, {})))
            finally:
                conn.close()
        except OSError as err:
            # dead hub / stale address (e.g. RAY_TPU_TORCH_ADDRESS left
            # exported after the head went down): report, don't
            # traceback — and still drop the stale state files below
            print(f"hub at {addr} unreachable ({err}); nothing to stop")
        else:
            print(f"sent shutdown to hub at {addr}")
        for path in (_PID_FILE, _ADDR_FILE):
            try:
                os.unlink(path)
            except OSError:
                pass
        return
    try:
        os.kill(pid, signal.SIGINT)
        print(f"sent SIGINT to head (pid {pid})")
    except ProcessLookupError:
        print("head already gone")
    for path in (_PID_FILE, _ADDR_FILE):
        try:
            os.unlink(path)
        except OSError:
            pass


def cmd_status(args) -> None:
    import ray_tpu_torch

    _connect(args)
    nodes = ray_tpu_torch.nodes()
    total = ray_tpu_torch.cluster_resources()
    avail = ray_tpu_torch.available_resources()
    print(f"nodes: {len(nodes)}")
    _print_table(
        [
            {
                "node_id": n["node_id"],
                "alive": n["alive"],
                "hostname": n.get("hostname", ""),
                "cpu": n.get("resources", {}).get("CPU", 0),
                "gpu": n.get("resources", {}).get("GPU", 0),
            }
            for n in nodes
        ],
        ["node_id", "alive", "hostname", "cpu", "gpu"],
    )
    print("\nresources (available / total):")
    for key in sorted(total):
        print(f"  {key}: {avail.get(key, 0):g} / {total[key]:g}")


_LIST_COLUMNS = {
    "actors": ["actor_id", "class_name", "state", "name", "pid"],
    "tasks": ["task_id", "name", "state", "worker_id"],
    "workers": ["worker_id", "node_id", "pid", "state"],
    "nodes": ["node_id", "alive", "hostname"],
    "objects": ["object_id", "kind", "size", "owner", "owner_alive",
                "age_s", "pins", "ready", "spilled"],
    "profile": ["pid", "kind", "thread", "stage", "task_name", "samples"],
    "placement_groups": ["pg_id", "state", "strategy"],
    "jobs": ["job_id", "tenant", "priority", "quota", "submitted",
             "dispatched", "preempted"],
    "tenants": ["tenant", "quota", "admitted", "share", "pending_quota"],
    "shards": ["shard", "service", "conns", "accepted", "wakeups",
               "frames_sent", "drain_saturated", "backpressure",
               "processed"],
    "traces": ["trace_id", "root", "n_spans", "duration_s", "processes"],
}


def cmd_list(args) -> None:
    from ray_tpu_torch.util import state as state_api

    _connect(args)
    kind = {"pgs": "placement_groups"}.get(args.kind, args.kind)
    fn = getattr(state_api, f"list_{kind}")
    rows = fn()
    if args.format == "json":
        print(json.dumps(rows, indent=2, default=str))
        return
    cols = _LIST_COLUMNS.get(kind) or (list(rows[0].keys()) if rows else [])
    _print_table(rows, cols)


def cmd_summary(args) -> None:
    from ray_tpu_torch.util import state as state_api

    _connect(args)
    fn = getattr(state_api, f"summarize_{args.kind}")
    print(json.dumps(fn(), indent=2, default=str))


def cmd_events(args) -> None:
    """Flight-recorder runtime events (node up/down, worker exits,
    retries, spills...; reference: `ray list cluster-events`)."""
    from ray_tpu_torch.util import state as state_api

    _connect(args)
    events = state_api.list_events()
    if args.kind:
        events = [e for e in events if e.get("kind") == args.kind]
    if args.format == "json":
        print(json.dumps(events, indent=2, default=str))
        return
    rows = []
    for e in events:
        detail = " ".join(
            f"{k}={v}" for k, v in e.items()
            if k not in ("seq", "ts", "kind")
        )
        rows.append({
            "seq": e.get("seq", ""),
            "time": time.strftime(
                "%H:%M:%S", time.localtime(e.get("ts", 0))
            ),
            "kind": e.get("kind", ""),
            "detail": detail[:120],
        })
    _print_table(rows, ["seq", "time", "kind", "detail"])


def cmd_trace(args) -> None:
    """Distributed runtime traces (util/tracing.py). Without an id:
    list sampled traces. With one: the span table + the critical-path
    breakdown (which stage the time went to)."""
    from ray_tpu_torch.util import state as state_api
    from ray_tpu_torch.util.tracing import analyze_trace

    _connect(args)
    if not args.trace_id:
        rows = state_api.list_traces()
        if args.format == "json":
            print(json.dumps(rows, indent=2, default=str))
            return
        _print_table(
            [
                {
                    "trace_id": r["trace_id"],
                    "root": r.get("root", ""),
                    "spans": r.get("n_spans", 0),
                    "duration_ms": f"{1000 * r.get('duration_s', 0):.1f}",
                    "processes": r.get("processes", 0),
                }
                for r in rows
            ],
            ["trace_id", "root", "spans", "duration_ms", "processes"],
        )
        return
    spans = state_api.get_trace(args.trace_id)
    if not spans:
        raise SystemExit(f"no trace {args.trace_id!r} (evicted, or never "
                         "sampled — set RAY_TPU_TORCH_TRACE_SAMPLE/RAY_TPU_TORCH_TRACING)")
    analysis = analyze_trace(spans)
    if args.format == "json":
        print(json.dumps({"analysis": analysis, "spans": spans},
                         indent=2, default=str))
        return
    t0 = min(s["start"] for s in spans)
    _print_table(
        [
            {
                "at_ms": f"{1000 * (s['start'] - t0):.2f}",
                "dur_ms": f"{1000 * (s['end'] - s['start']):.2f}",
                "name": s.get("name", ""),
                "stage": (s.get("attrs") or {}).get("stage", ""),
                "where": f"{s.get('node_id', '')}/pid={s.get('pid', '')}",
                "span": s.get("span_id", ""),
                "parent": s.get("parent_id") or "",
            }
            for s in sorted(spans, key=lambda s: s["start"])
        ],
        ["at_ms", "dur_ms", "name", "stage", "where", "span", "parent"],
    )
    print(f"\nend-to-end: {1000 * analysis['end_to_end_s']:.2f} ms over "
          f"{len(analysis['processes'])} processes "
          f"({', '.join(analysis['processes'])})")
    print("critical path:")
    for stage, d in analysis["stages"].items():
        print(f"  {stage:<14} {1000 * d['dur_s']:>9.2f} ms  "
              f"{100 * d['share']:5.1f}%")
    print(f"  {'(untracked)':<14} {1000 * analysis['untracked_s']:>9.2f} ms")
    if analysis["dominant_stage"]:
        print(f"dominant stage: {analysis['dominant_stage']}")


def cmd_chaos(args) -> None:
    """Fault-injection plane: the active chaos plan, per-fault trigger
    counts, and recent fault events (chaos.py; RAY_TPU_TORCH_CHAOS_PLAN)."""
    from ray_tpu_torch.util import state as state_api

    _connect(args)
    rows = state_api.list_chaos()
    if args.format == "json":
        print(json.dumps(rows, indent=2, default=str))
        return
    plan_rows = [r for r in rows if "plan" in r]
    events = [r for r in rows if "kind" in r]
    if not plan_rows:
        print("no chaos plan active (set RAY_TPU_TORCH_CHAOS_PLAN on the head)")
    for r in plan_rows:
        print(f"plan: {r['plan']}")
        print(f"seed: {r['seed']}  armed: {r['armed']}  "
              f"elapsed: {r.get('elapsed_s', 0):.1f}s")
        counts = r.get("counts") or {}
        if counts:
            print("trigger counts:")
            for k in sorted(counts):
                print(f"  {k:<18} {counts[k]}")
        pend = r.get("pending_timed") or []
        if pend:
            print("pending timed faults:")
            for f in pend:
                print(f"  {f['kind']}@{f['at_s']}s "
                      f"({f['fired']}/{f['count']} fired)")
        parts = r.get("partitions") or {}
        if parts:
            print(f"partitions: {parts}")
    if events:
        print("\nrecent fault events:")
        _print_table(
            [
                {
                    "seq": e.get("seq", ""),
                    "kind": e.get("kind", ""),
                    "detail": " ".join(
                        f"{k}={v}" for k, v in e.items()
                        if k not in ("seq", "ts", "kind")
                    )[:100],
                }
                for e in events[-30:]
            ],
            ["seq", "kind", "detail"],
        )


def cmd_jobs(args) -> None:
    """Multi-tenant scheduler view: per-tenant usage vs quota plus the
    registered job table (fairsched). Quota units are hub resource
    units — whole GPUs, CPU cores, 'memory' bytes."""
    from ray_tpu_torch.util import state as state_api

    _connect(args)
    tenants = state_api.list_tenants()
    jobs = state_api.list_jobs()
    if args.format == "json":
        print(json.dumps({"tenants": tenants, "jobs": jobs}, indent=2,
                         default=str))
        return

    def _res(d):
        return ",".join(f"{k}={v:g}" for k, v in sorted(d.items())) or "-"

    print("tenants:")
    _print_table(
        [
            {
                "tenant": t["tenant"],
                "quota": _res(t.get("quota", {})),
                "in_use": _res(t.get("admitted", {})),
                "share": f"{t.get('share', 0.0):.2f}",
                "usage_s": f"{t.get('usage_s', 0.0):.1f}",
                "pending_quota": t.get("pending_quota", 0),
                "preempted": t.get("preempted", 0),
            }
            for t in tenants
        ],
        ["tenant", "quota", "in_use", "share", "usage_s",
         "pending_quota", "preempted"],
    )
    print("\njobs:")
    _print_table(
        [
            {
                "job_id": j["job_id"],
                "tenant": j["tenant"],
                "priority": j["priority"],
                "quota": _res(j.get("quota", {})),
                "submitted": j.get("submitted", 0),
                "dispatched": j.get("dispatched", 0),
                "preempted": j.get("preempted", 0),
            }
            for j in jobs
        ],
        ["job_id", "tenant", "priority", "quota", "submitted",
         "dispatched", "preempted"],
    )


def _parse_quota(spec: Optional[str]) -> dict:
    """'GPU=1,CPU=8' -> {'GPU': 1.0, 'CPU': 8.0} (also accepts JSON)."""
    if not spec:
        return {}
    spec = spec.strip()
    bad = SystemExit(
        f"--quota: expected RESOURCE=AMOUNT[,...] or a JSON object, "
        f"got {spec!r}"
    )
    if spec.startswith("{"):
        try:
            return {str(k): float(v) for k, v in json.loads(spec).items()}
        except (ValueError, TypeError, AttributeError):
            raise bad from None
    out = {}
    for part in spec.split(","):
        if not part.strip():
            continue
        k, eq, v = part.partition("=")
        if not eq or not k.strip():
            raise bad
        try:
            out[k.strip()] = float(v)
        except ValueError:
            raise bad from None
    return out


def cmd_timeline(args) -> None:
    import ray_tpu_torch

    _connect(args)
    events = ray_tpu_torch.timeline()
    out = args.output or "ray_tpu_torch_timeline.json"
    with open(out, "w") as f:
        json.dump(events, f)
    print(f"wrote {len(events)} events to {out} (chrome://tracing format)")


def cmd_memory(args) -> None:
    """Object-store view with leak attribution: one row per object
    (owner process, age, size, pins) plus the aggregate summary.
    --leak-suspects keeps only ready objects whose owner is GONE and
    that nothing pins — refs no live process can ever release."""
    from ray_tpu_torch.util import state as state_api

    _connect(args)
    objects = state_api.list_objects()
    if args.leak_suspects:
        objects = state_api.leak_suspects(
            min_age_s=args.min_age, objects=objects
        )
    if args.format == "json":
        print(json.dumps(
            {"objects": objects,
             "summary": state_api.summarize_objects()},
            indent=2, default=str,
        ))
        return
    rows = [
        {
            "object_id": o.get("object_id", "")[:16],
            "kind": o.get("kind", ""),
            "size": o.get("size", 0),
            "owner": o.get("owner") or "?",
            "alive": "yes" if o.get("owner_alive", True) else "NO",
            "age_s": f"{o.get('age_s', 0.0):.1f}",
            "pins": o.get("pins", 0),
            "ready": o.get("ready"),
            "spilled": o.get("spilled"),
        }
        for o in sorted(
            objects, key=lambda o: o.get("age_s", 0.0), reverse=True
        )
    ]
    _print_table(rows, ["object_id", "kind", "size", "owner", "alive",
                        "age_s", "pins", "ready", "spilled"])
    summary = state_api.summarize_objects()
    print(
        f"\n{summary['ready']}/{summary['total']} ready, "
        f"{summary['total_size_bytes']} bytes, "
        f"{summary['spilled']} spilled, "
        f"{summary['leak_suspects']} leak suspect(s)"
    )


def cmd_stack(args) -> None:
    """On-demand all-thread stack dump of the hub or a worker — the
    profiler does not need to be on (reference: `ray stack`)."""
    from ray_tpu_torch.util import profiler as prof_api

    _connect(args)
    reply = prof_api.stack(args.target, timeout=args.timeout)
    sys.stdout.write(prof_api.format_stack(reply))
    if reply.get("error"):
        raise SystemExit(1)


def cmd_profile(args) -> None:
    """Window the cluster-wide sampling profiler over --duration
    seconds and report: a stage/task/thread top table, and/or the raw
    flamegraph collapsed stacks (--fold FILE, '-' for stdout)."""
    from ray_tpu_torch.util import profiler as prof_api

    _connect(args)
    print(f"profiling for {args.duration:.1f}s ...", file=sys.stderr)
    rows = prof_api.profile(args.duration)
    samples = [r for r in rows if not r.get("proc")]
    procs = prof_api.overhead(rows)
    if not samples:
        print(
            "no samples collected. Is the profiler on? Start the "
            "cluster with RAY_TPU_TORCH_PROFILE_HZ=<rate> (e.g. 50) — the "
            "sampler is off by default.",
            file=sys.stderr,
        )
        raise SystemExit(1)
    if args.fold:
        lines = prof_api.fold_lines(samples)
        if args.fold == "-":
            sys.stdout.write("\n".join(lines) + "\n")
        else:
            with open(args.fold, "w") as f:
                f.write("\n".join(lines) + "\n")
            print(f"wrote {len(lines)} folded stacks to {args.fold}")
    if args.top or not args.fold:
        by = args.top or "stage"
        total = sum(r.get("samples", 0) for r in samples)
        print(f"\n{total} samples by {by}:")
        _print_table(
            [
                dict(r, share=f"{r['share'] * 100:.1f}%")
                for r in prof_api.top(samples, by=by, n=args.limit)
            ],
            [by, "samples", "share"],
        )
    if procs:
        print("\nsamplers:")
        _print_table(
            [
                {
                    "pid": m.get("pid"), "kind": m.get("kind"),
                    "hz": m.get("hz"),
                    "overhead": f"{m.get('overhead', 0.0) * 100:.2f}%",
                    "drops": m.get("drops", 0),
                }
                for m in procs
            ],
            ["pid", "kind", "hz", "overhead", "drops"],
        )


def cmd_job(args) -> None:
    from ray_tpu_torch.job_submission import JobSubmissionClient

    addr = _resolve_address(args.address)
    if addr is None:
        # without this guard JobSubmissionClient would silently boot a
        # throwaway in-process cluster that dies when the CLI exits
        raise SystemExit(
            "no cluster address: pass --address, set RAY_TPU_TORCH_ADDRESS, or "
            "run `python -m ray_tpu_torch start --head` first"
        )
    client = JobSubmissionClient(address=addr)
    if args.job_cmd == "submit":
        import shlex

        # shlex.join: argv elements with spaces/parens must survive the
        # shell the job supervisor execs the entrypoint with
        entrypoint = shlex.join(args.entrypoint)
        if not entrypoint:
            raise SystemExit("job submit: pass the entrypoint after --")
        job_id = client.submit_job(
            entrypoint=entrypoint,
            tenant=args.tenant,
            priority=args.priority,
            # tri-state: omitted --quota keeps the tenant's cap;
            # an explicit empty spec ("{}") lifts it
            quota=_parse_quota(args.quota) if args.quota is not None
            else None,
        )
        print(job_id)
        if args.wait:
            status = client.wait_until_finished(job_id, timeout=args.timeout)
            print(status)
            sys.stdout.write(client.get_job_logs(job_id))
            if status != "SUCCEEDED":
                raise SystemExit(1)
    elif args.job_cmd == "status":
        print(client.get_job_status(args.job_id))
    elif args.job_cmd == "logs":
        sys.stdout.write(client.get_job_logs(args.job_id))
    elif args.job_cmd == "list":
        _print_table(
            client.list_jobs(), ["submission_id", "status", "entrypoint"]
        )
    elif args.job_cmd == "stop":
        print(client.stop_job(args.job_id))


def cmd_serve(args) -> None:
    """Serve-plane SLO status: one row per (deployment, route) with
    request/error/timeout counts, latency percentiles estimated from
    the hub's histogram buckets, live load gauges, batch efficiency,
    the drain-vs-drop teardown counters, and the overload/resilience
    counters (shed admissions, expired deadlines, replica ejections)."""
    from ray_tpu_torch.util import state as state_api

    _connect(args)
    summary = state_api.summarize_serve()
    if args.format == "json":
        print(json.dumps(summary, indent=2, default=str))
        return

    def _ms(v):
        return f"{v * 1000:.1f}" if v is not None else "-"

    rows = []
    for name, dep in sorted(summary["deployments"].items()):
        for route, r in sorted(dep["routes"].items()):
            lat = r["latency_s"] or {}
            rows.append({
                "deployment": name,
                "route": route or "-",
                "requests": r["requests"],
                "errors": r["errors"],
                "timeouts": r["timeouts"],
                "p50_ms": _ms(lat.get("p50")),
                "p95_ms": _ms(lat.get("p95")),
                "p99_ms": _ms(lat.get("p99")),
                "replicas": dep["replicas"],
                "ongoing": dep["ongoing"],
                "queued": dep["queued"],
                "batch_eff": (
                    f"{dep['batch_efficiency']:.2f}"
                    if dep["batch_efficiency"] is not None
                    else "-"
                ),
                "drained": dep["drained"],
                "dropped": dep["dropped"],
                "shed": dep.get("shed", 0),
                "expired": dep.get("expired", 0),
                "ejections": dep.get("ejections", 0),
            })
    if not rows:
        print("no serve metrics recorded (is a deployment running?)")
        return
    _print_table(rows, [
        "deployment", "route", "requests", "errors", "timeouts",
        "p50_ms", "p95_ms", "p99_ms", "replicas", "ongoing", "queued",
        "batch_eff", "drained", "dropped", "shed", "expired", "ejections",
    ])


def cmd_debug(args) -> None:
    from ray_tpu_torch.util import rpdb

    _connect(args)
    bps = rpdb.list_breakpoints()
    if not bps:
        print("no active breakpoints")
        return
    for i, bp in enumerate(bps):
        print(f"[{i}] {bp['uuid']} pid={bp['pid']} {bp['host']}:{bp['port']}")
    choice = 0
    if len(bps) > 1 and sys.stdin.isatty():
        choice = int(input("attach to which breakpoint? ") or "0")
    print(f"attaching to {bps[choice]['uuid']} (Ctrl-D to detach)")
    rpdb.connect(bps[choice]["uuid"])


# ------------------------------------------------------------------ parser
def _build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="ray_tpu_torch", description=__doc__)
    sub = p.add_subparsers(dest="cmd", required=True)

    def add_address(sp):
        sp.add_argument("--address", default=None, help="tcp://host:port")

    sp = sub.add_parser("start", help="start a head or join as a node")
    sp.add_argument("--head", action="store_true")
    sp.add_argument("--host", default="0.0.0.0")
    sp.add_argument("--port", type=int, default=0,
                    help="head listen port (0 = ephemeral)")
    sp.add_argument("--num-cpus", type=int, default=None)
    sp.add_argument("--num-gpus", type=int, default=None)
    sp.add_argument("--max-workers", type=int, default=None)
    sp.add_argument("--hub-shards", type=int, default=None,
                    help="reactor shard count for the head's control "
                         "plane (0/unset = auto: min(4, cpu count); "
                         "1 = single-reactor)")
    sp.add_argument("--node-id", default=None)
    add_address(sp)
    sp.set_defaults(fn=cmd_start)

    sp = sub.add_parser("stop", help="stop the head started by this CLI")
    add_address(sp)
    sp.set_defaults(fn=cmd_stop)

    sp = sub.add_parser("status", help="cluster nodes + resources")
    add_address(sp)
    sp.set_defaults(fn=cmd_status)

    sp = sub.add_parser("list", help="list cluster state")
    sp.add_argument(
        "kind",
        choices=["actors", "tasks", "workers", "nodes", "objects",
                 "placement_groups", "pgs", "jobs", "tenants", "shards",
                 "traces", "chaos", "profile"],
    )
    sp.add_argument("--format", choices=["table", "json"], default="table")
    add_address(sp)
    sp.set_defaults(fn=cmd_list)

    sp = sub.add_parser("summary", help="aggregate state summaries")
    sp.add_argument("kind", choices=["tasks", "actors", "objects"])
    add_address(sp)
    sp.set_defaults(fn=cmd_summary)

    sp = sub.add_parser("events", help="flight-recorder runtime events")
    sp.add_argument("--kind", default=None,
                    help="filter by event kind (e.g. node_down)")
    sp.add_argument("--format", choices=["table", "json"], default="table")
    add_address(sp)
    sp.set_defaults(fn=cmd_events)

    sp = sub.add_parser(
        "jobs", help="multi-tenant scheduler: tenants (usage vs quota) "
                     "+ registered jobs"
    )
    sp.add_argument("--format", choices=["table", "json"], default="table")
    add_address(sp)
    sp.set_defaults(fn=cmd_jobs)

    sp = sub.add_parser(
        "chaos", help="fault-injection plane: active plan, trigger "
                      "counts, recent fault events"
    )
    sp.add_argument("--format", choices=["table", "json"], default="table")
    add_address(sp)
    sp.set_defaults(fn=cmd_chaos)

    sp = sub.add_parser(
        "trace", help="distributed runtime traces: list, or one trace's "
                      "spans + critical-path breakdown"
    )
    sp.add_argument("trace_id", nargs="?", default=None)
    sp.add_argument("--format", choices=["table", "json"], default="table")
    add_address(sp)
    sp.set_defaults(fn=cmd_trace)

    sp = sub.add_parser("timeline", help="dump chrome://tracing timeline")
    sp.add_argument("--output", default=None)
    add_address(sp)
    sp.set_defaults(fn=cmd_timeline)

    sp = sub.add_parser(
        "memory", help="object store: per-object owner/age/size rows "
                       "+ leak suspects"
    )
    sp.add_argument("--leak-suspects", action="store_true",
                    help="only ready objects whose owner process is "
                         "gone and that no in-flight task pins")
    sp.add_argument("--min-age", type=float, default=60.0,
                    help="leak-suspect age floor in seconds")
    sp.add_argument("--format", choices=["table", "json"], default="table")
    add_address(sp)
    sp.set_defaults(fn=cmd_memory)

    sp = sub.add_parser(
        "stack", help="all-thread stack dump of the hub or a worker "
                      "(no profiler needed)"
    )
    sp.add_argument("target", nargs="?", default="hub",
                    help='"hub" (default), a worker id (prefix ok), '
                         "or a worker pid")
    sp.add_argument("--timeout", type=float, default=10.0)
    add_address(sp)
    sp.set_defaults(fn=cmd_stack)

    sp = sub.add_parser(
        "profile", help="sample the cluster for N seconds and report "
                        "folded stacks / stage tops (needs "
                        "RAY_TPU_TORCH_PROFILE_HZ > 0)"
    )
    sp.add_argument("--duration", type=float, default=5.0)
    sp.add_argument("--fold", default=None, metavar="FILE",
                    help="write flamegraph collapsed stacks ('-' = "
                         "stdout)")
    sp.add_argument("--top", default=None,
                    choices=["stage", "task", "thread", "kind", "stack"],
                    help="aggregate table dimension (default: stage "
                         "when --fold is not given)")
    sp.add_argument("--limit", type=int, default=20,
                    help="top-table row cap")
    add_address(sp)
    sp.set_defaults(fn=cmd_profile)

    sp = sub.add_parser("job", help="job submission")
    jsub = sp.add_subparsers(dest="job_cmd", required=True)
    j = jsub.add_parser("submit")
    j.add_argument("--wait", action="store_true")
    j.add_argument("--timeout", type=float, default=600.0)
    j.add_argument("--tenant", default=None,
                   help="fairsched tenant the job's work is accounted to")
    j.add_argument("--priority", type=int, default=None,
                   help="integer scheduling priority (higher wins)")
    j.add_argument("--quota", default=None,
                   help='resource quota, "GPU=1,CPU=8" or JSON')
    j.add_argument("entrypoint", nargs=argparse.REMAINDER)
    add_address(j)
    for name in ("status", "logs", "stop"):
        j = jsub.add_parser(name)
        j.add_argument("job_id")
        add_address(j)
    j = jsub.add_parser("list")
    add_address(j)
    sp.set_defaults(fn=cmd_job)

    sp = sub.add_parser(
        "serve", help="serve-plane SLOs: per-deployment/per-route "
                      "request counts, latency percentiles, batch "
                      "efficiency"
    )
    ssub = sp.add_subparsers(dest="serve_cmd", required=True)
    s = ssub.add_parser("status", help="per-deployment SLO table")
    s.add_argument("--format", choices=["table", "json"], default="table")
    add_address(s)
    s.set_defaults(fn=cmd_serve)

    sp = sub.add_parser("debug", help="attach to a remote breakpoint")
    add_address(sp)
    sp.set_defaults(fn=cmd_debug)

    return p


def main(argv: Optional[List[str]] = None) -> None:
    args = _build_parser().parse_args(argv)
    # strip a leading "--" from REMAINDER entrypoints
    if getattr(args, "entrypoint", None) and args.entrypoint[0] == "--":
        args.entrypoint = args.entrypoint[1:]
    args.fn(args)


if __name__ == "__main__":
    main()
