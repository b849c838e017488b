"""Cluster-wide profiler surface: folded stacks, tops, remote dumps.

Parity: `ray stack` / py-spy dashboards (reference: dashboard/modules/
reporter's profiling endpoints) re-done over the hub's own aggregation
point. Every runtime process runs the in-process sampler from
``ray_tpu_torch._private.profiling`` (opt-in via RAY_TPU_TORCH_PROFILE_HZ); batches
fold at the hub; this module is the read side:

- :func:`snapshot` — the raw folded rows (list_state("profile")).
- :func:`profile` — window a snapshot pair over ``duration_s`` and diff
  them, so the report covers exactly the window (the hub's table is
  cumulative). Backs ``ray_tpu_torch profile``.
- :func:`fold_lines` — flamegraph collapsed format, one
  ``prefix;stack count`` line per row, ready for flamegraph.pl /
  speedscope.
- :func:`top` — aggregate sample counts by stage / task / thread /
  stack for a terminal table.
- :func:`stack` — on-demand all-thread stack dump of the hub or a
  worker (works with the profiler OFF).
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Tuple


def _client():
    from ray_tpu_torch._private import worker

    return worker.get_client()


# rows are keyed by everything except the sample count
_KEY = ("pid", "kind", "thread", "stage", "task_id", "stack")


def _row_key(row: dict) -> Tuple:
    return tuple(row.get(k) for k in _KEY)


def snapshot() -> List[dict]:
    """Cumulative folded samples from the hub (+ per-process meta rows
    flagged ``proc=True``). Empty when no sampler is running."""
    return _client().list_state("profile")


def diff(before: List[dict], after: List[dict]) -> List[dict]:
    """Sample-count delta between two snapshots — the activity that
    happened in between. Meta rows pass through from ``after``."""
    base: Dict[Tuple, int] = {}
    for row in before:
        if not row.get("proc"):
            base[_row_key(row)] = row.get("samples", 0)
    out: List[dict] = []
    for row in after:
        if row.get("proc"):
            out.append(dict(row))
            continue
        delta = row.get("samples", 0) - base.get(_row_key(row), 0)
        if delta > 0:
            out.append(dict(row, samples=delta))
    return out


def profile(duration_s: float = 5.0) -> List[dict]:
    """Collect ``duration_s`` seconds of cluster profile: snapshot,
    wait, snapshot, diff. Requires a sampler to be on somewhere
    (RAY_TPU_TORCH_PROFILE_HZ > 0) — with none running both snapshots are
    empty and so is the result."""
    before = snapshot()
    time.sleep(max(0.0, float(duration_s)))
    return diff(before, snapshot())


def fold_lines(rows: List[dict], with_task_names: bool = True) -> List[str]:
    """Flamegraph collapsed format. Each row renders as

        <kind>:<pid>;<thread>;<stage>[;task:<id> (<name>)];<stack> <n>

    so flamegraphs group by process, then thread domain, then runtime
    stage, with the per-task split inside."""
    lines: List[str] = []
    for row in rows:
        if row.get("proc"):
            continue
        parts = [
            f"{row.get('kind', '?')}:{row.get('pid', '?')}",
            str(row.get("thread", "?")),
            str(row.get("stage", "?")),
        ]
        task = row.get("task_id")
        if task:
            name = row.get("task_name")
            label = f"task:{task[:8]}"
            if with_task_names and name:
                label += f" ({name})"
            parts.append(label)
        stack = row.get("stack")
        if stack:
            parts.append(stack)
        lines.append(";".join(parts) + f" {row.get('samples', 0)}")
    return lines


def top(rows: List[dict], by: str = "stage", n: int = 20) -> List[dict]:
    """Aggregate sample counts by one dimension: "stage", "task",
    "thread", "kind", or "stack" (leaf frame). Returns rows sorted by
    samples descending with a share-of-total ratio."""
    agg: Dict[str, int] = {}
    total = 0
    for row in rows:
        if row.get("proc"):
            continue
        samples = row.get("samples", 0)
        total += samples
        if by == "task":
            key = row.get("task_id") or "(no task)"
            name = row.get("task_name")
            if name and row.get("task_id"):
                key = f"{key[:8]} ({name})"
        elif by == "stack":
            stack = row.get("stack") or ""
            key = stack.rsplit(";", 1)[-1] or "(no stack)"
        else:
            key = str(row.get(by, "?"))
        agg[key] = agg.get(key, 0) + samples
    out = [
        {by: key, "samples": count,
         "share": (count / total) if total else 0.0}
        for key, count in sorted(agg.items(), key=lambda kv: -kv[1])
    ]
    return out[:n]


def overhead(rows: Optional[List[dict]] = None) -> List[dict]:
    """Per-process sampler meta rows (kind, hz, self-overhead ratio,
    drop count) — the profiler watching itself."""
    if rows is None:
        rows = snapshot()
    return [dict(r) for r in rows if r.get("proc")]


def stack(target: str = "hub", timeout: float = 10.0) -> dict:
    """All-thread stack dump of one process, no sampler needed:
    "hub" (or a pid matching the hub's) dumps the hub process inline;
    anything else resolves a worker by id prefix or reported pid and
    round-trips a STACK_DUMP through its control connection. Returns
    ``{"target", "pid", "threads": [{thread, ident, daemon, frames}]}``
    or an ``{"error": ...}`` payload on timeout / unknown target."""
    return _client().stack_dump(target, timeout=timeout)


def format_stack(reply: dict) -> str:
    """Render a :func:`stack` reply the way `py-spy dump` reads: one
    block per thread, innermost frame last."""
    lines: List[str] = []
    header = f"==== {reply.get('target', '?')} pid={reply.get('pid', '?')}"
    lines.append(header)
    if reply.get("error"):
        lines.append(f"  error: {reply['error']}")
    for t in reply.get("threads", ()):
        flags = " [daemon]" if t.get("daemon") else ""
        lines.append(f"-- thread {t.get('thread')} (ident={t.get('ident')})"
                     f"{flags}")
        for frame_line in t.get("frames", ()):
            lines.append("  " + frame_line)
    return "\n".join(lines) + "\n"
