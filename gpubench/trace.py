"""Reduce a ``torch.profiler`` trace (Chrome JSON) to what the per-layer
metrics read.

Only the traced window counts: the span of the ``user_annotation`` event
named by the caller. Each kernel is tied to the host op that launched it:
by its correlation id to the runtime's launch call (or, without one, by
its external id to the host op), then to the innermost of the ``ops``
(autograd functions, forward and ``...Backward``) whose span on that thread
holds the launch. The summary gives:

- ``busy_s``: the union of kernels, copies and sets on the device, over
  the window ``window_s``;
- ``kernel_s``, ``launches``; ``gemm_s`` (kernels named as GEMMs, not under
  an op); ``ops``: for each op its calls and backward calls in the window
  and the device seconds of the kernels under each;
- ``nccl_kernel_s``: NCCL's kernels (by name); ``nccl_exposed_s``: the
  time in which an NCCL kernel runs on the device and no other kernel
  does, the collectives' time that compute does not hide; ``nccl_ops``:
  each NCCL kernel name with its device seconds, the most first;
- ``device_ops``: the ten kernel names with the most device time;
- ``idle_gaps``: the ten longest spans with nothing on the device, each
  named by the host op that launched the kernel ending it.
"""

from __future__ import annotations

import bisect
import json
from collections import defaultdict
from typing import Dict, List

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
HOST_CATS = ("cpu_op", "user_annotation", "python_function")
GEMM_MARKS = ("gemm", "xmma", "nvjet", "cutlass", "gemv", "splitk")
TOP = 10


def is_gemm(name: str) -> bool:
    low = name.lower()
    return any(m in low for m in GEMM_MARKS)


def is_nccl(name: str) -> bool:
    return "nccl" in name.lower()


def union(spans: List[tuple]) -> List[List[float]]:
    """The union of (start, end) spans as sorted disjoint [start, end]."""
    out: List[List[float]] = []
    for a, b in sorted(spans):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _uncovered(spans: List[List[float]], cover: List[List[float]]) -> float:
    """The length of ``spans`` that ``cover`` leaves bare (both unions)."""
    bare, j = 0.0, 0
    for a, b in spans:
        t = a
        while j < len(cover) and cover[j][1] <= t:
            j += 1
        k = j
        while k < len(cover) and cover[k][0] < b:
            if cover[k][0] > t:
                bare += cover[k][0] - t
            t = max(t, cover[k][1])
            k += 1
        if t < b:
            bare += b - t
    return bare


class _Spans:
    """Host spans of one thread, for the innermost span holding a time."""

    def __init__(self, spans: List[dict]):
        self.spans = sorted(spans, key=lambda e: e["ts"])
        self.starts = [e["ts"] for e in self.spans]

    def innermost(self, t: float, reach: int = 4000):
        i = bisect.bisect_right(self.starts, t) - 1
        for j in range(i, max(i - reach, -1), -1):
            e = self.spans[j]
            if e["ts"] <= t <= e["ts"] + e["dur"]:
                return e
        return None


def summarize(path: str, window: str, ops: List[str]) -> Dict[str, object]:
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]
    (win,) = [e for e in events if e.get("cat") == "user_annotation" and e["name"] == window]
    w0, w1 = win["ts"], win["ts"] + win["dur"]
    inside = lambda e: e["ts"] >= w0 and e["ts"] + e["dur"] <= w1  # noqa: E731
    device = sorted((e for e in events if e.get("cat") in DEVICE_CATS and inside(e)),
                    key=lambda e: e["ts"])
    launches = {e["args"]["correlation"]: e for e in events
                if e.get("cat") in LAUNCH_CATS and "correlation" in e.get("args", {})}
    host = [e for e in events if e.get("cat") in HOST_CATS]
    by_ext = {e["args"]["External id"]: e for e in host if "External id" in e.get("args", {})}
    threads = defaultdict(list)
    tracked = defaultdict(list)
    for e in host:
        threads[e["tid"]].append(e)
        if _op_of(e["name"], ops):
            tracked[e["tid"]].append(e)
    threads = {t: _Spans(s) for t, s in threads.items()}
    tracked = {t: _Spans(s) for t, s in tracked.items()}

    def origin(k):
        """(thread, time) of the host call that launched kernel k."""
        args = k.get("args", {})
        launch = launches.get(args.get("correlation"))
        if launch is not None:
            return launch["tid"], launch["ts"], "correlation"
        op = by_ext.get(args.get("External id"))
        if op is not None:
            return op["tid"], op["ts"] + 1e-3, "external"
        return None, None, "none"

    linked = defaultdict(int)
    op_s = defaultdict(float)
    names = defaultdict(float)
    gemm_s = kernel_s = 0.0
    n_kernels = 0
    nccl, others = [], []
    first_of_gap = []
    busy, end = 0.0, w0
    for e in device:
        s, t = e["ts"], e["ts"] + e["dur"]
        if s > end:
            first_of_gap.append((s - end, e))
        busy += max(0.0, t - max(s, end))
        end = max(end, t)
        if e["cat"] != "kernel":
            continue
        n_kernels += 1
        kernel_s += e["dur"]
        names[e["name"]] += e["dur"]
        (nccl if is_nccl(e["name"]) else others).append((s, t))
        tid, ts, how = origin(e)
        linked[how] += 1
        span = tracked[tid].innermost(ts) if tid in tracked else None
        if span is not None:
            op_s[_op_of(span["name"], ops)] += e["dur"]
        elif is_gemm(e["name"]):
            gemm_s += e["dur"]
    if w1 > end:
        first_of_gap.append((w1 - end, None))

    def gap_name(k):
        if k is None:
            return "(window end)"
        tid, ts, _ = origin(k)
        span = threads[tid].innermost(ts) if tid in threads else None
        return span["name"] if span is not None else "(unknown)"

    calls = defaultdict(int)   # a backward node's span may hold one of the same name
    for spans in tracked.values():
        last_end = {}
        for e in spans.spans:
            key = _op_of(e["name"], ops)
            if w0 <= e["ts"] <= w1 and e["ts"] > last_end.get(key, -1.0):
                calls[key] += 1
                last_end[key] = e["ts"] + e["dur"]
    us = 1e-6
    return {
        "window_s": (w1 - w0) * us, "busy_s": busy * us, "kernel_s": kernel_s * us,
        "gemm_s": gemm_s * us, "launches": n_kernels, "linked": dict(linked),
        "nccl_kernel_s": sum(b - a for a, b in nccl) * us,
        "nccl_exposed_s": _uncovered(union(nccl), union(others)) * us,
        "ops": {op: {"calls": calls[op], "kernel_s": op_s[op] * us,
                     "backward_calls": calls[op + "Backward"],
                     "backward_kernel_s": op_s[op + "Backward"] * us} for op in ops},
        "nccl_ops": [[n, d * us] for n, d in sorted(names.items(), key=lambda x: -x[1])
                     if is_nccl(n)],
        "device_ops": [[n, d * us] for n, d in sorted(names.items(), key=lambda x: -x[1])[:TOP]],
        "idle_gaps": [[gap_name(k), g * us] for g, k in sorted(first_of_gap, key=lambda x: -x[0])[:TOP]],
    }


def _op_of(name: str, ops: List[str]):
    """``op`` or ``op + "Backward"`` when ``name`` is that autograd
    function's forward or backward node, else None."""
    for op in ops:
        if name == op:
            return op
        if name.endswith(op + "Backward"):
            return op + "Backward"
    return None
