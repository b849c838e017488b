"""Split a traced train step's device time by the program's own spans.

The program opens ``tracing.span``s around the phases of its train step
(``train_step.forward``, ``train_step.backward``, ``train_step.update``,
and ``train_step.grad_sync`` over a mesh) and around each model block
(``llama.block``). While a torch profiler records, each span is a
``user_annotation`` range in the Chrome trace, on the kernels' clock.

``probe`` runs in the worker after a traced window: it profiles ``STEPS``
more steps of the same state through the window's step, as the window
runs them (batch, step, loss read back), and reduces that trace with
``reduce``. The readers
``forward_ms_per_step``, ``backward_ms_per_step``,
``recompute_ms_per_step`` and ``optimizer_ms_per_step`` read the result;
where the program opens no such span, they read nothing.

A kernel belongs to a span when the call that launched it falls inside
one of the span's ranges, on any thread: autograd runs the backward pass
on a thread of its own, not on the one that holds ``train_step.backward``.
A kernel launched inside a ``llama.block`` range that lies inside a
``train_step.backward`` range belongs to ``RECOMPUTE`` too: the blocks'
forward run again under remat. Each idle gap on the device is put down to
the innermost span open on the step's thread when the gap began.
"""

from __future__ import annotations

import bisect
import json
import os
import sys
import tempfile
from collections import defaultdict
from typing import Dict, List, Tuple

from gpubench import trace

WINDOW = "gpubench.phases"
STEPS = 2
OPS = ("_FlashAttention", "_FusedCrossEntropy")
BACKWARD = "train_step.backward"
BLOCK = "llama.block"
RECOMPUTE = "recompute"
OUTSIDE = "(outside the step)"
_DONE = "gpubench.phases.done"


class _Ranges:
    """The union of some host ranges, for whether a time falls inside."""

    def __init__(self, ranges: List[Tuple[float, float]]):
        merged = trace.union(ranges)
        self.starts = [a for a, _ in merged]
        self.ends = [b for _, b in merged]

    def __contains__(self, t: float) -> bool:
        i = bisect.bisect_right(self.starts, t) - 1
        return i >= 0 and t <= self.ends[i]


def reduce(path: str) -> Dict[str, object]:
    """The device time of the ``WINDOW`` range in ``path`` (a Chrome trace)
    by span: ``phases`` holds, for each span name in the window and
    ``RECOMPUTE``, its ``calls``, ``host_s`` (its ranges' summed duration), ``kernel_s``
    (kernels launched inside it), and of those ``gemm_s`` (GEMMs by name,
    not under one of ``OPS``) and ``under_ops_s`` (under one of ``OPS``);
    ``idle_by_span`` the window's idle device time by the innermost span
    open on the step's thread when each gap began; ``kernel_s`` every
    kernel of the window."""
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]
    (win,) = [e for e in events if e.get("cat") == "user_annotation" and e["name"] == WINDOW]
    w0, w1 = win["ts"], win["ts"] + win["dur"]
    inside = lambda e: e["ts"] >= w0 and e["ts"] + e["dur"] <= w1  # noqa: E731
    spans = [e for e in events
             if e.get("cat") == "user_annotation" and e is not win and inside(e)]
    by_name = defaultdict(list)
    for e in spans:
        by_name[e["name"]].append(e)
    backward = _Ranges([(e["ts"], e["ts"] + e["dur"]) for e in by_name.get(BACKWARD, ())])
    if BLOCK in by_name:
        by_name[RECOMPUTE] = [e for e in by_name[BLOCK]
                              if e["ts"] in backward and e["ts"] + e["dur"] in backward]
    ranges = {n: _Ranges([(e["ts"], e["ts"] + e["dur"]) for e in es])
              for n, es in by_name.items()}

    launches = {e["args"]["correlation"]: e for e in events
                if e.get("cat") in trace.LAUNCH_CATS and "correlation" in e.get("args", {})}
    host = [e for e in events if e.get("cat") in trace.HOST_CATS]
    by_ext = {e["args"]["External id"]: e for e in host if "External id" in e.get("args", {})}
    tracked = defaultdict(list)
    for e in host:
        if trace._op_of(e["name"], OPS):
            tracked[e["tid"]].append(e)
    tracked = {t: trace._Spans(s) for t, s in tracked.items()}

    def origin(k):
        """(thread, time) of the host call that launched kernel k, as
        ``trace.summarize`` ties them."""
        args = k.get("args", {})
        launch = launches.get(args.get("correlation"))
        if launch is not None:
            return launch["tid"], launch["ts"]
        op = by_ext.get(args.get("External id"))
        if op is not None:
            return op["tid"], op["ts"] + 1e-3
        return None, None

    sums = {n: defaultdict(float) for n in by_name}
    kernel_s = 0.0
    device = sorted((e for e in events if e.get("cat") in trace.DEVICE_CATS and inside(e)),
                    key=lambda e: e["ts"])
    for k in device:
        if k["cat"] != "kernel":
            continue
        kernel_s += k["dur"]
        tid, ts = origin(k)
        if ts is None:
            continue
        under = tid in tracked and tracked[tid].innermost(ts) is not None
        for n, r in ranges.items():
            if ts in r:
                sums[n]["kernel_s"] += k["dur"]
                if under:
                    sums[n]["under_ops_s"] += k["dur"]
                elif trace.is_gemm(k["name"]):
                    sums[n]["gemm_s"] += k["dur"]

    own = trace._Spans([e for e in spans if e["tid"] == win["tid"]])
    idle = defaultdict(float)
    end = w0
    for e in device + [{"ts": w1, "dur": 0.0}]:
        if e["ts"] > end:
            span = own.innermost(end)
            idle[span["name"] if span is not None else OUTSIDE] += e["ts"] - end
        end = max(end, e["ts"] + e["dur"])

    us = 1e-6
    return {
        "window_s": (w1 - w0) * us, "kernel_s": kernel_s * us,
        "phases": {n: {"calls": len(es), "host_s": sum(e["dur"] for e in es) * us,
                       **{key: sums[n][key] * us
                          for key in ("kernel_s", "gemm_s", "under_ops_s")}}
                   for n, es in sorted(by_name.items())},
        "idle_by_span": {n: g * us for n, g in sorted(idle.items(), key=lambda x: -x[1])},
    }


def probe(ctx: dict) -> dict:
    """``{"phases": ...}``: ``reduce`` over ``STEPS`` steps of the window's
    own step, profiled after the window, with ``steps``. Once a run: each
    reader has this probe. Over a mesh every rank runs the steps (their
    collectives need every rank) and rank 0 profiles them; the others
    give nothing."""
    if ctx.get(_DONE):
        return {}
    ctx[_DONE] = True
    import torch

    from . import traffic as traffic_gen

    cfg, traffic, seed, dev = ctx["config"], ctx["traffic"], ctx["seed"], ctx["device"]
    step, state = ctx["step"], ctx["state"]
    on_gpu = dev.type == "cuda"
    sync = torch.cuda.synchronize if on_gpu else (lambda: None)

    def steps():
        nonlocal state
        with torch.profiler.record_function(WINDOW):
            for k in range(state.step + 1, state.step + 1 + STEPS):
                batch = traffic_gen.batch(traffic, cfg["vocab_size"], seed, k, dev)
                state, m = step(state, batch)
                m["loss"].item()
            sync()

    sync()
    if ctx.get("rank", 0) != 0:
        steps()
        return {}
    acts = [torch.profiler.ProfilerActivity.CPU]
    if on_gpu:
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    fd, path = tempfile.mkstemp(prefix="gpubench-phases-", suffix=".json")
    os.close(fd)
    try:
        with torch.profiler.profile(activities=acts) as prof:
            steps()
        prof.export_chrome_trace(path)
        out = reduce(path)
    finally:
        os.remove(path)
    out["steps"] = STEPS
    print(f"gpubench phases: {json.dumps(out)}", file=sys.stderr, flush=True)
    return {"phases": out}


def ms_per_step(run: dict, name: str):
    """Device ms a step of the kernels launched inside span ``name`` in
    the probe's steps; None where the probe found no such span or no
    kernel (a run on the CPU)."""
    p = run["probes"].get("phases")
    if p is None or name not in p["phases"] or not p["kernel_s"]:
        return None
    return 1e3 * p["phases"][name]["kernel_s"] / p["steps"]
