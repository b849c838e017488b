"""The split of a traced step by the program's spans (``phases.py``) on a
small hand-made Chrome trace, the readers that sit on it, and the probe in
a whole run of the harness on the CPU."""

import json
import os
import shutil
import subprocess
import sys
import tempfile

import pytest

from gpubench import ROOT, phases, registry, trace
from gpubench.tests import tiny

READERS = {"forward_ms_per_step": "train_step.forward",
           "backward_ms_per_step": "train_step.backward",
           "recompute_ms_per_step": phases.RECOMPUTE,
           "optimizer_ms_per_step": "train_step.update"}


def _ev(cat, name, ts, dur, tid=1, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "pid": 1, "tid": tid,
            "args": args}


def _launch(ts, corr, tid=1):
    return _ev("cuda_runtime", "cudaLaunchKernel", ts, 2, tid=tid, correlation=corr)


# thread 1 holds the step; autograd's thread 2 launches the backward pass
# (the recompute under a llama.block range, then the op's backward and a
# GEMM); thread 7 is the device
SPANS = [
    _ev("user_annotation", "train_step.forward", 10, 190),
    _ev("user_annotation", "llama.block", 15, 175),
    _ev("user_annotation", "train_step.backward", 210, 390),
    _ev("user_annotation", "llama.block", 220, 80, tid=2),
    _ev("user_annotation", "train_step.update", 610, 90),
]
EVENTS = [
    _ev("user_annotation", phases.WINDOW, 0, 1000),
    _ev("cpu_op", "_FlashAttention", 20, 40),
    _launch(30, 100),
    _ev("kernel", "flash_fwd_kernel", 100, 200, tid=7, correlation=100),
    _ev("cpu_op", "aten::mm", 70, 5, **{"External id": 9}),
    _ev("kernel", "nvjet_tst_128x256_gemm", 300, 50, tid=7, **{"External id": 9}),
    _ev("cpu_op", "aten::mul", 78, 5),
    _launch(80, 101),
    _ev("kernel", "vectorized_elementwise_kernel", 350, 10, tid=7, correlation=101),
    _ev("cpu_op", "aten::mul", 228, 5, tid=2),
    _launch(230, 102, tid=2),
    _ev("kernel", "elementwise_kernel", 400, 30, tid=7, correlation=102),
    _ev("cpu_op", "_FlashAttentionBackward", 310, 90, tid=2),
    _launch(320, 103, tid=2),
    _ev("kernel", "flash_bwd_dq_kernel", 430, 100, tid=7, correlation=103),
    _ev("cpu_op", "aten::mm", 448, 5, tid=2),
    _launch(450, 104, tid=2),
    _ev("kernel", "nvjet_tst_192x192_gemm", 530, 40, tid=7, correlation=104),
    _ev("cpu_op", "aten::add_", 618, 5),
    _launch(620, 105),
    _ev("kernel", "vectorized_elementwise_kernel", 710, 50, tid=7, correlation=105),
    _ev("cpu_op", "aten::mul_", 628, 5),
    _launch(630, 106),
    _ev("kernel", "vectorized_elementwise_kernel", 760, 50, tid=7, correlation=106),
    _ev("cpu_op", "aten::random_", 748, 5),     # the next batch, outside the step
    _launch(750, 107),
    _ev("kernel", "distribution_elementwise_kernel", 900, 20, tid=7, correlation=107),
    _ev("kernel", "outside_the_window", 2000, 10, tid=7, correlation=108),
]


def _write(tmp_path, events, name="t.json"):
    path = tmp_path / name
    path.write_text(json.dumps({"traceEvents": events}))
    return str(path)


def test_reduce_ties_kernels_to_spans_across_threads(tmp_path):
    r = phases.reduce(_write(tmp_path, EVENTS + SPANS))
    us = 1e-6
    assert r["window_s"] == pytest.approx(1000 * us)
    assert r["kernel_s"] == pytest.approx(550 * us)
    want = {  # calls, host, kernels, GEMMs, under the ops
        "train_step.forward": (1, 190, 260, 50, 200),
        "train_step.backward": (1, 390, 170, 40, 100),
        "train_step.update": (1, 90, 100, 0, 0),
        "llama.block": (2, 255, 290, 50, 200),
        phases.RECOMPUTE: (1, 80, 30, 0, 0),
    }
    assert set(r["phases"]) == set(want)
    for name, (calls, host, kern, gemm, under) in want.items():
        p = r["phases"][name]
        assert p["calls"] == calls, name
        assert p["host_s"] == pytest.approx(host * us), name
        assert p["kernel_s"] == pytest.approx(kern * us), name
        assert p["gemm_s"] == pytest.approx(gemm * us), name
        assert p["under_ops_s"] == pytest.approx(under * us), name
    # gaps 0-100, 810-900 and 920-1000 began outside the step; 360-400
    # and 570-710 while the step's thread waited in train_step.backward
    assert r["idle_by_span"] == {phases.OUTSIDE: pytest.approx(270 * us),
                                 "train_step.backward": pytest.approx(180 * us)}


def _run(probes):
    return {"probes": probes, "trace": None, "window": {"steps": 5}}


def test_readers_on_the_probe(tmp_path):
    r = phases.reduce(_write(tmp_path, EVENTS + SPANS))
    run = _run({"phases": {**r, "steps": 2}})
    got = {m: registry.metric(m).read(run) for m in READERS}
    assert got == {"forward_ms_per_step": pytest.approx(0.130),
                   "backward_ms_per_step": pytest.approx(0.085),
                   "recompute_ms_per_step": pytest.approx(0.015),
                   "optimizer_ms_per_step": pytest.approx(0.050)}
    assert got["recompute_ms_per_step"] < got["backward_ms_per_step"]
    # forward, backward and update hold every kernel but the next batch's
    step = got["forward_ms_per_step"] + got["backward_ms_per_step"] + \
        got["optimizer_ms_per_step"]
    assert step == pytest.approx(1e3 * (r["kernel_s"] - 20e-6) / 2)
    for m in READERS:
        assert registry.metric(m).probe is phases.probe


def test_readers_read_nothing_without_the_spans(tmp_path):
    """A program that opens no span: the probe finds no phase and
    every reader gives None; so does a run without the probe, and one on
    the CPU (no kernel)."""
    bare = phases.reduce(_write(tmp_path, EVENTS))
    assert bare["phases"] == {} and bare["kernel_s"] > 0
    assert bare["idle_by_span"] == {phases.OUTSIDE: pytest.approx(450e-6)}
    for probes in ({"phases": {**bare, "steps": 2}}, {}):
        for m in READERS:
            assert registry.metric(m).read(_run(probes)) is None
    cpu = {**phases.reduce(_write(tmp_path, EVENTS[:1] + SPANS)), "steps": 2}
    assert set(cpu["phases"]) == set(READERS.values()) | {"llama.block"}
    for m in READERS:
        assert registry.metric(m).read(_run({"phases": cpu})) is None


def test_spans_move_no_key_of_the_window_summary(tmp_path):
    """The accepted reduction reads the same numbers with the program's
    spans in the trace as without them."""
    events = [dict(e, name="gpubench.window") if e["name"] == phases.WINDOW else e
              for e in EVENTS]
    ops = ["_FlashAttention", "_FusedCrossEntropy"]
    bare = trace.summarize(_write(tmp_path, events, "a.json"), "gpubench.window", ops)
    spans = trace.summarize(_write(tmp_path, events + SPANS, "b.json"), "gpubench.window", ops)
    assert spans == bare


def test_the_probe_in_a_traced_run_on_the_cpu(tmp_path):
    """A traced run of a tiny cell whose cells list the four readers runs
    the probe once after the window: its phases reach the harness's
    standard error, the state's steps read as before (the probe keeps its
    own), no device metric is read from the CPU, and the run leaves its
    TMPDIR empty."""
    copy = tiny.copy_with_tiny_cells(str(tmp_path / "bench"))
    path = os.path.join(copy, "BENCHMARK.json")
    with open(path) as f:
        bench = json.load(f)
    for m in bench["per_layer"]:
        if m["name"] in READERS:
            m["workloads"].append("tiny.llama")
    with open(path, "w") as f:
        json.dump(bench, f)
    tmp = tempfile.mkdtemp(prefix="gb", dir="/tmp")
    try:
        env = dict(os.environ, TMPDIR=tmp, PYTHONPATH=ROOT)
        env.pop("BENCH_RUN", None)
        p = subprocess.run([sys.executable, "-m", "gpubench", "--device", "cpu", "--seconds",
                            "1", "--workload", "tiny.llama", "--seed", "2147483659",
                            "--trace", "1"], cwd=copy, env=env, capture_output=True,
                           text=True, timeout=300)
        assert p.returncode == 0, p.stderr[-3000:]
        line = json.loads(p.stdout.strip().splitlines()[-1])
        assert line["correct"] is True
        steps = tiny.TRAFFIC["check_steps"] + line["attempted"]
        assert line["metrics"]["tiny_steps"]["value"] == float(steps)
        assert not set(READERS) & set(line["metrics"])
        said = [json.loads(x.split("gpubench phases: ", 1)[1]) for x in p.stderr.splitlines()
                if x.startswith("gpubench phases: ")]
        assert len(said) == 1
        got = said[0]["phases"]
        n = phases.STEPS
        layers = tiny.LLAMA["num_hidden_layers"]
        assert {k: v["calls"] for k, v in got.items()} == {
            "train_step.forward": n, "train_step.backward": n, "train_step.update": n,
            "llama.block": 2 * layers * n, phases.RECOMPUTE: layers * n}
        assert os.listdir(tmp) == []
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
