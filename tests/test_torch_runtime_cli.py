"""The port's CLI (``python -m ray_tpu_torch ...``) against the
reference's (``python -m ray_tpu ...``), with both heads up at once.

Both heads are started through their CLIs in subprocesses that share one
``HOME``: the reference keeps its head's address and pid in
``~/.ray_tpu``, the port in ``~/.ray_tpu_torch``. The programs of
tests/test_cli.py run on each: ``status`` and ``list``, ``job submit
--wait`` with ``summary tasks`` and ``events``, a job's logs, ``summary``
and ``timeline``, and a node joining with ``start --address`` (the
port's with ``--num-gpus 1``, shown in ``status``'s ``gpu`` column). Then
the port's ``stop`` halts the port's head and leaves the reference's up,
and the reference's ``stop`` halts its own.

A head stopped from another place (no pid file there) is sent SHUTDOWN
over the wire: the head exits, its node agent sees the connection close
and reaps its workers, and no worker process of that cluster is left.

Cost: two heads for the file, one CLI process per command.
"""

import json
import os
import signal
import subprocess
import sys
import time

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKGS = ["ray_tpu", "ray_tpu_torch"]


def _env(home, pkg):
    env = dict(os.environ, HOME=str(home), PYTHONPATH=REPO)
    env["RAY_TPU_NUM_TPUS" if pkg == "ray_tpu" else "RAY_TPU_TORCH_NUM_GPUS"] = "0"
    return env


def _start_head(home, pkg, *extra):
    head = subprocess.Popen(
        [sys.executable, "-m", pkg, "start", "--head", "--num-cpus", "2",
         "--host", "127.0.0.1", *extra],
        env=_env(home, pkg), cwd=REPO, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    addr_file = home / f".{pkg}" / "head_address"
    pid_file = home / f".{pkg}" / "head_pid"  # written after the address
    deadline = time.monotonic() + 30
    while not (pid_file.exists() and pid_file.read_text()):
        assert head.poll() is None, head.stdout.read()
        assert time.monotonic() < deadline, "head never wrote its address file"
        time.sleep(0.1)
    return head, addr_file.read_text().strip()


def _end(proc):
    if proc.poll() is None:
        proc.send_signal(signal.SIGINT)
        try:
            proc.wait(timeout=10)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()


def _cli(home, pkg, *argv, timeout=60, extra_env=None):
    out = subprocess.run([sys.executable, "-m", pkg, *argv],
                         env=dict(_env(home, pkg), **(extra_env or {})), cwd=REPO,
                         capture_output=True, text=True, timeout=timeout)
    assert out.returncode == 0, out.stdout + out.stderr
    return out.stdout


@pytest.fixture(scope="module")
def heads(tmp_path_factory):
    home = tmp_path_factory.mktemp("home")
    procs = {}
    try:
        for pkg in PKGS:
            procs[pkg] = _start_head(home, pkg)
        yield home, procs
    finally:
        for head, _ in procs.values():
            _end(head)


def status_and_list(home, pkg):
    out = _cli(home, pkg, "status")
    nodes = json.loads(_cli(home, pkg, "list", "nodes", "--format", "json"))
    actors = _cli(home, pkg, "list", "actors")
    return ("nodes: 1" in out, "CPU" in out, len(nodes), nodes[0]["alive"],
            "(none)" in actors or "ACTOR_ID" in actors)


def events_and_summary_tasks(home, pkg):
    out = _cli(home, pkg, "job", "submit", "--wait", "--", sys.executable, "-c",
               f"import os, {pkg}; "
               f"{pkg}.init(address=os.environ['{pkg.upper()}_ADDRESS']); "
               f"f = {pkg}.remote(lambda: 1); "
               f"print(sum({pkg}.get([f.remote() for _ in range(3)])))", timeout=120)
    summary = json.loads(_cli(home, pkg, "summary", "tasks"))
    events = json.loads(_cli(home, pkg, "events", "--format", "json"))
    table = _cli(home, pkg, "events")
    only = json.loads(_cli(home, pkg, "events", "--kind", "hub_start", "--format", "json"))
    return ("SUCCEEDED" in out, summary["total"] >= 1, "by_state" in summary,
            "queue_wait_s" in summary and "run_time_s" in summary,
            {"p50", "p95", "p99"} <= set(summary["run_time_s"] or {"p50", "p95", "p99"}),
            bool(events) and all("kind" in e and "seq" in e for e in events),
            any(e["kind"] == "hub_start" for e in events), "KIND" in table,
            bool(only) and all(e["kind"] == "hub_start" for e in only))


def job_submit_wait_logs(home, pkg):
    out = _cli(home, pkg, "job", "submit", "--wait", "--", sys.executable, "-c",
               "print('hello from job')", timeout=120)
    return "SUCCEEDED" in out, "hello from job" in out


def summary_and_timeline(home, pkg):
    json.loads(_cli(home, pkg, "summary", "tasks"))
    tl = home / f"tl_{pkg}.json"
    _cli(home, pkg, "timeline", "--output", str(tl))
    return tl.exists(), isinstance(json.loads(tl.read_text()), list)


def node_joins_via_cli(home, pkg):
    extra = ["--num-gpus", "1"] if pkg == "ray_tpu_torch" else []
    joiner = subprocess.Popen(
        [sys.executable, "-m", pkg, "start", "--address",
         (home / f".{pkg}" / "head_address").read_text().strip(),
         "--num-cpus", "1", "--node-id", "clinode", *extra],
        env=_env(home, pkg), cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)
    try:
        deadline = time.monotonic() + 30
        while True:
            nodes = json.loads(_cli(home, pkg, "list", "nodes", "--format", "json"))
            if any(n["node_id"] == "clinode" and n["alive"] for n in nodes):
                break
            assert joiner.poll() is None, joiner.stdout.read()
            assert time.monotonic() < deadline, f"the CLI node never registered: {nodes}"
            time.sleep(0.3)
        status = _cli(home, pkg, "status")
        row = next(line.split() for line in status.splitlines() if line.startswith("clinode"))
        return "clinode" in status, row
    finally:
        joiner.terminate()
        joiner.wait(timeout=10)


PROGRAMS = {f.__name__: f for f in (status_and_list, events_and_summary_tasks,
                                    job_submit_wait_logs, summary_and_timeline,
                                    node_joins_via_cli)}


@pytest.mark.parametrize("name", list(PROGRAMS))
def test_cli_program_agrees(heads, name):
    home, _ = heads
    ref, port = (PROGRAMS[name](home, pkg) for pkg in PKGS)
    if name == "node_joins_via_cli":
        # the row: node id, alive, hostname, cpu, and the accelerator
        # column (tpu there, gpu here)
        assert ref[0] and port[0]
        assert ref[1][:2] == port[1][:2] == ["clinode", "True"]
        assert ref[1][3:] == ["1.0", "0"] and port[1][3:] == ["1.0", "1.0"]
    else:
        assert ref == port and all(ref), (ref, port)


def test_one_stop_leaves_the_other_head_up(heads):
    home, procs = heads
    _cli(home, "ray_tpu_torch", "stop")
    procs["ray_tpu_torch"][0].wait(timeout=15)
    assert not (home / ".ray_tpu_torch" / "head_pid").exists()
    assert procs["ray_tpu"][0].poll() is None
    status = _cli(home, "ray_tpu", "status")
    assert any(line.split()[:2] == ["node0", "True"] for line in status.splitlines()), status
    _cli(home, "ray_tpu", "stop")
    procs["ray_tpu"][0].wait(timeout=15)


def _cluster_pids(session_tag):
    """pids of the port's worker processes and node agents."""
    pids = []
    for pid in os.listdir("/proc"):
        if not pid.isdigit():
            continue
        try:
            with open(f"/proc/{pid}/cmdline", "rb") as f:
                cmd = f.read().replace(b"\0", b" ").decode()
            with open(f"/proc/{pid}/environ", "rb") as f:
                env = f.read()
        except OSError:
            continue
        if session_tag in env and ("ray_tpu_torch._private" in cmd):
            pids.append(int(pid))
    return pids


def test_stop_from_elsewhere_sends_shutdown_and_leaves_no_process(tmp_path):
    head_home, other_home = tmp_path / "head", tmp_path / "other"
    head_home.mkdir()
    other_home.mkdir()
    head, addr = _start_head(head_home, "ray_tpu_torch", "--num-gpus", "0")
    tag = f"tag-{os.getpid()}-{time.monotonic_ns()}".encode()
    agent = subprocess.Popen(
        [sys.executable, "-m", "ray_tpu_torch", "start", "--address", addr,
         "--num-cpus", "1", "--num-gpus", "1", "--node-id", "gpu-node"],
        env=dict(_env(head_home, "ray_tpu_torch"), RAY_TPU_TORCH_TEST_TAG=tag.decode()),
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        job = _cli(other_home, "ray_tpu_torch", "job", "submit", "--address", addr, "--wait",
                   "--", sys.executable, "-c",
                   "import os, ray_tpu_torch as rt; "
                   "rt.init(address=os.environ['RAY_TPU_TORCH_ADDRESS']); "
                   "f = rt.remote(num_gpus=1)(lambda: (os.environ['RAY_TPU_TORCH_NODE_ID'], "
                   "os.environ['CUDA_VISIBLE_DEVICES'])); print('ON', rt.get(f.remote()))",
                   timeout=120)
        assert "SUCCEEDED" in job and "ON ('gpu-node', '0')" in job, job
        assert _cluster_pids(tag)  # the agent and the worker it forked
        out = _cli(other_home, "ray_tpu_torch", "stop", "--address", addr)
        assert f"sent shutdown to hub at {addr}" in out
        head.wait(timeout=30)
        agent.wait(timeout=30)
        deadline = time.monotonic() + 15
        while _cluster_pids(tag) and time.monotonic() < deadline:
            time.sleep(0.1)
        assert _cluster_pids(tag) == []
    finally:
        _end(agent)
        _end(head)
