"""The port's runtime and the reference's, in one process at once.

pytest runs every test file of the repo inside long-lived worker
processes, so a port runtime must leave nothing a reference test could
see: its environment variables carry the ``RAY_TPU_TORCH_`` prefix, its
session, spill and scratch directories the ``ray_tpu_torch`` prefix, and
its workers run ``ray_tpu_torch._private.worker_process``. Here both
runtimes run tasks and an actor side by side, with disjoint worker pids,
session directories and hub addresses; the port's workers import neither
JAX nor ``ray_tpu`` and are given no ``RAY_TPU_`` variable of the
reference's; and shutting the port down leaves the reference working.
Also: no module of the port names a ``ray_tpu.`` module or reads a
``RAY_TPU_`` variable of the reference's, and the modules copied from
the reference differ from it by the renames only. Compiled DAGs of both
packages run at once, each on its own channels (its own segment prefix,
its own C++ ring module), and Data of both packages runs side by side.

Clusters of both packages on one machine: two CLI heads share one
``HOME`` and each keeps its address and pid under its own state dir; a
node agent joins each under the same node id, and each cluster lists
only its own two nodes; each agent runs its own package's
``node_agent`` with a session dir of its own prefix; and stopping both
leaves no process of either.

Cost: one runtime per package for the whole file, two CPUs and two
pooled workers each; every get has a timeout. The cluster test starts
two heads and two agents as processes of their own.
"""

import ast
import json
import os
import re
import subprocess
import sys
import time

import pytest

import ray_tpu
import ray_tpu_torch
from ray_tpu._private import worker as ref_worker
from ray_tpu_torch._private import worker as port_worker

T = 60
PORT_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "ray_tpu_torch")


@pytest.fixture(scope="module")
def runtimes():
    ray_tpu.init(num_cpus=2, max_workers=2, ignore_reinit_error=True)
    ray_tpu_torch.init(num_cpus=2, max_workers=2)
    yield
    ray_tpu_torch.shutdown()
    ray_tpu.shutdown()


def _probe(rt):
    """(task pid, actor pid, the foreign modules and RAY_TPU_* variables
    of a task's worker) on runtime ``rt``."""

    @rt.remote
    def where():
        import os
        import sys

        mods = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "ray_tpu"))
        env = {k: v for k, v in os.environ.items() if k.startswith("RAY_TPU_")}
        return os.getpid(), mods, env

    @rt.remote
    class A:
        def pid(self):
            import os

            return os.getpid()

    a = A.remote()
    (pid, mods, env), apid = rt.get([where.remote(), a.pid.remote()], timeout=T)
    return pid, apid, a, mods, env


def _alive(pid):
    try:
        with open(f"/proc/{pid}/status") as f:
            return "\nState:\tZ" not in f.read()
    except OSError:
        return False


def test_both_runtimes_run_side_by_side(runtimes):
    rpid, rapid, ra, _, renv = _probe(ray_tpu)
    ppid, papid, pa, pmods, penv = _probe(ray_tpu_torch)
    assert {rpid, rapid}.isdisjoint({ppid, papid})
    assert os.getpid() not in {rpid, rapid, ppid, papid}
    rdir, pdir = ref_worker._session_dir, port_worker._session_dir
    assert rdir != pdir
    assert os.path.basename(pdir).startswith("ray_tpu_torch_")
    assert not os.path.basename(rdir).startswith("ray_tpu_torch_")
    assert ref_worker._hub.addr != port_worker._hub.addr
    assert port_worker._hub.spill_dir != ref_worker._hub.spill_dir
    assert "ray_tpu_torch_spill_" in port_worker._hub.spill_dir
    # the port's worker: no JAX, no ray_tpu; of the RAY_TPU_ variables only
    # its own prefix and what this process already had
    assert pmods == [m for m in pmods if m.startswith("ray_tpu_torch")]
    foreign = {k: v for k, v in penv.items() if not k.startswith("RAY_TPU_TORCH_")}
    assert all(os.environ.get(k) == v for k, v in foreign.items()), foreign
    assert {"RAY_TPU_TORCH_HUB_ADDR", "RAY_TPU_TORCH_SESSION_DIR",
            "RAY_TPU_TORCH_WORKER_ID"} <= set(penv)
    # and the reference's worker sees nothing of the port
    assert not [k for k in renv if k.startswith("RAY_TPU_TORCH_")]
    assert not [k for k in os.environ if k.startswith("RAY_TPU_TORCH_")]
    ray_tpu.kill(ra)
    ray_tpu_torch.kill(pa)


def test_compiled_dags_and_data_of_both_packages_keep_apart(runtimes):
    import numpy as np

    compiled, names, mods = [], [], []
    for rt, k in ((ray_tpu, 2.0), (ray_tpu_torch, 3.0)):
        dag = __import__(f"{rt.__name__}.dag", fromlist=["dag"])

        @rt.remote
        class Scale:
            def __init__(self, k):
                self.k = k

            def run(self, x):
                return x * self.k

        a = Scale.remote(k)
        with dag.InputNode() as inp:
            c = a.run.bind(inp).with_shm_channel((3,)).experimental_compile()
        assert c._channel_mode
        compiled.append((c, a, rt))
        names.append([ch.name for ch in c._edge_chans.values()])
        mods.append({ch._mod.__file__ for ch in c._edge_chans.values()})
    refs = [c.execute(np.full(3, float(i), np.float32)) for i in range(4) for c, _, _ in compiled]
    outs = [r.get(timeout=T).tolist() for r in refs]
    assert outs == [[v * float(i)] * 3 for i in range(4) for v in (2.0, 3.0)]
    assert all(n.startswith("rt_ch_") for n in names[0])
    assert all(n.startswith("ray_tpu_torch_ch_") for n in names[1])
    assert len(mods[0]) == len(mods[1]) == 1 and mods[0] != mods[1]
    assert all("build/ray_tpu_torch/" in m for m in mods[1])
    for c, a, rt in compiled:
        c.teardown()
        rt.kill(a)
    rows = [sorted(r["id"] for r in __import__(f"{rt.__name__}.data", fromlist=["data"])
                   .range(12).map_batches(lambda b: {"id": b["id"] * 2}).take_all())
            for rt in (ray_tpu, ray_tpu_torch)]
    assert rows[0] == rows[1] == list(range(0, 24, 2))


def test_shutting_the_port_down_leaves_the_reference_working(runtimes):
    rpid, rapid, ra, _, _ = _probe(ray_tpu)
    ppid, papid, _, _, _ = _probe(ray_tpu_torch)
    pdir = port_worker._session_dir
    ray_tpu_torch.shutdown()
    assert not ray_tpu_torch.is_initialized()
    deadline = time.time() + T
    while (_alive(ppid) or _alive(papid)) and time.time() < deadline:
        time.sleep(0.05)
    assert not _alive(ppid) and not _alive(papid)
    assert not os.path.exists(pdir)
    assert _alive(rpid) and _alive(rapid)

    @ray_tpu.remote
    def plus(x):
        return x + 1

    assert ray_tpu.get(plus.remote(1), timeout=T) == 2
    assert ray_tpu.get(ra.pid.remote(), timeout=T) == rapid
    ray_tpu.kill(ra)


def _strings(tree):
    """String constants of a module that are not docstrings."""
    docs = set()
    for node in ast.walk(tree):
        if isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef, ast.AsyncFunctionDef)):
            body = node.body
            if body and isinstance(body[0], ast.Expr) and isinstance(body[0].value, ast.Constant):
                docs.add(id(body[0].value))
    return [n.value for n in ast.walk(tree)
            if isinstance(n, ast.Constant) and isinstance(n.value, str) and id(n) not in docs]


def test_no_port_module_names_the_reference():
    offenders, env_reads = [], []
    for root, _, files in os.walk(PORT_DIR):
        for f in files:
            if not f.endswith(".py"):
                continue
            path = os.path.join(root, f)
            with open(path) as fh:
                src = fh.read()
            for i, line in enumerate(src.splitlines(), 1):
                if re.search(r"\bray_tpu\.", line):
                    offenders.append(f"{path}:{i}: {line.strip()}")
            tree = ast.parse(src)
            for node in ast.walk(tree):
                names = ([a.name for a in node.names] if isinstance(node, ast.Import) else
                         [node.module or ""] if isinstance(node, ast.ImportFrom) and not node.level
                         else [])
                for n in names:
                    if n.split(".")[0] in ("jax", "ray_tpu"):
                        offenders.append(f"{path}:{node.lineno}: imports {n}")
            env_reads += [f"{path}: {s}" for s in _strings(tree)
                          if re.match(r"RAY_TPU_(?!TORCH_)", s)]
    assert not offenders, offenders
    assert not env_reads, env_reads


# copied with the renames only; the other runtime modules carry named
# edits (ROADMAP.md Queue C)
VERBATIM = ["ids", "protocol", "debug", "config", "session", "store", "object_store",
            "object_agent", "chaos", "profiling", "hub_shards", "client"]
RENAMES = [(r"\bray_tpu\.", "ray_tpu_torch."), (r"RAY_TPU_", "RAY_TPU_TORCH_"),
           (r"\[ray_tpu\]", "[ray_tpu_torch]"), (r'"ray_tpu_spill_"', '"ray_tpu_torch_spill_"'),
           (r"ray_tpu_client_", "ray_tpu_torch_client_"),
           (r'prefix: str = "ray_tpu"', 'prefix: str = "ray_tpu_torch"')]


@pytest.mark.parametrize("name", VERBATIM)
def test_copied_module_differs_from_the_reference_by_the_renames_only(name):
    ref_dir = os.path.join(os.path.dirname(PORT_DIR), "ray_tpu", "_private")
    with open(os.path.join(ref_dir, f"{name}.py")) as f:
        want = f.read()
    for pat, rep in RENAMES:
        want = re.sub(pat, rep, want)
    with open(os.path.join(PORT_DIR, "_private", f"{name}.py")) as f:
        assert f.read() == want


# the Train and Serve libraries' modules copied with the renames only, and
# with ``import ray_tpu`` renamed as well (ROADMAP.md Queue C names the
# edits of the other Train and Serve modules)
VERBATIM_LIBRARY = ["air/result", "train/session", "train/_internal/checkpoint_manager",
                    "train/data_parallel_trainer", "serve/response", "serve/batching",
                    "serve/multiplex", "serve/handle", "serve/_private/replica",
                    "serve/_private/proxy", "serve/_private/local_testing_mode"]


@pytest.mark.parametrize("name", VERBATIM_LIBRARY)
def test_copied_library_module_differs_from_the_reference_by_the_renames_only(name):
    with open(os.path.join(os.path.dirname(PORT_DIR), "ray_tpu", f"{name}.py")) as f:
        want = f.read()
    for pat, rep in RENAMES + [(r"^(\s*)import ray_tpu$", r"\1import ray_tpu_torch")]:
        want = re.sub(pat, rep, want, flags=re.M)
    with open(os.path.join(PORT_DIR, f"{name}.py")) as f:
        assert f.read() == want


# the cluster modules: copied with the renames of every name the runtime
# writes (state dir, job manager, log files, threads, the HTML title)
CLUSTER_VERBATIM = ["util/state.py", "util/metrics.py", "util/profiler.py", "util/rpdb.py",
                    "job_submission.py", "dashboard/__init__.py", "dashboard/index.html",
                    "__main__.py"]


def _cluster_renames(src):
    src = src.replace("RAY_TPU_", "RAY_TPU_TORCH_")
    src = re.sub(r"(?<![A-Za-z0-9])_ray_tpu_", "_ray_tpu_torch_", src)
    src = re.sub(r"\bray_tpu_(?!torch)", "ray_tpu_torch_", src)
    src = re.sub(r"\bray_tpu\b", "ray_tpu_torch", src)
    return src.replace("ray-tpu-", "ray-tpu-torch-")


@pytest.mark.parametrize("name", CLUSTER_VERBATIM)
def test_copied_cluster_module_differs_from_the_reference_by_the_renames_only(name):
    with open(os.path.join(os.path.dirname(PORT_DIR), "ray_tpu", name)) as f:
        want = _cluster_renames(f.read())
    with open(os.path.join(PORT_DIR, name)) as f:
        assert f.read() == want


# dag, workflow and Data: copied with the same renames, the first list
# byte for byte, the second but for docstrings and comments that spoke of
# the TPU (their code, as parsed, is the reference's); the other modules of
# the slice carry named edits (ROADMAP.md Queue C)
SLICE8_VERBATIM = ["workflow/__init__.py", "dag/__init__.py", "data/aggregate.py",
                   "data/block.py", "data/context.py", "data/datasource.py",
                   "data/preprocessors.py", "data/_internal/__init__.py",
                   "data/_internal/plan.py", "data/_internal/tfrecords.py",
                   "_native/ring_channel.cpp"]
SLICE8_SAME_CODE = ["dag/dag_node.py", "dag/compiled_dag.py", "data/__init__.py",
                    "experimental/channel/__init__.py"]


@pytest.mark.parametrize("name", SLICE8_VERBATIM)
def test_copied_slice8_module_differs_from_the_reference_by_the_renames_only(name):
    with open(os.path.join(os.path.dirname(PORT_DIR), "ray_tpu", name)) as f:
        want = _cluster_renames(f.read())
    with open(os.path.join(PORT_DIR, name)) as f:
        assert f.read() == want


def _code(src):
    """The module as parsed, without docstrings."""
    tree = ast.parse(src)
    for node in ast.walk(tree):
        if isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef, ast.AsyncFunctionDef)):
            body = node.body
            if body and isinstance(body[0], ast.Expr) and isinstance(body[0].value, ast.Constant):
                node.body = body[1:] or [ast.Pass()]
    return ast.dump(tree)


@pytest.mark.parametrize("name", SLICE8_SAME_CODE)
def test_copied_slice8_module_has_the_reference_code_with_the_renames(name):
    with open(os.path.join(os.path.dirname(PORT_DIR), "ray_tpu", name)) as f:
        want = _code(_cluster_renames(f.read()))
    with open(os.path.join(PORT_DIR, name)) as f:
        assert _code(f.read()) == want


def _cli_env(home, pkg):
    env = dict(os.environ, HOME=str(home), PYTHONPATH=os.path.dirname(PORT_DIR))
    env["RAY_TPU_NUM_TPUS" if pkg == "ray_tpu" else "RAY_TPU_TORCH_NUM_GPUS"] = "0"
    return env


def _cli_json(home, pkg, *argv):
    out = subprocess.run([sys.executable, "-m", pkg, *argv], env=_cli_env(home, pkg),
                         capture_output=True, text=True, timeout=T)
    assert out.returncode == 0, out.stdout + out.stderr
    return json.loads(out.stdout)


def _proc(pid):
    with open(f"/proc/{pid}/cmdline", "rb") as f:
        cmd = f.read().split(b"\0")
    with open(f"/proc/{pid}/environ", "rb") as f:
        env = dict(kv.split(b"=", 1) for kv in f.read().split(b"\0") if b"=" in kv)
    return [c.decode() for c in cmd], {k.decode(): v.decode() for k, v in env.items()}


def test_two_clusters_on_one_machine_keep_apart(tmp_path):
    pkgs = ["ray_tpu", "ray_tpu_torch"]
    procs = []
    try:
        addrs = {}
        for pkg in pkgs:
            head = subprocess.Popen([sys.executable, "-m", pkg, "start", "--head", "--num-cpus",
                                     "1", "--host", "127.0.0.1"], env=_cli_env(tmp_path, pkg),
                                    stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
            procs.append(head)
            addr_file = tmp_path / f".{pkg}" / "head_address"
            pid_file = tmp_path / f".{pkg}" / "head_pid"  # written after the address
            deadline = time.monotonic() + T
            while not (pid_file.exists() and pid_file.read_text()):
                assert head.poll() is None and time.monotonic() < deadline
                time.sleep(0.1)
            addrs[pkg] = addr_file.read_text().strip()
            assert pid_file.read_text() == str(head.pid)
        assert addrs["ray_tpu"] != addrs["ray_tpu_torch"]
        agents = {}
        for pkg in pkgs:
            agents[pkg] = subprocess.Popen(
                [sys.executable, "-m", pkg, "start", "--address", addrs[pkg], "--num-cpus", "1",
                 "--node-id", "agent"], env=_cli_env(tmp_path, pkg),
                stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
            procs.append(agents[pkg])
        for pkg in pkgs:
            deadline = time.monotonic() + T
            while True:
                nodes = _cli_json(tmp_path, pkg, "list", "nodes", "--format", "json")
                if len(nodes) == 2 and all(n["alive"] for n in nodes):
                    break
                assert time.monotonic() < deadline, nodes
                time.sleep(0.2)
            assert sorted(n["node_id"] for n in nodes) == ["agent", "node0"]
        # each agent is its own package's node agent, in a session dir of
        # its own prefix, and the port's carries none of the reference's
        # variables
        (rcmd, renv), (pcmd, penv) = (_proc(agents[pkg].pid) for pkg in pkgs)
        assert "ray_tpu._private.node_agent" in rcmd
        assert "ray_tpu_torch._private.node_agent" in pcmd
        assert os.path.basename(renv["RAY_TPU_SESSION_DIR"]).startswith("ray_tpu_agent")
        assert os.path.basename(penv["RAY_TPU_TORCH_SESSION_DIR"]).startswith(
            "ray_tpu_torch_agent")
        assert penv["RAY_TPU_TORCH_HUB_ADDR"] == addrs["ray_tpu_torch"]
        assert not [k for k in renv if k.startswith("RAY_TPU_TORCH_")]
        foreign = {k: v for k, v in penv.items()
                   if k.startswith("RAY_TPU_") and not k.startswith("RAY_TPU_TORCH_")}
        assert all(os.environ.get(k) == v for k, v in foreign.items()), foreign
        for pkg in pkgs:
            out = subprocess.run([sys.executable, "-m", pkg, "stop"], env=_cli_env(tmp_path, pkg),
                                 capture_output=True, text=True, timeout=T)
            assert out.returncode == 0, out.stderr
        for p in procs:
            p.wait(timeout=T)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
