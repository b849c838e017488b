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
the reference differ from it by the renames only.

Cost: one runtime per package for the whole file, two CPUs and two
pooled workers each; every get has a timeout.
"""

import ast
import os
import re
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
