"""No module of the benchmark names jax, jaxlib, flax or ray_tpu as its
top-level import (compared whole: ray_tpu_torch passes), and the reference
imports nothing of the program. What a run loads at run time is checked by
the run itself (it exits 3 and prints no result); ``test_gpubench_cpu_run``
sees those runs exit 0."""

import ast
import os

import pytest

from gpubench import BANNED_MODULES, PKG_DIR


def _modules():
    for d, _, files in os.walk(PKG_DIR):
        for f in files:
            if f.endswith(".py"):
                yield os.path.relpath(os.path.join(d, f), PKG_DIR)


def _imports(rel):
    with open(os.path.join(PKG_DIR, rel)) as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("rel", sorted(_modules()))
def test_no_banned_top_level_import(rel):
    tops = {name.split(".")[0] for name in _imports(rel)}
    assert not tops & set(BANNED_MODULES), (rel, tops)


@pytest.mark.parametrize("rel", ["reference.py", "weights.py", "traffic.py", "check.py",
                                 "flops.py", "peaks.py", "trace.py"])
def test_yardstick_imports_nothing_of_the_program(rel):
    tops = {name.split(".")[0] for name in _imports(rel)}
    assert "ray_tpu_torch" not in tops, rel


def test_the_driver_imports_no_torch_before_the_window():
    """The driver's modules, the runtime and the trainer library load no
    torch: the driver imports it only once the window has closed, so its
    import is not counted in ``setup_s``."""
    import subprocess
    import sys

    code = ("import sys; from gpubench import harness, loop, registry, check, peaks; "
            "import ray_tpu_torch; from ray_tpu_torch import train; "
            "print('torch' in sys.modules)")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120, cwd=os.path.dirname(PKG_DIR))
    assert out.stdout.strip() == "False", out.stderr[-2000:]


@pytest.mark.parametrize("rel", sorted(r for r in _modules() if r.startswith("families" + os.sep)))
def test_a_family_imports_the_program_only_inside_its_program_functions(rel):
    """A family module's top-level imports name nothing of the program: its
    reference model loads without it."""
    with open(os.path.join(PKG_DIR, rel)) as f:
        tree = ast.parse(f.read())
    tops = set()
    for node in tree.body:
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            tops.add(node.module.split(".")[0])
    assert "ray_tpu_torch" not in tops, rel


@pytest.mark.time_limit(120)
def test_the_reference_loads_nothing_of_the_program():
    """A run of the reference, one process and spread over two, leaves no
    module of the program loaded in the process that ran it."""
    import subprocess
    import sys

    code = ("import sys, tempfile, torch; from gpubench import reference; "
            "from gpubench.tests import tiny; d = tempfile.mkdtemp(); "
            "reference.run(tiny.LLAMA, tiny.TRAFFIC, 3, torch.device('cpu')); "
            "reference.run(tiny.LLAMA, tiny.TRAFFIC_B4, 3, torch.device('cpu'), ranks=2, workdir=d); "
            "print(sorted(m for m in sys.modules if m.split('.')[0] == 'ray_tpu_torch'))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=110, cwd=os.path.dirname(PKG_DIR))
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]", out.stdout[-2000:]
