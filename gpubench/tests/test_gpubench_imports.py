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
