"""graftlint on the port: the reference's tool over ``ray_tpu_torch/``,
and the port's own copy (``ray_tpu_torch.tools.graftlint``) held to the
reference rule for rule.

graftlint checks the concurrency and message rules of the runtime, GL012
among them: every message type sent has a receiver and every handled
type a sender. Before the node agent and the CLI were ported, the hub's
ten node-agent messages and the CLI's ``shutdown`` had only one end
each. Over ``ray_tpu_torch/`` with no baseline the reference's tool now
reports nothing.

The port's copy scopes its rules to ``ray_tpu_torch/`` (the fingerprint
path's anchor, GL004's ``get`` bases, GL011's and GL017's serve plane).
Its parity with the reference is held on the reference's own fixtures:
every ``check_file`` call that ``tests/test_graftlint.py`` makes is
recorded by running its tests against a recording ``check_file``, then
replayed through both packages, the port's with ``ray_tpu`` renamed
``ray_tpu_torch`` in the path and the source. The historical defects
that its ``live_revert`` re-applies to the reference are re-applied to
the port's file at the same path.
"""

import ast
import importlib.util
import inspect
import io
import json
import os
import re
import subprocess
import sys
import textwrap
from contextlib import redirect_stdout

import pytest

from ray_tpu.tools import graftlint as ref_graftlint
from ray_tpu.tools.graftlint.__main__ import main
from ray_tpu_torch.tools import graftlint
from ray_tpu_torch.tools.graftlint import core as port_core

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(_REPO, "ray_tpu_torch")
_FIXTURE_FILE = os.path.join(_REPO, "tests", "test_graftlint.py")


def _to_port(text):
    """``ray_tpu`` -> ``ray_tpu_torch`` in a path or a source."""
    return re.sub(r"\bray_tpu\b", "ray_tpu_torch", text)


class _Recorded(Exception):
    """Ends a reference test at a call that is recorded, not run."""


def _record_reference_fixtures():
    """Run the reference's fixture tests with ``check_file`` recording
    its arguments (and still answering, so each test goes on to its next
    fixture) and ``live_revert`` recording its defect. Tests that take
    pytest fixtures build file trees and are not fixture calls; tests
    that lint the whole package are stopped at that call."""
    spec = importlib.util.spec_from_file_location("_graftlint_fixtures", _FIXTURE_FILE)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    real = mod.check_file
    calls, reverts = {}, {}

    def check_file(path, source=None, codes=None):
        frame = sys._getframe(1)
        if frame.f_code.co_name == "codes_of":
            frame = frame.f_back
        key = f"{frame.f_code.co_name}:{frame.f_lineno}"
        n = sum(1 for k in calls if k.split("#")[0] == key)
        calls[f"{key}#{n}" if n else key] = (path, source, codes)
        return real(path, source=source, codes=codes)

    def live_revert(rel_path, old, new, codes):
        reverts[sys._getframe(1).f_code.co_name] = (rel_path, old, new, tuple(codes))
        raise _Recorded

    def stop(*args, **kwargs):
        raise _Recorded

    mod.check_file, mod.live_revert = check_file, live_revert
    mod.check_paths = mod.run_cli = stop
    for name, fn in vars(mod).items():
        if not name.startswith("test_") or inspect.signature(fn).parameters:
            continue
        body = inspect.getsource(fn)
        if "codes_of(" in body or "check_file(" in body or "live_revert(" in body:
            try:
                fn()
            except _Recorded:
                pass
    return calls, reverts


_CALLS, _REVERTS = _record_reference_fixtures()


def _fixture_call_lines():
    """Line of every ``codes_of``/``check_file`` call in a test that takes
    no pytest fixture, read from the file's AST."""
    tree = ast.parse(open(_FIXTURE_FILE).read())
    lines = set()
    for fn in tree.body:
        if isinstance(fn, ast.FunctionDef) and fn.name.startswith("test_") and not fn.args.args:
            for node in ast.walk(fn):
                if (isinstance(node, ast.Call) and isinstance(node.func, ast.Name)
                        and node.func.id in ("codes_of", "check_file")):
                    lines.add((fn.name, node.lineno))
    return lines


def _findings(findings):
    return [(f.code, f.line) for f in findings]


def test_graftlint_finds_nothing_in_the_port():
    out = io.StringIO()
    with redirect_stdout(out):
        rc = main([PORT, "--no-baseline", "--format", "json"])
    report = json.loads(out.getvalue())
    assert report["findings"] == [], report["findings"]
    assert rc == 0


def test_port_gate_is_clean_with_its_baseline():
    """The port's gate over the port, in process, with the packaged
    baseline, which is empty."""
    baseline = graftlint.load_baseline(graftlint.DEFAULT_BASELINE_PATH)
    assert baseline == set()
    assert graftlint.DEFAULT_BASELINE_PATH == os.path.join(
        PORT, "tools", "graftlint", "baseline.json")
    fresh, baselined = graftlint.check_paths([PORT], baseline=baseline)
    assert fresh == [] and baselined == [], fresh


def test_port_gate_cli_defaults_to_the_port():
    """``python -m ray_tpu_torch.tools.graftlint`` with no path checks
    ``ray_tpu_torch/`` and exits 0 with no finding."""
    out = subprocess.run([sys.executable, "-m", "ray_tpu_torch.tools.graftlint",
                          "--format", "json"], cwd=_REPO, capture_output=True, text=True,
                         env=dict(os.environ, PYTHONPATH=_REPO), timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    report = json.loads(out.stdout)
    assert report["findings"] == [] and report["baselined"] == 0, report
    usage = subprocess.run([sys.executable, "-m", "ray_tpu_torch.tools.graftlint", "--help"],
                           cwd=_REPO, capture_output=True, text=True, timeout=60)
    assert "usage: python -m ray_tpu_torch.tools.graftlint" in usage.stdout
    assert "(default: ray_tpu_torch)" in usage.stdout


def test_rule_catalogue_equals_the_reference():
    def catalogue(pkg):
        return ([(c, n) for c, n, _ in pkg.all_checkers()],
                [(c, n) for c, n, _ in pkg.all_project_checkers()])

    port, ref = catalogue(graftlint), catalogue(ref_graftlint)
    assert port == ref
    assert sorted({c for c, _ in port[0] + port[1]}) == [f"GL{i:03d}" for i in range(1, 19)]


def test_fingerprint_paths_anchor_on_the_port():
    """Two port files of one name keep apart in the baseline: the path is
    kept from ``ray_tpu_torch/`` down, not cut to the basename."""
    norm = port_core._norm_path
    assert norm("/x/ray_tpu_torch/serve/handle.py") == "ray_tpu_torch/serve/handle.py"
    assert norm("ray_tpu_torch/_private/hub.py") == "ray_tpu_torch/_private/hub.py"
    assert norm("/x/tests/test_a.py") == "tests/test_a.py"
    assert norm("/x/ray_tpu_torch/serve/handle.py") != norm("/x/ray_tpu_torch/llm/handle.py")


def test_every_reference_fixture_was_recorded():
    """A fixture call the recorder missed would be a case the parity test
    never runs."""
    recorded = {(k.split(":")[0], int(k.split(":")[1].split("#")[0])) for k in _CALLS}
    assert _fixture_call_lines() <= recorded, _fixture_call_lines() - recorded
    assert len(_CALLS) >= 93
    assert len(_REVERTS) == 9, sorted(_REVERTS)


@pytest.mark.parametrize("case", sorted(_CALLS))
def test_fixture_parity(case):
    """The same findings (code, line) from both packages' ``check_file``,
    the port's on the fixture with ``ray_tpu`` renamed."""
    path, source, codes = _CALLS[case]
    ref = ref_graftlint.check_file(path, source=source, codes=codes)
    port = graftlint.check_file(_to_port(path), source=source and _to_port(source),
                                codes=codes)
    assert _findings(port) == _findings(ref)


@pytest.mark.parametrize("name", sorted(_REVERTS))
def test_historical_defect_is_flagged_in_the_port(name):
    """The defect the reference's test re-applies, re-applied to the
    port's file at the same path (every anchor text exists there), is
    flagged under the same codes (GL012's anchored at the send site, as
    in the reference)."""
    rel_path, old, new, codes = _REVERTS[name]
    path = os.path.join(PORT, *rel_path.split("/"))
    with open(path) as f:
        real = f.read()
    assert old in real, f"ray_tpu_torch/{rel_path} lacks the anchor text"
    fresh, _ = graftlint.check_paths([PORT], overrides={path: real.replace(old, new)},
                                     codes=set(codes))
    assert fresh and {f.code for f in fresh} == set(codes), fresh
    assert all(f.path.startswith(PORT + os.sep) for f in fresh), fresh


def test_fixture_sources_are_renamed_for_the_port():
    """The rename reaches GL004's ``get`` and the scoped paths."""
    src = textwrap.dedent("""
    import ray_tpu

    def poll_all(actors):
        return [ray_tpu.get(a.step.remote()) for a in actors]
    """)
    assert "import ray_tpu_torch\n" in _to_port(src)
    assert "ray_tpu_torch.get(" in _to_port(src)
    assert _to_port("ray_tpu/serve/x.py") == "ray_tpu_torch/serve/x.py"
    assert _to_port("ray_tpu_torch/serve/x.py") == "ray_tpu_torch/serve/x.py"
    assert [f.code for f in graftlint.check_file("x.py", source=_to_port(src))] == ["GL004"]
