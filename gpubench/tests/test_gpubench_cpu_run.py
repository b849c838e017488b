"""Whole runs of the harness on the CPU (``--device cpu`` skips the look
for a card; the rest of a run is the card's: the runtime, a TorchTrainer
worker, the window, the trace, the reference, the comparison), in a copy
of the benchmark to which tiny cells were added as files. With the timed
path broken underneath (a step that returns its state unchanged; half of
each batch left out of the loss) ``correct`` comes out false."""

import json
import os
import shutil
import subprocess
import sys
import tempfile

import pytest

from gpubench import ROOT, check
from gpubench.tests import tiny


@pytest.fixture(scope="module")
def copy(tmp_path_factory):
    return tiny.copy_with_tiny_cells(str(tmp_path_factory.mktemp("bench")))


@pytest.fixture
def tmp():
    """A short $TMPDIR for a run (the runtime's socket paths live under it)."""
    d = tempfile.mkdtemp(prefix="gb", dir="/tmp")
    yield d
    shutil.rmtree(d, ignore_errors=True)


def run(copy, tmp, *args, pythonpath=ROOT):
    env = dict(os.environ, TMPDIR=str(tmp), PYTHONPATH=pythonpath)
    env.pop("BENCH_RUN", None)
    p = subprocess.run([sys.executable, "-m", "gpubench", "--device", "cpu", "--seconds", "1",
                        *args], cwd=copy, env=env, capture_output=True, text=True, timeout=300)
    lines = p.stdout.strip().splitlines()
    return p.returncode, (json.loads(lines[-1]) if lines else None), p.stderr


def test_tiny_cell_runs_from_added_files(copy, tmp):
    rc, line, err = run(copy, tmp, "--workload", "tiny.llama", "--seed", "2147483659",
                        "--trace", "1")
    assert rc == 0, err[-3000:]
    assert list(line) == ["correct", "attempted", "failed", "metrics", "device", "breakdown",
                          "checks"]
    assert line["correct"] is True and line["failed"] == 0 and line["attempted"] >= 1
    steps = tiny.TRAFFIC["check_steps"] + line["attempted"]
    assert line["metrics"]["tiny_steps"] == {"value": float(steps), "unit": "count"}
    assert list(line["checks"]) == list(check.NAMES)
    assert err.strip().splitlines()[-1].startswith("check update_sample_err:")
    # the run removes its own files and the runtime's session under its TMPDIR
    assert os.listdir(tmp) == []


def test_tiny_cell_end_to_end_metrics(copy, tmp):
    rc, line, err = run(copy, tmp, "--workload", "tiny.llama", "--seed", "7", "--trace", "0")
    assert rc == 0, err[-3000:]
    assert line["correct"] is True
    assert set(line["metrics"]) == {"train_tokens_per_s", "setup_s"}  # no card: no peak memory
    assert "breakdown" not in line and line["device"]["platform"] == "cpu"


@pytest.mark.parametrize("fault, seed", [("unchanged", 5), ("half", 6), ("ascent", 8)])
def test_a_broken_timed_path_is_not_correct(copy, tmp, fault, seed):
    rc, line, err = run(copy, tmp, "--workload", "tiny.llama", "--seed", str(seed),
                        "--fault", fault)
    assert rc == 0, err[-3000:]
    assert line["correct"] is False
    assert any(c["value"] > c["limit"] for c in line["checks"].values())
    if fault == "ascent":     # only the sampled change sees an update of the wrong sign
        assert line["checks"]["update_sample_err"]["value"] > 1.5


def test_no_result_without_tmpdir(copy):
    env = {k: v for k, v in os.environ.items() if k not in ("TMPDIR", "BENCH_RUN")}
    p = subprocess.run([sys.executable, "-m", "gpubench", "--device", "cpu", "--workload",
                        "tiny.llama", "--seed", "1", "--seconds", "1"], cwd=copy,
                       env=dict(env, PYTHONPATH=ROOT), capture_output=True, text=True,
                       timeout=120)
    assert p.returncode != 0 and p.stdout.strip() == "" and "TMPDIR" in p.stderr


def test_a_long_tmpdir_puts_the_session_in_the_checkout(copy, tmp):
    """A TMPDIR too long for the runtime's socket paths: the session goes
    to build/rt in the checkout, and the run removes it."""
    long = os.path.join(tmp, "x" * 70)
    os.makedirs(long)
    rc, line, err = run(copy, long, "--workload", "tiny.llama", "--seed", "9", "--trace", "0")
    assert rc == 0, err[-3000:]
    assert line["correct"] is True
    assert not os.path.exists(os.path.join(copy, "build", "rt")) and os.listdir(long) == []


def test_no_result_without_the_program(tmp_path, tmp):
    """A directory with only BENCHMARK.json and gpubench/ exits non-zero
    and prints no result."""
    bare = tmp_path / "bare"
    bare.mkdir()
    tiny.copy_with_tiny_cells(str(bare))
    rc, line, err = run(str(bare), tmp, "--workload", "tiny.llama", "--seed", "1",
                        pythonpath="")
    assert rc != 0 and line is None and "ray_tpu_torch" in err


def test_no_result_without_a_card(copy, tmp):
    env = dict(os.environ, TMPDIR=tmp, PYTHONPATH=ROOT, CUDA_VISIBLE_DEVICES="")
    p = subprocess.run([sys.executable, "-m", "gpubench", "--workload", "tiny.llama", "--seed",
                        "1", "--seconds", "1"], cwd=copy, env=env, capture_output=True,
                       text=True, timeout=120)
    assert p.returncode != 0 and p.stdout.strip() == ""
