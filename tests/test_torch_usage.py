"""Usage stats on both packages (tests/test_small_components.py's
``test_usage_stats_report``).

The report of each runtime holds the libraries and tags recorded, the
node count, and the source, which names the package that wrote it
(``ray_tpu_torch`` on the port, where every name the runtime writes
carries that prefix). Importing ``llm`` records "llm" on both,
importing ``data`` and ``workflow`` records "data" and "workflow", and
importing ``tune`` records "tune" (and "train", which it imports),
checked in a fresh process for each package, since a package imported
before ``init`` records only into the first runtime it meets.

Cost: one runtime per package in this process, and one short-lived
process per package.
"""

import json
import os
import subprocess
import sys

import pytest

import ray_tpu
import ray_tpu_torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTS = [ray_tpu, ray_tpu_torch]
IDS = ["ray_tpu", "ray_tpu_torch"]


@pytest.mark.parametrize("rt", RTS, ids=IDS)
def test_usage_stats_report(rt):
    usage = __import__(f"{rt.__name__}._private.usage", fromlist=["usage"])
    rt.init(num_cpus=1, max_workers=1)
    try:
        usage.record_library_usage("data")
        usage.record_extra_usage_tag("test_tag", "42")
        report = usage.get_usage_report()
        assert "data" in report["library_usages"]
        assert report["extra_usage_tags"]["test_tag"] == "42"
        assert report["total_num_nodes"] >= 1
        path = usage.write_usage_report(rt._private.worker._session_dir)
        with open(path) as f:
            assert json.load(f)["source"] == rt.__name__
    finally:
        rt.shutdown()


PROBE = """
import sys; sys.path.insert(0, {repo!r})
import {rt}.{lib}
import {rt} as rt
from {rt}._private import usage
rt.init(num_cpus=1, max_workers=1)
print("LIBS", usage.get_usage_report()["library_usages"])
rt.shutdown()
"""


@pytest.mark.parametrize("rt", RTS, ids=IDS)
def test_importing_llm_records_its_usage(rt):
    out = subprocess.run([sys.executable, "-c", PROBE.format(repo=REPO, rt=rt.__name__,
                                                             lib="llm")],
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "LIBS ['llm']" in out.stdout, out.stdout


@pytest.mark.parametrize("rt", RTS, ids=IDS)
def test_importing_data_and_workflow_records_their_usage(rt):
    out = subprocess.run([sys.executable, "-c", PROBE.format(
        repo=REPO, rt=rt.__name__, lib="data, {rt}.workflow".format(rt=rt.__name__))],
        capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "LIBS ['data', 'workflow']" in out.stdout, out.stdout


@pytest.mark.parametrize("rt", RTS, ids=IDS)
def test_importing_tune_records_its_usage(rt):
    out = subprocess.run([sys.executable, "-c", PROBE.format(repo=REPO, rt=rt.__name__,
                                                             lib="tune")],
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "LIBS ['train', 'tune']" in out.stdout, out.stdout


@pytest.mark.parametrize("rt", RTS, ids=IDS)
def test_importing_rllib_records_its_usage(rt):
    out = subprocess.run([sys.executable, "-c", PROBE.format(repo=REPO, rt=rt.__name__,
                                                             lib="rllib")],
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "LIBS ['rllib']" in out.stdout, out.stdout
