"""Card test (the ``cuda`` marker; it skips without a card, decided inside
the test): a traced run reads the train step's phases. Run it on the card
with

    python3 -m pytest --noconftest -p no:cacheprovider -q gpubench/tests/test_gpubench_card_phases.py
"""

import json
import os
import re
import shutil
import subprocess
import sys
import tempfile

import pytest
import torch

from gpubench import ROOT, check, phases
from gpubench.tests import tiny
from gpubench.tests.test_gpubench_card import SMALL, SMALL_TRAFFIC

READERS = ("forward_ms_per_step", "backward_ms_per_step", "recompute_ms_per_step",
           "optimizer_ms_per_step")


@pytest.mark.cuda
def test_a_traced_run_on_the_card_reads_the_step_phases():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    root = tempfile.mkdtemp(prefix="gbp")
    try:
        copy = tiny.copy_with_tiny_cells(os.path.join(root, "c"))
        pkg = os.path.join(copy, "gpubench")
        cfg = {**SMALL, "num_hidden_layers": 4}
        for kind, name, obj in (("configs", "small-llama", cfg),
                                ("traffic", "train.b2.s1024", SMALL_TRAFFIC),
                                ("workloads", "small.llama",
                                 {"config": "small-llama", "traffic": "train.b2.s1024",
                                  "chips": 1, "why": "a card test cell"}),
                                ("limits", "small.llama", dict.fromkeys(check.NAMES, 0.5))):
            with open(os.path.join(pkg, kind, f"{name}.json"), "w") as f:
                json.dump(obj, f)
        with open(os.path.join(copy, "BENCHMARK.json")) as f:
            bench = json.load(f)
        bench["per_layer"] = [dict(m, workloads=["small.llama"]) for m in bench["per_layer"]
                              if m["name"] in READERS]
        with open(os.path.join(copy, "BENCHMARK.json"), "w") as f:
            json.dump(bench, f)
        tmp = os.path.join(root, "t")
        os.makedirs(tmp)
        p = subprocess.run([sys.executable, "-m", "gpubench", "--workload", "small.llama",
                            "--seed", "2147483801", "--seconds", "3", "--trace", "1"],
                           cwd=copy, env=dict(os.environ, TMPDIR=tmp, PYTHONPATH=ROOT),
                           capture_output=True, text=True, timeout=600)
        assert p.returncode == 0, p.stderr[-4000:]
        line = json.loads(p.stdout.strip().splitlines()[-1])
        m = {k: v["value"] for k, v in line["metrics"].items()}
        assert set(m) == set(READERS), m
        assert all(v > 0 for v in m.values()), m
        assert m["recompute_ms_per_step"] < m["backward_ms_per_step"]
        step_ms = m["forward_ms_per_step"] + m["backward_ms_per_step"] + \
            m["optimizer_ms_per_step"]
        (said,) = [json.loads(x.split("gpubench phases: ", 1)[1]) for x in p.stderr.splitlines()
                   if x.startswith("gpubench phases: ")]
        assert said["phases"]["llama.block"]["calls"] == 2 * 4 * phases.STEPS
        assert step_ms >= 0.9 * 1e3 * said["kernel_s"] / said["steps"], (m, said)
        # and against the window's own kernels a step (the accepted trace)
        (kernel_s,) = re.findall(r"gemm [0-9.]+ s of ([0-9.]+) s", p.stderr)
        assert step_ms >= 0.9 * 1e3 * float(kernel_s) / line["attempted"], (m, kernel_s)
    finally:
        shutil.rmtree(root, ignore_errors=True)
