"""Card tests (the ``cuda`` marker; each skips without a card, decided
inside the test). Run them on the card with

    python3 -m pytest --noconftest -p no:cacheprovider -q gpubench/tests/test_gpubench_card.py
"""

import json
import os
import shutil
import subprocess
import sys
import tempfile

import pytest
import torch

from gpubench import ROOT, check, weights
from gpubench.tests import tiny

# hd 128 and multiples of 128 rows and columns: the kernels' shapes
SMALL = {**tiny.LLAMA, "name": "small-llama", "hidden_size": 1024, "intermediate_size": 2048,
         "num_attention_heads": 8, "num_key_value_heads": 2, "head_dim": 128,
         "vocab_size": 4096, "max_position_embeddings": 2048}
SMALL_TRAFFIC = {**tiny.TRAFFIC, "batch": 2, "seq_len": 1024}


def need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")


@pytest.mark.cuda
def test_weights_remade_slice_by_slice_on_the_card():
    need_card()
    cfg = {**SMALL, "num_hidden_layers": 3}
    dev = torch.device("cuda", 0)
    params = weights.make(cfg, 2147483777, dev)
    for leaf in weights.leaves(cfg):
        t = weights.get(params, leaf.name)
        for l in range(leaf.shape[0] if leaf.layered else 1):
            again = weights.layer_slice(cfg, 2147483777, leaf, l, dev)
            assert torch.equal(t[l] if leaf.layered else t, again), (leaf.name, l)


@pytest.mark.cuda
def test_a_traced_run_on_the_card_reads_every_trace_metric():
    need_card()
    root = tempfile.mkdtemp(prefix="gbc")
    try:
        copy = tiny.copy_with_tiny_cells(os.path.join(root, "c"))
        pkg = os.path.join(copy, "gpubench")
        for kind, name, obj in (("configs", "small-llama", SMALL),
                                ("traffic", "train.b2.s1024", SMALL_TRAFFIC),
                                ("workloads", "small.llama",
                                 {"config": "small-llama", "traffic": "train.b2.s1024",
                                  "chips": 1, "why": "a card test cell"}),
                                ("limits", "small.llama", dict.fromkeys(check.NAMES, 0.5))):
            with open(os.path.join(pkg, kind, f"{name}.json"), "w") as f:
                json.dump(obj, f)
        with open(os.path.join(copy, "BENCHMARK.json")) as f:
            bench = json.load(f)
        for m in bench["per_layer"]:
            m["workloads"].append("small.llama")
        with open(os.path.join(copy, "BENCHMARK.json"), "w") as f:
            json.dump(bench, f)
        tmp = os.path.join(root, "t")
        os.makedirs(tmp)
        p = subprocess.run([sys.executable, "-m", "gpubench", "--workload", "small.llama",
                            "--seed", "2147483800", "--seconds", "3", "--trace", "1"],
                           cwd=copy, env=dict(os.environ, TMPDIR=tmp, PYTHONPATH=ROOT),
                           capture_output=True, text=True, timeout=600)
        assert p.returncode == 0, p.stderr[-4000:]
        line = json.loads(p.stdout.strip().splitlines()[-1])
        assert line["device"]["platform"] == "gpu" and line["device"]["count"] == 1
        assert 0 < line["device"]["busy_s"] <= line["device"]["window_s"]
        m = {k: v["value"] for k, v in line["metrics"].items()}
        for name in ("step_mfu_pct", "attn_roofline_pct", "ce_roofline_pct"):
            assert 0 < m[name] <= 100, (name, m)
        assert m["launches_per_step"] > 0 and m["elementwise_ms_per_step"] > 0
        assert line["breakdown"]["device_ops"] and line["checks"]
    finally:
        shutil.rmtree(root, ignore_errors=True)
