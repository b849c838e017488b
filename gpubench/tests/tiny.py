"""Tiny configurations and a copy of the benchmark with a tiny cell added
as files, for the CPU tests."""

import json
import os
import shutil

import gpubench

PROGRAM = {"dtype": "bfloat16", "param_dtype": "float32", "remat": True,
           "attention_impl": "flash"}

LLAMA = {"name": "tiny-llama", "source": "test", "hidden_size": 64, "intermediate_size": 128,
         "num_attention_heads": 4, "num_key_value_heads": 2, "head_dim": 16,
         "num_hidden_layers": 2, "vocab_size": 256, "max_position_embeddings": 64,
         "rope_theta": 10000.0, "rms_norm_eps": 1e-05,
         "program": {**PROGRAM, "family": "llama", "ce_impl": "fused"}}

TRAFFIC = {"kind": "train", "batch": 2, "seq_len": 64, "tokens": "uniform", "check_steps": 3,
           "optimizer": {"learning_rate": 3e-4, "warmup_steps": 0, "total_steps": 10000,
                         "weight_decay": 0.1, "grad_clip": 1.0, "b1": 0.9, "b2": 0.95}}

# the mesh cell's: 2 rows a rank over fsdp 2 (the fused CE takes 128 rows)
TRAFFIC_B4 = {**TRAFFIC, "batch": 4}
MESH = {"fsdp": 2}

# between the program's readings and the float8 control's at these sizes
# (seeds 21-26: grad_norm_gap <= 2.6e-3 against >= 1.5e-2; grad_sample_err
# <= 0.0188 against >= 0.198; update_sample_err <= 0.0895 against >= 0.365,
# an update of the wrong sign 2.0)
LIMITS = {"loss_gap": 2e-3, "grad_norm_gap": 7e-3, "grad_sample_err": 0.08,
          "update_norm_gap": 3e-3, "update_sample_err": 0.2}


def f32(cfg: dict) -> dict:
    """``cfg`` with the program's plain float32 paths."""
    return {**cfg, "program": {**cfg["program"], "dtype": "float32", "attention_impl": "xla",
                               "ce_impl": "xla"}}


def copy_with_tiny_cells(dest: str) -> str:
    """A copy of the benchmark (``gpubench/`` and ``BENCHMARK.json``) at
    ``dest`` with two tiny cells, ``tiny.llama`` and ``tiny.llama.fsdp2``
    (two ranks of a mesh, over gloo), and a
    metric ``tiny_steps`` (with a probe: the state's steps after the window)
    added: new files and new entries of ``BENCHMARK.json`` only."""
    shutil.copytree(gpubench.PKG_DIR, os.path.join(dest, "gpubench"),
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(os.path.join(gpubench.ROOT, "BENCHMARK.json"), dest)
    pkg = os.path.join(dest, "gpubench")

    def put(kind, name, obj):
        with open(os.path.join(pkg, kind, f"{name}.json"), "w") as f:
            json.dump(obj, f)

    put("configs", LLAMA["name"], LLAMA)
    put("traffic", "train.b2.s64", TRAFFIC)
    put("workloads", "tiny.llama", {"config": LLAMA["name"], "traffic": "train.b2.s64",
                                    "chips": 1, "why": "a test cell"})
    put("limits", "tiny.llama", LIMITS)
    put("traffic", "train.b4.s64", TRAFFIC_B4)
    mesh_cell = {"config": LLAMA["name"], "traffic": "train.b4.s64", "chips": 2, "mesh": MESH,
                 "why": "a test cell over two ranks"}
    put("workloads", "tiny.llama.fsdp2", mesh_cell)
    put("limits", "tiny.llama.fsdp2", LIMITS)
    with open(os.path.join(pkg, "metrics", "tiny_steps.py"), "w") as f:
        f.write('"""Steps the train state has taken after the window, read in the worker\n'
                '(a test metric with a probe)."""\n\n\n'
                'def probe(ctx):\n    return {"tiny_steps": float(ctx["state"].step)}\n\n\n'
                'def read(run):\n    return run["probes"].get("tiny_steps")\n')
    # BENCHMARK.json gains entries; no file of the harness changes
    path = os.path.join(dest, "BENCHMARK.json")
    with open(path) as f:
        bench = json.load(f)
    cells = ["tiny.llama", "tiny.llama.fsdp2"]
    bench["workloads"].append({"name": "tiny.llama", "config": LLAMA["name"],
                               "traffic": "train.b2.s64", "chips": 1, "why": "a test cell"})
    bench["workloads"].append({"name": "tiny.llama.fsdp2", **mesh_cell})
    bench["per_layer"].append({"name": "tiny_steps", "unit": "count", "better": "higher",
                               "source": "host_clock", "layer": "train step",
                               "moves": "train_tokens_per_s", "workloads": cells})
    with open(path, "w") as f:
        json.dump(bench, f)
    return dest
