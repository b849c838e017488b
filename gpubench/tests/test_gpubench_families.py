"""Model families found by name: a family added as files only runs a cell
end to end, its pins handed from the program's first steps to its
reference; and the Llama family, moved out of the harness's files, reads
what the harness read before (weights bit for bit, the reference's losses
and norms, the check numbers, the FLOP counts), frozen here from the tree
before the move."""

import hashlib
import json
import os
import shutil
import subprocess
import sys
import tempfile

import pytest
import torch

from gpubench import ROOT, check, flops, program, reference, registry, traffic as traffic_gen
from gpubench import weights
from gpubench.tests import tiny

# a family of its own, beside the Llama family: the Llama program and
# reference, and pins (each row's first four token ids, read from the
# program's batch) that its reference checks against its own batch and prints
TINYFAM = '''"""A test family: the Llama family's program, leaves, reference and
FLOPs, and pins its reference checks."""

import sys

from gpubench.families import llama
from gpubench.families.llama import (attention_flops_per_token, leaves,  # noqa: F401
                                     matmul_params_per_token, model_config, param_specs)


def pins(params, batch, mcfg):
    return [row[:4] for row in batch["tokens"].tolist()]


class Model(llama.Model):
    def loss_and_grads(self, params, tokens, grads=None, scale=1.0, pins=None):
        want = [row[:4] for row in tokens.tolist()]
        if pins != want:
            raise ValueError(f"pins {pins} where the batch gives {want}")
        print(f"tinyfam pins: {pins}", file=sys.stderr, flush=True)
        return super().loss_and_grads(params, tokens, grads, scale)
'''


def copy_with_a_family(dest: str) -> str:
    """The tiny copy with a cell ``tiny.fam`` of the family ``tinyfam``,
    added as new files and a new entry of ``BENCHMARK.json``."""
    tiny.copy_with_tiny_cells(dest)
    pkg = os.path.join(dest, "gpubench")
    with open(os.path.join(pkg, "families", "tinyfam.py"), "w") as f:
        f.write(TINYFAM)
    cfg = {**tiny.LLAMA, "name": "tiny-fam", "program": {**tiny.LLAMA["program"], "family": "tinyfam"}}
    cell = {"config": "tiny-fam", "traffic": "train.b2.s64", "chips": 1, "why": "a family test"}
    for kind, name, obj in (("configs", "tiny-fam", cfg), ("workloads", "tiny.fam", cell),
                            ("limits", "tiny.fam", tiny.LIMITS)):
        with open(os.path.join(pkg, kind, f"{name}.json"), "w") as f:
            json.dump(obj, f)
    path = os.path.join(dest, "BENCHMARK.json")
    with open(path) as f:
        bench = json.load(f)
    bench["workloads"].append({"name": "tiny.fam", **cell})
    with open(path, "w") as f:
        json.dump(bench, f)
    return dest


@pytest.mark.time_limit(300)
def test_a_family_added_as_files_runs_end_to_end(tmp_path):
    copy = copy_with_a_family(str(tmp_path / "bench"))
    tmp = tempfile.mkdtemp(prefix="gb", dir="/tmp")
    try:
        env = dict(os.environ, TMPDIR=tmp, PYTHONPATH=ROOT)
        env.pop("BENCH_RUN", None)
        seed = 2147483661
        p = subprocess.run([sys.executable, "-m", "gpubench", "--device", "cpu", "--seconds", "1",
                            "--workload", "tiny.fam", "--seed", str(seed), "--trace", "0"],
                           cwd=copy, env=env, capture_output=True, text=True, timeout=280)
        assert p.returncode == 0, p.stderr[-3000:]
        line = json.loads(p.stdout.strip().splitlines()[-1])
        assert line["correct"] is True, line
        # the reference got each check step's pins, as the program read them
        said = [x.split("tinyfam pins: ", 1)[1] for x in p.stderr.splitlines()
                if x.startswith("tinyfam pins: ")]
        want = [str([row[:4] for row in traffic_gen.batch(
            tiny.TRAFFIC, tiny.LLAMA["vocab_size"], seed, k, torch.device("cpu"))["tokens"].tolist()])
            for k in range(1, tiny.TRAFFIC["check_steps"] + 1)]
        assert said == want
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def test_every_configuration_names_a_family_with_the_interface():
    for name in registry.names("configs"):
        fam = registry.family(registry.config(name)["program"]["family"])
        for attr in ("model_config", "param_specs", "leaves", "Model",
                     "matmul_params_per_token", "attention_flops_per_token"):
            assert hasattr(fam, attr), (name, attr)
    with pytest.raises(FileNotFoundError):
        registry.family("no_such_family")
    with pytest.raises(ValueError):
        registry.family("../llama")


# read on the tree before the family moved (tiny.LLAMA; weights of seed 5;
# reference and program, the cells' bf16 paths, of seed 21)
BEFORE = {
    "digests": {"embed": "e6a4ab6da5d05edf", "blocks.attn_norm": "02722f124d0f1736",
                "blocks.wq": "395edcb1a3d8e31b", "blocks.wk": "f3e16779c5cccc13",
                "blocks.wv": "a94933f6fab65084", "blocks.wo": "1d4ffbf45db86f26",
                "blocks.mlp_norm": "02722f124d0f1736", "blocks.w_gate": "1bfbdddd9fa4cb7a",
                "blocks.w_up": "678aab46789d413b", "blocks.w_down": "9be217ad4efd2920",
                "final_norm": "2f20cd03c9cd392a", "lm_head": "50edd44983ff6009"},
    "ref_losses": [6.068352699279785, 5.99720573425293, 6.048718452453613],
    "ref_grad_norms": {"blocks.attn_norm": 0.20198111236095428, "blocks.wq": 0.7787731885910034,
                       "blocks.wk": 0.7604408264160156, "blocks.wv": 1.0953483581542969,
                       "blocks.wo": 1.2061941623687744, "blocks.mlp_norm": 0.13947463035583496,
                       "blocks.w_gate": 0.8210826516151428, "blocks.w_up": 0.8171533942222595,
                       "blocks.w_down": 1.1585988998413086, "final_norm": 0.17795661091804504,
                       "lm_head": 0.7372623085975647, "embed": 1.4519038200378418},
    "ref_update_norms": {"embed": 0.055589448660612106, "blocks.attn_norm": 0.006621247400993671,
                         "blocks.wq": 0.053435732233223475, "blocks.wk": 0.037794106133572425,
                         "blocks.wv": 0.03786975218145404, "blocks.wo": 0.05395859370277417,
                         "blocks.mlp_norm": 0.006873738406949991,
                         "blocks.w_gate": 0.07525703964448996, "blocks.w_up": 0.07500749967901602,
                         "blocks.w_down": 0.07504021791596051, "final_norm": 0.006839968729764223,
                         "lm_head": 0.07648350298404694},
    "gaps": {"loss_gap": 0.0006443481350001574, "grad_norm_gap": 0.0012090062216325705,
             "grad_sample_err": 0.018284007917709687, "update_norm_gap": 0.0011481559426756442,
             "update_sample_err": 0.08470151947446904},
    "prog_losses": [6.067325115203857, 6.001070022583008, 6.049439907073975],
    "matmul_params": 90112, "flops_per_token_s64": 589824.0,
}


@pytest.mark.time_limit(120)
def test_the_llama_family_reads_what_the_harness_read_before_it_moved():
    cfg, dev = tiny.LLAMA, torch.device("cpu")
    params = weights.make(cfg, 5, dev)
    digests = {leaf.name: hashlib.sha256(weights.get(params, leaf.name).numpy().tobytes())
               .hexdigest()[:16] for leaf in weights.leaves(cfg)}
    assert digests == BEFORE["digests"]
    ref = reference.run(cfg, tiny.TRAFFIC, 21, dev)
    state, step = program.setup(cfg, tiny.TRAFFIC, 21, dev)
    _, prog = program.first_steps(state, step, cfg, tiny.TRAFFIC, 21, dev)
    rel = pytest.approx
    assert ref["losses"] == rel(BEFORE["ref_losses"], rel=1e-6)
    assert prog["losses"] == rel(BEFORE["prog_losses"], rel=1e-6)
    assert ref["grad_norms"] == rel(BEFORE["ref_grad_norms"], rel=1e-6)
    assert ref["update_norms"] == rel(BEFORE["ref_update_norms"], rel=1e-6)
    assert check.gaps(prog, ref) == rel(BEFORE["gaps"], rel=1e-6)
    assert flops.matmul_params_per_token(cfg) == BEFORE["matmul_params"]
    assert flops.train_flops_per_token(cfg, 64) == BEFORE["flops_per_token_s64"]
