"""A cell laid over a mesh, on the CPU over gloo: each rank's part of the
seeded tree, the sharded program's readings against a one-rank run of the
same global batch, the reference spread over ranks against the reference
in one process, and whole runs of a two-rank cell (``tiny.llama.fsdp2``)
through the harness: sound, with half of each batch left out, with the
exchange between the ranks left out, and with a module that no run may
load loaded on one rank alone."""

import json
import math
import os
import shutil
import subprocess
import sys
import tempfile

import pytest
import torch

from gpubench import ROOT, program, reference, weights
from gpubench.tests import tiny

# float32 paths on both sides: the ranks' readings differ from one rank's
# by the order of float32 sums alone (the reduce-scatter's, the loss's,
# the norms' over shards), which moves a norm by a few 1e-7 and a sampled
# element by a few 1e-7 of the sample's norm; Adam's first update divides
# by the gradient's size, so an update moves by up to 1e-4 of its norm
NORM_RTOL, GRAD_SAMPLE_TOL, UPDATE_SAMPLE_TOL, LOSS_RTOL = 1e-5, 1e-5, 1e-3, 1e-6


def _rel_err(a, b):
    return math.sqrt(sum((x - y) ** 2 for x, y in zip(a, b)) / max(sum(y * y for y in b), 1e-300))


def _sharded_rank(rank, world, port, out):
    import torch.distributed as dist

    from ray_tpu_torch import parallel

    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                            world_size=world)
    try:
        mesh = parallel.make_mesh(device="cpu", **tiny.MESH)
        cfg, dev = tiny.f32(tiny.LLAMA), torch.device("cpu")
        state, step = program.setup(cfg, tiny.TRAFFIC_B4, 11, dev, None, mesh)
        _, got = program.first_steps(state, step, cfg, tiny.TRAFFIC_B4, 11, dev, mesh=mesh)
    finally:
        dist.destroy_process_group()
    with open(f"{out}.{rank}", "w") as f:
        json.dump(got, f)


def test_the_parts_readings_sum_to_the_whole_trees():
    """Each rank's part of a two-way cut of every leaf's second dimension
    (the first where it has one): the counted parts' readings of the
    change and of the sample sum to the whole tree's."""
    cfg, dev, seed = tiny.LLAMA, torch.device("cpu"), 3
    whole = weights.make(cfg, seed, dev)
    for leaf in weights.leaves(cfg):
        weights.get(whole, leaf.name).add_(0.5)
    made = []
    for r in range(2):
        parts, tree = {}, {}
        for leaf in weights.leaves(cfg):
            d = 1 if len(leaf.shape) > 1 else 0
            n = leaf.shape[d] // 2
            cut = tuple(slice(r * n, (r + 1) * n) if i == d else slice(0, m)
                        for i, m in enumerate(leaf.shape))
            parts[leaf.name] = weights.Part(cut, True)
            weights.put(tree, leaf.name, weights.get(whole, leaf.name)[cut].clone())
        made.append((parts, tree))
    want_sq, want_picked = weights.change_parts(cfg, seed, whole)
    shares = [weights.change_parts(cfg, seed, t, parts) for parts, t in made]
    samples = [weights.sample(cfg, seed, t, 2.0, parts) for parts, t in made]
    want_sample = weights.sample(cfg, seed, whole, 2.0)
    for leaf in weights.leaves(cfg):
        n = leaf.name
        assert sum(s[0][n] for s in shares) == pytest.approx(want_sq[n], rel=1e-6)
        assert [a + b for a, b in zip(shares[0][1][n], shares[1][1][n])] == want_picked[n]
        assert [a + b for a, b in zip(samples[0][n], samples[1][n])] == want_sample[n]


@pytest.mark.time_limit(240)
def test_sharded_readings_agree_with_one_rank(tmp_path):
    out = str(tmp_path / "readings")
    torch.multiprocessing.spawn(_sharded_rank, args=(2, reference.free_port(), out), nprocs=2)
    two = []
    for r in range(2):
        with open(f"{out}.{r}") as f:
            two.append({k: v for k, v in json.load(f).items() if k != "seconds"})
    assert two[0] == two[1]          # every rank reads the whole tree's readings
    cfg, dev = tiny.f32(tiny.LLAMA), torch.device("cpu")
    state, step = program.setup(cfg, tiny.TRAFFIC_B4, 11, dev)
    _, one = program.first_steps(state, step, cfg, tiny.TRAFFIC_B4, 11, dev)
    got = two[0]
    assert got["losses"] == pytest.approx(one["losses"], rel=LOSS_RTOL)
    for key in ("grad_norms", "update_norms"):
        assert got[key] == pytest.approx(one[key], rel=NORM_RTOL), key
    for n in one["grad_sample"]:
        assert _rel_err(got["grad_sample"][n], one["grad_sample"][n]) < GRAD_SAMPLE_TOL, n
        assert _rel_err(got["update_sample"][n], one["update_sample"][n]) < UPDATE_SAMPLE_TOL, n


@pytest.mark.time_limit(240)
def test_the_reference_spread_over_ranks_agrees_with_one_process(tmp_path):
    """Two ranks, one sequence at a time, gradients summed before the clip,
    each rank updating half of the leaves' layers: the readings of the
    reference in one process, to float32 sums."""
    cfg, dev = tiny.LLAMA, torch.device("cpu")
    one = reference.run(cfg, tiny.TRAFFIC_B4, 13, dev)
    two = reference.run(cfg, tiny.TRAFFIC_B4, 13, dev, ranks=2, workdir=str(tmp_path))
    assert two["losses"] == pytest.approx(one["losses"], rel=LOSS_RTOL)
    for key in ("grad_norms", "update_norms"):
        assert two[key] == pytest.approx(one[key], rel=NORM_RTOL), key
    for n in one["grad_sample"]:
        assert _rel_err(two["grad_sample"][n], one["grad_sample"][n]) < GRAD_SAMPLE_TOL, n
        assert _rel_err(two["update_sample"][n], one["update_sample"][n]) < UPDATE_SAMPLE_TOL, n


@pytest.fixture(scope="module")
def copy(tmp_path_factory):
    return tiny.copy_with_tiny_cells(str(tmp_path_factory.mktemp("bench")))


@pytest.mark.time_limit(300)
@pytest.mark.parametrize("fault, seed, correct", [(None, 2147483663, True), ("half", 17, False),
                                                  ("noexchange", 19, False)])
def test_a_two_rank_cell_through_the_harness(copy, fault, seed, correct):
    tmp = tempfile.mkdtemp(prefix="gb", dir="/tmp")
    try:
        env = dict(os.environ, TMPDIR=tmp, PYTHONPATH=ROOT)
        env.pop("BENCH_RUN", None)
        args = ["--workload", "tiny.llama.fsdp2", "--seed", str(seed), "--trace", "1"]
        p = subprocess.run([sys.executable, "-m", "gpubench", "--device", "cpu", "--seconds", "1",
                            *args, *(["--fault", fault] if fault else [])],
                           cwd=copy, env=env, capture_output=True, text=True, timeout=280)
        assert p.returncode == 0, p.stderr[-3000:]
        line = json.loads(p.stdout.strip().splitlines()[-1])
        assert line["correct"] is correct, line["checks"]
        assert line["failed"] == 0 and line["attempted"] >= 1
        steps = tiny.TRAFFIC_B4["check_steps"] + line["attempted"]
        assert line["metrics"]["tiny_steps"]["value"] == float(steps)
        assert os.listdir(tmp) == []
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def test_a_cell_on_several_cards_needs_a_mesh_of_as_many_ranks(copy):
    path = os.path.join(copy, "gpubench", "workloads", "tiny.llama.fsdp2.json")
    with open(path) as f:
        cell = json.load(f)
    try:
        with open(path, "w") as f:
            json.dump({**cell, "mesh": {"fsdp": 4}}, f)
        env = dict(os.environ, TMPDIR="/tmp", PYTHONPATH=ROOT)
        p = subprocess.run([sys.executable, "-m", "gpubench", "--device", "cpu", "--seconds", "1",
                            "--workload", "tiny.llama.fsdp2", "--seed", "1"], cwd=copy, env=env,
                           capture_output=True, text=True, timeout=120)
        assert p.returncode != 0 and p.stdout.strip() == "" and "mesh" in p.stderr
    finally:
        with open(path, "w") as f:
            json.dump(cell, f)


# a reader whose probe (every rank runs it) loads a module that no run may
# load on rank 1 alone
_PLANT = ('"""A test metric: loads a banned module on rank 1."""\n\nimport sys\nimport types\n\n\n'
          'def probe(ctx):\n    if ctx["rank"] == 1:\n'
          '        sys.modules.setdefault("flax", types.ModuleType("flax"))\n    return {}\n\n\n'
          'def read(run):\n    return None\n')


@pytest.mark.time_limit(300)
def test_a_banned_module_on_one_rank_alone_ends_the_run(tmp_path):
    dest = tiny.copy_with_tiny_cells(str(tmp_path / "bench"))
    with open(os.path.join(dest, "gpubench", "metrics", "tiny_plant.py"), "w") as f:
        f.write(_PLANT)
    path = os.path.join(dest, "BENCHMARK.json")
    with open(path) as f:
        bench = json.load(f)
    bench["per_layer"].append({"name": "tiny_plant", "unit": "count", "better": "lower",
                               "source": "host_clock", "layer": "train step",
                               "moves": "train_tokens_per_s", "workloads": ["tiny.llama.fsdp2"]})
    with open(path, "w") as f:
        json.dump(bench, f)
    tmp = tempfile.mkdtemp(prefix="gb", dir="/tmp")
    try:
        env = dict(os.environ, TMPDIR=tmp, PYTHONPATH=ROOT)
        env.pop("BENCH_RUN", None)
        p = subprocess.run([sys.executable, "-m", "gpubench", "--device", "cpu", "--seconds", "1",
                            "--workload", "tiny.llama.fsdp2", "--seed", "23", "--trace", "1"],
                           cwd=dest, env=env, capture_output=True, text=True, timeout=280)
        assert p.returncode == 3, p.stderr[-3000:]
        assert p.stdout.strip() == ""
        assert "flax" in p.stderr.strip().splitlines()[-1]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


@pytest.mark.time_limit(120)
def test_a_rank_of_the_reference_that_loads_a_banned_module_fails(tmp_path):
    """A reference rank process with a banned module loaded exits 3 and
    writes no readings."""
    job = {"cfg": tiny.LLAMA, "traffic": tiny.TRAFFIC, "seed": 3, "device_type": "cpu",
           "fp8": False, "pins": None, "port": reference.free_port(), "world": 1,
           "out": str(tmp_path / "reference.json")}
    with open(tmp_path / "job.json", "w") as f:
        json.dump(job, f)
    code = ("import sys, types; sys.modules['jaxlib'] = types.ModuleType('jaxlib'); "
            "from gpubench import reference; sys.argv = ['x', sys.argv[1], '0']; "
            "import runpy; runpy.run_module('gpubench.reference', run_name='__main__')")
    p = subprocess.run([sys.executable, "-c", code, str(tmp_path / "job.json")], cwd=ROOT,
                       capture_output=True, text=True, timeout=110)
    assert p.returncode == 3, p.stderr[-3000:]
    assert "jaxlib" in p.stderr and not os.path.exists(job["out"])
