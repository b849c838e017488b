"""The port stands alone: importing ray_tpu_torch (its train, air and
serve libraries, ``llm``'s Serve deployments and batch processor, dag,
channels, workflow, data, the multi-host modules, tune, util.collective,
the rest of util, rllib with rllib.podracer, and tools.graftlint
included) and running it (an Anakin superstep, a PPO update and a lint of
one file among it) pulls in neither JAX nor
the ray_tpu package, in the driver, in a runtime worker, in a worker a
node agent forked, in a train worker, in a Serve replica, in the actor of
a channel-mode compiled DAG, in a Data pool actor, in a Tune trial or in
a store group's rank, and its entry points refuse to run on the CPU
unless asked to."""

import os
import subprocess
import sys
import typing

import pytest
import torch

from ray_tpu_torch import parallel, resolve_device
from ray_tpu_torch.llm import LLMConfig, LlamaEngine
from ray_tpu_torch.models import convert, llama, moe_llama, params_from_numpy, vit
from ray_tpu_torch.ops import init_moe_params

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = """
import sys
import torch
import ray_tpu_torch
from ray_tpu_torch.llm import LlamaEngine
from ray_tpu_torch.models import llama
from ray_tpu_torch.ops import cuda_attention, cuda_ce
cfg = llama.LLAMA_TINY
params = llama.init_params(torch.Generator().manual_seed(0), cfg, "cpu")
logits = llama.forward(params, torch.zeros((1, 8), dtype=torch.long), cfg)
assert logits.shape == (1, 8, cfg.vocab_size) and bool(torch.isfinite(logits).all())
LlamaEngine(cfg, params, max_batch=1, max_seq=32, device="cpu").generate([1, 2], max_tokens=2)
from ray_tpu_torch import parallel
opt = parallel.default_optimizer(1e-3, warmup_steps=1, total_steps=4)
state = parallel.create_train_state(torch.Generator().manual_seed(0),
                                    lambda g: llama.init_params(g, cfg, "cpu"), opt, device="cpu")
step = parallel.make_train_step(lambda p, b: llama.loss_fn(p, b, cfg), opt)
state, m = step(state, {"tokens": torch.zeros((1, 9), dtype=torch.long)})
assert bool(torch.isfinite(m["loss"]))
from ray_tpu_torch.ops import moe
from ray_tpu_torch.models import moe_llama, vit
from ray_tpu_torch.llm import lora, apply_lora, save_params_npz
mcfg = moe_llama.MOE_TINY
mp = moe_llama.init_params(torch.Generator().manual_seed(0), mcfg, "cpu")
assert bool(torch.isfinite(moe_llama.loss_fn(mp, {"tokens": torch.zeros((1, 9), dtype=torch.long)},
                                             mcfg)))
vp = vit.init_params(torch.Generator().manual_seed(0), vit.VIT_TINY, "cpu")
assert vit.forward(vp, torch.zeros((1, 32, 32, 3)), vit.VIT_TINY).shape == (1, 10)
folded = apply_lora(params, {"lm_head.delta": torch.ones(cfg.dim, cfg.vocab_size).numpy()})
assert folded["embed"] is params["embed"]
ray_tpu_torch.init(num_cpus=2, max_workers=2)  # a Data pool actor holds a CPU beside the read tasks
@ray_tpu_torch.remote
def worker_foreign():
    import sys
    return sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "ray_tpu"))
@ray_tpu_torch.remote
class Adder:
    def add(self, t):
        return t + 1
worker_bad = ray_tpu_torch.get(worker_foreign.remote(), timeout=60)
actor = Adder.remote()
assert bool((ray_tpu_torch.get(actor.add.remote(torch.zeros(3)), timeout=60) == 1).all())
ray_tpu_torch.kill(actor)
import numpy as np
from ray_tpu_torch import dag, data, workflow
from ray_tpu_torch.experimental.channel import ShmChannel
from ray_tpu_torch.llm import batch, build_llm_processor
@ray_tpu_torch.remote
class Stage:
    def run(self, x):
        return x + 1
    def foreign(self):
        import sys
        return sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "ray_tpu"))
stage = Stage.remote()
with dag.InputNode() as inp:
    compiled = stage.run.bind(inp).with_shm_channel((2,)).experimental_compile()
assert compiled._channel_mode
assert compiled.execute(np.zeros(2, np.float32)).get(timeout=60).tolist() == [1.0, 1.0]
compiled.teardown()
dag_actor_bad = ray_tpu_torch.get(stage.foreign.remote(), timeout=60)
ray_tpu_torch.kill(stage)
class PoolForeign:
    def __call__(self, b):
        import sys
        bad = ",".join(sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "ray_tpu")))
        return {"id": b["id"], "bad": np.array([bad] * len(b["id"]))}
pool_bad = sorted({str(r["bad"]) for r in data.range(4).map_batches(
    PoolForeign, concurrency=1).take_all()})
import shutil, tempfile
from ray_tpu_torch import air, train
def loop():
    import sys
    train.report({"foreign": sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "ray_tpu"))})
storage = tempfile.mkdtemp()
result = train.DataParallelTrainer(loop, run_config=air.RunConfig(storage_path=storage)).fit()
shutil.rmtree(storage)
from ray_tpu_torch import serve
from ray_tpu_torch.llm import LLMServer, OpenAIServer, build_llm_app, build_openai_app
@serve.deployment
def replica_foreign():
    import sys
    return sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "ray_tpu"))
replica_bad = serve.run(replica_foreign.bind()).remote().result(timeout_s=60)
serve.shutdown()
ray_tpu_torch.shutdown()
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m == "ray_tpu" or m.startswith("ray_tpu."))
print("FOREIGN", bad)
print("WORKER FOREIGN", worker_bad)
print("TRAIN WORKER FOREIGN", result.metrics["foreign"])
print("SERVE REPLICA FOREIGN", replica_bad)
print("DAG ACTOR FOREIGN", dag_actor_bad)
print("DATA POOL ACTOR FOREIGN", pool_bad)
"""


def test_port_imports_neither_jax_nor_ray_tpu():
    # a subprocess: this test process has jax loaded by tests/conftest.py;
    # the probe also starts the port's runtime, whose worker must be clean
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=_REPO, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "\nFOREIGN []" in "\n" + out.stdout, out.stdout
    assert "\nWORKER FOREIGN []" in out.stdout, out.stdout
    assert "TRAIN WORKER FOREIGN []" in out.stdout, out.stdout
    assert "SERVE REPLICA FOREIGN []" in out.stdout, out.stdout
    assert "DAG ACTOR FOREIGN []" in out.stdout, out.stdout
    assert "DATA POOL ACTOR FOREIGN ['']" in out.stdout, out.stdout


_CLUSTER_PROBE = """
import os, sys
import ray_tpu_torch
from ray_tpu_torch import autoscaler, cluster_utils, dashboard, job_submission, scripts
from ray_tpu_torch._private import node_agent
from ray_tpu_torch.util import metrics, profiler, rpdb, state
os.environ["RAY_TPU_TORCH_NUM_GPUS"] = "0"
c = cluster_utils.Cluster(head_num_cpus=1)
node = c.add_node(num_cpus=1, num_gpus=1)
@ray_tpu_torch.remote(num_gpus=1)
def agent_worker_foreign():
    import os, sys
    return os.environ["RAY_TPU_TORCH_NODE_ID"], sorted(
        m for m in sys.modules if m.split(".")[0] in ("jax", "ray_tpu"))
where, agent_bad = ray_tpu_torch.get(agent_worker_foreign.remote(), timeout=60)
assert where == node.node_id, where
state.list_nodes(); state.summarize_tasks(); metrics.snapshot()
c.shutdown()
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m == "ray_tpu" or m.startswith("ray_tpu."))
print("FOREIGN", bad)
print("AGENT WORKER FOREIGN", agent_bad)
"""


def test_cluster_modules_import_neither_jax_nor_ray_tpu():
    """The node agent, client mode, Cluster, CLI, jobs, state API, metrics,
    profiler, rpdb, autoscaler and dashboard; a worker forked by a node
    agent is clean too."""
    out = subprocess.run([sys.executable, "-c", _CLUSTER_PROBE], cwd=_REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "\nFOREIGN []" in "\n" + out.stdout, out.stdout
    assert "\nAGENT WORKER FOREIGN []" in out.stdout, out.stdout


_SLICE9_PROBE = """
import sys, tempfile
import torch
import ray_tpu_torch
from ray_tpu_torch import tune
from ray_tpu_torch.air import RunConfig
from ray_tpu_torch.tune import sample, schedulers, search, tuner
from ray_tpu_torch.util import actor_group, joblib, multiprocessing, queue
from ray_tpu_torch.util import collective
from ray_tpu_torch.util.accelerators import gpu
from ray_tpu_torch.util.collective.collective_group import base, nccl_group, store_group
group = collective.init_collective_group(2, 0, group_name="probe", devices=["cpu", "cpu"])
assert group.allreduce([torch.ones(2), torch.ones(2)])[1].tolist() == [2.0, 2.0]
ray_tpu_torch.init(num_cpus=2, max_workers=2)
def trainable(config):
    import sys
    tune.report({"foreign": sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "ray_tpu"))})
storage = tempfile.mkdtemp()
grid = tune.Tuner(trainable, param_space={"x": tune.grid_search([0])},
                  run_config=RunConfig(storage_path=storage)).fit()
@ray_tpu_torch.remote
def rank(r):
    import sys
    from ray_tpu_torch.util import collective
    collective.init_collective_group(2, r, backend="store", group_name="probe_store")
    collective.allreduce(torch.ones(2), group_name="probe_store")
    return sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "ray_tpu"))
store_bad = ray_tpu_torch.get([rank.remote(0), rank.remote(1)], timeout=60)
ray_tpu_torch.shutdown()
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m == "ray_tpu" or m.startswith("ray_tpu."))
print("FOREIGN", bad)
print("TRIAL FOREIGN", grid[0].metrics["foreign"])
print("STORE RANK FOREIGN", store_bad)
"""


def test_slice9_modules_import_neither_jax_nor_ray_tpu():
    """Tune (a trial included), util.collective (a store group's ranks
    included), the queue, Pool, ActorGroup, joblib and the GPU helpers."""
    out = subprocess.run([sys.executable, "-c", _SLICE9_PROBE], cwd=_REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "\nFOREIGN []" in "\n" + out.stdout, out.stdout
    assert "\nTRIAL FOREIGN []" in out.stdout, out.stdout
    assert "\nSTORE RANK FOREIGN [[], []]" in out.stdout, out.stdout


def test_entry_points_raise_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = llama.LLAMA_TINY
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device()
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device("cuda")
    with pytest.raises(RuntimeError):
        llama.init_params(torch.Generator(), cfg)
    with pytest.raises(RuntimeError):
        llama.init_kv_cache(cfg, 1, 16)
    with pytest.raises(RuntimeError):
        params_from_numpy({"w": torch.zeros(2).numpy()})
    with pytest.raises(RuntimeError):
        LLMConfig(model_config=cfg).load_params()
    params = llama.init_params(torch.Generator(), cfg, device="cpu")
    with pytest.raises(RuntimeError):
        LlamaEngine(cfg, params)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        parallel.create_train_state(torch.Generator(), lambda _: params,
                                    parallel.default_optimizer())
    with pytest.raises(RuntimeError):
        moe_llama.init_params(torch.Generator(), moe_llama.MOE_TINY)
    with pytest.raises(RuntimeError):
        init_moe_params(torch.Generator(), moe_llama.MOE_TINY.moe)
    with pytest.raises(RuntimeError):
        vit.init_params(torch.Generator(), vit.VIT_TINY)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        parallel.make_mesh()      # before any process group is started
    with pytest.raises(RuntimeError, match="device='cpu'"):
        parallel.pipe_mesh()
    assert resolve_device("cpu") == torch.device("cpu")


def test_cuda_device_comes_back_with_its_index(monkeypatch):
    """A "cuda" device resolves to "cuda:<current>", which is what a
    tensor's .device reports; the engine compares the two."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    assert resolve_device("cuda") == torch.device("cuda", 0)
    assert resolve_device() == torch.device("cuda", 0)
    assert resolve_device("cuda:0") == torch.device("cuda", 0)


def test_convert_annotations_resolve():
    """Every annotation of models/convert.py names something it imports."""
    hints = typing.get_type_hints(convert._unflatten)
    assert hints["flat"] == typing.Dict[str, typing.Any]
    typing.get_type_hints(convert.params_from_numpy)


_SLICE10_PROBE = """
import sys
import torch
from ray_tpu_torch import parallel
from ray_tpu_torch.parallel import comm, mesh, pipeline
import importlib
importlib.import_module("ray_tpu_torch.ops.ring_attention")
importlib.import_module("ray_tpu_torch.ops.ulysses")
from ray_tpu_torch.ops import ring_attention, ulysses_attention
from ray_tpu_torch.models import gather_params, llama, shard_params
cfg = llama.LLAMA_TINY
m = parallel.make_mesh(device="cpu")
opt = parallel.default_optimizer(1e-3, warmup_steps=1, total_steps=4)
specs = llama.param_specs(cfg)
state, sh = parallel.create_train_state(
    m, torch.Generator().manual_seed(0), lambda g: llama.init_params(g, cfg, "cpu"), opt, specs)
step = parallel.make_train_step(lambda p, b: llama.loss_fn(p, b, cfg), opt, m, sh)
state, out = step(state, {"tokens": torch.zeros((1, 9), dtype=torch.long)})
assert bool(torch.isfinite(out["loss"]))
assert gather_params(state, m, specs)["embed"].shape == (cfg.vocab_size, cfg.dim)
q = torch.randn(1, 8, 2, 16)
assert ring_attention(q, q, q, mesh=m).shape == q.shape
assert ulysses_attention(q, q, q, mesh=m).shape == q.shape
p = parallel.pipe_mesh("cpu")
run = parallel.pipeline_sharded(lambda w, x: x * w["a"], {"a": torch.ones(1, 1)}, p)
assert run(torch.ones(2, 3)).shape == (2, 3)
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m == "ray_tpu" or m.startswith("ray_tpu."))
print("FOREIGN", bad)
"""


def test_parallel_modules_import_neither_jax_nor_ray_tpu():
    """parallel.mesh, parallel.comm, parallel.pipeline, ops.ring_attention,
    ops.ulysses and the shard/gather helpers, each driven on a world of
    one CPU rank."""
    out = subprocess.run([sys.executable, "-c", _SLICE10_PROBE], cwd=_REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "\nFOREIGN []" in "\n" + out.stdout, out.stdout


_RLLIB_PROBE = """
import pickle, sys
import torch
import ray_tpu_torch.rllib
import ray_tpu_torch.rllib.podracer
from ray_tpu_torch.rllib import PPOConfig, core, ppo
from ray_tpu_torch.rllib.podracer import PodracerConfig
from ray_tpu_torch.rllib.podracer.anakin import AnakinWorker
cfg = PodracerConfig().podracer(num_envs=8).env_runners(rollout_fragment_length=4).training(
    device="cpu")
w = AnakinWorker(pickle.dumps(cfg))
row = w.tick(None)
assert row[1] == 1 and row[2] == 32, row
spec = core.MLPSpec(4, 2, (8,))
opt, upd = ppo.make_ppo_update(PPOConfig(minibatch_size=8, num_epochs=1), spec)
p = core.init_mlp_module(torch.Generator().manual_seed(0), spec, "cpu")
roll = {"obs": torch.zeros(4, 2, 4), "actions": torch.zeros(4, 2, dtype=torch.long),
        "rewards": torch.ones(4, 2), "dones": torch.zeros(4, 2), "logp": torch.zeros(4, 2),
        "values": torch.zeros(4, 2), "final_obs": torch.zeros(2, 4)}
p, s, m = upd(p, opt.init(p), roll, torch.randperm(8)[None])
assert s.count == 1
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m == "ray_tpu" or m.startswith("ray_tpu."))
print("FOREIGN", bad)
"""


def test_rllib_imports_neither_jax_nor_ray_tpu():
    """ray_tpu_torch.rllib and rllib.podracer, an Anakin superstep and a
    PPO update run on the CPU in a fresh process."""
    out = subprocess.run([sys.executable, "-c", _RLLIB_PROBE], cwd=_REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "\nFOREIGN []" in "\n" + out.stdout, out.stdout


_GRAFTLINT_PROBE = """
import sys
from ray_tpu_torch.tools import graftlint
from ray_tpu_torch.tools.graftlint import __main__ as cli, project
from ray_tpu_torch.tools.graftlint.checkers import gl017_deadline_conformance
assert len(graftlint.all_checkers()) + len(graftlint.all_project_checkers()) == 18
findings = graftlint.check_file("ray_tpu_torch/serve/handle.py")
assert findings == [], findings
assert cli.main(["ray_tpu_torch/serve/handle.py", "--no-baseline"]) == 0
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m == "ray_tpu" or m.startswith("ray_tpu."))
print("FOREIGN", bad)
"""


def test_graftlint_imports_neither_jax_nor_ray_tpu():
    """ray_tpu_torch.tools.graftlint, every checker loaded, run on one
    file of the port in process and through its CLI."""
    out = subprocess.run([sys.executable, "-c", _GRAFTLINT_PROBE], cwd=_REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "\nFOREIGN []" in "\n" + out.stdout, out.stdout
