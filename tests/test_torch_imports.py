"""The port stands alone: importing ray_tpu_torch (its train, air and
serve libraries and ``llm``'s Serve deployments included) and running it
pulls in neither JAX nor the ray_tpu package, in the driver, in a runtime
worker, in a train worker or in a Serve replica, and its entry points
refuse to run on the CPU unless asked to."""

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
ray_tpu_torch.init(num_cpus=1, max_workers=1)
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
