"""``LLMConfig.load_params`` of a Train checkpoint directory, the port
against the reference.

One ``LLAMA_TINY`` parameter tree is drawn with numpy (seeded) at the
shapes of the JAX package's ``init_params``. The JAX side saves it with
orbax's ``StandardCheckpointer`` and loads it through
``ray_tpu.llm.config.LLMConfig.load_params`` (its orbax branch, the
reference's Train format); the port's side carries the same arrays over
with ``models.convert.params_from_numpy``, saves them with
``train.Checkpoint.from_torch`` and loads them with the port's
``LLMConfig.load_params(device="cpu")``. Every leaf must be equal exactly
in f32, and bit-equal after both packages' cast to a bf16
``param_dtype``; the two packages' greedy engines must give the same
tokens; a checkpoint of another depth raises ValueError in both. The
port's branch has no fallback: a directory without the file, a
TrainState checkpoint and a call without a GPU and without
``device="cpu"`` raise. Last, an ``LLMServer`` on the port's Serve with
the HTTP ingress answers a POST with the in-process engine's tokens.

Cost: a few seconds for the orbax and torch round trips; the HTTP test
starts one port runtime (two CPUs, two pooled workers).
"""

import dataclasses
import json
import socket
import time
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import orbax.checkpoint as ocp
import pytest
import torch

import ray_tpu_torch
from ray_tpu.llm import LlamaEngine as RefEngine
from ray_tpu.llm.config import LLMConfig as RefLLMConfig
from ray_tpu.models import llama as jl
from ray_tpu_torch import parallel
from ray_tpu_torch import serve as port_serve
from ray_tpu_torch.llm import LLMConfig, LlamaEngine, build_llm_app
from ray_tpu_torch.models import llama as tl
from ray_tpu_torch.models.convert import params_from_numpy
from ray_tpu_torch.train import Checkpoint

JCFG = dataclasses.replace(jl.LLAMA_TINY, dtype=jnp.float32)
TCFG = dataclasses.replace(tl.LLAMA_TINY, dtype=torch.float32)
PROMPT = [5, 17, 99, 3]
T = 120  # seconds: the bound of every wait


def _flat(tree, prefix=""):
    """{"/"-joined key path: leaf} of a nested dict."""
    if isinstance(tree, dict):
        return {k: v for n, sub in tree.items() for k, v in _flat(sub, f"{prefix}{n}/").items()}
    return {prefix[:-1]: tree}


def _bits(leaf) -> np.ndarray:
    """A leaf of either package as raw bits (bf16 as uint16), on the host."""
    if isinstance(leaf, torch.Tensor):
        if leaf.dtype == torch.bfloat16:
            return leaf.view(torch.int16).numpy().view(np.uint16)
        return leaf.numpy()
    a = np.asarray(leaf)
    return a.view(np.uint16) if a.dtype == ml_dtypes.bfloat16 else a


@pytest.fixture(scope="module")
def saved(tmp_path_factory):
    """(JAX orbax dir, port checkpoint dir, the numpy tree)."""
    d = tmp_path_factory.mktemp("llm_checkpoint")
    shapes = jax.eval_shape(lambda: jl.init_params(jax.random.PRNGKey(0), JCFG))
    rng = np.random.default_rng(0)
    tree = jax.tree.map(lambda s: rng.standard_normal(s.shape).astype(np.float32), shapes)
    ckptr = ocp.StandardCheckpointer()
    ckptr.save(str(d / "orbax"), tree)
    ckptr.wait_until_finished()
    Checkpoint.from_torch(params_from_numpy(tree, "cpu"), str(d / "torch"))
    return str(d / "orbax"), str(d / "torch"), tree


def _both(saved, jcfg=JCFG, tcfg=TCFG):
    """(the reference's loaded tree, the port's), flat, by key path."""
    jdir, tdir, _ = saved
    ref = RefLLMConfig(model_config=jcfg, checkpoint_path=jdir).load_params()
    port = LLMConfig(model_config=tcfg, checkpoint_path=tdir).load_params(device="cpu")
    return _flat(ref), _flat(port)


def test_f32_leaves_equal_exactly(saved):
    ref, port = _both(saved)
    want = _flat(saved[2])
    assert set(ref) == set(port) == set(want)
    for k in want:
        assert port[k].dtype == torch.float32 and np.asarray(ref[k]).dtype == np.float32, k
        assert np.array_equal(_bits(port[k]), want[k]), k
        assert np.array_equal(_bits(ref[k]), want[k]), k


def test_bf16_cast_bit_equal_to_the_reference(saved):
    ref, port = _both(saved, dataclasses.replace(JCFG, param_dtype=jnp.bfloat16),
                      dataclasses.replace(TCFG, param_dtype=torch.bfloat16))
    assert set(ref) == set(port)
    for k in ref:
        assert port[k].dtype == torch.bfloat16 and np.asarray(ref[k]).dtype == jnp.bfloat16, k
        assert np.array_equal(_bits(port[k]), _bits(ref[k])), k


def test_bf16_checkpoint_stays_bit_equal(tmp_path):
    """A bf16 tree saved as bf16 comes back as the same bits."""
    cfg = dataclasses.replace(TCFG, param_dtype=torch.bfloat16)
    params = tl.init_params(torch.Generator().manual_seed(3), cfg, "cpu")
    Checkpoint.from_torch(params, str(tmp_path))
    got = LLMConfig(model_config=cfg, checkpoint_path=str(tmp_path)).load_params(device="cpu")
    want, out = _flat(params), _flat(got)
    for k in want:
        assert out[k].dtype == torch.bfloat16 and torch.equal(out[k], want[k]), k


def test_greedy_tokens_equal_across_packages(saved):
    jdir, tdir, _ = saved
    ref_params = RefLLMConfig(model_config=JCFG, checkpoint_path=jdir).load_params()
    port_params = LLMConfig(model_config=TCFG, checkpoint_path=tdir).load_params(device="cpu")
    want = RefEngine(JCFG, ref_params, max_batch=1, max_seq=64).generate(PROMPT, max_tokens=6)
    got = LlamaEngine(TCFG, port_params, max_batch=1, max_seq=64,
                      device="cpu").generate(PROMPT, max_tokens=6)
    assert got == want and len(got) == 6


def test_shape_mismatch_raises_in_both(saved):
    jdir, tdir, _ = saved
    with pytest.raises(ValueError):
        RefLLMConfig(model_config=dataclasses.replace(JCFG, n_layers=1),
                     checkpoint_path=jdir).load_params()
    with pytest.raises(ValueError, match=r"\.blocks\.\w+ holds \(2, "):
        LLMConfig(model_config=dataclasses.replace(TCFG, n_layers=1),
                  checkpoint_path=tdir).load_params(device="cpu")


def test_no_fallback(saved, tmp_path):
    _, tdir, _ = saved
    empty = tmp_path / "empty"
    empty.mkdir()
    with pytest.raises(FileNotFoundError, match="torch_state.pt"):
        LLMConfig(model_config=TCFG, checkpoint_path=str(empty)).load_params(device="cpu")
    with pytest.raises(FileNotFoundError):
        LLMConfig(model_config=TCFG, checkpoint_path=str(tmp_path / "absent")).load_params(
            device="cpu")
    opt = parallel.default_optimizer(1e-3)
    state = parallel.create_train_state(torch.Generator().manual_seed(0),
                                        lambda g: tl.init_params(g, TCFG, "cpu"), opt, "cpu")
    Checkpoint.from_torch(state, str(tmp_path / "state"))
    with pytest.raises(ValueError, match=r"save state\.params with train\.Checkpoint\.from_torch"):
        LLMConfig(model_config=TCFG, checkpoint_path=str(tmp_path / "state")).load_params(
            device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            LLMConfig(model_config=TCFG, checkpoint_path=tdir).load_params()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_llm_server_over_http_serves_the_checkpoint(saved):
    _, tdir, _ = saved
    cfg = LLMConfig(model_config=TCFG, checkpoint_path=tdir, max_batch_size=4, max_seq_len=64,
                    accelerator_type="", engine_kwargs={"device": "cpu"})
    want = LlamaEngine(TCFG, cfg.load_params(device="cpu"), max_batch=1, max_seq=64,
                       device="cpu").generate(PROMPT, max_tokens=6)
    port = _free_port()
    ray_tpu_torch.init(num_cpus=2, max_workers=2)
    try:
        port_serve.run(build_llm_app(cfg), route_prefix="/llm", http_options={"port": port})
        body = json.dumps({"prompt_ids": PROMPT, "max_tokens": 6}).encode()
        deadline, got, last = time.time() + T, None, None
        while got is None and time.time() < deadline:
            req = urllib.request.Request(f"http://127.0.0.1:{port}/llm", data=body,
                                         headers={"Content-Type": "application/json"})
            try:
                with urllib.request.urlopen(req, timeout=T) as r:
                    got = json.loads(r.read())
            except urllib.error.HTTPError as e:
                if e.code != 404:  # 404: the route table refreshes ~1 s after serve.run
                    raise
                last = e
                time.sleep(0.3)
        assert got == {"token_ids": want, "num_generated": 6}, last
    finally:
        port_serve.shutdown()
        ray_tpu_torch.shutdown()
