"""The slice against the JAX package: one ``LLAMA_TINY`` checkpoint, two
actors.

The parameters of ``LLAMA_TINY`` (f32) are written once to a ``.npz``.
A ``ray_tpu`` actor loads them with the JAX ``LLMConfig`` and scores and
serves with the JAX ``loss_fn`` and ``LlamaEngine``; a ``ray_tpu_torch``
``LlamaActor(device="cpu")`` loads the same file with the port's
``LLMConfig`` and scores through ``loss_fn`` with ``attention_impl=
"flash"`` and ``ce_impl="fused"`` (their plain versions on the CPU) and
serves through the port's engine. The losses agree within
test_torch_llama.py's f32 loss tolerance (rtol 1e-5), and the greedy
tokens exactly.

Cost: one runtime per package for the whole file, two CPUs and two
pooled workers each; every get has a timeout. The JAX actor's process
imports JAX; the port's does not.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ray_tpu
import ray_tpu_torch
from ray_tpu.llm import LLMConfig as JaxLLMConfig
from ray_tpu.llm import save_params_npz
from ray_tpu.models import llama as jl
from ray_tpu_torch.llm import GenRequest, LLMConfig, LlamaActor
from ray_tpu_torch.models import llama as tl

T = 120
LOSS_RTOL = 1e-5  # test_torch_llama.py, f32 losses


@pytest.fixture(scope="module")
def actors(tmp_path_factory):
    jcfg = dataclasses.replace(jl.LLAMA_TINY, dtype=jnp.float32)
    tcfg = dataclasses.replace(tl.LLAMA_TINY, dtype=torch.float32)
    path = str(tmp_path_factory.mktemp("llama") / "tiny.npz")
    save_params_npz(jl.init_params(jax.random.PRNGKey(0), jcfg), path)
    ray_tpu.init(num_cpus=2, max_workers=2, ignore_reinit_error=True)
    ray_tpu_torch.init(num_cpus=2, max_workers=2)

    @ray_tpu.remote
    class JaxLlama:
        """The reference's side: JAX LLMConfig, loss_fn and LlamaEngine."""

        def __init__(self, llm_config):
            from ray_tpu.llm import LlamaEngine

            self.cfg = llm_config.model_config
            self.params = llm_config.load_params()
            self.engine = LlamaEngine(self.cfg, self.params, max_batch=llm_config.max_batch_size,
                                      max_seq=llm_config.max_seq_len)

        def score(self, tokens):
            import jax.numpy as jnp

            from ray_tpu.models import llama

            return float(llama.loss_fn(self.params, {"tokens": jnp.asarray(tokens)}, self.cfg))

        def generate(self, prompts, max_tokens):
            return [self.engine.generate(p, max_tokens=max_tokens) for p in prompts]

    kw = dict(checkpoint_path=path, max_batch_size=4, max_seq_len=64)
    ref = JaxLlama.remote(JaxLLMConfig(model_config=jcfg, **kw))
    port = ray_tpu_torch.remote(LlamaActor).remote(
        LLMConfig(model_config=tcfg, **kw), device="cpu")
    yield ref, port, tcfg
    ray_tpu_torch.shutdown()
    ray_tpu.shutdown()


def test_scores_agree(actors):
    ref, port, cfg = actors
    tokens = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 65))  # 2 x 64 = 128 rows
    want = ray_tpu.get(ref.score.remote(tokens), timeout=T)
    # the batch goes through the object store as a CPU tensor
    got = ray_tpu_torch.get(port.score.remote(ray_tpu_torch.put(torch.from_numpy(tokens))),
                            timeout=T)
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL)
    assert np.isfinite(got) and abs(got - np.log(cfg.vocab_size)) < 1.0


def test_greedy_tokens_agree(actors):
    ref, port, cfg = actors
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, cfg.vocab_size, int(n)).tolist() for n in (3, 9, 17, 5, 12)]
    want = ray_tpu.get(ref.generate.remote(prompts, 6), timeout=T)
    reqs = [GenRequest(request_id=str(i), prompt_ids=p, max_tokens=6)
            for i, p in enumerate(prompts)]  # five requests, four slots
    got = ray_tpu_torch.get(port.generate.remote(reqs), timeout=T)
    assert [got[str(i)] for i in range(len(prompts))] == want


def test_actor_reports_its_process(actors):
    _, port, _ = actors
    info = ray_tpu_torch.get(port.info.remote(), timeout=T)
    assert info["device"] == "cpu" and info["cuda_visible_devices"] == ""
    assert ray_tpu_torch.get(port.launches.remote(), timeout=T) == dict.fromkeys(
        ["flash_attention_fwd", "flash_attention_bwd_dkv", "flash_attention_bwd_dq",
         "fused_ce_fwd", "fused_ce_bwd_dlog", "fused_ce_bwd_dx", "fused_ce_bwd_dw",
         "fused_adamw"], 0)
    assert len(ray_tpu_torch.get(port.param_digest.remote(), timeout=T)) == 64
