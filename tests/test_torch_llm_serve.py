"""``llm.serve`` of the port against the reference's: one ``LLAMA_TINY``
checkpoint, two runtimes, two Serve applications on each.

The JAX package's ``LLAMA_TINY`` parameters (f32, ``PRNGKey(0)``) are
written once with its ``save_params_npz`` and go through
``checkpoint_path`` into both packages' ``build_llm_app`` and
``build_openai_app``; the port's replicas run with
``engine_kwargs={"device": "cpu"}``. Greedy tokens must be equal across
the packages and equal to an in-process JAX ``LlamaEngine``'s, streamed
and not; the OpenAI responses must be equal field for field; a LoRA
adapter routes by the body's ``model`` and by ``multiplexed_model_id``
and serves the folded weights; the LRU of adapter engines and the
multiplex registry behave as ``test_llm_lora.py`` runs them; and the
replica's actor options carry ``num_gpus`` where the reference's carry
``num_tpus``.

Cost: one runtime per package for the whole file, two CPUs and two
pooled workers each; the reference's replicas import JAX, the port's do
not. Every result has a timeout.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ray_tpu
import ray_tpu_torch
from ray_tpu import llm as ref_llm
from ray_tpu import serve as ref_serve
from ray_tpu.models import llama as jl
from ray_tpu_torch import llm as port_llm
from ray_tpu_torch import serve as port_serve
from ray_tpu_torch.models import llama as tl

T = 120
PROMPT = [5, 17, 99, 3]
JCFG = dataclasses.replace(jl.LLAMA_TINY, dtype=jnp.float32)
TCFG = dataclasses.replace(tl.LLAMA_TINY, dtype=torch.float32)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """(checkpoint path, adapter directory, the JAX parameters)."""
    d = tmp_path_factory.mktemp("llm_serve")
    params = jl.init_params(jax.random.PRNGKey(0), JCFG)
    path = str(d / "tiny.npz")
    ref_llm.save_params_npz(params, path)
    for name, seed in (("ad_a", 1), ("ad_b", 2), ("ad_c", 3)):
        rng = np.random.default_rng(seed)
        delta = rng.normal(size=(JCFG.dim, JCFG.vocab_size)).astype(np.float32)
        np.savez(d / f"{name}.npz", **{"lm_head.delta": delta})
    return path, str(d), params


def _configs(files, **kw):
    """The same LLMConfig in both packages; the port's engine on the CPU."""
    path, lora_dir, _ = files
    common = dict(checkpoint_path=path, max_batch_size=4, max_seq_len=64,
                  lora_config={"dynamic_lora_loading_path": lora_dir,
                               "max_adapters_per_replica": 2}, **kw)
    return (ref_llm.LLMConfig(model_config=JCFG, **common),
            port_llm.LLMConfig(model_config=TCFG, engine_kwargs={"device": "cpu"}, **common))


def _jax_tokens(files, adapter=None, n=6, prompt=PROMPT):
    """Greedy tokens of an in-process JAX engine, on the adapter's folded
    weights if one is named."""
    _, lora_dir, params = files
    if adapter:
        params = ref_llm.apply_lora(params, ref_llm.load_lora_adapter(f"{lora_dir}/{adapter}.npz"))
    return ref_llm.LlamaEngine(JCFG, params, max_batch=2, max_seq=64).generate(prompt, max_tokens=n)


@pytest.fixture(scope="module")
def served(files):
    """{package: (llm handle, openai handle)}, both apps of both packages up."""
    ray_tpu.init(num_cpus=2, max_workers=2, ignore_reinit_error=True)
    ray_tpu_torch.init(num_cpus=2, max_workers=2)
    handles = {}
    for name, llm, serve, cfg in zip(("ref", "port"), (ref_llm, port_llm),
                                     (ref_serve, port_serve),
                                     _configs(files, accelerator_type="")):
        handles[name] = (serve.run(llm.build_llm_app(cfg), name="llm"),
                         serve.run(llm.build_openai_app(cfg), name="openai"))
    yield handles
    port_serve.shutdown()
    ref_serve.shutdown()
    ray_tpu_torch.shutdown()
    ray_tpu.shutdown()


def test_generate_and_stream_agree_with_the_jax_engine(served, files):
    want = _jax_tokens(files)
    for name, (llm, _) in served.items():
        out = llm.remote({"prompt_ids": PROMPT, "max_tokens": 6}).result(timeout_s=T)
        assert out == {"token_ids": want, "num_generated": 6}, name
        streamed = list(llm.options(method_name="generate_stream", stream=True).remote(PROMPT, 6))
        assert streamed == want, name


def _completions(openai):
    first = openai.remote({"model": "base", "prompt": PROMPT, "max_tokens": 3})
    first = first.result(timeout_s=T)
    eos = first["choices"][0]["token_ids"][0]
    return [
        first,
        openai.remote({"prompt_ids": PROMPT, "max_tokens": 3, "eos_id": eos}).result(timeout_s=T),
        openai.remote({"model": "ad_a", "prompt": PROMPT, "max_tokens": 3}).result(timeout_s=T),
        openai.options(multiplexed_model_id="ad_b").remote(
            {"prompt": PROMPT, "max_tokens": 3}).result(timeout_s=T),
    ]


def test_openai_completions_and_adapter_routing_agree(served, files):
    ref = _completions(served["ref"][1])
    port = _completions(served["port"][1])
    assert port == ref
    base, stopped, by_model, by_mux = port
    assert base["object"] == "text_completion" and base["model"] == "base"
    assert base["choices"] == [{"index": 0, "token_ids": _jax_tokens(files, n=3),
                                "finish_reason": "length"}]
    assert base["usage"] == {"prompt_tokens": 4, "completion_tokens": 3, "total_tokens": 7}
    assert stopped["choices"][0]["token_ids"] == base["choices"][0]["token_ids"][:1]
    assert stopped["choices"][0]["finish_reason"] == "stop"
    assert by_model["model"] == "ad_a"
    assert by_model["choices"][0]["token_ids"] == _jax_tokens(files, "ad_a", n=3)
    # routed by the handle's model id: the body names no model
    assert by_mux["model"] == "base"
    assert by_mux["choices"][0]["token_ids"] == _jax_tokens(files, "ad_b", n=3)
    assert len({tuple(c["choices"][0]["token_ids"]) for c in (base, by_model, by_mux)}) == 3


def _lru(llm, cfg):
    """test_llm_lora.py's programs on an in-process LLMServer. The
    multiplex registry is global to the process, so a model id that an
    earlier program left there is not counted as this server's."""
    from collections import Counter
    from importlib import import_module

    registered = import_module(f"{llm.__name__.rsplit('.', 1)[0]}.serve.multiplex")
    before = Counter(registered.registered_model_ids())

    def ids():
        return sorted((Counter(registered.registered_model_ids()) - before).elements())

    server = llm.LLMServer(cfg)
    try:
        out = {aid: server.generate(PROMPT, max_tokens=3, adapter_id=aid)
               for aid in ("ad_a", "ad_b", "ad_c")}
        live = [aid for aid in server._engines if aid]
        reloaded = server.generate(PROMPT, max_tokens=3, adapter_id="ad_a")
        seen = ids()
        base = server({"prompt_ids": PROMPT, "max_tokens": 3, "model": "base"})["token_ids"]
        try:
            server.generate(PROMPT, max_tokens=1, adapter_id="../evil")
            refused = None
        except ValueError as e:
            refused = str(e)
    finally:
        server.shutdown()
    return out, live, reloaded, seen, base, refused, ids()


def test_adapter_lru_and_registry_agree(files):
    ref_cfg, port_cfg = _configs(files)
    ref = _lru(ref_llm, ref_cfg)
    port = _lru(port_llm, port_cfg)
    assert port == ref
    out, live, reloaded, seen, base, refused, after = port
    assert live == ["ad_b", "ad_c"]  # the oldest evicted
    assert reloaded == out["ad_a"] == _jax_tokens(files, "ad_a", n=3)
    assert seen == ["ad_a", "ad_c"]  # ad_a loaded again, ad_b evicted
    assert base == _jax_tokens(files, n=3)
    assert refused == "invalid adapter id '../evil'"
    assert after == []


def test_two_token_request_gets_both_tokens(files):
    """A request's last prompt chunk and its first decode run in one
    engine step and emit two tokens; the reference's batching loop puts
    "done" after the first when the request then has all it asked for,
    so a request for 2 tokens gets 1. The port puts "done" after the
    request's last token of the step (ROADMAP.md Queue C)."""
    ref_cfg, port_cfg = _configs(files)
    want = _jax_tokens(files, n=2)
    got = {}
    for name, llm, cfg in (("ref", ref_llm, ref_cfg), ("port", port_llm, port_cfg)):
        server = llm.LLMServer(cfg)
        try:
            got[name] = (server.generate(PROMPT, max_tokens=2),
                         server.generate(PROMPT, max_tokens=2, adapter_id="ad_a"))
        finally:
            server.shutdown()
    assert got["port"] == (want, _jax_tokens(files, "ad_a", n=2))
    assert got["ref"] == (want[:1], _jax_tokens(files, "ad_a", n=2)[:1])


@pytest.mark.parametrize("key, want", [
    (None, {"num_gpus": 2.0}),
    ("TPU", {"resources": {"TPU": 2.0}}),
    ("", None),
])
def test_replica_asks_for_the_gpus_of_its_bundle(key, want):
    kw = {} if key is None else {"accelerator_type": key}
    port = port_llm.build_llm_app(port_llm.LLMConfig(tensor_parallel_size=2, **kw))
    assert port.deployment.ray_actor_options == (want or {})
    ref_key = "TPU" if key is None else key
    ref = ref_llm.build_llm_app(ref_llm.LLMConfig(tensor_parallel_size=2,
                                                  accelerator_type=ref_key))
    assert ref.deployment.ray_actor_options == ({"num_tpus": 2.0} if ref_key == "TPU" else {})
    oa = port_llm.build_openai_app(port_llm.LLMConfig(**kw))
    assert oa.deployment.name == "v1-completions"
    assert issubclass(oa.deployment.func_or_class, port_llm.OpenAIServer)
