"""Parity of the port's LoRA folding, LLMConfig, save_params_npz and
GenRequest (ray_tpu_torch.llm) with ray_tpu/llm on the CPU.

Tolerances: the fold of a delta exactly; of an A/B pair in f32 atol
1e-7 + rtol 1e-6 (A @ B summed over the rank in another order: one or
two f32 ulps of the leaf), in bf16 exactly (the same casts, and the
scale rounded to the leaf's dtype as JAX rounds a weakly typed scalar,
then one product and one sum, each rounded once); greedy tokens exactly;
a saved .npz exactly (a bf16 tensor is written as f32, which holds it)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.llm import GenRequest as JaxGenRequest
from ray_tpu.llm import LLMConfig as JaxLLMConfig
from ray_tpu.llm import LlamaEngine as JaxEngine
from ray_tpu.llm import apply_lora as jax_apply_lora
from ray_tpu.models import llama as jl
from ray_tpu_torch.llm import (GenRequest, LLMConfig, LlamaEngine, apply_lora,
                               load_lora_adapter, save_params_npz)
from ray_tpu_torch.models import llama as tl
from ray_tpu_torch.models import params_from_numpy
from ray_tpu_torch.parallel import tree_leaves

F32_AB = dict(atol=1e-7, rtol=1e-6)


@pytest.fixture(scope="module")
def setup():
    jcfg = dataclasses.replace(jl.LLAMA_TINY, dtype=jnp.float32)
    tcfg = dataclasses.replace(tl.LLAMA_TINY, dtype=torch.float32)
    jparams = jl.init_params(jax.random.PRNGKey(0), jcfg)
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    return jcfg, tcfg, jparams, tparams


def _adapter(cfg, seed=0, rank=8, scale=None):
    """A seeded adapter: blocks/wq as an A/B pair (rank ``rank``) and
    lm_head as a full delta, in f32, plus a "scale" entry when given."""
    rng = np.random.default_rng(seed)
    L, D, H, hd = cfg.n_layers, cfg.dim, cfg.n_heads, cfg.head_dim
    ad = {
        "blocks/wq.A": (rng.standard_normal((L * D * H, rank)) / np.sqrt(D)).astype(np.float32),
        "blocks/wq.B": (rng.standard_normal((rank, hd)) / np.sqrt(rank)).astype(np.float32),
        "lm_head.delta": (rng.standard_normal((D, cfg.vocab_size)) / np.sqrt(D)
                          ).astype(np.float32),
    }
    if scale is not None:
        ad["scale"] = np.float32(scale)
    return ad


@pytest.fixture()
def adapter_path(setup, tmp_path):
    path = str(tmp_path / "adapter.npz")
    np.savez(path, **_adapter(setup[0], scale=0.37))
    return path


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_apply_lora_matches_jax(setup, adapter_path, dtype):
    """One .npz (an A/B pair, a delta and a "scale" entry that overrides
    the caller's scale) folded by both packages, leaf by leaf."""
    _, _, jparams, tparams = setup
    jp = jax.tree.map(lambda a: a.astype(dtype), jparams)
    tp = {k: ({k2: v2.to(getattr(torch, dtype)) for k2, v2 in v.items()}
              if isinstance(v, dict) else v.to(getattr(torch, dtype)))
          for k, v in tparams.items()}
    adapter = load_lora_adapter(adapter_path)
    assert set(adapter) == {"blocks/wq.A", "blocks/wq.B", "lm_head.delta", "scale"}
    ref = jax_apply_lora(jp, adapter, scale=5.0)
    out = apply_lora(tp, adapter, scale=5.0)
    for path in (("embed",), ("lm_head",), ("blocks", "wq"), ("blocks", "wk")):
        r, o = ref, out
        for p in path:
            r, o = r[p], o[p]
        leaf = tp[path[0]] if len(path) == 1 else tp[path[0]][path[1]]
        assert o.dtype == leaf.dtype
        if dtype == "float32" and path == ("blocks", "wq"):
            np.testing.assert_allclose(o.numpy(), np.asarray(r), **F32_AB)
        else:
            np.testing.assert_array_equal(o.float().numpy(), np.asarray(r, np.float32),
                                          err_msg=str(path))
    assert not torch.equal(out["lm_head"], tp["lm_head"])
    assert not torch.equal(out["blocks"]["wq"], tp["blocks"]["wq"])


def test_caller_scale_without_scale_entry(setup):
    jcfg, _, jparams, tparams = setup
    adapter = _adapter(jcfg, seed=1)
    ref = jax_apply_lora(jparams, adapter, scale=0.5)
    out = apply_lora(tparams, adapter, scale=0.5)
    np.testing.assert_array_equal(out["lm_head"].numpy(), np.asarray(ref["lm_head"]))
    np.testing.assert_allclose(out["blocks"]["wq"].numpy(), np.asarray(ref["blocks"]["wq"]),
                               **F32_AB)


def test_unadapted_leaves_are_shared(setup):
    jcfg, _, _, tparams = setup
    out = apply_lora(tparams, _adapter(jcfg))
    assert out is not tparams and out["blocks"] is not tparams["blocks"]
    assert out["embed"] is tparams["embed"] and out["final_norm"] is tparams["final_norm"]
    for k in ("wk", "wv", "wo", "w_gate", "w_up", "w_down", "attn_norm", "mlp_norm"):
        assert out["blocks"][k] is tparams["blocks"][k], k
    assert out["lm_head"] is not tparams["lm_head"]


@pytest.mark.parametrize("adapter,match", [
    ({"blocks/wq.A": np.zeros((4, 2), np.float32)}, "no blocks/wq.B"),
    ({"blocks/wq.B": np.zeros((2, 4), np.float32)}, "no blocks/wq.A"),
    ({"blocks/nope.delta": np.zeros(3, np.float32)}, "unknown parameter"),
    ({"lm_head": np.zeros(3, np.float32)}, "unrecognized adapter entry"),
])
def test_bad_adapters_raise(setup, adapter, match):
    _, _, jparams, tparams = setup
    with pytest.raises(ValueError, match=match):
        jax_apply_lora(jparams, adapter)
    with pytest.raises(ValueError, match=match):
        apply_lora(tparams, adapter)


def test_engine_greedy_tokens_match_jax_with_a_folded_adapter(setup, adapter_path):
    """The port's engine on the port's fold and the JAX engine on the JAX
    fold give the same greedy tokens, which differ from the base model's."""
    jcfg, tcfg, jparams, tparams = setup
    adapter = load_lora_adapter(adapter_path)
    jfold, tfold = jax_apply_lora(jparams, adapter), apply_lora(tparams, adapter)
    prompts = [[5, 17, 99, 3], [1, 2, 3, 4, 5, 6, 7]]
    base = LlamaEngine(tcfg, tparams, max_batch=2, max_seq=64, device="cpu")
    for prompt in prompts:
        ref = JaxEngine(jcfg, jfold, max_batch=2, max_seq=64).generate(prompt, max_tokens=6)
        got = LlamaEngine(tcfg, tfold, max_batch=2, max_seq=64, device="cpu").generate(
            prompt, max_tokens=6)
        assert got == ref
        assert got != base.generate(prompt, max_tokens=6)


def test_llm_config_binds_like_the_reference(setup):
    jcfg, tcfg, *_ = setup
    ref, out = JaxLLMConfig("base", jcfg), LLMConfig("base", tcfg)
    assert (out.model_id, out.model_config) == ("base", tcfg)
    assert ([f.name for f in dataclasses.fields(LLMConfig)]
            == [f.name for f in dataclasses.fields(JaxLLMConfig)])
    for f in dataclasses.fields(LLMConfig):
        if f.name not in ("model_config", "accelerator_type"):
            assert getattr(out, f.name) == getattr(ref, f.name), f.name
    # positional binding reaches every field alike
    args = ("m", None, "/x.npz", 2, 3, 4, 256, "GPU", {"t": 1}, {"scale": 2.0})
    assert dataclasses.astuple(LLMConfig(*args)) == dataclasses.astuple(JaxLLMConfig(*args))
    # the resource key is the one difference by design: "GPU" in the port
    assert (ref.accelerator_type, out.accelerator_type) == ("TPU", "GPU")


@pytest.mark.parametrize("tp,pp", [(1, 1), (4, 1), (2, 3)])
def test_placement_bundles_match_but_for_the_resource_key(tp, pp):
    kw = dict(tensor_parallel_size=tp, pipeline_parallel_size=pp)
    rb, rs = JaxLLMConfig(**kw).placement_bundles()
    ob, os_ = LLMConfig(**kw).placement_bundles()
    assert os_ == rs and len(ob) == len(rb) == pp
    assert ob == [{"GPU" if k == "TPU" else k: v for k, v in b.items()} for b in rb]
    # a key given explicitly is used as it is by both; an empty one falls
    # back to each package's default
    for acc in ("GPU", "TPU"):
        kw2 = dict(kw, accelerator_type=acc)
        assert LLMConfig(**kw2).placement_bundles() == JaxLLMConfig(**kw2).placement_bundles()
    assert (LLMConfig(**kw, accelerator_type="").placement_bundles()
            == LLMConfig(**kw).placement_bundles())


def test_save_params_npz_loads_back_in_both_packages(setup, tmp_path):
    _, tcfg, _, tparams = setup
    params = dict(tparams, embed=tparams["embed"].bfloat16())
    path = str(tmp_path / "port.npz")
    save_params_npz(params, path)
    jax_loaded = JaxLLMConfig(checkpoint_path=path).load_params()
    port_loaded = LLMConfig(model_config=tcfg, checkpoint_path=path).load_params(device="cpu")
    for tree in (jax_loaded, port_loaded):
        assert set(tree) == set(params) and set(tree["blocks"]) == set(params["blocks"])
    for k, v in tree_leaves_with_names(params):
        j = jax_loaded[k[0]] if len(k) == 1 else jax_loaded[k[0]][k[1]]
        t = port_loaded[k[0]] if len(k) == 1 else port_loaded[k[0]][k[1]]
        np.testing.assert_array_equal(np.asarray(j), v.float().numpy(), err_msg=str(k))
        assert torch.equal(t, v.float()), k
        assert t.dtype == torch.float32   # bf16 written as f32; f32 as f32


def tree_leaves_with_names(tree):
    for k, v in tree.items():
        if isinstance(v, dict):
            for k2, v2 in v.items():
                yield (k, k2), v2
        else:
            yield (k,), v


def test_save_params_npz_of_the_port_feeds_the_jax_engine(setup, tmp_path):
    """A tree saved by the port and served by the JAX engine generates what
    the port's engine generates from the same tree."""
    jcfg, tcfg, _, tparams = setup
    path = str(tmp_path / "served.npz")
    save_params_npz(tparams, path)
    jparams = JaxLLMConfig(model_config=jcfg, checkpoint_path=path).load_params()
    ref = JaxEngine(jcfg, jparams, max_batch=1, max_seq=64).generate([9, 8, 7], max_tokens=5)
    got = LlamaEngine(tcfg, tparams, max_batch=1, max_seq=64, device="cpu").generate(
        [9, 8, 7], max_tokens=5)
    assert got == ref
    assert len(tree_leaves(tparams)) == len(jax.tree.leaves(jparams))


def test_gen_request_takes_adapter_id():
    r = GenRequest("r", [1, 2], adapter_id="a")
    assert (r.request_id, r.prompt_ids, r.adapter_id) == ("r", [1, 2], "a")
    args = ("r", [1, 2], 5, 0.5, 7, "a")
    ours, ref = GenRequest(*args), JaxGenRequest(*args)
    for f in dataclasses.fields(JaxGenRequest):
        assert getattr(ours, f.name) == getattr(ref, f.name), f.name
    assert [f.name for f in dataclasses.fields(GenRequest)] == [
        f.name for f in dataclasses.fields(JaxGenRequest)]
    assert GenRequest("r", [1]).adapter_id == ""
