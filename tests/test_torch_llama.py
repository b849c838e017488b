"""Parity of the port's Llama model (ray_tpu_torch.models.llama) with
ray_tpu/models/llama.py on LLAMA_TINY, from the same JAX-initialised
parameters carried over with params_from_numpy, on the CPU.

Tolerances (f32): logits atol 1e-4 (two layers of f32 products summed in
another order); losses rtol 1e-5; gradients atol 1e-6 and rtol 1e-4 (the
same products backward, for gradients of order 1e-3 to 1e-1); bf16
cast-point checks allow one bf16 rounding step (rtol 2**-7)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models import llama as jl
from ray_tpu_torch.models import llama as tl
from ray_tpu_torch.models import params_from_numpy

LOGIT_ATOL = 1e-4
BF16_RTOL = 2.0 ** -7
GRAD_ATOL = 1e-6


@pytest.fixture(scope="module")
def setup():
    jcfg = dataclasses.replace(jl.LLAMA_TINY, dtype=jnp.float32)
    tcfg = dataclasses.replace(tl.LLAMA_TINY, dtype=torch.float32)
    jparams = jl.init_params(jax.random.PRNGKey(0), jcfg)
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    tokens = np.random.default_rng(1).integers(0, jcfg.vocab_size, (2, 65)).astype(np.int32)
    return jcfg, tcfg, jparams, tparams, tokens


def test_stock_configs_match_reference():
    for name in ("LLAMA_3_8B", "LLAMA_3_70B", "LLAMA_2_7B", "LLAMA_TINY", "LLAMA_BENCH"):
        j, t = getattr(jl, name), getattr(tl, name)
        for f in ("vocab_size", "dim", "n_layers", "n_heads", "n_kv_heads", "ffn_dim",
                  "max_seq_len", "rope_theta", "norm_eps", "remat"):
            assert getattr(j, f) == getattr(t, f), (name, f)
        assert tl.param_count(t) == jl.param_count(j)
        assert tl.flops_per_token(t, 2048) == jl.flops_per_token(j, 2048)


def test_params_carry_over_names_and_shapes(setup):
    _, tcfg, jparams, tparams, _ = setup
    fresh = tl.init_params(torch.Generator().manual_seed(0), tcfg, "cpu")
    jflat = {jax.tree_util.keystr(k): v.shape
             for k, v in jax.tree_util.tree_leaves_with_path(jparams)}
    for tree in (tparams, fresh):
        flat = {}
        for k, v in tree.items():
            if isinstance(v, dict):
                flat.update({f"['{k}']['{k2}']": tuple(t.shape) for k2, t in v.items()})
            else:
                flat[f"['{k}']"] = tuple(v.shape)
        assert flat == jflat
    assert sum(t.numel() for t in jax.tree.leaves(fresh)) == tl.param_count(tcfg)


@pytest.mark.parametrize("impl", ["xla", "flash"])
def test_forward_logits_match(setup, impl):
    jcfg, tcfg, jparams, tparams, tokens = setup
    inputs = tokens[:, :-1]
    ref = jl.forward(jparams, jnp.asarray(inputs), dataclasses.replace(jcfg, attention_impl=impl))
    out = tl.forward(tparams, torch.from_numpy(inputs),
                     dataclasses.replace(tcfg, attention_impl=impl))
    assert out.dtype == torch.float32 and out.shape == (2, 64, tcfg.vocab_size)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=LOGIT_ATOL)


@pytest.mark.parametrize("ce_impl,attention_impl", [
    ("xla", "xla"), ("fused", "xla"), ("fused", "flash"),
])
def test_loss_matches(setup, ce_impl, attention_impl):
    jcfg, tcfg, jparams, tparams, tokens = setup
    mask = np.ones((2, 65), np.float32)
    mask[:, -5:] = 0.0
    kw = dict(ce_impl=ce_impl, attention_impl=attention_impl)
    ref = jl.loss_fn(jparams, {"tokens": jnp.asarray(tokens), "mask": jnp.asarray(mask)},
                     dataclasses.replace(jcfg, **kw))
    out = tl.loss_fn(tparams, {"tokens": torch.from_numpy(tokens),
                               "mask": torch.from_numpy(mask)},
                     dataclasses.replace(tcfg, **kw))
    np.testing.assert_allclose(float(out), float(ref), rtol=1e-5)


def test_forward_with_cache_matches(setup):
    jcfg, tcfg, jparams, tparams, tokens = setup
    B, max_seq, T = 2, 64, 8
    start = np.array([0, 5], np.int32)
    jcache = jl.init_kv_cache(jcfg, B, max_seq)
    tcache = tl.init_kv_cache(tcfg, B, max_seq, device="cpu")
    for step, (lo, hi) in enumerate([(0, T), (T, T + 1), (T + 1, T + 2)]):
        chunk = tokens[:, lo:hi]
        jlog, jcache = jl.forward_with_cache(jparams, jnp.asarray(chunk), jcache,
                                             jnp.asarray(start), jcfg)
        tlog, tcache = tl.forward_with_cache(tparams, torch.from_numpy(chunk), tcache,
                                             start, tcfg)
        np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), atol=LOGIT_ATOL,
                                   err_msg=f"step {step}")
        for name in ("k", "v"):
            np.testing.assert_allclose(tcache[name].numpy(), np.asarray(jcache[name]),
                                       atol=1e-5, err_msg=f"cache {name} step {step}")
        start = start + (hi - lo)


def test_cached_last_logits_equal_full_forward(setup):
    _, tcfg, _, tparams, tokens = setup
    prompt = torch.from_numpy(tokens[:1, :40])
    cache = tl.init_kv_cache(tcfg, 1, 64, device="cpu")
    for pos in range(0, 40, 16):
        logits, cache = tl.forward_with_cache(tparams, prompt[:, pos:pos + 16], cache,
                                              [pos], tcfg)
    full = tl.forward(tparams, prompt, dataclasses.replace(tcfg, attention_impl="flash"))
    np.testing.assert_allclose(logits[0, -1].numpy(), full[0, -1].numpy(), atol=LOGIT_ATOL)


def test_cache_write_past_the_end_raises(setup):
    _, tcfg, _, tparams, tokens = setup
    cache = tl.init_kv_cache(tcfg, 1, 16, device="cpu")
    with pytest.raises(ValueError, match="out of range"):
        tl.forward_with_cache(tparams, torch.from_numpy(tokens[:1, :8]), cache, [12], tcfg)


def test_config_checks_raise(setup):
    _, tcfg, _, tparams, tokens = setup
    odd = {"tokens": torch.from_numpy(tokens[:, :34])}   # B*S = 66
    with pytest.raises(ValueError, match="not applicable"):
        tl.loss_fn(tparams, odd, dataclasses.replace(tcfg, ce_impl="fused"))
    with pytest.raises(ValueError, match="not applicable"):
        tl.loss_fn(tparams, {"tokens": torch.from_numpy(tokens)},
                   dataclasses.replace(tcfg, ce_impl="fused", logit_softcap=30.0))
    # ring without a mesh falls back to flash, as the reference's
    # _attention_ring does with no ambient mesh (llama.py:243-244)
    ring = tl.forward(tparams, torch.from_numpy(tokens), dataclasses.replace(tcfg, attention_impl="ring"))
    flash = tl.forward(tparams, torch.from_numpy(tokens), dataclasses.replace(tcfg, attention_impl="flash"))
    assert torch.equal(ring, flash)
    with pytest.raises(ValueError, match="unknown attention_impl"):
        tl.forward(tparams, torch.from_numpy(tokens), dataclasses.replace(tcfg, attention_impl="x"))


def test_bf16_cast_points_match():
    """rms_norm (f32 compute, cast, weight in bf16) and apply_rope (f32
    half-split rotation) round where the reference rounds."""
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 16, 4, 32), dtype=np.float32)
    w = rng.standard_normal((32,), dtype=np.float32)
    jx = jnp.asarray(x, jnp.bfloat16)
    tx = torch.from_numpy(x).bfloat16()
    ref = jl.rms_norm(jx, jnp.asarray(w), 1e-5).astype(jnp.float32)
    out = tl.rms_norm(tx, torch.from_numpy(w), 1e-5)
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.float().numpy(), np.asarray(ref), rtol=BF16_RTOL, atol=1e-6)
    cfg_j = dataclasses.replace(jl.LLAMA_TINY, dim=128, n_heads=4)
    cfg_t = dataclasses.replace(tl.LLAMA_TINY, dim=128, n_heads=4)
    jc, js = jl.rope_table(cfg_j, 16)
    tc, ts = tl.rope_table(cfg_t, 16)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=1e-6)
    ref = jl.apply_rope(jx, jc, js).astype(jnp.float32)
    out = tl.apply_rope(tx, tc, ts)
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.float().numpy(), np.asarray(ref), rtol=BF16_RTOL, atol=1e-6)


def _torch_grads(tparams, batch, cfg):
    leaves = [tparams["embed"], *tparams["blocks"].values(), tparams["final_norm"],
              tparams["lm_head"]]
    leaves = [t.detach().requires_grad_() for t in leaves]
    names = ["embed", *tparams["blocks"], "final_norm", "lm_head"]
    tree = {"embed": leaves[0], "blocks": dict(zip(names[1:-2], leaves[1:-2])),
            "final_norm": leaves[-2], "lm_head": leaves[-1]}
    return names, torch.autograd.grad(tl.loss_fn(tree, batch, cfg), leaves)


@pytest.mark.parametrize("attention_impl", ["xla", "flash"])
@pytest.mark.parametrize("ce_impl", ["xla", "fused"])
def test_grads_match(setup, attention_impl, ce_impl):
    """Gradients of loss_fn (masked) against jax.grad(llama.loss_fn), f32;
    the port's flash and fused paths run their plain backward on the CPU,
    the reference's fused path its Pallas kernels in interpret mode."""
    jcfg, tcfg, jparams, tparams, tokens = setup
    mask = np.ones((2, 65), np.float32)
    mask[:, -5:] = 0.0
    kw = dict(ce_impl=ce_impl, attention_impl=attention_impl)
    ref = jax.grad(jl.loss_fn)(jparams, {"tokens": jnp.asarray(tokens), "mask": jnp.asarray(mask)},
                               dataclasses.replace(jcfg, **kw))
    names, grads = _torch_grads(tparams, {"tokens": torch.from_numpy(tokens),
                                          "mask": torch.from_numpy(mask)},
                                dataclasses.replace(tcfg, **kw))
    for name, g in zip(names, grads):
        r = ref[name] if name in ref else ref["blocks"][name]
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=GRAD_ATOL, rtol=1e-4,
                                   err_msg=name)


@pytest.mark.parametrize("attention_impl,ce_impl", [("xla", "xla"), ("flash", "fused")])
def test_remat_gives_the_same_grads(setup, attention_impl, ce_impl):
    """remat (torch.utils.checkpoint per block) recomputes the same values:
    the gradients with and without it are equal."""
    _, tcfg, _, tparams, tokens = setup
    batch = {"tokens": torch.from_numpy(tokens)}
    cfg = dataclasses.replace(tcfg, attention_impl=attention_impl, ce_impl=ce_impl)
    _, plain = _torch_grads(tparams, batch, dataclasses.replace(cfg, remat=False))
    _, remat = _torch_grads(tparams, batch, dataclasses.replace(cfg, remat=True))
    for a, b in zip(plain, remat):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-7, rtol=1e-6)
