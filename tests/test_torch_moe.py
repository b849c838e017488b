"""Parity of the port's MoE (ray_tpu_torch.ops.moe, models.moe_llama) with
ray_tpu/ops/moe.py and ray_tpu/models/moe_llama.py on the CPU, from the
same numpy inputs and the same JAX-initialised parameters.

Tolerances (f32): top_k_gating's dispatch exactly (0/1), expert_load
rtol 1e-6 (the same counts over T, divided in another order), combine
atol 1e-6 and the aux loss rtol 1e-6 (the same f32 softmax); moe_ffn
outputs atol 1e-5 (four f32 products summed in another order); MOE_TINY logits atol 1e-4 and losses rtol 1e-5, gradients atol
1e-6 + rtol 1e-4, as tests/test_torch_llama.py holds the dense model;
train steps as tests/test_torch_train_step.py (loss rtol 1e-5, params
atol 1e-5). The bf16 moe_ffn case allows two bf16 steps of the output
(rtol 2**-6, atol 2**-6 against outputs of order 1)."""

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu import parallel as jpar
from ray_tpu.models import moe_llama as jm
from ray_tpu.ops import moe as jmoe
from ray_tpu_torch import parallel as tpar
from ray_tpu_torch.models import moe_llama as tm
from ray_tpu_torch.models import params_from_numpy
from ray_tpu_torch.ops import moe as tmoe

LOGIT_ATOL = 1e-4
GRAD_ATOL = 1e-6


def _gating_case(name):
    """(logits (T, E) f32, kwargs, token_mask or None) of each case."""
    rng = np.random.default_rng(0)
    T, E = 24, 4
    logits = rng.standard_normal((T, E)).astype(np.float32)
    if name == "random":
        return logits, {}, None
    if name == "tied":
        # a zero router: every probability ties, so lax.top_k's lower-index
        # rule sends every token to experts 0 and 1, past their capacity
        return np.zeros((T, E), np.float32), {}, None
    if name == "partly_tied":
        # ties inside the top two and between the second and third choices
        return rng.integers(0, 2, (T, E)).astype(np.float32), dict(k=2), None
    if name == "masked":
        mask = np.ones(T, np.float32)
        mask[-7:] = 0.0
        return logits, {}, mask
    if name == "all_masked":
        return logits, {}, np.zeros(T, np.float32)
    if name == "dropping":
        return logits, dict(capacity_factor=0.5, min_capacity=2), None
    if name == "dropping_masked_k1":
        mask = (rng.random(T) > 0.3).astype(np.float32)
        return logits, dict(k=1, capacity_factor=0.6, min_capacity=1), mask
    raise KeyError(name)


GATING_CASES = ["random", "tied", "partly_tied", "masked", "all_masked", "dropping",
                "dropping_masked_k1"]


@pytest.mark.parametrize("case", GATING_CASES)
def test_top_k_gating_matches_jax(case):
    logits, kw, mask = _gating_case(case)
    ref = jmoe.top_k_gating(jnp.asarray(logits), token_mask=None if mask is None
                            else jnp.asarray(mask), **kw)
    out = tmoe.top_k_gating(torch.from_numpy(logits), token_mask=None if mask is None
                            else torch.from_numpy(mask), **kw)
    assert out.dispatch.shape == ref.dispatch.shape
    np.testing.assert_array_equal(out.dispatch.numpy(), np.asarray(ref.dispatch))
    # expert_load: the same counts, each divided by T (or the real-token
    # count) in another order of the f32 operations
    np.testing.assert_allclose(out.expert_load.numpy(), np.asarray(ref.expert_load), rtol=1e-6)
    np.testing.assert_allclose(out.combine.numpy(), np.asarray(ref.combine), atol=1e-6)
    np.testing.assert_allclose(float(out.aux_loss), float(ref.aux_loss), rtol=1e-6)


def test_gating_cases_reach_what_they_claim():
    """The tied case drops assignments (slots past the capacity) and the
    dropping case too; a dropped assignment leaves no trace in dispatch."""
    for case in ("tied", "dropping"):
        logits, kw, _ = _gating_case(case)
        out = tmoe.top_k_gating(torch.from_numpy(logits), **kw)
        k = kw.get("k", 2)
        assert out.dispatch.sum() < logits.shape[0] * k, case
    out = tmoe.top_k_gating(torch.zeros(24, 4))
    assert out.dispatch[:, 2:].sum() == 0 and out.dispatch[:, :2].sum() == 2 * 15


@pytest.mark.parametrize("masked", [False, True])
def test_moe_ffn_matches_jax(masked):
    cfg = jmoe.MoEConfig(d_model=32, d_ff=48, n_experts=4, k=2, capacity_factor=1.0)
    jparams = jmoe.init_moe_params(jax.random.PRNGKey(0), cfg, dtype=jnp.float32)
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 12, 32)).astype(np.float32)
    mask = (rng.random((2, 12)) > 0.25).astype(np.float32) if masked else None
    ref, raux = jmoe.moe_ffn(jparams, jnp.asarray(x), cfg,
                             None if mask is None else jnp.asarray(mask))
    out, aux = tmoe.moe_ffn(tparams, torch.from_numpy(x), tmoe.MoEConfig(32, 48, 4, 2, 1.0),
                            None if mask is None else torch.from_numpy(mask))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5)
    np.testing.assert_allclose(float(aux), float(raux), rtol=1e-6)


def test_moe_ffn_bf16_matches_jax():
    """bf16 experts and input, f32 router: the router's choices are the
    reference's (f32), the expert products round to bf16 as there."""
    cfg = jmoe.MoEConfig(d_model=32, d_ff=48, n_experts=4)
    jparams = jmoe.init_moe_params(jax.random.PRNGKey(2), cfg)
    tparams = params_from_numpy(jax.tree.map(lambda a: np.asarray(a, np.float32), jparams), "cpu")
    tparams = {k: v if k == "router" else v.bfloat16() for k, v in tparams.items()}
    x = np.random.default_rng(3).standard_normal((2, 8, 32)).astype(np.float32)
    ref, raux = jmoe.moe_ffn(jparams, jnp.asarray(x, jnp.bfloat16), cfg)
    out, aux = tmoe.moe_ffn(tparams, torch.from_numpy(x).bfloat16(), tmoe.MoEConfig(32, 48, 4))
    assert out.dtype == torch.bfloat16 and tparams["router"].dtype == torch.float32
    np.testing.assert_allclose(out.float().numpy(), np.asarray(ref, np.float32),
                               rtol=2.0 ** -6, atol=2.0 ** -6)
    np.testing.assert_allclose(float(aux), float(raux), rtol=1e-5)


def test_init_moe_params_shapes_and_dtypes():
    jp = jmoe.init_moe_params(jax.random.PRNGKey(0), jmoe.MoEConfig(16, 24, 4))
    tp = tmoe.init_moe_params(torch.Generator().manual_seed(0), tmoe.MoEConfig(16, 24, 4),
                              device="cpu")
    for k in jp:
        assert tuple(tp[k].shape) == jp[k].shape, k
        assert str(tp[k].dtype).split(".")[-1] == str(jp[k].dtype), k


@pytest.fixture(scope="module")
def setup():
    jcfg = dataclasses.replace(jm.MOE_TINY, dtype=jnp.float32)
    tcfg = dataclasses.replace(tm.MOE_TINY, dtype=torch.float32)
    jparams = jm.init_params(jax.random.PRNGKey(0), jcfg)
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    rng = np.random.default_rng(1)
    tokens = rng.integers(0, jcfg.vocab_size, (2, 33)).astype(np.int32)
    mask = np.ones((2, 33), np.float32)
    mask[:, :6] = 0.0          # loss mask: a prompt whose tokens still route
    input_mask = np.ones((2, 33), np.float32)
    input_mask[1, -9:] = 0.0   # routing mask: padding at the end of row 1
    return jcfg, tcfg, jparams, tparams, tokens, mask, input_mask


def test_stock_configs_and_counts_match_reference():
    for name in ("MIXTRAL_8X7B", "MOE_TINY"):
        j, t = getattr(jm, name), getattr(tm, name)
        for f in ("vocab_size", "dim", "n_layers", "n_heads", "n_kv_heads", "ffn_dim",
                  "max_seq_len", "rope_theta", "norm_eps", "remat", "n_experts",
                  "experts_per_token", "capacity_factor", "router_aux_coeff"):
            assert getattr(j, f) == getattr(t, f), (name, f)
        assert tm.param_count(t) == jm.param_count(j)
        assert tm.active_param_count(t) == jm.active_param_count(j)
        assert dataclasses.asdict(t.moe) == dataclasses.asdict(j.moe)
    cut = dataclasses.replace(tm.MIXTRAL_8X7B, n_layers=2)
    assert tm.param_count(cut) == jm.param_count(dataclasses.replace(jm.MIXTRAL_8X7B,
                                                                     n_layers=2))


def test_params_carry_over_names_shapes_and_count(setup):
    _, tcfg, jparams, tparams, *_ = setup
    fresh = tm.init_params(torch.Generator().manual_seed(0), tcfg, "cpu")
    jflat = {jax.tree_util.keystr(k): (v.shape, str(v.dtype))
             for k, v in jax.tree_util.tree_leaves_with_path(jparams)}
    for tree in (tparams, fresh):
        flat = {}
        for k, v in tree.items():
            items = v.items() if isinstance(v, dict) else [(None, v)]
            for k2, t in items:
                key = f"['{k}']" + (f"['{k2}']" if k2 else "")
                flat[key] = (tuple(t.shape), str(t.dtype).split(".")[-1])
        assert flat == jflat
    assert sum(t.numel() for t in tpar.tree_leaves(fresh)) == tm.param_count(tcfg)


@pytest.mark.parametrize("impl", ["xla", "flash"])
def test_forward_logits_and_aux_match(setup, impl):
    jcfg, tcfg, jparams, tparams, tokens, _, input_mask = setup
    inputs, m = tokens[:, :-1], input_mask[:, :-1]
    for routing in (None, m):
        rl, ra = jm.forward(jparams, jnp.asarray(inputs), dataclasses.replace(jcfg, attention_impl=impl),
                            mask=None if routing is None else jnp.asarray(routing))
        ol, oa = tm.forward(tparams, torch.from_numpy(inputs),
                            dataclasses.replace(tcfg, attention_impl=impl),
                            mask=None if routing is None else torch.from_numpy(routing))
        assert ol.dtype == torch.float32 and ol.shape == (2, 32, tcfg.vocab_size)
        np.testing.assert_allclose(ol.numpy(), np.asarray(rl), atol=LOGIT_ATOL)
        np.testing.assert_allclose(float(oa), float(ra), rtol=1e-5)


def _batches(tokens, mask, input_mask):
    """The loss and routing masks apart, together, and in the
    inputs/targets form (where input_mask is not sliced)."""
    return [
        {"tokens": tokens},
        {"tokens": tokens, "mask": mask},
        {"tokens": tokens, "input_mask": input_mask},
        {"tokens": tokens, "mask": mask, "input_mask": input_mask},
        {"inputs": tokens[:, :-1], "targets": tokens[:, 1:], "mask": mask[:, 1:],
         "input_mask": input_mask[:, :-1]},
    ]


@pytest.mark.parametrize("impl", ["xla", "flash"])
def test_loss_matches(setup, impl):
    jcfg, tcfg, jparams, tparams, tokens, mask, input_mask = setup
    jc = dataclasses.replace(jcfg, attention_impl=impl)
    tc = dataclasses.replace(tcfg, attention_impl=impl)
    losses = []
    for b in _batches(tokens, mask, input_mask):
        ref = jm.loss_fn(jparams, {k: jnp.asarray(v) for k, v in b.items()}, jc)
        out = tm.loss_fn(tparams, {k: torch.from_numpy(v) for k, v in b.items()}, tc)
        np.testing.assert_allclose(float(out), float(ref), rtol=1e-5, err_msg=str(list(b)))
        losses.append(float(out))
    # the masks change the loss: the loss mask through the CE, the routing
    # mask through the experts and the aux loss
    assert len(set(losses[:4])) == 4


def _torch_grads(tparams, batch, cfg):
    names = ["embed", *tparams["blocks"], "final_norm", "lm_head"]
    leaves = [t.detach().requires_grad_() for t in
              [tparams["embed"], *tparams["blocks"].values(), tparams["final_norm"],
               tparams["lm_head"]]]
    tree = {"embed": leaves[0], "blocks": dict(zip(names[1:-2], leaves[1:-2])),
            "final_norm": leaves[-2], "lm_head": leaves[-1]}
    return names, torch.autograd.grad(tm.loss_fn(tree, batch, cfg), leaves)


@pytest.mark.parametrize("impl", ["xla", "flash"])
def test_grads_match(setup, impl):
    """Gradients of loss_fn (loss and routing masks) against jax.grad,
    router included (through the gate values and the aux loss)."""
    jcfg, tcfg, jparams, tparams, tokens, mask, input_mask = setup
    b = {"tokens": tokens, "mask": mask, "input_mask": input_mask}
    ref = jax.grad(jm.loss_fn)(jparams, {k: jnp.asarray(v) for k, v in b.items()},
                               dataclasses.replace(jcfg, attention_impl=impl))
    names, grads = _torch_grads(tparams, {k: torch.from_numpy(v) for k, v in b.items()},
                                dataclasses.replace(tcfg, attention_impl=impl))
    for name, g in zip(names, grads):
        r = ref[name] if name in ref else ref["blocks"][name]
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=GRAD_ATOL, rtol=1e-4,
                                   err_msg=name)
    assert float(grads[names.index("router")].abs().max()) > 0


def test_remat_gives_the_same_grads(setup):
    """remat (torch.utils.checkpoint of a block returning (x, aux))
    recomputes the same values."""
    _, tcfg, _, tparams, tokens, mask, input_mask = setup
    b = {"tokens": torch.from_numpy(tokens), "mask": torch.from_numpy(mask),
         "input_mask": torch.from_numpy(input_mask)}
    _, plain = _torch_grads(tparams, b, tcfg)
    _, remat = _torch_grads(tparams, b, dataclasses.replace(tcfg, remat=True,
                                                            attention_impl="flash"))
    _, flash = _torch_grads(tparams, b, dataclasses.replace(tcfg, attention_impl="flash"))
    for a, r in zip(flash, remat):
        assert torch.equal(a, r)
    for a, r in zip(plain, remat):
        np.testing.assert_allclose(a.numpy(), r.numpy(), atol=GRAD_ATOL, rtol=1e-4)


def test_softcap_matches(setup):
    jcfg, tcfg, jparams, tparams, tokens, *_ = setup
    ref, _ = jm.forward(jparams, jnp.asarray(tokens), dataclasses.replace(jcfg, logit_softcap=5.0))
    out, _ = tm.forward(tparams, torch.from_numpy(tokens),
                        dataclasses.replace(tcfg, logit_softcap=5.0))
    assert float(out.abs().max()) < 5.0
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=LOGIT_ATOL)


def test_fused_ce_is_refused(setup):
    _, tcfg, _, tparams, tokens, *_ = setup
    with pytest.raises(ValueError, match="not applicable"):
        tm.loss_fn(tparams, {"tokens": torch.from_numpy(tokens)},
                   dataclasses.replace(tcfg, ce_impl="fused"))


def test_moe_train_steps_match_jax():
    """Three steps of make_train_step on the MoE loss against the JAX
    make_train_step on a one-device CPU mesh (MOE_TINY f32, routing mask
    given): loss, grad_norm and every parameter after each step."""
    jcfg = dataclasses.replace(jm.MOE_TINY, dtype=jnp.float32)
    tcfg = dataclasses.replace(tm.MOE_TINY, dtype=torch.float32)
    mesh = jpar.make_mesh(devices=jax.devices()[:1])
    jopt = jpar.default_optimizer(1e-3, warmup_steps=1, total_steps=10)
    jstate, state_sh = jpar.create_train_state(
        mesh, jax.random.PRNGKey(0), lambda r: jm.init_params(r, jcfg), jopt,
        jm.param_specs(jcfg))
    tree = jax.tree.map(np.asarray, jstate.params)
    jstep = jpar.make_train_step(partial(jm.loss_fn, config=jcfg), jopt, mesh, state_sh)
    topt = tpar.default_optimizer(1e-3, warmup_steps=1, total_steps=10)
    tstate = tpar.create_train_state(None, lambda _: params_from_numpy(tree, "cpu"), topt,
                                     device="cpu")
    tstep = tpar.make_train_step(lambda p, b: tm.loss_fn(p, b, tcfg), topt)
    rng = np.random.default_rng(4)
    for i in range(3):
        tokens = rng.integers(0, jcfg.vocab_size, (2, 33)).astype(np.int32)
        input_mask = np.ones((2, 33), np.float32)
        input_mask[0, -4:] = 0.0
        jstate, jmet = jstep(jstate, {"tokens": jnp.asarray(tokens),
                                      "input_mask": jnp.asarray(input_mask)})
        tstate, tmet = tstep(tstate, {"tokens": torch.from_numpy(tokens),
                                      "input_mask": torch.from_numpy(input_mask)})
        np.testing.assert_allclose(float(tmet["loss"]), float(jmet["loss"]), rtol=1e-5)
        np.testing.assert_allclose(float(tmet["grad_norm"]), float(jmet["grad_norm"]),
                                   rtol=1e-5)
        # the port's tree came from jax.tree.map: its dicts hold the keys
        # in jax.tree.leaves' (sorted) order
        for t, j in zip(tpar.tree_leaves(tstate.params), jax.tree.leaves(jstate.params)):
            np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), atol=1e-5,
                                       err_msg=f"step {i}")
