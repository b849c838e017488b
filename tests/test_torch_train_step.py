"""Parity of the port's training step (ray_tpu_torch.parallel) with
ray_tpu/parallel/train_step.py and optax, on the CPU, from the same
numpy parameters and tokens.

Tolerances: f32 losses and grad norms rtol 1e-5, and parameters atol 1e-5
after each step: an Adam step moves a parameter by ~lr = 1e-3 whatever
the gradient's size, so an element whose gradient is tiny and only
agrees to ~1e-6 relative can move differently by up to ~1e-6 (1% of one
step is allowed). The optimizer alone, each update from the same state:
f32 at a few ulps (rtol 1e-6, atol 1e-7); bf16 exact, since the port
rounds every op of the chain as XLA does. Schedule rtol 1e-6 (Python
floats against optax's f32)."""

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ray_tpu import parallel as jpar
from ray_tpu.models import llama as jl
from ray_tpu_torch import parallel as tpar
from ray_tpu_torch.models import llama as tl
from ray_tpu_torch.models import params_from_numpy


def _flat(tree):
    """(name, array) pairs of a parameter tree in the port's leaf order."""
    return [("embed", tree["embed"]), *((k, v) for k, v in tree["blocks"].items()),
            ("final_norm", tree["final_norm"]), ("lm_head", tree["lm_head"])]


def test_train_steps_match_jax():
    """Four steps of make_train_step against the JAX make_train_step on a
    one-device CPU mesh: loss, grad_norm and every parameter after each
    step (LLAMA_TINY f32, default_optimizer(1e-3, warmup 2, total 10))."""
    jcfg = dataclasses.replace(jl.LLAMA_TINY, dtype=jnp.float32)
    tcfg = dataclasses.replace(tl.LLAMA_TINY, dtype=torch.float32)
    mesh = jpar.make_mesh(devices=jax.devices()[:1])
    jopt = jpar.default_optimizer(1e-3, warmup_steps=2, total_steps=10)
    jstate, state_sh = jpar.create_train_state(
        mesh, jax.random.PRNGKey(0), lambda r: jl.init_params(r, jcfg), jopt,
        jl.param_specs(jcfg))
    tree = jax.tree.map(np.asarray, jstate.params)
    jstep = jpar.make_train_step(partial(jl.loss_fn, config=jcfg), jopt, mesh, state_sh)

    topt = tpar.default_optimizer(1e-3, warmup_steps=2, total_steps=10)
    tstate = tpar.create_train_state(None, lambda _: params_from_numpy(tree, "cpu"), topt,
                                     device="cpu")
    tstep = tpar.make_train_step(lambda p, b: tl.loss_fn(p, b, tcfg), topt)

    rng = np.random.default_rng(1)
    for i in range(4):
        tokens = rng.integers(0, jcfg.vocab_size, (2, 65)).astype(np.int32)
        jstate, jm = jstep(jstate, {"tokens": jnp.asarray(tokens)})
        tstate, tm = tstep(tstate, {"tokens": torch.from_numpy(tokens)})
        assert tm["step"] == int(jm["step"]) == i + 1
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=1e-5)
        np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]), rtol=1e-5)
        for (name, t), (_, j) in zip(_flat(tstate.params), _flat(jstate.params)):
            np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), atol=1e-5,
                                       err_msg=f"step {i}: {name}")


def _random_tree(rng, dtype):
    tree = {"a": rng.standard_normal((8, 16)),
            "b": {"c": rng.standard_normal(32), "d": rng.standard_normal((4, 4, 4))}}
    return jax.tree.map(lambda a: jnp.asarray(a, dtype), tree)


def _to_torch(tree, dtype):
    return tpar.tree_map(lambda a: torch.from_numpy(np.array(a, np.float32)).to(dtype), tree)


@pytest.mark.parametrize("dtype,grad_scale", [("float32", 0.01), ("float32", 3.0),
                                              ("bfloat16", 3.0)])
def test_optimizer_matches_optax(dtype, grad_scale):
    """default_optimizer alone against the optax chain: five updates with
    fresh gradients, each from the same state (the port's parameters and
    moments are set to optax's before every update); grad_scale 3.0 makes
    the global norm > 1 (clipped). In bf16 the port's f32 norm rounds to
    optax's bf16 norm, and then parameters and moments must equal optax's
    bit for bit; the case runs at lr 1.0, so that a step and its
    weight-decay part (lr x 0.1 x |p|) span many bf16 steps of p."""
    lr = 1.0 if dtype == "bfloat16" else 1e-2
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    rng = np.random.default_rng(2)
    jparams = _random_tree(rng, jdt)
    jopt = jpar.default_optimizer(lr, warmup_steps=2, total_steps=10)
    topt = tpar.default_optimizer(lr, warmup_steps=2, total_steps=10)
    tparams = _to_torch(jparams, tdt)
    jstate, tstate = jopt.init(jparams), topt.init(tparams)
    clipped = []
    for _ in range(5):
        adam = jstate[1][0]
        for tt, jt in ((tparams, jparams), (tstate.mu, adam.mu), (tstate.nu, adam.nu)):
            for t, j in zip(tpar.tree_leaves(tt), jax.tree.leaves(jt)):
                t.copy_(torch.from_numpy(np.array(j, np.float32)))
        grads = jax.tree.map(
            lambda a: jnp.asarray(rng.standard_normal(a.shape) * grad_scale, jdt), jparams)
        gnorm = float(optax.global_norm(grads))
        clipped.append(gnorm >= 1.0)
        upd, jstate = jopt.update(grads, jstate, jparams)
        jparams = optax.apply_updates(jparams, upd)
        tstate, tnorm = topt.update(_to_torch(grads, tdt), tstate, tparams)
        if dtype == "bfloat16":
            assert float(tnorm.to(tdt)) == gnorm
        else:
            np.testing.assert_allclose(float(tnorm), gnorm, rtol=1e-6)
        adam = jstate[1][0]
        for tt, jt in ((tparams, jparams), (tstate.mu, adam.mu), (tstate.nu, adam.nu)):
            for t, j in zip(tpar.tree_leaves(tt), jax.tree.leaves(jt)):
                assert t.dtype == tdt
                if dtype == "bfloat16":
                    np.testing.assert_array_equal(t.float().numpy(), np.asarray(j, np.float32))
                else:
                    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-6, atol=1e-7)
    assert tstate.count == 5 and all(clipped) == (grad_scale > 1)


def test_schedule_matches_optax():
    """The learning rate at steps 0..12: warmup from 0 (step 0 has lr 0),
    then cosine decay, as optax.warmup_cosine_decay_schedule."""
    ref = optax.warmup_cosine_decay_schedule(0.0, 1e-3, 4, 10)
    ours = tpar.default_optimizer(1e-3, warmup_steps=4, total_steps=10).learning_rate
    for i in range(13):
        np.testing.assert_allclose(ours(i), float(ref(i)), rtol=1e-6, atol=1e-12)
    assert ours(0) == 0.0


def test_step_zero_changes_nothing():
    cfg = dataclasses.replace(tl.LLAMA_TINY, dtype=torch.float32)
    opt = tpar.default_optimizer(1e-3, warmup_steps=2, total_steps=10)
    state = tpar.create_train_state(torch.Generator().manual_seed(0),
                                    lambda g: tl.init_params(g, cfg, "cpu"), opt, device="cpu")
    before = [t.detach().clone() for t in tpar.tree_leaves(state.params)]
    step = tpar.make_train_step(lambda p, b: tl.loss_fn(p, b, cfg), opt)
    tokens = torch.from_numpy(np.random.default_rng(3).integers(0, cfg.vocab_size, (2, 33)))
    state, m = step(state, {"tokens": tokens})
    assert m["step"] == 1 and state.opt_state.count == 1
    assert all(torch.equal(a, b) for a, b in zip(before, tpar.tree_leaves(state.params)))
    state, _ = step(state, {"tokens": tokens})
    assert not all(torch.equal(a, b) for a, b in zip(before, tpar.tree_leaves(state.params)))


def test_eval_step_matches_jax_loss():
    jcfg = dataclasses.replace(jl.LLAMA_TINY, dtype=jnp.float32)
    tcfg = dataclasses.replace(tl.LLAMA_TINY, dtype=torch.float32)
    jparams = jl.init_params(jax.random.PRNGKey(4), jcfg)
    tree = jax.tree.map(np.asarray, jparams)
    opt = tpar.default_optimizer()
    state = tpar.create_train_state(None, lambda _: params_from_numpy(tree, "cpu"), opt,
                                    device="cpu")
    tokens = np.random.default_rng(5).integers(0, jcfg.vocab_size, (2, 33)).astype(np.int32)
    out = tpar.make_eval_step(lambda p, b: tl.loss_fn(p, b, tcfg))(
        state, {"tokens": torch.from_numpy(tokens)})
    assert not out["loss"].requires_grad
    ref = jl.loss_fn(jparams, {"tokens": jnp.asarray(tokens)}, jcfg)
    np.testing.assert_allclose(float(out["loss"]), float(ref), rtol=1e-5)


@pytest.mark.parametrize("grad_scale", [0.01, 3.0])
def test_mixed_dtype_tree_matches_optax(grad_scale):
    """An MoE-like tree, an f32 router beside bf16 experts, through
    default_optimizer against the optax chain, five updates each from the
    same state: every leaf keeps its dtype and its moments are in it.
    optax sums each bf16 leaf's squares in bf16 before the f32 total,
    the port in f32, so the norms agree to one bf16 step (rtol 2**-8).
    Unclipped (grad_scale 0.01) the clip is the identity on both sides:
    bf16 leaves equal optax's bit for bit and the f32 leaf agrees to a
    few ulps (rtol 1e-6, atol 1e-7). Clipped (3.0), each side divides by
    its own norm, which Adam's normalisation almost cancels: the f32 leaf
    within 1e-5 and the bf16 leaves within one bf16 step (rtol 2**-7)."""
    rng = np.random.default_rng(6)
    dtypes = {"router": jnp.float32, "w_gate": jnp.bfloat16, "w_up": jnp.bfloat16}
    jparams = {k: jnp.asarray(rng.standard_normal((4, 8, 6)), dt) for k, dt in dtypes.items()}
    jopt = jpar.default_optimizer(1e-2, warmup_steps=2, total_steps=10)
    topt = tpar.default_optimizer(1e-2, warmup_steps=2, total_steps=10)
    tparams = {k: torch.from_numpy(np.array(v, np.float32)).to(getattr(torch, str(v.dtype)))
               for k, v in jparams.items()}
    jstate, tstate = jopt.init(jparams), topt.init(tparams)
    for _ in range(5):
        adam = jstate[1][0]
        for tt, jt in ((tparams, jparams), (tstate.mu, adam.mu), (tstate.nu, adam.nu)):
            for k in dtypes:
                tt[k].copy_(torch.from_numpy(np.array(jt[k], np.float32)))
        grads = {k: jnp.asarray(rng.standard_normal(v.shape) * grad_scale, v.dtype)
                 for k, v in jparams.items()}
        gnorm = float(optax.global_norm(grads))
        upd, jstate = jopt.update(grads, jstate, jparams)
        jparams = optax.apply_updates(jparams, upd)
        tgrads = {k: torch.from_numpy(np.array(v, np.float32)).to(tparams[k].dtype)
                  for k, v in grads.items()}
        tstate, tnorm = topt.update(tgrads, tstate, tparams)
        np.testing.assert_allclose(float(tnorm), gnorm, rtol=2.0 ** -8)
        assert (gnorm >= 1.0) == (grad_scale > 1)
        adam = jstate[1][0]
        for tt, jt in ((tparams, jparams), (tstate.mu, adam.mu), (tstate.nu, adam.nu)):
            for k, dt in dtypes.items():
                t, j = tt[k], jt[k]
                assert str(t.dtype).split(".")[-1] == jnp.dtype(dt).name == str(j.dtype)
                t, j = t.float().numpy(), np.asarray(j, np.float32)
                if grad_scale > 1:
                    tol = dict(atol=1e-5) if dt == jnp.float32 else dict(rtol=2.0 ** -7)
                    np.testing.assert_allclose(t, j, err_msg=k, **tol)
                elif dt == jnp.float32:
                    np.testing.assert_allclose(t, j, rtol=1e-6, atol=1e-7, err_msg=k)
                else:
                    np.testing.assert_array_equal(t, j, err_msg=k)
