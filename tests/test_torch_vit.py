"""Parity of the port's ViT (ray_tpu_torch.models.vit) with
ray_tpu/models/vit.py on the CPU, from the same JAX-initialised
parameters and the same numpy images.

Tolerances: patchify exactly (a reshape and transpose); f32 (VIT_TINY)
logits atol 1e-4 and losses rtol 1e-5, gradients atol 1e-6 + rtol 1e-4,
as the Llama parity tests; layer norm in f32 atol 1e-5. bf16 (the
default working dtype): logits atol 0.15 against logits of order 1
(read 5.1e-2) and losses rtol 1e-2 (read 3.0e-3): two layers of bf16
products, layer norms and GELUs, rounded where the reference rounds,
with the sums in another order; the bf16 layer norm within two bf16
steps (rtol 2**-6, atol 2**-6)."""

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu import parallel as jpar
from ray_tpu.models import vit as jv
from ray_tpu_torch import parallel as tpar
from ray_tpu_torch.models import params_from_numpy
from ray_tpu_torch.models import vit as tv

LOGIT_ATOL = 1e-4
GRAD_ATOL = 1e-6


@pytest.fixture(scope="module")
def setup():
    jparams = jv.init_params(jax.random.PRNGKey(0), jv.VIT_TINY)
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    rng = np.random.default_rng(1)
    images = rng.standard_normal((3, 32, 32, 3)).astype(np.float32)
    labels = rng.integers(0, 10, (3,)).astype(np.int32)
    return jparams, tparams, images, labels


def test_stock_configs_and_counts_match_reference():
    for name in ("VIT_B_16", "VIT_L_16", "VIT_TINY"):
        j, t = getattr(jv, name), getattr(tv, name)
        for f in ("image_size", "patch_size", "num_classes", "dim", "n_layers", "n_heads",
                  "mlp_dim", "channels", "norm_eps", "remat"):
            assert getattr(j, f) == getattr(t, f), (name, f)
        assert str(t.dtype).split(".")[-1] == jnp.dtype(j.dtype).name
        assert str(t.param_dtype).split(".")[-1] == jnp.dtype(j.param_dtype).name
        # the reference counts by initialising; count its shapes without
        # allocating them
        shapes = jax.eval_shape(lambda: jv.init_params(jax.random.PRNGKey(0), j))
        assert tv.param_count(t) == sum(int(np.prod(s.shape)) for s in jax.tree.leaves(shapes))
    assert tv.param_count(tv.VIT_B_16) == 86_530_792


def test_params_carry_over_names_shapes_and_dtypes(setup):
    jparams, tparams, *_ = setup
    fresh = tv.init_params(torch.Generator().manual_seed(0), tv.VIT_TINY, "cpu")
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
    assert sum(t.numel() for t in tpar.tree_leaves(fresh)) == tv.param_count(tv.VIT_TINY)


def test_patchify_matches(setup):
    *_, images, _ = setup
    ref = jv.patchify(jnp.asarray(images), jv.VIT_TINY)
    out = tv.patchify(torch.from_numpy(images), tv.VIT_TINY)
    assert out.shape == (3, 16, 192)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layer_norm_matches(dtype):
    """Mean and population variance in x's dtype (jnp.var is not the
    unbiased torch.var default)."""
    rng = np.random.default_rng(2)
    x = (rng.standard_normal((4, 7, 48)) * 3 + 1).astype(np.float32)
    s, b = rng.standard_normal(48).astype(np.float32), rng.standard_normal(48).astype(np.float32)
    ref = jv._layer_norm(jnp.asarray(x, dtype), jnp.asarray(s), jnp.asarray(b), 1e-6)
    out = tv._layer_norm(torch.from_numpy(x).to(getattr(torch, dtype)), torch.from_numpy(s),
                         torch.from_numpy(b), 1e-6)
    assert str(out.dtype).split(".")[-1] == dtype
    tol = dict(atol=1e-5) if dtype == "float32" else dict(rtol=2.0 ** -6, atol=2.0 ** -6)
    np.testing.assert_allclose(out.float().numpy(), np.asarray(ref, np.float32), **tol)


def test_forward_and_loss_match(setup):
    jparams, tparams, images, labels = setup
    ref = jv.forward(jparams, jnp.asarray(images), jv.VIT_TINY)
    out = tv.forward(tparams, torch.from_numpy(images), tv.VIT_TINY)
    assert out.dtype == torch.float32 and out.shape == (3, 10)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=LOGIT_ATOL)
    jb = {"image": jnp.asarray(images), "label": jnp.asarray(labels)}
    tb = {"image": torch.from_numpy(images), "label": torch.from_numpy(labels)}
    np.testing.assert_allclose(float(tv.loss_fn(tparams, tb, tv.VIT_TINY)),
                               float(jv.loss_fn(jparams, jb, jv.VIT_TINY)), rtol=1e-5)


def _torch_grads(tparams, batch, cfg):
    leaves = [t.detach().requires_grad_() for t in tpar.tree_leaves(tparams)]
    it = iter(leaves)
    tree = tpar.tree_map(lambda _: next(it), tparams)
    return leaves, torch.autograd.grad(tv.loss_fn(tree, batch, cfg), leaves)


@pytest.mark.parametrize("remat", [False, True])
def test_grads_match(setup, remat):
    """Gradients of loss_fn against jax.grad(vit.loss_fn), with and
    without remat (torch.utils.checkpoint per block)."""
    jparams, tparams, images, labels = setup
    jcfg = dataclasses.replace(jv.VIT_TINY, remat=remat)
    tcfg = dataclasses.replace(tv.VIT_TINY, remat=remat)
    ref = jax.grad(jv.loss_fn)(jparams, {"image": jnp.asarray(images),
                                         "label": jnp.asarray(labels)}, jcfg)
    _, grads = _torch_grads(tparams, {"image": torch.from_numpy(images),
                                      "label": torch.from_numpy(labels)}, tcfg)
    # tparams came from jax.tree.map: its dicts are in jax.tree.leaves' order
    for g, r in zip(grads, jax.tree.leaves(ref)):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=GRAD_ATOL, rtol=1e-4)


def test_bf16_forward_and_loss_match(setup):
    """The default working dtype (bf16 activations, f32 parameters)."""
    jparams, tparams, images, labels = setup
    jcfg = dataclasses.replace(jv.VIT_TINY, dtype=jnp.bfloat16)
    tcfg = dataclasses.replace(tv.VIT_TINY, dtype=torch.bfloat16)
    ref = jv.forward(jparams, jnp.asarray(images), jcfg)
    out = tv.forward(tparams, torch.from_numpy(images), tcfg)
    assert out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=0.15)
    jb = {"image": jnp.asarray(images), "label": jnp.asarray(labels)}
    tb = {"image": torch.from_numpy(images), "label": torch.from_numpy(labels)}
    np.testing.assert_allclose(float(tv.loss_fn(tparams, tb, tcfg)),
                               float(jv.loss_fn(jparams, jb, jcfg)), rtol=1e-2)


def test_vit_train_steps_match_jax():
    """Three steps of make_train_step on the ViT loss against the JAX
    make_train_step on a one-device CPU mesh (VIT_TINY f32)."""
    cfg_j, cfg_t = jv.VIT_TINY, tv.VIT_TINY
    mesh = jpar.make_mesh(devices=jax.devices()[:1])
    jopt = jpar.default_optimizer(1e-3, warmup_steps=1, total_steps=10)
    jstate, state_sh = jpar.create_train_state(
        mesh, jax.random.PRNGKey(0), lambda r: jv.init_params(r, cfg_j), jopt,
        jv.param_specs(cfg_j))
    tree = jax.tree.map(np.asarray, jstate.params)
    jstep = jpar.make_train_step(partial(jv.loss_fn, config=cfg_j), jopt, mesh, state_sh,
                                 batch_ndim_extra=0)  # labels are (B,)
    topt = tpar.default_optimizer(1e-3, warmup_steps=1, total_steps=10)
    tstate = tpar.create_train_state(None, lambda _: params_from_numpy(tree, "cpu"), topt,
                                     device="cpu")
    tstep = tpar.make_train_step(lambda p, b: tv.loss_fn(p, b, cfg_t), topt)
    rng = np.random.default_rng(5)
    for i in range(3):
        images = rng.standard_normal((4, 32, 32, 3)).astype(np.float32)
        labels = rng.integers(0, 10, (4,)).astype(np.int32)
        jstate, jm = jstep(jstate, {"image": jnp.asarray(images), "label": jnp.asarray(labels)})
        tstate, tm = tstep(tstate, {"image": torch.from_numpy(images),
                                    "label": torch.from_numpy(labels)})
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=1e-5)
        np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]), rtol=1e-5)
        for t, j in zip(tpar.tree_leaves(tstate.params), jax.tree.leaves(jstate.params)):
            np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), atol=1e-5,
                                       err_msg=f"step {i}")
