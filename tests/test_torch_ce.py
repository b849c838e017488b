"""Parity of the port's fused lm-head cross-entropy
(ray_tpu_torch.ops.cuda_ce) with ray_tpu/ops/pallas_ce.py, in the cases of
tests/test_pallas_ce.py, on the same numpy inputs, on the CPU (the Pallas
kernel in interpret mode, the port through its plain version).

Tolerance: atol 1e-5 in f32 (the two sides sum the same f32 logits in a
different order), for the losses and for the gradients."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.ops.pallas_ce import _bwd_call, _fwd_call
from ray_tpu.ops.pallas_ce import fused_cross_entropy as jax_fused
from ray_tpu.ops.pallas_ce import xla_cross_entropy as jax_xla
from ray_tpu_torch.ops import cuda_ce

ATOL = 1e-5


def _problem(seed, N, D, V, lo=0, hi=None):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((N, D), dtype=np.float32) * 0.5
    w = rng.standard_normal((D, V), dtype=np.float32) * 0.05
    t = rng.integers(lo, V if hi is None else hi, (N,)).astype(np.int32)
    return x, w, t


@pytest.mark.parametrize("N,D,V", [(256, 128, 1024), (128, 64, 384)])
def test_forward_matches_pallas_and_xla(N, D, V):
    x, w, t = _problem(0, N, D, V)
    ours = cuda_ce.fused_cross_entropy(*map(torch.from_numpy, (x, w, t)))
    assert ours.shape == (N,) and ours.dtype == torch.float32
    jx, jw, jt = map(jnp.asarray, (x, w, t))
    np.testing.assert_allclose(ours.numpy(), np.asarray(jax_fused(jx, jw, jt)), atol=ATOL)
    np.testing.assert_allclose(ours.numpy(), np.asarray(jax_xla(jx, jw, jt)), atol=ATOL)
    plain_xla = cuda_ce.xla_cross_entropy(*map(torch.from_numpy, (x, w, t)))
    np.testing.assert_allclose(plain_xla.numpy(), np.asarray(jax_xla(jx, jw, jt)), atol=ATOL)


def test_plain_kernel_outputs_match_pallas_fwd_call():
    """The kernel's plain version returns the Pallas kernel's (lse, tgt)."""
    x, w, t = _problem(1, 256, 128, 1024)
    lse, tgt = cuda_ce.fused_ce_fwd_plain(*map(torch.from_numpy, (x, w, t)))
    jl, jt = _fwd_call(jnp.asarray(x), jnp.asarray(w), jnp.asarray(t), 128, 512)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jl), atol=ATOL)
    np.testing.assert_allclose(tgt.numpy(), np.asarray(jt), atol=ATOL)


def test_out_of_range_targets_are_clamped():
    x, w, t = _problem(2, 256, 128, 1024, lo=-40, hi=1064)
    assert (t < 0).any() and (t >= 1024).any()
    ours = cuda_ce.fused_cross_entropy(*map(torch.from_numpy, (x, w, t)))
    jx, jw = jnp.asarray(x), jnp.asarray(w)
    np.testing.assert_allclose(ours.numpy(), np.asarray(jax_fused(jx, jw, jnp.asarray(t))),
                               atol=ATOL)
    clipped = jnp.asarray(np.clip(t, 0, 1023))
    np.testing.assert_allclose(ours.numpy(), np.asarray(jax_xla(jx, jw, clipped)), atol=ATOL)


def _weights(seed, N):
    return np.random.default_rng(seed).uniform(0.5, 1.5, N).astype(np.float32) / N


def _torch_grads(x, w, t, wt):
    tx, tw = torch.from_numpy(x).requires_grad_(), torch.from_numpy(w).requires_grad_()
    (cuda_ce.fused_cross_entropy(tx, tw, torch.from_numpy(t)) * torch.from_numpy(wt)).sum().backward()
    return tx.grad.numpy(), tw.grad.numpy()


@pytest.mark.parametrize("N,D,V", [(256, 128, 1024), (128, 64, 384)])
def test_grads_match_pallas_and_xla(N, D, V):
    """torch autograd through fused_cross_entropy (the plain backward on
    the CPU) against jax.grad of the Pallas path (interpret mode) and of
    xla_cross_entropy, for a per-row weighted sum of the losses."""
    x, w, t = _problem(3, N, D, V)
    wt = _weights(4, N)
    gx, gw = _torch_grads(x, w, t, wt)
    jx, jw, jt, jwt = map(jnp.asarray, (x, w, t, wt))
    for fn in (jax_fused, jax_xla):
        rx, rw = jax.grad(lambda a, b: jnp.sum(fn(a, b, jt) * jwt), argnums=(0, 1))(jx, jw)
        np.testing.assert_allclose(gx, np.asarray(rx), atol=ATOL)
        np.testing.assert_allclose(gw, np.asarray(rw), atol=ATOL)


def test_plain_bwd_matches_pallas_bwd_call():
    """The kernels' plain versions return the Pallas backward's (dx, dW)
    from the same lse and per-row g."""
    x, w, t = _problem(5, 256, 128, 1024)
    g = _weights(6, 256)
    jl, _ = _fwd_call(jnp.asarray(x), jnp.asarray(w), jnp.asarray(t), 128, 512)
    rx, rw = _bwd_call(jnp.asarray(x), jnp.asarray(w), jnp.asarray(t), jl, jnp.asarray(g),
                       128, 512)
    dx, dw = cuda_ce.fused_ce_bwd_plain(*map(torch.from_numpy, (x, w, t)),
                                        torch.from_numpy(np.array(jl)), torch.from_numpy(g))
    np.testing.assert_allclose(dx.numpy(), np.asarray(rx), atol=ATOL)
    np.testing.assert_allclose(dw.numpy(), np.asarray(rw), atol=ATOL)


def test_grads_with_out_of_range_targets_are_clamped():
    x, w, t = _problem(7, 256, 128, 1024, lo=-40, hi=1064)
    assert (t < 0).any() and (t >= 1024).any()
    wt = _weights(8, 256)
    gx, gw = _torch_grads(x, w, t, wt)
    jx, jw, jwt = jnp.asarray(x), jnp.asarray(w), jnp.asarray(wt)
    for fn, jt in ((jax_fused, jnp.asarray(t)), (jax_xla, jnp.asarray(np.clip(t, 0, 1023)))):
        rx, rw = jax.grad(lambda a, b: jnp.sum(fn(a, b, jt) * jwt), argnums=(0, 1))(jx, jw)
        np.testing.assert_allclose(gx, np.asarray(rx), atol=ATOL)
        np.testing.assert_allclose(gw, np.asarray(rw), atol=ATOL)


def test_kernel_wrapper_refuses_cpu_tensors():
    x, w, t = _problem(4, 128, 64, 256)
    with pytest.raises(ValueError, match="CUDA"):
        cuda_ce.fused_ce_fwd(*map(torch.from_numpy, (x, w, t)))
    g = torch.zeros(128)
    for fn in (cuda_ce.fused_ce_bwd, cuda_ce.fused_ce_bwd_dx, cuda_ce.fused_ce_bwd_dw):
        with pytest.raises(ValueError, match="CUDA"):
            fn(*map(torch.from_numpy, (x, w, t)), g, g)
