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


@pytest.mark.parametrize("blocks", [(128, 512), (64, 128), (100, 300)])
def test_reference_block_arguments(blocks):
    """fused_cross_entropy(x, w, t, block_n, block_v), positional as in the
    reference: the plain forward walks those blocks (an online logsumexp
    over the vocab blocks, ragged ones included) and agrees with the
    Pallas kernel at the reference's own blocks and with the one-piece
    plain version; the gradients are unchanged."""
    x, w, t = _problem(5, 256, 128, 1024)
    tx, tw = torch.from_numpy(x).requires_grad_(), torch.from_numpy(w).requires_grad_()
    tt = torch.from_numpy(t)
    ours = cuda_ce.fused_cross_entropy(tx, tw, tt, *blocks)
    jx, jw, jt = map(jnp.asarray, (x, w, t))
    np.testing.assert_allclose(ours.detach().numpy(), np.asarray(jax_fused(jx, jw, jt, 128, 512)),
                               atol=ATOL)
    whole = cuda_ce.fused_cross_entropy(*map(torch.from_numpy, (x, w, t)))
    np.testing.assert_allclose(ours.detach().numpy(), whole.numpy(), atol=ATOL)
    wt = np.random.default_rng(6).random(256).astype(np.float32)
    g = torch.autograd.grad(ours, (tx, tw), torch.from_numpy(wt))
    jg = jax.grad(lambda a, b: jnp.sum(jax_fused(a, b, jt) * jnp.asarray(wt)), (0, 1))(jx, jw)
    for a, b in zip(g, jg):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=ATOL)
    with pytest.raises(ValueError, match="positive"):
        cuda_ce.fused_cross_entropy(tx, tw, tt, 0, 512)


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
    """Each kernel wrapper raises for CPU tensors; fused_ce_bwd, the chunk
    loop, takes the plain versions for them instead."""
    x, w, t = _problem(4, 128, 64, 256)
    tx, tw, tt = map(torch.from_numpy, (x, w, t))
    with pytest.raises(ValueError, match="CUDA"):
        cuda_ce.fused_ce_fwd(tx, tw, tt)
    g = torch.zeros(128)
    dlog = torch.zeros(128, 256)
    for fn, args in ((cuda_ce.fused_ce_bwd_dlog, (tx, tw, tt, g, g)),
                     (cuda_ce.fused_ce_bwd_dx, (dlog, tw)),
                     (cuda_ce.fused_ce_bwd_dw, (tx, dlog))):
        with pytest.raises(ValueError, match="CUDA"):
            fn(*args)
    dx, dw = cuda_ce.fused_ce_bwd(tx, tw, tt, g, g)
    rx, rw = cuda_ce.fused_ce_bwd_plain(tx, tw, tt, g, g)
    assert torch.equal(dx, rx) and torch.equal(dw, rw)


# N 640 in f32: 640-, 384- and 256-row chunks give 1 chunk, 2 (384 + a
# ragged 256) and 3 (256 + 256 + a ragged 128).
CHUNKS = [(640, 1), (384, 2), (256, 3)]


def _budget(rows, V, itemsize=4):
    return rows * V * itemsize


@pytest.mark.parametrize("rows,n_chunks", CHUNKS)
def test_chunked_bwd_matches_pallas_bwd_call(monkeypatch, rows, n_chunks):
    """fused_ce_bwd on CPU tensors (the chunk loop over the plain versions)
    against the Pallas backward, with the dlog budget cut to force 1, 2 and
    3 chunks of rows."""
    N, D, V = 640, 128, 1024
    monkeypatch.setattr(cuda_ce, "_DLOG_BUDGET", _budget(rows, V))
    assert cuda_ce.chunk_rows(N, V, 4) == min(rows, N)
    assert -(-N // cuda_ce.chunk_rows(N, V, 4)) == n_chunks
    x, w, t = _problem(9, N, D, V)
    g = _weights(10, N)
    jl, _ = _fwd_call(jnp.asarray(x), jnp.asarray(w), jnp.asarray(t), 128, 512)
    rx, rw = _bwd_call(jnp.asarray(x), jnp.asarray(w), jnp.asarray(t), jl, jnp.asarray(g),
                       128, 512)
    dx, dw = cuda_ce.fused_ce_bwd(*map(torch.from_numpy, (x, w, t)),
                                  torch.from_numpy(np.array(jl)), torch.from_numpy(g))
    np.testing.assert_allclose(dx.numpy(), np.asarray(rx), atol=ATOL)
    np.testing.assert_allclose(dw.numpy(), np.asarray(rw), atol=ATOL)


@pytest.mark.parametrize("rows,n_chunks", CHUNKS)
def test_chunked_grads_match_pallas(monkeypatch, rows, n_chunks):
    """torch autograd through fused_cross_entropy with the chunked backward
    against jax.grad of the Pallas path (interpret mode)."""
    N, D, V = 640, 128, 1024
    monkeypatch.setattr(cuda_ce, "_DLOG_BUDGET", _budget(rows, V))
    x, w, t = _problem(11, N, D, V)
    wt = _weights(12, N)
    gx, gw = _torch_grads(x, w, t, wt)
    jx, jw, jt, jwt = map(jnp.asarray, (x, w, t, wt))
    rx, rw = jax.grad(lambda a, b: jnp.sum(jax_fused(a, b, jt) * jwt), argnums=(0, 1))(jx, jw)
    np.testing.assert_allclose(gx, np.asarray(rx), atol=ATOL)
    np.testing.assert_allclose(gw, np.asarray(rw), atol=ATOL)


@pytest.mark.parametrize("x_dtype,w_dtype", [("bfloat16", "float32"), ("float32", "bfloat16")])
@pytest.mark.parametrize("rows", [640, 256])
def test_mixed_dtype_chunked_bwd_matches_pallas_bwd_call(monkeypatch, x_dtype, w_dtype, rows):
    """x and w of different dtypes (1 chunk, and 3 with a ragged last one):
    dlog is rounded to w's dtype for dx and to x's for dW, dx comes back in
    x's dtype and dW in w's, as in the Pallas backward."""
    N, D, V = 640, 128, 1024
    monkeypatch.setattr(cuda_ce, "_DLOG_BUDGET", _budget(rows, V))
    x, w, t = _problem(15, N, D, V)
    g = _weights(16, N)
    jx, jw = jnp.asarray(x).astype(x_dtype), jnp.asarray(w).astype(w_dtype)
    jl, _ = _fwd_call(jx, jw, jnp.asarray(t), 128, 512)
    rx, rw = _bwd_call(jx, jw, jnp.asarray(t), jl, jnp.asarray(g), 128, 512)
    tx = torch.from_numpy(np.asarray(jx, np.float32)).to(getattr(torch, x_dtype))
    tw = torch.from_numpy(np.asarray(jw, np.float32)).to(getattr(torch, w_dtype))
    dx, dw = cuda_ce.fused_ce_bwd(tx, tw, torch.from_numpy(t), torch.from_numpy(np.array(jl)),
                                  torch.from_numpy(g))
    assert dx.dtype == tx.dtype and dw.dtype == tw.dtype
    # a bf16 output may round an f32 sum taken in another order to the
    # neighbouring bf16 value: one ulp, 2^-7 of it
    for ours, ref in ((dx, rx), (dw, rw)):
        rtol = 2.0**-7 if ours.dtype == torch.bfloat16 else 0.0
        np.testing.assert_allclose(ours.float().numpy(), np.asarray(ref, np.float32),
                                   atol=ATOL, rtol=rtol)


def test_plain_pieces_compose_to_the_whole_backward():
    """dlog, then dx and dW from it, over two chunks with the f32 sum
    carried between them, equal the one-piece plain backward."""
    x, w, t = map(torch.from_numpy, _problem(13, 256, 64, 384))
    g = torch.from_numpy(_weights(14, 256))
    lse, _ = cuda_ce.fused_ce_fwd_plain(x, w, t)
    rx, rw = cuda_ce.fused_ce_bwd_plain(x, w, t, lse, g)
    acc, dxs = None, []
    for r0, r1 in ((0, 128), (128, 256)):
        dlog = cuda_ce.fused_ce_bwd_dlog_plain(x[r0:r1], w, t[r0:r1], lse[r0:r1], g[r0:r1])
        assert dlog.shape == (r1 - r0, 384) and dlog.dtype == x.dtype
        dxs.append(cuda_ce.fused_ce_bwd_dx_plain(dlog, w))
        acc = cuda_ce.fused_ce_bwd_dw_plain(x[r0:r1], dlog, acc, last=r1 == 256)
        assert acc.dtype == torch.float32
    np.testing.assert_allclose(torch.cat(dxs).numpy(), rx.numpy(), atol=ATOL)
    np.testing.assert_allclose(acc.numpy(), rw.numpy(), atol=ATOL)


def test_chunk_rows_at_the_training_shape():
    """N 16384, V 32000 in bf16 under the 256 MiB budget: 4 chunks of 4096
    rows, each dlog chunk within the budget; tiny budgets still make
    128-row chunks, and a short N is one chunk."""
    rows = cuda_ce.chunk_rows(16384, 32000, 2)
    assert rows == 4096 and rows * 32000 * 2 <= cuda_ce._DLOG_BUDGET
    assert (rows + 128) * 32000 * 2 > cuda_ce._DLOG_BUDGET
    assert cuda_ce.chunk_rows(16384, 10**9, 2) == 128
    assert cuda_ce.chunk_rows(300, 1024, 2) == 300
