"""Parity of the port's attention (ray_tpu_torch.ops.attention) with the
JAX package: the Pallas flash-attention kernel in interpret mode and the
blockwise reference, on the same numpy inputs, on the CPU.

Tolerance: atol 2e-5 in f32, as tests/test_pallas_attention.py holds the
Pallas kernel against the blockwise path (different block order of the
f32 sums); gradients atol/rtol 5e-5, the tolerance tests/
test_pallas_attention.py holds the Pallas gradients to."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.ops import attention as jattn
from ray_tpu.ops.pallas_attention import _bwd, _fwd, pallas_flash_attention
from ray_tpu_torch.ops import attention as tattn
from ray_tpu_torch.ops import cuda_attention

ATOL = 2e-5
GRAD_TOL = 5e-5


def _inputs(seed, B, S, T, H, KVH, hd=128):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(shape, dtype=np.float32)
                 for shape in ((B, S, H, hd), (B, T, KVH, hd), (B, T, KVH, hd)))


CASES = [
    # causal, kvh, S, T
    (True, 4, 256, 256),
    (True, 1, 256, 256),
    (False, 2, 256, 256),
    (False, 2, 128, 384),   # T != S (cross-attention shape)
    (True, 2, 128, 384),    # T != S, causal top-left aligned
]


@pytest.mark.parametrize("causal,kvh,S,T", CASES)
def test_flash_attention_matches_pallas(causal, kvh, S, T):
    q, k, v = _inputs(0, 2, S, T, 4, kvh)
    ref = pallas_flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                 causal, block_q=128, block_kv=128)
    out = tattn.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                                torch.from_numpy(v), causal=causal)
    assert out.shape == (2, S, 4, 128) and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL, rtol=ATOL)


@pytest.mark.parametrize("causal,kvh,S,T", CASES)
def test_lse_matches_pallas_lane0(causal, kvh, S, T):
    """lse (B,H,S) against lane 0 of the TPU kernel's (B,H,S,128) lse."""
    q, k, v = _inputs(1, 2, S, T, 4, kvh)
    tr = lambda a: jnp.asarray(a).transpose(0, 2, 1, 3)  # noqa: E731
    _, ref_lse = _fwd(tr(q), tr(k), tr(v), causal, 128, 128)
    _, lse = cuda_attention.flash_attention_plain(torch.from_numpy(q), torch.from_numpy(k),
                                         torch.from_numpy(v), causal=causal)
    np.testing.assert_allclose(lse.numpy(), np.asarray(ref_lse)[..., 0],
                               atol=ATOL, rtol=ATOL)


def test_matches_blockwise_reference_and_small_blocks():
    q, k, v = _inputs(2, 1, 256, 256, 4, 2)
    ref = jattn.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                causal=True, block_q=64, block_kv=64)
    out, _ = cuda_attention.flash_attention_plain(torch.from_numpy(q), torch.from_numpy(k),
                                         torch.from_numpy(v), causal=True,
                                         block_q=64, block_kv=64)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL, rtol=ATOL)


@pytest.mark.parametrize("causal", [True, False])
def test_reference_block_keywords(causal):
    """The reference's call flash_attention(q, k, v, causal=..., block_q=16,
    block_kv=16) works in the port: the plain path walks 16-row blocks,
    forward and backward, and agrees with the reference's blockwise path
    and with the port at its default blocks."""
    q, k, v = _inputs(4, 2, 64, 64, 4, 2, hd=32)
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    ref = jattn.flash_attention(jq, jk, jv, causal=causal, block_q=16, block_kv=16)
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    out = tattn.flash_attention(tq, tk, tv, causal=causal, block_q=16, block_kv=16)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), atol=ATOL, rtol=ATOL)
    wide = tattn.flash_attention(*(torch.from_numpy(a) for a in (q, k, v)), causal=causal)
    np.testing.assert_allclose(out.detach().numpy(), wide.numpy(), atol=ATOL, rtol=ATOL)
    do = np.random.default_rng(5).standard_normal(q.shape).astype(np.float32)
    jg = jax.vjp(lambda a, b, c: jattn.flash_attention(a, b, c, causal=causal, block_q=16,
                                                       block_kv=16), jq, jk, jv)[1](
        jnp.asarray(do))
    tg = torch.autograd.grad(out, (tq, tk, tv), torch.from_numpy(do))
    for a, b in zip(tg, jg):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=GRAD_TOL, rtol=GRAD_TOL)
    with pytest.raises(ValueError, match="positive"):
        tattn.flash_attention(tq, tk, tv, block_q=0)


def test_blockwise_accum_masked_block_is_noop():
    """A kv span that starts after some query rows (ring-attention style
    offsets): those rows see a fully masked block first, which must leave
    their state exactly empty (zeroed probabilities, -inf carried)."""
    B, S, KVH, G, hd = 1, 128, 2, 2, 128
    q, k, v = _inputs(3, B, S, S, KVH * G, KVH)
    qg = q.reshape(B, S, KVH, G, hd)
    kw = dict(causal=True, block_q=64, block_kv=64, q_offset=0, kv_offset=64)
    jstate = jattn._blockwise_accum(
        jnp.asarray(qg), jnp.asarray(k), jnp.asarray(v),
        *jattn.init_attention_state(B, S, KVH, G, hd), **kw)
    tstate = tattn._blockwise_accum(
        torch.from_numpy(qg), torch.from_numpy(k), torch.from_numpy(v),
        *tattn.init_attention_state(B, S, KVH, G, hd), **kw)
    acc, m, l = (t.numpy() for t in tstate)
    assert np.all(acc[:, :64] == 0.0) and np.all(l[:, :64] == 0.0)
    for a, b in zip(tstate, jstate):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=ATOL, rtol=ATOL)
    np.testing.assert_allclose(
        tattn.finalize_attention_state(*tstate[::2]).numpy(),
        np.asarray(jattn.finalize_attention_state(jstate[0], jstate[2])),
        atol=ATOL)


@pytest.mark.parametrize("causal,kvh,S,T", CASES)
def test_grads_match_pallas(causal, kvh, S, T):
    """torch autograd through flash_attention (the plain backward on the
    CPU) against jax.grad through the Pallas kernels in interpret mode,
    with the loss sum(o * cos(o)) of tests/test_pallas_attention.py."""
    q, k, v = _inputs(6, 2, S, T, 4, kvh)

    def loss_pallas(q, k, v):
        o = pallas_flash_attention(q, k, v, causal, block_q=128, block_kv=128)
        return jnp.sum(o * jnp.cos(o))

    ref = jax.grad(loss_pallas, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    o = tattn.flash_attention(tq, tk, tv, causal=causal)
    (o * torch.cos(o)).sum().backward()
    for name, ours, theirs in zip("qkv", (tq, tk, tv), ref):
        np.testing.assert_allclose(ours.grad.numpy(), np.asarray(theirs),
                                   atol=GRAD_TOL, rtol=GRAD_TOL, err_msg=f"d{name}")


@pytest.mark.parametrize("causal,kvh,S,T", [CASES[0], CASES[3], CASES[4]])
def test_bwd_plain_matches_pallas_bwd(causal, kvh, S, T):
    """The kernels' plain versions against the Pallas backward ``_bwd``,
    given the same o, lse (lane 0 of the TPU layout) and dO."""
    q, k, v = _inputs(7, 2, S, T, 4, kvh)
    do = np.random.default_rng(8).standard_normal(q.shape, dtype=np.float32)
    tr = lambda a: jnp.asarray(a).transpose(0, 2, 1, 3)  # noqa: E731
    o, lse = _fwd(tr(q), tr(k), tr(v), causal, 128, 128)
    ref = _bwd(tr(q), tr(k), tr(v), o, lse, tr(do), causal, 128, 128)
    ours = cuda_attention.flash_attention_bwd_plain(
        *map(torch.from_numpy, (q, k, v)),
        torch.from_numpy(np.array(o).transpose(0, 2, 1, 3)),
        torch.from_numpy(np.array(lse)[..., 0]), torch.from_numpy(do), causal=causal)
    for name, a, b in zip(("dq", "dk", "dv"), ours, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b).transpose(0, 2, 1, 3),
                                   atol=GRAD_TOL, rtol=GRAD_TOL, err_msg=name)


@pytest.mark.parametrize("causal,S,T,kvh", [(True, 100, 300, 2), (True, 300, 100, 1),
                                            (False, 130, 77, 2)])
def test_bwd_plain_ragged_matches_autograd(causal, S, T, kvh):
    """At ragged S != T (which the Pallas kernels do not take), the plain
    backward against autograd through the plain forward, at small blocks."""
    q, k, v = (torch.from_numpy(a).requires_grad_() for a in _inputs(9, 1, S, T, 4, kvh, hd=64))
    o, lse = cuda_attention.flash_attention_plain(q, k, v, causal=causal, block_q=64,
                                                  block_kv=64)
    do = torch.from_numpy(np.random.default_rng(10).standard_normal(o.shape, dtype=np.float32))
    ref = torch.autograd.grad(o, (q, k, v), do)
    ours = cuda_attention.flash_attention_bwd_plain(q.detach(), k.detach(), v.detach(),
                                                    o.detach(), lse.detach(), do,
                                                    causal=causal, block_q=64, block_kv=48)
    for name, a, b in zip(("dq", "dk", "dv"), ours, ref):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-5, rtol=1e-5, err_msg=name)


def test_rejects_bad_gqa_split():
    q, k, v = (torch.from_numpy(a) for a in _inputs(5, 1, 64, 64, 3, 2))
    with pytest.raises(ValueError):
        tattn.flash_attention(q, k, v)


def test_kernel_wrapper_refuses_cpu_tensors():
    q = torch.zeros(1, 64, 2, 128, dtype=torch.bfloat16)
    lse = torch.zeros(1, 2, 64)
    with pytest.raises(ValueError, match="CUDA"):
        cuda_attention.flash_attention_fwd(q, q, q)
    with pytest.raises(ValueError, match="CUDA"):
        cuda_attention.flash_attention_bwd(q, q, q, q, lse, q)
    with pytest.raises(ValueError, match="CUDA"):
        cuda_attention.flash_attention_bwd_dq(q, q, q, q, lse, lse)
