"""Memory-efficient attention (flash-attention algorithm), PyTorch port of
``ray_tpu/ops/attention.py``.

``flash_attention`` keeps the JAX layout: q (B, S, H, hd), k/v
(B, T, KVH, hd), GQA with query head h reading kv head h // (H // KVH),
causal masking top-left aligned (query i sees kv j <= i). Dispatch is by
the device of the tensors and nothing else:

- a CUDA tensor goes to the hand-written Hopper kernel
  (``ops/cuda_attention.py``), or the call raises;
- a CPU tensor goes to the kernel's plain version
  (``cuda_attention.flash_attention_plain``), built from the blockwise
  online-softmax steps below: ports of ``_blockwise_accum``,
  ``init_attention_state`` and ``finalize_attention_state``, which the
  ring attention of a later slice reuses.

The backward follows the same rule: the dK/dV and dQ kernels for a CUDA
tensor, their plain versions for a CPU tensor.

The JAX dispatch falls back to the blockwise path when the kernel raises
``NotImplementedError``; the port has no such fallback.
"""

from __future__ import annotations

import math
import torch

_NEG_INF = -1e30


def _blockwise_accum(q, k, v, acc, m, l, *, causal: bool, block_q: int,
                     block_kv: int, q_offset: int = 0, kv_offset: int = 0):
    """Accumulate attention of q against one K/V span into running
    online-softmax state. Shapes: q (B, Sq, KVH, G, hd), k/v
    (B, Skv, KVH, hd); acc (B, Sq, KVH, G, hd) f32, m/l (B, Sq, KVH, G)
    f32. Returns updated (acc, m, l); the inputs are not modified.

    Products take f32 inputs (the JAX einsums ask for f32 results, which
    bf16 inputs give exactly). Fully masked blocks are exact no-ops:
    masked probabilities are zeroed explicitly, since exp(-big) does not
    underflow when a block is masked before any visible block has set a
    finite running max. The last block of a ragged length is shorter.
    """
    Sq, Skv = q.shape[1], k.shape[1]
    scale = 1.0 / math.sqrt(q.shape[-1])
    dev = q.device
    accs, ms, ls = [], [], []
    for qs in range(0, Sq, block_q):
        qe = min(qs + block_q, Sq)
        q_blk = q[:, qs:qe].float()
        a, mm, ll = acc[:, qs:qe], m[:, qs:qe], l[:, qs:qe]
        q_pos = q_offset + torch.arange(qs, qe, device=dev)
        for ks in range(0, Skv, block_kv):
            ke = min(ks + block_kv, Skv)
            k_blk, v_blk = k[:, ks:ke], v[:, ks:ke]
            logits = torch.einsum("bqkgh,btkh->bqkgt", q_blk, k_blk.float()) * scale
            if causal:
                kv_pos = kv_offset + torch.arange(ks, ke, device=dev)
                mask = (q_pos[:, None] >= kv_pos[None, :])[None, :, None, None, :]
                logits = torch.where(mask, logits, _NEG_INF)
            m_new = torch.maximum(mm, logits.amax(dim=-1))
            m_safe = torch.where(torch.isfinite(m_new), m_new, 0.0)
            p = torch.exp(logits - m_safe[..., None])
            if causal:
                p = torch.where(mask, p, 0.0)
            corr = torch.where(torch.isfinite(mm), torch.exp(mm - m_safe), 0.0)
            ll = ll * corr + p.sum(dim=-1)
            pv = torch.einsum("bqkgt,btkh->bqkgh", p.to(v_blk.dtype).float(),
                              v_blk.float())
            a = a * corr[..., None] + pv
            mm = m_new
        accs.append(a)
        ms.append(mm)
        ls.append(ll)
    return torch.cat(accs, 1), torch.cat(ms, 1), torch.cat(ls, 1)


def init_attention_state(B, Sq, KVH, G, hd, device=None):
    return (
        torch.zeros((B, Sq, KVH, G, hd), dtype=torch.float32, device=device),
        torch.full((B, Sq, KVH, G), -math.inf, dtype=torch.float32, device=device),
        torch.zeros((B, Sq, KVH, G), dtype=torch.float32, device=device),
    )


def finalize_attention_state(acc, l):
    return acc / torch.clamp(l, min=1e-30)[..., None]


class _FlashAttention(torch.autograd.Function):
    """Forward and FlashAttention-2 backward; the residuals are those of
    ``pallas_attention.py`` ``_flash_fwd`` (:407): q, k, v, o and lse."""

    @staticmethod
    def forward(ctx, q, k, v, causal, block_q, block_kv):
        from .cuda_attention import flash_attention_fwd, flash_attention_plain

        if q.device.type == "cuda":
            o, lse = flash_attention_fwd(q, k, v, causal=causal)
        elif q.device.type == "cpu":
            o, lse = flash_attention_plain(q, k, v, causal=causal, block_q=block_q,
                                           block_kv=block_kv)
        else:
            raise ValueError(f"flash_attention: unsupported device {q.device}")
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.blocks = causal, dict(block_q=block_q, block_kv=block_kv)
        return o

    @staticmethod
    def backward(ctx, do):
        from .cuda_attention import flash_attention_bwd, flash_attention_bwd_plain

        q, k, v, o, lse = ctx.saved_tensors
        if do.device.type == "cuda":
            # the kernels read dO through strides but need its last dim
            # contiguous; autograd may hand over any layout
            if do.stride(-1) != 1:
                do = do.contiguous()
            dq, dk, dv = flash_attention_bwd(q, k, v, o, lse, do, causal=ctx.causal)
        elif do.device.type == "cpu":
            dq, dk, dv = flash_attention_bwd_plain(q, k, v, o, lse, do, causal=ctx.causal,
                                                   **ctx.blocks)
        else:
            raise ValueError(f"flash_attention: unsupported device {do.device}")
        return dq, dk, dv, None, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, block_q: int = 512,
                    block_kv: int = 512) -> torch.Tensor:
    """q (B, S, H, hd); k/v (B, T, KVH, hd) -> (B, S, H, hd) in q's dtype.

    ``block_q`` and ``block_kv`` are the reference's block sizes. The plain
    version (CPU tensors) walks q and k/v in blocks of those sizes, forward
    and backward; the kernels (CUDA tensors) keep their own tiles (128 query
    rows a CTA, 64 or 128 rows a streamed tile; see the ``csrc`` headers)
    and ignore them."""
    H, KVH = q.shape[2], k.shape[2]
    if H % KVH != 0:
        raise ValueError(f"n_heads {H} not divisible by n_kv_heads {KVH}")
    if block_q < 1 or block_kv < 1:
        raise ValueError(f"block sizes must be positive, got {block_q}, {block_kv}")
    return _FlashAttention.apply(q, k, v, causal, block_q, block_kv)
