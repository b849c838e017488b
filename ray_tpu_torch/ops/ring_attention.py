"""Ring attention: sequence parallelism over the ``seq`` mesh axis, the
port of ``ray_tpu/ops/ring_attention.py``.

Q, K and V hold this rank's block of the sequence. Each of the axis's n
ranks attends its Q block to the K/V block it holds, then passes K/V one
hop round the ring (``parallel/comm.py`` ``RingShift``: every rank posts
its send and receive at once, as ``lax.ppermute``; the hop is posted
before the block's compute and waited after it). After n hops every Q
block has seen the whole sequence.

The hop plan (causal): rank r at hop i holds the K/V block of rank
(r - i) mod n. A past block is attended in full, the diagonal block (i = 0)
causally, and a future block is skipped: it would contribute nothing. So
rank r attends r + 1 blocks (one causal, r full); without causality every
block, in full.

On the card each hop runs the port's kernels on the block it holds: the
flash forward (K1, non-causal on a past block, causal on the diagonal),
whose o and lse are merged across hops by their lse in f32. The backward
runs the dK/dV and dQ kernels (K2, K3) per hop with the merged lse and
``attention_delta`` of the merged output, as flash attention's backward
does on one device; the dK/dV of a block travel round with it and are
home after the n-th hop. The kernels take contiguous bf16 blocks: what a
hop receives is a fresh buffer, and the caller's q, k, v must already be
(the models' are).

On the CPU the forward is the port's ``_blockwise_accum`` with
``q_offset``/``kv_offset`` (what the JAX ring computes), its running
(acc, m, l) carried across hops, and the backward the kernels' plain
versions on the same hop plan.
"""

from __future__ import annotations

import functools

import torch
from torch.distributed.device_mesh import DeviceMesh

from ..parallel import comm
from ..parallel.mesh import axis_index, get_mesh, mesh_axis_size
from .attention import _blockwise_accum, finalize_attention_state, init_attention_state


def _hops(idx: int, n: int, causal: bool):
    """(hop, kv block index, causal) of each hop that attends, in order."""
    for i in range(n):
        kv = (idx - i) % n
        if causal and kv > idx:
            continue
        yield i, kv, causal and kv == idx


class _RingAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, mesh, axis, causal, block_q, block_kv):
        n, idx = mesh_axis_size(mesh, axis), axis_index(mesh, axis)
        B, Sq, H, hd = q.shape
        KVH = k.shape[2]
        cuda = q.device.type == "cuda"
        attend = {i: (kv, c) for i, kv, c in _hops(idx, n, causal)}
        if cuda:
            from .cuda_attention import flash_attention_fwd
            o_acc = lse_acc = None
        else:
            qg = q.reshape(B, Sq, KVH, H // KVH, hd)
            acc, m, l = init_attention_state(B, Sq, KVH, H // KVH, hd, device=q.device)
        k_cur, v_cur = k, v
        for i in range(n):
            shift = comm.RingShift(mesh, axis, (k_cur, v_cur)) if i < n - 1 else None
            if i in attend:
                kv, hop_causal = attend[i]
                if cuda:
                    o_i, lse_i = flash_attention_fwd(q, k_cur, v_cur, causal=hop_causal)
                    if o_acc is None:
                        o_acc, lse_acc = o_i.float(), lse_i
                    else:
                        lse_new = torch.logaddexp(lse_acc, lse_i)
                        w_old = torch.exp(lse_acc - lse_new).transpose(1, 2)[..., None]
                        w_new = torch.exp(lse_i - lse_new).transpose(1, 2)[..., None]
                        o_acc = o_acc * w_old + o_i.float() * w_new
                        lse_acc = lse_new
                else:
                    acc, m, l = _blockwise_accum(
                        qg, k_cur, v_cur, acc, m, l, causal=causal, block_q=block_q,
                        block_kv=block_kv, q_offset=idx * Sq, kv_offset=kv * k_cur.shape[1])
            if shift is not None:
                k_cur, v_cur = shift.wait()
        if cuda:
            o, lse = o_acc.to(q.dtype), lse_acc.contiguous()
        else:
            o = finalize_attention_state(acc, l).reshape(B, Sq, H, hd).to(q.dtype)
            lse = (m + torch.log(torch.clamp(l, min=1e-30))).reshape(B, Sq, H)
            lse = lse.permute(0, 2, 1).contiguous()
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.mesh, ctx.axis, ctx.causal = mesh, axis, causal
        ctx.blocks = dict(block_q=block_q, block_kv=block_kv)
        return o

    @staticmethod
    def backward(ctx, do):
        from .cuda_attention import attention_delta

        q, k, v, o, lse = ctx.saved_tensors
        mesh, axis = ctx.mesh, ctx.axis
        n, idx = mesh_axis_size(mesh, axis), axis_index(mesh, axis)
        cuda = do.device.type == "cuda"
        if cuda:
            from .cuda_attention import flash_attention_bwd_dkv, flash_attention_bwd_dq
            if do.stride(-1) != 1:
                do = do.contiguous()
            kw = {}
        else:
            from .cuda_attention import (
                flash_attention_bwd_dkv_plain as flash_attention_bwd_dkv,
                flash_attention_bwd_dq_plain as flash_attention_bwd_dq,
            )
            kw = ctx.blocks
        delta = attention_delta(o, do)
        attend = {i: c for i, _, c in _hops(idx, n, ctx.causal)}
        dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
        k_cur, v_cur = k, v
        dk_cur = torch.zeros(k.shape, dtype=torch.float32, device=k.device)
        dv_cur = torch.zeros_like(dk_cur)
        for i in range(n):
            # the K/V block moves on once its hop is posted; its dK/dV after
            # this hop's products are added
            kv_shift = comm.RingShift(mesh, axis, (k_cur, v_cur)) if i < n - 1 else None
            if i in attend:
                hop_causal = attend[i]
                dk_i, dv_i = flash_attention_bwd_dkv(q, k_cur, v_cur, do, lse, delta,
                                                     causal=hop_causal, **kw)
                dq += flash_attention_bwd_dq(q, k_cur, v_cur, do, lse, delta,
                                             causal=hop_causal, **kw).float()
                dk_cur += dk_i.float()
                dv_cur += dv_i.float()
            dkv_shift = comm.RingShift(mesh, axis, (dk_cur, dv_cur))
            if kv_shift is not None:
                k_cur, v_cur = kv_shift.wait()
            dk_cur, dv_cur = dkv_shift.wait()
        return (dq.to(q.dtype), dk_cur.to(k.dtype), dv_cur.to(v.dtype),
                None, None, None, None, None)


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                   mesh: DeviceMesh = None, axis_name: str = "seq", causal: bool = True,
                   block_q: int = 512, block_kv: int = 512) -> torch.Tensor:
    """This rank's block of ring attention: q (B, S_local, H, hd), k/v
    (B, S_local, KVH, hd), the blocks in axis order along the sequence ->
    (B, S_local, H, hd). ``mesh`` defaults to the ambient one. Every rank
    of the axis calls it. ``block_q``/``block_kv`` are the plain version's
    blocks (the CPU); the kernels keep their own tiles."""
    mesh = mesh if mesh is not None else get_mesh()
    if mesh is None:
        raise ValueError("ring_attention needs a mesh (pass one, or set_mesh)")
    if q.shape[2] % k.shape[2] != 0:
        raise ValueError(f"n_heads {q.shape[2]} not divisible by n_kv_heads {k.shape[2]}")
    return _RingAttention.apply(q, k, v, mesh, axis_name, causal, block_q, block_kv)


class _Split(torch.autograd.Function):
    """Replicated tensor -> this rank's block of ``dim`` (backward: the
    blocks gathered, so each rank's gradient is the whole one)."""

    @staticmethod
    def forward(ctx, x, mesh, axis, dim):
        ctx.mesh, ctx.axis, ctx.dim = mesh, axis, dim
        return comm.local_part(x, mesh, (axis,), dim).contiguous()

    @staticmethod
    def backward(ctx, g):
        return comm.all_gather(g, ctx.mesh, ctx.axis, ctx.dim), None, None, None


class _Join(torch.autograd.Function):
    """This rank's block -> the replicated whole (backward: the block's
    part of the gradient)."""

    @staticmethod
    def forward(ctx, x, mesh, axis, dim):
        ctx.mesh, ctx.axis, ctx.dim = mesh, axis, dim
        return comm.all_gather(x, mesh, axis, dim)

    @staticmethod
    def backward(ctx, g):
        return comm.local_part(g, ctx.mesh, (ctx.axis,), ctx.dim).contiguous(), None, None, None


def ring_attention_sharded(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           mesh: DeviceMesh, *, axis_name: str = "seq", causal: bool = True,
                           block_q: int = 512, block_kv: int = 512) -> torch.Tensor:
    """Whole q, k, v (the same on every rank of the axis) -> the whole
    output on every rank, the sequence split over ``axis_name`` inside:
    each rank takes its block, runs the ring, and the blocks are gathered.
    Gradients come back whole on every rank. For models, whose activations
    are already split, call ``ring_attention`` on the blocks."""
    fn = functools.partial(ring_attention, mesh=mesh, axis_name=axis_name, causal=causal,
                           block_q=block_q, block_kv=block_kv)
    local = [_Split.apply(t, mesh, axis_name, 1) for t in (q, k, v)]
    return _Join.apply(fn(*local), mesh, axis_name, 1)

