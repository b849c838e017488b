"""Flash-attention kernels for Hopper, the port of
``ray_tpu/ops/pallas_attention.py``: the forward and the two
FlashAttention-2 backward kernels.

Kernels (hand-written CUDA C++ for sm_90a; see each source's header for
the design and what bounds it):

- ``csrc/flash_attention_fwd.cu``: ``flash_attention_fwd`` replaces
  ``pallas_attention.py`` ``_fwd`` (:141) / ``_fwd_kernel`` (:78);
- ``csrc/flash_attention_bwd.cu``: ``flash_attention_bwd_dkv`` replaces
  ``_bwd`` (:309) / ``_bwd_dkv_kernel`` (:200) and
  ``flash_attention_bwd_dq`` replaces ``_bwd_dq_kernel`` (:256);
  ``flash_attention_bwd`` runs both.

The kernels read the model's (B, S, H, hd) layout through strides, so the
transposes of ``pallas_attention.py:435-439`` are gone, and lse is
(B, H, S) f32 instead of the TPU's 128-lane broadcast. The dK/dV kernel
sums over the GQA group in f32 and rounds once; the reference writes
per-query-head bf16 partials and sums them outside the kernel. Each
kernel's plain PyTorch version (``flash_attention_plain``,
``flash_attention_bwd_dkv_plain``, ``flash_attention_bwd_dq_plain``) is
taken for CPU tensors and is what the kernel is held against on the card.
"""

from __future__ import annotations

import ctypes
import math
from typing import Tuple

import torch

from .._native import build
from .attention import _blockwise_accum, finalize_attention_state, init_attention_state


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                          causal: bool = True, block_q: int = 512,
                          block_kv: int = 512) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain version of the kernel: q (B,S,H,hd), k/v (B,T,KVH,hd) ->
    (o (B,S,H,hd) in q's dtype, lse (B,H,S) f32)."""
    B, S, H, hd = q.shape
    KVH = k.shape[2]
    if H % KVH != 0:
        raise ValueError(f"n_heads {H} not divisible by n_kv_heads {KVH}")
    G = H // KVH
    acc, m, l = init_attention_state(B, S, KVH, G, hd, device=q.device)
    acc, m, l = _blockwise_accum(q.reshape(B, S, KVH, G, hd), k, v, acc, m, l,
                                 causal=causal, block_q=block_q, block_kv=block_kv)
    o = finalize_attention_state(acc, l).reshape(B, S, H, hd).to(q.dtype)
    lse = (m + torch.log(torch.clamp(l, min=1e-30))).reshape(B, S, H)
    return o, lse.permute(0, 2, 1).contiguous()


def _recompute_p(qb, kb, lse_b, q_pos, kv_pos, causal: bool, scale: float):
    """p = exp(q k^T * scale - lse) of one (q block, kv block) pair, f32:
    qb (B, bq, KVH, G, hd), kb (B, bk, KVH, hd), lse_b (B, bq, KVH, G) ->
    (B, bq, KVH, G, bk); masked entries are exactly 0."""
    s = torch.einsum("bqkgh,btkh->bqkgt", qb, kb) * scale
    p = torch.exp(s - lse_b[..., None])
    if causal:
        mask = (q_pos[:, None] >= kv_pos[None, :])[None, :, None, None, :]
        p = torch.where(mask, p, 0.0)
    return p


def _bwd_blocks(q, k, lse, delta, do, causal, block_q, block_kv):
    """The (q block, kv block) pairs of the FlashAttention-2 backward that
    can see each other, with the per-block operands in f32 (exact for bf16
    inputs): yields (qs, qe, ks, ke, q, do, k, p, delta) with q/do
    (B, bq, KVH, G, hd), k (B, bk, KVH, hd), p and delta as above."""
    B, S, H, hd = q.shape
    T, KVH = k.shape[1], k.shape[2]
    G = H // KVH
    scale = 1.0 / math.sqrt(hd)
    dev = q.device
    qg, dog = q.reshape(B, S, KVH, G, hd), do.reshape(B, S, KVH, G, hd)
    lse_g = lse.permute(0, 2, 1).reshape(B, S, KVH, G)
    delta_g = delta.permute(0, 2, 1).reshape(B, S, KVH, G)
    for ks in range(0, T, block_kv):
        ke = min(ks + block_kv, T)
        kb = k[:, ks:ke].float()
        kv_pos = torch.arange(ks, ke, device=dev)
        for qs in range(0, S, block_q):
            qe = min(qs + block_q, S)
            if causal and qe - 1 < ks:
                continue
            qb = qg[:, qs:qe].float()
            p = _recompute_p(qb, kb, lse_g[:, qs:qe], torch.arange(qs, qe, device=dev),
                             kv_pos, causal, scale)
            yield qs, qe, ks, ke, qb, dog[:, qs:qe], kb, p, delta_g[:, qs:qe]


def flash_attention_bwd_dkv_plain(q, k, v, do, lse, delta, *, causal: bool = True,
                                  block_q: int = 512, block_kv: int = 512):
    """The plain version of the dK/dV kernel: (dk, dv) (B,T,KVH,hd) in k's
    and v's dtypes, summed over the GQA group in f32 and rounded once, as
    the kernel does. p is rounded to dO's dtype before p^T dO and dS to
    q's dtype before dS^T q, where the reference rounds."""
    B, T, KVH, hd = k.shape
    scale = 1.0 / math.sqrt(hd)
    dk = torch.zeros((B, T, KVH, hd), dtype=torch.float32, device=q.device)
    dv = torch.zeros_like(dk)
    for _, _, ks, ke, qb, dob, _, p, dl in _bwd_blocks(q, k, lse, delta, do, causal,
                                                       block_q, block_kv):
        vb = v[:, ks:ke].float()
        dv[:, ks:ke] += torch.einsum("bqkgt,bqkgh->btkh", p.to(do.dtype).float(), dob.float())
        dp = torch.einsum("bqkgh,btkh->bqkgt", dob.float(), vb)
        ds = p * (dp - dl[..., None]) * scale
        dk[:, ks:ke] += torch.einsum("bqkgt,bqkgh->btkh", ds.to(q.dtype).float(), qb)
    return dk.to(k.dtype), dv.to(v.dtype)


def flash_attention_bwd_dq_plain(q, k, v, do, lse, delta, *, causal: bool = True,
                                 block_q: int = 512, block_kv: int = 512):
    """The plain version of the dQ kernel: dq (B,S,H,hd) in q's dtype; dS
    is rounded to k's dtype before dS k, where the reference rounds."""
    B, S, H, hd = q.shape
    KVH = k.shape[2]
    scale = 1.0 / math.sqrt(hd)
    dq = torch.zeros((B, S, KVH, H // KVH, hd), dtype=torch.float32, device=q.device)
    for qs, qe, ks, ke, _, dob, kb, p, dl in _bwd_blocks(q, k, lse, delta, do, causal,
                                                         block_q, block_kv):
        dp = torch.einsum("bqkgh,btkh->bqkgt", dob.float(), v[:, ks:ke].float())
        ds = p * (dp - dl[..., None]) * scale
        dq[:, qs:qe] += torch.einsum("bqkgt,btkh->bqkgh", ds.to(k.dtype).float(), kb)
    return dq.reshape(B, S, H, hd).to(q.dtype)


def attention_delta(o: torch.Tensor, do: torch.Tensor) -> torch.Tensor:
    """delta = rowsum(dO * O) in f32, (B, S, H, hd) -> (B, H, S), the
    backward's per-row term (pallas_attention.py:318-324)."""
    return (do.float() * o.float()).sum(-1).permute(0, 2, 1).contiguous()


def flash_attention_bwd_plain(q, k, v, o, lse, do, *, causal: bool = True,
                              block_q: int = 512, block_kv: int = 512):
    """The plain version of ``flash_attention_bwd`` -> (dq, dk, dv)."""
    delta = attention_delta(o, do)
    kw = dict(causal=causal, block_q=block_q, block_kv=block_kv)
    dk, dv = flash_attention_bwd_dkv_plain(q, k, v, do, lse, delta, **kw)
    return flash_attention_bwd_dq_plain(q, k, v, do, lse, delta, **kw), dk, dv


def _size1_strides(t: torch.Tensor) -> torch.Tensor:
    """``t`` with the stride of each size-1 dimension set to what a
    contiguous layout gives it. Such a stride is never stepped along, and
    autograd may hand over any value there (a one-row microbatch's dO came
    with a batch stride of 1); the kernels take it as a row stride, which
    must stay 16-byte aligned."""
    if t.dim() != 4 or all(n > 1 for n in t.shape[:3]):
        return t
    strides = list(t.stride())
    for d in (2, 1, 0):
        if t.shape[d] == 1:
            strides[d] = strides[d + 1] * t.shape[d + 1]
    return t.as_strided(t.shape, strides)


def _check_operand(fn: str, name: str, t: torch.Tensor, dev: torch.device) -> None:
    if t.device != dev:
        raise ValueError(f"{fn}: {name} on {t.device}, q on {dev}")
    if t.dtype != torch.bfloat16:
        raise ValueError(f"{fn}: {name} is {t.dtype}; the kernel takes bfloat16")
    if t.dim() != 4 or t.stride(-1) != 1:
        raise ValueError(f"{fn}: {name} must be 4-D with a contiguous last dim")
    if any(s % 8 for s in t.stride()[:3]) or t.data_ptr() % 16:
        raise ValueError(f"{fn}: {name} rows must be 16-byte aligned")


def _check_shapes(fn: str, q, k, v, *rest) -> None:
    """Device, type, layout and shapes of the q/k/v-like operands; raises
    for anything the kernels do not take."""
    if q.device.type != "cuda":
        raise ValueError(f"{fn}: q on {q.device}; the kernel needs CUDA")
    for name, t in (("q", q), ("k", k), ("v", v), *rest):
        _check_operand(fn, name, t, q.device)
    B, S, H, hd = q.shape
    Bk, T, KVH, hdk = k.shape
    if v.shape != k.shape or Bk != B or hdk != hd:
        raise ValueError(f"{fn}: shapes q {tuple(q.shape)} "
                         f"k {tuple(k.shape)} v {tuple(v.shape)} do not match")
    if any(t.shape != q.shape for _, t in rest):
        raise ValueError(f"{fn}: dO must have q's shape {tuple(q.shape)}")
    if H % KVH != 0:
        raise ValueError(f"{fn}: H={H} not divisible by KVH={KVH}")
    if hd not in (64, 128):
        raise ValueError(f"{fn}: head_dim {hd}; the kernel takes 64 or 128")


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """q (B,S,H,hd), k/v (B,T,KVH,hd), bf16 on one CUDA device ->
    (o (B,S,H,hd) bf16, lse (B,H,S) f32). hd is 64 or 128; S and T need
    not be multiples of the tile. Raises for anything the kernel does not
    take; there is no fallback."""
    q, k, v = (_size1_strides(t) for t in (q, k, v))
    _check_shapes("flash_attention_fwd", q, k, v)
    dev = q.device
    B, S, H, hd = q.shape
    T, KVH = k.shape[1], k.shape[2]
    lib = build.library()
    o = torch.empty((B, S, H, hd), dtype=q.dtype, device=dev)
    lse = torch.empty((B, H, S), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        flash_attention_fwd.launches += 1
        err = lib.rtt_flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
            B, S, T, H, KVH, hd,
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *o.stride()[:3],
            1.0 / math.sqrt(hd), int(causal), stream)
    build.check(err, "flash_attention_fwd")
    return o, lse


flash_attention_fwd.launches = 0


def _check_stats(fn: str, lse: torch.Tensor, delta: torch.Tensor, q: torch.Tensor) -> None:
    B, S, H, _ = q.shape
    for name, t in (("lse", lse), ("delta", delta)):
        if (t.device != q.device or t.dtype != torch.float32 or t.shape != (B, H, S)
                or not t.is_contiguous()):
            raise ValueError(f"{fn}: {name} must be contiguous (B, H, S) float32 on {q.device}")


def _strides(*ts):
    """The (b, s, h) strides of each tensor, None for three zeros, as the
    C array of long long the entry points read."""
    vals = [s for t in ts for s in (t.stride()[:3] if t is not None else (0, 0, 0))]
    return (ctypes.c_longlong * len(vals))(*vals)


def flash_attention_bwd_dkv(q, k, v, do, lse, delta, *, causal: bool = True):
    """The dK/dV kernel: q/do (B,S,H,hd), k/v (B,T,KVH,hd) bf16 read
    through strides, lse and delta (B,H,S) f32 on one CUDA device ->
    (dk, dv) (B,T,KVH,hd) bf16. Raises for anything the kernel does not
    take."""
    fn = "flash_attention_bwd_dkv"
    q, k, v, do = (_size1_strides(t) for t in (q, k, v, do))
    _check_shapes(fn, q, k, v, ("dO", do))
    _check_stats(fn, lse, delta, q)
    dev = q.device
    B, S, H, hd = q.shape
    T, KVH = k.shape[1], k.shape[2]
    lib = build.library()
    dk = torch.empty((B, T, KVH, hd), dtype=k.dtype, device=dev)
    dv = torch.empty_like(dk)
    strides = _strides(q, k, v, do, None, dk)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        flash_attention_bwd_dkv.launches += 1
        err = lib.rtt_flash_attention_bwd_dkv(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
            delta.data_ptr(), dk.data_ptr(), dv.data_ptr(), B, S, T, H, KVH, hd,
            ctypes.addressof(strides), 1.0 / math.sqrt(hd), int(causal), stream)
    build.check(err, fn)
    return dk, dv


flash_attention_bwd_dkv.launches = 0


def flash_attention_bwd_dq(q, k, v, do, lse, delta, *, causal: bool = True):
    """The dQ kernel: operands as ``flash_attention_bwd_dkv`` -> dq
    (B,S,H,hd) bf16. Raises for anything the kernel does not take."""
    fn = "flash_attention_bwd_dq"
    q, k, v, do = (_size1_strides(t) for t in (q, k, v, do))
    _check_shapes(fn, q, k, v, ("dO", do))
    _check_stats(fn, lse, delta, q)
    dev = q.device
    B, S, H, hd = q.shape
    T, KVH = k.shape[1], k.shape[2]
    lib = build.library()
    dq = torch.empty((B, S, H, hd), dtype=q.dtype, device=dev)
    strides = _strides(q, k, v, do, dq, None)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        flash_attention_bwd_dq.launches += 1
        err = lib.rtt_flash_attention_bwd_dq(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
            delta.data_ptr(), dq.data_ptr(), B, S, T, H, KVH, hd,
            ctypes.addressof(strides), 1.0 / math.sqrt(hd), int(causal), stream)
    build.check(err, fn)
    return dq


flash_attention_bwd_dq.launches = 0


def flash_attention_bwd(q, k, v, o, lse, do, *, causal: bool = True):
    """The FlashAttention-2 backward on the card: delta = rowsum(dO * O)
    in f32 by PyTorch (the reference computes it outside its kernels
    too), then the dK/dV and the dQ kernels -> (dq, dk, dv) bf16."""
    delta = attention_delta(o, do)
    dk, dv = flash_attention_bwd_dkv(q, k, v, do, lse, delta, causal=causal)
    return flash_attention_bwd_dq(q, k, v, do, lse, delta, causal=causal), dk, dv
