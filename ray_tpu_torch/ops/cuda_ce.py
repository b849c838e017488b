"""Fused lm-head cross-entropy, the port of ``ray_tpu/ops/pallas_ce.py``:
the forward and the dx and dW backward kernels.

Kernels (hand-written CUDA C++ for sm_90a; see each source's header for
the design and what bounds it):

- ``csrc/fused_ce_fwd.cu``: ``fused_ce_fwd`` replaces ``pallas_ce.py``
  ``_fwd_call`` (:95) / ``_fwd_kernel`` (:52);
- ``csrc/fused_ce_bwd.cu``: ``fused_ce_bwd_dx`` replaces ``_bwd_call``
  (:201) / ``_dx_kernel`` (:142) and ``fused_ce_bwd_dw`` replaces
  ``_dw_kernel`` (:171); ``fused_ce_bwd`` runs both.

Contract, as in the JAX module:
    x (N, D), w (D, V), targets (N,) int
    -> per-token losses (N,) f32 = lse_i - logit_i[target_i]
Targets are clamped into [0, V) first (pallas_ce.py:265). Masking and
averaging stay with the caller (``models.llama.masked_mean``).
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from .._native import build

_TILE_V = 128            # vocab columns per tile (kBN in the .cu)
_ROWS = 128              # rows per CTA (kBM in the .cu)


def fused_ce_fwd_plain(x: torch.Tensor, w: torch.Tensor,
                       targets: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain version of the kernel: (lse, target logit), both (N,) f32,
    from f32 products of x and w (exact for bf16 inputs, as the kernel's
    f32 accumulation). Targets must already be in [0, V)."""
    logits = x.float() @ w.float()
    lse = torch.logsumexp(logits, dim=-1)
    tgt = logits.gather(1, targets.long()[:, None])[:, 0]
    return lse, tgt


def _check_fwd(fn: str, x, w, targets) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"{fn}: x on {x.device}; the kernel needs CUDA")
    dev = x.device
    if w.device != dev or targets.device != dev:
        raise ValueError(f"{fn}: x, w and targets must share one device")
    if x.dtype != torch.bfloat16 or w.dtype != torch.bfloat16:
        raise ValueError(f"{fn}: x {x.dtype}, w {w.dtype}; the kernel takes bfloat16")
    if targets.dtype != torch.int32:
        raise ValueError(f"{fn}: targets {targets.dtype}; the kernel takes int32")
    if x.dim() != 2 or w.dim() != 2 or targets.dim() != 1:
        raise ValueError(f"{fn}: x (N,D), w (D,V) and targets (N,) expected")
    N, D = x.shape
    V = w.shape[1]
    if w.shape[0] != D or targets.shape[0] != N:
        raise ValueError(f"{fn}: x {tuple(x.shape)}, w {tuple(w.shape)}, "
                         f"targets {tuple(targets.shape)} do not match")
    if D % 8 or V % 8:
        raise ValueError(f"{fn}: D={D} and V={V} must be multiples of 8")
    for name, t in (("x", x), ("w", w), ("targets", targets)):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{fn}: {name} must be contiguous and 16-byte aligned")


def fused_ce_fwd(x: torch.Tensor, w: torch.Tensor,
                 targets: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (N,D), w (D,V) bf16 contiguous and targets (N,) int32 in [0, V) on
    one CUDA device -> (lse, tgt), both (N,) f32. D and V must be
    multiples of 8. Raises for anything the kernel does not take."""
    _check_fwd("fused_ce_fwd", x, w, targets)
    dev = x.device
    N, D = x.shape
    V = w.shape[1]
    lib = build.library()
    # Split the vocab across CTAs: at least 8 splits (so the CTAs in
    # flight share few row blocks of x), more when there are few rows.
    n_vt = -(-V // _TILE_V)
    row_blocks = -(-N // _ROWS)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    splits = min(n_vt, max(8, -(-2 * sms // row_blocks)))
    tiles_per_split = -(-n_vt // splits)
    splits = -(-n_vt // tiles_per_split)
    part = torch.empty((splits, N, 3), dtype=torch.float32, device=dev)
    lse = torch.empty((N,), dtype=torch.float32, device=dev)
    tgt = torch.empty((N,), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        fused_ce_fwd.launches += 1
        err = lib.rtt_fused_ce_fwd(
            x.data_ptr(), w.data_ptr(), targets.data_ptr(), part.data_ptr(),
            lse.data_ptr(), tgt.data_ptr(), N, D, V, splits, tiles_per_split, stream)
    build.check(err, "fused_ce_fwd")
    return lse, tgt


fused_ce_fwd.launches = 0


def _dlog_plain(x, w, targets, lse, g):
    """dlog = (softmax(x w) - onehot(targets)) * g in f32, from f32
    products (exact for bf16 inputs) and the forward's lse."""
    p = torch.exp(x.float() @ w.float() - lse[:, None])
    p[torch.arange(p.shape[0], device=p.device), targets.long()] -= 1.0
    return p * g[:, None]


def fused_ce_bwd_dx_plain(x, w, targets, lse, g) -> torch.Tensor:
    """The plain version of the dx kernel: dx = bf16(dlog) w^T (dlog
    rounded to w's dtype, as the reference) -> (N, D) in x's dtype."""
    dlog = _dlog_plain(x, w, targets, lse, g)
    return (dlog.to(w.dtype).float() @ w.float().T).to(x.dtype)


def fused_ce_bwd_dw_plain(x, w, targets, lse, g) -> torch.Tensor:
    """The plain version of the dW kernel: dW = x^T bf16(dlog) (dlog
    rounded to x's dtype, as the reference) -> (D, V) in w's dtype."""
    dlog = _dlog_plain(x, w, targets, lse, g)
    return (x.float().T @ dlog.to(x.dtype).float()).to(w.dtype)


def fused_ce_bwd_plain(x, w, targets, lse, g) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain version of ``fused_ce_bwd`` -> (dx, dw)."""
    return (fused_ce_bwd_dx_plain(x, w, targets, lse, g),
            fused_ce_bwd_dw_plain(x, w, targets, lse, g))


def _check_bwd(fn: str, x, w, targets, lse, g) -> None:
    _check_fwd(fn, x, w, targets)
    N = x.shape[0]
    for name, t in (("lse", lse), ("g", g)):
        if (t.device != x.device or t.dtype != torch.float32 or t.shape != (N,)
                or not t.is_contiguous()):
            raise ValueError(f"{fn}: {name} must be contiguous (N,) float32 on {x.device}")


def fused_ce_bwd_dx(x, w, targets, lse, g) -> torch.Tensor:
    """The dx kernel: operands as ``fused_ce_fwd`` plus the forward's lse
    and the upstream gradient g, both (N,) f32 -> dx (N, D) bf16. Raises
    for anything the kernel does not take."""
    _check_bwd("fused_ce_bwd_dx", x, w, targets, lse, g)
    N, D = x.shape
    V = w.shape[1]
    lib = build.library()
    scratch = torch.empty((N, D), dtype=torch.float32, device=x.device)
    dx = torch.empty((N, D), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        fused_ce_bwd_dx.launches += 1
        err = lib.rtt_fused_ce_bwd_dx(
            x.data_ptr(), w.data_ptr(), targets.data_ptr(), lse.data_ptr(), g.data_ptr(),
            scratch.data_ptr(), dx.data_ptr(), N, D, V, stream)
    build.check(err, "fused_ce_bwd_dx")
    return dx


fused_ce_bwd_dx.launches = 0


def fused_ce_bwd_dw(x, w, targets, lse, g) -> torch.Tensor:
    """The dW kernel: operands as ``fused_ce_bwd_dx`` -> dW (D, V) bf16.
    Raises for anything the kernel does not take."""
    _check_bwd("fused_ce_bwd_dw", x, w, targets, lse, g)
    N, D = x.shape
    V = w.shape[1]
    lib = build.library()
    scratch = torch.empty((D, V), dtype=torch.float32, device=x.device)
    dw = torch.empty((D, V), dtype=w.dtype, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        fused_ce_bwd_dw.launches += 1
        err = lib.rtt_fused_ce_bwd_dw(
            x.data_ptr(), w.data_ptr(), targets.data_ptr(), lse.data_ptr(), g.data_ptr(),
            scratch.data_ptr(), dw.data_ptr(), N, D, V, stream)
    build.check(err, "fused_ce_bwd_dw")
    return dw


fused_ce_bwd_dw.launches = 0


def fused_ce_bwd(x, w, targets, lse, g) -> Tuple[torch.Tensor, torch.Tensor]:
    """The backward on the card: the dx and the dW kernels -> (dx, dw)."""
    return fused_ce_bwd_dx(x, w, targets, lse, g), fused_ce_bwd_dw(x, w, targets, lse, g)


class _FusedCrossEntropy(torch.autograd.Function):
    """Forward and backward; the residuals are those of ``pallas_ce.py``
    ``_vjp_fwd`` (:270-274): x, w, the clamped targets and lse."""

    @staticmethod
    def forward(ctx, x, w, targets):
        t = targets.clamp(0, w.shape[1] - 1)
        if x.device.type == "cuda":
            t = t.to(torch.int32).contiguous()
            lse, tgt = fused_ce_fwd(x, w, t)
        elif x.device.type == "cpu":
            lse, tgt = fused_ce_fwd_plain(x, w, t)
        else:
            raise ValueError(f"fused_cross_entropy: unsupported device {x.device}")
        ctx.save_for_backward(x, w, t, lse)
        return lse - tgt

    @staticmethod
    def backward(ctx, g):
        x, w, t, lse = ctx.saved_tensors
        g = g.float().contiguous()          # f32 per row, as pallas_ce.py:280
        if g.device.type == "cuda":
            dx, dw = fused_ce_bwd(x, w, t, lse, g)
        elif g.device.type == "cpu":
            dx, dw = fused_ce_bwd_plain(x, w, t, lse, g)
        else:
            raise ValueError(f"fused_cross_entropy: unsupported device {g.device}")
        return dx, dw, None


def fused_cross_entropy(x: torch.Tensor, w: torch.Tensor,
                        targets: torch.Tensor) -> torch.Tensor:
    """Per-token losses (N,) f32 for logits = x @ w against targets.

    Out-of-range targets are clamped into [0, V), as the JAX kernel does;
    without the clamp the column match would miss and return lse instead
    of a loss. A CUDA tensor goes to the kernel (or the call raises), a
    CPU tensor to the plain version."""
    return _FusedCrossEntropy.apply(x, w, targets)


def xla_cross_entropy(x: torch.Tensor, w: torch.Tensor,
                      targets: torch.Tensor) -> torch.Tensor:
    """Reference path of the JAX module: materialized logits in x's dtype,
    then an f32 log-softmax. Targets must lie in [0, V)."""
    logits = (x @ w.to(x.dtype)).float()
    logp = F.log_softmax(logits, dim=-1)
    return -logp.gather(1, targets.long()[:, None])[:, 0]
