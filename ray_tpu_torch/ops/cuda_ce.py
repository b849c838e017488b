"""Fused lm-head cross-entropy, the port of ``ray_tpu/ops/pallas_ce.py``:
the forward kernel and the backward's dlog, dx and dW kernels.

Kernels (hand-written CUDA C++ for sm_90a; see each source's header for
the design and what bounds it):

- ``csrc/fused_ce_fwd.cu``: ``fused_ce_fwd`` replaces ``pallas_ce.py``
  ``_fwd_call`` (:95) / ``_fwd_kernel`` (:52);
- ``csrc/fused_ce_bwd.cu`` replaces ``_bwd_call`` (:201):
  ``fused_ce_bwd_dlog`` forms dlog for a chunk of rows once,
  ``fused_ce_bwd_dx`` takes it into dx (``_dx_kernel``, :142) and
  ``fused_ce_bwd_dw`` into dW (``_dw_kernel``, :171); ``fused_ce_bwd``
  walks the chunks.

All four kernels run on the GEMM core ``csrc/wgmma_gemm.cuh``.

Contract, as in the JAX module:
    x (N, D), w (D, V), targets (N,) int
    -> per-token losses (N,) f32 = lse_i - logit_i[target_i]
Targets are clamped into [0, V) first (pallas_ce.py:265). Masking and
averaging stay with the caller (``models.llama.masked_mean``).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from .._native import build

_TILE_V = 256            # vocab columns per tile (gemm::kBN; rtt_fused_ce_fwd checks it)
# Most bytes the backward's dlog chunk may take: no buffer grows as N x V.
_DLOG_BUDGET = 256 * 2**20


def fused_ce_fwd_plain(x: torch.Tensor, w: torch.Tensor, targets: torch.Tensor,
                       block_n: Optional[int] = None, block_v: Optional[int] = None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain version of the kernel: (lse, target logit), both (N,) f32,
    from f32 products of x and w (exact for bf16 inputs, as the kernel's
    f32 accumulation). Targets must already be in [0, V). With ``block_n``
    and ``block_v`` the rows and the vocab are walked in blocks of those
    sizes, lse as an online logsumexp over the vocab blocks (the
    reference's ``_fwd_kernel`` loop); without them in one piece."""
    N, V = x.shape[0], w.shape[1]
    bn, bv = block_n or max(N, 1), block_v or max(V, 1)
    lses, tgts = [], []
    for r0 in range(0, N, bn):
        xb, tb = x[r0:r0 + bn].float(), targets[r0:r0 + bn].long()
        m = torch.full((xb.shape[0],), -torch.inf, device=x.device)
        s = torch.zeros_like(m)
        tgt = torch.zeros_like(m)
        for c0 in range(0, V, bv):
            logits = xb @ w[:, c0:c0 + bv].float()
            m_new = torch.maximum(m, logits.amax(dim=-1))
            s = s * torch.exp(m - m_new) + torch.exp(logits - m_new[:, None]).sum(dim=-1)
            m = m_new
            hit = (tb >= c0) & (tb < c0 + logits.shape[1])
            col = (tb - c0).clamp(0, logits.shape[1] - 1)
            tgt = tgt + torch.where(hit, logits.gather(1, col[:, None])[:, 0], 0.0)
        lses.append(m + torch.log(s))
        tgts.append(tgt)
    return torch.cat(lses), torch.cat(tgts)


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


def _launch(fn, name: str, dev, *args) -> None:
    lib = build.library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        fn.launches += 1
        err = getattr(lib, f"rtt_{name}")(*args, stream)
    build.check(err, name)


def fused_ce_fwd(x: torch.Tensor, w: torch.Tensor,
                 targets: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (N,D), w (D,V) bf16 contiguous and targets (N,) int32 in [0, V) on
    one CUDA device -> (lse, tgt), both (N,) f32. D and V must be
    multiples of 8. Raises for anything the kernel does not take."""
    _check_fwd("fused_ce_fwd", x, w, targets)
    dev = x.device
    N, D = x.shape
    V = w.shape[1]
    # one partial (max, sum, target logit) per row and vocab tile; the
    # kernel refuses a tile count other than its own
    n_vt = -(-V // _TILE_V)
    part = torch.empty((3, n_vt, N), dtype=torch.float32, device=dev)
    lse = torch.empty((N,), dtype=torch.float32, device=dev)
    tgt = torch.empty((N,), dtype=torch.float32, device=dev)
    _launch(fused_ce_fwd, "fused_ce_fwd", dev, x.data_ptr(), w.data_ptr(), targets.data_ptr(),
            part.data_ptr(), lse.data_ptr(), tgt.data_ptr(), N, D, V, n_vt)
    return lse, tgt


fused_ce_fwd.launches = 0


def fused_ce_bwd_dlog_plain(x, w, targets, lse, g, out=None) -> torch.Tensor:
    """The plain version of the dlog kernel: dlog = (softmax(x w) -
    onehot(targets)) * g, from f32 products (exact for bf16 inputs) and the
    forward's lse -> (N, V) rounded once to x's dtype, or written into
    ``out`` and rounded once to its dtype."""
    p = torch.exp(x.float() @ w.float() - lse[:, None])
    p[torch.arange(p.shape[0], device=p.device), targets.long()] -= 1.0
    dlog = p * g[:, None]
    return dlog.to(x.dtype) if out is None else out.copy_(dlog)


def fused_ce_bwd_dx_plain(dlog, w, out=None) -> torch.Tensor:
    """The plain version of the dx kernel: dlog (N, V), rounded to w's dtype
    as the reference rounds it for dx (pallas_ce.py:162), times w^T in f32
    -> (N, D) rounded once to w's dtype, or written into ``out`` and
    rounded once to its dtype."""
    dx = dlog.to(w.dtype).float() @ w.float().T
    return dx.to(w.dtype) if out is None else out.copy_(dx)


def fused_ce_bwd_dw_plain(x, dlog, acc=None, last=True, out_dtype=None) -> torch.Tensor:
    """The plain version of the dW kernel: x^T dlog in f32 for one chunk of
    rows, dlog rounded to x's dtype as the reference rounds it for dW
    (pallas_ce.py:192), added to ``acc`` (D, V) f32, the sum of the chunks
    before (None for the first). Returns the new f32 sum (``acc`` updated
    in place), or when ``last`` the sum rounded once to ``out_dtype`` (x's
    dtype when None): dW."""
    s = x.float().T @ dlog.to(x.dtype).float()
    if acc is not None:
        s = acc.add_(s)
    return s.to(out_dtype or x.dtype) if last else s


def _dlog_dtype(x, w) -> torch.dtype:
    """dlog's buffer: the one input dtype, or f32 when x and w differ, so
    that each product rounds dlog once to its own operand's dtype."""
    return x.dtype if x.dtype == w.dtype else torch.float32


def fused_ce_bwd_plain(x, w, targets, lse, g) -> Tuple[torch.Tensor, torch.Tensor]:
    """The whole backward in one piece (all N rows at once): (dx, dW) in
    x's and w's dtypes, the reference for ``fused_ce_bwd``."""
    dlog = fused_ce_bwd_dlog_plain(x, w, targets, lse, g, out=torch.empty(
        (x.shape[0], w.shape[1]), dtype=_dlog_dtype(x, w), device=x.device))
    dx = fused_ce_bwd_dx_plain(dlog, w, out=torch.empty_like(x))
    return dx, fused_ce_bwd_dw_plain(x, dlog, out_dtype=w.dtype)


def _check_bwd(fn: str, x, w, targets, lse, g) -> None:
    _check_fwd(fn, x, w, targets)
    N = x.shape[0]
    for name, t in (("lse", lse), ("g", g)):
        if (t.device != x.device or t.dtype != torch.float32 or t.shape != (N,)
                or not t.is_contiguous()):
            raise ValueError(f"{fn}: {name} must be contiguous (N,) float32 on {x.device}")


def _check_mat(fn: str, name: str, t, shape, dtype, dev) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{fn}: {name} on {t.device}; the kernel needs CUDA")
    if (t.device != dev or t.dtype != dtype or tuple(t.shape) != shape
            or not t.is_contiguous() or t.data_ptr() % 16):
        raise ValueError(f"{fn}: {name} must be a contiguous, 16-byte aligned {shape} "
                         f"{dtype} on {dev}, got {tuple(t.shape)} {t.dtype} on {t.device}")


def fused_ce_bwd_dlog(x, w, targets, lse, g, out=None) -> torch.Tensor:
    """The dlog kernel: operands as ``fused_ce_fwd`` plus the forward's lse
    and the upstream gradient g, both (N,) f32 -> dlog (N, V) bf16, written
    into ``out`` when given. Raises for anything the kernel does not take."""
    _check_bwd("fused_ce_bwd_dlog", x, w, targets, lse, g)
    N, D = x.shape
    V = w.shape[1]
    if out is None:
        out = torch.empty((N, V), dtype=x.dtype, device=x.device)
    _check_mat("fused_ce_bwd_dlog", "out", out, (N, V), x.dtype, x.device)
    _launch(fused_ce_bwd_dlog, "fused_ce_bwd_dlog", x.device, x.data_ptr(), w.data_ptr(),
            targets.data_ptr(), lse.data_ptr(), g.data_ptr(), out.data_ptr(), N, D, V)
    return out


fused_ce_bwd_dlog.launches = 0


def fused_ce_bwd_dx(dlog, w, out=None) -> torch.Tensor:
    """The dx kernel: dlog (N, V) and w (D, V) bf16 on one CUDA device ->
    dx (N, D) bf16, written into ``out`` when given. Raises for anything the
    kernel does not take."""
    fn = "fused_ce_bwd_dx"
    N, V = dlog.shape
    D = w.shape[0]
    _check_mat(fn, "dlog", dlog, (N, V), torch.bfloat16, dlog.device)
    _check_mat(fn, "w", w, (D, V), torch.bfloat16, dlog.device)
    if D % 8 or V % 8:
        raise ValueError(f"{fn}: D={D} and V={V} must be multiples of 8")
    if out is None:
        out = torch.empty((N, D), dtype=w.dtype, device=w.device)
    _check_mat(fn, "out", out, (N, D), torch.bfloat16, dlog.device)
    _launch(fused_ce_bwd_dx, fn, dlog.device, dlog.data_ptr(), w.data_ptr(), out.data_ptr(),
            N, D, V)
    return out


fused_ce_bwd_dx.launches = 0


def fused_ce_bwd_dw(x, dlog, acc=None, last=True, out_dtype=None) -> torch.Tensor:
    """The dW kernel: x (N, D) and dlog (N, V) bf16 of one chunk of rows on
    one CUDA device, and ``acc`` (D, V) f32, the sum of the chunks before
    (None for the first). Returns the new f32 sum (``acc`` updated in
    place), or when ``last`` dW (D, V) bf16 (``out_dtype`` None or bf16).
    Raises for anything the kernel does not take."""
    fn = "fused_ce_bwd_dw"
    N, D = x.shape
    V = dlog.shape[1]
    _check_mat(fn, "x", x, (N, D), torch.bfloat16, x.device)
    _check_mat(fn, "dlog", dlog, (N, V), torch.bfloat16, x.device)
    if D % 8 or V % 8:
        raise ValueError(f"{fn}: D={D} and V={V} must be multiples of 8")
    if out_dtype not in (None, torch.bfloat16):
        raise ValueError(f"{fn}: dW in {out_dtype}; the kernel writes bfloat16")
    if acc is not None:
        _check_mat(fn, "acc", acc, (D, V), torch.float32, x.device)
    total = acc
    if total is None and not last:
        total = torch.empty((D, V), dtype=torch.float32, device=x.device)
    dw = torch.empty((D, V), dtype=dlog.dtype, device=x.device) if last else None
    _launch(fused_ce_bwd_dw, fn, x.device, x.data_ptr(), dlog.data_ptr(),
            None if total is None else total.data_ptr(), None if dw is None else dw.data_ptr(),
            N, D, V, int(acc is not None), int(last))
    return dw if last else total


fused_ce_bwd_dw.launches = 0


def chunk_rows(N: int, V: int, itemsize: int) -> int:
    """Rows per chunk of the backward: the largest multiple of 128 whose
    dlog chunk (rows x V x itemsize bytes) fits ``_DLOG_BUDGET``, at least
    128 and at most N."""
    rows = _DLOG_BUDGET // (V * itemsize) // 128 * 128
    return min(max(rows, 128), N)


def fused_ce_bwd(x, w, targets, lse, g) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dx, dW), a chunk of rows at a time: per chunk dlog is formed once
    into a buffer of at most ``_DLOG_BUDGET`` bytes, dx's rows are written,
    and x_c^T dlog is added into an f32 (D, V) sum that the last chunk
    rounds into dW. CUDA tensors go to the three kernels (or the call
    raises), CPU tensors to their plain versions; the loop is the same."""
    if x.device.type == "cuda":
        dlog_fn, dx_fn, dw_fn = fused_ce_bwd_dlog, fused_ce_bwd_dx, fused_ce_bwd_dw
    elif x.device.type == "cpu":
        dlog_fn, dx_fn, dw_fn = (fused_ce_bwd_dlog_plain, fused_ce_bwd_dx_plain,
                                 fused_ce_bwd_dw_plain)
    else:
        raise ValueError(f"fused_ce_bwd: unsupported device {x.device}")
    N = x.shape[0]
    V = w.shape[1]
    dtype = _dlog_dtype(x, w)
    rows = chunk_rows(N, V, dtype.itemsize)
    buf = torch.empty((rows, V), dtype=dtype, device=x.device)
    dx = torch.empty_like(x)
    acc = None
    for r0 in range(0, N, rows):
        r1 = min(r0 + rows, N)
        dlog = dlog_fn(x[r0:r1], w, targets[r0:r1], lse[r0:r1], g[r0:r1], out=buf[:r1 - r0])
        dx_fn(dlog, w, out=dx[r0:r1])
        acc = dw_fn(x[r0:r1], dlog, acc, last=r1 == N, out_dtype=w.dtype)
    return dx, acc


class _FusedCrossEntropy(torch.autograd.Function):
    """Forward and backward; the residuals are those of ``pallas_ce.py``
    ``_vjp_fwd`` (:270-274): x, w, the clamped targets and lse."""

    @staticmethod
    def forward(ctx, x, w, targets, block_n, block_v):
        t = targets.clamp(0, w.shape[1] - 1)
        if x.device.type == "cuda":
            t = t.to(torch.int32).contiguous()
            lse, tgt = fused_ce_fwd(x, w, t)
        elif x.device.type == "cpu":
            lse, tgt = fused_ce_fwd_plain(x, w, t, block_n, block_v)
        else:
            raise ValueError(f"fused_cross_entropy: unsupported device {x.device}")
        ctx.save_for_backward(x, w, t, lse)
        return lse - tgt

    @staticmethod
    def backward(ctx, g):
        x, w, t, lse = ctx.saved_tensors
        g = g.float().contiguous()          # f32 per row, as pallas_ce.py:280
        dx, dw = fused_ce_bwd(x, w, t, lse, g)
        return dx, dw, None, None, None


def fused_cross_entropy(x: torch.Tensor, w: torch.Tensor, targets: torch.Tensor,
                        block_n: int = 128, block_v: int = 512) -> torch.Tensor:
    """Per-token losses (N,) f32 for logits = x @ w against targets.

    Out-of-range targets are clamped into [0, V), as the JAX kernel does;
    without the clamp the column match would miss and return lse instead
    of a loss. A CUDA tensor goes to the kernel (or the call raises), a
    CPU tensor to the plain version.

    ``block_n`` and ``block_v`` are the reference's row and vocab blocks
    (positional there too). The plain forward walks the rows and the
    vocab in blocks of those sizes; the kernels keep their own tiles (128
    rows by 256 vocab columns, ``csrc/wgmma_gemm.cuh``) and ignore them,
    and the backward walks rows in chunks of ``chunk_rows`` on both
    devices."""
    if block_n < 1 or block_v < 1:
        raise ValueError(f"block sizes must be positive, got {block_n}, {block_v}")
    return _FusedCrossEntropy.apply(x, w, targets, block_n, block_v)


def xla_cross_entropy(x: torch.Tensor, w: torch.Tensor,
                      targets: torch.Tensor) -> torch.Tensor:
    """Reference path of the JAX module: materialized logits in x's dtype,
    then an f32 log-softmax. Targets must lie in [0, V)."""
    logits = (x @ w.to(x.dtype)).float()
    logp = F.log_softmax(logits, dim=-1)
    return -logp.gather(1, targets.long()[:, None])[:, 0]
