"""The update of ``parallel.default_optimizer`` (clip by the global norm,
then AdamW) over the leaves of a parameter tree, in place.

Kernel (hand-written CUDA C++ for sm_90a; see the source's header for the
design and what bounds it): ``csrc/fused_adamw.cu``, ``fused_adamw``,
applies the whole chain to one leaf in one read and one write. It
replaces no TPU kernel: the reference's optimizer is optax, whose chain
XLA fuses. PyTorch runs it as ~20 elementwise kernels a leaf; the update
is bandwidth-bound, so one pass is the gain.

``adamw_update`` dispatches on where the parameters lie: leaves on the CPU
take ``adamw_update_plain``, the per-leaf loop of ops (the plain version,
held against the JAX package's optax on the CPU); leaves on a CUDA device
take the kernel, one launch a leaf, or raise. The kernel repeats the loop's
ops, order and roundings, so on the card the two agree bit for bit.
"""

from __future__ import annotations

import ctypes
from typing import Dict, List, NamedTuple

import torch

from .._native import build


class AdamWStep(NamedTuple):
    """The host's numbers of one update: the clip, the AdamW constants, the
    f32 bias corrections ``1 - b ** count`` and the schedule's lr."""
    grad_clip: float
    b1: float
    b2: float
    eps: float
    weight_decay: float
    lr: float
    bc1: float
    bc2: float


class Scalars(NamedTuple):
    """An ``AdamWStep``'s scalars rounded to one leaf dtype (the clip also
    to float32, which the norm is compared with), in the order of the
    kernel's ``Scalars``."""
    clip_f32: float
    clip: float
    b1: float
    omb1: float
    b2: float
    omb2: float
    bc1: float
    bc2: float
    eps: float
    wd: float
    neg_lr: float


def _scalar(x: float, dtype: torch.dtype) -> float:
    """x rounded to ``dtype``, as a weakly typed JAX scalar is."""
    return torch.tensor(x, dtype=torch.float32).to(dtype).item()


def rounded(hp: AdamWStep, dtypes) -> Dict[torch.dtype, Scalars]:
    """The scalars of ``hp`` rounded once to each dtype in ``dtypes``."""
    clip_f32 = _scalar(hp.grad_clip, torch.float32)
    return {dt: Scalars(clip_f32, *(_scalar(x, dt) for x in (
        hp.grad_clip, hp.b1, 1 - hp.b1, hp.b2, 1 - hp.b2, hp.bc1, hp.bc2, hp.eps,
        hp.weight_decay, -hp.lr))) for dt in set(dtypes)}


def adamw_update_plain(gs: List[torch.Tensor], ps: List[torch.Tensor], mus: List[torch.Tensor],
                       nus: List[torch.Tensor], gnorm: torch.Tensor, hp: AdamWStep) -> None:
    """The plain version: optax's ops one at a time, each rounding to its
    tensor's dtype, a product before the sum it feeds. ``ps``, ``mus`` and
    ``nus`` are updated in place."""
    keep = gnorm < hp.grad_clip
    # optax selects t / norm * clip where the norm reaches the clip;
    # dividing and multiplying by 1 elsewhere is exact
    one = torch.ones((), device=gnorm.device)
    by_dtype = rounded(hp, (p.dtype for p in ps))
    for g, p, mu, nu in zip(gs, ps, mus, nus):
        dt, s = p.dtype, by_dtype[p.dtype]
        g = (g / torch.where(keep, one, gnorm).to(dt)
             * torch.where(keep, one, s.clip).to(dt))
        mu.mul_(s.b1).add_(g * s.omb1)
        nu.mul_(s.b2).add_(g.square().mul_(s.omb2))
        u = mu / s.bc1
        u /= (nu / s.bc2).sqrt_().add_(s.eps)
        u.add_(p * s.wd)
        p.add_(u.mul_(s.neg_lr))


_DTYPES = (torch.float32, torch.bfloat16)


def _check(g: torch.Tensor, p: torch.Tensor, mu: torch.Tensor, nu: torch.Tensor,
           gnorm: torch.Tensor) -> None:
    fn = "fused_adamw"
    dev = p.device
    if dev.type != "cuda":
        raise ValueError(f"{fn}: p on {dev}; the kernel needs CUDA")
    for name, t in (("g", g), ("mu", mu), ("nu", nu), ("the global norm", gnorm)):
        if t.device != dev:
            raise ValueError(f"{fn}: {name} on {t.device}, p on {dev}")
    if p.dtype not in _DTYPES:
        raise ValueError(f"{fn}: p {p.dtype}; the kernel takes float32 or bfloat16")
    for name, t in (("g", g), ("mu", mu), ("nu", nu)):
        if t.dtype != p.dtype:
            raise ValueError(f"{fn}: {name} {t.dtype}, p {p.dtype}; one dtype a leaf")
    if gnorm.dim() != 0 or gnorm.dtype != torch.float32:
        raise ValueError(f"{fn}: the global norm must be a 0-d float32 tensor")
    n = p.numel()
    for name, t in (("g", g), ("mu", mu), ("nu", nu)):
        if t.numel() != n:
            raise ValueError(f"{fn}: {name} has {t.numel()} elements, p {n}")
    for name, t in (("p", p), ("mu", mu), ("nu", nu)):
        if not t.is_contiguous():
            raise ValueError(f"{fn}: {name} must be contiguous")


def fused_adamw(g: torch.Tensor, p: torch.Tensor, mu: torch.Tensor, nu: torch.Tensor,
                gnorm: torch.Tensor, s: Scalars) -> None:
    """One leaf through the kernel: p, mu and nu (contiguous, float32 or
    bfloat16) updated in place from g (of their dtype, made contiguous
    here), the global norm (0-d float32), all on one CUDA device, and
    ``s``, the scalars rounded to p's dtype; the clip factor is formed on
    the device. Raises for anything the kernel does not take; there is no
    fallback. An empty leaf launches nothing."""
    _check(g, p, mu, nu, gnorm)
    if p.numel() == 0:
        return
    g = g.contiguous()
    scalars = (ctypes.c_float * len(s))(*s)
    lib = build.library()
    dev = p.device
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        fused_adamw.launches += 1
        err = lib.rtt_fused_adamw(g.data_ptr(), p.data_ptr(), mu.data_ptr(), nu.data_ptr(),
                                  gnorm.data_ptr(), p.numel(), int(p.dtype == torch.bfloat16),
                                  scalars, stream)
    build.check(err, "fused_adamw")
    # the kernel writes behind autograd's back: mark the in-place change
    torch.autograd.graph.increment_version((p, mu, nu))


fused_adamw.launches = 0


def adamw_update(gs: List[torch.Tensor], ps: List[torch.Tensor], mus: List[torch.Tensor],
                 nus: List[torch.Tensor], gnorm: torch.Tensor, hp: AdamWStep) -> None:
    """Clip and AdamW over the leaves, in place: one ``fused_adamw`` launch
    a leaf when the parameters lie on a CUDA device, else the plain loop."""
    if not ps:
        return
    if ps[0].device.type != "cuda":
        adamw_update_plain(gs, ps, mus, nus, gnorm, hp)
        return
    by_dtype = rounded(hp, (p.dtype for p in ps))
    for g, p, mu, nu in zip(gs, ps, mus, nus):
        fused_adamw(g, p, mu, nu, gnorm, by_dtype[p.dtype])
