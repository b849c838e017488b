"""Mixture-of-Experts: top-k routing and the routed expert FFN, PyTorch
port of ``ray_tpu/ops/moe.py``.

The reference writes these as einsums with no Pallas kernel, so plain
PyTorch is the port, and it keeps the reference's formulation: a dense
(T, E, C) dispatch tensor of capacity-bounded one-hots and a combine
tensor of gate weights, each taken into the experts by an einsum (no
gather or scatter, static shapes). The outputs are the reference's:

- top-k keeps the lower expert index first among tied probabilities, as
  ``jax.lax.top_k`` does (a stable descending sort; ``torch.topk`` makes
  no promise about ties);
- an assignment whose slot is past the capacity is dropped: its one-hot
  over the capacity is a zero row, as ``jax.nn.one_hot`` gives for an
  index out of range (``F.one_hot`` would raise);
- the priority order is choice-major (every token's first choice before
  any second choice), positions are an int32 cumulative count, and the
  capacity is max(min_capacity, ceil(T k capacity_factor / E));
- the router runs in f32, the expert products in x's dtype, and dispatch
  and combine are cast to x's dtype before their einsums.

Over a mesh (``mesh``, more than one rank) the experts are split over the
``expert`` axis (each rank holds E / ep of them, and their ffn hidden may be
split over ``model``). Routing is computed on the tokens of every rank,
gathered over the axes ``token_axes`` splits them on, as GSPMD computes the
reference's on the global batch; each rank runs the dispatch and combine
of its own experts, the result is summed over ``expert`` and ``model``, and
each rank keeps its own tokens.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from .._private.device import DeviceLike, resolve_device


class GatingResult(NamedTuple):
    dispatch: torch.Tensor     # (T, E, C) one-hot dispatch weights in {0, 1}
    combine: torch.Tensor      # (T, E, C) combine weights (gate probs)
    aux_loss: torch.Tensor     # scalar load-balance loss
    expert_load: torch.Tensor  # (E,) fraction of tokens per expert


def top_k_gating(logits: torch.Tensor, *, k: int = 2, capacity_factor: float = 1.25,
                 min_capacity: int = 4,
                 token_mask: Optional[torch.Tensor] = None) -> GatingResult:
    """Softmax router with top-k, capacity dropping and the Switch
    load-balancing aux loss. logits (T, E); token_mask (T,) 1 = real
    token, 0 = padding (padding takes no expert, no capacity, and no part
    in the balance statistics)."""
    T, E = logits.shape
    dev = logits.device
    probs = torch.softmax(logits.float(), dim=-1)
    capacity = max(min_capacity, int(math.ceil(T * k * capacity_factor / E)))

    # a stable descending sort keeps the lower index first among ties
    gate_vals, gate_idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate_vals, gate_idx = gate_vals[:, :k], gate_idx[:, :k]
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True), min=1e-9)

    # position of each (token, choice) within its expert's capacity: the
    # count of earlier assignments to the same expert
    onehot = F.one_hot(gate_idx, E).to(torch.int32)  # (T, k, E)
    if token_mask is not None:
        m32 = token_mask.float().reshape(T)
        gate_vals = gate_vals * m32[:, None]
        onehot = onehot * token_mask.to(torch.int32).reshape(T, 1, 1)
    flat = onehot.reshape(T * k, E)
    # choice-major priority: every first choice before any second one
    order = torch.arange(T * k, device=dev).reshape(T, k).T.reshape(-1)
    flat_ordered = flat[order]
    pos_ordered = torch.cumsum(flat_ordered, dim=0, dtype=torch.int32) - flat_ordered
    pos = pos_ordered[torch.argsort(order)].reshape(T, k, E)
    slot = (pos * onehot).sum(-1)  # (T, k) slot within the expert
    keep = slot < capacity

    keep_f = keep[:, :, None, None].float()
    if token_mask is not None:
        keep_f = keep_f * token_mask.float().reshape(T, 1, 1, 1)
    # one-hot over the capacity by comparison: a slot past it is a zero row
    slot_onehot = (slot[..., None] == torch.arange(capacity, device=dev)).float()
    disp = (F.one_hot(gate_idx, E).float()[..., None]
            * slot_onehot[:, :, None, :] * keep_f)  # (T, k, E, C)
    dispatch = disp.sum(1)
    combine = (disp * gate_vals[:, :, None, None]).sum(1)

    # Switch aux loss E * sum(f_e * p_e), over real tokens when masked
    if token_mask is not None:
        m32 = token_mask.float().reshape(T)
        denom = torch.clamp(m32.sum(), min=1.0)
        me = (probs * m32[:, None]).sum(0) / denom
        ce = onehot.sum(1).float().sum(0) / denom
    else:
        me = probs.mean(0)                    # mean router prob per expert
        ce = onehot.sum(1).float().mean(0)    # fraction routed (before drops)
    aux = (me * ce).sum() * E
    return GatingResult(dispatch, combine, aux, ce)


@dataclass(frozen=True)
class MoEConfig:
    d_model: int
    d_ff: int
    n_experts: int
    k: int = 2
    capacity_factor: float = 1.25


def init_moe_params(generator: torch.Generator, config: MoEConfig,
                    dtype: torch.dtype = torch.bfloat16, device: DeviceLike = None):
    """Router (D, E) in f32 and SwiGLU experts (E, D, F), (E, F, D) in
    ``dtype`` on ``device`` (the GPU unless "cpu" is asked), drawn from
    ``generator`` in that order."""
    dev = resolve_device(device)
    E, D, Fd = config.n_experts, config.d_model, config.d_ff

    def normal(shape):
        return torch.randn(shape, generator=generator, dtype=torch.float32, device=dev)

    s_in, s_out = 1.0 / math.sqrt(D), 1.0 / math.sqrt(Fd)
    return {
        "router": normal((D, E)) * s_in,
        "w_gate": (normal((E, D, Fd)) * s_in).to(dtype),
        "w_up": (normal((E, D, Fd)) * s_in).to(dtype),
        "w_down": (normal((E, Fd, D)) * s_out).to(dtype),
    }


def moe_ffn(params: dict, x: torch.Tensor, config: MoEConfig,
            mask: Optional[torch.Tensor] = None, mesh=None,
            token_axes: Tuple[Tuple[str, ...], ...] = ()) -> Tuple[torch.Tensor, torch.Tensor]:
    """Routed SwiGLU expert FFN: x (B, S, D), mask (B, S) 1 = real token ->
    (out (B, S, D) in x's dtype, aux_loss f32). Over ``mesh``, x is this
    rank's block of tokens, split along dim d over the axes
    ``token_axes[d]`` (major first), and ``params`` hold its experts."""
    if mesh is not None:
        return _moe_ffn_sharded(params, x, config, mask, mesh, token_axes)
    B, S, D = x.shape
    T = B * S
    xt = x.reshape(T, D)
    logits = xt.float() @ params["router"].float()
    gate = top_k_gating(logits, k=config.k, capacity_factor=config.capacity_factor,
                        token_mask=None if mask is None else mask.reshape(T))
    xe = torch.einsum("td,tec->ecd", xt, gate.dispatch.to(x.dtype))       # (E, C, D)
    h = (F.silu(torch.einsum("ecd,edf->ecf", xe, params["w_gate"]))
         * torch.einsum("ecd,edf->ecf", xe, params["w_up"]))
    ye = torch.einsum("ecf,efd->ecd", h, params["w_down"])                # (E, C, D)
    out = torch.einsum("ecd,tec->td", ye, gate.combine.to(x.dtype))
    return out.reshape(B, S, D), gate.aux_loss


def _moe_ffn_sharded(params, x, config: MoEConfig, mask, mesh, token_axes):
    from ..parallel import comm
    from ..parallel.mesh import axis_index

    def whole(t):
        for d, axes in enumerate(token_axes):
            for axis in reversed(axes):  # the minor axis first
                t = comm.gather(t, mesh, axis, d)
        return t

    xs = whole(x)
    ms = None if mask is None else whole(mask)
    B, S, D = xs.shape
    T = B * S
    xt = xs.reshape(T, D)
    logits = xt.float() @ params["router"].float()
    gate = top_k_gating(logits, k=config.k, capacity_factor=config.capacity_factor,
                        token_mask=None if ms is None else ms.reshape(T))
    n_local = params["w_gate"].shape[0]
    e0 = axis_index(mesh, "expert") * n_local
    mine = slice(e0, e0 + n_local)
    xe = torch.einsum("td,tec->ecd", xt, gate.dispatch[:, mine].to(x.dtype))
    h = (F.silu(torch.einsum("ecd,edf->ecf", xe, params["w_gate"]))
         * torch.einsum("ecd,edf->ecf", xe, params["w_up"]))
    ye = torch.einsum("ecf,efd->ecd", h, params["w_down"])
    out = torch.einsum("ecd,tec->td", ye, gate.combine[:, mine].to(x.dtype))
    out = comm.psum(out, mesh, ("expert", "model")).reshape(B, S, D)
    for d, axes in enumerate(token_axes):
        if axes:
            out = comm.local_part(out, mesh, axes, d)
    return out, gate.aux_loss
