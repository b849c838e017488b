"""Mixtral-style MoE Llama, PyTorch port of ``ray_tpu/models/moe_llama.py``:
the Llama attention stack with every dense FFN replaced by a top-k routed
expert FFN (``ops/moe.py``).

As in the reference:
- the attention sublayer is the Llama one (``models/llama.py``), so
  ``attention_impl="flash"`` runs the hand-written attention kernels;
- the router stays f32, the expert products run in ``config.dtype``;
- each block returns (x, aux); the aux losses are summed over the layers
  and divided by ``n_layers``;
- the LOSS mask (``batch["mask"]``) and the ROUTING mask
  (``batch["input_mask"]``, padding only) are different things.

``remat`` runs each block under ``torch.utils.checkpoint`` when grad is
enabled, as the dense model does. The loss is the masked CE on full f32
logits, as in the reference: the fused CE kernel is not on this path, and
``ce_impl="fused"`` raises rather than run the plain CE.

Over a mesh the attention half is sharded as the dense model's, and the
experts over ``expert`` (``param_specs``; ``ops/moe.py``). The router's
aux loss is computed alike on every rank, so each rank's share of it is
1 / world (``parallel/comm.py``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from .._private.device import DeviceLike, resolve_device
from ..ops.moe import MoEConfig, moe_ffn
from ..parallel import comm
from ..parallel.mesh import P
from . import llama
from .llama import (
    LlamaConfig,
    _layers,
    attention_sublayer,
    attn_param_count,
    init_attn_params,
    make_dense_init,
    masked_ce,
    rms_norm,
    unpack_batch,
)

Params = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class MoELlamaConfig(LlamaConfig):
    n_experts: int = 8
    experts_per_token: int = 2
    capacity_factor: float = 1.25
    router_aux_coeff: float = 0.01

    @property
    def moe(self) -> MoEConfig:
        return MoEConfig(d_model=self.dim, d_ff=self.ffn_dim, n_experts=self.n_experts,
                         k=self.experts_per_token, capacity_factor=self.capacity_factor)


# Stock shapes (public Mixtral architecture table) and the test size.
MIXTRAL_8X7B = MoELlamaConfig(
    vocab_size=32000, dim=4096, n_layers=32, n_heads=32, n_kv_heads=8,
    ffn_dim=14336, max_seq_len=32768, rope_theta=1e6,
    n_experts=8, experts_per_token=2,
)
MOE_TINY = MoELlamaConfig(
    vocab_size=512, dim=64, n_layers=2, n_heads=4, n_kv_heads=2,
    ffn_dim=128, max_seq_len=128, rope_theta=10000.0, remat=False,
    n_experts=4, experts_per_token=2,
)


def param_specs(config: MoELlamaConfig) -> Dict[str, Any]:
    """The dense model's attention specs, and the experts (L, E, D, F) on
    ``expert``, each expert's matrices split fsdp/model as the dense FFN
    (``ray_tpu/models/moe_llama.py:70``)."""
    specs = llama.param_specs(config)
    blocks = {k: specs["blocks"][k] for k in
              ("attn_norm", "wq", "wk", "wv", "wo", "mlp_norm")}
    blocks.update({
        "router": P(None, "fsdp", None),                 # (L, D, E)
        "w_gate": P(None, "expert", "fsdp", "model"),    # (L, E, D, F)
        "w_up": P(None, "expert", "fsdp", "model"),
        "w_down": P(None, "expert", "model", "fsdp"),    # (L, E, F, D)
    })
    return {**specs, "blocks": blocks}


def init_params(generator: torch.Generator, config: MoELlamaConfig,
                device: DeviceLike = None) -> Params:
    """Stacked-layer params on ``device`` (the GPU unless "cpu" is asked),
    ``generator`` living there. Draw order: embed, wq, wk, wv, wo, router,
    w_gate, w_up, w_down, lm_head. The router is f32 whatever
    ``param_dtype`` is."""
    c = config
    dev = resolve_device(device)
    dense = make_dense_init(c, dev)
    L, E = c.n_layers, c.n_experts
    embed = dense(generator, (c.vocab_size, c.dim), c.dim)
    attn = init_attn_params(c, generator, dense, dev)
    router = torch.randn((L, c.dim, E), generator=generator, dtype=torch.float32,
                         device=dev) / math.sqrt(c.dim)
    return {
        "embed": embed,
        "blocks": {
            **attn,
            "router": router,
            "w_gate": dense(generator, (L, E, c.dim, c.ffn_dim), c.dim),
            "w_up": dense(generator, (L, E, c.dim, c.ffn_dim), c.dim),
            "w_down": dense(generator, (L, E, c.ffn_dim, c.dim), c.ffn_dim),
        },
        "final_norm": torch.ones((c.dim,), dtype=c.param_dtype, device=dev),
        "lm_head": dense(generator, (c.dim, c.vocab_size), c.dim),
    }


def _count(config: MoELlamaConfig, experts: int) -> int:
    c = config
    moe = c.dim * c.n_experts + 3 * experts * c.dim * c.ffn_dim
    return c.vocab_size * c.dim * 2 + c.n_layers * (attn_param_count(c) + moe) + c.dim


def param_count(config: MoELlamaConfig) -> int:
    return _count(config, config.n_experts)


def active_param_count(config: MoELlamaConfig) -> int:
    """Params touched per token (k of E experts): the count for MFU."""
    return _count(config, config.experts_per_token)


def block_fn(config: MoELlamaConfig, x: torch.Tensor, layer: Dict[str, torch.Tensor],
             cos: torch.Tensor, sin: torch.Tensor,
             mask: Optional[torch.Tensor] = None, mesh=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """One MoE transformer block. Returns (x, aux_loss). Over a mesh,
    ``layer`` holds this rank's shards, gathered over fsdp here."""
    c = config
    if mesh is not None:
        layer = comm.gather_layer(layer, param_specs(c)["blocks"], mesh, ("fsdp",))
    x = attention_sublayer(c, x, layer, cos, sin, mesh)
    h = rms_norm(x, layer["mlp_norm"], c.norm_eps)
    moe_params = {
        "router": layer["router"],
        "w_gate": layer["w_gate"].to(c.dtype),
        "w_up": layer["w_up"].to(c.dtype),
        "w_down": layer["w_down"].to(c.dtype),
    }
    token_axes = () if mesh is None else tuple(
        (llama.BATCH_AXES, ("seq",) if llama.seq_split(c, mesh) else ()))
    out, aux = moe_ffn(moe_params, h.to(c.dtype), c.moe, mask=mask, mesh=mesh,
                       token_axes=token_axes)
    return x + out.to(x.dtype), aux


def forward(params: Params, tokens: torch.Tensor, config: MoELlamaConfig,
            mask: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """tokens (B, S) int -> (logits (B, S, V) f32, aux_loss). ``mask`` (B, S)
    keeps padding out of expert capacity and the balance statistics. Over
    a mesh, tokens, mask and logits are this rank's rows (and sequence
    block under ring attention)."""
    c = config
    mesh = comm.active_mesh()
    S = tokens.shape[1]
    x = llama.embed_weight(params, c, mesh).to(c.dtype)[tokens.long()]
    cos, sin = llama.rope_for(c, S, x.device, mesh)
    remat = c.remat and torch.is_grad_enabled()
    aux_sum = torch.zeros((), dtype=torch.float32, device=x.device)
    for layer in _layers(params["blocks"]):
        if remat:
            x, aux = checkpoint(block_fn, c, x, layer, cos, sin, mask, mesh,
                                use_reentrant=False)
        else:
            x, aux = block_fn(c, x, layer, cos, sin, mask, mesh)
        aux_sum = aux_sum + aux
    x = rms_norm(x, params["final_norm"], c.norm_eps)
    logits = (x @ llama.head_weight(params, c, mesh)).float()
    if c.logit_softcap:
        logits = torch.tanh(logits / c.logit_softcap) * c.logit_softcap
    return logits, aux_sum / c.n_layers


def loss_fn(params: Params, batch: Dict[str, torch.Tensor],
            config: MoELlamaConfig) -> torch.Tensor:
    """Next-token cross entropy + router_aux_coeff x the router aux loss.
    An SFT loss mask ("mask") zeroes positions whose tokens still route;
    routing excludes only padding, given as batch["input_mask"] aligned
    with the model inputs (sliced [:, :-1] when the batch has "tokens").
    Over a mesh the batch is the global one and the result the global loss."""
    if config.ce_impl != "xla":
        raise ValueError(f"ce_impl={config.ce_impl!r} not applicable: the MoE loss is the "
                         "masked CE on full logits, as in the reference")
    mesh = comm.active_mesh()
    inputs, targets, mask = unpack_batch(batch)
    input_mask = batch.get("input_mask")
    if input_mask is not None and "tokens" in batch:
        input_mask = input_mask[:, :-1]  # aligned with inputs = tokens[:, :-1]
    if mesh is None:
        logits, aux = forward(params, inputs, config, mask=input_mask)
        return masked_ce(logits, targets, mask) + config.router_aux_coeff * aux
    inputs, targets, mask = llama.local_batch(config, mesh, inputs, targets, mask)
    if input_mask is not None:
        input_mask = llama.local_batch(config, mesh, input_mask, None, None)[0]
    logits, aux = forward(params, inputs, config, mask=input_mask)
    # every rank computes the same aux loss: its share is 1 / world of it
    share = (comm.mean_share(llama.token_nll(logits, targets), mask, mesh,
                             llama.split_axes(config, mesh))
             + config.router_aux_coeff * aux / mesh.size())
    return comm.loss_total(share, mesh)
