"""Operators of the port: attention and the fused lm-head cross-entropy,
each a hand-written Hopper kernel with a plain PyTorch version beside it,
the MoE routing and expert FFN (einsums in the reference too, so plain
PyTorch here), and the sequence-parallel attentions over a mesh axis (ring
and Ulysses), which run those kernels on each rank's blocks."""

from .attention import flash_attention
from .cuda_ce import fused_cross_entropy, xla_cross_entropy
from .moe import MoEConfig, init_moe_params, moe_ffn, top_k_gating
from .ring_attention import ring_attention, ring_attention_sharded
from .ulysses import ulysses_attention

__all__ = [
    "MoEConfig",
    "flash_attention",
    "fused_cross_entropy",
    "init_moe_params",
    "moe_ffn",
    "ring_attention",
    "ring_attention_sharded",
    "top_k_gating",
    "ulysses_attention",
    "xla_cross_entropy",
]
