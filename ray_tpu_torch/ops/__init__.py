"""Operators of the port: attention and the fused lm-head cross-entropy,
each a hand-written Hopper kernel with a plain PyTorch version beside it,
and the MoE routing and expert FFN (einsums in the reference too, so plain
PyTorch here)."""

from .attention import flash_attention
from .cuda_ce import fused_cross_entropy, xla_cross_entropy
from .moe import MoEConfig, init_moe_params, moe_ffn, top_k_gating

__all__ = [
    "MoEConfig",
    "flash_attention",
    "fused_cross_entropy",
    "init_moe_params",
    "moe_ffn",
    "top_k_gating",
    "xla_cross_entropy",
]
