"""Model families of the port (PyTorch counterparts of ``ray_tpu/models``):
dense Llama, MoE Llama and ViT."""

from . import llama, moe_llama, vit
from .convert import load_params_npz, params_from_numpy
from .llama import LLAMA_2_7B, LLAMA_3_8B, LLAMA_3_70B, LLAMA_BENCH, LLAMA_TINY, LlamaConfig
from .moe_llama import MIXTRAL_8X7B, MOE_TINY, MoELlamaConfig
from .vit import VIT_B_16, VIT_L_16, VIT_TINY, ViTConfig

__all__ = [
    "llama", "moe_llama", "vit",
    "LlamaConfig", "LLAMA_2_7B", "LLAMA_3_8B", "LLAMA_3_70B", "LLAMA_BENCH", "LLAMA_TINY",
    "MoELlamaConfig", "MIXTRAL_8X7B", "MOE_TINY",
    "ViTConfig", "VIT_B_16", "VIT_L_16", "VIT_TINY",
    "load_params_npz", "params_from_numpy",
]
