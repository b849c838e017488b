"""LLM serving engine, configuration and LoRA folding of the port
(counterpart of ``ray_tpu.llm``; the Serve deployment and batch inference
wait for the runtime)."""

from ._internal.engine import GenRequest, LlamaEngine
from .config import LLMConfig, save_params_npz
from .lora import apply_lora, load_lora_adapter

__all__ = [
    "GenRequest",
    "LLMConfig",
    "LlamaEngine",
    "apply_lora",
    "load_lora_adapter",
    "save_params_npz",
]
