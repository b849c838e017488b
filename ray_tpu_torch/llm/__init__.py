"""LLM serving engine, configuration and LoRA folding of the port
(counterpart of ``ray_tpu/llm``), and ``LlamaActor``, the model held by a
runtime actor; the Serve deployment and batch inference wait for Serve
and Data."""

from ._internal.engine import GenRequest, LlamaEngine
from ._internal.actor import LlamaActor
from .config import LLMConfig, save_params_npz
from .lora import apply_lora, load_lora_adapter

__all__ = [
    "GenRequest",
    "LLMConfig",
    "LlamaActor",
    "LlamaEngine",
    "apply_lora",
    "load_lora_adapter",
    "save_params_npz",
]
