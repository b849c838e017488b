"""LLM serving engine, configuration and LoRA folding of the port
(counterpart of ``ray_tpu/llm``), ``LlamaActor``, the model held by a
runtime actor, and the Serve deployments (``LLMServer``, ``OpenAIServer``,
``build_llm_app``, ``build_openai_app``); batch inference waits for Data."""

from ._internal.engine import GenRequest, LlamaEngine
from ._internal.actor import LlamaActor
from .config import LLMConfig, save_params_npz
from .lora import apply_lora, load_lora_adapter
from .serve import LLMServer, OpenAIServer, build_llm_app, build_openai_app

__all__ = [
    "GenRequest",
    "LLMConfig",
    "LLMServer",
    "LlamaActor",
    "LlamaEngine",
    "OpenAIServer",
    "apply_lora",
    "build_llm_app",
    "build_openai_app",
    "load_lora_adapter",
    "save_params_npz",
]
