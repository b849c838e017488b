"""LLM serving engine, configuration and LoRA folding of the port
(counterpart of ``ray_tpu/llm``), ``LlamaActor``, the model held by a
runtime actor, and the Serve deployments (``LLMServer``, ``OpenAIServer``,
``build_llm_app``, ``build_openai_app``) and batch inference over a
Dataset (``build_llm_processor``)."""

from ._internal.engine import GenRequest, LlamaEngine
from ._internal.actor import LlamaActor
from .batch import build_llm_processor
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
    "build_llm_processor",
    "build_openai_app",
    "load_lora_adapter",
    "save_params_npz",
]

from .._private import usage as _usage

_usage.record_library_usage("llm")
