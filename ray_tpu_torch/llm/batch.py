"""Batch LLM inference over ray_tpu_torch.data.

Parity: python/ray/llm/_internal/batch/ (vllm_engine_stage + Processor
configs) — a Dataset pipeline stage that runs prompts through a pool of
engine actors via ``map_batches(compute="actors")``, one engine per
actor. ``accelerator_type="GPU"`` (``LLMConfig``'s default) asks each pool
actor for ``tensor_parallel_size`` GPUs through ``num_gpus``, the pinned
resource, "TPU" for as many through ``num_tpus`` (a countable resource
here), and ``""`` for no accelerator. The engine runs on
``engine_kwargs.get("device")``: None is the GPU, as in ``LLMServer``.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

from .config import LLMConfig


class _EngineUDF:
    """Callable-class UDF: builds the engine once per actor; each batch
    generates completions for the 'prompt_ids' column."""

    def __init__(self, llm_config: LLMConfig, max_tokens: int,
                 temperature: float):
        from ._internal.engine import LlamaEngine

        from ray_tpu_torch.models import llama

        self.max_tokens = max_tokens
        self.temperature = temperature
        self.engine = LlamaEngine(
            llm_config.model_config or llama.LLAMA_TINY,
            llm_config.load_params(llm_config.engine_kwargs.get("device")),
            max_batch=llm_config.max_batch_size,
            max_seq=llm_config.max_seq_len,
            **llm_config.engine_kwargs,
        )

    def __call__(self, batch: Dict[str, Any]) -> Dict[str, Any]:
        from ._internal.engine import GenRequest

        prompts = [list(map(int, p)) for p in batch["prompt_ids"]]
        reqs = [
            GenRequest(
                request_id=str(i), prompt_ids=p,
                max_tokens=self.max_tokens, temperature=self.temperature,
            )
            for i, p in enumerate(prompts)
        ]
        # continuous batching across the whole micro-batch
        pending = list(reqs)
        while pending or self.engine.num_active():
            while pending and self.engine.has_capacity():
                self.engine.add_request(pending.pop(0))
            if self.engine.num_active():
                self.engine.step()
        import numpy as np

        maxlen = max(len(r.generated) for r in reqs)
        gen = np.full((len(reqs), maxlen), -1, dtype=np.int64)
        for i, r in enumerate(reqs):
            gen[i, : len(r.generated)] = r.generated
        return dict(
            batch,
            generated_ids=gen,
            num_generated=np.array([len(r.generated) for r in reqs]),
        )


def build_llm_processor(
    llm_config: LLMConfig,
    *,
    concurrency: int = 1,
    batch_size: int = 16,
    max_tokens: int = 32,
    temperature: float = 0.0,
):
    """Returns ds -> ds with a 'generated_ids' column (reference:
    build_llm_processor returning a Processor over vLLM stages)."""

    def apply(ds):
        accel = {"GPU": "num_gpus", "TPU": "num_tpus"}.get(llm_config.accelerator_type)
        amount = {accel: llm_config.tensor_parallel_size} if accel else {}
        return ds.map_batches(
            _EngineUDF,
            fn_constructor_args=(llm_config, max_tokens, temperature),
            batch_size=batch_size,
            concurrency=concurrency,
            **amount,
        )

    return apply
