"""A Llama model held by a runtime actor: scoring through the flash
attention and fused cross-entropy kernels, and serving through
``LlamaEngine``.

This is what ``ray_tpu/llm/serve.py``'s ``LLMServer`` asks of its actor
(:33-44: the parameters from ``LLMConfig.load_params``, an engine sized
from ``max_batch_size``, ``max_seq_len`` and ``engine_kwargs``), on the
port's runtime. The Serve deployment itself waits for Serve. Start it
with ``ray_tpu_torch.remote(num_gpus=1)(LlamaActor).remote(llm_config)``
to pin one card to its process; ``device="cpu"`` runs it without one.
"""

from __future__ import annotations

import dataclasses
import hashlib
import os
from typing import Dict, List

import torch

from ..._private.device import DeviceLike, resolve_device
from ...models import llama
from ..config import LLMConfig
from .engine import GenRequest, LlamaEngine, _leaves


def _kernels() -> Dict[str, object]:
    """name -> wrapper carrying the ``launches`` counter, every kernel."""
    from ...ops import cuda_adamw, cuda_attention, cuda_ce

    return {
        "flash_attention_fwd": cuda_attention.flash_attention_fwd,
        "flash_attention_bwd_dkv": cuda_attention.flash_attention_bwd_dkv,
        "flash_attention_bwd_dq": cuda_attention.flash_attention_bwd_dq,
        "fused_ce_fwd": cuda_ce.fused_ce_fwd,
        "fused_ce_bwd_dlog": cuda_ce.fused_ce_bwd_dlog,
        "fused_ce_bwd_dx": cuda_ce.fused_ce_bwd_dx,
        "fused_ce_bwd_dw": cuda_ce.fused_ce_bwd_dw,
        "fused_adamw": cuda_adamw.fused_adamw,
    }


def param_digest(params) -> str:
    """sha256 over the parameter leaves' bytes in tree order."""
    h = hashlib.sha256()
    for t in _leaves(params):
        h.update(t.detach().contiguous().view(torch.uint8).cpu().numpy().tobytes())
    return h.hexdigest()


class LlamaActor:
    """One Llama model in an actor process (plain class: wrap it with
    ``ray_tpu_torch.remote``)."""

    def __init__(self, llm_config: LLMConfig, device: DeviceLike = None):
        self.llm_config = llm_config
        self.device = resolve_device(device)
        self.config = llm_config.model_config or llama.LLAMA_TINY
        self.params = llm_config.load_params(self.device)
        self.engine = LlamaEngine(
            self.config,
            self.params,
            max_batch=llm_config.max_batch_size,
            max_seq=llm_config.max_seq_len,
            device=self.device,
            **llm_config.engine_kwargs,
        )

    def info(self) -> dict:
        """Where the actor runs: its pid, CUDA_VISIBLE_DEVICES, and the
        cards it sees (name and UUID)."""
        out = {
            "pid": os.getpid(),
            "device": str(self.device),
            "cuda_visible_devices": os.environ.get("CUDA_VISIBLE_DEVICES"),
            "device_count": torch.cuda.device_count() if self.device.type == "cuda" else 0,
        }
        if self.device.type == "cuda":
            props = torch.cuda.get_device_properties(self.device)
            out["name"] = props.name
            out["uuid"] = str(props.uuid)
        return out

    def param_digest(self) -> str:
        return param_digest(self.params)

    def score(self, tokens: torch.Tensor) -> float:
        """Mean next-token loss of a (B, S+1) token batch with flash
        attention and the fused cross-entropy (``llama.loss_fn``)."""
        cfg = dataclasses.replace(self.config, attention_impl="flash", ce_impl="fused")
        with torch.inference_mode():
            loss = llama.loss_fn(self.params, {"tokens": tokens.to(self.device)}, cfg)
            return float(loss.item())

    def generate(self, requests: List[GenRequest]) -> Dict[str, List[int]]:
        """Run the requests to completion through the engine, continuously
        batched; returns request id -> generated tokens."""
        pending = list(requests)
        while pending or self.engine.num_active():
            while pending and self.engine.has_capacity():
                req = pending.pop(0)
                if not self.engine.add_request(req):
                    raise RuntimeError(f"request {req.request_id} refused")
            self.engine.step()
        return {r.request_id: list(r.generated) for r in requests}

    def reset_launches(self) -> None:
        for wrapper in _kernels().values():
            wrapper.launches = 0

    def launches(self) -> Dict[str, int]:
        """The kernels' launch counters in this process."""
        return {name: wrapper.launches for name, wrapper in _kernels().items()}

    def kernel_build_seconds(self) -> float:
        """The nvcc seconds this process spent building the kernel library:
        0.0 when it loaded one already built (``_native/build.py``'s cache)."""
        from ..._native import build

        if self.device.type == "cuda":
            build.library()
        return build.build_seconds
