"""LLM deployment configuration and TP x PP placement sizing, PyTorch port
of ``ray_tpu/llm/config.py``.

``LLMConfig`` has the reference's fields in the reference's order, so
positional and keyword construction bind alike. ``placement_bundles()``
is the same arithmetic; its resource key defaults to "GPU" here (the
reference's default is "TPU"). Parameters come from a ``.npz`` in the
flat ``/``-path format (``save_params_npz`` below, or the JAX package's)
or from a seeded initialisation. The orbax checkpoint branch is not
ported: it raises.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from .._private.device import DeviceLike, resolve_device
from ..models import llama
from ..models.convert import load_params_npz, params_from_numpy


@dataclass
class LLMConfig:
    """Declarative model + engine config for serving and batch inference."""

    model_id: str = "base"            # name OpenAI-style bodies use for
    # the base model ({"model": model_id} routes to base, not a LoRA)
    model_config: Any = None          # a llama.LlamaConfig; None = LLAMA_TINY
    checkpoint_path: Optional[str] = None  # .npz; None = seeded init
    tensor_parallel_size: int = 1
    pipeline_parallel_size: int = 1
    max_batch_size: int = 8
    max_seq_len: int = 512
    accelerator_type: str = "GPU"
    # engine extras (temperature defaults etc.)
    engine_kwargs: Dict[str, Any] = field(default_factory=dict)
    # LoRA multiplexing: {"dynamic_lora_loading_path": dir with
    # <adapter_id>.npz, "max_adapters_per_replica": 4, "scale": 1.0}
    lora_config: Optional[Dict[str, Any]] = None

    def placement_bundles(self) -> Tuple[List[Dict[str, float]], str]:
        """(bundles, strategy): one bundle of tp devices per pp rank.

        pp == 1  -> a single PACK bundle with tp devices (one host).
        pp  > 1  -> SPREAD, one tp-device bundle per pipeline stage:
        stages go between hosts, tensor parallelism stays on one host.
        """
        tp = self.tensor_parallel_size
        pp = self.pipeline_parallel_size
        res_key = self.accelerator_type if self.accelerator_type else "GPU"
        if pp == 1:
            return [{res_key: float(tp), "CPU": 1.0}], "PACK"
        return [{res_key: float(tp), "CPU": 1.0} for _ in range(pp)], "SPREAD"

    def load_params(self, device: DeviceLike = None):
        """Materialize model params on ``device`` (the GPU unless "cpu" is
        asked): from ``checkpoint_path`` if given, else an init seeded 0."""
        dev = resolve_device(device)
        cfg = self.model_config or llama.LLAMA_TINY
        if not self.checkpoint_path:
            gen = torch.Generator(device=dev)
            gen.manual_seed(0)
            return llama.init_params(gen, cfg, dev)
        if not self.checkpoint_path.endswith(".npz"):
            raise NotImplementedError(
                f"{self.checkpoint_path}: only .npz checkpoints are ported "
                "(orbax directories are not)")
        return params_from_numpy(load_params_npz(self.checkpoint_path), dev)


def save_params_npz(params, path: str) -> None:
    """Flat .npz export under '/'-joined tree paths. numpy has no
    bfloat16, so a bf16 tensor is written as f32, which holds it exactly;
    every other tensor in its own dtype."""
    def host(t):
        t = torch.as_tensor(t).detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()

    np.savez(path, **{k: host(v) for k, v in _flatten(params).items()})


def _flatten(tree, prefix=""):
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}{k}/"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}{i}/"))
    else:
        out[prefix[:-1]] = tree
    return out
