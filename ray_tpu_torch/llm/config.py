"""LLM deployment configuration and TP x PP placement sizing, PyTorch port
of ``ray_tpu/llm/config.py``.

``LLMConfig`` has the reference's fields in the reference's order, so
positional and keyword construction bind alike. ``placement_bundles()``
is the same arithmetic; its resource key defaults to "GPU" here (the
reference's default is "TPU"). Parameters come from a ``.npz`` in the
flat ``/``-path format (``save_params_npz`` below, or the JAX package's),
from a checkpoint directory of the Train stack (the counterpart of the
reference's orbax branch: a parameter tree written by
``train.Checkpoint.from_torch``, restored onto the model's tree and cast
to its ``param_dtype``), or from a seeded initialisation.
"""

from __future__ import annotations

from dataclasses import dataclass, field
import os
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
    checkpoint_path: Optional[str] = None  # .npz or Checkpoint.from_torch
    # dir; None = seeded init
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
        asked): from ``checkpoint_path`` if given (a ``.npz``, or a
        directory written by ``train.Checkpoint.from_torch(params, dir)``),
        else an init seeded 0."""
        dev = resolve_device(device)
        cfg = self.model_config or llama.LLAMA_TINY
        if not self.checkpoint_path:
            gen = torch.Generator(device=dev)
            gen.manual_seed(0)
            return llama.init_params(gen, cfg, dev)
        if self.checkpoint_path.endswith(".npz"):
            return params_from_numpy(load_params_npz(self.checkpoint_path), dev)
        return _restore_dir(self.checkpoint_path, cfg, dev)


def _restore_dir(path: str, cfg, dev: torch.device):
    """The parameter tree that ``train.Checkpoint.from_torch(params, path)``
    wrote, on ``dev``, in the structure and leaf shapes of
    ``llama.init_params`` for ``cfg`` (a template on the meta device, so
    nothing is drawn), each leaf cast to the template's dtype after the
    load, as orbax casts to its restore target. A tree of another
    structure and a leaf of another shape raise ValueError."""
    from ..train._checkpoint import _TORCH_FILE, Checkpoint

    ckpt = Checkpoint(path)
    if not os.path.isfile(os.path.join(ckpt.path, _TORCH_FILE)):
        raise FileNotFoundError(
            f"{path}: no {_TORCH_FILE}; write the parameters with "
            "train.Checkpoint.from_torch(params, path)")
    template = llama.init_params(torch.Generator(), cfg, "meta")
    try:
        restored = ckpt.to_torch(target=template, device=dev)
    except ValueError as e:
        raise ValueError(
            f"{path}: {e}; a TrainState checkpoint is not accepted: save "
            "state.params with train.Checkpoint.from_torch(state.params, path)") from None
    return _cast_like(template, restored, path, "")


def _cast_like(template, restored, path: str, where: str):
    """``restored`` with every leaf checked against the template's shape
    and cast to its dtype (no copy where the dtype is already right)."""
    if isinstance(template, dict):
        return {k: _cast_like(v, restored[k], path, f"{where}.{k}") for k, v in template.items()}
    if not isinstance(restored, torch.Tensor) or restored.shape != template.shape:
        got = tuple(restored.shape) if isinstance(restored, torch.Tensor) else type(restored).__name__
        raise ValueError(f"{path}: checkpoint at {where} holds {got}, the model "
                         f"{tuple(template.shape)}")
    return restored.to(template.dtype)


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
