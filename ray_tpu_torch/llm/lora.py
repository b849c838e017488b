"""LoRA adapters for served models, PyTorch port of ``ray_tpu/llm/lora.py``.

Adapters are FOLDED into the weights at load time (W' = W + scale * A @ B)
and the folded model runs as its own engine: the shapes do not change,
and decode batches stay uniform.

Adapter file format (.npz): for each adapted parameter, either
  "<path>.delta"            full-shape delta tensor, or
  "<path>.A" + "<path>.B"   factored (prod(leading_dims), r) x (r, last)
with "<path>" the '/'-joined tree path (e.g. "blocks/wq", "lm_head").
An optional scalar "scale" overrides the caller's scale.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from .config import _flatten


def load_lora_adapter(path: str) -> Dict[str, np.ndarray]:
    """Read an adapter .npz into {key: array}."""
    with np.load(path) as data:
        return {k: data[k] for k in data.files}


def _tensor(arr, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(arr), device=device).to(dtype)


def apply_lora(params: Dict[str, Any], adapter: Dict[str, np.ndarray],
               scale: float = 1.0) -> Dict[str, Any]:
    """Fold an adapter into a COPY of params: each adapted leaf becomes a
    new tensor in its own dtype and on its own device; every other leaf
    is the same tensor object (shared, not copied). A delta is cast to the
    leaf's dtype before it is scaled; A @ B is formed in f32, reshaped to
    the leaf's shape and cast to its dtype; the scale is rounded to that
    dtype too. Unknown paths, unpaired factors and unrecognised entries
    raise ``ValueError``."""
    if "scale" in adapter:
        scale = float(adapter["scale"])
    deltas: Dict[str, Any] = {}
    for key, arr in adapter.items():
        if key == "scale":
            continue
        if key.endswith(".delta"):
            deltas[key[:-6]] = ("delta", arr)
        elif key.endswith(".A"):
            path = key[:-2]
            b = adapter.get(path + ".B")
            if b is None:
                raise ValueError(f"adapter has {key} but no {path}.B")
            deltas[path] = ("ab", arr, b)
        elif key.endswith(".B"):
            if adapter.get(key[:-2] + ".A") is None:
                raise ValueError(f"adapter has {key} but no {key[:-2]}.A")
        else:
            raise ValueError(
                f"unrecognized adapter entry {key!r} "
                "(expected <path>.delta or <path>.A/.B)")

    flat = _flatten(params)
    for path in deltas:
        if path not in flat:
            raise ValueError(
                f"adapter targets unknown parameter {path!r}; known: {sorted(flat)[:8]}...")

    def fold(node, prefix=""):
        if isinstance(node, dict):
            return {k: fold(v, f"{prefix}{k}/") for k, v in node.items()}
        spec = deltas.get(prefix[:-1])
        if spec is None:
            return node  # shared leaf, no copy
        # the scale rounded to the leaf's dtype first, as JAX rounds a
        # weakly typed Python scalar
        s = torch.tensor(scale).to(node.dtype).item()
        if spec[0] == "delta":
            return node + s * _tensor(spec[1], node.dtype, node.device)
        _, a, b = spec
        delta = (_tensor(a, torch.float32, node.device)
                 @ _tensor(b, torch.float32, node.device))
        return node + s * delta.reshape(node.shape).to(node.dtype)

    return fold(params)
