"""Carry parameters over from the JAX package.

``params_from_numpy`` turns a JAX parameter tree, given as numpy arrays
(``jax.tree.map(np.asarray, params)``), into the port's tensors under the
same key names. ``load_params_npz`` reads the flat ``/``-path ``.npz``
format of ``ray_tpu/llm/config.py`` ``save_params_npz``, through the
port's own copy of that format's ``_unflatten``.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from .._private.device import DeviceLike, resolve_device


def params_from_numpy(tree: Any, device: DeviceLike = None,
                      dtype: Optional[torch.dtype] = None) -> Any:
    """Same tree with every array as a tensor on ``device`` (the GPU unless
    "cpu" is asked), in its own dtype or in ``dtype`` when given."""
    dev = resolve_device(device)

    def conv(node):
        if isinstance(node, dict):
            return {k: conv(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(conv(v) for v in node)
        t = torch.from_numpy(np.array(node))  # a writable copy
        return t.to(device=dev, dtype=dtype or t.dtype)

    return conv(tree)


def load_params_npz(path: str) -> Any:
    """Parameter tree of numpy arrays from a flat ``/``-path ``.npz``."""
    with np.load(path) as data:
        return _unflatten({k: data[k] for k in data.files})


def _unflatten(flat: Dict[str, Any]):
    root: dict = {}
    for key, value in flat.items():
        parts = key.split("/")
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = value
    return _listify(root)


def _listify(node):
    if not isinstance(node, dict):
        return node
    if node and all(k.isdigit() for k in node):
        return [_listify(node[k]) for k in sorted(node, key=int)]
    return {k: _listify(v) for k, v in node.items()}
