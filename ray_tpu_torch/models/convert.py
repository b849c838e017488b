"""Carry parameters over from the JAX package.

``params_from_numpy`` turns a JAX parameter tree, given as numpy arrays
(``jax.tree.map(np.asarray, params)``), into the port's tensors under the
same key names; ``shard_params`` cuts such a tree into one rank's shards
of a mesh and ``gather_params`` puts shards back together (``shard_tensor``
and ``gather_tensor`` do it for one leaf). ``load_params_npz`` reads the flat ``/``-path ``.npz``
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


def _map_with_specs(fn, tree: Any, specs: Any) -> Any:
    from ..parallel.mesh import P

    if isinstance(specs, P):
        return fn(tree, specs)
    if isinstance(specs, dict):
        return {k: _map_with_specs(fn, tree[k], specs[k]) for k in specs}
    return type(tree)(_map_with_specs(fn, t, s) for t, s in zip(tree, specs))


def shard_tensor(leaf: Any, mesh, spec, dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """This rank's shard of one full array (numpy or a tensor): cut along
    every dimension ``spec`` names, as a contiguous tensor of its own on
    the mesh's device (in its own dtype or ``dtype``), detached. A
    dimension that its axes do not divide raises."""
    from ..parallel.mesh import mesh_device, shard_slice

    t = leaf.detach() if isinstance(leaf, torch.Tensor) else torch.from_numpy(np.array(leaf))
    index = tuple(shard_slice(mesh, e, t.shape[d]) for d, e in enumerate(spec))
    return t[index].to(device=mesh_device(mesh), dtype=dtype or t.dtype).clone().contiguous()


def gather_tensor(t: torch.Tensor, mesh, spec) -> torch.Tensor:
    """The full array from this rank's shard: all-gathered over every axis
    ``spec`` names, the minor axis of a dimension first. Every rank of the
    mesh must call it."""
    from ..parallel.comm import all_gather
    from ..parallel.mesh import spec_axes

    t = t.detach()
    for d, e in enumerate(spec):
        for axis in reversed(spec_axes(e)):
            t = all_gather(t, mesh, axis, d)
    return t


def shard_params(params: Any, mesh, specs: Any, dtype: Optional[torch.dtype] = None) -> Any:
    """This rank's shards of full parameters (numpy arrays, from the JAX
    package, or tensors): ``shard_tensor`` of each leaf with its spec in
    ``specs``. A dimension that its axes do not divide raises."""
    return _map_with_specs(lambda leaf, spec: shard_tensor(leaf, mesh, spec, dtype),
                           params, specs)


def gather_params(state: Any, mesh, specs: Any) -> Any:
    """Full parameters from this rank's shards: every leaf all-gathered over
    the axes its spec names (a TrainState gives its ``params``). Every rank
    of the mesh must call it."""
    params = state.params if hasattr(state, "params") and hasattr(state, "opt_state") else state
    return _map_with_specs(lambda t, spec: gather_tensor(t, mesh, spec), params, specs)
