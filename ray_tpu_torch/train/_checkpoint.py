"""Checkpoint: a directory of files, possibly on remote storage.

Port of ``ray_tpu/train/_checkpoint.py`` (reference: python/ray/train/
_checkpoint.py; Checkpoint = path + pyarrow filesystem;
as_directory/to_directory/from_directory). The JAX package's orbax pair
``from_jax``/``to_jax`` becomes ``from_torch``/``to_torch``: a tree of
tensors saved with ``torch.save`` into the checkpoint directory and
loaded with ``torch.load(weights_only=True)`` onto a device, or, given
the shardings of a mesh, gathered whole from every rank's shards and cut
back into each rank's shards on a mesh of any shape.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import pickle
import shutil
import tempfile
import uuid
from typing import Any, Dict, Iterator, Optional

_METADATA_FILE = ".metadata.json"
_PYTREE_FILE = "pytree.msgpack.pkl"
_TORCH_FILE = "torch_state.pt"


class Checkpoint:
    def __init__(self, path: str, filesystem: Any = None):
        self.path = os.path.abspath(os.path.expanduser(path))
        self.filesystem = filesystem  # pyarrow fs slot; local-only for now

    # ------------------------------------------------------------ basics
    @classmethod
    def from_directory(cls, path: str) -> "Checkpoint":
        return cls(path)

    def to_directory(self, path: Optional[str] = None) -> str:
        dest = path or os.path.join(
            tempfile.gettempdir(), f"ckpt_{uuid.uuid4().hex[:8]}"
        )
        if os.path.abspath(dest) != self.path:
            shutil.copytree(self.path, dest, dirs_exist_ok=True)
        return dest

    @contextlib.contextmanager
    def as_directory(self) -> Iterator[str]:
        # local paths need no materialization
        yield self.path

    def update_metadata(self, metadata: Dict[str, Any]) -> None:
        meta = self.get_metadata()
        meta.update(metadata)
        with open(os.path.join(self.path, _METADATA_FILE), "w") as f:
            json.dump(meta, f)

    def get_metadata(self) -> Dict[str, Any]:
        p = os.path.join(self.path, _METADATA_FILE)
        if os.path.exists(p):
            with open(p) as f:
                return json.load(f)
        return {}

    def __repr__(self):
        return f"Checkpoint(path={self.path!r})"

    def __eq__(self, other):
        return isinstance(other, Checkpoint) and other.path == self.path

    def __hash__(self):
        return hash(self.path)

    # ------------------------------------------------------- pytree I/O
    @classmethod
    def from_state(cls, state: Any, path: Optional[str] = None) -> "Checkpoint":
        """Persist a picklable object / pytree of host arrays."""
        d = path or os.path.join(tempfile.gettempdir(), f"ckpt_{uuid.uuid4().hex[:8]}")
        os.makedirs(d, exist_ok=True)
        with open(os.path.join(d, _PYTREE_FILE), "wb") as f:
            pickle.dump(state, f, protocol=pickle.HIGHEST_PROTOCOL)
        return cls(d)

    def to_state(self) -> Any:
        with open(os.path.join(self.path, _PYTREE_FILE), "rb") as f:
            return pickle.load(f)

    # ------------------------------------------------------- torch I/O
    @classmethod
    def from_torch(cls, tree: Any, path: Optional[str] = None,
                   shardings: Any = None) -> "Checkpoint":
        """Save a tree of tensors with ``torch.save`` (the counterpart of
        the JAX package's orbax ``from_jax``). The tree may nest dicts,
        lists, tuples, NamedTuples and dataclasses, with tensors and
        Python scalars as leaves; it is stored as plain containers (a
        NamedTuple or a dataclass as a dict of its fields), so that it
        loads with ``weights_only=True``. Tensors keep their dtype and
        bits (bf16 included).

        ``shardings``: a tree of ``parallel.NamedSharding`` shaped like
        ``tree`` (``parallel.state_shardings`` gives one for a
        TrainState), when ``tree`` holds this rank's shards. Every rank of
        the mesh calls it with the same ``path``: each leaf is all-gathered
        over the axes of its spec, the mesh's first rank writes the whole
        tree, and the others wait for it. The file then holds the global
        tree, as orbax's save of sharded arrays does, and restores onto a
        mesh of any shape.
        """
        import torch

        if shardings is None:
            d = os.path.abspath(path or os.path.join(
                tempfile.gettempdir(), f"ckpt_{uuid.uuid4().hex[:8]}"))
            os.makedirs(d, exist_ok=True)
            torch.save(_plain(tree), os.path.join(d, _TORCH_FILE))
            return cls(d)
        if path is None:
            raise ValueError("a sharded save needs a path that every rank names")
        from ..models.convert import gather_tensor

        d = os.path.abspath(path)
        plain_sh = _plain_shardings(shardings)
        mesh = _mesh_of(plain_sh)
        if mesh is None:
            raise ValueError("shardings hold no NamedSharding")
        first = mesh.get_rank() == int(mesh.mesh.flatten()[0])

        def gathered(leaf, sh, where):
            """The whole leaf on the host on the first rank, dropped elsewhere."""
            if not hasattr(leaf, "detach"):
                return leaf
            whole = gather_tensor(leaf, sh.mesh, sh.spec)
            return whole.cpu() if first else None

        whole = _zip_shardings(gathered, _plain(tree), plain_sh)
        if first:
            os.makedirs(d, exist_ok=True)
            torch.save(whole, os.path.join(d, _TORCH_FILE))
        _barrier(mesh)
        return cls(d)

    def to_torch(self, target: Any = None, device: Any = None,
                 shardings: Any = None) -> Any:
        """Restore the tree saved by ``from_torch``.

        ``target``: optional tree template; the restored values are put
        back into its exact structure, dict keys and fields matched by
        name (NamedTuples such as ``parallel.TrainState`` and dataclasses
        included; a tensor whose template requires grad comes back
        requiring grad); a tree of another shape raises ValueError.
        ``device``: where the tensors go; the GPU unless "cpu" is asked,
        and it raises without one.
        ``shardings``: instead of ``device``, a tree of
        ``parallel.NamedSharding`` shaped like ``target`` (or, with no
        target, giving the structure itself): each rank gets its own
        shard of every leaf, cut as ``models.shard_params`` cuts it, a
        contiguous tensor on the mesh's device; a leaf with ``P()``
        comes whole, a Python scalar as it was saved. The mesh may have
        another shape than the one the tree was saved from (a fresh mesh
        after a gang restart). A dimension that its axes do not divide
        raises ValueError.
        """
        import torch

        from .._private.device import resolve_device

        if shardings is not None and device is not None:
            raise ValueError("pass device or shardings, not both")
        restored = torch.load(
            os.path.join(self.path, _TORCH_FILE),
            map_location="cpu" if shardings is not None else resolve_device(device),
            weights_only=True,
        )
        if shardings is not None:
            from ..models.convert import shard_tensor

            def shard(leaf, sh, where):
                if not hasattr(leaf, "detach"):
                    return leaf
                try:
                    return shard_tensor(leaf, sh.mesh, sh.spec)
                except ValueError as e:
                    raise ValueError(f"checkpoint at {where or 'the root'}: {e}") from None

            restored = _zip_shardings(shard, restored, _plain_shardings(shardings))
        template = target if target is not None else shardings
        if template is not None:
            restored = _rebuild(template, restored, "")
        return restored


def _is_sharding(node: Any) -> bool:
    from ..parallel.mesh import NamedSharding

    return isinstance(node, NamedSharding)


def _plain_shardings(shardings: Any) -> Any:
    """``_plain`` of a shardings tree, its ``NamedSharding``s kept as leaves."""
    if _is_sharding(shardings):
        return shardings
    fields = _fields(shardings)
    if fields is not None:
        return {n: _plain_shardings(v) for n, v in zip(*fields)}
    if isinstance(shardings, dict):
        return {k: _plain_shardings(v) for k, v in shardings.items()}
    return [_plain_shardings(v) for v in shardings]


def _mesh_of(plain_shardings: Any):
    """The mesh of the first ``NamedSharding`` of a plain shardings tree."""
    if _is_sharding(plain_shardings):
        return plain_shardings.mesh
    values = (plain_shardings.values() if isinstance(plain_shardings, dict)
              else plain_shardings)
    for v in values:
        mesh = _mesh_of(v)
        if mesh is not None:
            return mesh
    return None


def _zip_shardings(fn, tree: Any, shardings: Any, where: str = "") -> Any:
    """``fn(leaf, sharding, where)`` on every leaf of the plain ``tree``,
    with the ``NamedSharding`` at its place in the plain ``shardings``."""
    if _is_sharding(shardings):
        return fn(tree, shardings, where)
    if isinstance(shardings, dict) and isinstance(tree, dict) and set(tree) == set(shardings):
        return {k: _zip_shardings(fn, tree[k], shardings[k], f"{where}.{k}") for k in tree}
    if isinstance(shardings, list) and isinstance(tree, list) and len(tree) == len(shardings):
        return [_zip_shardings(fn, v, sh, f"{where}[{i}]")
                for i, (v, sh) in enumerate(zip(tree, shardings))]
    raise ValueError(f"shardings at {where or 'the root'} do not match the checkpoint's tree")


def _barrier(mesh) -> None:
    """Returns on every rank once every rank of ``mesh`` has reached it: a
    one-element sum over each axis, read back on the host."""
    import torch

    from ..parallel import comm
    from ..parallel.mesh import AXIS_ORDER, mesh_axis_size, mesh_device

    flag = torch.ones(1, device=mesh_device(mesh))
    comm.all_reduce_axes_(flag, mesh, [a for a in AXIS_ORDER if mesh_axis_size(mesh, a) > 1])
    flag.item()


def _fields(node: Any):
    """(names, values) of a NamedTuple or dataclass instance, else None
    (a ``NamedSharding`` is a leaf)."""
    if isinstance(node, tuple) and hasattr(node, "_fields") and not _is_sharding(node):
        return list(node._fields), list(node)
    if dataclasses.is_dataclass(node) and not isinstance(node, type):
        names = [f.name for f in dataclasses.fields(node)]
        return names, [getattr(node, n) for n in names]
    return None


def _plain(tree: Any) -> Any:
    """The tree in dicts and lists only, tensors detached."""
    fields = _fields(tree)
    if fields is not None:
        return {n: _plain(v) for n, v in zip(*fields)}
    if isinstance(tree, dict):
        return {k: _plain(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_plain(v) for v in tree]
    return tree.detach() if hasattr(tree, "detach") else tree


def _rebuild(target: Any, saved: Any, where: str) -> Any:
    """``target``'s structure filled from ``saved`` (the plain tree):
    dict keys and fields matched by name, sequences by position."""
    fields = _fields(target)
    if fields is not None or isinstance(target, dict):
        names, values = fields or (list(target), list(target.values()))
        if not isinstance(saved, dict) or set(saved) != set(names):
            got = sorted(saved) if isinstance(saved, dict) else type(saved).__name__
            raise ValueError(f"checkpoint at {where or 'the root'} holds {got}, "
                             f"the target {sorted(names)}")
        out = {n: _rebuild(v, saved[n], f"{where}.{n}") for n, v in zip(names, values)}
        if fields is None:
            return out
        if isinstance(target, tuple):
            return type(target)(**out)
        return dataclasses.replace(target, **out)
    if isinstance(target, (list, tuple)) and not _is_sharding(target):
        if not isinstance(saved, list) or len(saved) != len(target):
            raise ValueError(f"checkpoint at {where or 'the root'} is not a sequence "
                             f"of {len(target)}")
        return type(target)(_rebuild(v, x, f"{where}[{i}]")
                            for i, (v, x) in enumerate(zip(target, saved)))
    if getattr(target, "requires_grad", False) and hasattr(saved, "requires_grad_"):
        saved.requires_grad_(True)
    return saved
