"""Checkpoint: a directory of files, possibly on remote storage.

Port of ``ray_tpu/train/_checkpoint.py`` (reference: python/ray/train/
_checkpoint.py; Checkpoint = path + pyarrow filesystem;
as_directory/to_directory/from_directory). The JAX package's orbax pair
``from_jax``/``to_jax`` becomes ``from_torch``/``to_torch``: a tree of
tensors saved with ``torch.save`` into the checkpoint directory and
loaded with ``torch.load(weights_only=True)`` onto a device.
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
    def from_torch(cls, tree: Any, path: Optional[str] = None) -> "Checkpoint":
        """Save a tree of tensors with ``torch.save`` (the counterpart of
        the JAX package's orbax ``from_jax``). The tree may nest dicts,
        lists, tuples, NamedTuples and dataclasses, with tensors and
        Python scalars as leaves; it is stored as plain containers (a
        NamedTuple or a dataclass as a dict of its fields), so that it
        loads with ``weights_only=True``. Tensors keep their dtype and
        bits (bf16 included)."""
        import torch

        d = os.path.abspath(
            path
            or os.path.join(tempfile.gettempdir(), f"ckpt_{uuid.uuid4().hex[:8]}")
        )
        os.makedirs(d, exist_ok=True)
        torch.save(_plain(tree), os.path.join(d, _TORCH_FILE))
        return cls(d)

    def to_torch(self, target: Any = None, device: Any = None) -> Any:
        """Restore the tree saved by ``from_torch``.

        ``target``: optional tree template; the restored values are put
        back into its exact structure, dict keys and fields matched by
        name (NamedTuples such as ``parallel.TrainState`` and dataclasses
        included; a tensor whose template requires grad comes back
        requiring grad); a tree of another shape raises ValueError.
        ``device``: where the tensors go (the place of ``to_jax``'s
        shardings); the GPU unless "cpu" is asked, and it raises without
        one.
        """
        import torch

        from .._private.device import resolve_device

        restored = torch.load(
            os.path.join(self.path, _TORCH_FILE),
            map_location=resolve_device(device),
            weights_only=True,
        )
        if target is not None:
            restored = _rebuild(target, restored, "")
        return restored


def _fields(node: Any):
    """(names, values) of a NamedTuple or dataclass instance, else None."""
    if isinstance(node, tuple) and hasattr(node, "_fields"):
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
    if isinstance(target, (list, tuple)):
        if not isinstance(saved, list) or len(saved) != len(target):
            raise ValueError(f"checkpoint at {where or 'the root'} is not a sequence "
                             f"of {len(target)}")
        return type(target)(_rebuild(v, x, f"{where}[{i}]")
                            for i, (v, x) in enumerate(zip(target, saved)))
    if getattr(target, "requires_grad", False) and hasattr(saved, "requires_grad_"):
        saved.requires_grad_(True)
    return saved
