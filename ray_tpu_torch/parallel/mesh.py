"""Device meshes and axis conventions, the port of ``ray_tpu/parallel/mesh.py``.

In the JAX package a mesh is a ``jax.sharding.Mesh`` over one process's
devices, and GSPMD places the collectives. Here a program runs as one
process per rank (``torch.distributed``), each calling the same entry
points, and the mesh is a ``torch.distributed.device_mesh.DeviceMesh``
over the process group's ranks. It always carries the five axes of
``AXIS_ORDER`` (size-1 axes included), named by ``mesh_dim_names``, so a
``PartitionSpec`` naming any canonical axis resolves:

- ``data``   data parallelism (batch split; gradients summed);
- ``fsdp``   data parallelism with parameter sharding: parameters are held
             as shards on this axis, all-gathered for use, their gradients
             reduce-scattered;
- ``model``  tensor parallelism (Megatron split of heads and ffn hidden);
- ``seq``    sequence parallelism (``ops/ring_attention.py``);
- ``expert`` expert parallelism for MoE layers.

``P`` is the port's own small ``PartitionSpec``: one axis name, a tuple of
names or None per tensor dimension. A parameter is held as its local shard,
a contiguous tensor cut along each dimension its spec names
(``models/convert.py`` ``shard_params``).

The ambient mesh (``set_mesh``/``get_mesh``) is the counterpart of
``jax.sharding.set_mesh`` and ``get_abstract_mesh``: the sharded train
step sets it, and the models read it to decide how they run.
"""

from __future__ import annotations

import contextlib
import math
from dataclasses import dataclass
from typing import Dict, Iterator, List, NamedTuple, Optional, Tuple, Union

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from .._private.device import DeviceLike, resolve_device

# Canonical axis order, outermost (slowest-varying) first.
AXIS_ORDER = ("data", "fsdp", "expert", "seq", "model")

# The batch dim of activations is split over every data-like axis.
BATCH_AXES = ("data", "fsdp")

Axes = Union[None, str, Tuple[str, ...]]


class P(tuple):
    """A partition spec: one entry per tensor dimension, each None (not
    split), an axis name, or a tuple of names (split over their product,
    the first name the major one). ``P()`` is replicated."""

    def __new__(cls, *axes: Axes):
        return super().__new__(cls, axes)

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}" if len(self) != 1 else f"P({self[0]!r})"


class NamedSharding(NamedTuple):
    """A spec bound to a mesh (the counterpart of ``jax.sharding.NamedSharding``)."""
    mesh: DeviceMesh
    spec: P


@dataclass(frozen=True)
class MeshConfig:
    """Declarative mesh shape. ``auto_axis`` names the axis that absorbs
    the ranks the explicit sizes leave over (world // product of sizes)."""

    data: int = 1
    fsdp: int = 1
    expert: int = 1
    seq: int = 1
    model: int = 1
    auto_axis: str = "fsdp"

    def __post_init__(self):
        if self.auto_axis not in AXIS_ORDER:
            raise ValueError(f"auto_axis {self.auto_axis!r} not one of {AXIS_ORDER}")

    def sizes(self) -> Dict[str, int]:
        return {"data": self.data, "fsdp": self.fsdp, "expert": self.expert,
                "seq": self.seq, "model": self.model}


# The shape a TorchTrainer worker's ``make_mesh()`` takes when called with
# no arguments: ``TorchConfig.mesh_shape``, set by the worker's backend hook.
_default_shape: Dict[str, int] = {}


def set_default_mesh_shape(shape: Optional[Dict[str, int]]) -> None:
    """Axis sizes ``make_mesh()`` uses when it is given none (the worker
    hook of ``TorchConfig`` sets ``mesh_shape`` here)."""
    _default_shape.clear()
    _default_shape.update(shape or {})


def make_mesh(config: Optional[MeshConfig] = None, *, device: DeviceLike = None,
              **axis_sizes: int) -> DeviceMesh:
    """A 5-axis ``DeviceMesh`` over the ranks of the default process group.

    Takes a MeshConfig or axis sizes as keywords (``make_mesh(fsdp=2,
    model=2)``); with neither, the worker's ``TorchConfig.mesh_shape``, if
    any. The ranks the explicit sizes leave over go to ``auto_axis``
    (default fsdp), so ``make_mesh()`` over 4 ranks is a 4-way fsdp mesh;
    sizes that do not divide the world raise. Ranks are laid out row-major
    in ``AXIS_ORDER`` (rank = ((((data * fsdp) + ...) * model) + model
    index), as the JAX package reshapes its device list.

    ``device``: the mesh's device type, the GPU unless "cpu" is asked (no
    GPU raises). With no process group, a world of one rank is started on
    an in-memory store (nccl on the GPU, gloo on the CPU): the counterpart
    of a mesh over one process's one device.
    """
    if config is None:
        config = MeshConfig(**(axis_sizes or _default_shape))
    elif axis_sizes:
        raise ValueError("pass either a MeshConfig or axis sizes, not both")
    device_type = resolve_device(device).type
    if not dist.is_initialized():
        backend = "nccl" if device_type == "cuda" else "gloo"
        dist.init_process_group(backend, store=dist.HashStore(), rank=0, world_size=1)
    n = dist.get_world_size()
    sizes = config.sizes()
    explicit = math.prod(sizes.values())
    if n % explicit != 0:
        raise ValueError(f"{n} ranks not divisible by requested mesh {sizes} (={explicit})")
    sizes[config.auto_axis] *= n // explicit
    return init_device_mesh(device_type, tuple(sizes[a] for a in AXIS_ORDER),
                            mesh_dim_names=AXIS_ORDER)


def single_device_mesh(device: DeviceLike = None) -> DeviceMesh:
    """A mesh of one rank carrying all canonical axes at size 1: lets the
    sharded code paths run unchanged on one card. Needs a world of one."""
    if dist.is_initialized() and dist.get_world_size() != 1:
        raise ValueError(f"single_device_mesh needs a world of one rank, not "
                         f"{dist.get_world_size()}")
    return make_mesh(MeshConfig(), device=device)


def batch_spec(extra_dims: int = 1) -> P:
    """The spec of an activation batch: dim 0 over (data, fsdp), then
    ``extra_dims`` dims not split."""
    return P(BATCH_AXES, *([None] * extra_dims))


def batch_sharding(mesh: DeviceMesh, extra_dims: int = 1) -> NamedSharding:
    return NamedSharding(mesh, batch_spec(extra_dims))


def mesh_axis_size(mesh: DeviceMesh, axis: str) -> int:
    names = mesh.mesh_dim_names or ()
    return mesh.size(names.index(axis)) if axis in names else 1


def dp_degree(mesh: DeviceMesh) -> int:
    """Total data-parallel degree (batch split factor)."""
    return mesh_axis_size(mesh, "data") * mesh_axis_size(mesh, "fsdp")


def axis_index(mesh: DeviceMesh, axis: str) -> int:
    """This rank's coordinate along ``axis``."""
    return mesh.get_local_rank(axis) if mesh_axis_size(mesh, axis) > 1 else 0


def is_trivial(mesh: Optional[DeviceMesh]) -> bool:
    """True for no mesh or a mesh of one rank: nothing to split or sum."""
    return mesh is None or mesh.size() == 1


def spec_axes(entry: Axes) -> Tuple[str, ...]:
    """The axis names of one spec entry, major first."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def replicated_axes(mesh: DeviceMesh, spec: P) -> List[str]:
    """The axes of size > 1 that ``spec`` does not name: a tensor with this
    spec is held whole (replicated) along each of them."""
    named = {a for e in spec for a in spec_axes(e)}
    return [a for a in AXIS_ORDER if a not in named and mesh_axis_size(mesh, a) > 1]


def shard_slice(mesh: DeviceMesh, entry: Axes, length: int) -> slice:
    """This rank's contiguous slice of a dimension of ``length`` split over
    ``entry``'s axes; raises when the length does not divide."""
    axes = spec_axes(entry)
    n = math.prod(mesh_axis_size(mesh, a) for a in axes)
    if length % n != 0:
        raise ValueError(f"dimension of {length} not divisible by {n} ({axes})")
    idx = 0
    for a in axes:
        idx = idx * mesh_axis_size(mesh, a) + axis_index(mesh, a)
    chunk = length // n
    return slice(idx * chunk, (idx + 1) * chunk)


_ambient: List[DeviceMesh] = []


@contextlib.contextmanager
def set_mesh(mesh: DeviceMesh) -> Iterator[DeviceMesh]:
    """Make ``mesh`` the ambient mesh inside the block (the counterpart of
    ``jax.sharding.set_mesh``)."""
    _ambient.append(mesh)
    try:
        yield mesh
    finally:
        _ambient.pop()


def get_mesh() -> Optional[DeviceMesh]:
    """The ambient mesh, or None outside ``set_mesh``."""
    return _ambient[-1] if _ambient else None


def mesh_device(mesh: DeviceMesh) -> torch.device:
    """The device this rank's tensors live on for ``mesh``."""
    return resolve_device(mesh.device_type)
