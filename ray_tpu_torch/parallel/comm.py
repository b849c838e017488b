"""Collectives over a mesh axis, and the autograd functions built on them.

Every collective of the parallel layer goes through this module, on the
group of one mesh axis (``DeviceMesh.get_group(axis)``). An axis of size 1
is a no-op. A failed collective raises; nothing here changes backend or
device.

Transport. NCCL takes CUDA tensors as they are. A gloo group (several
ranks sharing one card, or CPU ranks) moves CUDA tensors through the
host: each is copied to host memory before the collective and its result
copied back after it, here and nowhere else, and the bytes are counted
(``staging``: the bytes of the copies out and back in, and the host time
spent waiting for the card before a copy, in the copies and in the
collectives' calls). The staging is fixed by the group's backend, not by
a failure.

Gradients. A sharded program is one process per rank, and its loss is
the sum of the ranks' shares (``loss_total``). Each collective's backward
is its adjoint under that sum: an all-reduce's is an all-reduce, an
all-gather's a reduce-scatter, an all-to-all's the all-to-all back (ring
attention's backward sends dK/dV round the ring with their blocks). A
parameter held whole on several ranks then gets its gradient by summing
the ranks' gradients over every axis it is replicated on
(``parallel/train_step.py``).
"""

from __future__ import annotations

import time
from typing import List, Optional, Sequence

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from .mesh import AXIS_ORDER, axis_index, mesh_axis_size

# the names of torch 2.13; older releases have only the *_tensor ones
_all_gather_single = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor
_reduce_scatter_single = (getattr(dist, "reduce_scatter_single", None)
                          or dist.reduce_scatter_tensor)


class _Staging:
    """What the gloo transport of CUDA tensors costs: ``bytes`` copied
    between the card and the host, and host-clock seconds spent waiting
    for the card's queued work before a copy out (``wait_s``), in the
    copies (``copy_s``) and in the collectives' calls (``comm_s``)."""

    def __init__(self):
        self.reset()

    def reset(self) -> None:
        self.bytes = 0
        self.wait_s = self.copy_s = self.comm_s = 0.0


staging = _Staging()


def _stages(group, tensors: Sequence[torch.Tensor]) -> bool:
    return dist.get_backend(group) == "gloo" and any(t.is_cuda for t in tensors)


def _to_host(t: torch.Tensor) -> torch.Tensor:
    t0 = time.perf_counter()
    torch.cuda.current_stream(t.device).synchronize()
    t1 = time.perf_counter()
    host = t.cpu()
    staging.wait_s += t1 - t0
    staging.copy_s += time.perf_counter() - t1
    staging.bytes += t.numel() * t.element_size()
    return host


def _back(host: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    t0 = time.perf_counter()
    out = host.to(like.device)
    staging.copy_s += time.perf_counter() - t0
    staging.bytes += host.numel() * host.element_size()
    return out


class _Timed:
    """Adds the host time of the block to ``staging.comm_s``."""

    def __enter__(self):
        self.t0 = time.perf_counter()

    def __exit__(self, *exc):
        staging.comm_s += time.perf_counter() - self.t0


def _collective(fn, out: torch.Tensor, inp: torch.Tensor, group, **kw) -> torch.Tensor:
    """``fn(out, inp, group=group, **kw)``, through the host for gloo and
    CUDA tensors; returns ``out`` filled."""
    if not _stages(group, (out, inp)):
        with _Timed():
            fn(out, inp, group=group, **kw)
        return out
    host_out = torch.empty(out.shape, dtype=out.dtype)
    host_in = _to_host(inp)
    with _Timed():
        fn(host_out, host_in, group=group, **kw)
    out.copy_(_back(host_out, out))
    return out


def all_reduce_(t: torch.Tensor, mesh: DeviceMesh, axis: str) -> torch.Tensor:
    """Sum ``t`` in place over ``axis``; returns ``t``."""
    if mesh_axis_size(mesh, axis) == 1:
        return t
    group = mesh.get_group(axis)
    if _stages(group, (t,)):
        host = _to_host(t)
        with _Timed():
            dist.all_reduce(host, group=group)
        t.copy_(_back(host, t))
    else:
        with _Timed():
            dist.all_reduce(t, group=group)
    return t


def all_reduce_axes_(t: torch.Tensor, mesh: DeviceMesh, axes: Sequence[str]) -> torch.Tensor:
    for a in axes:
        all_reduce_(t, mesh, a)
    return t


def all_gather(t: torch.Tensor, mesh: DeviceMesh, axis: str, dim: int) -> torch.Tensor:
    """The axis ranks' ``t`` concatenated along ``dim`` in axis order."""
    n = mesh_axis_size(mesh, axis)
    if n == 1:
        return t
    x = t.movedim(dim, 0).contiguous()
    out = torch.empty((n * x.shape[0],) + tuple(x.shape[1:]), dtype=x.dtype, device=x.device)
    _collective(_all_gather_single, out, x, mesh.get_group(axis))
    return out.movedim(0, dim).contiguous()


def reduce_scatter(t: torch.Tensor, mesh: DeviceMesh, axis: str, dim: int) -> torch.Tensor:
    """Sum over ``axis`` and keep this rank's block of ``dim``."""
    n = mesh_axis_size(mesh, axis)
    if n == 1:
        return t
    x = t.movedim(dim, 0).contiguous()
    out = torch.empty((x.shape[0] // n,) + tuple(x.shape[1:]), dtype=x.dtype, device=x.device)
    _collective(_reduce_scatter_single, out, x, mesh.get_group(axis))
    return out.movedim(0, dim).contiguous()


def all_to_all(x: torch.Tensor, mesh: DeviceMesh, axis: str) -> torch.Tensor:
    """Block i of dim 0 goes to the axis's rank i; block j of the result
    came from rank j (``all_to_all_single`` with equal splits)."""
    if mesh_axis_size(mesh, axis) == 1:
        return x
    x = x.contiguous()
    return _collective(dist.all_to_all_single, torch.empty_like(x), x, mesh.get_group(axis))


class RingShift:
    """Send tensors to the next rank of an axis and receive the previous
    rank's, all ranks posting at once as ``lax.ppermute`` does. Building it
    posts the hops; ``wait`` returns what came."""

    def __init__(self, mesh: DeviceMesh, axis: str, tensors: Sequence[torch.Tensor]):
        group = mesh.get_group(axis)
        n, me = mesh_axis_size(mesh, axis), axis_index(mesh, axis)
        ranks = dist.get_process_group_ranks(group)
        nxt, prv = ranks[(me + 1) % n], ranks[(me - 1) % n]
        self._staged = _stages(group, tensors)
        self._like = list(tensors)
        send = [_to_host(t.contiguous()) if self._staged else t.contiguous() for t in tensors]
        self._recv = [torch.empty(s.shape, dtype=s.dtype, device=s.device) for s in send]
        ops = [dist.P2POp(dist.isend, s, nxt, group=group) for s in send]
        ops += [dist.P2POp(dist.irecv, r, prv, group=group) for r in self._recv]
        self._send = send  # alive until the sends complete
        self._reqs = dist.batch_isend_irecv(ops)

    def wait(self) -> List[torch.Tensor]:
        with _Timed():
            for r in self._reqs:
                r.wait()
        self._send = None
        if self._staged:
            return [_back(r, t) for r, t in zip(self._recv, self._like)]
        return self._recv


def exchange(mesh: DeviceMesh, axis: str, send: dict, recv: dict,
             device: torch.device) -> dict:
    """Point-to-point hops along ``axis``, posted together and waited
    together: ``send`` maps an axis index to the tensor for it, ``recv`` an
    axis index to the (shape, dtype) expected from it, on ``device``.
    Returns the received tensors by axis index."""
    group = mesh.get_group(axis)
    ranks = dist.get_process_group_ranks(group)
    staged = dist.get_backend(group) == "gloo" and torch.device(device).type == "cuda"
    ops, bufs, keep = [], {}, []
    for i, t in send.items():
        s = _to_host(t.contiguous()) if staged else t.contiguous()
        keep.append(s)
        ops.append(dist.P2POp(dist.isend, s, ranks[i], group=group))
    for i, (shape, dtype) in recv.items():
        bufs[i] = torch.empty(shape, dtype=dtype, device="cpu" if staged else device)
        ops.append(dist.P2POp(dist.irecv, bufs[i], ranks[i], group=group))
    if ops:
        with _Timed():
            for r in dist.batch_isend_irecv(ops):
                r.wait()
    if staged:
        like = torch.empty(0, device=device)
        return {i: _back(b, like) for i, b in bufs.items()}
    return bufs


def broadcast_(t: torch.Tensor, mesh: DeviceMesh, axis: str, src: int) -> torch.Tensor:
    """Overwrite ``t`` with axis rank ``src``'s ``t``; returns ``t``."""
    if mesh_axis_size(mesh, axis) == 1:
        return t
    group = mesh.get_group(axis)
    root = dist.get_process_group_ranks(group)[src]
    if _stages(group, (t,)):
        host = _to_host(t)
        with _Timed():
            dist.broadcast(host, root, group=group)
        t.copy_(_back(host, t))
    else:
        with _Timed():
            dist.broadcast(t, root, group=group)
    return t


# ---------------------------------------------------------------------
# autograd functions (sum-of-shares semantics; see the module docstring)
# ---------------------------------------------------------------------

class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        ctx.mesh, ctx.axes = mesh, axes
        return all_reduce_axes_(x.clone(), mesh, axes)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_axes_(g.clone(), ctx.mesh, ctx.axes), None, None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, dim):
        ctx.mesh, ctx.axis, ctx.dim = mesh, axis, dim
        return all_gather(x, mesh, axis, dim)

    @staticmethod
    def backward(ctx, g):
        return reduce_scatter(g, ctx.mesh, ctx.axis, ctx.dim), None, None, None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return all_to_all(x, mesh, axis)

    @staticmethod
    def backward(ctx, g):
        return all_to_all(g, ctx.mesh, ctx.axis), None, None


class _Total(torch.autograd.Function):
    """Forward: the sum of the ranks' shares, on every rank. Backward:
    each rank's share takes the loss's gradient as it is (its own term of
    the sum)."""

    @staticmethod
    def forward(ctx, share, mesh):
        return all_reduce_axes_(share.clone(), mesh, AXIS_ORDER)

    @staticmethod
    def backward(ctx, g):
        return g, None


def psum(x: torch.Tensor, mesh: DeviceMesh, axes: Sequence[str]) -> torch.Tensor:
    """Sum over ``axes``; the backward sums the gradient over them too."""
    axes = tuple(a for a in axes if mesh_axis_size(mesh, a) > 1)
    return _AllReduce.apply(x, mesh, axes) if axes else x


def gather(x: torch.Tensor, mesh: DeviceMesh, axis: str, dim: int) -> torch.Tensor:
    """All-gather along ``dim``; the backward reduce-scatters."""
    return _AllGather.apply(x, mesh, axis, dim) if mesh_axis_size(mesh, axis) > 1 else x


def all_to_all_grad(x: torch.Tensor, mesh: DeviceMesh, axis: str) -> torch.Tensor:
    """``all_to_all`` with the all-to-all back as its backward."""
    return _AllToAll.apply(x, mesh, axis) if mesh_axis_size(mesh, axis) > 1 else x


def loss_total(share: torch.Tensor, mesh: DeviceMesh) -> torch.Tensor:
    """The loss from the ranks' shares: their sum on every rank, whose
    gradient reaches each share unchanged."""
    return _Total.apply(share, mesh)


def replication(mesh: DeviceMesh, split_axes: Sequence[str]) -> int:
    """How many ranks hold the same piece of data when it is split over
    ``split_axes`` only: the product of the other axes' sizes."""
    n = mesh.size()
    for a in split_axes:
        n //= mesh_axis_size(mesh, a)
    return n


def mean_share(nll: torch.Tensor, mask: Optional[torch.Tensor], mesh: DeviceMesh,
               split_axes: Sequence[str]) -> torch.Tensor:
    """This rank's share of the global (masked) mean of ``nll``, whose
    elements are split over ``split_axes`` and replicated over the rest:
    the local sum over the global count, over the replication."""
    if mask is not None:
        num, den = torch.sum(nll * mask), torch.sum(mask).float()
    else:
        num = torch.sum(nll)
        den = torch.tensor(float(nll.numel()), device=nll.device)
    den = all_reduce_axes_(den.detach().clone(), mesh, split_axes)
    return num / torch.clamp(den, min=1.0) / replication(mesh, split_axes)



# ---------------------------------------------------------------------
# what the models call under a mesh
# ---------------------------------------------------------------------

def active_mesh() -> Optional[DeviceMesh]:
    """The ambient mesh when it has more than one rank, else None: on a
    mesh of one rank the models run their one-device code unchanged."""
    from .mesh import get_mesh, is_trivial

    mesh = get_mesh()
    return None if is_trivial(mesh) else mesh


def gather_param(t: torch.Tensor, spec, mesh: DeviceMesh,
                 axes: Optional[Sequence[str]] = None) -> torch.Tensor:
    """A parameter shard all-gathered over the axes its spec names (only
    those in ``axes`` when given), with the reduce-scatter as backward."""
    from .mesh import spec_axes

    for d, e in enumerate(spec):
        for axis in reversed(spec_axes(e)):  # the minor axis first
            if axes is None or axis in axes:
                t = gather(t, mesh, axis, d)
    return t


def gather_layer(layer: dict, specs: dict, mesh: DeviceMesh,
                 axes: Sequence[str]) -> dict:
    """One layer's weights (views of the stacked shards) gathered over
    ``axes``; ``specs`` are the stacked tensors' specs, whose first entry
    is the layer dim."""
    from .mesh import P

    return {k: gather_param(w, P(*specs[k][1:]), mesh, axes) for k, w in layer.items()}


def local_part(t: Optional[torch.Tensor], mesh: DeviceMesh, axes: Sequence[str],
               dim: int) -> Optional[torch.Tensor]:
    """This rank's contiguous block of ``dim`` split over ``axes`` (major
    first); None stays None."""
    from .mesh import shard_slice

    if t is None:
        return None
    index = [slice(None)] * t.dim()
    index[dim] = shard_slice(mesh, tuple(axes), t.shape[dim])
    return t[tuple(index)]
