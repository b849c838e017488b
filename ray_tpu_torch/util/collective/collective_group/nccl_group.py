"""NCCL collective group: eager collectives over this process's GPUs.

Takes the place of the JAX package's ``XlaGroup``
(``ray_tpu/util/collective/collective_group/xla_group.py``) and keeps its
single-controller convention: one process drives the group's N devices,
each eager op takes a list of N per-rank tensors (rank i on device i of
the group), all of one shape and dtype, and returns a new list of N.

On CUDA tensors each op is one ``torch.cuda.nccl`` call over the list
(NCCL builds and caches a communicator per device list, as the
reference's NCCLGroup caches one per device list,
nccl_collective_group.py:402-432); a CUDA tensor that cannot reach NCCL
raises. CPU tensors take a plain reduction over the list: that is the
tests' path, and nothing on the card takes it. NCCL refuses two ranks on
one device, so a group on a one-card machine has world size 1, and its
ops still go through NCCL.

Results equal the JAX group's op by op. AVERAGE is a SUM, then a division
by the world size, so integers come back as floats, as ``psum / world``
gives them; PRODUCT, MIN and MAX are NCCL's own reductions. ``ReduceOp``'s
numbers are the JAX package's (PRODUCT 1, MIN 2, MAX 3), not NCCL's (prod
1, max 2, min 3), so ops are mapped by name.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..types import (
    AllGatherOptions,
    AllReduceOptions,
    BarrierOptions,
    BroadcastOptions,
    RecvOptions,
    ReduceOp,
    ReduceOptions,
    ReduceScatterOptions,
    SendOptions,
)
from .base import BaseGroup

# ncclRedOp_t of each ReduceOp, by name; AVERAGE is a sum divided afterwards
_NCCL_OP = {"SUM": 0, "AVERAGE": 0, "PRODUCT": 1, "MAX": 2, "MIN": 3}


def _plain_reduce(tensors: List[torch.Tensor], op: ReduceOp) -> torch.Tensor:
    """The reduction over the per-rank list, in the tensors' own dtype."""
    stack = torch.stack(tensors)
    if op in (ReduceOp.SUM, ReduceOp.AVERAGE):
        return stack.sum(0, dtype=stack.dtype)
    if op == ReduceOp.PRODUCT:
        return stack.prod(0, dtype=stack.dtype)
    if op == ReduceOp.MAX:
        return stack.amax(0)
    if op == ReduceOp.MIN:
        return stack.amin(0)
    raise ValueError(f"unsupported reduce op {op}")


class NcclGroup(BaseGroup):
    """A collective group over N devices of this process.

    ``devices`` are the ranks' devices, ``cuda:0`` .. ``cuda:N-1`` by
    default; CPU tensors may be given whatever the devices are, and a
    group that must make its own tensors (``barrier``) or move one
    (``send``) on the CPU is built with ``devices=["cpu"] * N``.
    """

    def __init__(
        self,
        world_size: int,
        rank: int,
        group_name: str,
        devices: Optional[Sequence] = None,
    ):
        super().__init__(world_size, rank, group_name)
        if devices is None:
            devices = [torch.device("cuda", i) for i in range(world_size)]
        if len(devices) != world_size:
            raise ValueError(
                f"group of world_size {world_size} needs {world_size} devices, "
                f"got {len(devices)}"
            )
        self._devices = [torch.device(d) for d in devices]
        # single-controller p2p: destination rank -> tensors delivered, FIFO
        self._p2p_mailbox: Dict[int, List[torch.Tensor]] = {}

    @property
    def backend(self) -> str:
        return "nccl"

    def destroy_group(self) -> None:
        self._p2p_mailbox.clear()

    # -- argument checks -------------------------------------------------

    def _tensors(self, tensors) -> tuple:
        """(contiguous per-rank tensors, whether they are on the GPUs).
        Raises unless the list is all CPU or all CUDA, one tensor on each
        rank's device, and NCCL can take it."""
        if len(tensors) != self._world_size:
            raise ValueError(
                f"expected {self._world_size} per-rank tensors, got {len(tensors)}"
            )
        ts = [
            (t if isinstance(t, torch.Tensor) else torch.as_tensor(np.asarray(t))).contiguous()
            for t in tensors
        ]
        if any(t.shape != ts[0].shape or t.dtype != ts[0].dtype for t in ts):
            raise ValueError("per-rank tensors must share one shape and dtype")
        on_cuda = [t.is_cuda for t in ts]
        if not any(on_cuda):
            return ts, False
        if not all(on_cuda):
            raise ValueError("per-rank tensors must be all on the CPU or all on GPUs")
        if not torch.cuda.is_available() or not torch.cuda.nccl.is_available(ts):
            raise RuntimeError(
                "these CUDA tensors cannot reach NCCL (no CUDA device, a torch "
                "built without NCCL, or two ranks on one device)"
            )
        for i, (t, d) in enumerate(zip(ts, self._devices)):
            if t.device != d:
                raise ValueError(f"rank {i}'s tensor is on {t.device}, the rank's device is {d}")
        return ts, True

    def _average(self, outs: List[torch.Tensor], op: ReduceOp) -> List[torch.Tensor]:
        if op != ReduceOp.AVERAGE:
            return outs
        return [o / self._world_size for o in outs]

    # -- collectives -----------------------------------------------------

    def allreduce(self, tensors, opts: AllReduceOptions = AllReduceOptions()):
        ts, cuda = self._tensors(tensors)
        if cuda:
            outs = [t.clone() for t in ts]  # NCCL reduces in place
            torch.cuda.nccl.all_reduce(outs, op=_NCCL_OP[opts.reduceOp.name])
        else:
            red = _plain_reduce(ts, opts.reduceOp)
            outs = [red.clone() for _ in ts]
        return self._average(outs, opts.reduceOp)

    def reduce(self, tensors, opts: ReduceOptions = ReduceOptions()):
        ts, cuda = self._tensors(tensors)
        root = opts.root_rank
        outs = [t.clone() for t in ts]
        if cuda:
            torch.cuda.nccl.reduce(outs, root=root, op=_NCCL_OP[opts.reduceOp.name])
        else:
            outs[root] = _plain_reduce(ts, opts.reduceOp)
        if opts.reduceOp == ReduceOp.AVERAGE:
            # the other ranks keep their input, in the result's dtype
            outs[root] = outs[root] / self._world_size
            outs = [o if i == root else o.to(outs[root].dtype) for i, o in enumerate(outs)]
        return outs

    def broadcast(self, tensors, opts: BroadcastOptions = BroadcastOptions()):
        ts, cuda = self._tensors(tensors)
        root = opts.root_rank
        if cuda:
            outs = [t.clone() for t in ts]
            torch.cuda.nccl.broadcast(outs, root=root)
            return outs
        return [ts[root].clone() for _ in ts]

    def allgather(self, tensors, opts: AllGatherOptions = AllGatherOptions()):
        """Each rank contributes [k...]; each rank receives [world, k...]."""
        ts, cuda = self._tensors(tensors)
        if cuda:
            outs = [t.new_empty((self._world_size, *t.shape)) for t in ts]
            torch.cuda.nccl.all_gather(ts, outs)
            return outs
        return [torch.stack(ts) for _ in ts]

    def reducescatter(
        self, tensors, opts: ReduceScatterOptions = ReduceScatterOptions()
    ):
        """Each rank holds the full [world*k, ...] input; rank i receives
        chunk i of the reduction along dim 0."""
        ts, cuda = self._tensors(tensors)
        world = self._world_size
        dim0 = ts[0].shape[0] if ts[0].dim() else 0
        if ts[0].dim() == 0 or dim0 % world != 0:
            raise ValueError(
                f"reducescatter dim0 {dim0} not divisible by world_size {world}"
            )
        chunk = dim0 // world
        if cuda:
            outs = [t.new_empty((chunk, *t.shape[1:])) for t in ts]
            torch.cuda.nccl.reduce_scatter(ts, outs, op=_NCCL_OP[opts.reduceOp.name])
        else:
            red = _plain_reduce(ts, opts.reduceOp)
            outs = [red[i * chunk:(i + 1) * chunk].clone() for i in range(world)]
        return self._average(outs, opts.reduceOp)

    def barrier(self, opts: BarrierOptions = BarrierOptions()):
        zeros = [torch.zeros(1, dtype=torch.int32, device=d) for d in self._devices]
        self.allreduce(zeros)
        for d in self._devices:
            if d.type == "cuda":
                torch.cuda.synchronize(d)

    # -- eager p2p ---------------------------------------------------------
    # Single-controller semantics, as the JAX group's: send() copies the
    # tensor onto the destination rank's device and parks it in that
    # rank's FIFO mailbox; recv(rank) pops the oldest tensor delivered to
    # that rank. Across processes, send/recv is StoreGroup's.
    def send(self, tensors, opts: SendOptions):
        tensor = tensors[0] if isinstance(tensors, (list, tuple)) else tensors
        delivered = torch.as_tensor(tensor).to(self._devices[opts.dst_rank], copy=True)
        self._p2p_mailbox.setdefault(opts.dst_rank, []).append(delivered)

    def recv(self, tensors_or_opts=None, opts: RecvOptions = None):
        # tolerate both recv(opts) and recv(tensors, opts) call shapes
        if opts is None:
            opts = tensors_or_opts
        queue = self._p2p_mailbox.get(opts.src_rank)
        if not queue:
            raise RuntimeError(
                f"no pending p2p message for rank {opts.src_rank} "
                f"(single-controller group: send() must precede recv())"
            )
        return queue.pop(0)
