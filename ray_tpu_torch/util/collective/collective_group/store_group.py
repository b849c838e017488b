"""Store-backed collective group: eager cross-process collectives.

The CPU / cross-process fallback, playing the reference's gloo role
(python/ray/util/collective/collective_group/gloo_collective_group.py)
with the rendezvous pattern of NCCLUniqueIDStore
(nccl_collective_group.py:29-92): a *named coordinator actor* holds the
group state; each rank's eager op posts its contribution and polls for
the reduced result. Bandwidth rides the runtime's shared-memory object
plane, so one-host transfers are zero-ish copy.

Used for: heterogeneous/CPU workers, cross-process tests without
devices (the reference's CPUCommunicator test pattern,
python/ray/experimental/channel/cpu_communicator.py), and control-plane
barriers between gang workers before they enter jitted programs.

Port of ``ray_tpu/util/collective/collective_group/store_group.py``. It
takes torch tensors, CPU or CUDA (numpy arrays too), and hands each rank
its result as a torch tensor on the device of the tensor that rank gave
(the CPU for numpy, and for ``recv``, which is given none). A CUDA tensor
is staged through the host, as the runtime's tensor reducer stages it.
The reduction stays ``_np_reduce`` on numpy, so results are bit-equal to
the JAX package's; numpy has no bf16, so a bf16 tensor travels as f32 and
its result is rounded back to bf16.
"""

from __future__ import annotations

import time
from typing import Any, Dict, List, Optional, Tuple

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


def _np_reduce(chunks: List[np.ndarray], op: ReduceOp) -> np.ndarray:
    stack = np.stack(chunks)
    if op == ReduceOp.SUM:
        return stack.sum(axis=0)
    if op == ReduceOp.AVERAGE:
        return stack.mean(axis=0)
    if op == ReduceOp.MAX:
        return stack.max(axis=0)
    if op == ReduceOp.MIN:
        return stack.min(axis=0)
    if op == ReduceOp.PRODUCT:
        return stack.prod(axis=0)
    raise ValueError(f"unsupported reduce op {op}")


class _Coordinator:
    """Named actor holding per-op mailboxes. One instance per group.

    Methods are tiny and non-blocking (ranks poll) so the actor's
    single-threaded queue never deadlocks.
    """

    def __init__(self, world_size: int):
        self.world_size = world_size
        # (op_seq) -> {rank: payload}
        self.boxes: Dict[Tuple, Dict[int, Any]] = {}
        # key -> how many ranks already pulled the completed box
        self.pickups: Dict[Tuple, int] = {}
        # p2p mailboxes: (src, dst, tag) -> payload
        self.mail: Dict[Tuple, Any] = {}
        # rank -> number of times it joined (group incarnations)
        self.joins: Dict[int, int] = {}

    def join(self, rank: int) -> int:
        """Rank's incarnation number (1 on first join, 2 after the whole
        group is re-created, ...). Incarnations are folded into op keys,
        so a re-created group can never collect a stale box left by a
        previous incarnation that timed out or died mid-op. (If only ONE
        member re-joins a live group, its incarnation diverges and its
        ops time out — loud failure instead of silent corruption;
        rebuild the whole group in that case.)"""
        self.joins[rank] = self.joins.get(rank, 0) + 1
        return self.joins[rank]

    def post(self, key: Tuple, rank: int, payload: Any) -> None:
        self.boxes.setdefault(key, {})[rank] = payload

    def collect(self, key: Tuple) -> Optional[Dict[int, Any]]:
        """Returns the full mailbox once all ranks posted, else None."""
        box = self.boxes.get(key)
        if box is None or len(box) < self.world_size:
            return None
        # keep until all ranks pulled, then GC
        result = dict(box)
        picked = self.pickups.get(key, 0) + 1
        if picked >= self.world_size:
            self.boxes.pop(key, None)
            self.pickups.pop(key, None)
        else:
            self.pickups[key] = picked
        return result

    def p2p_send(self, src: int, dst: int, tag: int, payload: Any) -> None:
        self.mail[(src, dst, tag)] = payload

    def p2p_recv(self, src: int, dst: int, tag: int) -> Tuple[bool, Any]:
        key = (src, dst, tag)
        if key in self.mail:
            return True, self.mail.pop(key)
        return False, None


class StoreGroup(BaseGroup):
    def __init__(self, world_size: int, rank: int, group_name: str):
        super().__init__(world_size, rank, group_name)
        import ray_tpu_torch

        # world_size is part of the rendezvous name so a later group that
        # reuses the name with a different size can never adopt a stale
        # coordinator (whose collect() would fire at the old world count).
        actor_name = f"__ray_tpu_torch_collective_{group_name}_w{world_size}"
        coord_cls = ray_tpu_torch.remote(_Coordinator)
        try:
            self._coord = ray_tpu_torch.get_actor(actor_name)
        except ValueError:
            try:
                self._coord = coord_cls.options(
                    name=actor_name, lifetime="detached"
                ).remote(world_size)
            except Exception:
                # lost the creation race
                self._coord = ray_tpu_torch.get_actor(actor_name)
        self._seq = 0
        self._send_tags: Dict[int, int] = {}  # dst -> next tag
        self._recv_tags: Dict[int, int] = {}  # src -> next tag
        self._ray = ray_tpu_torch
        self._inc = ray_tpu_torch.get(self._coord.join.remote(rank))

    @property
    def backend(self) -> str:
        return "store"

    def destroy_group(self) -> None:
        # Drop only local state. The named coordinator actor is shared by
        # all ranks — killing it here would break peers still polling an
        # in-flight op; it dies with the session (or via an explicit
        # ray_tpu_torch.kill by the application).
        self._coord = None

    # -- plumbing ------------------------------------------------------

    def _to_np(self, t) -> np.ndarray:
        if isinstance(t, torch.Tensor):
            t = t.detach()
            if t.dtype == torch.bfloat16:
                t = t.float()
            return t.cpu().numpy()
        return np.asarray(t)

    @staticmethod
    def _out(arr, like=None) -> torch.Tensor:
        """``arr`` as a torch tensor (a copy) on the device of ``like``,
        the tensor this rank gave, in bf16 again if ``like`` was bf16."""
        out = torch.tensor(np.asarray(arr))
        if isinstance(like, torch.Tensor):
            if like.dtype == torch.bfloat16:
                out = out.to(torch.bfloat16)
            out = out.to(like.device)
        return out

    def _exchange(self, op_name: str, payload, timeout_ms: int) -> Dict[int, Any]:
        key = (op_name, self._inc, self._seq)
        self._seq += 1
        self._ray.get(self._coord.post.remote(key, self._rank, payload))
        deadline = time.monotonic() + timeout_ms / 1000.0
        while True:
            box = self._ray.get(self._coord.collect.remote(key))
            if box is not None:
                return box
            if time.monotonic() > deadline:
                raise TimeoutError(
                    f"collective {op_name} timed out in group "
                    f"{self._group_name} (rank {self._rank}); "
                    f"did all {self._world_size} ranks call it?"
                )
            time.sleep(0.001)

    # -- collectives ---------------------------------------------------

    def allreduce(self, tensor, opts: AllReduceOptions = AllReduceOptions()):
        box = self._exchange("allreduce", self._to_np(tensor), opts.timeout_ms)
        red = _np_reduce([box[r] for r in range(self._world_size)], opts.reduceOp)
        return self._out(red, tensor)

    def reduce(self, tensor, opts: ReduceOptions = ReduceOptions()):
        box = self._exchange("reduce", self._to_np(tensor), opts.timeout_ms)
        if self._rank == opts.root_rank:
            return self._out(_np_reduce(
                [box[r] for r in range(self._world_size)], opts.reduceOp
            ), tensor)
        return self._out(self._to_np(tensor), tensor)

    def broadcast(self, tensor, opts: BroadcastOptions = BroadcastOptions()):
        payload = self._to_np(tensor) if self._rank == opts.root_rank else None
        box = self._exchange("broadcast", payload, opts.timeout_ms)
        return self._out(box[opts.root_rank], tensor)

    def allgather(self, tensor, opts: AllGatherOptions = AllGatherOptions()):
        box = self._exchange("allgather", self._to_np(tensor), opts.timeout_ms)
        return self._out(np.stack([box[r] for r in range(self._world_size)]), tensor)

    def reducescatter(
        self, tensor, opts: ReduceScatterOptions = ReduceScatterOptions()
    ):
        arr = self._to_np(tensor)
        if arr.shape[0] % self._world_size != 0:
            raise ValueError(
                f"reducescatter dim0 {arr.shape[0]} not divisible by "
                f"world_size {self._world_size}"
            )
        box = self._exchange("reducescatter", arr, opts.timeout_ms)
        red = _np_reduce([box[r] for r in range(self._world_size)], opts.reduceOp)
        chunk = red.shape[0] // self._world_size
        return self._out(red[self._rank * chunk : (self._rank + 1) * chunk], tensor)

    def barrier(self, opts: BarrierOptions = BarrierOptions()):
        self._exchange("barrier", None, opts.timeout_ms)

    # -- p2p -----------------------------------------------------------

    def send(self, tensor, opts: SendOptions):
        tag = self._send_tags.get(opts.dst_rank, 0)
        self._send_tags[opts.dst_rank] = tag + 1
        self._ray.get(
            self._coord.p2p_send.remote(
                self._rank, opts.dst_rank, (self._inc, tag), self._to_np(tensor)
            )
        )

    def recv(self, opts: RecvOptions):
        tag = self._recv_tags.get(opts.src_rank, 0)
        self._recv_tags[opts.src_rank] = tag + 1
        deadline = time.monotonic() + opts.timeout_ms / 1000.0
        while True:
            ok, payload = self._ray.get(
                self._coord.p2p_recv.remote(
                    opts.src_rank, self._rank, (self._inc, tag)
                )
            )
            if ok:
                return self._out(payload)
            if time.monotonic() > deadline:
                raise TimeoutError(
                    f"recv from rank {opts.src_rank} timed out "
                    f"(group {self._group_name})"
                )
            time.sleep(0.001)
