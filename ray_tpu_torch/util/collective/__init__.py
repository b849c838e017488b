"""ray_tpu_torch.util.collective — collective communication on GPUs.

Port of ``ray_tpu/util/collective`` (reference:
python/ray/util/collective/__init__.py). Backends: "nccl" (in-process
group over this process's GPUs, each op one NCCL call) and "store"
(cross-process via a named coordinator actor).
"""

from .collective import (
    allgather,
    allreduce,
    barrier,
    broadcast,
    create_collective_group,
    destroy_collective_group,
    get_collective_group_size,
    get_group_handle,
    get_rank,
    init_collective_group,
    is_group_initialized,
    recv,
    reduce,
    reducescatter,
    send,
)
from .types import Backend, ReduceOp

__all__ = [
    "Backend",
    "ReduceOp",
    "allgather",
    "allreduce",
    "barrier",
    "broadcast",
    "create_collective_group",
    "destroy_collective_group",
    "get_collective_group_size",
    "get_group_handle",
    "get_rank",
    "init_collective_group",
    "is_group_initialized",
    "recv",
    "reduce",
    "reducescatter",
    "send",
]
