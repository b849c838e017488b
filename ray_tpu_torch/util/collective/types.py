"""Collective types: reduce ops, backends, group descriptors.

Port of ``ray_tpu/util/collective/types.py`` (reference:
python/ray/util/collective/types.py, ReduceOp, Backend validation,
*Options dataclasses). The primary backend is "nccl": an in-process group
over this process's GPUs whose ops are NCCL calls, where the JAX package's
"xla" group compiles XLA programs over a device mesh; "store" is the
CPU/cross-process group (the reference's gloo role). The ``ReduceOp``
numbers are the JAX package's, not NCCL's: groups map them by name.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import Any, List, Optional


class ReduceOp(enum.Enum):
    SUM = 0
    PRODUCT = 1
    MIN = 2
    MAX = 3
    AVERAGE = 4


class Backend:
    """Validated backend name (reference: types.py Backend class).

    - ``NCCL``: in-process group over this process's GPUs; each op on
      CUDA tensors is one ``torch.cuda.nccl`` call over the per-rank list.
    - ``STORE``: cross-process eager collectives rendezvoused through a
      named coordinator actor (the reference's gloo/NCCLUniqueIDStore
      pattern, nccl_collective_group.py:29-92).
    """

    NCCL = "nccl"
    STORE = "store"
    XLA = "xla"  # rejected with a helpful error (no XLA device mesh here)
    GLOO = "gloo"  # alias of STORE

    def __new__(cls, name: str):
        backend = name.lower() if isinstance(name, str) else name
        if backend == cls.GLOO:
            backend = cls.STORE
        if backend == cls.XLA:
            raise ValueError(
                "XLA is the TPU backend; on GPUs use backend='nccl' (in-process "
                "NCCL group) or backend='store' (CPU/cross-process)."
            )
        if backend not in (cls.NCCL, cls.STORE):
            raise ValueError(f"Unsupported collective backend: {name!r}")
        return backend


@dataclass
class AllReduceOptions:
    reduceOp: ReduceOp = ReduceOp.SUM
    timeout_ms: int = 30000


@dataclass
class BarrierOptions:
    timeout_ms: int = 30000


@dataclass
class ReduceOptions:
    reduceOp: ReduceOp = ReduceOp.SUM
    root_rank: int = 0
    timeout_ms: int = 30000


@dataclass
class BroadcastOptions:
    root_rank: int = 0
    timeout_ms: int = 30000


@dataclass
class AllGatherOptions:
    timeout_ms: int = 30000


@dataclass
class ReduceScatterOptions:
    reduceOp: ReduceOp = ReduceOp.SUM
    timeout_ms: int = 30000


@dataclass
class SendOptions:
    dst_rank: int = 0
    timeout_ms: int = 30000


@dataclass
class RecvOptions:
    src_rank: int = 0
    timeout_ms: int = 30000
