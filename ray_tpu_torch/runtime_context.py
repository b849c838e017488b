"""ray_tpu_torch.get_runtime_context(): where am I running?

Parity: python/ray/runtime_context.py (`ray.get_runtime_context()` —
get_node_id/get_job_id/get_worker_id/get_task_id/get_actor_id,
accelerator ids). Identity comes from the process's CoreClient; the
current task/actor ids are contextvars set by the worker executor
around every user-code invocation, so nested helper calls and async
actor methods all see the right ids.
"""

from __future__ import annotations

import contextvars
import os
from typing import List, Optional

_current_task_id: contextvars.ContextVar[Optional[bytes]] = (
    contextvars.ContextVar("ray_tpu_task_id", default=None)
)
# (pg_id bytes, bundle_idx) of the currently-executing task, or None;
# set by the worker executor, read by get_current_placement_group()
_current_pg: contextvars.ContextVar[Optional[tuple]] = (
    contextvars.ContextVar("ray_tpu_current_pg", default=None)
)


class RuntimeContext:
    def get_node_id(self) -> str:
        from ._private import worker

        if worker.is_initialized():
            return worker.get_client().node_id
        return os.environ.get("RAY_TPU_TORCH_NODE_ID", "node0")

    def get_worker_id(self) -> str:
        from ._private import worker

        if worker.is_initialized():
            return worker.get_client().worker_id
        return "driver"

    def get_job_id(self) -> str:
        # one hub session = one job in this runtime's model
        return os.environ.get("RAY_TPU_TORCH_JOB_ID", "job0")

    def get_task_id(self) -> Optional[str]:
        """Hex id of the currently-executing task (None on the driver)."""
        tid = _current_task_id.get()
        return tid.hex() if tid is not None else None

    def get_actor_id(self) -> Optional[str]:
        """Hex id of the current actor (None outside an actor)."""
        from ._private import worker

        runtime = getattr(worker, "_worker_runtime", None)
        if runtime is not None and runtime.actor_id is not None:
            return runtime.actor_id.hex()
        return None

    def get_accelerator_ids(self) -> dict:
        """Visible accelerator ids (the reference reads TPU_VISIBLE_CHIPS;
        the port pins GPUs through CUDA_VISIBLE_DEVICES)."""
        ids = os.environ.get("CUDA_VISIBLE_DEVICES", "")
        return {"GPU": [c for c in ids.split(",") if c]}

    @property
    def was_current_actor_reconstructed(self) -> bool:
        # per-runtime flag, not os.environ: a process-wide env var would
        # leak one actor's restart marker to later actors hosted by the
        # same worker
        from ._private import worker

        runtime = getattr(worker, "_worker_runtime", None)
        if runtime is not None:
            return bool(getattr(runtime, "actor_restarted", False))
        return False


_context = RuntimeContext()


def get_runtime_context() -> RuntimeContext:
    return _context
