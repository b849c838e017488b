"""Worker-side training session: context, report(), checkpoints.

Parity: python/ray/train/_internal/session.py (_TrainSession :112,
report :405,672) + the public ray.train.get_context()/report() surface.
The session lives inside each TrainWorker actor; ``report`` persists
the checkpoint into the run's storage path and enqueues (metrics,
checkpoint_path) for the controller to drain — the reference's
worker→driver result queue, without Tune in the loop (Train-v2 shape).
"""

from __future__ import annotations

import os
import queue
import shutil
import threading
from dataclasses import dataclass
from typing import Any, Dict, Optional

from ._checkpoint import Checkpoint

_session_lock = threading.Lock()
_session: Optional["_TrainSession"] = None


@dataclass
class TrainContext:
    """What user train_fns can ask about their world
    (parity: ray.train.get_context() TrainContext)."""

    world_size: int
    world_rank: int
    local_rank: int
    local_world_size: int
    node_rank: int
    experiment_name: str
    trial_name: str = ""
    trial_id: str = ""

    def get_world_size(self) -> int:
        return self.world_size

    def get_world_rank(self) -> int:
        return self.world_rank

    def get_local_rank(self) -> int:
        return self.local_rank

    def get_local_world_size(self) -> int:
        return self.local_world_size

    def get_node_rank(self) -> int:
        return self.node_rank

    def get_experiment_name(self) -> str:
        return self.experiment_name

    def get_trial_name(self) -> str:
        return self.trial_name

    def get_trial_id(self) -> str:
        return self.trial_id


class _TrainSession:
    def __init__(
        self,
        context: TrainContext,
        storage_dir: str,
        latest_checkpoint: Optional[Checkpoint] = None,
        dataset_shards: Optional[Dict[str, Any]] = None,
        start_iteration: int = 0,
        sync_reports: bool = False,
    ):
        self.context = context
        self.storage_dir = storage_dir
        # sync mode (Tune trials): report() blocks until the controller
        # drains — step-synchronized training, so schedulers (ASHA/PBT)
        # can stop/exploit between iterations (the reference's function
        # trainables block in session.report the same way)
        self.result_queue: "queue.Queue" = queue.Queue(
            maxsize=1 if sync_reports else 0
        )
        self.latest_checkpoint = latest_checkpoint
        self.dataset_shards = dataset_shards or {}
        # Continues across gang restarts (controller passes the next
        # global iteration) so checkpoint_NNNNNN dirs never collide with
        # a previous attempt's.
        self.iteration = start_iteration
        self.stop_requested = threading.Event()

    def report(self, metrics: Dict[str, Any], checkpoint: Optional[Checkpoint] = None):
        persisted_path = None
        if checkpoint is not None:
            # rank-0 commits the checkpoint into run storage (the
            # reference's StorageContext.persist_current_checkpoint,
            # train/_internal/storage.py:358); other ranks may report
            # their own shards in multi-host mode — same dir, distinct
            # subpaths, so commits never collide.
            name = f"checkpoint_{self.iteration:06d}"
            if self.context.world_rank == 0:
                dest = os.path.join(self.storage_dir, name)
            else:
                dest = os.path.join(
                    self.storage_dir, name, f"rank_{self.context.world_rank}"
                )
            os.makedirs(os.path.dirname(dest), exist_ok=True)
            if os.path.abspath(checkpoint.path) != os.path.abspath(dest):
                shutil.copytree(checkpoint.path, dest, dirs_exist_ok=True)
            persisted_path = os.path.join(self.storage_dir, name)
            self.latest_checkpoint = Checkpoint(persisted_path)
        self.result_queue.put(
            {
                "metrics": dict(metrics),
                "checkpoint_path": persisted_path,
                "iteration": self.iteration,
                "rank": self.context.world_rank,
            }
        )
        self.iteration += 1
        if self.stop_requested.is_set():
            raise StopIteration("training stop requested by controller")


def _init_session(session: "_TrainSession") -> None:
    global _session
    with _session_lock:
        _session = session


def _shutdown_session() -> None:
    global _session
    with _session_lock:
        _session = None


def _get_session() -> Optional["_TrainSession"]:
    return _session


# ------------------------------------------------------------- public API


def report(metrics: Dict[str, Any], checkpoint: Optional[Checkpoint] = None) -> None:
    """Report metrics (+ optional checkpoint) from a train_fn
    (parity: ray.train.report, train/_internal/session.py:672)."""
    s = _get_session()
    if s is None:
        raise RuntimeError(
            "ray_tpu_torch.train.report() called outside a training worker"
        )
    s.report(metrics, checkpoint)


def get_context() -> TrainContext:
    s = _get_session()
    if s is None:
        # driver-side default context (world of 1), matching the
        # reference's behavior of degrading gracefully outside training
        return TrainContext(1, 0, 0, 1, 0, "default")
    return s.context


def get_checkpoint() -> Optional[Checkpoint]:
    """Latest committed checkpoint — how train_fns resume after a
    restart (parity: ray.train.get_checkpoint)."""
    s = _get_session()
    return s.latest_checkpoint if s else None


def get_dataset_shard(name: str = "train"):
    """This worker's split of the Dataset passed to the trainer
    (parity: ray.train.get_dataset_shard; reference
    train/_internal/data_config.py:66 streaming_split)."""
    s = _get_session()
    if s is None:
        raise RuntimeError("get_dataset_shard() called outside a training worker")
    return s.dataset_shards.get(name)
