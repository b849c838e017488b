"""Run/scaling/failure/checkpoint configs.

Port of ``ray_tpu/air/config.py`` (reference: python/ray/air/config.py,
ScalingConfig :103, FailureConfig :398, CheckpointConfig :448, RunConfig
:597). GPUs are the pinned accelerator here: ``use_gpu`` gives each
worker ``gpus_per_worker`` cards (default 1), which the runtime pins to
the worker's process through ``CUDA_VISIBLE_DEVICES``. ``use_tpu`` and
``tpu_chips_per_worker`` stay so that a reference program binds; they ask
for the plain countable "TPU" resource. ``topology`` is accepted and
inert, as SLICE placement is.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Union


@dataclass
class ScalingConfig:
    """How many workers, with what resources each.

    num_workers: training processes (one per GPU for data-parallel
    training). use_gpu: give each worker ``gpus_per_worker`` GPUs
    (default 1), pinned to its process. use_tpu: ask for the countable
    "TPU" resource (``tpu_chips_per_worker``, default 1).
    resources_per_worker overrides the per-worker resource dict.
    topology: the reference's slice topology string; inert here.
    """

    num_workers: int = 1
    use_tpu: bool = False
    use_gpu: bool = False
    tpu_chips_per_worker: Optional[int] = None
    resources_per_worker: Optional[Dict[str, float]] = None
    placement_strategy: str = "PACK"
    topology: Optional[str] = None
    trainer_resources: Optional[Dict[str, float]] = None
    # elastic training (reference: train/v2 ScalingPolicy + elastic
    # resize): when set, a gang that cannot be placed at num_workers
    # after a failure restarts at a smaller size (halving down to this
    # floor) instead of failing the run.
    min_workers: Optional[int] = None
    placement_timeout_s: float = 60.0
    gpus_per_worker: Optional[int] = None

    def _resources_per_worker_not_none(self) -> Dict[str, float]:
        if self.resources_per_worker is not None:
            return dict(self.resources_per_worker)
        res: Dict[str, float] = {"CPU": 1.0}
        if self.use_tpu:
            res["TPU"] = float(self.tpu_chips_per_worker or 1)
        if self.use_gpu:
            res["GPU"] = float(self.gpus_per_worker or 1)
        return res

    @property
    def num_tpus_per_worker(self) -> float:
        return self._resources_per_worker_not_none().get("TPU", 0.0)

    @property
    def num_gpus_per_worker(self) -> float:
        return self._resources_per_worker_not_none().get("GPU", 0.0)

    def as_placement_group_factory(self):
        from ..util.placement_group import placement_group

        bundles = [self._resources_per_worker_not_none() for _ in range(self.num_workers)]
        if self.trainer_resources:
            bundles = [dict(self.trainer_resources)] + bundles
        return lambda: placement_group(bundles, strategy=self.placement_strategy)

    @property
    def total_resources(self) -> Dict[str, float]:
        out: Dict[str, float] = dict(self.trainer_resources or {})
        per_worker = self._resources_per_worker_not_none()
        for k, v in per_worker.items():
            out[k] = out.get(k, 0.0) + v * self.num_workers
        return out


@dataclass
class FailureConfig:
    """Retries on worker-group failure (reference :398). Gangs are
    all-or-nothing: any worker death fails the gang; the controller
    restarts the whole group from the latest checkpoint."""

    max_failures: int = 0
    fail_fast: bool = False


@dataclass
class CheckpointConfig:
    """Top-k retention (reference :448)."""

    num_to_keep: Optional[int] = None
    checkpoint_score_attribute: Optional[str] = None
    checkpoint_score_order: str = "max"
    checkpoint_frequency: int = 0
    checkpoint_at_end: Optional[bool] = None

    def __post_init__(self):
        if self.checkpoint_score_order not in ("max", "min"):
            raise ValueError("checkpoint_score_order must be 'max' or 'min'")
        if self.num_to_keep is not None and self.num_to_keep <= 0:
            raise ValueError("num_to_keep must be positive or None")


@dataclass
class RunConfig:
    """Experiment-level config (reference :597). ``storage_path``
    defaults to ``$RAY_TPU_TORCH_STORAGE_PATH``, else
    ``~/ray_tpu_torch_results``."""

    name: Optional[str] = None
    storage_path: Optional[str] = None
    failure_config: Optional[FailureConfig] = None
    checkpoint_config: Optional[CheckpointConfig] = None
    stop: Optional[Union[Dict[str, Any], Callable]] = None
    verbose: int = 1
    log_to_file: bool = False
    callbacks: Optional[List[Any]] = None

    def __post_init__(self):
        if self.storage_path is None:
            self.storage_path = os.path.expanduser(
                os.environ.get("RAY_TPU_TORCH_STORAGE_PATH", "~/ray_tpu_torch_results")
            )
        if self.failure_config is None:
            self.failure_config = FailureConfig()
        if self.checkpoint_config is None:
            self.checkpoint_config = CheckpointConfig()
