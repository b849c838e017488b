"""DataParallelTrainer + TrainController: the Train-v2 control loop.

Parity: python/ray/train/data_parallel_trainer.py (v1 user API) driven
by the v2-style controller (train/v2/_internal/execution/controller/
controller.py:91): poll the worker group, surface results, consult the
FailurePolicy on worker death, restart the gang from the latest
checkpoint. TPU-native: the gang is all-or-nothing — any worker failure
tears down and re-forms the whole group (a slice runs one SPMD
program; partial worlds are useless).
"""

from __future__ import annotations

import os
import time
import uuid
from typing import Any, Callable, Dict, List, Optional

from ..air.config import CheckpointConfig, FailureConfig, RunConfig, ScalingConfig
from ..air.result import Result
from ._checkpoint import Checkpoint
from ._internal.checkpoint_manager import CheckpointManager
from ._internal.worker_group import WorkerGroup
from .backend import Backend, BackendConfig

_POLL_INTERVAL_S = 0.05


class TrainingFailedError(RuntimeError):
    """Raised when training fails beyond FailureConfig.max_failures
    (parity: ray.train.base_trainer.TrainingFailedError)."""


class DataParallelTrainer:
    """Launch ``train_loop_per_worker`` on a gang of workers.

    Usage parity with the reference:
        trainer = DataParallelTrainer(
            train_loop_per_worker=fn,
            scaling_config=ScalingConfig(num_workers=4, use_tpu=True),
            run_config=RunConfig(name="exp"),
        )
        result = trainer.fit()
    """

    _default_backend_config: BackendConfig = BackendConfig()

    def __init__(
        self,
        train_loop_per_worker: Callable,
        *,
        train_loop_config: Optional[Dict[str, Any]] = None,
        backend_config: Optional[BackendConfig] = None,
        scaling_config: Optional[ScalingConfig] = None,
        run_config: Optional[RunConfig] = None,
        datasets: Optional[Dict[str, Any]] = None,
        resume_from_checkpoint: Optional[Checkpoint] = None,
        metadata: Optional[Dict[str, Any]] = None,
    ):
        self.train_loop_per_worker = train_loop_per_worker
        self.train_loop_config = train_loop_config or {}
        self.backend_config = backend_config or self._default_backend_config
        self.scaling_config = scaling_config or ScalingConfig()
        self.run_config = run_config or RunConfig()
        self.datasets = datasets or {}
        self.resume_from_checkpoint = resume_from_checkpoint
        self.metadata = metadata or {}
        self._callbacks = list(self.run_config.callbacks or [])

    # ------------------------------------------------------------------
    def fit(self) -> Result:
        import ray_tpu_torch

        if not ray_tpu_torch.is_initialized():
            ray_tpu_torch.init(ignore_reinit_error=True)

        name = self.run_config.name or f"train_{uuid.uuid4().hex[:8]}"
        storage_dir = os.path.join(
            os.path.expanduser(self.run_config.storage_path), name
        )
        os.makedirs(storage_dir, exist_ok=True)

        ckpt_mgr = CheckpointManager(self.run_config.checkpoint_config)
        failure_config = self.run_config.failure_config
        latest_ckpt = self.resume_from_checkpoint
        failures = 0
        # survives failed attempts so Result carries the last reported
        # metrics even when fit() ends in error
        self._last_metrics: Optional[Dict[str, Any]] = None
        self._next_iteration = 0
        error: Optional[Exception] = None

        from ._internal.worker_group import GangUnschedulableError

        sc = self.scaling_config
        current_workers = sc.num_workers
        while True:
            try:
                self._run_attempt(
                    name, storage_dir, ckpt_mgr, latest_ckpt,
                    num_workers=current_workers,
                )
                break
            except (TrainingFailedError, GangUnschedulableError) as e:
                failures += 1
                latest_ckpt = ckpt_mgr.latest_checkpoint or latest_ckpt
                allowed = (
                    failure_config.max_failures == -1
                    or failures <= failure_config.max_failures
                )
                if failure_config.fail_fast or not allowed:
                    error = (
                        e if isinstance(e, TrainingFailedError)
                        else TrainingFailedError(str(e))
                    )
                    break
                if (
                    isinstance(e, GangUnschedulableError)
                    and sc.min_workers
                    and current_workers > sc.min_workers
                ):
                    # elastic resize (reference: v2 ScalingPolicy): the
                    # full gang no longer fits — halve toward the floor
                    # and resume from the latest checkpoint
                    current_workers = max(sc.min_workers, current_workers // 2)
                # else: gang restart at the same size from the checkpoint

        checkpoint = ckpt_mgr.latest_checkpoint
        return Result(
            metrics=self._last_metrics,
            checkpoint=checkpoint,
            error=error,
            path=storage_dir,
            best_checkpoints=ckpt_mgr.best_checkpoints,
        )

    # ------------------------------------------------------------------
    def _run_attempt(
        self,
        name: str,
        storage_dir: str,
        ckpt_mgr: CheckpointManager,
        latest_ckpt: Optional[Checkpoint],
        num_workers: Optional[int] = None,
    ) -> None:
        import ray_tpu_torch
        from ..exceptions import ActorError, TaskError

        sc = self.scaling_config
        if num_workers is not None and num_workers != sc.num_workers:
            import dataclasses

            sc = dataclasses.replace(sc, num_workers=num_workers)
        wg = WorkerGroup(sc, name)
        backend: Backend = self.backend_config.backend_cls()
        try:
            wg.start()
            backend.on_start(wg, self.backend_config)
            # per-worker dataset shards (streaming split)
            shards_per_worker = self._split_datasets(len(wg))
            # node-aware ranks: workers are sorted by hostname, so local
            # ranks are positions within each host's contiguous span
            hosts: list = []
            local_ranks = []
            local_sizes: dict = {}
            for w in wg.workers:
                h = w.metadata["hostname"]
                if not hosts or hosts[-1] != h:
                    hosts.append(h)
                local_ranks.append(local_sizes.get(h, 0))
                local_sizes[h] = local_ranks[-1] + 1
            refs = []
            for i, w in enumerate(wg.workers):
                h = w.metadata["hostname"]
                refs.append(
                    w.actor.setup_session.remote(
                        w.rank,
                        storage_dir,
                        latest_ckpt.path if latest_ckpt else None,
                        shards_per_worker[i],
                        self._next_iteration,
                        local_rank=local_ranks[i],
                        local_world_size=local_sizes[h],
                        node_rank=hosts.index(h),
                    )
                )
            ray_tpu_torch.get(refs)
            backend.on_training_start(wg, self.backend_config)
            wg.execute(
                "start_training", self.train_loop_per_worker, self.train_loop_config
            )
            self._control_loop(wg, ckpt_mgr)
        except (ActorError, TaskError, ConnectionError) as e:
            raise TrainingFailedError(str(e)) from e
        finally:
            try:
                backend.on_shutdown(wg, self.backend_config)
            except Exception:
                pass
            wg.shutdown()

    def _split_datasets(self, n: int) -> List[Optional[Dict[str, Any]]]:
        if not self.datasets:
            return [None] * n
        out: List[Dict[str, Any]] = [dict() for _ in range(n)]
        for key, ds in self.datasets.items():
            if hasattr(ds, "streaming_split"):
                splits = ds.streaming_split(n)
            elif hasattr(ds, "split"):
                splits = ds.split(n)
            else:
                splits = [ds] * n  # replicate non-Dataset iterables
            for i in range(n):
                out[i][key] = splits[i]
        return out

    def _control_loop(self, wg: WorkerGroup, ckpt_mgr: CheckpointManager) -> None:
        """Drain report()s until every worker's train_fn returns
        (reference: controller.py:91 control loop + backend_executor
        get_next_results :588 — results consumed iteration-aligned).

        An iteration is processed once, when reports from ALL ranks have
        arrived (reports can straddle poll boundaries); a final flush
        after every worker finishes handles ranks that report unevenly.
        """
        world = len(wg.workers)
        pending: Dict[int, Dict[int, dict]] = {}  # iter -> rank -> row

        def process(it: int, rows: Dict[int, dict]) -> None:
            rank0 = rows.get(0) or rows[min(rows)]
            metrics = dict(rank0["metrics"])
            metrics.setdefault("training_iteration", it + 1)
            self._last_metrics = metrics
            self._next_iteration = max(self._next_iteration, it + 1)
            ckpt_path = rank0.get("checkpoint_path")
            if ckpt_path:
                ckpt_mgr.register(Checkpoint(ckpt_path), metrics)
            for cb in self._callbacks:
                handler = getattr(cb, "on_result", None)
                if handler:
                    handler(metrics)
            if self._should_stop(metrics):
                wg.execute("request_stop")

        while True:
            polls = wg.execute("poll")
            for p in polls:
                for r in p["results"]:
                    pending.setdefault(r["iteration"], {})[r["rank"]] = r
            done = all(p["finished"] for p in polls)
            for it in sorted(pending):
                if len(pending[it]) >= world or done:
                    process(it, pending.pop(it))
                else:
                    break  # keep iteration order: wait for stragglers
            errors = [p["error"] for p in polls if p["error"]]
            if errors:
                raise TrainingFailedError(
                    "training worker failed:\n" + errors[0]
                )
            if done:
                return
            time.sleep(_POLL_INTERVAL_S)

    def _should_stop(self, metrics: Dict[str, Any]) -> bool:
        stop = self.run_config.stop
        if stop is None:
            return False
        if callable(stop):
            return bool(stop(metrics))
        return any(
            k in metrics and metrics[k] >= v for k, v in stop.items()
        )
