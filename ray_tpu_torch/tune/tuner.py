"""Tuner + TuneController: the experiment control loop.

Parity: python/ray/tune/tuner.py (Tuner.fit :312) driving
tune/execution/tune_controller.py:68 — an event loop that creates trial
actors, consumes their reported results, consults the scheduler
(stop/continue/exploit) and searcher (next configs), and assembles a
ResultGrid. Trials are TrainWorker actors (one-worker gangs) reusing
the Train session/report/checkpoint machinery — the same unification
the reference converged on (ray.tune.report == ray.train.report).

Port of ``ray_tpu/tune/tuner.py``. A trial that asks for "GPU" gets
``num_gpus``, the pinned resource: its actor sees its cards as
``CUDA_VISIBLE_DEVICES`` before user code runs ("TPU" stays ``num_tpus``,
the countable resource). A trial that wraps a Trainer holds no GPU itself:
the trainer's gang does, and on one card a trial actor holding it would
leave a ``use_gpu`` gang waiting for ever. No more trials run at once than
the cluster holds of each resource a trial asks for, since a trial actor
that cannot be placed would block the loop in ``_start_trial``.
"""

from __future__ import annotations

import os
import time
import uuid
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Union

from ..air.config import CheckpointConfig, RunConfig
from ..air.result import Result
from ..train._checkpoint import Checkpoint
from ..train._internal.worker_group import TrainWorker
from .sample import Domain, GridSearch
from .schedulers import CONTINUE, STOP, FIFOScheduler, TrialScheduler
from .search import BasicVariantGenerator, Searcher

_POLL_S = 0.05


@dataclass
class TuneConfig:
    """Parity: ray.tune.TuneConfig."""

    metric: Optional[str] = None
    mode: str = "min"
    num_samples: int = 1
    max_concurrent_trials: Optional[int] = None
    search_alg: Optional[Searcher] = None
    scheduler: Optional[TrialScheduler] = None
    trial_resources: Optional[Dict[str, float]] = None
    seed: Optional[int] = None


class ResultGrid:
    """Parity: ray.tune.ResultGrid."""

    def __init__(self, results: List[Result], metric: Optional[str], mode: str):
        self._results = results
        self._metric = metric
        self._mode = mode

    def __len__(self):
        return len(self._results)

    def __getitem__(self, i: int) -> Result:
        return self._results[i]

    def __iter__(self):
        return iter(self._results)

    @property
    def errors(self) -> List[Exception]:
        return [r.error for r in self._results if r.error]

    def get_best_result(
        self, metric: Optional[str] = None, mode: Optional[str] = None
    ) -> Result:
        metric = metric or self._metric
        mode = mode or self._mode
        if metric is None:
            raise ValueError("metric required (set TuneConfig.metric or pass one)")
        sign = 1.0 if mode == "max" else -1.0
        candidates = [
            r for r in self._results if r.metrics and metric in r.metrics
        ]
        if not candidates:
            raise RuntimeError("no trial reported the requested metric")
        return max(candidates, key=lambda r: sign * float(r.metrics[metric]))

    def get_dataframe(self):
        import pandas as pd

        return pd.DataFrame([r.metrics or {} for r in self._results])


@dataclass
class _Trial:
    trial_id: str
    config: Dict[str, Any]
    actor: Any = None
    status: str = "PENDING"  # PENDING RUNNING TERMINATED ERROR
    last_metrics: Optional[Dict[str, Any]] = None
    checkpoint_path: Optional[str] = None
    error: Optional[str] = None
    storage_dir: str = ""
    iteration: int = 0


def _is_trainer(trainable) -> bool:
    return hasattr(trainable, "fit") and hasattr(trainable, "train_loop_per_worker")


def with_resources(trainable: Callable, resources: Dict[str, float]) -> Callable:
    """Parity: tune.with_resources — attach per-trial resources."""
    trainable.__tune_resources__ = dict(resources)
    return trainable


class Tuner:
    def __init__(
        self,
        trainable: Union[Callable, Any],
        *,
        param_space: Optional[Dict[str, Any]] = None,
        tune_config: Optional[TuneConfig] = None,
        run_config: Optional[RunConfig] = None,
    ):
        self.trainable = trainable
        self.param_space = param_space or {}
        self.tune_config = tune_config or TuneConfig()
        self.run_config = run_config or RunConfig()
        self._restored_state: Optional[dict] = None

    # ------------------------------------------------------------------
    @classmethod
    def restore(
        cls,
        path: str,
        trainable: Union[Callable, Any],
        *,
        resume_unfinished: bool = True,
        restart_errored: bool = False,
    ) -> "Tuner":
        """Resume an interrupted experiment from its directory
        (reference: Tuner.restore + tune/execution/experiment_state.py).
        Rehydrates the searcher/scheduler state and every trial's
        config/status/last-checkpoint; unfinished trials continue from
        their checkpoints, finished ones keep their results."""
        import cloudpickle

        state_path = os.path.join(path, "experiment_state.pkl")
        with open(state_path, "rb") as f:
            state = cloudpickle.load(f)
        tuner = cls(
            trainable,
            param_space=state["param_space"],
            tune_config=state["tune_config"],
            run_config=state["run_config"],
        )
        for t in state["trials"]:
            if t["status"] == "RUNNING" or (
                t["status"] == "PENDING" and resume_unfinished
            ):
                t["status"] = "PENDING"  # relaunch from checkpoint
            elif t["status"] == "ERROR" and restart_errored:
                t["status"] = "PENDING"
                t["error"] = None
        if not resume_unfinished:
            state["trials"] = [
                t for t in state["trials"] if t["status"] != "PENDING"
            ]
        tuner._restored_state = state
        return tuner

    @staticmethod
    def can_restore(path: str) -> bool:
        return os.path.exists(os.path.join(path, "experiment_state.pkl"))

    def _save_state(self, exp_dir, name, trials, counter, searcher, scheduler):
        """Atomic experiment snapshot after every trial-state change —
        the crash-consistency contract Tuner.restore relies on."""
        import cloudpickle

        state = {
            "name": name,
            "counter": counter,
            "param_space": self.param_space,
            "tune_config": self.tune_config,
            "run_config": self.run_config,
            "searcher": searcher,
            "scheduler": scheduler,
            "trials": [
                {
                    "trial_id": t.trial_id,
                    "config": t.config,
                    "status": t.status if t.status != "RUNNING" else "RUNNING",
                    "last_metrics": t.last_metrics,
                    "checkpoint_path": t.checkpoint_path,
                    "error": t.error,
                    "storage_dir": t.storage_dir,
                    "iteration": t.iteration,
                }
                for t in trials.values()
            ],
        }
        tmp = os.path.join(exp_dir, ".experiment_state.tmp")
        with open(tmp, "wb") as f:
            cloudpickle.dump(state, f)
        os.replace(tmp, os.path.join(exp_dir, "experiment_state.pkl"))

    # ------------------------------------------------------------------
    def fit(self) -> ResultGrid:
        import ray_tpu_torch

        if not ray_tpu_torch.is_initialized():
            ray_tpu_torch.init(ignore_reinit_error=True)

        tc = self.tune_config
        restored = self._restored_state
        if restored is not None:
            name = restored["name"]
        else:
            name = self.run_config.name or f"tune_{uuid.uuid4().hex[:8]}"
        exp_dir = os.path.join(os.path.expanduser(self.run_config.storage_path), name)
        os.makedirs(exp_dir, exist_ok=True)

        if restored is not None:
            searcher = restored["searcher"]
            scheduler = restored["scheduler"]
        else:
            searcher = tc.search_alg or BasicVariantGenerator(
                self.param_space, num_samples=tc.num_samples, seed=tc.seed
            )
            scheduler = tc.scheduler or FIFOScheduler()
        scheduler.set_metric_and_mode(tc.metric, tc.mode)

        max_conc = tc.max_concurrent_trials or 4
        trials: Dict[str, _Trial] = {}
        counter = 0
        resume_queue: List[_Trial] = []
        if restored is not None:
            counter = restored["counter"]
            for t in restored["trials"]:
                trial = _Trial(
                    trial_id=t["trial_id"],
                    config=t["config"],
                    status=t["status"],
                    last_metrics=t["last_metrics"],
                    checkpoint_path=t["checkpoint_path"],
                    error=t["error"],
                    storage_dir=t["storage_dir"],
                    iteration=t["iteration"],
                )
                trials[trial.trial_id] = trial
                if trial.status == "PENDING":
                    resume_queue.append(trial)
        # Custom searchers (e.g. Optuna) can suggest unboundedly; cap
        # them at num_samples. BasicVariantGenerator self-limits (grid ×
        # num_samples) and reports exhaustion via is_finished().
        own_searcher = tc.search_alg is None
        trial_cap = None if own_searcher else max(tc.num_samples, 1)

        train_fn = self._as_train_fn()
        resources = dict(
            getattr(self.trainable, "__tune_resources__", None)
            or tc.trial_resources
            or {"CPU": 1}
        )
        if _is_trainer(self.trainable):
            resources.pop("GPU", None)
        total = ray_tpu_torch.cluster_resources()
        for key, amount in resources.items():
            if amount > 0:
                max_conc = min(max_conc, max(1, int(total.get(key, 0) // amount)))

        def exhausted() -> bool:
            if searcher.is_finished():
                return True
            return trial_cap is not None and counter >= trial_cap

        dirty = True
        while True:
            # launch new trials up to the concurrency cap
            starved = False
            running = [t for t in trials.values() if t.status == "RUNNING"]
            # restored unfinished trials resume first (from checkpoint)
            while resume_queue and len(running) < max_conc:
                trial = resume_queue.pop(0)
                if hasattr(scheduler, "register_config"):
                    scheduler.register_config(trial.trial_id, trial.config)
                self._start_trial(trial, train_fn, resources)
                running.append(trial)
                dirty = True
            while not exhausted() and len(running) < max_conc:
                trial_id = f"{name}_{counter:05d}"
                cfg = searcher.suggest(trial_id)
                if cfg is None:
                    starved = True
                    break  # not now (concurrency-limited); retry next tick
                counter += 1
                trial = _Trial(trial_id, cfg, storage_dir=os.path.join(exp_dir, trial_id))
                if hasattr(scheduler, "register_config"):
                    scheduler.register_config(trial_id, cfg)
                self._start_trial(trial, train_fn, resources)
                trials[trial_id] = trial
                running.append(trial)
                dirty = True

            if not running:
                # nothing in flight and the searcher has nothing to give
                # right now — with no live trials to unblock it, that is
                # terminal (covers custom searchers with no is_finished)
                if exhausted() or starved:
                    break
                time.sleep(_POLL_S)
                continue

            # poll running trials
            import ray_tpu_torch as ray

            for trial in list(running):
                try:
                    # sequential by design: per-trial error attribution
                    # needs each poll's exception on its own trial
                    poll = ray.get(trial.actor.poll.remote())  # graftlint: disable=GL004
                except Exception as e:
                    trial.status = "ERROR"
                    trial.error = str(e)
                    self._stop_actor(trial)
                    searcher.on_trial_complete(trial.trial_id, trial.last_metrics)
                    scheduler.on_trial_complete(trial.trial_id)
                    continue
                for row in poll["results"]:
                    metrics = dict(row["metrics"])
                    trial.iteration = row["iteration"] + 1
                    metrics.setdefault("training_iteration", trial.iteration)
                    metrics["trial_id"] = trial.trial_id
                    metrics["config"] = trial.config
                    trial.last_metrics = metrics
                    if row.get("checkpoint_path"):
                        trial.checkpoint_path = row["checkpoint_path"]
                        dirty = True
                    decision = scheduler.on_result(trial.trial_id, metrics)
                    if decision == STOP:
                        # rare control-path call, one trial at a time
                        ray.get(trial.actor.request_stop.remote())  # graftlint: disable=GL004
                # PBT exploit hook — only for trials still mid-training;
                # a finished/errored trial's poll flags belong to the OLD
                # actor and would immediately kill the exploit restart
                if not poll["finished"] and not poll["error"]:
                    exploit = scheduler.exploit(trial.trial_id)
                    if exploit is not None:
                        source_id, new_config = exploit
                        source = trials.get(source_id)
                        applied = self._exploit_trial(
                            trial, source, new_config, train_fn, resources
                        )
                        if applied and hasattr(scheduler, "commit_exploit"):
                            scheduler.commit_exploit(trial.trial_id, new_config)
                        if applied:
                            continue  # fresh actor; re-poll next tick
                if poll["error"]:
                    trial.status = "ERROR"
                    trial.error = poll["error"]
                    self._stop_actor(trial)
                    searcher.on_trial_complete(trial.trial_id, trial.last_metrics)
                    scheduler.on_trial_complete(trial.trial_id)
                    dirty = True
                elif poll["finished"]:
                    trial.status = "TERMINATED"
                    self._stop_actor(trial)
                    searcher.on_trial_complete(trial.trial_id, trial.last_metrics)
                    scheduler.on_trial_complete(trial.trial_id)
                    dirty = True
            if dirty:
                # crash-consistent snapshot for Tuner.restore
                self._save_state(exp_dir, name, trials, counter, searcher, scheduler)
                dirty = False
            time.sleep(_POLL_S)

        self._save_state(exp_dir, name, trials, counter, searcher, scheduler)
        results = [
            Result(
                metrics=t.last_metrics,
                checkpoint=Checkpoint(t.checkpoint_path) if t.checkpoint_path else None,
                error=RuntimeError(t.error) if t.error else None,
                path=t.storage_dir,
            )
            for t in trials.values()
        ]
        return ResultGrid(results, tc.metric, tc.mode)

    # ------------------------------------------------------------------
    def _as_train_fn(self) -> Callable:
        trainable = self.trainable
        if _is_trainer(trainable):
            # a Trainer instance: each trial runs trainer.fit() with the
            # trial config merged into train_loop_config (reference:
            # BaseTrainer wrapped as a Tune trainable, §3.4 step 1)
            def run_trainer(config):
                import copy
                import dataclasses

                from ..train.session import get_context, report as _report

                t = copy.copy(trainable)
                t.train_loop_config = {**(trainable.train_loop_config or {}), **config}
                # each trial gets its OWN storage namespace — trials
                # sharing the trainer's run name would overwrite each
                # other's checkpoint dirs
                trial_name = get_context().experiment_name
                rc = trainable.run_config
                t.run_config = dataclasses.replace(
                    rc, name=f"{rc.name or 'trainer'}_{trial_name}"
                )
                result = t.fit()
                if result.error:
                    raise result.error
                # surface the inner run's final metrics as THIS trial's
                # report so the controller/searcher see them
                if result.metrics:
                    _report(
                        {k: v for k, v in result.metrics.items() if k != "config"}
                    )
                return result.metrics

            return run_trainer
        return trainable

    def _start_trial(self, trial: _Trial, train_fn, resources) -> None:
        import ray_tpu_torch

        worker_cls = ray_tpu_torch.remote(TrainWorker)
        opts: Dict[str, Any] = {"num_cpus": resources.get("CPU", 1)}
        if resources.get("TPU"):
            opts["num_tpus"] = resources["TPU"]
        if resources.get("GPU"):
            opts["num_gpus"] = resources["GPU"]
        trial.actor = worker_cls.options(**opts).remote(1, trial.trial_id)
        os.makedirs(trial.storage_dir, exist_ok=True)
        ray_tpu_torch.get(
            trial.actor.setup_session.remote(
                0,
                trial.storage_dir,
                trial.checkpoint_path,
                None,
                trial.iteration,
                True,  # sync_reports: step-synchronize with the controller
            )
        )
        ray_tpu_torch.get(trial.actor.start_training.remote(train_fn, trial.config))
        trial.status = "RUNNING"

    def _stop_actor(self, trial: _Trial) -> None:
        import ray_tpu_torch

        if trial.actor is not None:
            try:
                ray_tpu_torch.kill(trial.actor)
            except Exception:
                pass
            trial.actor = None

    def _exploit_trial(
        self, trial: _Trial, source: Optional[_Trial], new_config, train_fn, resources
    ) -> bool:
        """PBT exploit: restart `trial` from `source`'s checkpoint with
        mutated config (reference: pbt.py _exploit). Returns whether the
        exploit was applied (False when the source has no checkpoint
        yet — the scheduler's population record stays untouched)."""
        if source is None or source.checkpoint_path is None:
            return False
        self._stop_actor(trial)
        trial.config = dict(new_config)
        trial.checkpoint_path = source.checkpoint_path
        self._start_trial(trial, train_fn, resources)
        return True
