"""Trial schedulers: FIFO, ASHA, PBT.

Parity: python/ray/tune/schedulers/ (FIFOScheduler; ASHA
async_hyperband.py — asynchronous successive halving with rungs; PBT
pbt.py — exploit top quantile + explore by mutation).
"""

from __future__ import annotations

import math
import random
from collections import defaultdict
from typing import Any, Dict, List, Optional

CONTINUE = "CONTINUE"
STOP = "STOP"


class TrialScheduler:
    metric: Optional[str] = None
    mode: Optional[str] = None

    @property
    def _sign(self) -> float:
        return -1.0 if (self.mode or "min") == "min" else 1.0

    def set_metric_and_mode(self, metric: Optional[str], mode: Optional[str]) -> None:
        """Fill UNSET metric/mode from TuneConfig (controller calls this
        before launching trials); explicit scheduler args win."""
        if self.metric is None and metric:
            self.metric = metric
        if self.mode is None and mode:
            self.mode = mode

    def on_result(self, trial_id: str, metrics: Dict[str, Any]) -> str:
        return CONTINUE

    def on_trial_complete(self, trial_id: str) -> None:
        pass

    # PBT hook: returns (source_trial_id, new_config) when the trial
    # should exploit another, else None
    def exploit(self, trial_id: str) -> Optional[tuple]:
        return None


class FIFOScheduler(TrialScheduler):
    pass


class ASHAScheduler(TrialScheduler):
    """Asynchronous successive halving (reference:
    tune/schedulers/async_hyperband.py AsyncHyperBandScheduler).

    A trial reaching rung r (iteration = grace_period *
    reduction_factor^r) continues only if its metric is in the top
    1/reduction_factor of results recorded at that rung.
    """

    def __init__(
        self,
        metric: Optional[str] = None,
        mode: Optional[str] = None,
        max_t: int = 100,
        grace_period: int = 1,
        reduction_factor: int = 4,
        time_attr: str = "training_iteration",
    ):
        # metric/mode may be deferred to TuneConfig (resolved by the
        # controller via set_metric_and_mode before the run starts)
        self.metric = metric
        self.mode = mode
        self.max_t = max_t
        self.grace = grace_period
        self.rf = reduction_factor
        self.time_attr = time_attr
        # rung iteration -> list of recorded metric values
        self._rungs: Dict[int, List[float]] = defaultdict(list)
        # trial -> rung levels it has already been evaluated at
        self._recorded: Dict[str, set] = defaultdict(set)

    def _rung_levels(self) -> List[int]:
        levels = []
        t = self.grace
        while t < self.max_t:
            levels.append(t)
            t *= self.rf
        return levels

    def on_result(self, trial_id: str, metrics: Dict[str, Any]) -> str:
        t = metrics.get(self.time_attr, 0)
        val = metrics.get(self.metric) if self.metric else None
        if val is None:
            return CONTINUE
        if t >= self.max_t:
            return STOP
        # evaluate at every rung level CROSSED since the last report —
        # time_attr need not land exactly on grace * rf^r (a trial
        # reporting at t=1000, 2000, ... still hits rungs 1, 4, 16, ...)
        for level in self._rung_levels():
            if t >= level and level not in self._recorded[trial_id]:
                self._recorded[trial_id].add(level)
                rung = self._rungs[level]
                rung.append(self._sign * float(val))
                k = max(1, len(rung) // self.rf)
                cutoff = sorted(rung, reverse=True)[k - 1]
                if self._sign * float(val) < cutoff:
                    return STOP
        return CONTINUE


class PopulationBasedTraining(TrialScheduler):
    """PBT (reference: tune/schedulers/pbt.py): every
    ``perturbation_interval`` iterations, bottom-quantile trials clone
    the state of a top-quantile trial (checkpoint exploit) and mutate
    its hyperparameters (explore)."""

    def __init__(
        self,
        metric: Optional[str] = None,
        mode: Optional[str] = None,
        perturbation_interval: int = 5,
        hyperparam_mutations: Optional[Dict[str, Any]] = None,
        quantile_fraction: float = 0.25,
        time_attr: str = "training_iteration",
        seed: Optional[int] = None,
    ):
        self.metric = metric
        self.mode = mode
        self.interval = perturbation_interval
        self.mutations = hyperparam_mutations or {}
        self.quantile = quantile_fraction
        self.time_attr = time_attr
        self._latest: Dict[str, Dict[str, Any]] = {}
        self._configs: Dict[str, Dict[str, Any]] = {}
        self._last_perturb: Dict[str, int] = {}
        self._rng = random.Random(seed)

    def register_config(self, trial_id: str, config: Dict[str, Any]) -> None:
        self._configs[trial_id] = dict(config)

    def on_result(self, trial_id: str, metrics: Dict[str, Any]) -> str:
        self._latest[trial_id] = dict(metrics)
        return CONTINUE

    def on_trial_complete(self, trial_id: str) -> None:
        # drop the finished trial's state: it can no longer perturb and
        # must leave the exploit pool — and a long tuning run must not
        # accumulate one config/metrics dict per completed trial (GL009)
        self._configs.pop(trial_id, None)
        self._latest.pop(trial_id, None)
        self._last_perturb.pop(trial_id, None)

    def exploit(self, trial_id: str) -> Optional[tuple]:
        m = self._latest.get(trial_id)
        if not m or not self.metric or self.metric not in m:
            return None
        t = m.get(self.time_attr, 0)
        if t - self._last_perturb.get(trial_id, 0) < self.interval:
            return None
        scores = {
            tid: self._sign * float(mm[self.metric])
            for tid, mm in self._latest.items()
            if self.metric in mm
        }
        if len(scores) < 2:
            return None
        ranked = sorted(scores, key=scores.get, reverse=True)
        n = len(ranked)
        k = max(1, int(n * self.quantile))
        top, bottom = ranked[:k], ranked[n - k :]
        if trial_id not in bottom or trial_id in top:
            self._last_perturb[trial_id] = t
            return None
        source = self._rng.choice(top)
        new_config = self._mutate(self._configs.get(source, {}))
        # NOT committed yet: the controller confirms via commit_exploit
        # only after the restart-from-checkpoint actually happens, so a
        # skipped exploit (source has no checkpoint yet) leaves this
        # trial's population record truthful.
        return source, new_config

    def commit_exploit(self, trial_id: str, new_config: Dict[str, Any]) -> None:
        t = self._latest.get(trial_id, {}).get(self.time_attr, 0)
        self._last_perturb[trial_id] = t
        self._configs[trial_id] = dict(new_config)

    def _mutate(self, config: Dict[str, Any]) -> Dict[str, Any]:
        from .sample import Domain

        out = dict(config)
        for k, spec in self.mutations.items():
            if isinstance(spec, Domain):
                out[k] = spec.sample(self._rng)
            elif isinstance(spec, list):
                out[k] = self._rng.choice(spec)
            elif callable(spec):
                out[k] = spec()
            elif k in out and isinstance(out[k], (int, float)):
                factor = self._rng.choice([0.8, 1.2])
                out[k] = type(out[k])(out[k] * factor)
        return out


class PB2(PopulationBasedTraining):
    """Population-based bandits (reference: tune/schedulers/pb2.py).

    PBT's exploit step with the random mutation replaced by a GP-UCB
    bandit: reward IMPROVEMENTS are modeled as a Gaussian process over
    (hyperparameters, time), and the explore step picks the
    highest-UCB point inside ``hyperparam_bounds`` — sample-efficient
    where PBT's multiplicative jitter is blind. Continuous bounds only
    (the paper's setting); categorical params pass through unchanged.
    GP backend: sklearn GaussianProcessRegressor (Matern 5/2).
    """

    def __init__(
        self,
        metric: Optional[str] = None,
        mode: Optional[str] = None,
        perturbation_interval: int = 5,
        hyperparam_bounds: Optional[Dict[str, Any]] = None,
        quantile_fraction: float = 0.25,
        time_attr: str = "training_iteration",
        ucb_kappa: float = 1.0,
        seed: Optional[int] = None,
    ):
        super().__init__(
            metric=metric,
            mode=mode,
            perturbation_interval=perturbation_interval,
            hyperparam_mutations={},
            quantile_fraction=quantile_fraction,
            time_attr=time_attr,
            seed=seed,
        )
        if not hyperparam_bounds:
            raise ValueError("PB2 requires hyperparam_bounds={name: (lo, hi)}")
        self.bounds = {k: (float(lo), float(hi))
                       for k, (lo, hi) in hyperparam_bounds.items()}
        self.kappa = ucb_kappa
        # observation history: per trial, last (t, config, score) to
        # turn absolute scores into per-interval improvements
        self._prev_obs: Dict[str, tuple] = {}
        self._X: List[List[float]] = []   # [normalized hp..., t]
        self._y: List[float] = []         # score improvement

    def on_result(self, trial_id: str, metrics: Dict[str, Any]) -> str:
        out = super().on_result(trial_id, metrics)
        if self.metric and self.metric in metrics:
            t = float(metrics.get(self.time_attr, 0))
            score = self._sign * float(metrics[self.metric])
            cfg = self._configs.get(trial_id, {})
            prev = self._prev_obs.get(trial_id)
            if prev is not None and all(k in cfg for k in self.bounds):
                pt, pscore = prev
                if t > pt:
                    self._X.append(self._featurize(cfg, pt))
                    self._y.append((score - pscore) / (t - pt))
            self._prev_obs[trial_id] = (t, score)
        return out

    def _featurize(self, config: Dict[str, Any], t: float) -> List[float]:
        feats = []
        for k, (lo, hi) in self.bounds.items():
            feats.append((float(config[k]) - lo) / max(hi - lo, 1e-12))
        feats.append(t)  # raw; normalized against max-t at fit time so
        # the isotropic kernel is not dominated by the time scale
        return feats

    def commit_exploit(self, trial_id: str, new_config: Dict[str, Any]) -> None:
        super().commit_exploit(trial_id, new_config)
        # the next report's score jump comes from the checkpoint CLONE,
        # not from the new hyperparameters — recording it would teach
        # the GP that whatever configs bottom trials clone into cause
        # huge improvements
        self._prev_obs.pop(trial_id, None)

    def _mutate(self, config: Dict[str, Any]) -> Dict[str, Any]:
        out = dict(config)
        if len(self._y) < 4:
            # cold start: uniform sample inside the bounds
            for k, (lo, hi) in self.bounds.items():
                out[k] = lo + self._rng.random() * (hi - lo)
            return out
        import numpy as np
        from sklearn.gaussian_process import GaussianProcessRegressor
        from sklearn.gaussian_process.kernels import Matern

        X = np.asarray(self._X, float)
        t_max = max(X[:, -1].max(), 1.0)
        X = X.copy()
        X[:, -1] /= t_max  # time on the same [0,1] scale as the hps
        y = np.asarray(self._y, float)
        y = (y - y.mean()) / (y.std() + 1e-9)
        gp = GaussianProcessRegressor(
            kernel=Matern(nu=2.5), alpha=1e-4, normalize_y=False,
            random_state=self._rng.randrange(2**31),
        )
        gp.fit(X, y)
        rng = np.random.default_rng(self._rng.randrange(2**31))
        n_cand = 256
        cand = rng.random((n_cand, len(self.bounds)))
        feats = np.concatenate(
            [cand, np.ones((n_cand, 1))], axis=1  # t = now = max = 1.0
        )
        mean, std = gp.predict(feats, return_std=True)
        best = int(np.argmax(mean + self.kappa * std))
        for i, (k, (lo, hi)) in enumerate(self.bounds.items()):
            out[k] = lo + float(cand[best, i]) * (hi - lo)
        return out
