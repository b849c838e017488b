"""Search algorithms.

Parity: python/ray/tune/search/ — Searcher ABC, BasicVariantGenerator
(grid + random), ConcurrencyLimiter, and an optional OptunaSearch
adapter (gated on optuna being installed, like the reference's
soft-dependency searchers).
"""

from __future__ import annotations

import random
from typing import Any, Dict, List, Optional

from .sample import resolve


class Searcher:
    """Suggest/observe interface (reference: tune/search/searcher.py)."""

    def __init__(self, metric: str = "loss", mode: str = "min"):
        self.metric = metric
        self.mode = mode

    def suggest(self, trial_id: str) -> Optional[Dict[str, Any]]:
        raise NotImplementedError

    def is_finished(self) -> bool:
        """True when suggest() will never yield another config. Default
        False: a None from suggest() means 'not now' (e.g. concurrency
        capped), and the controller bounds custom searchers by
        num_samples instead."""
        return False

    def on_trial_complete(
        self, trial_id: str, result: Optional[Dict[str, Any]] = None
    ) -> None:
        pass


class BasicVariantGenerator(Searcher):
    """Grid expansion × num_samples random draws
    (reference: tune/search/basic_variant.py)."""

    def __init__(self, param_space: Dict[str, Any], num_samples: int = 1, seed=None):
        super().__init__()
        self.param_space = param_space
        self.num_samples = num_samples
        self._rng = random.Random(seed)
        self._queue: List[Dict[str, Any]] = []
        for _ in range(num_samples):
            self._queue.extend(resolve(param_space, self._rng))

    @property
    def total_trials(self) -> int:
        return len(self._queue)

    def is_finished(self) -> bool:
        return not self._queue

    def suggest(self, trial_id: str) -> Optional[Dict[str, Any]]:
        if not self._queue:
            return None
        return self._queue.pop(0)


class ConcurrencyLimiter(Searcher):
    """Caps in-flight suggestions (reference: tune/search/
    concurrency_limiter.py)."""

    def __init__(self, searcher: Searcher, max_concurrent: int):
        super().__init__(searcher.metric, searcher.mode)
        self.searcher = searcher
        self.max_concurrent = max_concurrent
        self._live: set = set()

    def suggest(self, trial_id: str) -> Optional[Dict[str, Any]]:
        if len(self._live) >= self.max_concurrent:
            return None
        cfg = self.searcher.suggest(trial_id)
        if cfg is not None:
            self._live.add(trial_id)
        return cfg

    def is_finished(self) -> bool:
        return self.searcher.is_finished()

    def on_trial_complete(self, trial_id, result=None):
        self._live.discard(trial_id)
        self.searcher.on_trial_complete(trial_id, result)


class OptunaSearch(Searcher):
    """Optuna TPE adapter (reference: tune/search/optuna/optuna_search.py).
    Soft dependency: raises ImportError with guidance if optuna is absent.
    """

    def __init__(self, param_space: Dict[str, Any], metric="loss", mode="min", seed=None):
        super().__init__(metric, mode)
        try:
            import optuna
        except ImportError as e:
            raise ImportError(
                "OptunaSearch requires the `optuna` package (not bundled); "
                "use BasicVariantGenerator or install optuna"
            ) from e
        self._optuna = optuna
        sampler = optuna.samplers.TPESampler(seed=seed)
        self._study = optuna.create_study(
            direction="minimize" if mode == "min" else "maximize", sampler=sampler
        )
        from .sample import Categorical, Domain, Float, Integer

        for k, v in param_space.items():
            if isinstance(v, Domain) and not isinstance(
                v, (Float, Integer, Categorical)
            ):
                raise ValueError(
                    f"OptunaSearch supports uniform/loguniform/randint/choice "
                    f"domains; param {k!r} is {type(v).__name__}"
                )
            if isinstance(v, dict):
                raise ValueError(
                    f"OptunaSearch does not support nested search spaces "
                    f"(param {k!r}); flatten the space"
                )
        self.param_space = param_space
        self._trials: Dict[str, Any] = {}

    def suggest(self, trial_id: str) -> Optional[Dict[str, Any]]:
        from .sample import Categorical, Float, Integer

        ot = self._study.ask()
        cfg = {}
        for k, v in self.param_space.items():
            if isinstance(v, Float):
                cfg[k] = ot.suggest_float(k, v.lower, v.upper, log=v.log)
            elif isinstance(v, Integer):
                cfg[k] = ot.suggest_int(k, v.lower, v.upper - 1, log=v.log)
            elif isinstance(v, Categorical):
                cfg[k] = ot.suggest_categorical(k, v.categories)
            else:
                cfg[k] = v
        self._trials[trial_id] = ot
        return cfg

    def on_trial_complete(self, trial_id, result=None):
        ot = self._trials.pop(trial_id, None)
        if ot is not None and result and self.metric in result:
            self._study.tell(ot, float(result[self.metric]))
