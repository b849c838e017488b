"""Search-space primitives.

Parity: python/ray/tune/search/sample.py (Domain/Categorical/Float/
Integer/grid_search) — the declarative param_space vocabulary.
"""

from __future__ import annotations

import random
from typing import Any, Callable, Dict, List, Sequence


class Domain:
    def sample(self, rng: random.Random) -> Any:
        raise NotImplementedError


class Categorical(Domain):
    def __init__(self, categories: Sequence[Any]):
        self.categories = list(categories)

    def sample(self, rng):
        return rng.choice(self.categories)


class Float(Domain):
    def __init__(self, lower: float, upper: float, log: bool = False, q: float = None):
        self.lower, self.upper, self.log, self.q = lower, upper, log, q

    def sample(self, rng):
        import math

        if self.log:
            v = math.exp(rng.uniform(math.log(self.lower), math.log(self.upper)))
        else:
            v = rng.uniform(self.lower, self.upper)
        if self.q:
            v = round(v / self.q) * self.q
        return v


class Integer(Domain):
    def __init__(self, lower: int, upper: int, log: bool = False):
        self.lower, self.upper, self.log = lower, upper, log

    def sample(self, rng):
        import math

        if self.log:
            return int(
                round(
                    math.exp(rng.uniform(math.log(self.lower), math.log(self.upper - 1)))
                )
            )
        return rng.randint(self.lower, self.upper - 1)


class Function(Domain):
    """tune.sample_from: fn optionally receives the partially-resolved
    config (the reference passes the spec the same way)."""

    def __init__(self, fn: Callable):
        self.fn = fn

    def sample(self, rng, spec=None):
        try:
            argc = self.fn.__code__.co_argcount
        except AttributeError:
            argc = 1
        return self.fn(spec) if argc else self.fn()


class _Gauss(Domain):
    def __init__(self, mean: float, sd: float):
        self.mean, self.sd = mean, sd

    def sample(self, rng):
        return rng.gauss(self.mean, self.sd)


class GridSearch:
    """Marker for exhaustive expansion (tune.grid_search parity)."""

    def __init__(self, values: Sequence[Any]):
        self.values = list(values)


def choice(categories: Sequence[Any]) -> Categorical:
    return Categorical(categories)


def uniform(lower: float, upper: float) -> Float:
    return Float(lower, upper)


def quniform(lower: float, upper: float, q: float) -> Float:
    return Float(lower, upper, q=q)


def loguniform(lower: float, upper: float) -> Float:
    return Float(lower, upper, log=True)


def randint(lower: int, upper: int) -> Integer:
    return Integer(lower, upper)


def lograndint(lower: int, upper: int) -> Integer:
    return Integer(lower, upper, log=True)


def randn(mean: float = 0.0, sd: float = 1.0) -> Domain:
    return _Gauss(mean, sd)


def sample_from(fn: Callable) -> Function:
    return Function(fn)


def grid_search(values: Sequence[Any]) -> GridSearch:
    return GridSearch(values)


def _collect_grids(space: Dict[str, Any], path: tuple) -> List[tuple]:
    """All (path, values) GridSearch entries at any nesting depth."""
    out: List[tuple] = []
    for k, v in space.items():
        if isinstance(v, GridSearch):
            out.append((path + (k,), v.values))
        elif isinstance(v, dict):
            out.extend(_collect_grids(v, path + (k,)))
    return out


def resolve(param_space: Dict[str, Any], rng: random.Random) -> List[Dict[str, Any]]:
    """Expand grid_search axes (cartesian product, nested dicts
    included) and sample Domains once per variant — the
    BasicVariantGenerator expansion (reference:
    tune/search/basic_variant.py). sample_from functions receive the
    config resolved so far (key order = insertion order)."""
    grids = _collect_grids(param_space, ())
    assignments: List[Dict[tuple, Any]] = [{}]
    for path, values in grids:
        assignments = [
            {**a, path: val} for a in assignments for val in values
        ]

    def build(space: Dict[str, Any], path: tuple, chosen: Dict[tuple, Any], cfg_root):
        cfg: Dict[str, Any] = {}
        for k, v in space.items():
            p = path + (k,)
            if isinstance(v, GridSearch):
                cfg[k] = chosen[p]
            elif isinstance(v, Function):
                cfg[k] = v.sample(rng, spec=cfg_root if path else cfg)
            elif isinstance(v, Domain):
                cfg[k] = v.sample(rng)
            elif isinstance(v, dict):
                cfg[k] = build(v, p, chosen, cfg_root or cfg)
            else:
                cfg[k] = v
        return cfg

    return [build(param_space, (), chosen, None) for chosen in assignments]
