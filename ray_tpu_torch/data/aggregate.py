"""Aggregations for groupby/global reduce.

Parity: python/ray/data/aggregate.py (AggregateFn, Count/Sum/Min/Max/
Mean/Std) — implemented as vectorized numpy reductions over columnar
blocks.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional

import numpy as np

from .block import Block, BlockAccessor


class AggregateFn:
    def __init__(self, on: Optional[str], name: str, reduce_fn: Callable[[np.ndarray], Any]):
        self.on = on
        self.name = name
        self.reduce_fn = reduce_fn

    def output_name(self) -> str:
        return f"{self.name}({self.on})" if self.on else self.name


class Count(AggregateFn):
    def __init__(self, on: Optional[str] = None):
        super().__init__(on, "count", lambda v: int(len(v)))

    def output_name(self) -> str:
        return "count()"


class Sum(AggregateFn):
    def __init__(self, on: str):
        super().__init__(on, "sum", lambda v: v.sum())


class Min(AggregateFn):
    def __init__(self, on: str):
        super().__init__(on, "min", lambda v: v.min())


class Max(AggregateFn):
    def __init__(self, on: str):
        super().__init__(on, "max", lambda v: v.max())


class Mean(AggregateFn):
    def __init__(self, on: str):
        super().__init__(on, "mean", lambda v: v.mean())


class Std(AggregateFn):
    def __init__(self, on: str, ddof: int = 1):
        super().__init__(on, "std", lambda v: v.std(ddof=ddof) if len(v) > ddof else 0.0)


class AbsMax(AggregateFn):
    def __init__(self, on: str):
        super().__init__(on, "abs_max", lambda v: np.abs(v).max())


def aggregate_block(block: Block, key: Optional[str], aggs: List[AggregateFn]) -> Block:
    """Group `block` rows by `key` (or globally if None) and apply aggs.
    Returns a columnar block with one row per group."""
    acc = BlockAccessor.for_block(block)
    if acc.num_rows() == 0:
        return {}
    if isinstance(block, dict):
        cols = block
    else:
        cols = BlockAccessor.batch_to_block(list(acc.iter_rows()))
        if not isinstance(cols, dict):
            raise ValueError("aggregate requires dict-style rows or columnar blocks")

    def col_for(agg: AggregateFn, idx: np.ndarray) -> np.ndarray:
        src = cols[agg.on] if agg.on else next(iter(cols.values()))
        return src[idx]

    if key is None:
        idx = np.arange(acc.num_rows())
        return {agg.output_name(): np.asarray([agg.reduce_fn(col_for(agg, idx))]) for agg in aggs}

    keys = cols[key]
    uniq, inverse = np.unique(keys, return_inverse=True)
    out: Dict[str, np.ndarray] = {key: uniq}
    for agg in aggs:
        vals = [agg.reduce_fn(col_for(agg, np.nonzero(inverse == g)[0])) for g in range(len(uniq))]
        out[agg.output_name()] = np.asarray(vals)
    return out
