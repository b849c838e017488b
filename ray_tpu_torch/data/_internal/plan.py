"""Logical plan: lazy operator DAG + rule-based fusion.

Parity: python/ray/data/_internal/logical/ (LogicalPlan, operators,
optimizers.py fusion rules) collapsed to the ops that matter. The key
optimization is the same one the reference's OperatorFusionRule does:
adjacent one-to-one transforms (map/filter/flat_map/map_batches with
task compute) fuse into ONE task chain so blocks cross the object
store once per fused group, not once per op.
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Any, Callable, Dict, List, Optional, Tuple, Union

from ..datasource import Datasource


@dataclass
class LogicalOp:
    input: Optional["LogicalOp"] = None

    @property
    def name(self) -> str:
        return type(self).__name__


@dataclass
class Read(LogicalOp):
    datasource: Optional[Datasource] = None
    parallelism: int = -1


@dataclass
class FromBlocks(LogicalOp):
    """Already-materialized blocks (from_pandas/from_numpy refs)."""

    blocks: List[Any] = field(default_factory=list)  # ObjectRefs


@dataclass
class OneToOne(LogicalOp):
    """Base for per-block transforms; carries compute config."""

    fn: Optional[Callable] = None
    compute: Optional[Any] = None  # None=tasks, ActorPoolStrategy=actors
    fn_constructor_args: Tuple = ()
    fn_constructor_kwargs: Dict[str, Any] = field(default_factory=dict)
    resources: Dict[str, float] = field(default_factory=dict)
    concurrency: Optional[Union[int, Tuple[int, int]]] = None


@dataclass
class MapRows(OneToOne):
    pass


@dataclass
class Filter(OneToOne):
    pass


@dataclass
class FlatMap(OneToOne):
    pass


@dataclass
class MapBatches(OneToOne):
    batch_size: Optional[int] = None
    batch_format: str = "numpy"
    zero_copy_batch: bool = False


@dataclass
class Limit(LogicalOp):
    n: int = 0


@dataclass
class Repartition(LogicalOp):
    num_blocks: int = 1


@dataclass
class RandomShuffle(LogicalOp):
    seed: Optional[int] = None
    num_blocks: Optional[int] = None


@dataclass
class Sort(LogicalOp):
    key: Optional[Union[str, Callable]] = None
    descending: bool = False


@dataclass
class Aggregate(LogicalOp):
    key: Optional[str] = None
    aggs: List[Any] = field(default_factory=list)


@dataclass
class Union(LogicalOp):
    others: List["LogicalOp"] = field(default_factory=list)


@dataclass
class Zip(LogicalOp):
    other: Optional["LogicalOp"] = None


class LogicalPlan:
    def __init__(self, terminal: LogicalOp):
        self.terminal = terminal

    def ops(self) -> List[LogicalOp]:
        """Linear chain root..terminal (branches hang off Union/Zip)."""
        chain: List[LogicalOp] = []
        op: Optional[LogicalOp] = self.terminal
        while op is not None:
            chain.append(op)
            op = op.input
        return list(reversed(chain))

    def with_op(self, op: LogicalOp) -> "LogicalPlan":
        op.input = self.terminal
        return LogicalPlan(op)
