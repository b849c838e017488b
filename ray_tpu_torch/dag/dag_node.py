"""DAG authoring: lazy task/actor-method graphs.

Parity: python/ray/dag/ (dag_node.py, input_node.py, function_node.py,
class_node.py) — `fn.bind(...)` / `actor.method.bind(...)` build a lazy
DAG; `dag.execute(input)` runs it. The compiled path
(compiled_dag.py) pre-plans the schedule the way the reference's
CompiledDAG does (compiled_dag_node.py:805).
"""

from __future__ import annotations

import itertools
from typing import Any, Dict, List, Optional, Tuple

_node_counter = itertools.count()


class DAGNode:
    def __init__(self, args: Tuple = (), kwargs: Optional[Dict] = None):
        self._bound_args = args
        self._bound_kwargs = kwargs or {}
        self._id = next(_node_counter)

    # -- traversal -----------------------------------------------------
    def _children(self) -> List["DAGNode"]:
        out: List[DAGNode] = []

        def scan(v):
            if isinstance(v, DAGNode):
                out.append(v)
            elif isinstance(v, (list, tuple)):
                for x in v:
                    scan(x)
            elif isinstance(v, dict):
                for x in v.values():
                    scan(x)

        for a in list(self._bound_args) + list(self._bound_kwargs.values()):
            scan(a)
        return out

    def _topo(self) -> List["DAGNode"]:
        seen: Dict[int, DAGNode] = {}
        order: List[DAGNode] = []

        def visit(node: DAGNode):
            if node._id in seen:
                return
            seen[node._id] = node
            for c in node._children():
                visit(c)
            order.append(node)

        visit(self)
        return order

    # -- execution -----------------------------------------------------
    def execute(self, *input_args, **input_kwargs):
        """Eager execution: submit every node's task in topo order,
        passing upstream ObjectRefs directly (worker-to-worker data
        flow; the driver only holds refs)."""
        results: Dict[int, Any] = {}
        for node in self._topo():
            results[node._id] = node._apply(results, input_args, input_kwargs)
        return results[self._id]

    def _resolve_args(self, results, input_args, input_kwargs):
        def res(v):
            if isinstance(v, DAGNode):
                return results[v._id]
            if isinstance(v, list):
                return [res(x) for x in v]
            if isinstance(v, tuple):
                return tuple(res(x) for x in v)
            if isinstance(v, dict):
                return {k: res(x) for k, x in v.items()}
            return v

        args = tuple(res(a) for a in self._bound_args)
        kwargs = {k: res(v) for k, v in self._bound_kwargs.items()}
        return args, kwargs

    def _apply(self, results, input_args, input_kwargs):
        raise NotImplementedError

    def with_shm_channel(self, shape, dtype: str = "float32") -> "DAGNode":
        """Declare this node's output as a fixed-shape numpy payload so
        experimental_compile() can pre-allocate a shared-memory ring
        channel for it (reference: with_type_hint/TorchTensorType on DAG
        nodes feeding the channel allocator)."""
        self._channel_spec = (tuple(shape), dtype)
        return self

    def experimental_compile(self, **kwargs):
        from .compiled_dag import CompiledDAG

        return CompiledDAG(self, **kwargs)


class InputNode(DAGNode):
    """Placeholder for execute()'s argument (reference: dag/input_node.py).
    Context-manager form mirrors the reference's `with InputNode() as inp`.
    """

    def __init__(self):
        super().__init__()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def _apply(self, results, input_args, input_kwargs):
        if len(input_args) == 1 and not input_kwargs:
            return input_args[0]
        if not input_args and not input_kwargs:
            return None
        return (input_args, input_kwargs)

    def __getattr__(self, key: str):
        if key.startswith("_"):
            raise AttributeError(key)
        return InputAttributeNode(self, key)

    def __getitem__(self, key):
        return InputAttributeNode(self, key)


class InputAttributeNode(DAGNode):
    """inp.x / inp[0] — projects a field out of the input."""

    def __init__(self, parent: InputNode, key):
        super().__init__(args=(parent,))
        self._key = key

    def _apply(self, results, input_args, input_kwargs):
        base = results[self._bound_args[0]._id]
        if isinstance(self._key, str):
            if isinstance(base, dict):
                return base[self._key]
            return getattr(base, self._key)
        return base[self._key]


class FunctionNode(DAGNode):
    """fn.bind(...) (reference: dag/function_node.py)."""

    def __init__(self, remote_fn, args, kwargs):
        super().__init__(args, kwargs)
        self._remote_fn = remote_fn

    def _apply(self, results, input_args, input_kwargs):
        args, kwargs = self._resolve_args(results, input_args, input_kwargs)
        return self._remote_fn.remote(*args, **kwargs)


class ClassMethodNode(DAGNode):
    """actor.method.bind(...) (reference: dag/class_node.py)."""

    def __init__(self, actor_method, args, kwargs):
        super().__init__(args, kwargs)
        self._method = actor_method

    def _apply(self, results, input_args, input_kwargs):
        args, kwargs = self._resolve_args(results, input_args, input_kwargs)
        return self._method.remote(*args, **kwargs)


class MultiOutputNode(DAGNode):
    """Bundle several leaves into one output list (reference:
    dag/output_node.py)."""

    def __init__(self, outputs: List[DAGNode]):
        super().__init__(args=tuple(outputs))

    def _apply(self, results, input_args, input_kwargs):
        return [results[n._id] for n in self._bound_args]


class CollectiveOutputNode(DAGNode):
    """One participant's reduced output of an in-DAG allreduce
    (reference: dag/collective_node.py CollectiveOutputNode over the
    Communicator ABC, experimental/channel/communicator.py:19).

    Channel-compiled execution runs the reduction INSIDE the resident
    exec loops: the group's actors exchange contributions over a full
    mesh of pre-allocated shm ring channels and reduce locally — zero
    scheduler round-trips per tick. (The reference's NCCL allreduce node
    reduces device buffers; this node reduces host arrays on the DAG
    plane.)
    """

    def __init__(self, parent: "ClassMethodNode", group: List["ClassMethodNode"],
                 rank: int, op: str):
        # every group member is a real dependency: the reduce needs all
        # contributions, and the topo schedule must order them first
        super().__init__(args=tuple(group))
        self._parent = parent
        self._group = group
        self._rank = rank
        self._op = op
        self._channel_spec = getattr(parent, "_channel_spec", None)

    def _apply(self, results, input_args, input_kwargs):
        # legacy (non-channel) mode: resolve every participant's ref and
        # reduce driver-side — semantics preserved without loops
        import numpy as np

        import ray_tpu_torch

        vals = [
            np.asarray(v)
            for v in ray_tpu_torch.get([results[n._id] for n in self._group])
        ]
        acc = vals[0].copy()
        for v in vals[1:]:
            acc = _REDUCE_OPS[self._op](acc, v)
        return ray_tpu_torch.put(acc)


_REDUCE_OPS = {
    "sum": lambda a, b: a + b,
    "prod": lambda a, b: a * b,
    "max": lambda a, b: __import__("numpy").maximum(a, b),
    "min": lambda a, b: __import__("numpy").minimum(a, b),
}


class _AllReduce:
    """`allreduce.bind([n1, n2, ...])` — binds an allreduce across DAG
    nodes living on distinct actors, returning one CollectiveOutputNode
    per input (reference: ray.experimental.collective.allreduce)."""

    @staticmethod
    def bind(nodes: List["ClassMethodNode"], op: str = "sum"
             ) -> List["CollectiveOutputNode"]:
        if op not in _REDUCE_OPS:
            raise ValueError(f"unsupported allreduce op {op!r}")
        if len(nodes) < 2:
            raise ValueError("allreduce needs at least two participants")
        for n in nodes:
            if not isinstance(n, ClassMethodNode):
                raise ValueError(
                    "allreduce participants must be actor-method nodes"
                )
        actors = {n._method._handle._actor_id.binary() for n in nodes}
        if len(actors) != len(nodes):
            raise ValueError("allreduce participants must be distinct actors")
        return [
            CollectiveOutputNode(n, list(nodes), i, op)
            for i, n in enumerate(nodes)
        ]


allreduce = _AllReduce()
