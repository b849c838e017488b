"""Workflows: durable DAG execution with exactly-once node semantics.

Parity: python/ray/workflow/ (workflow_executor.py + workflow_storage.py)
— a DAG (the same `fn.bind` graphs ray_tpu_torch.dag builds) runs with every
node's result checkpointed to storage as it completes; a crashed or
interrupted workflow resumes by replaying ONLY the nodes without a
durable result. Storage layout:

    <storage>/<workflow_id>/status.json
    <storage>/<workflow_id>/results/<node_key>.pkl

Node keys are content-derived (function name + arg structure position in
the topo order), so resume matches results to nodes deterministically.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, List, Optional

from ..dag.dag_node import DAGNode, FunctionNode, InputNode

_storage_base: Optional[str] = None


class EventListener:
    """External-event source for durable workflows (reference:
    python/ray/workflow/event_listener.py EventListener ABC).

    `poll_for_event()` blocks until the event occurs and returns its
    payload; `event_checkpointed(event)` runs AFTER the payload is
    durably persisted — the commit hook where e.g. a queue message is
    acked, giving exactly-once delivery INTO the workflow (the payload
    checkpoint is consulted before any re-poll on resume)."""

    def poll_for_event(self) -> Any:
        raise NotImplementedError

    def event_checkpointed(self, event: Any) -> None:
        pass


class EventNode(DAGNode):
    """A durable wait-for-event step (reference: workflow.wait_for_event
    building a WaitForEvent step). Resume semantics: a checkpointed
    payload short-circuits the poll entirely."""

    def __init__(self, listener_cls, args, kwargs):
        super().__init__()
        if not (isinstance(listener_cls, type)
                and issubclass(listener_cls, EventListener)):
            raise TypeError(
                "wait_for_event expects an EventListener subclass"
            )
        self._listener_cls = listener_cls
        self._listener_args = args
        self._listener_kwargs = kwargs

    def make_listener(self) -> EventListener:
        return self._listener_cls(
            *self._listener_args, **self._listener_kwargs
        )

    def _apply(self, results, input_args, input_kwargs):
        import cloudpickle

        import ray_tpu_torch

        blob = cloudpickle.dumps(
            (self._listener_cls, self._listener_args, self._listener_kwargs)
        )

        @ray_tpu_torch.remote
        def _poll_for_event(b):
            import cloudpickle as _cp

            cls, a, kw = _cp.loads(b)
            return cls(*a, **kw).poll_for_event()

        return _poll_for_event.remote(blob)


def wait_for_event(listener_cls, *args, **kwargs) -> EventNode:
    """Bind an external-event wait into a workflow DAG (reference:
    workflow/api.py wait_for_event)."""
    return EventNode(listener_cls, args, kwargs)


def init(storage: str) -> None:
    """Set the workflow storage root (reference: workflow.init)."""
    global _storage_base
    _storage_base = os.path.expanduser(storage)
    os.makedirs(_storage_base, exist_ok=True)


def _storage() -> str:
    if _storage_base is None:
        raise RuntimeError("call ray_tpu_torch.workflow.init(storage_dir) first")
    return _storage_base


def _wf_dir(workflow_id: str) -> str:
    return os.path.join(_storage(), workflow_id)


def _node_key(node: DAGNode, index: int) -> str:
    name = ""
    if isinstance(node, FunctionNode):
        name = getattr(node._remote_fn, "__name__", "fn")
    elif isinstance(node, EventNode):
        name = f"event_{node._listener_cls.__name__}"
    return f"{index:04d}_{name}"


def _set_status(workflow_id: str, status: str, **extra) -> None:
    path = os.path.join(_wf_dir(workflow_id), "status.json")
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(dict(extra, status=status), f)
    os.replace(tmp, path)


def get_status(workflow_id: str) -> str:
    try:
        with open(os.path.join(_wf_dir(workflow_id), "status.json")) as f:
            return json.load(f)["status"]
    except OSError:
        return "NOT_FOUND"


def list_all() -> List[Dict[str, str]]:
    out = []
    base = _storage()
    for wid in sorted(os.listdir(base)):
        if os.path.isdir(os.path.join(base, wid)):
            out.append({"workflow_id": wid, "status": get_status(wid)})
    return out


def run(dag: DAGNode, *, workflow_id: str, args: Any = None) -> Any:
    """Execute (or resume) the DAG durably and return the root's result.

    Every FunctionNode runs as a normal task; its result is fetched and
    pickled to storage before dependents run (the reference checkpoints
    through its storage backends the same way). Nodes with durable
    results are skipped on re-run — crash anywhere, call run() again
    with the same workflow_id, and only unfinished nodes execute."""
    import cloudpickle

    import ray_tpu_torch

    if not ray_tpu_torch.is_initialized():
        ray_tpu_torch.init(ignore_reinit_error=True)
    wdir = _wf_dir(workflow_id)
    results_dir = os.path.join(wdir, "results")
    os.makedirs(results_dir, exist_ok=True)
    _set_status(workflow_id, "RUNNING")

    # Concurrent executor (reference: workflow_executor.py runs every
    # in-flight node as a task and reacts to completions): all nodes
    # whose deps are durable submit IMMEDIATELY — independent branches
    # overlap; each result is persisted the moment it lands, before any
    # dependent can observe it.
    schedule = dag._topo()
    index_of = {node._id: i for i, node in enumerate(schedule)}
    deps: Dict[int, set] = {
        n._id: {c._id for c in n._children()} for n in schedule
    }
    dependents: Dict[int, List[DAGNode]] = {}
    for n in schedule:
        for c in n._children():
            dependents.setdefault(c._id, []).append(n)
    results: Dict[int, Any] = {}
    in_flight: Dict[Any, DAGNode] = {}  # ObjectRef -> node
    started: set = set()

    def _persist(node: DAGNode, value: Any) -> None:
        path = os.path.join(
            results_dir, _node_key(node, index_of[node._id]) + ".pkl"
        )
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            cloudpickle.dump(value, f)
        os.replace(tmp, path)  # durable BEFORE dependents may run

    def _ack_event(node: "EventNode", path: str, value: Any) -> None:
        """Commit hook AFTER the durable checkpoint (reference:
        event_listener.event_checkpointed — ack the source). The
        .acked marker makes the hook itself resumable: a crash
        between persist and ack re-runs ONLY the hook."""
        node.make_listener().event_checkpointed(value)
        with open(path + ".acked", "w") as f:
            f.write("1")

    from collections import deque as _deque

    worklist: "_deque" = _deque()  # nodes whose deps are all in `results`

    def _start(node: DAGNode) -> None:
        """Deps are all in `results`; run or restore this node.
        Iterative (worklist, not recursion): restored/passthrough chains
        can be thousands of nodes deep."""
        if node._id in started:
            return
        started.add(node._id)
        if isinstance(node, InputNode):
            _finish(node, args)
            return
        if not isinstance(node, (FunctionNode, EventNode)):
            # passthrough nodes (input attributes, multi-output)
            _finish(node, node._apply(results, (args,), {}))
            return
        path = os.path.join(
            results_dir, _node_key(node, index_of[node._id]) + ".pkl"
        )
        if os.path.exists(path):
            # exactly-once: a checkpointed event payload (or task
            # result) is NEVER re-polled/re-run on resume
            with open(path, "rb") as f:
                value = cloudpickle.load(f)
            if isinstance(node, EventNode) and not os.path.exists(
                path + ".acked"
            ):
                # crashed between persist and the commit hook: re-run
                # the hook (at-least-once ack, exactly-once payload)
                _ack_event(node, path, value)
            _finish(node, value)
            return
        in_flight[node._apply(results, (args,), {})] = node

    def _finish(node: DAGNode, value: Any) -> None:
        results[node._id] = value
        for dep in dependents.get(node._id, ()):
            deps[dep._id].discard(node._id)
            if not deps[dep._id]:
                worklist.append(dep)

    def _drain() -> None:
        while worklist:
            _start(worklist.popleft())

    try:
        for node in schedule:
            if not deps[node._id]:
                worklist.append(node)
        _drain()
        while in_flight:
            done, _ = ray_tpu_torch.wait(list(in_flight), num_returns=1)
            node = in_flight.pop(done[0])
            value = ray_tpu_torch.get(done[0])
            _persist(node, value)
            if isinstance(node, EventNode):
                _ack_event(
                    node,
                    os.path.join(
                        results_dir,
                        _node_key(node, index_of[node._id]) + ".pkl",
                    ),
                    value,
                )
            _finish(node, value)
            _drain()
    except Exception:
        _set_status(workflow_id, "FAILED")
        raise
    _set_status(workflow_id, "SUCCEEDED")
    return results[dag._id]


def resume(workflow_id: str, dag: DAGNode, *, args: Any = None) -> Any:
    """Alias of run() — resumption IS re-running with the same id."""
    return run(dag, workflow_id=workflow_id, args=args)

from ray_tpu_torch._private import usage as _usage

_usage.record_library_usage("workflow")
