"""Compiled DAG execution.

Parity: python/ray/dag/compiled_dag_node.py:805 (CompiledDAG). Two
modes:

**Channel mode** (the reference's true compiled path): when every
compute node is an actor-method node annotated with a fixed-shape
channel (``node.with_shm_channel(shape, dtype)``), compilation

1. allocates one shared-memory ring channel per DAG edge
   (experimental/channel/shm_channel.py — the analogue of the
   reference's mutable-plasma channels,
   shared_memory_channel.py:151), and
2. parks a resident exec loop on each actor via ``__ray_call__``
   (the reference's ``do_exec_tasks`` :193).

``execute()`` is then pure channel I/O — the driver writes the input
segment and later reads the output segment; the scheduler sees ZERO
task submissions per execution (asserted in tests via the hub's task
counters). In-flight executions pipeline up to the ring capacity.

**Legacy mode** (fallback for un-annotated graphs): the frozen topo
schedule re-submits tasks per execute with refs flowing
worker-to-worker — still no per-execute graph traversal, but each node
costs a scheduler round trip.

The reference's NCCL channels (device buffers between stages) have no
counterpart in the port: payloads are fixed-shape host numpy arrays, and a
method that runs on the card turns them into tensors itself. The resident
loop and every channel import ``ray_tpu_torch`` only, so a compiled DAG's
actors never load the JAX package.
"""

from __future__ import annotations

import itertools
from collections import deque
from typing import Any, Dict, List, Optional, Tuple

from .dag_node import (
    ClassMethodNode,
    CollectiveOutputNode,
    DAGNode,
    InputAttributeNode,
    InputNode,
    MultiOutputNode,
)


def _compiled_exec_loop(instance, method_name, arg_plan, out_descs, stop_desc,
                        coll_plan=None):
    """Resident per-actor loop (reference: do_exec_tasks,
    compiled_dag_node.py:193). Runs inside the actor via __ray_call__:
    read inputs from ring channels, run the method, write outputs —
    until the stop channel signals teardown.

    coll_plan (reference: dag/collective_node.py executing over the
    Communicator ABC) runs an allreduce INSIDE the loop: the method
    output is exchanged with the group's peers over a full mesh of shm
    channels and reduced locally, then the reduced array flows to
    coll_plan["outs"]. Zero scheduler traffic per tick."""
    import numpy as np

    from ray_tpu_torch.experimental.channel.shm_channel import ShmChannel

    chans = {}

    def attach(desc):
        if desc not in chans:
            chans[desc] = ShmChannel(*desc)
        return chans[desc]

    ins = [
        ("chan", attach(kind_val)) if kind == "chan" else ("lit", kind_val)
        for kind, kind_val in arg_plan
    ]
    outs = [attach(d) for d in out_descs]
    stop = attach(stop_desc)
    if coll_plan is not None:
        from ray_tpu_torch.dag.dag_node import _REDUCE_OPS

        coll_sends = [attach(d) for d in coll_plan["sends"]]
        coll_recvs = [attach(d) for d in coll_plan["recvs"]]
        coll_outs = [attach(d) for d in coll_plan["outs"]]
        coll_reduce = _REDUCE_OPS[coll_plan["op"]]
    method = getattr(instance, method_name)
    try:
        while True:
            args = []
            stopped = False
            for kind, src in ins:
                if kind == "lit":
                    args.append(src)
                    continue
                while True:
                    if stop.try_read() is not None:
                        stopped = True
                        break
                    try:
                        args.append(src.read(timeout_s=0.2))
                        break
                    except TimeoutError:
                        continue
                if stopped:
                    break
            if stopped:
                return "stopped"
            if not ins and stop.try_read() is not None:
                return "stopped"
            out = method(*args)
            for ch in outs:
                ch.write(np.asarray(out))
            if coll_plan is not None:
                contrib = np.asarray(out)
                # all ranks send first (ring capacity absorbs skew) ...
                for ch in coll_sends:
                    ch.write(contrib)
                # ... then fold in GLOBAL rank order so every rank
                # computes bit-identical floats (recvs arrive ordered by
                # peer rank; own contribution slots in at coll_plan rank)
                contribs = []
                stopped = False
                for slot, ch in enumerate(coll_recvs):
                    if slot == coll_plan["rank"]:
                        contribs.append(contrib)
                    while True:
                        if stop.try_read() is not None:
                            stopped = True
                            break
                        try:
                            contribs.append(ch.read(timeout_s=0.2))
                            break
                        except TimeoutError:
                            continue
                    if stopped:
                        return "stopped"
                if len(contribs) == len(coll_recvs):
                    contribs.append(contrib)  # own rank is last
                acc = contribs[0].copy()
                for c in contribs[1:]:
                    acc = coll_reduce(acc, c)
                for ch in coll_outs:
                    ch.write(acc)
    finally:
        for ch in chans.values():
            ch.close()


class CompiledDAGRef:
    """Future for one compiled execution (reference:
    experimental/compiled_dag_ref.py). Channel mode delivers results in
    execution order — get() must follow that order."""

    def __init__(self, dag: "CompiledDAG", value=None, seq: Optional[int] = None):
        self._dag = dag
        self._value = value
        self._seq = seq
        self._result = None
        self._got = False

    def get(self, timeout: Optional[float] = None):
        if self._seq is not None:  # channel mode
            return self._dag._channel_get(self, timeout)
        import ray_tpu_torch

        self._dag._retire(self)
        return ray_tpu_torch.get(self._value, timeout=timeout)

    def _wait_done(self) -> None:
        """Completion only — no payload fetch (backpressure path)."""
        import ray_tpu_torch

        refs = self._value if isinstance(self._value, list) else [self._value]
        ray_tpu_torch.wait(refs, num_returns=len(refs))


class CompiledDAG:
    def __init__(self, root: DAGNode, *, max_inflight_executions: int = 10):
        self._root = root
        self._schedule = root._topo()  # frozen order
        self._max_inflight = max_inflight_executions
        self._inflight: deque = deque()
        self._inputs = [n for n in self._schedule if type(n) is InputNode]
        if len(self._inputs) > 1:
            raise ValueError("compiled DAG must have exactly one InputNode")
        self._channel_mode = False
        self._torn_down = False
        if self._qualifies_for_channels():
            self._compile_channels()

    # ------------------------------------------------------- channel mode
    def _qualifies_for_channels(self) -> bool:
        for node in self._schedule:
            if type(node) in (InputNode, MultiOutputNode):
                continue
            if isinstance(node, ClassMethodNode) and getattr(
                node, "_channel_spec", None
            ):
                continue
            if isinstance(node, CollectiveOutputNode) and node._channel_spec:
                continue
            return False
        leaves = (
            list(self._root._bound_args)
            if isinstance(self._root, MultiOutputNode)
            else [self._root]
        )
        return bool(self._inputs) and all(
            isinstance(x, (ClassMethodNode, CollectiveOutputNode))
            for x in leaves
        )

    def _compile_channels(self) -> None:
        import ray_tpu_torch
        from ray_tpu_torch.experimental.channel.shm_channel import ShmChannel

        cap = self._max_inflight
        # one SPSC channel per edge (producer node -> consumer node);
        # the driver is producer for input edges and consumer of leaves
        self._edge_chans: Dict[Tuple[int, int], ShmChannel] = {}

        def edge(producer: DAGNode, consumer_id: int, spec) -> ShmChannel:
            key = (producer._id, consumer_id)
            if key not in self._edge_chans:
                self._edge_chans[key] = ShmChannel.create(
                    shape=spec[0], dtype=spec[1], capacity=cap
                )
            return self._edge_chans[key]

        def desc(ch: ShmChannel):
            # backend travels in the descriptor: both endpoints must map
            # the same segment layout (native C++ ring vs numpy ring)
            return (ch.name, ch.shape, str(ch.dtype), ch.capacity, False,
                    ch.backend)

        self._stop_chans: List[ShmChannel] = []
        self._loop_refs = []
        actors_seen = set()
        compute_nodes = [
            n for n in self._schedule if isinstance(n, ClassMethodNode)
        ]
        # collective groups: a full mesh of peer channels per group
        # (reference: collective_node.py binds a Communicator; here the
        # "communicator" is the pre-allocated channel mesh). Keyed by
        # parent node id -> per-actor exchange plan.
        coll_nodes = [
            n for n in self._schedule if isinstance(n, CollectiveOutputNode)
        ]
        self._coll_plans: Dict[int, dict] = {}
        groups_done = set()
        for cnode in coll_nodes:
            gkey = (cnode._op, tuple(sorted(p._id for p in cnode._group)))
            if gkey in groups_done:
                continue
            groups_done.add(gkey)
            group = cnode._group
            spec = cnode._channel_spec
            for parent in group:
                if parent._id in self._coll_plans:
                    # one exec loop per actor runs ONE exchange per
                    # tick; a parent in two groups (different op or
                    # overlapping membership) would need two
                    raise ValueError(
                        "channel-compiled DAGs support one collective "
                        "per participating node (node "
                        f"{parent._method._name!r} is in two groups)"
                    )
            # mesh channels live in their own key namespace — a data
            # edge between two group members (one parent feeding
            # another) must NOT share a channel with the exchange
            def mesh(src, dst):
                key = ("mesh", src._id, dst._id)
                if key not in self._edge_chans:
                    self._edge_chans[key] = ShmChannel.create(
                        shape=spec[0], dtype=spec[1], capacity=cap
                    )
                return self._edge_chans[key]

            for i, src in enumerate(group):
                for j, dst in enumerate(group):
                    if i != j:
                        mesh(src, dst)
            for i, parent in enumerate(group):
                self._coll_plans[parent._id] = {
                    "op": cnode._op,
                    "rank": i,
                    "sends": [
                        desc(mesh(parent, dst))
                        for j, dst in enumerate(group) if j != i
                    ],
                    # recvs ordered by peer rank for the deterministic
                    # global fold in the exec loop
                    "recvs": [
                        desc(mesh(src, parent))
                        for j, src in enumerate(group) if j != i
                    ],
                    "outs": [],  # filled by the out-edge pass below
                }
        for node in compute_nodes:
            actor = node._method._handle
            aid = actor._actor_id.binary()
            if aid in actors_seen:
                raise ValueError(
                    "channel-compiled DAGs support one node per actor "
                    "(the resident exec loop pins the actor)"
                )
            actors_seen.add(aid)
            arg_plan = []
            for arg in node._bound_args:
                if isinstance(arg, InputNode):
                    spec = getattr(arg, "_channel_spec", None) or node._channel_spec
                    arg_plan.append(("chan", desc(edge(arg, node._id, spec))))
                elif isinstance(arg, ClassMethodNode):
                    arg_plan.append(
                        ("chan", desc(edge(arg, node._id, arg._channel_spec)))
                    )
                elif isinstance(arg, DAGNode):
                    raise ValueError(
                        f"unsupported upstream node {type(arg).__name__} in "
                        "channel-compiled DAG"
                    )
                else:
                    arg_plan.append(("lit", arg))
            # output edges materialize when consumers register; collect
            # them after the full pass
            node._arg_plan = arg_plan
        # second pass: each node's out-edges (to consumers or the driver)
        self._out_chans: List[ShmChannel] = []
        leaves = (
            list(self._root._bound_args)
            if isinstance(self._root, MultiOutputNode)
            else [self._root]
        )
        for cnode in coll_nodes:
            if cnode in leaves:
                ch = edge(cnode, -1, cnode._channel_spec)  # -1 = driver
                self._coll_plans[cnode._parent._id]["outs"].append(desc(ch))
        for node in compute_nodes:
            out_descs = []
            for key, ch in self._edge_chans.items():
                # mesh keys are ("mesh", src, dst) — never match a node id
                if key[0] == node._id:
                    out_descs.append(desc(ch))
            if node in leaves:
                ch = edge(node, -1, node._channel_spec)  # -1 = driver
                out_descs.append(desc(ch))
            stop = ShmChannel.create(shape=(1,), dtype="int8", capacity=4)
            self._stop_chans.append(stop)
            self._loop_refs.append(
                node._method._handle.__ray_call__.remote(
                    _compiled_exec_loop,
                    node._method._name,
                    node._arg_plan,
                    out_descs,
                    desc(stop),
                    self._coll_plans.get(node._id),
                )
            )
        self._driver_out = [self._edge_chans[(leaf._id, -1)] for leaf in leaves]
        self._multi_output = isinstance(self._root, MultiOutputNode)
        self._input_edges = [
            ch for key, ch in self._edge_chans.items()
            if key[0] == self._inputs[0]._id
        ] if self._inputs else []
        self._seq_submit = itertools.count()
        self._seq_read = 0
        self._channel_mode = True

    def _channel_execute(self, args) -> CompiledDAGRef:
        import numpy as np

        if self._torn_down:
            raise RuntimeError("compiled DAG was torn down")
        if len(args) != 1:
            raise ValueError("channel-compiled DAGs take exactly one input array")
        while len(self._inflight) >= self._max_inflight:
            # backpressure: block until the oldest result is consumed
            oldest = self._inflight[0]
            self._channel_get(oldest, timeout=60.0)
        arr = np.asarray(args[0])
        for ch in self._input_edges:
            ch.write(arr)
        ref = CompiledDAGRef(self, seq=next(self._seq_submit))
        self._inflight.append(ref)
        return ref

    def _channel_get(self, ref: CompiledDAGRef, timeout: Optional[float]):
        if ref._got:
            return ref._result
        if ref._seq != self._seq_read:
            raise RuntimeError(
                "channel-mode results must be consumed in execution order "
                f"(next is seq {self._seq_read}, asked for {ref._seq})"
            )
        out = [ch.read(timeout_s=timeout or 60.0) for ch in self._driver_out]
        ref._result = out if self._multi_output else out[0]
        ref._got = True
        self._seq_read += 1
        try:
            self._inflight.remove(ref)
        except ValueError:
            pass
        return ref._result

    # ---------------------------------------------------------- execution
    def execute(self, *args, **kwargs) -> CompiledDAGRef:
        if self._channel_mode:
            return self._channel_execute(args)
        while len(self._inflight) >= self._max_inflight:
            oldest = self._inflight.popleft()
            oldest._wait_done()
        results: Dict[int, Any] = {}
        for node in self._schedule:
            results[node._id] = node._apply(results, args, kwargs)
        ref = CompiledDAGRef(self, value=results[self._root._id])
        self._inflight.append(ref)
        return ref

    def _retire(self, ref: CompiledDAGRef) -> None:
        try:
            self._inflight.remove(ref)
        except ValueError:
            pass

    def teardown(self) -> None:
        self._inflight.clear()
        if self._channel_mode and not self._torn_down:
            self._torn_down = True
            import numpy as np

            import ray_tpu_torch

            for stop in self._stop_chans:
                try:
                    stop.write(np.zeros(1, dtype=np.int8))
                except TimeoutError:
                    pass
            try:
                ray_tpu_torch.get(self._loop_refs, timeout=10)
            except Exception:
                pass
            for ch in self._edge_chans.values():
                ch.close(unlink=True)
            for stop in self._stop_chans:
                stop.close(unlink=True)

    def __del__(self):
        try:
            self.teardown()
        except Exception:
            pass
