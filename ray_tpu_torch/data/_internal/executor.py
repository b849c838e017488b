"""Streaming executor: runs a logical plan as a pipeline of block tasks.

Parity: python/ray/data/_internal/execution/streaming_executor.py:52 —
a control loop that dispatches `ray.remote` block tasks per operator,
streams finished blocks downstream, and caps in-flight work (the
ResourceManager/backpressure role is played by `max_tasks_in_flight`).
One-to-one stages pipeline (a block flows to the next stage while its
siblings are still being produced); all-to-all stages (shuffle, sort,
aggregate, repartition) are barriers, implemented as 2-stage
partition/merge task graphs (the push-based shuffle shape,
data/_internal/planner/exchange/push_based_shuffle_task_scheduler.py).

Actor-pool compute (reference: ActorPoolMapOperator) pins stateful/
device UDFs to a pool of actors — the `num_gpus` batch-inference path:
each pool actor owns its GPUs for its lifetime (``num_gpus`` is the
pinned resource: the runtime sets ``CUDA_VISIBLE_DEVICES`` before the UDF
runs) and the UDF keeps its model on the card across batches. ``num_gpus``
reaches the runtime as ``num_gpus`` on the task path and the actor path
alike; "TPU" stays a countable resource.
"""

from __future__ import annotations

import random
from collections import deque
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple

import numpy as np

from ..block import Block, BlockAccessor
from ..context import DataContext
from . import plan as L

# ---------------------------------------------------------------- UDF glue


def _apply_one(op_kind: str, fn: Callable, spec: dict, block: Block) -> List[Block]:
    """Apply one logical op to one block, returning output blocks."""
    acc = BlockAccessor.for_block(block)
    if acc.num_rows() == 0:
        return []  # drop empty blocks; never invoke UDFs on them
    if op_kind == "map_rows":
        return [BlockAccessor.batch_to_block([fn(r) for r in acc.iter_rows()])]
    if op_kind == "filter":
        rows = [r for r in acc.iter_rows() if fn(r)]
        return [BlockAccessor.batch_to_block(rows)] if rows else []
    if op_kind == "flat_map":
        rows: List[Any] = []
        for r in acc.iter_rows():
            rows.extend(fn(r))
        return [BlockAccessor.batch_to_block(rows)] if rows else []
    if op_kind == "map_batches":
        bs = spec.get("batch_size")
        fmt = spec.get("batch_format", "numpy")
        n = acc.num_rows()
        out: List[Block] = []
        step = bs or n
        for lo in range(0, n, step):
            sub = BlockAccessor.for_block(acc.slice(lo, min(lo + step, n)))
            res = fn(sub.to_batch(fmt))
            out.append(BlockAccessor.batch_to_block(res))
        return out
    raise ValueError(f"unknown op kind {op_kind}")


def _apply_chain(chain: List[Tuple[str, Callable, dict]], block: Block) -> List[Block]:
    blocks = [block]
    for kind, fn, spec in chain:
        nxt: List[Block] = []
        for b in blocks:
            nxt.extend(_apply_one(kind, fn, spec, b))
        blocks = nxt
    return blocks


def _publish(blocks: List[Block]) -> List[Any]:
    """Worker-side: put each output block into the object store and
    return just the refs — blocks never round-trip through the driver
    (the reference's tasks likewise seal blocks into plasma and ship
    RefBundles of metadata, §3.5 step 3)."""
    import ray_tpu_torch

    return [ray_tpu_torch.put(b) for b in blocks]


def _run_read_task(read_fn: Callable, chain: List[Tuple[str, Callable, dict]]):
    """Worker-side: run a ReadTask then the fused transform chain."""
    out: List[Block] = []
    for block in read_fn():
        out.extend(_apply_chain(chain, block))
    return _publish(out)


def _run_chain_task(chain: List[Tuple[str, Callable, dict]], block: Block):
    return _publish(_apply_chain(chain, block))


class _ChainActor:
    """Actor-pool UDF host (reference: ActorPoolMapOperator worker).
    Instantiates callable-class UDFs once; GPUs assigned to this actor
    stay pinned so device state persists across batches."""

    def __init__(self, chain_spec: List[Tuple[str, Any, dict, tuple, dict]]):
        self.chain: List[Tuple[str, Callable, dict]] = []
        for kind, fn, spec, ctor_args, ctor_kwargs in chain_spec:
            if isinstance(fn, type):
                fn = fn(*ctor_args, **ctor_kwargs)
            self.chain.append((kind, fn, spec))

    def run(self, block: Block) -> List[Any]:
        return _publish(_apply_chain(self.chain, block))


# ------------------------------------------------------------ physical plan


class _Stage:
    kind = "abstract"

    def __init__(self, name: str):
        self.name = name


class _InputStage(_Stage):
    kind = "input"

    def __init__(self, refs: List[Any]):
        super().__init__("Input")
        self.refs = refs


class _ReadStage(_Stage):
    kind = "read"

    def __init__(self, read_tasks, chain, name):
        super().__init__(name)
        self.read_tasks = read_tasks
        self.chain = chain


class _MapStage(_Stage):
    kind = "map"

    def __init__(self, chain, name, compute=None, resources=None, concurrency=None):
        super().__init__(name)
        self.chain = chain  # [(kind, fn, spec, ctor_args, ctor_kwargs)]
        self.compute = compute
        self.resources = dict(resources or {})
        self.concurrency = concurrency


class _AllToAllStage(_Stage):
    kind = "all_to_all"

    def __init__(self, op: L.LogicalOp, name: str):
        super().__init__(name)
        self.op = op


class _LimitStage(_Stage):
    kind = "limit"

    def __init__(self, n: int):
        super().__init__(f"Limit[{n}]")
        self.n = n


def _op_to_chain_entry(op: L.OneToOne):
    kind = {
        L.MapRows: "map_rows",
        L.Filter: "filter",
        L.FlatMap: "flat_map",
        L.MapBatches: "map_batches",
    }[type(op)]
    spec = {}
    if isinstance(op, L.MapBatches):
        spec = {"batch_size": op.batch_size, "batch_format": op.batch_format}
    return (
        kind,
        op.fn,
        spec,
        tuple(op.fn_constructor_args),
        dict(op.fn_constructor_kwargs),
    )


def build_stages(logical: L.LogicalPlan) -> List[_Stage]:
    """Lower + fuse: adjacent task-compute OneToOne ops merge into one
    _MapStage; a leading fused chain merges into the read stage."""
    stages: List[_Stage] = []
    pending_chain: List[tuple] = []
    pending_meta: List[str] = []
    pending_compute = None
    pending_resources: Dict[str, float] = {}
    pending_concurrency = None

    def flush():
        nonlocal pending_chain, pending_compute, pending_resources
        nonlocal pending_concurrency, pending_meta
        if not pending_chain:
            return
        name = "->".join(pending_meta)
        if (
            stages
            and isinstance(stages[-1], _ReadStage)
            and pending_compute is None
            and not pending_resources
        ):
            stages[-1].chain = stages[-1].chain + list(pending_chain)
            stages[-1].name += "->" + name
        else:
            stages.append(
                _MapStage(
                    list(pending_chain),
                    name,
                    compute=pending_compute,
                    resources=pending_resources,
                    concurrency=pending_concurrency,
                )
            )
        pending_chain = []
        pending_meta = []
        pending_compute = None
        pending_resources = {}
        pending_concurrency = None

    for op in logical.ops():
        if isinstance(op, L.Read):
            stages.append(
                _ReadStage(
                    op.datasource.get_read_tasks(op.parallelism),
                    [],
                    f"Read{op.datasource.get_name()}",
                )
            )
        elif isinstance(op, L.FromBlocks):
            stages.append(_InputStage(op.blocks))
        elif isinstance(op, L.OneToOne):
            uses_actors = op.compute is not None
            has_res = bool(op.resources)
            if pending_chain and (uses_actors or has_res or pending_compute is not None):
                flush()
            pending_chain.append(_op_to_chain_entry(op))
            pending_meta.append(op.name)
            if uses_actors:
                pending_compute = op.compute
            if has_res:
                pending_resources = dict(op.resources)
            if op.concurrency is not None:
                pending_concurrency = op.concurrency
            if uses_actors or has_res:
                flush()
        elif isinstance(op, L.Limit):
            flush()
            stages.append(_LimitStage(op.n))
        elif isinstance(op, (L.Repartition, L.RandomShuffle, L.Sort, L.Aggregate, L.Union, L.Zip)):
            flush()
            stages.append(_AllToAllStage(op, op.name))
        else:
            raise NotImplementedError(f"op {op.name}")
    flush()
    return stages


# ---------------------------------------------------------------- executor


class StreamingExecutor:
    """Pull-driven pipeline. `execute()` yields final block refs as they
    become available."""

    def __init__(self, stages: List[_Stage]):
        self.stages = stages
        self.ctx = DataContext.get_current()

    # -- public -------------------------------------------------------
    def execute(self) -> Iterator[Any]:
        """Yield ObjectRefs of final blocks (each ref -> List[Block]-free
        single Block). Per-stage wall times and block counts accumulate
        in ``self.stage_stats`` (reference: data/_internal/stats.py
        per-operator DatasetStats behind ds.stats())."""
        import time as _time

        self.stage_stats: List[dict] = []
        stream: Iterator[Any] = iter(())
        for stage in self.stages:
            if stage.kind == "input":
                stream = iter(stage.refs)
            elif stage.kind == "read":
                stream = self._run_read(stage)
            elif stage.kind == "map":
                stream = self._run_map(stage, stream)
            elif stage.kind == "limit":
                stream = self._run_limit(stage, stream)
            elif stage.kind == "all_to_all":
                stream = self._run_all_to_all(stage, stream)
            if stage.kind != "input":
                stat = {"name": stage.name, "wall_s": 0.0, "blocks": 0}
                self.stage_stats.append(stat)
                stream = self._timed(stream, stat, _time)
        return self._publish_stats_on_drain(stream)

    def _publish_stats_on_drain(self, stream: Iterator[Any]) -> Iterator[Any]:
        """When the pipeline drains, snapshot per-op stats into the
        cluster KV so the dashboard's data view can render them
        (reference: the dashboard's data section reads
        DatasetStats via the stats actor)."""
        yield from stream
        try:
            import json as _json
            import time as _time

            from ray_tpu_torch._private import worker

            client = worker._client
            if client is None:
                return
            snap = _json.dumps({
                "finished_at": _time.time(),
                "stages": self.stage_stats,
            }).encode()
            client.kv_put(
                f"__data_stats__{_time.time():.6f}".encode(), snap,
                overwrite=True,
            )
            # bound the ring: keep the newest 50 snapshots
            keys = sorted(client.kv_keys(b"__data_stats__"))
            for k in keys[:-50]:
                client.kv_del(k)
        except Exception:
            pass  # stats publishing must never fail a data job

    @staticmethod
    def _timed(stream: Iterator[Any], stat: dict, _time) -> Iterator[Any]:
        """Cumulative time spent pulling through this stage's iterator
        (includes upstream; ds.stats() reports the self-time deltas)."""
        while True:
            t0 = _time.perf_counter()
            try:
                item = next(stream)
            except StopIteration:
                stat["wall_s"] += _time.perf_counter() - t0
                return
            stat["wall_s"] += _time.perf_counter() - t0
            stat["blocks"] += 1
            yield item

    # -- helpers ------------------------------------------------------
    def _ray(self):
        import ray_tpu_torch

        return ray_tpu_torch

    def _flatten_refs(self, list_ref) -> List[Any]:
        """A task returned List[ObjectRef] (blocks already published by
        the worker); only the small ref list crosses to the driver."""
        ray = self._ray()
        return list(ray.get(list_ref))

    def _run_read(self, stage: _ReadStage) -> Iterator[Any]:
        ray = self._ray()
        remote = ray.remote(_run_read_task)
        plain_chain = [(k, f, s) for (k, f, s, _a, _kw) in stage.chain]
        pending = deque(stage.read_tasks)
        in_flight: deque = deque()  # submission order == output order
        cap = self.ctx.max_tasks_in_flight
        while pending or in_flight:
            batch = []
            while pending and len(in_flight) + len(batch) < cap:
                rt = pending.popleft()
                batch.append((rt.read_fn, plain_chain))
            if batch:
                # one SUBMIT_TASKS frame per window refill, not one
                # frame per read task
                in_flight.extend(remote.map(batch))
            yield from self._flatten_refs(in_flight.popleft())

    def _run_map(self, stage: _MapStage, upstream: Iterator[Any]) -> Iterator[Any]:
        if stage.compute is not None:
            yield from self._run_actor_map(stage, upstream)
            return
        ray = self._ray()
        remote = ray.remote(_run_chain_task)
        if stage.resources:
            opts = {}
            if "TPU" in stage.resources:
                opts["num_tpus"] = stage.resources["TPU"]
            if "CPU" in stage.resources:
                opts["num_cpus"] = stage.resources["CPU"]
            if "GPU" in stage.resources:
                # the pinned resource: CUDA_VISIBLE_DEVICES is set for it
                opts["num_gpus"] = stage.resources["GPU"]
            rest = {k: v for k, v in stage.resources.items()
                    if k not in ("TPU", "CPU", "GPU")}
            if rest:
                opts["resources"] = rest
            remote = remote.options(**opts)
        plain_chain = [(k, f, s) for (k, f, s, _a, _kw) in stage.chain]
        in_flight: deque = deque()  # submission order == output order
        cap = self.ctx.max_tasks_in_flight
        upstream_done = False
        up = upstream
        while not upstream_done or in_flight:
            batch = []
            while not upstream_done and len(in_flight) + len(batch) < cap:
                try:
                    block_ref = next(up)
                except StopIteration:
                    upstream_done = True
                    break
                batch.append((plain_chain, block_ref))
            if batch:
                # whole window refill rides one SUBMIT_TASKS frame
                in_flight.extend(remote.map(batch))
            if not in_flight:
                continue
            yield from self._flatten_refs(in_flight.popleft())

    def _run_actor_map(self, stage: _MapStage, upstream: Iterator[Any]) -> Iterator[Any]:
        ray = self._ray()
        compute = stage.compute
        size = getattr(compute, "size", None) or getattr(compute, "min_size", 1)
        if isinstance(stage.concurrency, int):
            size = stage.concurrency
        elif isinstance(stage.concurrency, tuple):
            size = stage.concurrency[0]
        actor_cls = ray.remote(_ChainActor)
        opts: Dict[str, Any] = {"num_cpus": stage.resources.get("CPU", 1)}
        if stage.resources.get("TPU"):
            opts["num_tpus"] = stage.resources["TPU"]
        if stage.resources.get("GPU"):
            opts["num_gpus"] = stage.resources["GPU"]
        pool = [
            actor_cls.options(**opts).remote(stage.chain) for _ in range(size)
        ]
        try:
            idle = deque(pool)
            busy: Dict[Any, Any] = {}  # ref -> actor
            submitted: deque = deque()  # output order
            completed = set()
            upstream_done = False
            up = upstream
            while not upstream_done or busy or submitted:
                while not upstream_done and idle:
                    try:
                        block_ref = next(up)
                    except StopIteration:
                        upstream_done = True
                        break
                    actor = idle.popleft()
                    ref = actor.run.remote(block_ref)
                    busy[ref] = actor
                    submitted.append(ref)
                if busy:
                    ready, _ = ray.wait(list(busy.keys()), num_returns=1)
                    for r in ready:
                        idle.append(busy.pop(r))
                        completed.add(r)
                # emit in submission order as soon as the head is done
                while submitted and submitted[0] in completed:
                    completed.discard(submitted[0])
                    yield from self._flatten_refs(submitted.popleft())
        finally:
            for a in pool:
                try:
                    ray.kill(a)
                except Exception:
                    pass

    def _run_limit(self, stage: _LimitStage, upstream: Iterator[Any]) -> Iterator[Any]:
        ray = self._ray()
        remaining = stage.n
        for ref in upstream:
            if remaining <= 0:
                break
            block = ray.get(ref)
            acc = BlockAccessor.for_block(block)
            n = acc.num_rows()
            if n <= remaining:
                remaining -= n
                yield ref
            else:
                yield ray.put(acc.slice(0, remaining))
                remaining = 0

    # -- all-to-all ----------------------------------------------------
    def _run_all_to_all(self, stage: _AllToAllStage, upstream: Iterator[Any]) -> Iterator[Any]:
        op = stage.op
        refs = list(upstream)  # barrier
        if isinstance(op, L.Repartition):
            yield from self._repartition(refs, op.num_blocks)
        elif isinstance(op, L.RandomShuffle):
            yield from self._random_shuffle(refs, op.seed, op.num_blocks)
        elif isinstance(op, L.Sort):
            yield from self._sort(refs, op.key, op.descending)
        elif isinstance(op, L.Aggregate):
            yield from self._aggregate(refs, op.key, op.aggs)
        elif isinstance(op, L.Union):
            yield from refs
            for other in op.others:
                other_stages = build_stages(L.LogicalPlan(other))
                yield from StreamingExecutor(other_stages).execute()
        elif isinstance(op, L.Zip):
            yield from self._zip(refs, op.other)
        else:
            raise NotImplementedError(op.name)

    def _exchange_parts(
        self, refs: List[Any], submit_split: Callable[[Any], List[Any]], k: int
    ) -> List[List[Any]]:
        """Map phase of a 2-stage exchange -> per-partition piece lists.

        With ``DataContext.use_push_based_shuffle`` (default), map
        outputs are consumed in rounds of ~sqrt(M): each round's k
        pieces are partially concatenated as soon as that round's maps
        are submitted, so partial merges overlap the remaining maps and
        the final per-partition merge fans in O(sqrt(M)) refs instead of
        M (reference: push_based_shuffle_task_scheduler.py:112,400 —
        pipelined map/merge rounds). Pull-based fallback keeps one piece
        per map."""
        parts: List[List[Any]] = [[] for _ in range(k)]
        if k == 1:
            parts[0] = list(refs)
            return parts
        push = self.ctx.use_push_based_shuffle and len(refs) > 3
        if not push:
            for ref in refs:
                for i, piece in enumerate(submit_split(ref)):
                    parts[i].append(piece)
            return parts
        ray = self._ray()
        concat = ray.remote(lambda *bs: BlockAccessor.concat(list(bs)))
        round_size = max(2, int(len(refs) ** 0.5))
        pending: List[List[Any]] = []

        def flush_round():
            for i in range(k):
                pieces = [out[i] for out in pending]
                parts[i].append(
                    concat.remote(*pieces) if len(pieces) > 1 else pieces[0]
                )

        for ref in refs:
            pending.append(submit_split(ref))
            if len(pending) >= round_size:
                flush_round()
                pending.clear()
        if pending:
            flush_round()
        return parts

    def _repartition(self, refs: List[Any], k: int) -> Iterator[Any]:
        ray = self._ray()

        def split(block: Block, k: int) -> List[Block]:
            acc = BlockAccessor.for_block(block)
            n = acc.num_rows()
            cuts = [round(i * n / k) for i in range(k + 1)]
            return [acc.slice(cuts[i], cuts[i + 1]) for i in range(k)]

        split_remote = ray.remote(split).options(num_returns=k) if k > 1 else None
        parts = self._exchange_parts(
            refs, lambda ref: split_remote.remote(ref, k), k
        )
        merge = ray.remote(lambda *blocks: BlockAccessor.concat(list(blocks)))
        for i in range(k):
            yield merge.remote(*parts[i]) if parts[i] else ray.put([])

    def _random_shuffle(self, refs, seed, num_blocks) -> Iterator[Any]:
        ray = self._ray()
        k = num_blocks or max(len(refs), 1)
        rng = random.Random(seed)

        def split_shuffled(block: Block, k: int, s: int) -> List[Block]:
            acc = BlockAccessor.for_block(block)
            n = acc.num_rows()
            r = np.random.RandomState(s)
            assign = r.randint(0, k, size=n)
            return [acc.take(np.nonzero(assign == i)[0]) for i in range(k)]

        split_remote = ray.remote(split_shuffled).options(num_returns=k)
        parts = self._exchange_parts(
            refs, lambda ref: split_remote.remote(ref, k, rng.randrange(2**31)), k
        )

        def merge_shuffle(s: int, *blocks: Block) -> Block:
            merged = BlockAccessor.concat(list(blocks))
            acc = BlockAccessor.for_block(merged)
            r = np.random.RandomState(s)
            idx = r.permutation(acc.num_rows())
            return acc.take(idx)

        merge = ray.remote(merge_shuffle)
        for i in range(k):
            s = rng.randrange(2**31)
            yield merge.remote(s, *parts[i]) if parts[i] else ray.put([])

    def _sort(self, refs, key, descending) -> Iterator[Any]:
        """Sample-based range partition + per-partition sort (reference:
        data/_internal/planner/exchange/sort_task_spec.py)."""
        ray = self._ray()
        if not refs:
            return
        k = len(refs)

        def keyvals(block: Block) -> np.ndarray:
            acc = BlockAccessor.for_block(block)
            if callable(key):
                return np.asarray([key(r) for r in acc.iter_rows()])
            if isinstance(block, dict):
                return block[key]
            return np.asarray([r[key] for r in block])

        def sample(block: Block) -> np.ndarray:
            vals = keyvals(block)
            if len(vals) == 0:
                return vals
            idx = np.linspace(0, len(vals) - 1, num=min(20, len(vals))).astype(int)
            return vals[idx]

        samples = ray.get([ray.remote(sample).remote(r) for r in refs])
        allv = np.sort(np.concatenate([s for s in samples if len(s)]))
        if len(allv) == 0:
            yield from refs
            return
        cuts = [allv[round(i * (len(allv) - 1) / k)] for i in range(1, k)]

        def split_range(block: Block, cuts_: List[Any]) -> List[Block]:
            acc = BlockAccessor.for_block(block)
            vals = keyvals(block)
            assign = np.searchsorted(np.asarray(cuts_), vals, side="right")
            return [acc.take(np.nonzero(assign == i)[0]) for i in range(len(cuts_) + 1)]

        split_remote = ray.remote(split_range).options(num_returns=k)
        parts = self._exchange_parts(
            refs, lambda ref: split_remote.remote(ref, cuts), k
        )

        def merge_sorted(*blocks: Block) -> Block:
            merged = BlockAccessor.concat(list(blocks))
            acc = BlockAccessor.for_block(merged)
            if acc.num_rows() == 0:
                return merged
            return acc.take(acc.sort_indices(key, descending))

        merge = ray.remote(merge_sorted)
        order = range(k - 1, -1, -1) if descending else range(k)
        for i in order:
            if parts[i]:
                yield merge.remote(*parts[i])

    def _aggregate(self, refs, key, aggs) -> Iterator[Any]:
        """Hash partition by key + per-partition combine."""
        ray = self._ray()
        k = max(1, min(len(refs), self.ctx.shuffle_partitions))

        def split_hash(block: Block, k: int) -> List[Block]:
            import zlib

            acc = BlockAccessor.for_block(block)
            if key is None:
                return [block] + [acc.slice(0, 0)] * (k - 1)
            if isinstance(block, dict):
                vals = block[key]
            else:
                vals = np.asarray([r[key] for r in block])
            # deterministic cross-process hash: Python's hash() is salted
            # per-process, which would scatter one key over partitions
            hashes = np.asarray(
                [zlib.crc32(repr(v).encode()) % k for v in vals]
            )
            return [acc.take(np.nonzero(hashes == i)[0]) for i in range(k)]

        split_remote = ray.remote(split_hash).options(num_returns=k)
        parts = self._exchange_parts(
            refs, lambda ref: split_remote.remote(ref, k), k
        )

        def combine(key_, aggs_, *blocks: Block) -> Block:
            from ..aggregate import aggregate_block

            merged = BlockAccessor.concat(list(blocks))
            return aggregate_block(merged, key_, aggs_)

        merge = ray.remote(combine)
        for i in range(k):
            if parts[i]:
                yield merge.remote(key, aggs, *parts[i])

    def _zip(self, refs: List[Any], other: L.LogicalOp) -> Iterator[Any]:
        # worker-side merge: the driver only shuffles REFS (r1 Weak
        # finding: both sides used to materialize in the driver)
        ray = self._ray()
        other_refs = list(StreamingExecutor(build_stages(L.LogicalPlan(other))).execute())

        def zip_blocks(n_left: int, *blocks: Block) -> Block:
            left = BlockAccessor.concat(list(blocks[:n_left]))
            right = BlockAccessor.concat(list(blocks[n_left:]))
            la = BlockAccessor.for_block(left)
            ra = BlockAccessor.for_block(right)
            if la.num_rows() != ra.num_rows():
                raise ValueError(
                    f"zip requires equal row counts, got {la.num_rows()} "
                    f"vs {ra.num_rows()}"
                )
            if isinstance(left, dict) and isinstance(right, dict):
                merged = dict(left)
                for c, v in right.items():
                    merged[c if c not in merged else f"{c}_1"] = v
                return merged
            return [
                {**(lr if isinstance(lr, dict) else {"left": lr}),
                 **(rr if isinstance(rr, dict) else {"right": rr})}
                for lr, rr in zip(la.iter_rows(), ra.iter_rows())
            ]

        yield ray.remote(zip_blocks).remote(len(refs), *refs, *other_refs)
