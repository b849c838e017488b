"""Dataset: the lazy distributed data API.

Parity: python/ray/data/dataset.py (6,080 lines in the reference; the
surface here covers the operations its users reach for: map/map_batches
/filter/flat_map, shuffles/sort/groupby, consumption, splits) +
read_api.py. Everything is lazy: transforms append logical ops;
consumption lowers through build_stages and runs on the streaming
executor (see _internal/executor.py).

On the port: ``iter_batches(device_put=...)`` stages columnar numpy
batches into device memory (pinned host memory, a side stream,
double-buffering; see iterator.py) and ``iter_torch_batches`` yields those
tensors themselves; ``map_batches(..., num_gpus=n)`` pins n GPUs to each
task or pool actor — together the reference's GPU batch-inference path
(§3.5 step 4).
"""

from __future__ import annotations

import builtins
import itertools
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple, Union

import numpy as np

from .aggregate import AggregateFn, Count, Max, Mean, Min, Std, Sum
from .block import Block, BlockAccessor
from .context import DataContext
from ._internal import plan as L
from ._internal.executor import StreamingExecutor, build_stages


class ActorPoolStrategy:
    """Parity: ray.data.ActorPoolStrategy — pin UDFs to a pool of
    actors (stateful / device-holding UDFs)."""

    def __init__(self, size: Optional[int] = None, min_size: int = 1, max_size: Optional[int] = None):
        self.size = size
        self.min_size = size or min_size
        self.max_size = size or max_size or self.min_size


class Dataset:
    def __init__(self, logical: L.LogicalPlan):
        self._logical = logical
        self._materialized: Optional[List[Any]] = None  # block refs

    # ------------------------------------------------------ transforms
    def _append(self, op: L.LogicalOp) -> "Dataset":
        return Dataset(self._logical.with_op(op))

    def map(self, fn: Callable, **opts) -> "Dataset":
        return self._append(L.MapRows(fn=fn, **_map_opts(opts)))

    def filter(self, fn: Callable, **opts) -> "Dataset":
        return self._append(L.Filter(fn=fn, **_map_opts(opts)))

    def flat_map(self, fn: Callable, **opts) -> "Dataset":
        return self._append(L.FlatMap(fn=fn, **_map_opts(opts)))

    def map_batches(
        self,
        fn: Union[Callable, type],
        *,
        batch_size: Optional[int] = None,
        batch_format: str = "numpy",
        compute: Optional[ActorPoolStrategy] = None,
        fn_constructor_args: Tuple = (),
        fn_constructor_kwargs: Optional[dict] = None,
        num_tpus: Optional[float] = None,
        num_cpus: Optional[float] = None,
        num_gpus: Optional[float] = None,
        concurrency: Optional[Union[int, Tuple[int, int]]] = None,
        zero_copy_batch: bool = False,
        **_ignored,
    ) -> "Dataset":
        resources: Dict[str, float] = {}
        if num_tpus:
            resources["TPU"] = float(num_tpus)
        if num_cpus:
            resources["CPU"] = float(num_cpus)
        if num_gpus:
            resources["GPU"] = float(num_gpus)
        if isinstance(fn, type) and compute is None:
            # class UDFs imply actor compute (reference requires explicit
            # concurrency; we default the pool to `concurrency` or 1)
            compute = ActorPoolStrategy(
                size=concurrency if isinstance(concurrency, int) else None
            )
        return self._append(
            L.MapBatches(
                fn=fn,
                batch_size=batch_size,
                batch_format=batch_format,
                compute=compute,
                fn_constructor_args=tuple(fn_constructor_args),
                fn_constructor_kwargs=dict(fn_constructor_kwargs or {}),
                resources=resources,
                concurrency=concurrency,
                zero_copy_batch=zero_copy_batch,
            )
        )

    def limit(self, n: int) -> "Dataset":
        return self._append(L.Limit(n=n))

    def repartition(self, num_blocks: int) -> "Dataset":
        return self._append(L.Repartition(num_blocks=num_blocks))

    def random_shuffle(self, *, seed: Optional[int] = None, num_blocks: Optional[int] = None) -> "Dataset":
        return self._append(L.RandomShuffle(seed=seed, num_blocks=num_blocks))

    def sort(self, key: Union[str, Callable], descending: bool = False) -> "Dataset":
        return self._append(L.Sort(key=key, descending=descending))

    def groupby(self, key: str) -> "GroupedData":
        return GroupedData(self, key)

    def aggregate(self, *aggs: AggregateFn) -> Dict[str, Any]:
        ds = self._append(L.Aggregate(key=None, aggs=list(aggs)))
        rows = list(ds.iter_rows())
        return {k: v for r in rows for k, v in r.items()}

    # scalar aggregates (reference: Dataset.sum/min/max/mean/std —
    # None on an empty dataset, matching the reference's contract)
    def sum(self, on: str):
        return self.aggregate(Sum(on)).get(f"sum({on})")

    def min(self, on: str):
        return self.aggregate(Min(on)).get(f"min({on})")

    def max(self, on: str):
        return self.aggregate(Max(on)).get(f"max({on})")

    def mean(self, on: str):
        return self.aggregate(Mean(on)).get(f"mean({on})")

    def std(self, on: str, ddof: int = 1):
        return self.aggregate(Std(on, ddof=ddof)).get(f"std({on})")

    def unique(self, column: str) -> List[Any]:
        """Distinct values of one column (reference: Dataset.unique —
        no total order imposed; sorted only when the values allow it)."""
        out: Dict[Any, None] = {}
        for batch in self.select_columns([column]).iter_batches():
            col = np.asarray(batch[column])
            try:
                vals = np.unique(col).tolist()  # C-speed for plain dtypes
            except TypeError:
                vals = col.tolist()  # mixed/unorderable object columns
            for v in vals:
                out[v] = None
        values = list(out)
        try:
            return sorted(values)
        except TypeError:
            return values  # mixed/unorderable types: first-seen order

    def show(self, limit: int = 20) -> None:
        """Print the first rows (reference: Dataset.show)."""
        for row in self.take(limit):
            print(row)

    def union(self, *others: "Dataset") -> "Dataset":
        return self._append(L.Union(others=[o._logical.terminal for o in others]))

    def zip(self, other: "Dataset") -> "Dataset":
        return self._append(L.Zip(other=other._logical.terminal))

    def add_column(self, name: str, fn: Callable) -> "Dataset":
        def add(batch):
            batch[name] = np.asarray(fn(batch))
            return batch

        return self.map_batches(add)

    def drop_columns(self, cols: List[str]) -> "Dataset":
        def drop(batch):
            return {k: v for k, v in batch.items() if k not in cols}

        return self.map_batches(drop)

    def select_columns(self, cols: List[str]) -> "Dataset":
        def select(batch):
            return {k: batch[k] for k in cols}

        return self.map_batches(select)

    def rename_columns(self, mapping: Dict[str, str]) -> "Dataset":
        def rename(batch):
            return {mapping.get(k, k): v for k, v in batch.items()}

        return self.map_batches(rename)

    # ----------------------------------------------------- consumption
    def _block_refs(self) -> Iterator[Any]:
        if self._materialized is not None:
            return iter(self._materialized)
        executor = StreamingExecutor(build_stages(self._logical))
        self._last_executor = executor
        return executor.execute()

    def materialize(self) -> "Dataset":
        """Execute now; the result caches block refs (reference:
        Dataset.materialize -> MaterializedDataset)."""
        refs = list(self._block_refs())
        ds = Dataset(L.LogicalPlan(L.FromBlocks(blocks=refs)))
        ds._materialized = refs
        ds._last_executor = getattr(self, "_last_executor", None)
        return ds

    def iter_internal_refs(self) -> Iterator[Any]:
        return self._block_refs()

    def iter_rows(self) -> Iterator[Any]:
        import ray_tpu_torch

        for ref in self._block_refs():
            yield from BlockAccessor.for_block(ray_tpu_torch.get(ref)).iter_rows()

    def iter_batches(
        self,
        *,
        batch_size: Optional[int] = 256,
        batch_format: str = "numpy",
        prefetch_batches: Optional[int] = None,
        drop_last: bool = False,
        device_put: Any = None,
    ) -> Iterator[Any]:
        """Stream batches; with ``device_put`` (a ``torch.device`` or a
        string) numeric columns become tensors staged on that device
        ahead of consumption (iterator.py)."""
        from .iterator import iter_batches as _iter

        return _iter(
            self._block_refs(),
            batch_size=batch_size,
            batch_format=batch_format,
            prefetch_batches=(
                prefetch_batches
                if prefetch_batches is not None
                else DataContext.get_current().prefetch_batches
            ),
            drop_last=drop_last,
            device_put=device_put,
        )

    def iter_torch_batches(self, *, device_put: Any = "cpu", **kwargs) -> Iterator[Any]:
        """Batches of tensors: the tensors that ``iter_batches`` staged on
        ``device_put`` (the CPU unless asked), handed out as they are."""
        yield from self.iter_batches(batch_format="numpy", device_put=device_put, **kwargs)

    def take(self, n: int = 20) -> List[Any]:
        out = []
        for row in self.iter_rows():
            out.append(row)
            if len(out) >= n:
                break
        return out

    def take_all(self) -> List[Any]:
        return list(self.iter_rows())

    def take_batch(self, n: int = 20, batch_format: str = "numpy") -> Any:
        import ray_tpu_torch

        blocks, have = [], 0
        for ref in self._block_refs():
            b = ray_tpu_torch.get(ref)
            blocks.append(b)
            have += BlockAccessor.for_block(b).num_rows()
            if have >= n:
                break
        merged = BlockAccessor.concat(blocks)
        acc = BlockAccessor.for_block(merged)
        return BlockAccessor.for_block(acc.slice(0, min(n, acc.num_rows()))).to_batch(batch_format)

    def count(self) -> int:
        import ray_tpu_torch

        count_remote = ray_tpu_torch.remote(
            lambda b: BlockAccessor.for_block(b).num_rows()
        )
        refs = [count_remote.remote(r) for r in self._block_refs()]
        return int(sum(ray_tpu_torch.get(refs)))

    def schema(self) -> Optional[Dict[str, str]]:
        import ray_tpu_torch

        for ref in self._block_refs():
            s = BlockAccessor.for_block(ray_tpu_torch.get(ref)).schema()
            if s:
                return s
        return None

    def columns(self) -> Optional[List[str]]:
        s = self.schema()
        return list(s.keys()) if s else None

    def num_blocks(self) -> int:
        return sum(1 for _ in self._block_refs())

    def size_bytes(self) -> int:
        import ray_tpu_torch

        return sum(
            BlockAccessor.for_block(ray_tpu_torch.get(r)).size_bytes()
            for r in self._block_refs()
        )

    def to_pandas(self):
        import ray_tpu_torch

        blocks = [ray_tpu_torch.get(r) for r in self._block_refs()]
        merged = BlockAccessor.concat(blocks)
        return BlockAccessor.for_block(merged).to_pandas()

    def to_numpy_refs(self) -> List[Any]:
        return list(self._block_refs())

    # ------------------------------------------------------------ splits
    def split(self, n: int, *, equal: bool = False) -> List["Dataset"]:
        """Materializing split into n datasets (reference: Dataset.split)."""
        import ray_tpu_torch

        refs = list(self._block_refs())
        rows = [
            (r, BlockAccessor.for_block(ray_tpu_torch.get(r)).num_rows()) for r in refs
        ]
        total = sum(c for _, c in rows)
        per = total // n
        out: List[Dataset] = []
        carry: List[Tuple[Any, int]] = list(rows)
        # simple greedy contiguous partition by row count
        targets = [per + (1 if i < total % n else 0) for i in builtins.range(n)]
        if equal:
            targets = [per] * n
        idx = 0
        for t in targets:
            blocks: List[Any] = []
            need = t
            while need > 0 and idx < len(carry):
                ref, cnt = carry[idx]
                if cnt <= need:
                    blocks.append(ref)
                    need -= cnt
                    idx += 1
                else:
                    b = ray_tpu_torch.get(ref)
                    acc = BlockAccessor.for_block(b)
                    blocks.append(ray_tpu_torch.put(acc.slice(0, need)))
                    carry[idx] = (ray_tpu_torch.put(acc.slice(need, cnt)), cnt - need)
                    need = 0
            ds = Dataset(L.LogicalPlan(L.FromBlocks(blocks=blocks)))
            ds._materialized = blocks
            out.append(ds)
        return out

    def streaming_split(self, n: int, *, equal: bool = False, locality_hints=None) -> List["Dataset"]:
        """N coordinated consumers over ONE streaming execution
        (reference: Dataset.streaming_split -> StreamSplitDataIterator
        + its coordinator actor): blocks are claimed pull-based, so a
        slow consumer takes fewer blocks and the dataset still drains
        exactly once per epoch. After all consumers exhaust an epoch,
        the next pull re-runs the plan (per-epoch re-execution, like
        the reference's barrier + restarted executor).

        equal=True needs exact splits, which dynamic claiming cannot
        promise — it materializes and splits statically instead.
        locality_hints are accepted for API parity; the single-hub
        runtime has no per-node block placement to exploit yet.
        """
        if n <= 0:
            raise ValueError("n must be positive")
        if equal:
            return self.split(n, equal=True)
        import ray_tpu_torch

        coord = _SplitCoordinator.remote(
            Dataset(self._logical), n
        )
        return [_StreamSplit(coord, cid, n) for cid in builtins.range(n)]

    def train_test_split(self, test_size: float, *, shuffle: bool = False, seed=None):
        ds = self.random_shuffle(seed=seed) if shuffle else self
        mat = ds.materialize()  # execute ONCE; count + slice from the cache
        rows = mat.take_all()
        total = len(rows)
        n_test = int(total * test_size) if isinstance(test_size, float) else test_size
        train, test = rows[: total - n_test], rows[total - n_test :]
        return from_items(train), from_items(test)

    # ------------------------------------------------------------ write
    def write_tfrecords(self, path: str) -> None:
        """One TFRecord shard per block; rows encode as tf.train.Example
        (reference: Dataset.write_tfrecords)."""
        import os

        import ray_tpu_torch

        from ._internal import tfrecords as tfr

        os.makedirs(path, exist_ok=True)
        for i, ref in enumerate(self._block_refs()):
            rows = BlockAccessor.for_block(ray_tpu_torch.get(ref)).iter_rows()
            tfr.write_records(
                f"{path}/part-{i:05d}.tfrecords",
                (tfr.encode_example(r) for r in rows),
            )

    def write_parquet(self, path: str) -> None:
        import pyarrow.parquet as pq
        import os

        os.makedirs(path, exist_ok=True)
        import ray_tpu_torch

        for i, ref in enumerate(self._block_refs()):
            table = BlockAccessor.for_block(ray_tpu_torch.get(ref)).to_arrow()
            pq.write_table(table, f"{path}/part-{i:05d}.parquet")

    def write_csv(self, path: str) -> None:
        import os

        os.makedirs(path, exist_ok=True)
        import ray_tpu_torch

        for i, ref in enumerate(self._block_refs()):
            df = BlockAccessor.for_block(ray_tpu_torch.get(ref)).to_pandas()
            df.to_csv(f"{path}/part-{i:05d}.csv", index=False)

    def write_json(self, path: str) -> None:
        import json
        import os

        os.makedirs(path, exist_ok=True)
        import ray_tpu_torch

        for i, ref in enumerate(self._block_refs()):
            rows = list(BlockAccessor.for_block(ray_tpu_torch.get(ref)).iter_rows())
            with open(f"{path}/part-{i:05d}.json", "w") as f:
                for r in rows:
                    f.write(json.dumps({k: _json_safe(v) for k, v in r.items()}) + "\n")

    # ------------------------------------------------------------ misc
    def stats(self) -> str:
        """Per-operator execution report (reference: Dataset.stats() /
        data/_internal/stats.py). Wall times are self-times: each
        stage's cumulative pull time minus its upstream's."""
        ops = [op.name for op in self._logical.ops()]
        header = f"Dataset(plan={' -> '.join(ops)})"
        executor = getattr(self, "_last_executor", None)
        stage_stats = getattr(executor, "stage_stats", None) if executor else None
        if not stage_stats:
            return header + "\n  (not executed yet - run materialize() or iterate)"
        lines = [header]
        prev = 0.0
        for s in stage_stats:
            self_time = max(0.0, s["wall_s"] - prev)
            prev = s["wall_s"]
            lines.append(
                f"  {s['name']}: {self_time * 1e3:.1f}ms self, "
                f"{s['blocks']} blocks"
            )
        lines.append(f"  total: {prev * 1e3:.1f}ms")
        return "\n".join(lines)

    def __repr__(self):
        ops = [op.name for op in self._logical.ops()]
        return f"Dataset(plan={' -> '.join(ops)})"

    def _repr_html_(self):
        # Jupyter card (reference: python/ray/widgets dataset repr).
        # Plan-only — no execution triggered by displaying a dataset.
        from ray_tpu_torch import widgets

        ops = [op.name for op in self._logical.ops()]
        return widgets.dataset_html(
            "ray_tpu_torch.data.Dataset", None, [], {"plan": " -> ".join(ops)}
        )


def _json_safe(v):
    if isinstance(v, np.generic):
        return v.item()
    if isinstance(v, np.ndarray):
        return v.tolist()
    return v


def _map_opts(opts: dict) -> dict:
    resources = {}
    if opts.get("num_tpus"):
        resources["TPU"] = float(opts["num_tpus"])
    if opts.get("num_cpus"):
        resources["CPU"] = float(opts["num_cpus"])
    out = {"resources": resources}
    if opts.get("compute"):
        out["compute"] = opts["compute"]
    if opts.get("concurrency") is not None:
        out["concurrency"] = opts["concurrency"]
    return out


class GroupedData:
    """Parity: ray.data.grouped_data.GroupedData."""

    def __init__(self, ds: Dataset, key: str):
        self._ds = ds
        self._key = key

    def aggregate(self, *aggs: AggregateFn) -> Dataset:
        return self._ds._append(L.Aggregate(key=self._key, aggs=list(aggs)))

    def count(self) -> Dataset:
        return self.aggregate(Count())

    def sum(self, on: str) -> Dataset:
        return self.aggregate(Sum(on))

    def min(self, on: str) -> Dataset:
        return self.aggregate(Min(on))

    def max(self, on: str) -> Dataset:
        return self.aggregate(Max(on))

    def mean(self, on: str) -> Dataset:
        return self.aggregate(Mean(on))

    def std(self, on: str) -> Dataset:
        return self.aggregate(Std(on))

    def map_groups(self, fn: Callable, *, batch_format: str = "numpy") -> Dataset:
        key = self._key

        def apply(batch):
            acc = BlockAccessor.for_block(BlockAccessor.batch_to_block(batch))
            block = acc.block
            if not isinstance(block, dict):
                raise ValueError("map_groups requires columnar data")
            uniq, inverse = np.unique(block[key], return_inverse=True)
            outs = []
            for g in builtins.range(len(uniq)):
                idx = np.nonzero(inverse == g)[0]
                sub = BlockAccessor.for_block(acc.take(idx)).to_batch(batch_format)
                outs.append(BlockAccessor.batch_to_block(fn(sub)))
            return BlockAccessor.concat(outs)

        # group rows together first via sort, then map whole blocks
        return self._ds.sort(key).map_batches(apply, batch_size=None)


# ---------------------------------------------------------------- read API


def _plan(op: L.LogicalOp) -> Dataset:
    return Dataset(L.LogicalPlan(op))


def range(n: int, *, parallelism: int = -1, override_num_blocks: Optional[int] = None) -> Dataset:
    from .datasource import RangeDatasource

    return read_datasource(
        RangeDatasource(n), parallelism=override_num_blocks or parallelism
    )


def read_datasource(datasource, *, parallelism: int = -1, **_kw) -> Dataset:
    if parallelism is None or parallelism <= 0:
        parallelism = DataContext.get_current().read_op_min_num_blocks
    return _plan(L.Read(datasource=datasource, parallelism=parallelism))


def from_items(items: List[Any], *, parallelism: int = -1) -> Dataset:
    from .datasource import ItemsDatasource

    return read_datasource(ItemsDatasource(items), parallelism=parallelism)


def from_numpy(arr, column: str = "data") -> Dataset:
    from .datasource import NumpyDatasource

    arrays = arr if isinstance(arr, list) else [arr]
    return read_datasource(NumpyDatasource(arrays, column), parallelism=len(arrays))


def from_pandas(dfs) -> Dataset:
    dfs = dfs if isinstance(dfs, list) else [dfs]
    import ray_tpu_torch

    refs = [
        ray_tpu_torch.put({c: df[c].to_numpy() for c in df.columns}) for df in dfs
    ]
    return _plan(L.FromBlocks(blocks=refs))


def from_arrow(tables) -> Dataset:
    tables = tables if isinstance(tables, list) else [tables]
    import ray_tpu_torch

    refs = [ray_tpu_torch.put(BlockAccessor.batch_to_block(t)) for t in tables]
    return _plan(L.FromBlocks(blocks=refs))


def read_parquet(paths, *, columns=None, parallelism: int = -1, **_kw) -> Dataset:
    from .datasource import ParquetDatasource

    return read_datasource(ParquetDatasource(paths, columns), parallelism=parallelism)


def read_csv(paths, *, parallelism: int = -1, **_kw) -> Dataset:
    from .datasource import CSVDatasource

    return read_datasource(CSVDatasource(paths), parallelism=parallelism)


def read_json(paths, *, parallelism: int = -1, **_kw) -> Dataset:
    from .datasource import JSONDatasource

    return read_datasource(JSONDatasource(paths), parallelism=parallelism)


def read_text(paths, *, parallelism: int = -1, **_kw) -> Dataset:
    from .datasource import TextDatasource

    return read_datasource(TextDatasource(paths), parallelism=parallelism)


def read_binary_files(paths, *, parallelism: int = -1, **_kw) -> Dataset:
    from .datasource import BinaryDatasource

    return read_datasource(BinaryDatasource(paths), parallelism=parallelism)


def read_tfrecords(paths, *, parallelism: int = -1,
                   verify_crc: bool = False, raw: bool = False,
                   **_kw) -> Dataset:
    """TFRecord files -> one row per record (reference:
    data/_internal/datasource/tfrecords_datasource.py). Records parse
    as tf.train.Example protos into one column per feature (native
    varint+CRC framing and proto codec — no TensorFlow dependency);
    raw=True skips proto decoding and yields {"data": bytes}."""
    from ._internal import tfrecords as tfr
    from .datasource import FileBasedDatasource

    class TFRecordDatasource(FileBasedDatasource):
        def _read_file(self, path: str) -> Block:
            rows = []
            for rec in tfr.read_records(path, verify_crc=verify_crc):
                if raw:
                    rows.append({"data": rec})
                else:
                    rows.append(tfr.decode_example(rec))
            return rows

    return read_datasource(TFRecordDatasource(paths), parallelism=parallelism)


def read_numpy(paths, *, parallelism: int = -1, **_kw) -> Dataset:
    from .datasource import FileBasedDatasource

    class NpyDatasource(FileBasedDatasource):
        def _read_file(self, path: str) -> Block:
            return {"data": np.load(path)}

    return read_datasource(NpyDatasource(paths), parallelism=parallelism)


def read_webdataset(paths, *, parallelism: int = -1, **_kw) -> Dataset:
    """WebDataset tar shards -> one row per sample key; each extension
    becomes a column of raw bytes, with .cls/.txt/.json decoded
    (reference: data/datasource/webdataset_datasource.py; implemented
    on stdlib tarfile — one read task per shard)."""
    import json as _json
    import tarfile

    from .datasource import FileBasedDatasource

    class WebDatasetDatasource(FileBasedDatasource):
        def _read_file(self, path: str) -> Block:
            samples: Dict[str, dict] = {}
            order: List[str] = []
            with tarfile.open(path) as tf:
                for member in tf:
                    if not member.isfile():
                        continue
                    # WebDataset convention: key = path up to the FIRST
                    # dot of the BASENAME (dots in directories are part
                    # of the key, not the extension)
                    dirname, _, fname = member.name.rpartition("/")
                    stem, _, ext = fname.partition(".")
                    base = f"{dirname}/{stem}" if dirname else stem
                    raw = tf.extractfile(member).read()
                    if base not in samples:
                        samples[base] = {"__key__": base}
                        order.append(base)
                    if ext in ("cls", "index"):
                        samples[base][ext] = int(raw)
                    elif ext in ("txt", "text"):
                        samples[base][ext] = raw.decode()
                    elif ext == "json":
                        samples[base][ext] = _json.loads(raw)
                    else:
                        samples[base][ext] = raw
            return [samples[k] for k in order]

    return read_datasource(WebDatasetDatasource(paths), parallelism=parallelism)


def read_images(
    paths,
    *,
    size: Optional[Tuple[int, int]] = None,
    mode: Optional[str] = None,
    include_paths: bool = False,
    parallelism: int = -1,
    **_kw,
) -> Dataset:
    """Decode image files into an "image" column of HWC uint8 arrays
    (reference: data/datasource/image_datasource.py read_images — size/
    mode resize+convert on read so downstream batches are rectangular)."""
    from .datasource import FileBasedDatasource

    class ImageDatasource(FileBasedDatasource):
        def _read_file(self, path: str) -> Block:
            from PIL import Image

            with Image.open(path) as im:
                if mode is not None:
                    im = im.convert(mode)
                if size is not None:
                    im = im.resize((size[1], size[0]))  # PIL takes (W, H)
                arr = np.asarray(im)
            row = {"image": arr}
            if include_paths:
                row["path"] = path
            return [row]

    return read_datasource(ImageDatasource(paths), parallelism=parallelism)


# ------------------------------------------------------ streaming_split
class _SplitCoordinatorImpl:
    """Owns one streaming execution; consumers claim blocks pull-based.

    Reference: data/_internal/execution/streaming_executor's split
    coordinator actor (StreamSplitDataIterator): exactly-once block
    delivery per epoch, epoch barrier before re-execution.
    """

    def __init__(self, ds, n: int):
        self._ds = ds
        self._n = n
        self._it = None
        self._exhausted: set = set()

    def next_block(self, consumer_id: int):
        """One block ref, "__wait__" (epoch barrier), or None (epoch
        end for this consumer)."""
        if consumer_id in self._exhausted:
            # consumer is into its next epoch; wait for the stragglers,
            # then restart the plan
            if len(self._exhausted) < self._n:
                return "__wait__"
            self._it = None
            self._exhausted = set()
        if self._it is None:
            self._it = iter(self._ds.iter_internal_refs())
        try:
            return next(self._it)
        except StopIteration:
            self._exhausted.add(consumer_id)
            return None


_split_coordinator_cls = None


class _SplitCoordinator:
    """Lazy ray_tpu_torch.remote wrapper (dataset.py imports before init)."""

    @staticmethod
    def remote(ds, n: int):
        global _split_coordinator_cls
        import ray_tpu_torch

        if _split_coordinator_cls is None:
            _split_coordinator_cls = ray_tpu_torch.remote(_SplitCoordinatorImpl)
        return _split_coordinator_cls.remote(ds, n)


class _StreamSplit(Dataset):
    """One consumer's view of a coordinated streaming split.

    Consumption-only (like the reference's StreamSplitDataIterator,
    which is a DataIterator, not a Dataset): apply transforms BEFORE
    streaming_split — blocks here come from the shared coordinator, so
    a per-consumer logical plan would be silently empty.
    """

    BARRIER_TIMEOUT_S = 600.0

    def __init__(self, coord, consumer_id: int, n: int):
        super().__init__(L.LogicalPlan(L.FromBlocks(blocks=[])))
        self._coord = coord
        self._cid = consumer_id
        self._n = n

    def _append(self, op):
        raise TypeError(
            "streaming_split outputs are consume-only iterators "
            "(reference: StreamSplitDataIterator); apply transforms to "
            "the dataset BEFORE streaming_split()"
        )

    def _block_refs(self):
        import time

        import ray_tpu_torch

        waited = 0.0
        while True:
            # per-block protocol round-trip: blocks are consumed
            # strictly in order, there is nothing to batch
            out = ray_tpu_torch.get(self._coord.next_block.remote(self._cid))  # graftlint: disable=GL004
            if isinstance(out, str) and out == "__wait__":
                # epoch barrier: siblings must exhaust the epoch too
                if waited >= self.BARRIER_TIMEOUT_S:
                    raise RuntimeError(
                        f"streaming_split epoch barrier timed out: all "
                        f"{self._n} consumers must iterate every epoch"
                    )
                time.sleep(0.02)
                waited += 0.02
                continue
            waited = 0.0
            if out is None:
                return
            yield out

    def __reduce__(self):
        return (_StreamSplit, (self._coord, self._cid, self._n))
