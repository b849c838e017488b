"""Data of the port against the reference's.

Each program runs once on ``ray_tpu.data`` and once on
``ray_tpu_torch.data``, both runtimes up at once in this process, and the
two results must be equal exactly (arrays by dtype, shape and values).
They are the programs of test_data.py and test_preprocessors.py: reads
from items, numpy, pandas and arrow, row and batch transforms (numpy and
pandas formats, batch sizes, fusion into one read stage), callable-class
UDFs on an actor pool, repartition, seeded shuffles (the rows' order
included), sorts, groupby and global aggregates, union and zip,
iteration (batch sizes, drop_last, splits, take_batch, the coordinated
streaming split over two epochs), parquet, csv, json, text, binary,
image, webdataset and tfrecords files, the push-based shuffle against
the pull path, scalar aggregates, and the preprocessors.

Staging: ``iter_batches(device_put="cpu")`` gives CPU tensors whose
values equal the reference's ``jax.devices("cpu")[0]`` arrays, with and
without prefetch; ``iter_torch_batches`` hands out those tensors; a CUDA
device without a GPU raises; an abandoned iterator keeps no staged batch
alive. The port's runtime is told of one GPU (``init(num_gpus=1)``;
nothing is detected here), so ``map_batches(..., num_gpus=1)`` is held to
pin ``CUDA_VISIBLE_DEVICES='0'`` on the task path and the actor-pool path
(ROADMAP.md Queue C: "GPU" becomes ``num_gpus``).

Cost: one runtime per package for the whole file, four CPUs and four
pooled workers each; UDFs are defined inside the programs, so they pickle
by value and no worker imports this file.
"""

import contextlib
import gc
import importlib
import io
import os
import threading
import time

import numpy as np
import pytest
import torch

import ray_tpu
import ray_tpu_torch

T = 60


@pytest.fixture(scope="module")
def runtimes():
    ray_tpu.init(num_cpus=4, max_workers=4, ignore_reinit_error=True)
    ray_tpu_torch.init(num_cpus=4, max_workers=4, num_gpus=1)
    yield
    ray_tpu_torch.shutdown()
    ray_tpu.shutdown()


def _rd(rt):
    return importlib.import_module(f"{rt.__name__}.data")


def _plain(v):
    """Exact, comparable form of a program's result."""
    if isinstance(v, np.ndarray):
        return ("ndarray", str(v.dtype), v.shape, _plain(v.tolist()))
    if isinstance(v, torch.Tensor):
        return ("ndarray", str(v.numpy().dtype), tuple(v.shape), _plain(v.tolist()))
    if isinstance(v, np.generic):
        return (type(v).__name__, v.item())
    if isinstance(v, dict):
        return {k: _plain(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return type(v)(_plain(x) for x in v)
    return v


def reads(rt, tmp_path):
    import pandas as pd
    import pyarrow as pa

    rd = _rd(rt)
    ds = rd.range(100)
    out = [ds.count(), ds.take(5), ds.schema(), ds.columns()]
    items = rd.from_items([{"x": i, "y": i * 2} for i in range(10)])
    out += [items.count(), items.take(2), items.schema()]
    out += [rd.from_numpy(np.arange(12).reshape(4, 3)).take_all()]
    out += [list(rd.from_pandas(pd.DataFrame({"a": [1, 2], "b": [3.0, 4.0]})).to_pandas()["a"])]
    out += [rd.from_arrow(pa.table({"a": [1, 2, 3]})).take_all()]
    return out


def row_transforms(rt, tmp_path):
    rd = _rd(rt)
    return [rd.range(10).map(lambda r: {"id": r["id"] * 2}).take(3),
            rd.range(20).filter(lambda r: r["id"] % 2 == 0).count(),
            sorted(r["x"] for r in rd.from_items([{"x": 1}, {"x": 2}]).flat_map(
                lambda r: [{"x": r["x"]}, {"x": -r["x"]}]).take_all()),
            rd.range(100).limit(7).count()]


def batch_transforms(rt, tmp_path):
    rd = _rd(rt)

    def record(b):
        return {"n": np.array([len(b["id"])])}

    def pandas_udf(df):
        df["y"] = df["id"] * 3
        return df

    return [rd.range(32).map_batches(lambda b: {"id": b["id"] + 1}).take(3),
            sorted(r["n"] for r in rd.range(100, override_num_blocks=1).map_batches(
                record, batch_size=30).take_all()),
            rd.range(10).map_batches(pandas_udf, batch_format="pandas").take(2)]


def fusion_chains_maps(rt, tmp_path):
    rd = _rd(rt)
    build_stages = importlib.import_module(f"{rt.__name__}.data._internal.executor").build_stages
    ds = rd.range(10).map(lambda r: r).filter(lambda r: True).map_batches(lambda b: b)
    return [(s.kind, s.name) for s in build_stages(ds._logical)]


def columns(rt, tmp_path):
    rd = _rd(rt)
    ds = rd.range(5).add_column("sq", lambda b: b["id"] ** 2)
    return ds.take(3), ds.drop_columns(["sq"]).columns(), ds.select_columns(["sq"]).columns()


def actor_pool_class_udf(rt, tmp_path):
    rd = _rd(rt)

    class AddConst:
        def __init__(self, c):
            self.c = c

        def __call__(self, batch):
            return {"id": batch["id"] + self.c}

    ds = rd.range(16).map_batches(AddConst, fn_constructor_args=(100,),
                                  compute=rd.ActorPoolStrategy(size=2))
    return sorted(r["id"] for r in ds.take_all())


def shuffles_and_sorts(rt, tmp_path):
    rd = _rd(rt)
    rep = rd.range(20).repartition(4).materialize()
    return [rep.num_blocks(), rep.count(),
            [r["id"] for r in rd.range(50).random_shuffle(seed=42).take_all()],
            [r["v"] for r in rd.from_items([{"v": x} for x in [5, 3, 9, 1, 7, 2, 8]])
             .sort("v").take_all()],
            [r["v"] for r in rd.from_items([{"v": x} for x in [5, 3, 9]])
             .sort("v", descending=True).take_all()]]


def aggregates(rt, tmp_path):
    rd = _rd(rt)
    items = [{"k": i % 3, "v": float(i)} for i in range(12)]
    grouped = sorted(rd.from_items(items).groupby("k").sum("v").take_all(),
                     key=lambda r: r["k"])
    counts = sorted(rd.from_items(items).groupby("k").count().take_all(), key=lambda r: r["k"])
    glob = rd.range(10).aggregate(rd.Sum("id"), rd.Max("id"), rd.Mean("id"), rd.Min("id"),
                                  rd.Std("id"), rd.Count())
    ds = rd.from_items([{"v": float(x)} for x in [3, 1, 4, 1, 5]])
    shown = io.StringIO()
    with contextlib.redirect_stdout(shown):
        ds.show(limit=2)
    empty = rd.from_items([])
    return [grouped, counts, glob, ds.sum("v"), ds.min("v"), ds.max("v"), ds.mean("v"),
            ds.unique("v"), shown.getvalue(), empty.sum("v"), empty.mean("v")]


def union_zip(rt, tmp_path):
    rd = _rd(rt)
    a = rd.from_items([{"x": 1}, {"x": 2}])
    b = rd.from_items([{"x": 3}])
    return [a.union(b).count(), rd.from_items([{"l": 1}]).zip(rd.from_items([{"r": 2}])).take_all()]


def iteration(rt, tmp_path):
    rd = _rd(rt)
    return [[len(b["id"]) for b in rd.range(25).iter_batches(batch_size=10)],
            [len(b["id"]) for b in rd.range(25).iter_batches(batch_size=10, drop_last=True)],
            [b["id"] for b in rd.range(7).iter_batches(batch_size=3, prefetch_batches=0)],
            [p.count() for p in rd.range(10).split(2)],
            rd.range(100).take_batch(5)]


def streaming_split_two_epochs(rt, tmp_path):
    rd = _rd(rt)
    splits = rd.range(80).map_batches(lambda b: b, batch_size=8).streaming_split(2)
    epochs = []
    for delay in (0.01, 0.0):
        got = {0: [], 1: []}

        def consume(i):
            for row in splits[i].iter_rows():
                got[i].append(int(row["id"]))
                time.sleep(delay * i)

        ts = [threading.Thread(target=consume, args=(i,)) for i in (0, 1)]
        [t.start() for t in ts]
        [t.join(T) for t in ts]
        epochs.append((sorted(got[0] + got[1]), not set(got[0]) & set(got[1])))
    return epochs


def files(rt, tmp_path):
    rd = _rd(rt)
    base = tmp_path / rt.__name__
    rd.range(30).write_parquet(str(base / "pq"))
    rd.from_items([{"a": i, "b": i * 1.5} for i in range(10)]).write_csv(str(base / "csv"))
    rd.from_items([{"a": i} for i in range(5)]).write_json(str(base / "js"))
    (base / "t.txt").write_text("alpha\nbeta\ngamma\n")
    (base / "b.bin").write_bytes(b"\x00\x01")
    return [sorted(r["id"] for r in rd.read_parquet(str(base / "pq")).take_all()),
            sorted(rd.read_csv(str(base / "csv")).take_all(), key=lambda r: r["a"]),
            sorted(r["a"] for r in rd.read_json(str(base / "js")).take_all()),
            [r["text"] for r in rd.read_text(str(base / "t.txt")).take_all()],
            rd.read_binary_files(str(base / "b.bin")).take_all()[0]["bytes"]]


def images(rt, tmp_path):
    from PIL import Image

    rd = _rd(rt)
    base = tmp_path / rt.__name__ / "img"
    base.mkdir(parents=True)
    for i in range(3):
        Image.fromarray(np.full((10 + i, 12, 3), i * 40, np.uint8)).save(base / f"img{i}.png")
    rows = sorted(rd.read_images(str(base), size=(8, 8), mode="RGB", include_paths=True)
                  .iter_rows(), key=lambda r: r["path"])
    return [(r["image"], os.path.basename(r["path"])) for r in rows]


def webdataset(rt, tmp_path):
    import json
    import tarfile

    rd = _rd(rt)
    shard = tmp_path / f"{rt.__name__}-shard-000.tar"
    with tarfile.open(shard, "w") as tf:
        for i in range(3):
            for ext, payload in (("img", bytes([i] * 4)), ("cls", str(i * 10).encode()),
                                 ("json", json.dumps({"i": i}).encode())):
                info = tarfile.TarInfo(f"sample{i}.{ext}")
                info.size = len(payload)
                tf.addfile(info, io.BytesIO(payload))
    return sorted(rd.read_webdataset(str(shard)).take_all(), key=lambda r: r["__key__"])


def tfrecords(rt, tmp_path):
    import glob

    rd = _rd(rt)
    rows = [{"name": b"alpha", "score": 1.5, "count": 3, "tags": [1, 2, 3]},
            {"name": b"beta", "score": -2.25, "count": -7, "tags": [9]}]
    out = str(tmp_path / rt.__name__ / "tfr")
    rd.from_items(rows).write_tfrecords(out)
    back = sorted(rd.read_tfrecords(out, verify_crc=True).take_all(), key=lambda r: r["name"])
    raw = [type(r["data"]).__name__ for r in rd.read_tfrecords(out, raw=True).take_all()]
    shard = glob.glob(out + "/*.tfrecords")[0]
    blob = bytearray(open(shard, "rb").read())
    blob[4] ^= 0xFF  # flip a length byte
    open(shard, "wb").write(bytes(blob))
    with pytest.raises(Exception, match="crc|truncated"):
        rd.read_tfrecords(out).take_all()
    return back, raw


def push_and_pull_shuffles_agree(rt, tmp_path):
    rd = _rd(rt)
    ctx = rd.DataContext.get_current()
    orig = ctx.use_push_based_shuffle
    out = []
    try:
        for flag in (True, False):
            ctx.use_push_based_shuffle = flag
            out.append([int(r["id"]) for r in rd.range(200, override_num_blocks=9)
                        .random_shuffle(seed=4).iter_rows()])
            out.append(sorted(int(r["id"]) for r in rd.range(200, override_num_blocks=9)
                              .repartition(3).iter_rows()))
            out.append([int(r["id"]) for r in rd.range(200, override_num_blocks=9)
                        .sort("id").iter_rows()])
    finally:
        ctx.use_push_based_shuffle = orig
    return out


def partial_merge_rounds(rt, tmp_path):
    StreamingExecutor = importlib.import_module(
        f"{rt.__name__}.data._internal.executor").StreamingExecutor
    ex = StreamingExecutor([])
    refs = [rt.put({"id": np.arange(4) + 4 * i}) for i in range(16)]
    k, calls = 4, []

    def submit(ref):
        calls.append(ref)
        split = rt.remote(lambda b, kk=k: [{key: v[i::kk] for key, v in b.items()}
                                           for i in range(kk)]).options(num_returns=k)
        return split.remote(ref)

    parts = ex._exchange_parts(refs, submit, k)
    merged = sorted(int(x) for p in parts for r in p for x in rt.get(r, timeout=T)["id"])
    return len(calls), [len(p) for p in parts], merged


def preprocessors(rt, tmp_path):
    rd = _rd(rt)
    pp = importlib.import_module(f"{rt.__name__}.data.preprocessors")
    ds = rd.from_items([{"x": float(i), "y": float(2 * i)} for i in range(10)])
    scaler = pp.StandardScaler(["x", "y"])
    out = [[b["x"] for b in scaler.fit_transform(ds).iter_batches()],
           scaler.transform_batch({"x": np.asarray([4.5]), "y": np.asarray([9.0])})]
    out.append(sorted(float(r["x"]) for r in pp.MinMaxScaler(["x"]).fit_transform(
        rd.from_items([{"x": float(i)} for i in range(5)])).iter_rows()))
    cats = rd.from_items([{"c": v} for v in ["a", "b", "a", "c"]])
    out.append(list(pp.OneHotEncoder(["c"]).fit(cats).transform(cats).iter_rows()))
    labels = rd.from_items([{"label": v} for v in ["dog", "cat", "dog", "fish"]])
    enc = pp.LabelEncoder("label").fit(labels)
    out.append([int(r["label"]) for r in enc.transform(labels).iter_rows()])
    with pytest.raises(ValueError, match="unseen"):
        enc.transform_batch({"label": np.asarray(["wolf"])})
    out.append(sorted(float(r["x"]) for r in pp.SimpleImputer(["x"], strategy="mean")
                      .fit_transform(rd.from_items([{"x": 1.0}, {"x": float("nan")},
                                                    {"x": 3.0}])).iter_rows()))
    ab = rd.from_items([{"a": float(i), "b": float(i * 10)} for i in range(8)])
    out.append([b["concat_out"] for b in pp.Chain(pp.StandardScaler(["a", "b"]),
                                                  pp.Concatenator(["a", "b"]))
                .fit_transform(ab).iter_batches()])
    with pytest.raises(RuntimeError, match="must be fit"):
        pp.StandardScaler(["x"]).transform_batch({"x": np.asarray([1.0])})
    return out


PROGRAMS = [reads, row_transforms, batch_transforms, fusion_chains_maps, columns,
            actor_pool_class_udf, shuffles_and_sorts, aggregates, union_zip, iteration,
            streaming_split_two_epochs, files, images, webdataset, tfrecords,
            push_and_pull_shuffles_agree, partial_merge_rounds, preprocessors]


@pytest.mark.parametrize("program", PROGRAMS, ids=lambda p: p.__name__)
def test_same_program_same_result(runtimes, tmp_path, program):
    ref = program(ray_tpu, tmp_path)
    got = program(ray_tpu_torch, tmp_path)
    assert _plain(got) == _plain(ref)


@pytest.mark.parametrize("prefetch", [0, 2])
def test_cpu_staging_matches_the_reference_device_put(runtimes, prefetch):
    import jax

    cols = {"f": np.arange(24, dtype=np.float32).reshape(12, 2) / 7,
            "i": np.arange(12, dtype=np.int32), "s": np.array([f"r{i}" for i in range(12)])}
    kw = dict(batch_size=5, prefetch_batches=prefetch)
    # the reference's jax.device_put refuses a string column; the port
    # stages the numeric columns and hands the others on as numpy
    want = list(_rd(ray_tpu).from_items([{k: cols[k][i] for k in "fi"} for i in range(12)])
                .iter_batches(device_put=jax.devices("cpu")[0], **kw))
    ds = _rd(ray_tpu_torch).from_items([{k: v[i] for k, v in cols.items()} for i in range(12)])
    got = list(ds.iter_batches(device_put="cpu", **kw))
    assert [len(b["i"]) for b in got] == [5, 5, 2]
    for g, w in zip(got, want):
        assert isinstance(g["f"], torch.Tensor) and g["f"].device.type == "cpu"
        assert isinstance(w["f"], jax.Array)
        assert _plain({k: g[k] for k in "fi"}) == _plain({k: np.asarray(w[k]) for k in "fi"})
    assert [b["s"].tolist() for b in got] == [cols["s"][:5].tolist(), cols["s"][5:10].tolist(),
                                              cols["s"][10:].tolist()]
    torch_batches = list(ds.iter_torch_batches(batch_size=5, prefetch_batches=prefetch))
    assert all(type(b["i"]) is torch.Tensor for b in torch_batches)
    assert [b["i"].tolist() for b in torch_batches] == [b["i"].tolist() for b in got]
    # the tensors are copies the consumer owns, not views of a read-only block
    assert all(b["f"].numpy().flags.writeable for b in got)


def test_cuda_staging_without_a_gpu_raises(runtimes):
    ds = _rd(ray_tpu_torch).range(8)
    for kw in ({"prefetch_batches": 0}, {"prefetch_batches": 2}):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            next(iter(ds.iter_batches(batch_size=4, device_put="cuda", **kw)))
        with pytest.raises(RuntimeError, match="no CUDA device"):
            next(iter(ds.iter_torch_batches(batch_size=4, device_put="cuda", **kw)))


def _staged_tensors(width):
    return [o for o in gc.get_objects()
            if type(o) is torch.Tensor and o.dim() == 2 and o.shape[1] == width]


def test_an_abandoned_iterator_keeps_no_staged_batch(runtimes):
    width = 37  # a shape nothing else in the process has
    ds = _rd(ray_tpu_torch).from_numpy(np.ones((64, width), np.float32)).materialize()
    it = ds.iter_batches(batch_size=4, device_put="cpu", prefetch_batches=4)
    first = next(it)["data"]
    deadline = time.time() + T
    while len(_staged_tensors(width)) < 3 and time.time() < deadline:
        time.sleep(0.05)  # the prefetch thread fills its queue
    assert len(_staged_tensors(width)) >= 3
    it.close()
    # the queue is dropped at once: at most what the thread holds in hand
    assert len([t for t in _staged_tensors(width) if t is not first]) <= 2
    while (any(t.name == "data-prefetch" for t in threading.enumerate())
           and time.time() < deadline):
        time.sleep(0.05)
    gc.collect()
    assert [t for t in _staged_tensors(width) if t is not first] == []


def test_num_gpus_pins_a_gpu_on_the_task_and_actor_paths(runtimes):
    rd = _rd(ray_tpu_torch)

    def visible(b):
        import os as _os

        return {"id": b["id"], "gpu": np.array([_os.environ.get("CUDA_VISIBLE_DEVICES")] *
                                               len(b["id"]))}

    class Visible:
        def __call__(self, b):
            import os as _os

            return {"id": b["id"], "gpu": np.array([_os.environ.get("CUDA_VISIBLE_DEVICES")] *
                                                   len(b["id"]))}

    tasks = rd.range(8, override_num_blocks=2).map_batches(visible, num_gpus=1).take_all()
    pool = rd.range(8, override_num_blocks=2).map_batches(
        Visible, batch_size=4, concurrency=1, num_gpus=1).take_all()
    cpu_only = rd.range(4).map_batches(visible).take_all()
    assert sorted(r["id"] for r in tasks) == sorted(r["id"] for r in pool) == list(range(8))
    assert {r["gpu"] for r in tasks} == {r["gpu"] for r in pool} == {"0"}
    assert {r["gpu"] for r in cpu_only} == {""}


def test_importing_data_records_its_use_and_imports_no_jax():
    import subprocess
    import sys

    code = ("import sys, ray_tpu_torch.data, ray_tpu_torch.workflow, ray_tpu_torch.dag; "
            "print(sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'ray_tpu')))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=T, cwd=os.path.dirname(os.path.dirname(__file__)))
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
