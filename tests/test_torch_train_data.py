"""Train's dataset shards from a Dataset, on both packages.

A Dataset of 48 rows in 8 blocks goes to a two-worker trainer as
``datasets={"train": ds}``: ``ray_tpu_torch``'s ``TorchTrainer`` (gloo,
two CPU workers) and ``ray_tpu``'s ``JaxTrainer``. Each worker reads its
``get_dataset_shard("train")`` (a ``streaming_split`` of the Dataset)
over two epochs and writes the ids it saw. In each package and each
epoch the two workers' shards are disjoint, and together they hold every
row exactly once: the same rows in both packages. (Before Data was
ported, the port copied any dataset to every worker.)

Cost: one runtime per package for the whole file, four CPUs and four
pooled workers each; each trainer starts a gang of two workers. The loop
is defined inside the test, so it pickles by value.
"""

import json
import os

import pytest

import ray_tpu
import ray_tpu_torch
from ray_tpu import data as ref_data
from ray_tpu import train as ref_train
from ray_tpu_torch import data as port_data
from ray_tpu_torch import train as port_train

ROWS, BLOCKS, EPOCHS = 48, 8, 2


@pytest.fixture(scope="module")
def runtimes():
    # two train workers, the split's coordinator and the read tasks
    ray_tpu.init(num_cpus=4, max_workers=4, ignore_reinit_error=True)
    ray_tpu_torch.init(num_cpus=4, max_workers=4)
    yield
    ray_tpu_torch.shutdown()
    ray_tpu.shutdown()


def _shards(pkg_train, trainer_cls, data, out_dir, storage):
    def loop(config):
        import importlib
        import json as _json
        import os as _os

        tr = importlib.import_module(config["pkg"] + ".train")  # this package's only
        ctx = tr.get_context()
        shard = tr.get_dataset_shard("train")
        seen = [[int(r["id"]) for r in shard.iter_rows()] for _ in range(config["epochs"])]
        with open(_os.path.join(config["out"], f"rank{ctx.get_world_rank()}.json"), "w") as f:
            _json.dump({"type": type(shard).__name__, "seen": seen}, f)
        tr.report({"rows": sum(map(len, seen))})

    os.makedirs(out_dir)
    trainer = trainer_cls(
        loop,
        train_loop_config={"out": out_dir, "epochs": EPOCHS,
                           "pkg": pkg_train.__name__.split(".")[0]},
        scaling_config=pkg_train.ScalingConfig(num_workers=2),
        run_config=pkg_train.RunConfig(name="shards", storage_path=storage),
        datasets={"train": data.range(ROWS, override_num_blocks=BLOCKS)},
    )
    result = trainer.fit()
    assert result.error is None
    out = []
    for rank in (0, 1):
        with open(os.path.join(out_dir, f"rank{rank}.json")) as f:
            out.append(json.load(f))
    return out


def test_each_worker_gets_a_disjoint_split_with_the_reference_rows(runtimes, tmp_path):
    got = _shards(port_train, port_train.TorchTrainer, port_data, str(tmp_path / "port"),
                  str(tmp_path / "port_results"))
    want = _shards(ref_train, ref_train.JaxTrainer, ref_data, str(tmp_path / "ref"),
                   str(tmp_path / "ref_results"))
    for shards in (got, want):
        assert [s["type"] for s in shards] == ["_StreamSplit", "_StreamSplit"]
        for epoch in range(EPOCHS):
            a, b = (s["seen"][epoch] for s in shards)
            assert not set(a) & set(b)
            assert sorted(a + b) == list(range(ROWS))
    assert ({i for s in got for e in s["seen"] for i in e}
            == {i for s in want for e in s["seen"] for i in e})
