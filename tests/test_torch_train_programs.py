"""The reference's Train programs (tests/test_train.py) on the port, and
GPUs pinned to train workers without a card.

Each program of tests/test_train.py runs on ``ray_tpu_torch.train`` with
the same assertions: report, context ranks, checkpoint round trip, top-k
retention, a failure restart that resumes from the checkpoint, failures
exhausted, a dataset shard passed through, an elastic resize, and DDP
over gloo with two workers (``TorchTrainer``). The JAX mesh program has
no counterpart (no JAX here); test_torch_train.py holds ``TorchTrainer``
against ``JaxTrainer`` instead.

The runtime is told of one GPU with ``RAY_TPU_TORCH_NUM_GPUS=1`` (nothing
is detected here): a ``use_gpu`` worker is pinned ``CUDA_VISIBLE_DEVICES=
'0'``, a two-GPU gang is refused within its placement timeout, a worker
restarted after a failure is pinned the same card again, and
``TorchConfig()`` picks nccl for GPU workers and gloo otherwise (read
from the scaling config, so nccl is never started). A ``use_gpu``
``TorchTrainer`` fails here rather than running on the CPU.

Cost: one runtime for the whole file, four CPUs and four pooled workers;
remote code names no helper of this module, so no worker imports it.
"""

import os
import time

import pytest

import ray_tpu_torch
from ray_tpu_torch import train
from ray_tpu_torch.train import (
    Checkpoint,
    CheckpointConfig,
    DataParallelTrainer,
    FailureConfig,
    RunConfig,
    ScalingConfig,
    TorchConfig,
    TorchTrainer,
)
from ray_tpu_torch.train._internal.worker_group import GangUnschedulableError, WorkerGroup
from ray_tpu_torch.train.torch_trainer import _TorchBackend


@pytest.fixture(scope="module")
def rt():
    os.environ["RAY_TPU_TORCH_NUM_GPUS"] = "1"
    try:
        ray_tpu_torch.init(num_cpus=4, max_workers=4)
    finally:
        del os.environ["RAY_TPU_TORCH_NUM_GPUS"]
    assert ray_tpu_torch.cluster_resources()["GPU"] == 1.0
    yield ray_tpu_torch
    ray_tpu_torch.shutdown()


@pytest.fixture
def storage(tmp_path):
    return str(tmp_path / "results")


class _Collect:
    def __init__(self):
        self.rows = []

    def on_result(self, metrics):
        self.rows.append(dict(metrics))


def _report_loop():
    def loop(config):
        import sys

        # the train worker imports neither JAX, ray_tpu nor a test module
        foreign = sorted(m for m in sys.modules
                         if m.split(".")[0] in ("jax", "ray_tpu") or m.startswith("test_"))
        for i in range(3):
            train.report({"loss": 1.0 / (i + 1), "step": i, "foreign": foreign})

    return loop


def _ranks_loop():
    def loop(config):
        ctx = train.get_context()
        train.report({"rank": ctx.get_world_rank(), "world": ctx.get_world_size()})

    return loop


@pytest.mark.parametrize("program,workers,want", [
    ("report", 1, {"step": 2, "training_iteration": 3, "foreign": []}),
    ("context_ranks", 2, {"world": 2, "rank": 0}),  # rank-0 metrics surface
])
def test_reference_report_programs(rt, storage, program, workers, want):
    loop = {"report": _report_loop, "context_ranks": _ranks_loop}[program]()
    result = DataParallelTrainer(
        loop,
        scaling_config=ScalingConfig(num_workers=workers),
        run_config=RunConfig(name=program, storage_path=storage),
    ).fit()
    assert result.error is None
    assert {k: result.metrics[k] for k in want} == want


def test_reference_checkpoint_roundtrip(rt, storage):
    def loop(config):
        ckpt = Checkpoint.from_state({"weights": [1.0, 2.0], "step": 7})
        train.report({"loss": 0.5}, checkpoint=ckpt)

    result = DataParallelTrainer(
        loop,
        scaling_config=ScalingConfig(num_workers=1),
        run_config=RunConfig(name="t3", storage_path=storage),
    ).fit()
    assert result.error is None
    assert result.checkpoint is not None
    assert result.checkpoint.to_state()["step"] == 7


def test_reference_top_k_retention(rt, storage):
    def loop(config):
        for i in range(5):
            ckpt = Checkpoint.from_state({"i": i})
            train.report({"score": float(i % 3)}, checkpoint=ckpt)

    result = DataParallelTrainer(
        loop,
        scaling_config=ScalingConfig(num_workers=1),
        run_config=RunConfig(
            name="t4", storage_path=storage,
            checkpoint_config=CheckpointConfig(num_to_keep=2, checkpoint_score_attribute="score"),
        ),
    ).fit()
    assert result.error is None
    kept = sorted(os.listdir(os.path.join(storage, "t4")))
    assert len(kept) == 2
    assert "checkpoint_000004" in kept  # the latest survives even if low-scoring


def _failing_loop():
    def loop(config):
        import os

        start = 0
        ckpt = train.get_checkpoint()
        if ckpt is not None:
            start = ckpt.to_state()["step"] + 1
        for i in range(start, 4):
            if i == 2 and not os.path.exists(config["marker"]):
                open(config["marker"], "w").close()
                raise RuntimeError("boom at step 2")
            train.report(
                {"step": i, "resumed_from": start, "pid": os.getpid(),
                 "cuda_visible_devices": os.environ.get("CUDA_VISIBLE_DEVICES")},
                checkpoint=Checkpoint.from_state({"step": i}),
            )

    return loop


@pytest.mark.parametrize("use_gpu", [False, True])
def test_reference_failure_restart_resumes_from_checkpoint(rt, storage, use_gpu):
    """The reference's program; with ``use_gpu`` the worker holds the one
    GPU, and the restarted worker (another process) is pinned it again
    once the failed gang has given it back."""
    os.makedirs(storage, exist_ok=True)
    collect = _Collect()
    result = DataParallelTrainer(
        _failing_loop(),
        train_loop_config={"marker": os.path.join(storage, "poison")},
        scaling_config=ScalingConfig(num_workers=1, use_gpu=use_gpu),
        run_config=RunConfig(name="t5", storage_path=storage,
                             failure_config=FailureConfig(max_failures=2), callbacks=[collect]),
    ).fit()
    assert result.error is None
    assert result.metrics["step"] == 3
    assert result.metrics["resumed_from"] == 2  # resumed, not restarted
    assert result.metrics["training_iteration"] == 4
    assert [r["step"] for r in collect.rows] == [0, 1, 2, 3]
    assert collect.rows[0]["pid"] != collect.rows[2]["pid"]
    if use_gpu:
        assert {r["cuda_visible_devices"] for r in collect.rows} == {"0"}


def test_reference_failure_exhausted(rt, storage):
    def loop(config):
        raise ValueError("always broken")

    result = DataParallelTrainer(
        loop,
        scaling_config=ScalingConfig(num_workers=1),
        run_config=RunConfig(name="t6", storage_path=storage,
                             failure_config=FailureConfig(max_failures=1)),
    ).fit()
    assert result.error is not None
    assert "always broken" in str(result.error)


def test_reference_dataset_shard_passthrough(rt, storage):
    class FakeDataset:
        def __init__(self, items):
            self.items = items

        def split(self, n):
            return [FakeDataset(self.items[i::n]) for i in range(n)]

    def loop(config):
        shard = train.get_dataset_shard("train")
        train.report({"n": len(shard.items)})

    result = DataParallelTrainer(
        loop,
        scaling_config=ScalingConfig(num_workers=2),
        run_config=RunConfig(name="t8", storage_path=storage),
        datasets={"train": FakeDataset(list(range(10)))},
    ).fit()
    assert result.error is None
    assert result.metrics["n"] == 5


def test_reference_elastic_resize_on_unschedulable_gang(rt, storage):
    def loop(config):
        from ray_tpu_torch.train import session

        session.report({"world": session.get_context().get_world_size()})

    result = DataParallelTrainer(
        loop,
        # 8 x 1-CPU workers can never fit on 4 CPUs: must shrink 8 -> 4
        scaling_config=ScalingConfig(num_workers=8, resources_per_worker={"CPU": 1},
                                     min_workers=2, placement_timeout_s=2.0),
        run_config=RunConfig(name="elastic", storage_path=storage,
                             failure_config=FailureConfig(max_failures=3)),
    ).fit()
    assert result.error is None, result.error
    assert result.metrics["world"] == 4  # halved once: 8 -> 4 fits


def test_reference_torch_trainer_ddp_gloo(rt, storage):
    def loop(config):
        import torch
        import torch.distributed as dist

        from ray_tpu_torch.train.torch_trainer import prepare_model

        ctx = train.get_context()
        assert dist.is_initialized()
        assert dist.get_backend() == "gloo"
        assert dist.get_world_size() == 2
        assert dist.get_rank() == ctx.get_world_rank()
        t = torch.tensor([float(ctx.get_world_rank() + 1)])
        dist.all_reduce(t)
        assert t.item() == 3.0  # 1 + 2
        torch.manual_seed(0)
        model = prepare_model(torch.nn.Linear(4, 1))
        x = torch.full((8, 4), float(ctx.get_world_rank()))
        model(x).sum().backward()
        train.report({"grad0": float(model.module.weight.grad[0][0])})

    result = TorchTrainer(loop, scaling_config=ScalingConfig(num_workers=2),
                          run_config=RunConfig(storage_path=storage)).fit()
    assert result.error is None, result.error
    # DDP averages grads: ranks saw x=0 and x=1 -> mean grad = 8*(0+1)/2
    assert abs(result.metrics["grad0"] - 4.0) < 1e-6


def _wait_gpu_back(rt):
    deadline = time.time() + 30
    while rt.available_resources().get("GPU", 0) != 1.0 and time.time() < deadline:
        time.sleep(0.05)
    return rt.available_resources().get("GPU", 0)


def test_gpu_worker_is_pinned_and_gives_the_card_back(rt):
    wg = WorkerGroup(ScalingConfig(num_workers=1, use_gpu=True), "pin")
    wg.start()
    try:
        assert wg.workers[0].metadata["cuda_visible_devices"] == "0"
        assert rt.available_resources().get("GPU", 0) == 0.0
    finally:
        wg.shutdown()
    assert _wait_gpu_back(rt) == 1.0
    cpu = WorkerGroup(ScalingConfig(num_workers=1), "cpu")
    cpu.start()
    try:
        assert cpu.workers[0].metadata["cuda_visible_devices"] == ""
    finally:
        cpu.shutdown()


def test_two_gpu_gang_is_refused_within_its_timeout(rt, storage):
    sc = ScalingConfig(num_workers=2, use_gpu=True, placement_timeout_s=1.0)
    t0 = time.time()
    with pytest.raises(GangUnschedulableError, match="not schedulable"):
        WorkerGroup(sc, "two").start()
    assert time.time() - t0 < sc.placement_timeout_s + 10
    assert _wait_gpu_back(rt) == 1.0
    result = DataParallelTrainer(lambda: None, scaling_config=sc,
                                 run_config=RunConfig(storage_path=storage)).fit()
    assert isinstance(result.error, train.TrainingFailedError)
    assert "not schedulable" in str(result.error)


def test_torch_config_backend_follows_the_gpus():
    gpu = WorkerGroup(ScalingConfig(num_workers=2, use_gpu=True), "g")
    cpu = WorkerGroup(ScalingConfig(num_workers=2), "c")
    assert TorchConfig().backend is None
    assert TorchConfig().backend_for(gpu) == "nccl"
    assert TorchConfig().backend_for(cpu) == "gloo"
    assert TorchConfig(backend="gloo").backend_for(gpu) == "gloo"
    assert TorchConfig().backend_cls is _TorchBackend


def test_gpu_torch_trainer_without_a_card_fails(rt, storage):
    """No CPU path: the nccl setup asks for the card, which is not there."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("checks the refusal on a machine without a GPU")
    result = TorchTrainer(lambda: train.report({"ran": True}),
                          scaling_config=ScalingConfig(num_workers=1, use_gpu=True),
                          run_config=RunConfig(storage_path=storage)).fit()
    assert isinstance(result.error, train.TrainingFailedError)
    assert result.metrics is None
    assert _wait_gpu_back(rt) == 1.0
