"""A GPU gang's ranks follow the order of the driver's
``CUDA_VISIBLE_DEVICES``, whatever form its entries take.

CUDA takes numbers and ``GPU-<uuid>``/``MIG-<uuid>`` entries. The runtime
pins a worker by its GPUs' positions in the list it inherited, and the
worker group sorts its workers by (host, positions), as the reference
sorts by its chip ids. Two cases, each with its own runtime told of two
GPUs (``RAY_TPU_TORCH_NUM_GPUS=2``, read by ``init`` only): UUIDs, and
the numbers "10,2", where rank 0 must hold "10". The gang is a two-worker
``TorchTrainer`` over gloo (no card here); each rank all-gathers the
entry it was pinned. The driver's ``CUDA_VISIBLE_DEVICES`` stays set for
the runtime's life, since workers inherit it when they are spawned, and
is restored after.

Cost: one runtime per case, two CPUs and two workers.
"""

import os

import pytest

import ray_tpu_torch
from ray_tpu_torch.train import RunConfig, ScalingConfig, TorchConfig, TorchTrainer

VISIBLE = ["GPU-aaaaaaaa-0000,GPU-bbbbbbbb-1111", "10,2"]


@pytest.fixture(params=VISIBLE, ids=["uuids", "numbers"])
def driver_visible(request):
    saved = os.environ.get("CUDA_VISIBLE_DEVICES")
    os.environ["CUDA_VISIBLE_DEVICES"] = request.param
    os.environ["RAY_TPU_TORCH_NUM_GPUS"] = "2"
    try:
        ray_tpu_torch.init(num_cpus=2, max_workers=2)
    finally:
        del os.environ["RAY_TPU_TORCH_NUM_GPUS"]
    try:
        yield request.param.split(",")
    finally:
        ray_tpu_torch.shutdown()
        if saved is None:
            del os.environ["CUDA_VISIBLE_DEVICES"]
        else:
            os.environ["CUDA_VISIBLE_DEVICES"] = saved


def test_gpu_gang_ranks_follow_the_driver_order(driver_visible, tmp_path):
    def loop(config):
        import os

        import torch.distributed as dist

        from ray_tpu_torch import train

        pinned = [None] * dist.get_world_size()
        dist.all_gather_object(pinned, os.environ["CUDA_VISIBLE_DEVICES"])
        train.report({"pinned": pinned, "rank": train.get_context().get_world_rank()})

    result = TorchTrainer(loop, torch_config=TorchConfig(backend="gloo"),
                          scaling_config=ScalingConfig(num_workers=2, use_gpu=True),
                          run_config=RunConfig(storage_path=str(tmp_path))).fit()
    assert result.error is None, result.error
    assert result.metrics["pinned"] == driver_visible
