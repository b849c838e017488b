"""Train gangs across simulated hosts, on both packages.

From tests/test_train_multihost.py: a two-worker gang on a cluster whose
head has one CPU, so that the gang must span the head and a node agent.
The reference's ``JaxTrainer`` gang all-gathers its ranks with
``jax.distributed``; the port's ``TorchTrainer`` gang does the same with
a gloo process group. Both report a rank sum of 1 from two processes on
two hosts.

From tests/test_train_multihost_failures.py: a host (node agent) is
killed while the gang waits at step 2; the full-size restart cannot be
placed on the survivor, and the elastic resize finishes the run at half
size from the latest checkpoint. The program is the same on both
packages (``DataParallelTrainer``) and so are the results.

Cost: each test builds one cluster per package (a 1-CPU head and 1-CPU
node agents); train loops are defined inside the tests.
"""

import os
import threading
import time

import ray_tpu
import ray_tpu_torch
from ray_tpu.cluster_utils import Cluster as RefCluster
from ray_tpu_torch.cluster_utils import Cluster as PortCluster


def _port_cluster():
    os.environ["RAY_TPU_TORCH_NUM_GPUS"] = "0"
    try:
        return PortCluster(head_num_cpus=1)
    finally:
        del os.environ["RAY_TPU_TORCH_NUM_GPUS"]


def test_gang_all_gathers_across_two_hosts():
    c = RefCluster(head_num_cpus=1)
    try:
        c.add_node(num_cpus=1)
        from ray_tpu.air.config import ScalingConfig
        from ray_tpu.train.backend import JaxConfig
        from ray_tpu.train.jax_trainer import JaxTrainer

        def jax_fn(config):
            import os

            import jax
            import jax.numpy as jnp
            import numpy as np
            from jax.experimental import multihost_utils

            from ray_tpu.train import session

            node = float(os.environ.get("RAY_TPU_NODE_ID", "node0")[len("node"):])
            gathered = np.asarray(multihost_utils.process_allgather(
                jnp.array([float(jax.process_index()), node]))).reshape(-1, 2)
            session.report({"rank_sum": float(gathered[:, 0].sum()),
                            "n_processes": jax.process_count(),
                            "nodes": sorted(int(n) for n in gathered[:, 1])})

        ref = JaxTrainer(jax_fn, scaling_config=ScalingConfig(
            num_workers=2, resources_per_worker={"CPU": 1}),
            jax_config=JaxConfig(enable_distributed=True)).fit()
    finally:
        c.shutdown()
    assert ref.error is None, ref.error

    c = _port_cluster()
    try:
        c.add_node(num_cpus=1)
        from ray_tpu_torch.train import ScalingConfig, TorchConfig, TorchTrainer

        def torch_fn(config):
            import os

            import torch
            import torch.distributed as dist

            from ray_tpu_torch import train

            assert dist.get_backend() == "gloo"
            node = float(os.environ.get("RAY_TPU_TORCH_NODE_ID", "node0")[len("node"):])
            parts = [torch.zeros(2) for _ in range(dist.get_world_size())]
            dist.all_gather(parts, torch.tensor([float(dist.get_rank()), node]))
            gathered = torch.stack(parts)
            train.report({"rank_sum": float(gathered[:, 0].sum()),
                          "n_processes": dist.get_world_size(),
                          "nodes": sorted(int(n) for n in gathered[:, 1])})

        port = TorchTrainer(torch_fn, torch_config=TorchConfig(backend="gloo"),
                            scaling_config=ScalingConfig(
                                num_workers=2, resources_per_worker={"CPU": 1})).fit()
    finally:
        c.shutdown()
    assert port.error is None, port.error
    keys = ("rank_sum", "n_processes", "nodes")
    assert {k: ref.metrics[k] for k in keys} == {k: port.metrics[k] for k in keys} == {
        "rank_sum": 1.0, "n_processes": 2, "nodes": [0, 1]}


def _host_loss(rt, cluster, tmp_path):
    """The reference's host-loss program on package ``rt``: (final metrics,
    whether the doomed rank ran on the killed host)."""
    train = __import__(f"{rt.__name__}.train", fromlist=["train"])
    node_b = cluster.add_node(num_cpus=1)
    marker = tmp_path / f"{rt.__name__}_rank1_started"
    key = "RAY_TPU_TORCH_NODE_ID" if rt is ray_tpu_torch else "RAY_TPU_NODE_ID"

    def loop(config):
        import os
        import time

        ctx = train.get_context()
        start = 0
        ckpt = train.get_checkpoint()
        if ckpt is not None:
            start = ckpt.to_state()["step"] + 1
        for i in range(start, 4):
            if i == 2 and ctx.get_world_size() == 2:
                # the full-size gang parks at step 2: the off-head rank
                # signals the driver and both ranks wait for the host kill
                if os.environ.get(key, "node0") != "node0":
                    open(config["marker"], "w").close()
                time.sleep(120)
            train.report({"step": i, "world": ctx.get_world_size()},
                         checkpoint=train.Checkpoint.from_state({"step": i}))

    trainer = train.DataParallelTrainer(
        loop, train_loop_config={"marker": str(marker)},
        scaling_config=train.ScalingConfig(num_workers=2, resources_per_worker={"CPU": 1},
                                           min_workers=1, placement_timeout_s=3.0),
        run_config=train.RunConfig(name="hostloss", storage_path=str(tmp_path / rt.__name__),
                                   failure_config=train.FailureConfig(max_failures=3)),
    )

    def killer():
        deadline = time.monotonic() + 60
        while time.monotonic() < deadline:
            if marker.exists():
                cluster.remove_node(node_b)
                return
            time.sleep(0.2)

    kt = threading.Thread(target=killer, daemon=True)
    kt.start()
    result = trainer.fit()
    kt.join(timeout=60)
    assert result.error is None, result.error
    return {k: result.metrics[k] for k in ("step", "world")}, marker.exists()


def test_host_loss_restarts_the_gang_at_half_size(tmp_path):
    out = []
    for rt in (ray_tpu, ray_tpu_torch):
        cluster = RefCluster(head_num_cpus=1) if rt is ray_tpu else _port_cluster()
        try:
            out.append(_host_loss(rt, cluster, tmp_path))
        finally:
            cluster.shutdown()
    assert out[0] == out[1] == ({"step": 3, "world": 1}, True)
