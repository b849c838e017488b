"""The port's autoscaler against the reference's, on the same programs.

The three programs of tests/test_autoscaler.py run once per package:
demand that cannot fit on a 1-CPU head launches nodes through
``LocalNodeProvider`` (node-agent processes) and idle nodes retire after
the timeout; demand parked by a tenant's quota buys no node; and no more
than ``max_workers`` nodes are launched. A fourth program, on the port,
launches a node type with a GPU: the pending ``num_gpus=1`` task gets a
node whose agent holds one, and runs there pinned to id "0".

Cost: each program builds and shuts down its own cluster (or runtime),
one package after the other; remote code names no helper of this module.
"""

import importlib
import os
import time

import pytest

import ray_tpu
import ray_tpu_torch

T = 60
RTS = [ray_tpu, ray_tpu_torch]
IDS = ["ray_tpu", "ray_tpu_torch"]


def _mod(rt, name):
    return importlib.import_module(f"{rt.__name__}.{name}")


def _node_env(rt):
    return "RAY_TPU_TORCH_NODE_ID" if rt is ray_tpu_torch else "RAY_TPU_NODE_ID"


def _cluster(rt, **kw):
    if rt is not ray_tpu_torch:
        return _mod(rt, "cluster_utils").Cluster(**kw)
    os.environ["RAY_TPU_TORCH_NUM_GPUS"] = "0"  # the head holds no GPU
    try:
        return _mod(rt, "cluster_utils").Cluster(**kw)
    finally:
        del os.environ["RAY_TPU_TORCH_NUM_GPUS"]


@pytest.mark.parametrize("rt", RTS, ids=IDS)
def test_scales_up_then_down(rt):
    auto = _mod(rt, "autoscaler")
    key = _node_env(rt)
    c = _cluster(rt, head_num_cpus=1, max_workers=1)
    provider = auto.LocalNodeProvider(c)
    scaler = auto.Autoscaler(
        provider,
        [auto.NodeTypeConfig("cpu-worker", {"CPU": 2}, min_workers=0, max_workers=3)],
        poll_interval_s=0.2, upscale_delay_s=0.2, idle_timeout_s=2.0,
    ).start()
    try:
        @rt.remote(num_cpus=2)  # cannot fit on the 1-CPU head
        def big_task(i):
            import os
            import time

            time.sleep(1.0)
            return os.environ.get(key)

        nodes = rt.get([big_task.remote(i) for i in range(2)], timeout=T)
        assert all(n != "node0" for n in nodes)
        assert len(provider.non_terminated_nodes()) >= 1
        deadline = time.time() + 30  # demand gone: idle nodes retire
        while time.time() < deadline and provider.non_terminated_nodes():
            time.sleep(0.3)
        assert provider.non_terminated_nodes() == []
    finally:
        scaler.stop()
        c.shutdown()


@pytest.mark.parametrize("rt", RTS, ids=IDS)
def test_quota_parked_demand_does_not_scale_up(rt):
    auto = _mod(rt, "autoscaler")

    class RecordingProvider(auto.NodeProvider):
        def __init__(self):
            self.created = []

        def create_node(self, node_type):
            self.created.append(node_type.name)
            return f"fake-{len(self.created)}"

        def terminate_node(self, node_id):
            pass

        def non_terminated_nodes(self):
            return []

    rt.init(num_cpus=1, max_workers=1,
            job_config=rt.JobConfig(tenant="capped", quota={"CPU": 1}))
    try:
        @rt.remote(num_cpus=1)
        def hold(i):
            import time

            time.sleep(1.5)
            return i

        refs = [hold.remote(i) for i in range(4)]  # 1 admitted, 3 parked
        client = _mod(rt, "_private.worker").get_client()
        # wait for the stable window: one task running, every other
        # demand row parked by the quota
        deadline = time.time() + 30
        demand = None
        while time.time() < deadline:
            demand = client.list_state("demand")
            running = [t for t in client.list_state("tasks") if t.get("state") == "RUNNING"]
            if running and demand and all(d.get("pending_quota") for d in demand):
                break
            time.sleep(0.1)
        assert demand and all(d.get("pending_quota") for d in demand), demand
        provider = RecordingProvider()
        scaler = auto.Autoscaler(provider, [auto.NodeTypeConfig("w", {"CPU": 4}, max_workers=3)],
                                 upscale_delay_s=0.0)
        scaler.step()
        scaler.step()  # past any upscale delay
        assert provider.created == [], "the autoscaler bought nodes for quota-parked demand"
        assert rt.get(refs, timeout=T) == list(range(4))
    finally:
        rt.shutdown()


@pytest.mark.parametrize("rt", RTS, ids=IDS)
def test_respects_max_workers(rt):
    auto = _mod(rt, "autoscaler")
    c = _cluster(rt, head_num_cpus=1, max_workers=1)
    provider = auto.LocalNodeProvider(c)
    scaler = auto.Autoscaler(
        provider, [auto.NodeTypeConfig("w", {"CPU": 1}, max_workers=2)],
        poll_interval_s=0.1, upscale_delay_s=0.1, idle_timeout_s=60.0,
    ).start()
    try:
        @rt.remote(num_cpus=1)
        def hold(i):
            import time

            time.sleep(3)
            return i

        refs = [hold.remote(i) for i in range(8)]  # far more than max_workers allows
        time.sleep(2.0)
        assert len(provider.non_terminated_nodes()) <= 2
        rt.get(refs, timeout=120)
    finally:
        scaler.stop()
        c.shutdown()


def test_gpu_demand_launches_a_gpu_node():
    rt = ray_tpu_torch
    auto = _mod(rt, "autoscaler")
    c = _cluster(rt, head_num_cpus=1, max_workers=1)
    provider = auto.LocalNodeProvider(c)
    scaler = auto.Autoscaler(
        provider, [auto.NodeTypeConfig("gpu-worker", {"CPU": 1, "GPU": 1}, max_workers=1)],
        poll_interval_s=0.2, upscale_delay_s=0.2, idle_timeout_s=60.0,
    ).start()
    try:
        assert rt.cluster_resources().get("GPU", 0) == 0

        @rt.remote(num_gpus=1)
        def where():
            import os

            return os.environ["RAY_TPU_TORCH_NODE_ID"], os.environ["CUDA_VISIBLE_DEVICES"]

        node, ids = rt.get(where.remote(), timeout=T)
        assert provider.non_terminated_nodes() == [node] and ids == "0"
        assert rt.cluster_resources()["GPU"] == 1.0
    finally:
        scaler.stop()
        c.shutdown()
