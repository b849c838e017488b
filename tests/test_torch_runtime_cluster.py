"""The port's multi-node runtime against the reference's, side by side.

Each program of tests/test_cluster.py runs once on a ``ray_tpu``
``Cluster`` and once on a ``ray_tpu_torch`` ``Cluster``, both up at once
in this process, each a TCP head in this process and two node-agent
processes (simulated hosts with their own session dirs); the two results
must be equal: nodes registered, a task sent to a custom-resource node,
node affinity, tasks spread past the head, a shared-memory object made
on one node and read on the driver and on another node, an actor on a
remote node, STRICT_SPREAD bundles, a node's death, and the lineage
reconstruction of an object that died with its node.

GPUs on node agents (the port only, held without a card): an agent with
``num_gpus=2`` pins ids "0" and "1"; an agent whose environment has
``CUDA_VISIBLE_DEVICES=GPU-aaa,GPU-bbb`` hands those entries to its
workers; a head started with no GPU places no GPU task, which waits for
an agent that has one; a CPU tensor made on an agent reaches the driver.

Cost: one cluster per package for the whole file (2 + 2 + 2 CPUs);
remote code names no helper of this module, so no worker imports it.
"""

import os
import time

import numpy as np
import pytest

import ray_tpu
import ray_tpu_torch
from ray_tpu.cluster_utils import Cluster as RefCluster
from ray_tpu_torch.cluster_utils import Cluster as PortCluster

T = 60
RTS = [ray_tpu, ray_tpu_torch]


def _node_env(rt):
    """The variable a worker reads its node id from."""
    return "RAY_TPU_TORCH_NODE_ID" if rt is ray_tpu_torch else "RAY_TPU_NODE_ID"


def _util(rt, name):
    return __import__(f"{rt.__name__}.util.{name}", fromlist=[name])


@pytest.fixture(scope="module")
def clusters():
    ref = RefCluster(head_num_cpus=2)
    os.environ["RAY_TPU_TORCH_NUM_GPUS"] = "0"
    try:
        port = PortCluster(head_num_cpus=2)
    finally:
        del os.environ["RAY_TPU_TORCH_NUM_GPUS"]
    for c in (ref, port):
        c.add_node(num_cpus=2, resources={"nodeA": 4.0})
        c.add_node(num_cpus=2, resources={"nodeB": 4.0})
    yield {ray_tpu: ref, ray_tpu_torch: port}
    port.shutdown()
    ref.shutdown()


def nodes_registered(rt, cluster):
    alive = {n["node_id"] for n in rt.nodes() if n["alive"]}
    total = rt.cluster_resources()
    return sorted(alive), total["CPU"], total["nodeA"], total.get("GPU", 0)


def custom_resource_node(rt, cluster):
    key = _node_env(rt)

    @rt.remote(resources={"nodeB": 1.0})
    def where():
        import os

        return os.environ.get(key, "node0")

    return rt.get(where.remote(), timeout=T)


def node_affinity(rt, cluster):
    key = _node_env(rt)
    strategy = _util(rt, "scheduling_strategies").NodeAffinitySchedulingStrategy

    @rt.remote
    def where():
        import os

        return os.environ.get(key, "node0")

    return rt.get(where.options(
        scheduling_strategy=strategy(node_id="node1")).remote(), timeout=T)


def spread_past_the_head(rt, cluster):
    key = _node_env(rt)

    @rt.remote(num_cpus=1)
    def where(i):
        import os
        import time

        time.sleep(0.3)
        return os.environ.get(key, "node0")

    # 6 concurrent 1-CPU tasks > the head's 2 CPUs: they must spill over
    return len(set(rt.get([where.remote(i) for i in range(6)], timeout=T))) >= 2


def cross_node_shm_object(rt, cluster):
    @rt.remote(resources={"nodeA": 1.0})
    def make():
        import numpy as np

        return np.arange(200_000, dtype=np.float64)  # 1.6 MB: a shm segment

    @rt.remote(resources={"nodeB": 1.0})
    def consume(a):
        return float(a.sum())

    ref = make.remote()
    arr = rt.get(ref, timeout=T)  # the driver is on node0: a cross-node fetch
    return arr.shape, float(arr[123_456]), rt.get(consume.remote(ref), timeout=T)


def actor_on_remote_node(rt, cluster):
    key = _node_env(rt)

    @rt.remote(resources={"nodeA": 1.0})
    class Counter:
        def __init__(self):
            self.n = 0

        def bump(self, k):
            self.n += k
            return self.n

        def node(self):
            import os

            return os.environ.get(key, "node0")

    c = Counter.remote()
    out = rt.get(c.node.remote(), timeout=T), rt.get([c.bump.remote(2), c.bump.remote(3)],
                                                       timeout=T)
    rt.kill(c)
    return out


def strict_spread(rt, cluster):
    key = _node_env(rt)
    pgmod = _util(rt, "placement_group")
    strategy = _util(rt, "scheduling_strategies").PlacementGroupSchedulingStrategy
    pg = pgmod.placement_group([{"CPU": 1}] * 3, strategy="STRICT_SPREAD")
    assert pg.wait(timeout_seconds=10)

    @rt.remote(num_cpus=1)
    def where():
        import os

        return os.environ.get(key, "node0")

    got = rt.get([where.options(scheduling_strategy=strategy(
        placement_group=pg, placement_group_bundle_index=i)).remote() for i in range(3)],
        timeout=T)
    pgmod.remove_placement_group(pg)
    return sorted(got)


def node_death(rt, cluster):
    node = cluster.add_node(num_cpus=1, resources={"dying": 1.0})
    up = any(n["node_id"] == node.node_id and n["alive"] for n in rt.nodes())
    cluster.remove_node(node)
    entry = [n for n in rt.nodes() if n["node_id"] == node.node_id]
    return node.node_id, up, bool(entry) and not entry[0]["alive"], \
        "dying" in rt.cluster_resources()


def lineage_after_node_death(rt, cluster):
    node = cluster.add_node(num_cpus=2, resources={"ephemeral": 4.0})

    @rt.remote(resources={"ephemeral": 1.0}, max_retries=2)
    def make():
        import numpy as np

        return np.arange(250_000, dtype=np.float64)  # a shm segment

    ref = make.remote()
    ready, _ = rt.wait([ref], num_returns=1, timeout=T)  # made on the doomed node
    cluster.remove_node(node)
    cluster.add_node(num_cpus=2, resources={"ephemeral": 4.0})
    arr = rt.get(ref, timeout=T)  # the fetch fails, so the task runs again
    return bool(ready), float(arr[123_456])


PROGRAMS = {
    "nodes_registered": (nodes_registered, (["node0", "node1", "node2"], 6.0, 4.0, 0)),
    "custom_resource_node": (custom_resource_node, "node2"),
    "node_affinity": (node_affinity, "node1"),
    "spread_past_the_head": (spread_past_the_head, True),
    "cross_node_shm_object": (cross_node_shm_object,
                              ((200_000,), 123_456.0, float(np.arange(200_000.0).sum()))),
    "actor_on_remote_node": (actor_on_remote_node, ("node1", [2, 5])),
    "strict_spread": (strict_spread, ["node0", "node1", "node2"]),
    "node_death": (node_death, ("node3", True, True, False)),
    "lineage_after_node_death": (lineage_after_node_death, (True, 123_456.0)),
}


@pytest.mark.parametrize("name", list(PROGRAMS))
def test_cluster_program_agrees(clusters, name):
    program, want = PROGRAMS[name]
    got = [program(rt, clusters[rt]) for rt in RTS]
    assert got[0] == got[1] == want, got


# ------------------------------------------------ GPUs on node agents (port)
def _gpu_ids_on(rt, resource, n):
    """(node id, CUDA_VISIBLE_DEVICES) of ``n`` one-GPU actors held at once
    on the node that carries ``resource``."""

    @rt.remote(num_gpus=1, resources={resource: 1.0})
    class Holder:
        def ids(self):
            import os

            return os.environ["RAY_TPU_TORCH_NODE_ID"], os.environ["CUDA_VISIBLE_DEVICES"]

    holders = [Holder.remote() for _ in range(n)]
    got = sorted(rt.get([h.ids.remote() for h in holders], timeout=T))
    for h in holders:
        rt.kill(h)
    return got


def _wait_gpus(rt, want):
    deadline = time.time() + T
    while rt.available_resources().get("GPU", 0) != want and time.time() < deadline:
        time.sleep(0.05)
    return rt.available_resources().get("GPU", 0)


def test_agent_with_two_gpus_pins_each(clusters):
    rt, cluster = ray_tpu_torch, clusters[ray_tpu_torch]
    node = cluster.add_node(num_cpus=2, num_gpus=2, resources={"two_gpus": 2.0})
    try:
        assert rt.cluster_resources()["GPU"] == 2.0
        assert _gpu_ids_on(rt, "two_gpus", 2) == [(node.node_id, "0"), (node.node_id, "1")]
        assert _wait_gpus(rt, 2.0) == 2.0
    finally:
        cluster.remove_node(node)
    assert rt.cluster_resources().get("GPU", 0) == 0


def test_agent_hands_its_own_visible_list_to_workers(clusters):
    rt, cluster = ray_tpu_torch, clusters[ray_tpu_torch]
    saved = os.environ.get("CUDA_VISIBLE_DEVICES")
    os.environ["CUDA_VISIBLE_DEVICES"] = "GPU-aaa,GPU-bbb"  # inherited by the agent
    try:
        node = cluster.add_node(num_cpus=2, num_gpus=2, resources={"uuid_gpus": 2.0})
    finally:
        if saved is None:
            del os.environ["CUDA_VISIBLE_DEVICES"]
        else:
            os.environ["CUDA_VISIBLE_DEVICES"] = saved
    try:
        assert _gpu_ids_on(rt, "uuid_gpus", 2) == [(node.node_id, "GPU-aaa"),
                                                  (node.node_id, "GPU-bbb")]
    finally:
        cluster.remove_node(node)


def test_gpu_task_waits_for_an_agent_with_a_gpu(clusters):
    rt, cluster = ray_tpu_torch, clusters[ray_tpu_torch]
    assert rt.cluster_resources().get("GPU", 0) == 0  # the head has none

    @rt.remote(num_gpus=1)
    def where():
        import os

        return os.environ["RAY_TPU_TORCH_NODE_ID"], os.environ["CUDA_VISIBLE_DEVICES"]

    ref = where.remote()
    ready, _ = rt.wait([ref], timeout=2.0)
    assert not ready  # no node may take it
    node = cluster.add_node(num_cpus=1, num_gpus=1)
    try:
        assert rt.get(ref, timeout=T) == (node.node_id, "0")
    finally:
        cluster.remove_node(node)


def test_cpu_tensor_made_on_an_agent_reaches_the_driver(clusters):
    import torch

    rt = ray_tpu_torch

    @rt.remote(resources={"nodeA": 1.0})
    def make(n):
        import torch

        return torch.arange(n, dtype=torch.float32)

    @rt.remote(resources={"nodeB": 1.0})
    def total(t):
        return float(t.sum())

    for n in (16, 1 << 20):  # inline, and a shm segment on node1
        ref = make.remote(n)
        t = rt.get(ref, timeout=T)
        assert isinstance(t, torch.Tensor) and torch.equal(t, torch.arange(n, dtype=torch.float32))
        assert rt.get(total.remote(ref), timeout=T) == float(t.sum())
