"""Cluster: a multi-host test/dev harness on one machine.

Parity: python/ray/cluster_utils.py:135 (Cluster/add_node) — spins a
TCP-mode hub (head) plus N node-agent processes, each simulating one
host with its own session dir, resources, and (fake) hostname, so
multi-node scheduling, cross-node objects, STRICT_SPREAD placement, and
multi-process torch.distributed gangs are all exercisable without real
extra hosts. On real multi-host deployments the same agent binary runs
per host with RAY_TPU_TORCH_HUB_ADDR pointing at the head.

Port of ``ray_tpu/cluster_utils.py``: ``add_node(num_gpus=n)`` takes the
place of ``num_tpus`` and gives the agent ``RAY_TPU_TORCH_NUM_GPUS``; the
agent's workers index the ``CUDA_VISIBLE_DEVICES`` the agent inherits
from this process. The head detects GPUs as ``init`` does: set
``RAY_TPU_TORCH_NUM_GPUS=0`` around ``Cluster()`` for a head without one.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from typing import Dict, List, Optional


class ClusterNode:
    def __init__(self, node_id: str, proc: subprocess.Popen, session_dir: str):
        self.node_id = node_id
        self.proc = proc
        self.session_dir = session_dir


class Cluster:
    """Start a head (in-process hub over TCP) and add simulated hosts."""

    def __init__(
        self,
        head_num_cpus: int = 2,
        head_resources: Optional[Dict[str, float]] = None,
        max_workers: Optional[int] = None,
    ):
        import ray_tpu_torch

        self._ray = ray_tpu_torch
        ctx = ray_tpu_torch.init(
            num_cpus=head_num_cpus,
            resources=head_resources,
            max_workers=max_workers,
            _tcp_hub=True,
        )
        self.address = ctx.address_info["address"]
        assert self.address.startswith("tcp://"), self.address
        self.nodes: List[ClusterNode] = []
        self._counter = 0

    def add_node(
        self,
        *,
        num_cpus: int = 2,
        num_gpus: int = 0,
        resources: Optional[Dict[str, float]] = None,
        hostname: Optional[str] = None,
        max_workers: Optional[int] = None,
        wait: bool = True,
    ) -> ClusterNode:
        self._counter += 1
        node_id = f"node{self._counter}"
        from ray_tpu_torch._private.session import new_session_dir

        session_dir = new_session_dir(f"ray_tpu_torch_{node_id}")
        env = dict(os.environ)
        # the agent (and transitively its workers) must be able to import
        # ray_tpu_torch and the driver's modules regardless of cwd
        pkg_parent = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        paths = [pkg_parent] + [p for p in sys.path if p]
        if env.get("PYTHONPATH"):
            paths.append(env["PYTHONPATH"])
        env["PYTHONPATH"] = os.pathsep.join(dict.fromkeys(paths))
        env.update(
            RAY_TPU_TORCH_HUB_ADDR=self.address,
            RAY_TPU_TORCH_NODE_ID=node_id,
            RAY_TPU_TORCH_SESSION_DIR=session_dir,
            RAY_TPU_TORCH_NUM_CPUS=str(num_cpus),
            RAY_TPU_TORCH_NUM_GPUS=str(num_gpus),
            # simulate a distinct host: fake hostname, loopback IP
            RAY_TPU_TORCH_NODE_HOSTNAME=hostname or f"host-{node_id}",
            RAY_TPU_TORCH_NODE_IP="127.0.0.1",
        )
        if resources:
            env["RAY_TPU_TORCH_CUSTOM_RESOURCES"] = json.dumps(resources)
        if max_workers:
            env["RAY_TPU_TORCH_MAX_WORKERS"] = str(max_workers)
        proc = subprocess.Popen(
            [sys.executable, "-m", "ray_tpu_torch._private.node_agent"], env=env
        )
        node = ClusterNode(node_id, proc, session_dir)
        self.nodes.append(node)
        if wait:
            self._wait_for_node(node_id)
        return node

    def _wait_for_node(self, node_id: str, timeout: float = 15.0) -> None:
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            if any(
                n["node_id"] == node_id and n["alive"]
                for n in self._ray.nodes()
            ):
                return
            time.sleep(0.05)
        raise TimeoutError(f"node {node_id} did not register within {timeout}s")

    def remove_node(self, node: ClusterNode, timeout: float = 10.0) -> None:
        node.proc.terminate()
        try:
            node.proc.wait(timeout=timeout)
        except subprocess.TimeoutExpired:
            node.proc.kill()
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            if any(
                n["node_id"] == node.node_id and not n["alive"]
                for n in self._ray.nodes()
            ):
                return
            time.sleep(0.05)

    def shutdown(self) -> None:
        import shutil

        for node in self.nodes:
            try:
                node.proc.terminate()
                node.proc.wait(timeout=5)
            except Exception:
                try:
                    node.proc.kill()
                except Exception:
                    pass
            shutil.rmtree(node.session_dir, ignore_errors=True)
        self.nodes = []
        self._ray.shutdown()
