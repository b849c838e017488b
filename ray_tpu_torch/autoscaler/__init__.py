"""Autoscaler: declarative node-count reconciliation from demand.

Parity: python/ray/autoscaler/v2/ (autoscaler.py:42 + scheduler.py
bin-packing over ClusterStatus, instance_manager reconciler) — the
TPU-native reduction: the hub already aggregates pending demand
(list_state("demand")); the autoscaler bin-packs unmet shapes against
configured node types, asks a NodeProvider for instances, and retires
nodes idle past the timeout. Providers plug in like the reference's
NodeProvider ABC (aws/gcp/kuberay/fake_multinode); LocalNodeProvider is
the fake_multinode equivalent — real node-agent processes on this host
— and the shape a GKE/TPU-pod provider implements for production.

Port of ``ray_tpu/autoscaler/__init__.py``: a node type's "GPU" count is
the accelerator a launched node gets (``add_node(num_gpus=...)``), where
the reference launches "TPU" chips.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional


@dataclass
class NodeTypeConfig:
    """One launchable node shape (reference: available_node_types)."""

    name: str
    resources: Dict[str, float]
    min_workers: int = 0
    max_workers: int = 4


class NodeProvider:
    """Reference: autoscaler/node_provider.py ABC."""

    def create_node(self, node_type: NodeTypeConfig) -> str:
        raise NotImplementedError

    def terminate_node(self, node_id: str) -> None:
        raise NotImplementedError

    def non_terminated_nodes(self) -> List[str]:
        raise NotImplementedError


class LocalNodeProvider(NodeProvider):
    """Simulated instances: node-agent processes on this host (the
    reference's fake_multinode provider)."""

    def __init__(self, cluster):
        self._cluster = cluster  # ray_tpu_torch.cluster_utils.Cluster
        self._nodes: Dict[str, Any] = {}

    def create_node(self, node_type: NodeTypeConfig) -> str:
        res = dict(node_type.resources)
        cpus = int(res.pop("CPU", 1))
        gpus = int(res.pop("GPU", 0))
        res.pop("memory", None)
        node = self._cluster.add_node(
            num_cpus=cpus, num_gpus=gpus, resources=res or None
        )
        self._nodes[node.node_id] = node
        return node.node_id

    def terminate_node(self, node_id: str) -> None:
        node = self._nodes.pop(node_id, None)
        if node is not None:
            self._cluster.remove_node(node)

    def non_terminated_nodes(self) -> List[str]:
        return list(self._nodes)


def _fits(shape: Dict[str, float], resources: Dict[str, float]) -> bool:
    return all(resources.get(k, 0.0) >= v for k, v in shape.items())


class Autoscaler:
    def __init__(
        self,
        provider: NodeProvider,
        node_types: List[NodeTypeConfig],
        *,
        poll_interval_s: float = 0.5,
        upscale_delay_s: float = 0.5,
        idle_timeout_s: float = 30.0,
    ):
        self.provider = provider
        self.node_types = node_types
        self.poll_interval_s = poll_interval_s
        self.upscale_delay_s = upscale_delay_s
        self.idle_timeout_s = idle_timeout_s
        self._demand_since: Optional[float] = None
        self._idle_since: Dict[str, float] = {}
        self._owned_type: Dict[str, NodeTypeConfig] = {}
        self._launched_at: Dict[str, float] = {}
        self.launch_grace_s = 30.0  # registration time before a missing
        # node counts as dead (out-of-band failure)
        self._running = False
        self._thread: Optional[threading.Thread] = None

    # ------------------------------------------------------------------
    def _client(self):
        from ray_tpu_torch._private import worker

        return worker.get_client()

    def step(self) -> None:
        """One reconcile pass (the reference's Autoscaler.update)."""
        client = self._client()
        # post-quota demand only: work parked by a tenant's admission
        # quota (fairsched pending_quota) is reported flagged and MUST
        # NOT drive scale-up — no amount of new nodes can dispatch it,
        # and buying hardware a quota forbids using defeats the quota
        demand = [
            d for d in client.list_state("demand")
            if not d.get("pending_quota")
        ]
        avail_nodes = {
            n["node_id"]: n for n in client.list_state("nodes") if n["alive"]
        }
        # unmet demand: shapes no live node could EVER satisfy right now
        unmet = [
            d for d in demand
            if not any(
                _fits(d["shape"], n["available"]) for n in avail_nodes.values()
            )
        ]
        now = time.monotonic()
        if unmet:
            if self._demand_since is None:
                self._demand_since = now
            if now - self._demand_since >= self.upscale_delay_s:
                self._scale_up(unmet)
                self._demand_since = None
        else:
            self._demand_since = None
        self._maybe_scale_down(avail_nodes, client)

    def _scale_up(self, unmet: List[dict]) -> None:
        counts: Dict[str, int] = {}
        for nid, nt in self._owned_type.items():
            counts[nt.name] = counts.get(nt.name, 0) + 1
        for d in unmet:
            for nt in self.node_types:
                if not _fits(d["shape"], nt.resources):
                    continue
                if counts.get(nt.name, 0) >= nt.max_workers:
                    continue
                # one node per unmet shape per pass (launch pacing)
                node_id = self.provider.create_node(nt)
                self._owned_type[node_id] = nt
                self._launched_at[node_id] = time.monotonic()
                counts[nt.name] = counts.get(nt.name, 0) + 1
                break

    def _maybe_scale_down(self, avail_nodes, client) -> None:
        now = time.monotonic()
        # nodes that died out-of-band must release their max_workers
        # budget (and provider bookkeeping) or that type can never scale;
        # a launch grace period keeps this from racing registration
        for node_id in list(self._owned_type):
            if node_id not in avail_nodes and (
                now - self._launched_at.get(node_id, now) > self.launch_grace_s
            ):
                try:
                    self.provider.terminate_node(node_id)
                except Exception:
                    pass
                self._owned_type.pop(node_id, None)
                self._idle_since.pop(node_id, None)
                self._launched_at.pop(node_id, None)
        busy_nodes = {
            w["node_id"]
            for w in client.list_state("workers")
            if w["state"] in ("busy", "actor")
        }
        # quota-parked demand must not hold idle nodes alive either
        demand = [
            d for d in client.list_state("demand")
            if not d.get("pending_quota")
        ]
        for node_id in list(self._owned_type):
            node = avail_nodes.get(node_id)
            nt = self._owned_type[node_id]
            idle = (
                node is not None
                and node_id not in busy_nodes
                and node["available"] == node["resources"]
                and not demand
            )
            if not idle:
                self._idle_since.pop(node_id, None)
                continue
            first = self._idle_since.setdefault(node_id, now)
            owned_of_type = sum(
                1 for t in self._owned_type.values() if t.name == nt.name
            )
            if (
                now - first >= self.idle_timeout_s
                and owned_of_type > nt.min_workers
            ):
                self.provider.terminate_node(node_id)
                self._owned_type.pop(node_id, None)
                self._idle_since.pop(node_id, None)

    # ------------------------------------------------------------------
    def start(self) -> "Autoscaler":
        self._running = True

        def loop():
            import sys
            import traceback

            while self._running:
                try:
                    self.step()
                except Exception:
                    # transient control-plane hiccups must not kill the
                    # loop, but they must be visible
                    sys.stderr.write(
                        f"[ray_tpu_torch] autoscaler step failed:\n"
                        f"{traceback.format_exc()}\n"
                    )
                time.sleep(self.poll_interval_s)

        self._thread = threading.Thread(
            target=loop, daemon=True, name="ray-tpu-torch-autoscaler"
        )
        self._thread.start()
        return self

    def stop(self) -> None:
        self._running = False
