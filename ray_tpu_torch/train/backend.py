"""Backend plugin: per-framework worker-group setup hooks.

Port of ``ray_tpu/train/backend.py`` (reference: python/ray/train/
backend.py:16,32, Backend/BackendConfig with on_start/on_training_start/
on_shutdown). The JAX package's ``JaxConfig`` (the ``jax.distributed``
handshake and a device mesh) has no counterpart in a package without
JAX: its role goes to ``TorchConfig`` (``torch_trainer.py``), whose
backend runs ``torch.distributed.init_process_group`` on every worker and
hands ``TorchConfig.mesh_shape`` (``JaxConfig.mesh_shape``'s counterpart)
to ``ray_tpu_torch.parallel.make_mesh`` in each.
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass
class BackendConfig:
    """Declarative config; backend_cls() yields the imperative hooks."""

    @property
    def backend_cls(self):
        return Backend


class Backend:
    """Hooks run by the controller against the worker group. Each hook
    receives the WorkerGroup and the BackendConfig."""

    share_env_vars: bool = False

    def on_start(self, worker_group, backend_config: "BackendConfig") -> None:
        pass

    def on_training_start(self, worker_group, backend_config: "BackendConfig") -> None:
        pass

    def on_shutdown(self, worker_group, backend_config: "BackendConfig") -> None:
        pass


def rank0_rendezvous_addr(worker_group, port: int = 0) -> str:
    """host:port every rank can dial, bound on rank 0's host (the
    master-addr/port pattern of the reference's _TorchBackend,
    train/torch/config.py:66).

    node_ip, not hostname: simulated hosts have fake hostnames, and
    real hosts may not resolve each other's names — the IP the agent
    registered with is what peers can dial."""
    import ray_tpu_torch

    rank0 = worker_group.workers[0]
    if not port:
        port = ray_tpu_torch.get(rank0.actor.pick_free_port.remote())
    ip = rank0.metadata.get("node_ip") or rank0.metadata["hostname"]
    return f"{ip}:{port}"
