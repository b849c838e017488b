"""TorchTrainer: data-parallel training on a gang of torch processes.

Port of ``ray_tpu/train/torch_trainer.py`` and, by mapping, of
``ray_tpu/train/jax_trainer.py`` (reference: python/ray/train/torch/
torch_trainer.py + config.py:36,153, _TorchBackend: pick worker-0's
addr/port, dist.init_process_group on every worker). The JAX package
has a ``JaxTrainer`` over the same worker group; a package without JAX
has ``TorchTrainer`` in its place, and a train loop runs
``ray_tpu_torch.parallel.make_train_step`` where the reference's runs
the JAX one.

The train_loop_per_worker runs inside each gang worker with:
- ``ray_tpu_torch.train.get_context()``: rank and world;
- ``ray_tpu_torch.train.report(metrics, checkpoint=...)``: metrics and
  checkpoints;
- ``ray_tpu_torch.train.get_checkpoint()``: the resume point after a
  restart;
- ``ray_tpu_torch.parallel.make_mesh()``: the worker's mesh over the
  gang's process group, shaped by ``TorchConfig.mesh_shape`` (all fsdp
  when it is None), so that data/fsdp/model/seq/expert shardings run as
  collectives on the group's backend. (In the JAX package one worker owns
  every local chip and its mesh is over them; here a worker is one rank.)

The process group's backend follows the reference's rule: "nccl" when
the gang's workers ask for GPUs, "gloo" otherwise (``TorchConfig.backend``
None); a worker on nccl sets its card before it joins the group.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional

from ..air.config import RunConfig, ScalingConfig
from ._checkpoint import Checkpoint
from .backend import Backend, BackendConfig, rank0_rendezvous_addr
from .data_parallel_trainer import DataParallelTrainer


@dataclass
class TorchConfig(BackendConfig):
    """reference: train/torch/config.py TorchConfig (backend/timeout).

    backend: "nccl" or "gloo"; None picks nccl when the workers ask for
    GPUs and gloo otherwise. mesh_shape: axis sizes of the mesh
    ``parallel.make_mesh()`` builds in each worker, e.g. {"fsdp": 2,
    "model": 2}; None means every rank on the auto axis (fsdp)."""

    backend: Optional[str] = None
    init_timeout_s: float = 120.0
    mesh_shape: Optional[Dict[str, int]] = None

    @property
    def backend_cls(self):
        return _TorchBackend

    def backend_for(self, worker_group) -> str:
        """The process-group backend for this gang: ``backend`` if set,
        else nccl when each worker asks for GPUs, else gloo (the
        reference's rule, read from the scaling config)."""
        if self.backend is not None:
            return self.backend
        gpus = worker_group.scaling_config.num_gpus_per_worker
        return "nccl" if gpus > 0 else "gloo"


def _torch_worker_setup(worker, addr: str, world_size: int, rank: int,
                        backend: str, timeout_s: float, mesh_shape=None):
    """Runs inside each TrainWorker actor (the reference's
    _setup_torch_process_group, config.py:66). On nccl the worker's card
    is the first of its pinned ones, set before the group is joined.
    ``mesh_shape`` becomes the shape of ``parallel.make_mesh()``."""
    import datetime

    import torch
    import torch.distributed as dist

    from ray_tpu_torch.parallel import mesh

    mesh.set_default_mesh_shape(mesh_shape)

    if backend == "nccl":
        torch.cuda.set_device(0)
    if not dist.is_initialized():
        dist.init_process_group(
            backend,
            init_method=f"tcp://{addr}",
            world_size=world_size,
            rank=rank,
            timeout=datetime.timedelta(seconds=timeout_s),
        )
    return True


def _torch_worker_teardown(worker):
    import torch.distributed as dist

    if dist.is_initialized():
        dist.destroy_process_group()
    return True


class _TorchBackend(Backend):
    def on_start(self, worker_group, backend_config: TorchConfig) -> None:
        # group inits even for n == 1: world-size-agnostic loops call
        # dist.get_world_size()/all_reduce unconditionally (reference
        # behavior — _TorchBackend always sets up the process group)
        n = len(worker_group.workers)
        import ray_tpu_torch

        addr = rank0_rendezvous_addr(worker_group)
        backend = backend_config.backend_for(worker_group)
        ray_tpu_torch.get([
            w.actor.run_backend_hook.remote(
                _torch_worker_setup, addr, n, w.rank,
                backend, backend_config.init_timeout_s, backend_config.mesh_shape,
            )
            for w in worker_group.workers
        ])

    def on_shutdown(self, worker_group, backend_config: TorchConfig) -> None:
        import ray_tpu_torch

        try:
            ray_tpu_torch.get([
                w.actor.run_backend_hook.remote(_torch_worker_teardown)
                for w in worker_group.workers
            ])
        except Exception:
            pass  # workers may already be dead (gang teardown)


class TorchTrainer(DataParallelTrainer):
    def __init__(
        self,
        train_loop_per_worker: Callable,
        *,
        train_loop_config: Optional[Dict[str, Any]] = None,
        torch_config: Optional[TorchConfig] = None,
        scaling_config: Optional[ScalingConfig] = None,
        run_config: Optional[RunConfig] = None,
        datasets: Optional[Dict[str, Any]] = None,
        resume_from_checkpoint: Optional[Checkpoint] = None,
        metadata: Optional[Dict[str, Any]] = None,
    ):
        super().__init__(
            train_loop_per_worker,
            train_loop_config=train_loop_config,
            backend_config=torch_config or TorchConfig(),
            scaling_config=scaling_config,
            run_config=run_config,
            datasets=datasets,
            resume_from_checkpoint=resume_from_checkpoint,
            metadata=metadata,
        )


def prepare_model(model):
    """Wrap in DDP when a process group of more than one rank is live
    (reference: ray.train.torch.prepare_model, minus device movement)."""
    import torch.distributed as dist

    if dist.is_initialized() and dist.get_world_size() > 1:
        from torch.nn.parallel import DistributedDataParallel

        return DistributedDataParallel(model)
    return model
