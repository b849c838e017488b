"""WorkerGroup: a gang of TrainWorker actors in one placement group.

Port of ``ray_tpu/train/_internal/worker_group.py`` (reference:
python/ray/train/_internal/worker_group.py:102, WorkerGroup of
RayTrainWorker actors; backend_executor.py:230 PACK placement group; :363
rank sorting). GPUs are pinned where the JAX package pins TPU chips: a
worker that asks for GPUs gets them through ``num_gpus`` and sees them as
``CUDA_VISIBLE_DEVICES``. The gang is all-or-nothing; workers are sorted
by (node, position of their GPUs in the node's ``CUDA_VISIBLE_DEVICES``)
so that rank 0 is the rendezvous host and ranks follow the cards' order,
whether the ids are numbers or ``GPU-``/``MIG-`` UUIDs.
"""

from __future__ import annotations

import queue
import threading
import traceback
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional

from ...air.config import ScalingConfig


class GangUnschedulableError(RuntimeError):
    """The worker gang cannot currently be placed (elastic trainers
    react by shrinking; reference: v2 scaling_policy resize decisions)."""


class TrainWorker:
    """Actor hosting one training process's session + train_fn thread."""

    def __init__(self, world_size: int, experiment_name: str):
        self.rank = -1  # assigned at setup_session, after topology sort
        self.world_size = world_size
        self.experiment_name = experiment_name
        self.session = None
        self.thread: Optional[threading.Thread] = None
        self.error: Optional[str] = None
        self.finished = False
        self.final_result: Any = None

    def get_metadata(self) -> Dict[str, Any]:
        import os
        import socket

        from ..._private.accelerators import gpu

        return {
            "pid": os.getpid(),
            # node agents export the (possibly simulated) host identity;
            # node_ip is what rank-0 peers can actually dial for the
            # torch.distributed rendezvous
            "hostname": os.environ.get("RAY_TPU_TORCH_NODE_HOSTNAME")
            or socket.gethostname(),
            "node_ip": os.environ.get("RAY_TPU_TORCH_NODE_IP", "127.0.0.1"),
            # the GPU ids the runtime pinned to this process, and their
            # positions in the list the worker inherited (the driver's on
            # the head, the node agent's elsewhere): ids may be GPU-/MIG-
            # UUIDs, positions are always ints
            "cuda_visible_devices": os.environ.get("CUDA_VISIBLE_DEVICES", ""),
            "gpu_positions": list(gpu.pinned_positions),
        }

    def pick_free_port(self) -> int:
        """Bind-probe a free port (runs on rank 0's host; the coordinator
        binds it immediately after, same pattern as the reference's
        get_address_and_port, train/torch/config.py:66)."""
        import socket

        with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
            s.bind(("", 0))
            return s.getsockname()[1]

    def setup_session(
        self,
        rank: int,
        storage_dir: str,
        latest_checkpoint_path: Optional[str],
        dataset_shards: Optional[Dict[str, Any]] = None,
        start_iteration: int = 0,
        sync_reports: bool = False,
        local_rank: Optional[int] = None,
        local_world_size: Optional[int] = None,
        node_rank: int = 0,
    ) -> None:
        from .._checkpoint import Checkpoint
        from ..session import TrainContext, _TrainSession, _init_session

        self.rank = rank
        ctx = TrainContext(
            world_size=self.world_size,
            world_rank=self.rank,
            local_rank=self.rank if local_rank is None else local_rank,
            local_world_size=(
                self.world_size if local_world_size is None else local_world_size
            ),
            node_rank=node_rank,
            experiment_name=self.experiment_name,
        )
        ckpt = (
            Checkpoint(latest_checkpoint_path) if latest_checkpoint_path else None
        )
        self.session = _TrainSession(
            ctx,
            storage_dir,
            latest_checkpoint=ckpt,
            dataset_shards=dataset_shards,
            start_iteration=start_iteration,
            sync_reports=sync_reports,
        )
        _init_session(self.session)

    def run_backend_hook(self, hook_fn: Callable, *args) -> Any:
        """Run a Backend.on_start/on_shutdown-style callable in-process."""
        return hook_fn(self, *args)

    def start_training(self, train_fn: Callable, config: Dict[str, Any]) -> None:
        if self.session is None:
            raise RuntimeError("setup_session must run before start_training")
        self.finished = False
        self.error = None

        def run():
            try:
                import inspect

                sig = inspect.signature(train_fn)
                self.final_result = (
                    train_fn(config) if len(sig.parameters) >= 1 else train_fn()
                )
            except StopIteration:
                pass  # controller-requested stop
            except Exception:
                self.error = traceback.format_exc()
            finally:
                self.finished = True

        self.thread = threading.Thread(target=run, daemon=True, name="train_fn")
        self.thread.start()

    def poll(self) -> Dict[str, Any]:
        """Drain queued report() results; controller calls this in a loop
        (reference: backend_executor.get_next_results :588)."""
        results = []
        while True:
            try:
                results.append(self.session.result_queue.get_nowait())
            except queue.Empty:
                break
        return {
            "results": results,
            "finished": self.finished,
            "error": self.error,
            "final_result": self.final_result if self.finished else None,
        }

    def request_stop(self) -> None:
        if self.session:
            self.session.stop_requested.set()

    def shutdown_session(self) -> None:
        from ..session import _shutdown_session

        _shutdown_session()


@dataclass
class WorkerHandle:
    actor: Any
    rank: int
    metadata: Dict[str, Any]


class WorkerGroup:
    """Creates/destroys the actor gang (reference worker_group.py:102)."""

    def __init__(self, scaling_config: ScalingConfig, experiment_name: str):
        self.scaling_config = scaling_config
        self.experiment_name = experiment_name
        self.workers: List[WorkerHandle] = []
        self._pg = None

    def start(self) -> None:
        import ray_tpu_torch
        from ...util.placement_group import placement_group

        sc = self.scaling_config
        bundles = [
            sc._resources_per_worker_not_none() for _ in range(sc.num_workers)
        ]
        self._pg = placement_group(bundles, strategy=sc.placement_strategy)
        if not self._pg.wait(timeout_seconds=sc.placement_timeout_s):
            from ...util.placement_group import remove_placement_group

            remove_placement_group(self._pg)
            raise GangUnschedulableError(
                f"placement group for {sc.num_workers} train workers "
                f"({bundles[0]} each) not schedulable on this cluster"
            )
        from ...util.scheduling_strategies import PlacementGroupSchedulingStrategy

        worker_cls = ray_tpu_torch.remote(TrainWorker)
        res = sc._resources_per_worker_not_none()
        opts: Dict[str, Any] = {"num_cpus": res.get("CPU", 1)}
        if res.get("TPU"):
            opts["num_tpus"] = res["TPU"]
        if res.get("GPU"):
            opts["num_gpus"] = res["GPU"]
        extra = {
            k: v for k, v in res.items() if k not in ("CPU", "TPU", "GPU", "memory")
        }
        if extra:
            opts["resources"] = extra
        actors = [
            worker_cls.options(
                scheduling_strategy=PlacementGroupSchedulingStrategy(
                    placement_group=self._pg, placement_group_bundle_index=i
                ),
                **opts,
            ).remote(sc.num_workers, self.experiment_name)
            for i in range(sc.num_workers)
        ]
        metas = ray_tpu_torch.get([a.get_metadata.remote() for a in actors])
        # sort by (hostname, GPU positions) so ranks follow the order of
        # each host's CUDA_VISIBLE_DEVICES, whatever form its ids take
        order = sorted(
            range(len(actors)),
            key=lambda i: (metas[i]["hostname"], metas[i]["gpu_positions"]),
        )
        self.workers = [
            WorkerHandle(actor=actors[j], rank=new_rank, metadata=metas[j])
            for new_rank, j in enumerate(order)
        ]

    def execute(self, method: str, *args, **kwargs) -> List[Any]:
        """Call a TrainWorker method on every worker, gather results."""
        import ray_tpu_torch

        refs = [
            getattr(w.actor, method).remote(*args, **kwargs) for w in self.workers
        ]
        return ray_tpu_torch.get(refs)

    def execute_async(self, method: str, *args, **kwargs) -> List[Any]:
        return [
            getattr(w.actor, method).remote(*args, **kwargs) for w in self.workers
        ]

    def shutdown(self) -> None:
        import ray_tpu_torch
        from ...util.placement_group import remove_placement_group

        for w in self.workers:
            try:
                ray_tpu_torch.kill(w.actor)
            except Exception:
                pass
        self.workers = []
        if self._pg is not None:
            try:
                remove_placement_group(self._pg)
            except Exception:
                pass
            self._pg = None

    def __len__(self) -> int:
        return len(self.workers)
