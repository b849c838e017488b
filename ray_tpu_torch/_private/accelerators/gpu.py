"""GPUAcceleratorManager: NVIDIA GPUs as the pinned accelerator
(counterpart of ``ray_tpu/_private/accelerators/tpu.py``; reference:
python/ray/_private/accelerators/nvidia_gpu.py).

Detection never initialises CUDA in the driver: a CUDA context made
there before the workers fork would hold memory on every card and fix
the driver's own ``CUDA_VISIBLE_DEVICES``. The count comes, in order,
from ``RAY_TPU_TORCH_NUM_GPUS`` (the override, as ``RAY_TPU_NUM_TPUS`` is
the reference's), from a ``CUDA_VISIBLE_DEVICES`` the process was given,
and from ``nvidia-smi -L``. The manager reports no chip coordinates, so
the ICI placement code of the hub stays inert.
"""

from __future__ import annotations

import os
import subprocess
from typing import List, Optional

from .accelerator import AcceleratorManager

ENV_NUM_GPUS = "RAY_TPU_TORCH_NUM_GPUS"
VISIBLE_ENV = "CUDA_VISIBLE_DEVICES"

# positions, in the CUDA_VISIBLE_DEVICES list this process inherited from
# its driver or node agent, of the GPUs the runtime pinned to it (set by
# the worker when it pins; the hub's GPU ids are these positions)
pinned_positions: List[int] = []


def nvidia_smi_names(timeout: float = 10.0) -> List[str]:
    """The names of the node's GPUs as ``nvidia-smi -L`` lists them (none
    where it is missing or fails)."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "-L"], capture_output=True, text=True, timeout=timeout
        )
    except (OSError, subprocess.SubprocessError):
        return []
    if out.returncode != 0:
        return []
    # "GPU 0: NVIDIA H100 80GB HBM3 (UUID: GPU-...)"
    return [line.split(":", 1)[1].rsplit(" (UUID", 1)[0].strip()
            for line in out.stdout.splitlines() if line.startswith("GPU ")]


def visible_ids(value: Optional[str]) -> Optional[List[str]]:
    """Parse a ``CUDA_VISIBLE_DEVICES`` value; None when it is unset."""
    if value is None:
        return None
    return [v.strip() for v in value.split(",") if v.strip()]


class GPUAcceleratorManager(AcceleratorManager):
    @staticmethod
    def get_resource_name() -> str:
        return "GPU"

    @staticmethod
    def get_visible_accelerator_ids_env_var() -> str:
        return VISIBLE_ENV

    @staticmethod
    def get_current_node_num_accelerators() -> int:
        env = os.environ.get(ENV_NUM_GPUS)
        if env is not None:
            return int(env)
        visible = visible_ids(os.environ.get(VISIBLE_ENV))
        if visible is not None:
            return len(visible)
        return len(nvidia_smi_names())

    @staticmethod
    def get_current_node_accelerator_type() -> Optional[str]:
        return None

    @staticmethod
    def set_current_process_visible_accelerators(ids: List[str]) -> None:
        os.environ[VISIBLE_ENV] = ",".join(str(i) for i in ids)
