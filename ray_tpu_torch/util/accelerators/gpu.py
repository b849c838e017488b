"""Public GPU node helpers.

The counterpart of ``ray_tpu/util/accelerators/tpu.py`` (reference:
python/ray/util/accelerators/tpu.py:7-33, over TPUAcceleratorManager):
the node's GPU count and card name, from what the runtime's
``GPUAcceleratorManager`` detects, without making a CUDA context. The
TPU module's pod helpers (pod name, worker count) have no GPU meaning:
one host's cards are the unit here.
"""

from __future__ import annotations

from typing import Optional

from ..._private.accelerators import gpu as _gpu


def get_num_gpus_on_node() -> int:
    """GPUs on this node: ``RAY_TPU_TORCH_NUM_GPUS``, else the length of
    ``CUDA_VISIBLE_DEVICES``, else what ``nvidia-smi -L`` lists."""
    return _gpu.GPUAcceleratorManager.get_current_node_num_accelerators()


def get_accelerator_type() -> Optional[str]:
    """The node's card, e.g. "NVIDIA H100 80GB HBM3": the first GPU
    ``nvidia-smi -L`` lists, None where it lists none."""
    names = _gpu.nvidia_smi_names()
    return names[0] if names else None
