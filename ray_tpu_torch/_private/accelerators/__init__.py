"""Accelerator managers (reference: python/ray/_private/accelerators/).

The registry the runtime consults at node start to detect local
accelerators, derive their resource entries, and pin visibility for
workers. The port registers the NVIDIA GPU manager where the reference
registers its TPU manager; the ABC matches the reference's
AcceleratorManager surface.
"""

from .accelerator import AcceleratorManager
from .gpu import GPUAcceleratorManager

_MANAGERS = [GPUAcceleratorManager]


def get_all_accelerator_managers():
    return list(_MANAGERS)


def detect_resources() -> dict:
    """Aggregate resource entries from every manager that detects
    hardware (called by ray_tpu_torch.init / node agents)."""
    out: dict = {}
    for mgr in _MANAGERS:
        n = mgr.get_current_node_num_accelerators()
        if n <= 0:
            continue
        out[mgr.get_resource_name()] = float(n)
        acc_type = mgr.get_current_node_accelerator_type()
        if acc_type:
            # accelerator_type + pod-name resources for gang affinity
            # (reference: tpu.py:352,375)
            out[f"accelerator_type:{acc_type}"] = 1.0
        extra = mgr.get_current_node_additional_resources()
        if extra:
            out.update(extra)
    return out


__all__ = [
    "AcceleratorManager",
    "GPUAcceleratorManager",
    "detect_resources",
    "get_all_accelerator_managers",
]
