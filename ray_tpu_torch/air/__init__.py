"""ray_tpu_torch.air — shared configs and results for Train.

Port of ``ray_tpu/air`` (reference: python/ray/air/, config.py:103
ScalingConfig, :398 FailureConfig, :448 CheckpointConfig, :597 RunConfig;
Result in air/result.py). ScalingConfig's ``use_gpu`` pins GPUs to the
workers, where the JAX package's ``use_tpu`` pins TPU chips.
"""

from .config import (
    CheckpointConfig,
    FailureConfig,
    RunConfig,
    ScalingConfig,
)
from .result import Result

__all__ = [
    "CheckpointConfig",
    "FailureConfig",
    "RunConfig",
    "ScalingConfig",
    "Result",
]
