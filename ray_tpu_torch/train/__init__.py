"""ray_tpu_torch.train — distributed training on gangs of GPU workers.

Port of ``ray_tpu/train`` (reference: python/ray/train/, v2 controller
shape). Public surface: TorchTrainer / DataParallelTrainer,
report/get_context/get_checkpoint/get_dataset_shard, Checkpoint,
ScalingConfig/RunConfig/FailureConfig/CheckpointConfig, Result,
Backend/BackendConfig/TorchConfig. The JAX package's ``JaxTrainer`` and
``JaxConfig`` map onto ``TorchTrainer`` and ``TorchConfig`` (``MAPPED``).

A loop on one GPU-pinned worker, with a checkpoint to resume from::

    from ray_tpu_torch import parallel, train

    def loop(config):
        state = make_state()                      # parallel.create_train_state
        ckpt = train.get_checkpoint()
        if ckpt is not None:
            state = ckpt.to_torch(target=state)
        for _ in range(state.step, config["steps"]):
            state, m = step(state, batch)         # parallel.make_train_step
            train.report({"loss": m["loss"].item()},
                         checkpoint=train.Checkpoint.from_torch(state))

    result = train.TorchTrainer(
        loop, train_loop_config={"steps": 4},
        scaling_config=train.ScalingConfig(num_workers=1, use_gpu=True),
        run_config=train.RunConfig(failure_config=train.FailureConfig(max_failures=1)),
    ).fit()
"""

from ..air.config import (
    CheckpointConfig,
    FailureConfig,
    RunConfig,
    ScalingConfig,
)
from ..air.result import Result
from ._checkpoint import Checkpoint
from .backend import Backend, BackendConfig
from .data_parallel_trainer import DataParallelTrainer, TrainingFailedError
from .torch_trainer import TorchConfig, TorchTrainer
from .session import (
    TrainContext,
    get_checkpoint,
    get_context,
    get_dataset_shard,
    report,
)

# names of the JAX package's train library that stand for JAX, and their places here
MAPPED = {"JaxTrainer": "TorchTrainer", "JaxConfig": "TorchConfig"}

__all__ = [
    "Backend",
    "BackendConfig",
    "Checkpoint",
    "CheckpointConfig",
    "DataParallelTrainer",
    "FailureConfig",
    "TorchConfig",
    "TorchTrainer",
    "Result",
    "RunConfig",
    "ScalingConfig",
    "TrainContext",
    "TrainingFailedError",
    "get_checkpoint",
    "get_context",
    "get_dataset_shard",
    "report",
]

from .._private import usage as _usage

_usage.record_library_usage("train")
