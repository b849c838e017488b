"""Podracer architectures (Hessel et al. 2021): Anakin & Sebulba, on
torch (the port of ``ray_tpu/rllib/podracer``).

Two RL layouts behind one ``PodracerConfig``:

- **Anakin** — environment step and learner update run back to back on
  the worker's card (batched torch envs, the acting loop feeding the
  gradient step), driven by a compiled-DAG resident exec loop so the
  host never re-dispatches per step.
- **Sebulba** — actor workers and a learner gang-placed on separate
  bundles; trajectory hand-off rides ``fn.map`` bulk submission and the
  direct object plane (rollout batches never relay through the hub),
  the learner averages gradients over an NCCL collective group, and
  parameters broadcast back on a version-tagged KV channel.

Both run on the GPU unless ``device="cpu"`` is asked, and end to end on
the CPU with it. ``MAPPED`` names the reference's env names' counterparts.
"""

from .config import PodracerConfig
from .torch_env import TorchCartPole, get_torch_env, register_torch_env
from .anakin import AnakinDriver
from .sebulba import SebulbaDriver

# the reference's names -> their counterparts here
MAPPED = {"JaxCartPole": "TorchCartPole", "get_jax_env": "get_torch_env",
          "register_jax_env": "register_torch_env", "jax_env": "torch_env",
          "JAX_ENVS": "TORCH_ENVS"}

__all__ = [
    "PodracerConfig",
    "TorchCartPole",
    "get_torch_env",
    "register_torch_env",
    "AnakinDriver",
    "SebulbaDriver",
]
