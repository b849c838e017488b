"""ray_tpu_torch.rllib — reinforcement learning, on torch (the port of
``ray_tpu/rllib``).

Parity: python/ray/rllib/ core shape (AlgorithmConfig builder →
Algorithm.train(); EnvRunner actor fan-out; a Learner update on the
learner's device). PPO (sync batch) + IMPALA (async actor-learner with
V-trace) + APPO, DQN, SAC, the offline learners BC, MARWIL and CQL,
multi-agent PPO, and the Podracer layouts (Anakin/Sebulba,
``podracer/``). Learners run on the GPU unless a config asks for
``device="cpu"``; without a GPU they raise. Env runners act on the CPU.
"""

from .algorithm import Algorithm
from .appo import APPO, APPOConfig
from .bc import BC, BCConfig
from .connectors import (
    ConnectorPipelineV2,
    ConnectorV2,
    FlattenObservations,
    FrameStackObservations,
    NormalizeObservations,
)
from .core import MLPSpec, forward, init_mlp_module, sample_actions
from .cql import CQL, CQLConfig
from .env_runner import SingleAgentEnvRunner
from .dqn import DQN, DQNConfig
from .impala import IMPALA, IMPALAConfig, vtrace
from .marwil import MARWIL, MARWILConfig
from .multi_agent import (
    MultiAgentAlgorithm,
    MultiAgentEnv,
    MultiAgentEnvRunner,
    MultiAgentEpisode,
    make_multi_agent,
)
from .replay_buffers import PrioritizedReplayBuffer, ReplayBuffer
from .podracer import PodracerConfig
from .ppo import PPOConfig
from .sac import SAC, SACConfig

__all__ = [
    "Algorithm",
    "ConnectorPipelineV2",
    "ConnectorV2",
    "FlattenObservations",
    "FrameStackObservations",
    "NormalizeObservations",
    "APPO",
    "APPOConfig",
    "BC",
    "BCConfig",
    "CQL",
    "CQLConfig",
    "DQN",
    "DQNConfig",
    "IMPALA",
    "IMPALAConfig",
    "MARWIL",
    "MARWILConfig",
    "MLPSpec",
    "MultiAgentAlgorithm",
    "MultiAgentEnv",
    "MultiAgentEnvRunner",
    "MultiAgentEpisode",
    "make_multi_agent",
    "PodracerConfig",
    "PPOConfig",
    "SAC",
    "SACConfig",
    "SingleAgentEnvRunner",
    "forward",
    "init_mlp_module",
    "sample_actions",
    "vtrace",
    "ReplayBuffer",
    "PrioritizedReplayBuffer",
]

from .._private import usage as _usage

_usage.record_library_usage("rllib")
