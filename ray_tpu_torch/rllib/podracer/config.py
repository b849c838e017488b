"""PodracerConfig: one fluent builder for both Podracer layouts.

Port of ``ray_tpu/rllib/podracer/config.py``. Hyperparameter fields
duck-type ``IMPALAConfig``/``APPOConfig`` so the learner reuses
``make_impala_loss``/``make_appo_loss`` verbatim — the Podracer subsystem
adds topology, not a new RL algorithm. ``device`` is the port's: None
runs Anakin's worker and Sebulba's learner on the GPU (and raises where
the cluster has none), "cpu" runs everything on the CPU.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional, Tuple

from ..core import MLPSpec
from .torch_env import get_torch_env

MODES = ("anakin", "sebulba")
LOSSES = ("vtrace", "appo")


@dataclass
class PodracerConfig:
    mode: str = "anakin"
    env: str = "CartPole-v1"

    # -- learner hyperparams (IMPALA/APPO duck-type surface) ----------
    lr: float = 5e-3
    gamma: float = 0.99
    vtrace_clip_rho: float = 1.0
    vtrace_clip_c: float = 1.0
    vf_loss_coeff: float = 0.5
    entropy_coeff: float = 0.01
    grad_clip: float = 1.0
    clip_param: float = 0.3  # read only when loss == "appo"
    loss: str = "vtrace"
    hiddens: Tuple[int, ...] = (32, 32)
    seed: int = 0
    rollout_fragment_length: int = 16  # T: env steps per superstep/fragment

    # -- anakin topology ----------------------------------------------
    num_envs: int = 64  # total vectorized envs, sharded over the mesh
    anakin_num_devices: Optional[int] = None  # None -> every GPU of the cluster (1 on CPU)
    anakin_supersteps_per_call: int = 1  # supersteps per resident-loop tick
    use_compiled_dag: bool = True  # False: plain actor calls (debug path)

    # -- sebulba topology ---------------------------------------------
    num_actors: int = 2
    envs_per_actor: int = 16
    learner_shards: int = 1  # devices in the learner collective group
    num_sgd_steps: int = 1  # learner SGD passes over each round's batch
    param_sync_interval: int = 1  # publish params every k learner steps
    max_inflight_rounds: int = 2  # actor rounds racing ahead of the learner
    placement_strategy: Optional[str] = None  # None -> SLICE with enough GPUs, else PACK
    namespace: str = "default"  # isolates the version-tagged param channel

    # -- the port's device: None -> the GPU, "cpu" -> the CPU -----------
    device: Optional[str] = None

    # -- fluent builders (rllib AlgorithmConfig idiom) ----------------
    def environment(self, env: str) -> "PodracerConfig":
        self.env = env
        return self

    def podracer(self, *, mode=None, num_envs=None, anakin_num_devices=None,
                 anakin_supersteps_per_call=None, use_compiled_dag=None,
                 learner_shards=None, param_sync_interval=None,
                 max_inflight_rounds=None, num_sgd_steps=None,
                 placement_strategy=None, namespace=None) -> "PodracerConfig":
        for k, v in (
            ("mode", mode), ("num_envs", num_envs),
            ("anakin_num_devices", anakin_num_devices),
            ("anakin_supersteps_per_call", anakin_supersteps_per_call),
            ("use_compiled_dag", use_compiled_dag),
            ("learner_shards", learner_shards),
            ("param_sync_interval", param_sync_interval),
            ("max_inflight_rounds", max_inflight_rounds),
            ("num_sgd_steps", num_sgd_steps),
            ("placement_strategy", placement_strategy),
            ("namespace", namespace),
        ):
            if v is not None:
                setattr(self, k, v)
        return self

    def env_runners(self, *, num_actors=None, envs_per_actor=None,
                    rollout_fragment_length=None) -> "PodracerConfig":
        if num_actors is not None:
            self.num_actors = num_actors
        if envs_per_actor is not None:
            self.envs_per_actor = envs_per_actor
        if rollout_fragment_length is not None:
            self.rollout_fragment_length = rollout_fragment_length
        return self

    def training(self, **kwargs) -> "PodracerConfig":
        for k, v in kwargs.items():
            if not hasattr(self, k):
                raise ValueError(f"unknown Podracer training param {k!r}")
            setattr(self, k, v)
        return self

    def debugging(self, *, seed=None) -> "PodracerConfig":
        if seed is not None:
            self.seed = seed
        return self

    # -- derived ------------------------------------------------------
    @property
    def env_cls(self):
        return get_torch_env(self.env)

    @property
    def spec(self) -> MLPSpec:
        env_cls = self.env_cls
        return MLPSpec(
            obs_dim=env_cls.obs_dim,
            num_actions=env_cls.num_actions,
            hiddens=tuple(self.hiddens),
        )

    def validate(self) -> None:
        if self.mode not in MODES:
            raise ValueError(f"mode must be one of {MODES}, got {self.mode!r}")
        if self.loss not in LOSSES:
            raise ValueError(f"loss must be one of {LOSSES}, got {self.loss!r}")
        if self.mode == "sebulba":
            total = self.num_actors * self.envs_per_actor
            if total % max(1, self.learner_shards) != 0:
                raise ValueError(
                    f"num_actors*envs_per_actor ({total}) must divide evenly "
                    f"over learner_shards ({self.learner_shards})"
                )
        self.env_cls  # raises on unknown env

    def build(self):
        """Instantiate the driver for the selected mode."""
        self.validate()
        if self.mode == "anakin":
            from .anakin import AnakinDriver

            return AnakinDriver(self)
        from .sebulba import SebulbaDriver

        return SebulbaDriver(self)

    build_algo = build
