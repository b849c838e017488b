"""Algorithm: the RL training driver.

Port of ``ray_tpu/rllib/algorithm.py``. Parity:
python/ray/rllib/algorithms/algorithm.py (training_step :2038): each
train() iteration fans rollout collection out to the EnvRunner actors
(on the CPU), runs the learner update on the concatenated batch on the
driver's device (the GPU unless ``device="cpu"``; without one it
raises), and broadcasts fresh weights as numpy. Checkpointable
(save/restore of params + optimizer state), mirroring the reference's
Checkpointable mixin.
"""

from __future__ import annotations

import os
import pickle
from typing import Any, Dict

import numpy as np
import torch


class Algorithm:
    def __init__(self, config):
        import ray_tpu_torch

        from .._private.device import resolve_device
        from .core import MLPSpec, init_mlp_module
        from .env_runner import SingleAgentEnvRunner
        from .ppo import make_ppo_update

        if config.env is None:
            raise ValueError("config.environment(env) is required")
        self.device = resolve_device(config.device)
        if not ray_tpu_torch.is_initialized():
            ray_tpu_torch.init(ignore_reinit_error=True)
        self.config = config

        env = config.env
        env_config = getattr(config, "env_config", None)
        if env_config and callable(env) and not isinstance(env, str):
            # close the env_config over the creator — the runner calls
            # creators with no arguments
            creator, cfg = env, dict(env_config)
            env = lambda: creator(cfg)  # noqa: E731
        runner_cls = ray_tpu_torch.remote(SingleAgentEnvRunner)
        self.env_runners = [
            runner_cls.remote(
                env,
                config.num_envs_per_env_runner,
                config.seed + 1000 * i,
                config.rollout_fragment_length,
                config.gamma,
            )
            for i in range(config.num_env_runners)
        ]
        obs_dim = ray_tpu_torch.get(self.env_runners[0].obs_space_dim.remote())
        num_actions = ray_tpu_torch.get(self.env_runners[0].num_actions.remote())
        self.spec = MLPSpec(obs_dim, num_actions, tuple(config.hiddens))
        self.params = init_mlp_module(
            torch.Generator().manual_seed(config.seed), self.spec, self.device)
        self.optimizer, self._update = make_ppo_update(config, self.spec)
        self.opt_state = self.optimizer.init(self.params)
        # the minibatch permutations' generator (the reference's rng key)
        self._gen = torch.Generator().manual_seed(config.seed + 1)
        self.iteration = 0
        self._timesteps = 0

    # ------------------------------------------------------------------
    def train(self) -> Dict[str, Any]:
        """One training iteration (reference: Algorithm.train)."""
        import ray_tpu_torch

        from .core import params_to_numpy

        host_params = params_to_numpy(self.params)
        rollouts = ray_tpu_torch.get(
            [
                r.sample.remote(host_params, self.config.seed + self.iteration * 97 + i)
                for i, r in enumerate(self.env_runners)
            ]
        )
        # concat across runners on the env axis (time-major T, N)
        batch = {
            k: np.concatenate([ro[k] for ro in rollouts], axis=1)
            for k in ("obs", "actions", "rewards", "dones", "logp", "values")
        }
        batch["obs"] = batch["obs"].reshape(
            batch["obs"].shape[0], batch["obs"].shape[1], -1
        )
        batch["final_obs"] = np.concatenate(
            [ro["final_obs"].reshape(ro["final_obs"].shape[0], -1) for ro in rollouts],
            axis=0,
        )
        n = batch["actions"].size
        perms = torch.stack([torch.randperm(n, generator=self._gen)
                             for _ in range(self.config.num_epochs)])
        self.params, self.opt_state, metrics = self._update(
            self.params, self.opt_state, batch, perms
        )
        self.iteration += 1
        self._timesteps += int(n)
        ep_returns = np.concatenate(
            [ro["episode_returns"] for ro in rollouts]
        )
        # lag-free learning signal: only the episodes that finished
        # during this iteration's fragments (episode_return_mean is a
        # trailing-100 window that doubles as a lifetime mean early on)
        recent = np.concatenate(
            [
                ro.get("episode_returns_recent", np.zeros(0, np.float32))
                for ro in rollouts
            ]
        )
        result = {
            "training_iteration": self.iteration,
            "num_env_steps_sampled_lifetime": self._timesteps,
            "episode_return_mean": float(ep_returns.mean()) if len(ep_returns) else float("nan"),
            "num_episodes": int(len(ep_returns)),
            "episode_return_recent_mean": (
                float(recent.mean()) if len(recent) else float("nan")
            ),
            "num_episodes_recent": int(len(recent)),
        }
        result.update({k: float(v) for k, v in metrics.items()})
        return result

    # ------------------------------------------------------------------
    def compute_single_action(self, obs) -> int:
        from .core import forward

        obs = torch.as_tensor(np.asarray(obs, np.float32), device=self.device)
        with torch.no_grad():
            logits, _ = forward(self.params, obs[None])
        return int(torch.argmax(logits[0]))

    def save(self, checkpoint_dir: str) -> str:
        from .core import params_to_numpy

        os.makedirs(checkpoint_dir, exist_ok=True)
        state = {
            "params": params_to_numpy(self.params),
            "opt_state": params_to_numpy(self.opt_state),
            "iteration": self.iteration,
            "timesteps": self._timesteps,
        }
        with open(os.path.join(checkpoint_dir, "algorithm_state.pkl"), "wb") as f:
            pickle.dump(state, f)
        return checkpoint_dir

    def restore(self, checkpoint_dir: str) -> None:
        from .core import params_from_numpy

        with open(os.path.join(checkpoint_dir, "algorithm_state.pkl"), "rb") as f:
            state = pickle.load(f)
        self.params = params_from_numpy(state["params"], self.device)
        self.opt_state = params_from_numpy(state["opt_state"], self.device)
        self.iteration = state["iteration"]
        self._timesteps = state["timesteps"]

    def stop(self) -> None:
        import ray_tpu_torch

        for r in self.env_runners:
            try:
                ray_tpu_torch.kill(r)
            except Exception:
                pass
        self.env_runners = []
