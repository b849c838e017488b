"""EnvRunner: rollout-collection actors.

Port of ``ray_tpu/rllib/env_runner.py``. Parity:
python/ray/rllib/env/single_agent_env_runner.py + env_runner_group.py:71
— actors own gymnasium vector envs, receive policy weights (numpy) each
iteration, and return fixed-length rollout batches (the async actor
fan-out pattern). The runners act on the CPU (``sample_actions`` on host
tensors, the noise from a generator seeded per fragment); rollouts are
plain numpy so the learner can move them straight onto its device.
"""

from __future__ import annotations

from collections import deque
from typing import Any, Callable, Dict, List, Optional, Union

import numpy as np


def substitute_final_obs(next_obs, term, trunc, infos) -> np.ndarray:
    """SAME_STEP autoreset returns the NEW episode's reset obs at done
    steps; replay-style transitions must store the true final obs
    (infos["final_obs"]) or the critic bootstraps into an unrelated
    state. Shared by the DQN and SAC runners."""
    final_obs = infos.get("final_obs")
    if final_obs is None:
        return next_obs
    done_idx = np.nonzero(np.logical_or(term, trunc))[0]
    if not len(done_idx):
        return next_obs
    out = next_obs.copy()
    for i in done_idx:
        if final_obs[i] is not None:
            out[i] = np.asarray(final_obs[i])
    return out


def merge_return_windows(latest_windows: Dict[int, list]) -> list:
    """Per-runner last-100 windows are cumulative: keep only the newest
    per runner (the dict values) and concat across runners — extending
    every round would double-count episodes."""
    return [r for window in latest_windows.values() for r in window]


class SingleAgentEnvRunner:
    def __init__(
        self,
        env_creator: Union[str, Callable],
        num_envs: int = 1,
        seed: Optional[int] = None,
        rollout_fragment_length: int = 128,
        gamma: float = 0.99,
    ):
        import gymnasium as gym

        if isinstance(env_creator, str):
            env_id = env_creator
            fns = [lambda: gym.make(env_id) for _ in range(num_envs)]
        else:
            fns = [env_creator for _ in range(num_envs)]
        # SAME_STEP autoreset: a done step immediately returns the reset
        # obs, with the true final obs in infos — so every recorded
        # transition is real. (gymnasium >=1.0 defaults to NEXT_STEP,
        # which inserts a filler transition per episode end that would
        # corrupt PPO's batch.)
        self.envs = gym.vector.SyncVectorEnv(
            fns, autoreset_mode=gym.vector.AutoresetMode.SAME_STEP
        )
        self.num_envs = num_envs
        self.fragment = rollout_fragment_length
        self.gamma = gamma
        self.rng = np.random.default_rng(seed)
        self.obs, _ = self.envs.reset(seed=seed)
        # episode-return bookkeeping
        self._ep_returns = np.zeros(num_envs)
        self._ep_lens = np.zeros(num_envs, dtype=np.int64)
        # trailing window only; a plain list leaks for the runner's
        # lifetime (GL005)
        self.completed_returns: deque = deque(maxlen=100)

    def obs_space_dim(self) -> int:
        return int(np.prod(self.envs.single_observation_space.shape))

    def num_actions(self) -> int:
        return int(self.envs.single_action_space.n)

    def sample(self, params: Dict[str, Any], rng_seed: int) -> Dict[str, np.ndarray]:
        """Collect one fragment with the given policy weights (numpy).
        Returns time-major batch {obs, actions, rewards, dones, logp,
        values, final_obs} + episode stats."""
        import torch

        from .core import params_from_numpy, sample_actions, values_only

        params = params_from_numpy(params, "cpu")
        gen = torch.Generator().manual_seed(rng_seed)
        T, N = self.fragment, self.num_envs
        obs_buf = np.zeros((T, N) + self.envs.single_observation_space.shape, np.float32)
        act_buf = np.zeros((T, N), np.int64)
        rew_buf = np.zeros((T, N), np.float32)
        done_buf = np.zeros((T, N), np.float32)
        logp_buf = np.zeros((T, N), np.float32)
        val_buf = np.zeros((T, N), np.float32)

        obs = self.obs
        recent_returns: list = []
        for t in range(T):
            actions, logp, value = sample_actions(
                params, torch.from_numpy(obs.astype(np.float32)), gen
            )
            actions = actions.numpy()
            next_obs, rewards, term, trunc, infos = self.envs.step(actions)
            done = np.logical_or(term, trunc)
            rewards = np.asarray(rewards, np.float32).copy()
            # episode stats must see the RAW env rewards — the truncation
            # bootstrap below is a learning-signal adjustment only and
            # must not inflate episode_return_mean
            raw_rewards = rewards.copy()
            # time-limit truncation is NOT termination: bootstrap the
            # cut-off return from V(final_obs) (standard PPO truncation
            # handling; the GAE then treats the step as terminal)
            if np.any(trunc):
                final_obs = infos.get("final_obs")
                idx = np.nonzero(trunc)[0]
                fo = np.stack(
                    [
                        np.asarray(
                            final_obs[i]
                            if final_obs is not None and final_obs[i] is not None
                            else next_obs[i],
                            np.float32,
                        ).reshape(-1)
                        for i in idx
                    ]
                )
                v_fin = values_only(params, torch.from_numpy(fo)).numpy()
                rewards[idx] += self.gamma * v_fin
            obs_buf[t] = obs
            act_buf[t] = actions
            rew_buf[t] = rewards
            done_buf[t] = done
            logp_buf[t] = logp.numpy()
            val_buf[t] = value.numpy()
            # track episode returns (vector env auto-resets)
            self._ep_returns += raw_rewards
            self._ep_lens += 1
            for i in np.nonzero(done)[0]:
                self.completed_returns.append(float(self._ep_returns[i]))
                recent_returns.append(float(self._ep_returns[i]))
                self._ep_returns[i] = 0.0
                self._ep_lens[i] = 0
            obs = next_obs
        self.obs = obs
        stats_returns = list(self.completed_returns)
        return {
            "obs": obs_buf,
            "actions": act_buf,
            "rewards": rew_buf,
            "dones": done_buf,
            "logp": logp_buf,
            "values": val_buf,
            "final_obs": obs.astype(np.float32),
            "episode_returns": np.asarray(stats_returns, np.float32),
            # episodes completed during THIS fragment only. The window
            # above is a trailing deque(maxlen=100): until 100 episodes
            # have finished it is a LIFETIME mean that still contains
            # the random policy's first episodes, so it lags actual
            # learning by many iterations — short-horizon callers
            # (tests, early-stopping) should read this key instead.
            "episode_returns_recent": np.asarray(recent_returns, np.float32),
        }
