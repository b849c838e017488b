"""DQN: off-policy Q-learning with replay + target network.

Port of ``ray_tpu/rllib/dqn.py``. Parity: python/ray/rllib/algorithms/
dqn/ (double-DQN defaults) — EnvRunner actors (on the CPU) collect
epsilon-greedy transitions into a ReplayBuffer; the learner does
double-Q targets against a periodically-synced target network. The
minibatch update (target calc, Huber loss, clip and Adam) runs on the
learner's device (the GPU unless ``device="cpu"``); the buffer stays in
host numpy (random access) and only sampled minibatches reach the
device.
"""

from __future__ import annotations

from collections import deque
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Tuple, Union

import numpy as np
import torch

from .core import (
    MLPSpec,
    adam,
    dense,
    device_of,
    params_from_numpy,
    params_to_numpy,
    take_along,
    to_tensors,
    tree_map,
    value_and_grad,
)
from .replay_buffers import ReplayBuffer


@dataclass
class DQNConfig:
    env: Optional[Union[str, Callable]] = None
    num_env_runners: int = 1
    num_envs_per_env_runner: int = 2
    rollout_fragment_length: int = 32
    lr: float = 1e-3
    gamma: float = 0.99
    buffer_capacity: int = 50_000
    train_batch_size: int = 64
    num_steps_sampled_before_learning_starts: int = 500
    target_network_update_freq: int = 200  # learner updates between syncs
    updates_per_iteration: int = 32  # sample rounds per train()
    train_intensity: int = 8  # gradient updates per sample round (the
    # replay ratio lever; reference: training_intensity)
    epsilon_start: float = 1.0
    epsilon_end: float = 0.05
    epsilon_decay_steps: int = 4000
    double_q: bool = True
    grad_clip: float = 10.0
    hiddens: Tuple[int, ...] = (64, 64)
    seed: int = 0
    device: Optional[str] = None  # the learner's; None: the GPU

    def environment(self, env) -> "DQNConfig":
        self.env = env
        return self

    def env_runners(self, *, num_env_runners=None, num_envs_per_env_runner=None,
                    rollout_fragment_length=None) -> "DQNConfig":
        if num_env_runners is not None:
            self.num_env_runners = num_env_runners
        if num_envs_per_env_runner is not None:
            self.num_envs_per_env_runner = num_envs_per_env_runner
        if rollout_fragment_length is not None:
            self.rollout_fragment_length = rollout_fragment_length
        return self

    def training(self, **kwargs) -> "DQNConfig":
        for k, v in kwargs.items():
            if not hasattr(self, k):
                raise ValueError(f"unknown DQN training param {k!r}")
            setattr(self, k, v)
        return self

    def debugging(self, *, seed=None) -> "DQNConfig":
        if seed is not None:
            self.seed = seed
        return self

    def build_algo(self) -> "DQN":
        return DQN(self)

    build = build_algo


def _init_q_net(generator: torch.Generator, spec: MLPSpec, device):
    import math

    layers = []
    fan_in = spec.obs_dim
    for h in spec.hiddens:
        layers.append(dense(generator, fan_in, h, math.sqrt(2.0), device))
        fan_in = h
    return {"torso": layers, "head": dense(generator, fan_in, spec.num_actions, 1.0, device)}


def _q_values(params, obs):
    x = obs
    for layer in params["torso"]:
        x = torch.relu(x @ layer["w"] + layer["b"])
    return x @ params["head"]["w"] + params["head"]["b"]


def double_q_target(params, target_params, batch, *, gamma: float,
                    double_q: bool = True):
    """Bellman target shared by DQN and CQL: online net selects, target
    net evaluates (or plain max), no gradient through it."""
    with torch.no_grad():
        q_next_target = _q_values(target_params, batch["next_obs"])
        if double_q:
            next_a = torch.argmax(_q_values(params, batch["next_obs"]), 1)
            q_next = take_along(q_next_target, next_a)
        else:
            q_next = torch.amax(q_next_target, 1)
        return batch["rewards"] + gamma * (1.0 - batch["dones"]) * q_next


def huber_loss(x: torch.Tensor, delta: float = 1.0) -> torch.Tensor:
    """optax.huber_loss(x): 0.5 q^2 + delta (|x| - q), q = min(|x|, delta)."""
    abs_x = torch.abs(x)
    quadratic = torch.clamp(abs_x, max=delta)
    return 0.5 * quadratic ** 2 + delta * (abs_x - quadratic)


def make_dqn_update(config: DQNConfig, spec: MLPSpec):
    """(optimizer, update): ``update(params, target_params, opt_state,
    batch) -> (params, opt_state, loss, td)``."""
    optimizer = adam(config.lr, config.grad_clip)

    def loss_fn(params, target_params, batch):
        q = _q_values(params, batch["obs"])
        q_taken = take_along(q, batch["actions"])
        target = double_q_target(
            params, target_params, batch,
            gamma=config.gamma, double_q=config.double_q,
        )
        td = q_taken - target
        return torch.mean(huber_loss(td)), td

    def update(params, target_params, opt_state, batch):
        batch = to_tensors(batch, device_of(params))
        (loss, td), grads = value_and_grad(loss_fn, params, target_params, batch)
        params, opt_state = optimizer.update(grads, opt_state, params)
        return params, opt_state, loss, td

    return optimizer, update


def _copy(params):
    return tree_map(torch.clone, params)


class _EpsilonGreedyRunner:
    """Rollout actor: epsilon-greedy transitions as flat (s,a,r,s',d)
    arrays (reference: EnvRunner with an EpsilonGreedy exploration)."""

    def __init__(self, env_creator, num_envs, seed, fragment):
        import gymnasium as gym

        if isinstance(env_creator, str):
            env_id = env_creator
            fns = [lambda: gym.make(env_id) for _ in range(num_envs)]
        else:
            fns = [env_creator for _ in range(num_envs)]
        self.envs = gym.vector.SyncVectorEnv(
            fns, autoreset_mode=gym.vector.AutoresetMode.SAME_STEP
        )
        self.num_envs = num_envs
        self.fragment = fragment
        self.rng = np.random.default_rng(seed)
        self.obs, _ = self.envs.reset(seed=seed)
        self._ep_returns = np.zeros(num_envs)
        self.completed: deque = deque(maxlen=100)  # trailing window (GL005)

    def obs_space_dim(self):
        return int(np.prod(self.envs.single_observation_space.shape))

    def num_actions(self):
        return int(self.envs.single_action_space.n)

    def sample(self, params, epsilon: float):
        from .env_runner import substitute_final_obs

        params = params_from_numpy(params, "cpu")
        T, N = self.fragment, self.num_envs
        obs_dim = self.obs_space_dim()
        out = {
            "obs": np.zeros((T * N, obs_dim), np.float32),
            "actions": np.zeros((T * N,), np.int64),
            "rewards": np.zeros((T * N,), np.float32),
            "next_obs": np.zeros((T * N, obs_dim), np.float32),
            "dones": np.zeros((T * N,), np.float32),
        }
        obs = self.obs
        for t in range(T):
            with torch.no_grad():
                q = _q_values(params, torch.as_tensor(obs, dtype=torch.float32)).numpy()
            greedy = q.argmax(axis=1)
            rand = self.rng.integers(0, q.shape[1], size=N)
            explore = self.rng.random(N) < epsilon
            actions = np.where(explore, rand, greedy)
            next_obs, rewards, term, trunc, infos = self.envs.step(actions)
            # time-limit truncation is not termination for bootstrapping
            done_for_target = np.asarray(term, np.float32)
            next_store = substitute_final_obs(next_obs, term, trunc, infos)
            sl = slice(t * N, (t + 1) * N)
            out["obs"][sl] = obs.reshape(N, -1)
            out["actions"][sl] = actions
            out["rewards"][sl] = rewards
            out["next_obs"][sl] = next_store.reshape(N, -1)
            out["dones"][sl] = done_for_target
            self._ep_returns += rewards
            for i in np.nonzero(np.logical_or(term, trunc))[0]:
                self.completed.append(float(self._ep_returns[i]))
                self._ep_returns[i] = 0.0
            obs = next_obs
        self.obs = obs
        out["episode_returns"] = np.asarray(list(self.completed), np.float32)
        return out


class DQN:
    def __init__(self, config: DQNConfig):
        import ray_tpu_torch

        from .._private.device import resolve_device

        if config.env is None:
            raise ValueError("config.environment(env) is required")
        self.device = resolve_device(config.device)
        if not ray_tpu_torch.is_initialized():
            ray_tpu_torch.init(ignore_reinit_error=True)
        self.config = config
        self._ray = ray_tpu_torch
        runner_cls = ray_tpu_torch.remote(_EpsilonGreedyRunner)
        self.env_runners = [
            runner_cls.remote(
                config.env, config.num_envs_per_env_runner,
                config.seed + 1000 * i, config.rollout_fragment_length,
            )
            for i in range(config.num_env_runners)
        ]
        obs_dim = ray_tpu_torch.get(self.env_runners[0].obs_space_dim.remote())
        num_actions = ray_tpu_torch.get(self.env_runners[0].num_actions.remote())
        self.spec = MLPSpec(obs_dim, num_actions, tuple(config.hiddens))
        self.params = _init_q_net(torch.Generator().manual_seed(config.seed), self.spec,
                                  self.device)
        self.target_params = _copy(self.params)
        self.optimizer, self._update = make_dqn_update(config, self.spec)
        self.opt_state = self.optimizer.init(self.params)
        self.buffer = ReplayBuffer(config.buffer_capacity, seed=config.seed)
        self.iteration = 0
        self._timesteps = 0
        self._updates = 0

    def _epsilon(self) -> float:
        c = self.config
        frac = min(1.0, self._timesteps / max(1, c.epsilon_decay_steps))
        return c.epsilon_start + frac * (c.epsilon_end - c.epsilon_start)

    def train(self) -> Dict[str, Any]:
        ray = self._ray
        c = self.config
        host_params = params_to_numpy(self.params)
        # per-runner latest last-100 window (cumulative per runner):
        # keep the newest per runner, concat across runners
        latest_windows: Dict[int, list] = {}
        loss_val = float("nan")
        for _ in range(c.updates_per_iteration):
            rollouts = ray.get([
                r.sample.remote(host_params, self._epsilon())
                for r in self.env_runners
            ])
            for idx, ro in enumerate(rollouts):
                latest_windows[idx] = ro.pop("episode_returns").tolist()
                self.buffer.add(ro)
                self._timesteps += len(ro["actions"])
            if (
                self._timesteps < c.num_steps_sampled_before_learning_starts
                or len(self.buffer) < c.train_batch_size
            ):
                continue
            for _ in range(c.train_intensity):
                batch = self.buffer.sample(c.train_batch_size)
                self.params, self.opt_state, loss, _ = self._update(
                    self.params, self.target_params, self.opt_state, batch
                )
                loss_val = float(loss)
                self._updates += 1
                if self._updates % c.target_network_update_freq == 0:
                    self.target_params = _copy(self.params)
            host_params = params_to_numpy(self.params)
        from .env_runner import merge_return_windows

        episode_returns = merge_return_windows(latest_windows)
        self.iteration += 1
        return {
            "training_iteration": self.iteration,
            "num_env_steps_sampled_lifetime": self._timesteps,
            "episode_return_mean": (
                float(np.mean(episode_returns)) if episode_returns
                else float("nan")
            ),
            "num_episodes": len(episode_returns),
            "epsilon": self._epsilon(),
            "loss": loss_val,
            "buffer_size": len(self.buffer),
        }

    def compute_single_action(self, obs) -> int:
        obs = torch.as_tensor(np.asarray(obs, np.float32), device=self.device)
        with torch.no_grad():
            q = _q_values(self.params, obs[None])
        return int(torch.argmax(q[0]))

    def stop(self) -> None:
        for r in self.env_runners:
            try:
                self._ray.kill(r)
            except Exception:
                pass
        self.env_runners = []
