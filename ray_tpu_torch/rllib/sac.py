"""SAC: off-policy maximum-entropy actor-critic for continuous control.

Port of ``ray_tpu/rllib/sac.py``. Parity: python/ray/rllib/algorithms/
sac/ (twin critics, tanh-squashed Gaussian policy, automatic
entropy-coefficient tuning against target_entropy=-|A|). The update —
twin-critic Bellman step, reparameterized actor step, alpha step, and
the polyak target sync — runs on the learner's device (the GPU unless
``device="cpu"``); the policy's Gaussian noise is an argument the caller
draws from its generator. Rollout actors sample on the CPU and ship flat
numpy transitions.
"""

from __future__ import annotations

import math
from collections import deque
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Tuple, Union

import numpy as np
import torch

from .core import (
    adam,
    dense,
    device_of,
    params_from_numpy,
    params_to_numpy,
    to_tensors,
    tree_leaves,
    tree_map,
    tree_unflatten,
    value_and_grad,
)
from .replay_buffers import ReplayBuffer

LOG_STD_MIN, LOG_STD_MAX = -20.0, 2.0


@dataclass
class SACConfig:
    env: Optional[Union[str, Callable]] = None
    num_env_runners: int = 1
    num_envs_per_env_runner: int = 2
    rollout_fragment_length: int = 32
    actor_lr: float = 3e-4
    critic_lr: float = 3e-4
    alpha_lr: float = 3e-4
    gamma: float = 0.99
    tau: float = 0.005  # polyak target rate
    initial_alpha: float = 1.0
    target_entropy: Optional[float] = None  # default -action_dim
    buffer_capacity: int = 100_000
    train_batch_size: int = 256
    num_steps_sampled_before_learning_starts: int = 1000
    updates_per_iteration: int = 16  # sample rounds per train()
    train_intensity: int = 8  # gradient updates per sample round
    hiddens: Tuple[int, ...] = (256, 256)
    seed: int = 0
    device: Optional[str] = None  # the learner's; None: the GPU

    def environment(self, env) -> "SACConfig":
        self.env = env
        return self

    def env_runners(self, *, num_env_runners=None, num_envs_per_env_runner=None,
                    rollout_fragment_length=None) -> "SACConfig":
        if num_env_runners is not None:
            self.num_env_runners = num_env_runners
        if num_envs_per_env_runner is not None:
            self.num_envs_per_env_runner = num_envs_per_env_runner
        if rollout_fragment_length is not None:
            self.rollout_fragment_length = rollout_fragment_length
        return self

    def training(self, **kwargs) -> "SACConfig":
        for k, v in kwargs.items():
            if not hasattr(self, k):
                raise ValueError(f"unknown SAC training param {k!r}")
            setattr(self, k, v)
        return self

    def debugging(self, *, seed=None) -> "SACConfig":
        if seed is not None:
            self.seed = seed
        return self

    def build_algo(self) -> "SAC":
        return SAC(self)

    build = build_algo


# ------------------------------------------------------------------ nets
def _mlp_init(generator, sizes, out_dim, out_gain, device):
    layers = []
    fan_in = sizes[0]
    for h in sizes[1:]:
        layers.append(dense(generator, fan_in, h, math.sqrt(2.0), device))
        fan_in = h
    return {"torso": layers, "head": dense(generator, fan_in, out_dim, out_gain, device)}


def _mlp_apply(params, x):
    for layer in params["torso"]:
        x = torch.relu(x @ layer["w"] + layer["b"])
    return x @ params["head"]["w"] + params["head"]["b"]


def init_sac_params(generator: torch.Generator, obs_dim: int, act_dim: int, hiddens,
                    device=None) -> Dict[str, Any]:
    """Policy and twin critics, drawn on the CPU generator and placed on
    ``device`` (the GPU unless "cpu" is asked)."""
    from .._private.device import resolve_device

    dev = resolve_device(device)
    sizes = (obs_dim, *hiddens)
    q_sizes = (obs_dim + act_dim, *hiddens)
    return {
        "pi": _mlp_init(generator, sizes, 2 * act_dim, 0.01, dev),  # mean ++ log_std
        "q1": _mlp_init(generator, q_sizes, 1, 1.0, dev),
        "q2": _mlp_init(generator, q_sizes, 1, 1.0, dev),
    }


def _policy_dist(pi_params, obs):
    out = _mlp_apply(pi_params, obs)
    mean, log_std = torch.chunk(out, 2, -1)
    return mean, torch.clamp(log_std, LOG_STD_MIN, LOG_STD_MAX)


def _sample_squashed(pi_params, obs, eps):
    """Reparameterized tanh-Gaussian sample from the standard normal
    noise ``eps`` (the mean's shape) -> (action in [-1,1], logp)."""
    mean, log_std = _policy_dist(pi_params, obs)
    std = torch.exp(log_std)
    pre = mean + std * eps
    act = torch.tanh(pre)
    # log prob with tanh change-of-variables (stable form); softplus as
    # logaddexp(x, 0), as jax.nn.softplus computes it
    softplus = torch.logaddexp(-2.0 * pre, torch.zeros_like(pre))
    logp = (
        -0.5 * (eps**2 + 2 * log_std + math.log(2 * math.pi))
        - 2.0 * (math.log(2.0) - pre - softplus)
    ).sum(-1)
    return act, logp


def _q(params, obs, act):
    x = torch.cat([obs, act], -1)
    return _mlp_apply(params, x)[..., 0]


@torch.no_grad()
def sample_actions(pi_params, obs, generator: torch.Generator):
    mean, _ = _policy_dist(pi_params, obs)
    eps = torch.randn(mean.shape, generator=generator, device=mean.device)
    act, _ = _sample_squashed(pi_params, obs, eps)
    return act


@torch.no_grad()
def deterministic_actions(pi_params, obs):
    mean, _ = _policy_dist(pi_params, obs)
    return torch.tanh(mean)


def make_sac_update(config: SACConfig, act_dim: int):
    """(actor_opt, critic_opt, alpha_opt, update): ``update(state, batch,
    eps_critic, eps_actor) -> (state, critic_loss, actor_loss)`` with
    ``state = (params, target_q, log_alpha, opt_states)`` and the two
    standard-normal noise draws of shape (batch, act_dim)."""
    target_entropy = (
        config.target_entropy
        if config.target_entropy is not None
        else -float(act_dim)
    )
    actor_opt = adam(config.actor_lr)
    critic_opt = adam(config.critic_lr)
    alpha_opt = adam(config.alpha_lr)

    def critic_loss_fn(q_params, pi_params, target_q, log_alpha, batch, eps):
        with torch.no_grad():
            next_act, next_logp = _sample_squashed(pi_params, batch["next_obs"], eps)
            q_next = torch.minimum(
                _q(target_q["q1"], batch["next_obs"], next_act),
                _q(target_q["q2"], batch["next_obs"], next_act),
            )
            alpha = torch.exp(log_alpha)
            target = batch["rewards"] + config.gamma * (1.0 - batch["dones"]) * (
                q_next - alpha * next_logp
            )
        l1 = torch.mean((_q(q_params["q1"], batch["obs"], batch["actions"]) - target) ** 2)
        l2 = torch.mean((_q(q_params["q2"], batch["obs"], batch["actions"]) - target) ** 2)
        return l1 + l2, None

    def actor_loss_fn(pi_params, q_params, log_alpha, batch, eps):
        act, logp = _sample_squashed(pi_params, batch["obs"], eps)
        q = torch.minimum(
            _q(q_params["q1"], batch["obs"], act),
            _q(q_params["q2"], batch["obs"], act),
        )
        alpha = torch.exp(log_alpha).detach()
        return torch.mean(alpha * logp - q), logp

    def update(state, batch, eps_critic, eps_actor):
        (params, target_q, log_alpha, opt_states) = state
        dev = device_of(params)
        batch = to_tensors(batch, dev)
        eps_critic, eps_actor = eps_critic.to(dev), eps_actor.to(dev)
        q_params = {"q1": params["q1"], "q2": params["q2"]}
        (closs, _), q_grads = value_and_grad(
            critic_loss_fn, q_params, params["pi"], target_q, log_alpha, batch, eps_critic
        )
        q_params, critic_os = critic_opt.update(q_grads, opt_states["critic"], q_params)

        (aloss, logp), pi_grads = value_and_grad(
            actor_loss_fn, params["pi"], tree_map(torch.Tensor.detach, q_params),
            log_alpha, batch, eps_actor
        )
        pi_params, actor_os = actor_opt.update(pi_grads, opt_states["actor"], params["pi"])

        # alpha step: match policy entropy to the target. Loss is
        # -log_alpha * E[logp + H_target]; its grad wrt log_alpha is
        # -E[gap]: entropy below target (gap > 0) drives log_alpha UP.
        entropy_gap = logp + target_entropy
        alpha_grad = -torch.mean(entropy_gap)
        log_alpha, alpha_os = alpha_opt.update([alpha_grad], opt_states["alpha"], log_alpha)

        # polyak target sync
        with torch.no_grad():
            target_q = tree_unflatten(target_q, [
                (1 - config.tau) * t + config.tau * s
                for t, s in zip(tree_leaves(target_q), tree_leaves(q_params))
            ])
        new_params = {"pi": pi_params, "q1": q_params["q1"], "q2": q_params["q2"]}
        new_os = {"critic": critic_os, "actor": actor_os, "alpha": alpha_os}
        return (new_params, target_q, log_alpha, new_os), closs, aloss

    return actor_opt, critic_opt, alpha_opt, update


# ------------------------------------------------------------------ runner
class _GaussianRunner:
    """Rollout actor for continuous spaces: tanh-Gaussian exploration,
    actions stored normalized to [-1,1] (env sees the rescaled value)."""

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
        space = self.envs.single_action_space
        self.low = np.asarray(space.low, np.float32)
        self.high = np.asarray(space.high, np.float32)
        self.num_envs = num_envs
        self.fragment = fragment
        self.seed = seed
        self._step = 0
        self.obs, _ = self.envs.reset(seed=seed)
        self._ep_returns = np.zeros(num_envs)
        self.completed: deque = deque(maxlen=100)  # trailing window (GL005)

    def space_dims(self):
        return (
            int(np.prod(self.envs.single_observation_space.shape)),
            int(np.prod(self.envs.single_action_space.shape)),
        )

    def action_bounds(self):
        return self.low, self.high

    def _to_env(self, act_norm):
        return self.low + (act_norm + 1.0) * 0.5 * (self.high - self.low)

    def sample(self, pi_params, random_actions: bool = False):
        from .env_runner import substitute_final_obs

        pi_params = params_from_numpy(pi_params, "cpu")
        T, N = self.fragment, self.num_envs
        obs_dim, act_dim = self.space_dims()
        out = {
            "obs": np.zeros((T * N, obs_dim), np.float32),
            "actions": np.zeros((T * N, act_dim), np.float32),
            "rewards": np.zeros((T * N,), np.float32),
            "next_obs": np.zeros((T * N, obs_dim), np.float32),
            "dones": np.zeros((T * N,), np.float32),
        }
        rng = np.random.default_rng(self.seed + self._step)
        obs = self.obs
        for t in range(T):
            if random_actions:
                act = rng.uniform(-1.0, 1.0, size=(N, act_dim)).astype(np.float32)
            else:
                gen = torch.Generator().manual_seed(self.seed * 100003 + self._step)
                act = sample_actions(
                    pi_params, torch.as_tensor(obs, dtype=torch.float32), gen).numpy()
            self._step += 1
            next_obs, rewards, term, trunc, infos = self.envs.step(self._to_env(act))
            next_store = substitute_final_obs(next_obs, term, trunc, infos)
            sl = slice(t * N, (t + 1) * N)
            out["obs"][sl] = obs.reshape(N, -1)
            out["actions"][sl] = act
            out["rewards"][sl] = rewards
            out["next_obs"][sl] = next_store.reshape(N, -1)
            out["dones"][sl] = np.asarray(term, np.float32)
            self._ep_returns += rewards
            for i in np.nonzero(np.logical_or(term, trunc))[0]:
                self.completed.append(float(self._ep_returns[i]))
                self._ep_returns[i] = 0.0
            obs = next_obs
        self.obs = obs
        out["episode_returns"] = np.asarray(list(self.completed), np.float32)
        return out


# ------------------------------------------------------------------ algo
class SAC:
    def __init__(self, config: SACConfig):
        import ray_tpu_torch

        from .._private.device import resolve_device

        if config.env is None:
            raise ValueError("config.environment(env) is required")
        self.device = resolve_device(config.device)
        if not ray_tpu_torch.is_initialized():
            ray_tpu_torch.init(ignore_reinit_error=True)
        self.config = config
        self._ray = ray_tpu_torch
        runner_cls = ray_tpu_torch.remote(_GaussianRunner)
        self.env_runners = [
            runner_cls.remote(
                config.env, config.num_envs_per_env_runner,
                config.seed + 1000 * i, config.rollout_fragment_length,
            )
            for i in range(config.num_env_runners)
        ]
        obs_dim, act_dim = ray_tpu_torch.get(self.env_runners[0].space_dims.remote())
        self.act_dim = act_dim
        self.action_low, self.action_high = ray_tpu_torch.get(
            self.env_runners[0].action_bounds.remote()
        )
        self.params = init_sac_params(
            torch.Generator().manual_seed(config.seed), obs_dim, act_dim, config.hiddens,
            self.device,
        )
        self.target_q = tree_map(torch.clone, {"q1": self.params["q1"], "q2": self.params["q2"]})
        self.log_alpha = torch.tensor(np.log(config.initial_alpha), dtype=torch.float32,
                                      device=self.device)
        actor_opt, critic_opt, alpha_opt, self._update = make_sac_update(config, act_dim)
        self.opt_states = {
            "critic": critic_opt.init(
                {"q1": self.params["q1"], "q2": self.params["q2"]}
            ),
            "actor": actor_opt.init(self.params["pi"]),
            "alpha": alpha_opt.init(self.log_alpha),
        }
        self.buffer = ReplayBuffer(config.buffer_capacity, seed=config.seed)
        self.iteration = 0
        self._timesteps = 0
        self._gen = torch.Generator(device=self.device).manual_seed(config.seed + 777)

    def train(self) -> Dict[str, Any]:
        ray = self._ray
        c = self.config
        host_pi = params_to_numpy(self.params["pi"])
        # per-runner latest last-100 window (windows are cumulative per
        # runner, so keep only the newest per runner and concat across
        # runners — extending every round would double-count episodes)
        latest_windows: Dict[int, list] = {}
        closs = aloss = float("nan")
        for _ in range(c.updates_per_iteration):
            warmup = self._timesteps < c.num_steps_sampled_before_learning_starts
            rollouts = ray.get([
                r.sample.remote(host_pi, warmup) for r in self.env_runners
            ])
            for idx, ro in enumerate(rollouts):
                latest_windows[idx] = ro.pop("episode_returns").tolist()
                self.buffer.add(ro)
                self._timesteps += len(ro["actions"])
            if warmup or len(self.buffer) < c.train_batch_size:
                continue
            state = (self.params, self.target_q, self.log_alpha, self.opt_states)
            for _ in range(c.train_intensity):
                batch = self.buffer.sample(c.train_batch_size)
                eps = torch.randn((2, c.train_batch_size, self.act_dim),
                                  generator=self._gen, device=self.device)
                state, cl, al = self._update(state, batch, eps[0], eps[1])
                closs, aloss = float(cl), float(al)
            (self.params, self.target_q, self.log_alpha, self.opt_states) = state
            host_pi = params_to_numpy(self.params["pi"])
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
            "critic_loss": closs,
            "actor_loss": aloss,
            "alpha": float(torch.exp(self.log_alpha)),
            "buffer_size": len(self.buffer),
        }

    def compute_single_action(self, obs) -> np.ndarray:
        """Deterministic ENV-SPACE action (the runner applies the same
        rescale before env.step; RLlib returns env-space actions too)."""
        obs = torch.as_tensor(np.asarray(obs, np.float32), device=self.device)
        act = deterministic_actions(self.params["pi"], obs[None])[0].cpu().numpy()
        return self.action_low + (act + 1.0) * 0.5 * (
            self.action_high - self.action_low
        )

    def stop(self) -> None:
        for r in self.env_runners:
            try:
                self._ray.kill(r)
            except Exception:
                pass
        self.env_runners = []
