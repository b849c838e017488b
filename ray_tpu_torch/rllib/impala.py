"""IMPALA: async actor-learner with V-trace off-policy correction.

Port of ``ray_tpu/rllib/impala.py``. Parity: python/ray/rllib/algorithms/
impala/ — EnvRunner actors sample continuously with (slightly stale)
behavior policies while the learner consumes completed rollouts as they
arrive; V-trace (Espeholt et al. 2018) corrects the off-policyness. The
V-trace + SGD update runs on the learner's device (the GPU unless
``device="cpu"``), eagerly; the reference's reverse ``lax.scan`` is a
loop over T, backwards. Asynchrony lives in the actor fan-out
(``ray_tpu_torch.wait`` on whichever runner finishes first), not in
framework queue threads; the runners act on the CPU.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Tuple, Union

import numpy as np
import torch

from .core import (
    MLPSpec,
    adam,
    device_of,
    forward,
    init_mlp_module,
    params_from_numpy,
    params_to_numpy,
    take_along,
    to_tensors,
    value_and_grad,
)


@dataclass
class IMPALAConfig:
    """Builder (reference: impala/impala.py IMPALAConfig)."""

    env: Optional[Union[str, Callable]] = None
    num_env_runners: int = 2
    num_envs_per_env_runner: int = 2
    rollout_fragment_length: int = 64
    lr: float = 5e-3
    gamma: float = 0.99
    vtrace_clip_rho: float = 1.0
    vtrace_clip_c: float = 1.0
    vf_loss_coeff: float = 0.5
    entropy_coeff: float = 0.01
    grad_clip: float = 1.0
    # learner updates consumed per train() iteration (each is one
    # runner's completed rollout — the async unit)
    updates_per_iteration: int = 4
    hiddens: Tuple[int, ...] = (64, 64)
    seed: int = 0
    device: Optional[str] = None  # the learner's; None: the GPU

    def environment(self, env) -> "IMPALAConfig":
        self.env = env
        return self

    def env_runners(self, *, num_env_runners=None, num_envs_per_env_runner=None,
                    rollout_fragment_length=None) -> "IMPALAConfig":
        if num_env_runners is not None:
            self.num_env_runners = num_env_runners
        if num_envs_per_env_runner is not None:
            self.num_envs_per_env_runner = num_envs_per_env_runner
        if rollout_fragment_length is not None:
            self.rollout_fragment_length = rollout_fragment_length
        return self

    def training(self, **kwargs) -> "IMPALAConfig":
        for k, v in kwargs.items():
            if not hasattr(self, k):
                raise ValueError(f"unknown IMPALA training param {k!r}")
            setattr(self, k, v)
        return self

    def debugging(self, *, seed=None) -> "IMPALAConfig":
        if seed is not None:
            self.seed = seed
        return self

    def build_algo(self):
        return IMPALA(self)

    build = build_algo


def vtrace(
    behavior_logp, target_logp, rewards, dones, values, bootstrap_value,
    *, gamma, clip_rho, clip_c,
):
    """V-trace targets (Espeholt et al. 2018, eqs. 1-2). All inputs
    time-major (T, B) (numpy arrays or tensors); returns (vs (T, B),
    pg_advantages (T, B)) as tensors."""
    behavior_logp, target_logp, rewards, dones, values, bootstrap_value = (
        torch.as_tensor(x) for x in
        (behavior_logp, target_logp, rewards, dones, values, bootstrap_value)
    )
    rho = torch.exp(target_logp - behavior_logp)
    rho_c = torch.clamp(rho, max=clip_rho)
    c = torch.clamp(rho, max=clip_c)
    nonterminal = 1.0 - dones
    values_tp1 = torch.cat([values[1:], bootstrap_value[None]], 0)
    deltas = rho_c * (rewards + gamma * nonterminal * values_tp1 - values)

    acc = torch.zeros_like(bootstrap_value)
    out = [acc] * deltas.shape[0]
    for t in range(deltas.shape[0] - 1, -1, -1):
        acc = deltas[t] + gamma * nonterminal[t] * c[t] * acc
        out[t] = acc
    vs = values + torch.stack(out)
    vs_tp1 = torch.cat([vs[1:], bootstrap_value[None]], 0)
    pg_adv = rho_c * (rewards + gamma * nonterminal * vs_tp1 - values)
    return vs, pg_adv


def _entropy(logp_all: torch.Tensor) -> torch.Tensor:
    return -torch.mean(torch.sum(torch.exp(logp_all) * logp_all, -1))


def make_impala_loss(config, spec: MLPSpec):
    """The V-trace loss as a standalone ``loss_fn(params, batch) ->
    (total, metrics)`` over a time-major batch of tensors {obs, actions,
    rewards, dones, logp_mu, final_obs}. ``config`` duck-types
    IMPALAConfig (gamma/vtrace clips/vf_loss_coeff/entropy_coeff) — the
    Podracer learners reuse this loss (Anakin's superstep; Sebulba's
    sharded update over the learner collective group)."""

    def loss_fn(params, batch):
        logits, values = forward(params, batch["obs"])  # (T, B, A), (T, B)
        logp_all = torch.log_softmax(logits, -1)
        logp = take_along(logp_all, batch["actions"])
        bootstrap = forward(params, batch["final_obs"])[1]  # (B,)
        vs, pg_adv = vtrace(
            batch["logp_mu"], logp.detach(),
            batch["rewards"], batch["dones"],
            values.detach(), bootstrap.detach(),
            gamma=config.gamma,
            clip_rho=config.vtrace_clip_rho,
            clip_c=config.vtrace_clip_c,
        )
        pi_loss = -torch.mean(pg_adv.detach() * logp)
        vf_loss = torch.mean((values - vs.detach()) ** 2)
        entropy = _entropy(logp_all)
        total = (
            pi_loss
            + config.vf_loss_coeff * vf_loss
            - config.entropy_coeff * entropy
        )
        return total, {
            "policy_loss": pi_loss,
            "vf_loss": vf_loss,
            "entropy": entropy,
            "mean_rho": torch.mean(torch.exp(logp.detach() - batch["logp_mu"])),
        }

    return loss_fn


def make_loss_update(loss_fn, optimizer):
    """``update(params, opt_state, batch) -> (params, opt_state,
    metrics)``: one SGD step of ``loss_fn`` over a batch of numpy arrays
    or tensors, moved to the params' device."""

    def update(params, opt_state, batch):
        batch = to_tensors(batch, device_of(params))
        (_, metrics), grads = value_and_grad(loss_fn, params, batch)
        params, opt_state = optimizer.update(grads, opt_state, params)
        return params, opt_state, metrics

    return update


def make_impala_update(config: IMPALAConfig, spec: MLPSpec):
    """(optimizer, update) — V-trace loss + one clip-and-Adam step over a
    single runner's rollout."""
    optimizer = adam(config.lr, config.grad_clip)
    return optimizer, make_loss_update(make_impala_loss(config, spec), optimizer)


class IMPALA:
    """Async actor-learner driver (reference: impala.py training_step —
    sample non-blockingly from whichever runner is done, update, push
    fresh weights back to THAT runner only)."""

    def __init__(self, config: IMPALAConfig):
        import ray_tpu_torch

        from .._private.device import resolve_device
        from .env_runner import SingleAgentEnvRunner

        if config.env is None:
            raise ValueError("config.environment(env) is required")
        self.device = resolve_device(config.device)
        if not ray_tpu_torch.is_initialized():
            ray_tpu_torch.init(ignore_reinit_error=True)
        self.config = config
        self._ray = ray_tpu_torch
        runner_cls = ray_tpu_torch.remote(SingleAgentEnvRunner)
        self.env_runners = [
            runner_cls.remote(
                config.env,
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
        self.optimizer, self._update = self._make_update(config, self.spec)
        self.opt_state = self.optimizer.init(self.params)
        self.iteration = 0
        self._timesteps = 0
        self._seed_counter = 0
        # async pipeline: every runner always has a sample() in flight
        self._inflight: Dict[Any, int] = {}

    # subclass hook: APPO swaps in the clipped-surrogate learner while
    # keeping the whole async actor-learner machinery
    _make_update = staticmethod(make_impala_update)

    def _host_params(self):
        return params_to_numpy(self.params)

    def _submit(self, runner_idx: int):
        self._seed_counter += 1
        ref = self.env_runners[runner_idx].sample.remote(
            self._host_params(), self.config.seed + self._seed_counter * 97
        )
        self._inflight[ref] = runner_idx

    def train(self) -> Dict[str, Any]:
        ray = self._ray
        if not self._inflight:
            for i in range(len(self.env_runners)):
                self._submit(i)
        episode_returns = []
        metrics = {}
        for _ in range(self.config.updates_per_iteration):
            ready, _ = ray.wait(
                list(self._inflight.keys()), num_returns=1, timeout=120
            )
            ref = ready[0]
            runner_idx = self._inflight.pop(ref)
            rollout = ray.get(ref)
            # learner consumes THIS runner's batch; runner immediately
            # resamples with the post-update weights (async staleness <=
            # one rollout — the IMPALA contract)
            batch = {
                "obs": rollout["obs"].reshape(
                    *rollout["obs"].shape[:2], -1
                ),
                "actions": rollout["actions"],
                "rewards": rollout["rewards"],
                "dones": rollout["dones"],
                "logp_mu": rollout["logp"],
                "final_obs": rollout["final_obs"].reshape(
                    rollout["final_obs"].shape[0], -1
                ),
            }
            self.params, self.opt_state, metrics = self._update(
                self.params, self.opt_state, batch
            )
            self._timesteps += int(batch["actions"].size)
            episode_returns.extend(rollout["episode_returns"].tolist())
            self._submit(runner_idx)
        self.iteration += 1
        result = {
            "training_iteration": self.iteration,
            "num_env_steps_sampled_lifetime": self._timesteps,
            "episode_return_mean": (
                float(np.mean(episode_returns)) if episode_returns else float("nan")
            ),
            "num_episodes": len(episode_returns),
        }
        result.update({k: float(v) for k, v in metrics.items()})
        return result

    def compute_single_action(self, obs) -> int:
        obs = torch.as_tensor(np.asarray(obs, np.float32), device=self.device)
        with torch.no_grad():
            logits, _ = forward(self.params, obs[None])
        return int(torch.argmax(logits[0]))

    def save(self, checkpoint_dir: str) -> str:
        import os
        import pickle

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
        import os
        import pickle

        with open(os.path.join(checkpoint_dir, "algorithm_state.pkl"), "rb") as f:
            state = pickle.load(f)
        self.params = params_from_numpy(state["params"], self.device)
        self.opt_state = params_from_numpy(state["opt_state"], self.device)
        self.iteration = state["iteration"]
        self._timesteps = state["timesteps"]

    def stop(self) -> None:
        self._inflight.clear()
        for r in self.env_runners:
            try:
                self._ray.kill(r)
            except Exception:
                pass
        self.env_runners = []
