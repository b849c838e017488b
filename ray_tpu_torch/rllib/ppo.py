"""PPO: config + learner.

Port of ``ray_tpu/rllib/ppo.py``. Parity: python/ray/rllib/algorithms/
ppo/ (PPOConfig/PPO) + core/learner/learner.py:107. The whole update —
GAE, minibatch epochs, clipped surrogate, optimizer — runs on the
learner's device (the GPU unless ``device="cpu"``); the reference's
``lax.scan``s are loops, and each epoch's minibatch permutation is an
argument the caller draws (``Algorithm`` from a ``torch.Generator``), so
the same permutations give the same update on any device.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional, Tuple, Union

import torch

from .core import MLPSpec, adam, device_of, forward, take_along, to_tensors, value_and_grad


@dataclass
class PPOConfig:
    """Builder (reference: algorithm_config.py fluent API)."""

    env: Optional[Union[str, Callable]] = None
    num_env_runners: int = 2
    num_envs_per_env_runner: int = 2
    rollout_fragment_length: int = 128
    lr: float = 3e-4
    gamma: float = 0.99
    lambda_: float = 0.95
    clip_param: float = 0.2
    vf_loss_coeff: float = 0.5
    entropy_coeff: float = 0.01
    num_epochs: int = 4
    minibatch_size: int = 128
    grad_clip: float = 0.5
    hiddens: Tuple[int, ...] = (64, 64)
    seed: int = 0
    # multi-agent (reference: algorithm_config.multi_agent()):
    # policies = module ids; policy_mapping_fn(agent_id, episode) -> id
    policies: Optional[set] = None
    policy_mapping_fn: Optional[Callable] = None
    env_config: Optional[dict] = None
    # ConnectorV2 pipelines (reference: config.env_to_module_connector /
    # learner connector): builders called per module on the runner
    env_to_module_connector: Optional[Callable] = None
    learner_connector: Optional[Callable] = None
    device: Optional[str] = None  # the learner's; None: the GPU

    # -- fluent builder (reference parity) --
    def environment(self, env, *, env_config=None) -> "PPOConfig":
        self.env = env
        if env_config is not None:
            self.env_config = env_config
        return self

    def multi_agent(self, *, policies=None, policy_mapping_fn=None) -> "PPOConfig":
        """Enable multi-agent training (reference:
        algorithm_config.py multi_agent): `policies` is the set of
        module ids, `policy_mapping_fn(agent_id, episode)` routes each
        agent to one of them."""
        if policies is not None:
            self.policies = set(policies)
        if policy_mapping_fn is not None:
            self.policy_mapping_fn = policy_mapping_fn
        return self

    def env_runners(self, *, num_env_runners=None, num_envs_per_env_runner=None,
                    rollout_fragment_length=None,
                    env_to_module_connector=None) -> "PPOConfig":
        if num_env_runners is not None:
            self.num_env_runners = num_env_runners
        if num_envs_per_env_runner is not None:
            self.num_envs_per_env_runner = num_envs_per_env_runner
        if rollout_fragment_length is not None:
            self.rollout_fragment_length = rollout_fragment_length
        if env_to_module_connector is not None:
            self.env_to_module_connector = env_to_module_connector
        return self

    def training(self, **kwargs) -> "PPOConfig":
        for k, v in kwargs.items():
            if k == "lambda":
                k = "lambda_"
            if not hasattr(self, k):
                raise ValueError(f"unknown PPO training param {k!r}")
            setattr(self, k, v)
        return self

    def debugging(self, *, seed=None) -> "PPOConfig":
        if seed is not None:
            self.seed = seed
        return self

    def build_algo(self):
        if self.policies or self.policy_mapping_fn:
            from .multi_agent import MultiAgentAlgorithm

            return MultiAgentAlgorithm(self)
        from .algorithm import Algorithm

        return Algorithm(self)

    build = build_algo  # older API alias


def compute_gae(rewards, values, dones, final_value, gamma, lam):
    """Time-major GAE (T, N). Returns (advantages, value_targets)."""
    adv_next = torch.zeros_like(final_value)
    v_next = final_value
    advs = [adv_next] * rewards.shape[0]
    for t in range(rewards.shape[0] - 1, -1, -1):
        nonterminal = 1.0 - dones[t]
        delta = rewards[t] + gamma * v_next * nonterminal - values[t]
        adv_next = delta + gamma * lam * nonterminal * adv_next
        v_next = values[t]
        advs[t] = adv_next
    advs = torch.stack(advs)
    return advs, advs + values


def ppo_loss_terms(config, logits, values, batch):
    """(pi terms, vf terms, entropy terms) per sample of the clipped
    surrogate, the value error and the entropy — PPO's and the
    multi-agent learner's losses average them (the latter masked)."""
    logp_all = torch.log_softmax(logits, -1)
    logp = take_along(logp_all, batch["actions"])
    ratio = torch.exp(logp - batch["logp_old"])
    adv = batch["advantages"]
    surr = torch.minimum(
        ratio * adv,
        torch.clamp(ratio, 1 - config.clip_param, 1 + config.clip_param) * adv,
    )
    vf = (values - batch["value_targets"]) ** 2
    ent = -torch.sum(torch.exp(logp_all) * logp_all, -1)
    return surr, vf, ent


def run_minibatch_epochs(loss_fn, optimizer, params, opt_state, flat, perms, mb):
    """Epochs x minibatches of SGD over the flat batch, each epoch in the
    order of its row of ``perms`` ((num_epochs, B) int64); returns
    (params, opt_state, metrics averaged over every minibatch)."""
    perms = torch.as_tensor(perms, device=device_of(params))
    n_mb = perms.shape[1] // mb
    sums = {}
    for perm in perms:
        for i in range(n_mb):
            idx = perm[i * mb:(i + 1) * mb]
            batch = {k: v[idx] for k, v in flat.items()}
            (_, metrics), grads = value_and_grad(loss_fn, params, batch)
            params, opt_state = optimizer.update(grads, opt_state, params)
            for k, v in metrics.items():
                sums[k] = sums.get(k, 0.0) + v
    count = perms.shape[0] * n_mb
    return params, opt_state, {k: v / count for k, v in sums.items()}


def make_ppo_update(config: PPOConfig, spec: MLPSpec):
    """(optimizer, update): ``update(params, opt_state, rollout, perms)``
    — GAE + epochs × minibatches of clipped-surrogate SGD on the params'
    device, over a time-major rollout (numpy or tensors), each epoch's
    minibatches cut in the order of ``perms[epoch]`` (``perms`` is
    (num_epochs, T * N))."""
    optimizer = adam(config.lr, config.grad_clip)

    def loss_fn(params, batch):
        logits, values = forward(params, batch["obs"])
        surr, vf, ent = ppo_loss_terms(config, logits, values, batch)
        pi_loss = -torch.mean(surr)
        vf_loss = torch.mean(vf)
        entropy = torch.mean(ent)
        total = (
            pi_loss
            + config.vf_loss_coeff * vf_loss
            - config.entropy_coeff * entropy
        )
        return total, {
            "policy_loss": pi_loss,
            "vf_loss": vf_loss,
            "entropy": entropy,
        }

    def update(params, opt_state, rollout, perms):
        rollout = to_tensors(rollout, device_of(params))
        with torch.no_grad():
            final_value = forward(params, rollout["final_obs"])[1]
            advs, vtarg = compute_gae(
                rollout["rewards"],
                rollout["values"],
                rollout["dones"],
                final_value,
                config.gamma,
                config.lambda_,
            )
        flat = {
            "obs": rollout["obs"].reshape(-1, spec.obs_dim),
            "actions": rollout["actions"].reshape(-1),
            "logp_old": rollout["logp"].reshape(-1),
            "advantages": advs.reshape(-1),
            "value_targets": vtarg.reshape(-1),
        }
        B = flat["actions"].shape[0]
        a = flat["advantages"]
        flat["advantages"] = (a - a.mean()) / (a.std(correction=0) + 1e-8)
        return run_minibatch_epochs(loss_fn, optimizer, params, opt_state, flat, perms,
                                    min(config.minibatch_size, B))

    return optimizer, update
