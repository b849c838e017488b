"""CQL: conservative Q-learning for offline RL (discrete actions).

Port of ``ray_tpu/rllib/cql.py``. Parity: python/ray/rllib/algorithms/
cql/ — offline TD learning with the conservative regularizer alpha *
E[logsumexp_a Q(s,a) - Q(s, a_data)], which pushes down Q on
out-of-distribution actions so the greedy policy stays inside the
dataset's support. Data flows the rllib/offline way: a Dataset of (obs,
actions, rewards, next_obs, dones) transitions is staged into the host
replay buffer and minibatched into one update on the learner's device
(the GPU unless ``device="cpu"``): double-Q target, CQL penalty, clip
and Adam.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from .core import MLPSpec, adam, take_along, to_tensors, tree_map, value_and_grad
from .dqn import _init_q_net, _q_values, double_q_target, huber_loss
from .replay_buffers import ReplayBuffer


@dataclass
class CQLConfig:
    lr: float = 3e-4
    gamma: float = 0.99
    cql_alpha: float = 1.0  # conservative penalty weight (min_q_weight)
    grad_clip: float = 10.0
    target_network_update_freq: int = 200
    train_batch_size: int = 256
    buffer_capacity: int = 1_000_000
    hiddens: Tuple[int, ...] = (64, 64)
    seed: int = 0
    device: Optional[str] = None  # None: the GPU

    def training(self, **kwargs) -> "CQLConfig":
        for k, v in kwargs.items():
            if not hasattr(self, k):
                raise ValueError(f"unknown CQL training param {k!r}")
            setattr(self, k, v)
        return self

    def build_algo(self, obs_dim: int, num_actions: int) -> "CQL":
        return CQL(self, obs_dim, num_actions)


class CQL:
    def __init__(self, config: CQLConfig, obs_dim: int, num_actions: int):
        from .._private.device import resolve_device

        self.config = config
        self.device = resolve_device(config.device)
        self.spec = MLPSpec(obs_dim, num_actions, tuple(config.hiddens))
        self.params = _init_q_net(torch.Generator().manual_seed(config.seed), self.spec,
                                  self.device)
        self.target_params = tree_map(torch.clone, self.params)
        self.optimizer = adam(config.lr, config.grad_clip)
        self.opt_state = self.optimizer.init(self.params)
        gamma = config.gamma
        alpha = config.cql_alpha

        def loss_fn(params, target_params, batch):
            q = _q_values(params, batch["obs"])  # (B, A)
            q_taken = take_along(q, batch["actions"])
            target = double_q_target(
                params, target_params, batch, gamma=gamma, double_q=True
            )
            td = q_taken - target
            td_loss = torch.mean(huber_loss(td))
            # conservative penalty: push down the soft-max over ALL
            # actions, push up the dataset action
            cql_penalty = torch.mean(torch.logsumexp(q, 1) - q_taken)
            return td_loss + alpha * cql_penalty, (td_loss, cql_penalty)

        def update(params, target_params, opt_state, batch):
            batch = to_tensors(batch, self.device)
            (loss, (td, pen)), grads = value_and_grad(
                loss_fn, params, target_params, batch)
            params, opt_state = self.optimizer.update(grads, opt_state, params)
            return params, opt_state, loss, td, pen

        self._update = update
        self.buffer = ReplayBuffer(config.buffer_capacity, seed=config.seed)
        self.iteration = 0
        self._updates = 0

    def stage_dataset(self, dataset) -> int:
        """Load an offline transitions Dataset into the replay buffer.
        Fails loudly on overflow — silently ring-dropping offline rows
        would invalidate training without a trace."""
        n = 0
        for batch in dataset.iter_batches(batch_size=4096, batch_format="numpy"):
            staged = {
                "obs": np.asarray(batch["obs"], np.float32).reshape(
                    len(batch["actions"]), -1
                ),
                "actions": np.asarray(batch["actions"], np.int64),
                "rewards": np.asarray(batch["rewards"], np.float32),
                "next_obs": np.asarray(batch["next_obs"], np.float32).reshape(
                    len(batch["actions"]), -1
                ),
                "dones": np.asarray(batch["dones"], np.float32),
            }
            self.buffer.add(staged)
            n += len(staged["actions"])
            if n > self.config.buffer_capacity:
                raise ValueError(
                    f"offline dataset exceeds buffer_capacity="
                    f"{self.config.buffer_capacity}; raise it in CQLConfig"
                )
        return n

    def train(self, num_updates: int = 256) -> Dict[str, Any]:
        if num_updates <= 0:
            raise ValueError(f"num_updates must be positive, got {num_updates}")
        if not len(self.buffer):
            raise RuntimeError("stage_dataset() before train()")
        c = self.config
        loss = td = pen = float("nan")
        for _ in range(num_updates):
            batch = self.buffer.sample(c.train_batch_size)
            self.params, self.opt_state, loss, td, pen = self._update(
                self.params, self.target_params, self.opt_state, batch
            )
            self._updates += 1
            if self._updates % c.target_network_update_freq == 0:
                self.target_params = tree_map(torch.clone, self.params)
        self.iteration += 1
        return {
            "training_iteration": self.iteration,
            "num_updates_lifetime": self._updates,
            "loss": float(loss),
            "td_loss": float(td),
            "cql_penalty": float(pen),
        }

    def compute_single_action(self, obs) -> int:
        obs = torch.as_tensor(np.asarray(obs, np.float32), device=self.device)
        with torch.no_grad():
            q = _q_values(self.params, obs[None])
        return int(torch.argmax(q[0]))
