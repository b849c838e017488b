"""BC: offline behavior cloning from a ray_tpu_torch.data Dataset.

Port of ``ray_tpu/rllib/bc.py``. Parity: python/ray/rllib/algorithms/bc/
+ the offline data path (rllib/offline/ reading experiences through Ray
Data). The dataset provides "obs" and "actions" columns; training is
plain supervised cross-entropy on the policy head, batched through
``Dataset.iter_batches(device_put=...)``, which stages each batch on the
learner's device (the GPU unless ``device="cpu"``) ahead of the update.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from .core import MLPSpec, adam, forward, init_mlp_module, take_along, value_and_grad


@dataclass
class BCConfig:
    lr: float = 1e-3
    train_batch_size: int = 256
    hiddens: Tuple[int, ...] = (64, 64)
    seed: int = 0
    device: Optional[str] = None  # None: the GPU

    def training(self, **kwargs) -> "BCConfig":
        for k, v in kwargs.items():
            if not hasattr(self, k):
                raise ValueError(f"unknown BC training param {k!r}")
            setattr(self, k, v)
        return self

    def build_algo(self, obs_dim: int, num_actions: int) -> "BC":
        return BC(self, obs_dim, num_actions)


def offline_batches(dataset, batch_size: int, device: torch.device):
    """(batch, number of rows) of a Dataset's batches, every numeric
    column a tensor staged on ``device`` (obs flattened to (n, -1))."""
    for batch in dataset.iter_batches(batch_size=batch_size, batch_format="numpy",
                                      device_put=device):
        n = len(batch["actions"])
        batch = dict(batch)
        batch["obs"] = torch.as_tensor(batch["obs"], device=device).reshape(n, -1).float()
        batch["actions"] = torch.as_tensor(batch["actions"], device=device).long()
        yield batch, n


class BC:
    def __init__(self, config: BCConfig, obs_dim: int, num_actions: int):
        from .._private.device import resolve_device

        self.config = config
        self.device = resolve_device(config.device)
        self.spec = MLPSpec(obs_dim, num_actions, tuple(config.hiddens))
        self.params = init_mlp_module(
            torch.Generator().manual_seed(config.seed), self.spec, self.device
        )
        self.optimizer = adam(config.lr)
        self.opt_state = self.optimizer.init(self.params)

        def loss_fn(params, obs, actions):
            logits, _ = forward(params, obs)
            logp = torch.log_softmax(logits, -1)
            nll = -take_along(logp, actions)
            return torch.mean(nll), None

        def update(params, opt_state, obs, actions):
            (loss, _), grads = value_and_grad(loss_fn, params, obs, actions)
            params, opt_state = self.optimizer.update(grads, opt_state, params)
            return params, opt_state, loss

        self._update = update
        self.iteration = 0

    def train_on_dataset(self, dataset, *, epochs: int = 1) -> Dict[str, Any]:
        """Offline training pass(es) over a Dataset with "obs" and
        "actions" columns (the rllib/offline shape)."""
        losses = []
        n = 0
        for _ in range(epochs):
            for batch, rows in offline_batches(dataset, self.config.train_batch_size,
                                               self.device):
                self.params, self.opt_state, loss = self._update(
                    self.params, self.opt_state, batch["obs"], batch["actions"]
                )
                losses.append(loss)
                n += rows
        self.iteration += 1
        return {
            "training_iteration": self.iteration,
            "num_samples_trained": n,
            "loss": float(torch.stack(losses).mean()) if losses else float("nan"),
        }

    def compute_single_action(self, obs) -> int:
        obs = torch.as_tensor(np.asarray(obs, np.float32), device=self.device)
        with torch.no_grad():
            logits, _ = forward(self.params, obs[None])
        return int(torch.argmax(logits[0]))
