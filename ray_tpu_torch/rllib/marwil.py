"""MARWIL: monotonic advantage re-weighted imitation learning.

Port of ``ray_tpu/rllib/marwil.py``. Parity: python/ray/rllib/algorithms/
marwil/ — offline learning from a Dataset of (obs, actions, returns): a
value head estimates V(s), and the policy is cloned with per-sample
weights exp(beta * advantage / norm), so high-return actions dominate
(beta=0 degenerates to BC — same equivalence the reference documents).
The advantage normalizer is the running mean of squared advantages (the
paper's c^2 estimate). Batches are staged on the learner's device (the
GPU unless ``device="cpu"``) by ``iter_batches(device_put=...)``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from .bc import offline_batches
from .core import MLPSpec, adam, forward, init_mlp_module, take_along, value_and_grad


@dataclass
class MARWILConfig:
    lr: float = 1e-3
    beta: float = 1.0  # 0 = plain BC
    vf_coeff: float = 1.0
    moving_average_sqd_adv_norm_update_rate: float = 1e-2  # reference knob
    train_batch_size: int = 256
    hiddens: Tuple[int, ...] = (64, 64)
    seed: int = 0
    device: Optional[str] = None  # None: the GPU

    def training(self, **kwargs) -> "MARWILConfig":
        for k, v in kwargs.items():
            if not hasattr(self, k):
                raise ValueError(f"unknown MARWIL training param {k!r}")
            setattr(self, k, v)
        return self

    def build_algo(self, obs_dim: int, num_actions: int) -> "MARWIL":
        return MARWIL(self, obs_dim, num_actions)


class MARWIL:
    def __init__(self, config: MARWILConfig, obs_dim: int, num_actions: int):
        from .._private.device import resolve_device

        self.config = config
        self.device = resolve_device(config.device)
        self.spec = MLPSpec(obs_dim, num_actions, tuple(config.hiddens))
        self.params = init_mlp_module(
            torch.Generator().manual_seed(config.seed), self.spec, self.device
        )
        self.optimizer = adam(config.lr)
        self.opt_state = self.optimizer.init(self.params)
        # moving average of squared advantages (weight normalizer)
        self.ma_sqd_adv = torch.tensor(1.0, dtype=torch.float32, device=self.device)
        beta = config.beta
        vf_coeff = config.vf_coeff
        rate = config.moving_average_sqd_adv_norm_update_rate

        def loss_fn(params, ma_sqd_adv, obs, actions, returns):
            logits, values = forward(params, obs)
            adv = returns - values
            # update the normalizer OUTSIDE the gradient
            adv_sg = adv.detach()
            new_ma = ma_sqd_adv + rate * (torch.mean(adv_sg**2) - ma_sqd_adv)
            weights = torch.exp(
                beta * adv_sg / torch.sqrt(torch.clamp(new_ma, min=1e-8))
            )
            # clip for stability (reference clamps the exponent's output)
            weights = torch.clamp(weights, max=20.0)
            logp = torch.log_softmax(logits, -1)
            nll = -take_along(logp, actions)
            pi_loss = torch.mean(weights.detach() * nll)
            vf_loss = torch.mean(adv**2)
            return pi_loss + vf_coeff * vf_loss, (new_ma, pi_loss, vf_loss)

        def update(params, opt_state, ma_sqd_adv, obs, actions, returns):
            (loss, (new_ma, pi_loss, vf_loss)), grads = value_and_grad(
                loss_fn, params, ma_sqd_adv, obs, actions, returns)
            params, opt_state = self.optimizer.update(grads, opt_state, params)
            return params, opt_state, new_ma, loss, pi_loss, vf_loss

        self._update = update
        self.iteration = 0

    def train_on_dataset(self, dataset, *, epochs: int = 1) -> Dict[str, Any]:
        """Offline pass(es) over a Dataset with "obs", "actions" and
        "returns" columns (rllib/offline shape + MC returns)."""
        losses = []
        n = 0
        for _ in range(epochs):
            for batch, rows in offline_batches(dataset, self.config.train_batch_size,
                                               self.device):
                returns = torch.as_tensor(batch["returns"], device=self.device).float()
                (
                    self.params,
                    self.opt_state,
                    self.ma_sqd_adv,
                    loss,
                    _pi,
                    _vf,
                ) = self._update(
                    self.params, self.opt_state, self.ma_sqd_adv,
                    batch["obs"], batch["actions"], returns,
                )
                losses.append(loss)
                n += rows
        self.iteration += 1
        return {
            "training_iteration": self.iteration,
            "num_samples_trained": n,
            "loss": float(torch.stack(losses).mean()) if losses else float("nan"),
            "ma_sqd_adv": float(self.ma_sqd_adv),
        }

    def compute_single_action(self, obs) -> int:
        obs = torch.as_tensor(np.asarray(obs, np.float32), device=self.device)
        with torch.no_grad():
            logits, _ = forward(self.params, obs[None])
        return int(torch.argmax(logits[0]))
