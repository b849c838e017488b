"""APPO: asynchronous PPO — IMPALA's actor-learner with PPO's clipped
surrogate.

Port of ``ray_tpu/rllib/appo.py``. Parity: python/ray/rllib/algorithms/
appo/ — same async sampling architecture as IMPALA (stale behavior
policies, V-trace correction) but the policy loss is the PPO clipped
surrogate over the V-trace advantages, which tolerates more staleness
than the plain V-trace policy-gradient. Reuses IMPALA's runner fan-out
and update shape; only the loss differs.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from .core import MLPSpec, adam, forward, take_along
from .impala import IMPALA, IMPALAConfig, _entropy, make_loss_update, vtrace


@dataclass
class APPOConfig(IMPALAConfig):
    """Builder (reference: appo.py APPOConfig — clip_param on top of the
    IMPALA knobs)."""

    clip_param: float = 0.3

    def build_algo(self):
        return APPO(self)

    build = build_algo


def make_appo_loss(config, spec: MLPSpec):
    """APPO's clipped-surrogate-over-V-trace loss as a standalone
    ``loss_fn(params, batch) -> (total, metrics)``. ``config``
    duck-types APPOConfig (adds clip_param on top of the IMPALA
    hyperparams); reused by the Podracer learners the same way
    ``make_impala_loss`` is."""

    def loss_fn(params, batch):
        logits, values = forward(params, batch["obs"])  # (T, B, A), (T, B)
        logp_all = torch.log_softmax(logits, -1)
        logp = take_along(logp_all, batch["actions"])
        bootstrap = forward(params, batch["final_obs"])[1]
        vs, pg_adv = vtrace(
            batch["logp_mu"], logp.detach(),
            batch["rewards"], batch["dones"],
            values.detach(), bootstrap.detach(),
            gamma=config.gamma,
            clip_rho=config.vtrace_clip_rho,
            clip_c=config.vtrace_clip_c,
        )
        adv = pg_adv.detach()
        # the population std, as jnp.std computes it
        adv = (adv - adv.mean()) / (adv.std(correction=0) + 1e-8)
        # PPO clipped surrogate against the BEHAVIOR policy (the APPO
        # twist: ratio is new-policy vs rollout-time policy)
        ratio = torch.exp(logp - batch["logp_mu"])
        clipped = torch.clamp(ratio, 1 - config.clip_param, 1 + config.clip_param)
        pi_loss = -torch.mean(torch.minimum(ratio * adv, clipped * adv))
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
            "mean_ratio": torch.mean(ratio.detach()),
        }

    return loss_fn


def make_appo_update(config: APPOConfig, spec: MLPSpec):
    optimizer = adam(config.lr, config.grad_clip)
    return optimizer, make_loss_update(make_appo_loss(config, spec), optimizer)


class APPO(IMPALA):
    _make_update = staticmethod(make_appo_update)
