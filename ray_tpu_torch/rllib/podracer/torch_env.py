"""Batched torch environments for the Podracer loops (the port of
``podracer/jax_env.py``).

Anakin keeps the environment step on the device beside the learner, so
gymnasium's process-bound envs can't be used there. An env here is a
class of functions over an explicit state dict of tensors, batched over
N envs on the tensors' device, with the observation/action contract of
``env_runner.SingleAgentEnvRunner``:

    reset_draw(generator, n, device) -> (n, *reset_shape) uniform draws
    reset(draw)                      -> (state, obs)
    step(state, action, draw)        -> (state, obs, reward, done)

Auto-reset is folded into ``step`` (SAME_STEP semantics, mirroring the
gymnasium vector path): when an episode ends, ``done=1`` is returned
together with the freshly-reset observation, so an acting loop never
leaves the device. The bootstrap value of a reset obs is masked by
``1 - done`` inside V-trace, so the swap is sound. As in the reference,
a reset state is drawn for every env on every step; ``step`` takes that
draw as an argument, so the caller's generator (or a test's numbers)
decide it.
"""

from __future__ import annotations

import math
from typing import Dict, Type

import torch


class TorchCartPole:
    """CartPole-v1 dynamics (Barto, Sutton & Anderson 1983) batched on
    torch tensors — the reference's f32 Euler integration, thresholds and
    500-step time limit (treated as ``done``), op for op."""

    obs_dim = 4
    num_actions = 2
    max_steps = 500
    reset_shape = (4,)

    _GRAVITY = 9.8
    _MASSCART = 1.0
    _MASSPOLE = 0.1
    _TOTAL_MASS = _MASSPOLE + _MASSCART
    _LENGTH = 0.5  # half the pole's length
    _POLEMASS_LENGTH = _MASSPOLE * _LENGTH
    _FORCE_MAG = 10.0
    _TAU = 0.02
    _THETA_THRESHOLD = 12 * 2 * math.pi / 360
    _X_THRESHOLD = 2.4

    @classmethod
    def reset_draw(cls, generator: torch.Generator, n: int, device) -> torch.Tensor:
        """(n, 4) uniform in [-0.05, 0.05), as ``jax.random.uniform``
        scales its draws."""
        u = torch.rand((n, 4), generator=generator, device=device)
        return torch.clamp(u * 0.1 + -0.05, min=-0.05)

    @classmethod
    def reset(cls, draw: torch.Tensor):
        phys = draw.to(torch.float32)
        state = {"phys": phys, "t": torch.zeros(phys.shape[0], dtype=torch.int32,
                                                 device=phys.device)}
        return state, phys

    @classmethod
    def step(cls, state, action, draw):
        phys = state["phys"]
        x, x_dot, theta, theta_dot = phys.unbind(-1)
        force = torch.where(action == 1, cls._FORCE_MAG, -cls._FORCE_MAG).to(phys.dtype)
        costheta = torch.cos(theta)
        sintheta = torch.sin(theta)
        temp = (
            force + cls._POLEMASS_LENGTH * (theta_dot * theta_dot) * sintheta
        ) / cls._TOTAL_MASS
        thetaacc = (cls._GRAVITY * sintheta - costheta * temp) / (
            cls._LENGTH
            * (4.0 / 3.0 - cls._MASSPOLE * (costheta * costheta) / cls._TOTAL_MASS)
        )
        xacc = temp - cls._POLEMASS_LENGTH * thetaacc * costheta / cls._TOTAL_MASS
        x = x + cls._TAU * x_dot
        x_dot = x_dot + cls._TAU * xacc
        theta = theta + cls._TAU * theta_dot
        theta_dot = theta_dot + cls._TAU * thetaacc
        phys = torch.stack([x, x_dot, theta, theta_dot], -1)
        t = state["t"] + 1

        terminated = (
            (torch.abs(x) > cls._X_THRESHOLD)
            | (torch.abs(theta) > cls._THETA_THRESHOLD)
        )
        done = terminated | (t >= cls.max_steps)
        reward = torch.ones_like(x)

        # SAME_STEP auto-reset: the returned obs after a done step is
        # the next episode's first obs; V-trace masks its bootstrap.
        reset_state, reset_obs = cls.reset(draw)
        next_state = {
            "phys": torch.where(done[:, None], reset_state["phys"], phys),
            "t": torch.where(done, reset_state["t"], t),
        }
        obs = torch.where(done[:, None], reset_obs, phys)
        return next_state, obs, reward, done.to(torch.float32)


TORCH_ENVS: Dict[str, Type] = {"CartPole-v1": TorchCartPole}


def register_torch_env(name: str, env_cls) -> None:
    """Register a batched torch env under ``name`` for PodracerConfig.env."""
    TORCH_ENVS[name] = env_cls


def get_torch_env(name: str):
    try:
        return TORCH_ENVS[name]
    except KeyError:
        raise ValueError(
            f"no torch env registered for {name!r} (have "
            f"{sorted(TORCH_ENVS)}); register one with register_torch_env()"
        ) from None
