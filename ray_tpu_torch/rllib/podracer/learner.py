"""Shared programs for both Podracer layouts (the port of
``podracer/learner.py``).

Everything here is a *factory of functions*: the acting loop (batched
env interaction producing a time-major V-trace batch) and the SGD update
(IMPALA or APPO loss, reused from the rllib algorithms). Anakin runs both
on its device each superstep; Sebulba runs the acting loop on the actor
workers and the sharded update on the learner, whose per-shard gradients
are averaged over a ``util.collective`` NCCL group (the reference's
``shard_map`` + ``psum / world`` over an ``XlaGroup`` mesh).
"""

from __future__ import annotations

from typing import Any, Dict, List

import numpy as np
import torch

from ..._private.device import resolve_device
from ...util.collective.types import AllReduceOptions, ReduceOp
from ..appo import make_appo_loss
from ..core import (
    MLPSpec,
    adam,
    forward,
    gumbel_argmax,
    take_along,
    to_tensors,
    tree_leaves,
    tree_map,
    value_and_grad,
)
from ..impala import make_impala_loss, make_loss_update

BATCH_KEYS = ("obs", "actions", "rewards", "dones", "logp_mu", "final_obs")


def shard_devices(device, n: int) -> List[torch.device]:
    """``n`` devices to shard over: ``n`` CPU "devices" for "cpu", else
    the first ``n`` cards this process sees (None: the GPU; raises without
    a card or with fewer than ``n``)."""
    dev = resolve_device(device)
    if dev.type == "cpu":
        return [dev] * n
    if torch.cuda.device_count() < n:
        raise RuntimeError(f"{n} GPUs wanted, this process sees {torch.cuda.device_count()}")
    return [torch.device("cuda", i) for i in range(n)]


def mix_seed(seed: int, *parts: int) -> int:
    """A generator seed from ``seed`` and ``parts`` (superstep, shard,
    actor, round): the port's form of ``fold_in``."""
    for p in parts:
        seed = (seed * 1_000_003 + p + 1) % (2**63)
    return seed


def select_loss(config, spec: MLPSpec):
    if config.loss == "appo":
        return make_appo_loss(config, spec)
    return make_impala_loss(config, spec)


def make_optimizer(config):
    """``optax.chain(clip_by_global_norm(grad_clip), adam(lr))``."""
    return adam(config.lr, config.grad_clip)


def make_acting_fns(env_cls, rollout_len: int):
    """(init_envs, act): the batched interaction programs.

    ``init_envs(generator, n, device)`` -> (env_state, obs, ep_ret) for n
    envs. ``act(params, env_state, obs, ep_ret, generator)`` runs
    ``rollout_len`` steps and returns ``(env_state, obs, ep_ret, batch,
    ep_sum, ep_n)`` where ``batch`` is the time-major (T, N) V-trace batch
    and ``ep_sum``/``ep_n`` (0-d tensors) aggregate episode returns
    completed during the fragment (the lag-free learning-progress signal).
    The fragment's randomness (the actions' Gumbel noise, the envs' reset
    draws) is drawn from ``generator`` in two calls up front.
    """

    def init_envs(generator, n: int, device):
        env_state, obs = env_cls.reset(env_cls.reset_draw(generator, n, device))
        return env_state, obs, torch.zeros(n, dtype=torch.float32, device=obs.device)

    @torch.no_grad()
    def act(params, env_state, obs, ep_ret, generator):
        n, dev = obs.shape[0], obs.device
        noise = torch.rand((rollout_len, n, env_cls.num_actions), generator=generator,
                           device=dev)
        resets = env_cls.reset_draw(generator, rollout_len * n, dev).view(
            rollout_len, n, *env_cls.reset_shape)
        steps: Dict[str, List[torch.Tensor]] = {
            k: [] for k in ("obs", "actions", "rewards", "dones", "logp_mu")}
        done_sum = torch.zeros((), device=dev)
        done_n = torch.zeros((), device=dev)
        for t in range(rollout_len):
            logits, _ = forward(params, obs)  # (N, A)
            actions = gumbel_argmax(logits, noise[t])
            logp = take_along(torch.log_softmax(logits, -1), actions)
            env_state, next_obs, rewards, dones = env_cls.step(env_state, actions, resets[t])
            ep_ret = ep_ret + rewards
            done_sum = done_sum + torch.sum(ep_ret * dones)
            done_n = done_n + torch.sum(dones)
            ep_ret = ep_ret * (1.0 - dones)
            for k, v in (("obs", obs), ("actions", actions), ("rewards", rewards),
                         ("dones", dones), ("logp_mu", logp)):
                steps[k].append(v)
            obs = next_obs
        batch = {k: torch.stack(v) for k, v in steps.items()}
        batch["final_obs"] = obs  # bootstrap obs; masked by dones in V-trace
        return env_state, obs, ep_ret, batch, done_sum, done_n

    return init_envs, act


def make_update_fn(config, spec: MLPSpec):
    """(optimizer, update): one SGD step over a time-major batch, on the
    params' device."""
    optimizer = make_optimizer(config)
    return optimizer, make_loss_update(select_loss(config, spec), optimizer)


def shard_batch(batch: Dict[str, Any], devices: List[torch.device]) -> List[Dict[str, torch.Tensor]]:
    """A global time-major batch cut along the env axis into one shard a
    device (axis 1 of the (T, N) arrays; ``final_obs`` is (N, obs_dim), so
    its env axis is 0), each shard on its device."""
    world = len(devices)
    out = [dict() for _ in devices]
    for k in BATCH_KEYS:
        v = batch[k]
        v = v if isinstance(v, torch.Tensor) else torch.as_tensor(np.asarray(v))
        axis = 0 if k == "final_obs" else 1
        if v.shape[axis] % world:
            raise ValueError(f"batch[{k!r}]'s env axis ({v.shape[axis]}) does not divide "
                             f"over {world} shards")
        for i, part in enumerate(torch.chunk(v, world, dim=axis)):
            out[i][k] = part
    return [to_tensors(s, d) for s, d in zip(out, devices)]


def make_sharded_update(config, spec: MLPSpec, group):
    """(optimizer, update) with the batch sharded over the learner
    collective ``group`` (a ``util.collective`` NCCL group of N devices,
    one process): ``update(params, opt_state, shards) -> (params,
    opt_state, metrics)`` takes one params tree and one optimizer state
    per rank (rank i's on device i, replicated) and one batch shard per
    rank (``shard_batch``); each rank computes grads on its shard, the
    grads and metrics are AVERAGE-reduced over the group in one flat
    buffer each, and every rank takes the same clip-and-Adam step. The
    metrics come back from rank 0, as 0-d tensors."""
    optimizer = make_optimizer(config)
    loss_fn = select_loss(config, spec)
    avg = AllReduceOptions(reduceOp=ReduceOp.AVERAGE)
    world = group.world_size

    def update(params, opt_state, shards):
        if not (len(params) == len(opt_state) == len(shards) == world):
            raise ValueError(f"the sharded update takes {world} params trees, optimizer "
                             "states and batch shards, one a rank")
        flat_grads, flat_metrics = [], []
        names = None
        for p, shard in zip(params, shards):
            (_, metrics), grads = value_and_grad(loss_fn, p, shard)
            names = list(metrics)
            flat_grads.append(torch.cat([g.reshape(-1) for g in grads]))
            flat_metrics.append(torch.stack([metrics[k] for k in names]))
        # the learner all-reduce: mean local grads over the group
        flat_grads = group.allreduce(flat_grads, avg)
        flat_metrics = group.allreduce(flat_metrics, avg)
        new_params, new_states = [], []
        for p, s, flat in zip(params, opt_state, flat_grads):
            leaves = tree_leaves(p)
            grads = list(torch.split(flat, [t.numel() for t in leaves]))
            grads = [g.view_as(t) for g, t in zip(grads, leaves)]
            p, s = optimizer.update(grads, s, p)
            new_params.append(p)
            new_states.append(s)
        return new_params, new_states, dict(zip(names, flat_metrics[0].unbind()))

    return optimizer, update


def replicate(tree: Any, devices: List[torch.device]) -> List[Any]:
    """One copy of ``tree`` a device (tensors copied; other leaves kept)."""
    return [tree_map(lambda x: x.to(d, copy=True) if isinstance(x, torch.Tensor) else x, tree)
            for d in devices]
