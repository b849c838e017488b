"""Sebulba: actor/learner split (Hessel et al. 2021 §3.2), the port of
``ray_tpu/rllib/podracer/sebulba.py``.

Topology: ``num_actors`` rollout workers and one learner worker,
gang-placed in two placement groups. Placement (the reference's SLICE on
TPU, PACK on CPU, read for GPUs):

- **SLICE**: one ``{"GPU": 1}`` bundle a role, when the cluster holds
  ``num_actors + 1`` GPUs; actors act on their card. (The port's
  runtime keeps its own SLICE strategy for chips with ICI coordinates,
  which GPUs do not report, so these groups are reserved as PACK.)
- **one or more GPUs, fewer than that**: the learner's bundle is
  ``{"GPU": learner_shards}``, the actors' ``{"CPU": 1}``, acting on the
  CPU.
- **PACK with ``device="cpu"``**: every bundle ``{"CPU": 1}``, everything
  on the CPU.

With ``device=None`` a cluster without a GPU raises; the learner never
runs off the card on a cluster that holds one (its task raises if it
finds none), and reports the device it ran on in its metrics.

Every data-plane hop rides the cheapest path the runtime has:

- **actor fan-out** — each round's ``sample_fragment`` tasks go out as
  ONE ``fn.map`` SUBMIT_TASKS frame (bulk submission);
- **trajectory hand-off** — each fragment returns a >=100KiB numpy
  rollout batch, which the result path encodes as a shm segment: only
  the segment *name* crosses the hub, the learner pulls bytes over the
  direct object plane — zero hub relay for rollout payloads;
- **learner all-reduce** — per-shard gradients AVERAGE-reduced over a
  cached ``util.collective`` NCCL group of ``learner_shards`` devices
  (``learner.make_sharded_update``; the reference's ``XlaGroup``);
- **param broadcast** — the learner publishes ``(version, params)`` as
  numpy on a version-tagged KV channel; actors poll it at fragment start
  and cache by version, so a stale learner never wedges the actor loop.

Fault model: the learner update is a *plain task* — a chaos
``worker_kill`` mid-update is survived by lineage retry (same input
state ref + same trajectory refs -> identical recomputed output), so
the step counter resumes monotonically from the last published state
and actors keep sampling against the last KV version throughout.
"""

from __future__ import annotations

import pickle
import time
from collections import deque
from typing import Any, Dict, List, Optional

import numpy as np
import torch

import ray_tpu_torch
from ...util import tracing
from ...util.scheduling_strategies import PlacementGroupSchedulingStrategy

# one process-wide cache per worker: acting programs, the learner's
# collective group, and the last fetched param version
_PROC_CACHE: Dict[Any, Any] = {}


def _kv_key(namespace: str) -> bytes:
    return f"podracer/{namespace}/params".encode()


def _acting_programs(config):
    """Per-process acting programs, keyed by what changes them (env,
    fragment length)."""
    from .learner import make_acting_fns

    key = ("act", config.env, config.rollout_fragment_length)
    progs = _PROC_CACHE.get(key)
    if progs is None:
        progs = make_acting_fns(config.env_cls, config.rollout_fragment_length)
        _PROC_CACHE[key] = progs
    return progs


def _fetch_params(client, config, device):
    """Actor-side half of the version-tagged param channel: read the
    KV blob, decode only on version change."""
    from ..core import params_from_numpy

    key = ("params", config.namespace, str(device))
    blob = client.kv_get(_kv_key(config.namespace))
    if blob is None:
        raise RuntimeError(
            f"no published params on {_kv_key(config.namespace)!r} — "
            "SebulbaDriver publishes version 0 before the first round"
        )
    version, params = pickle.loads(blob)
    cached = _PROC_CACHE.get(key)
    if cached is not None and cached[0] == version:
        return cached
    _PROC_CACHE[key] = (version, params_from_numpy(params, device))
    return _PROC_CACHE[key]


@ray_tpu_torch.remote
def sample_fragment(cfg_blob: bytes, actor_idx: int, round_idx: int, carry):
    """One actor's rollout fragment. Pure function of (config, carry,
    published params): chaos-killed instances replay losslessly via
    lineage. Returns ``(traj, carry')`` via num_returns=2 — ``traj``
    is the big time-major numpy batch (rides the object plane),
    ``carry'`` the small env-state continuation the driver threads
    forward."""
    from ray_tpu_torch._private import worker

    from ..core import params_to_numpy, to_tensors
    from .learner import mix_seed, shard_devices

    # the driver's blob: (config, the actors' device, the learner's);
    # "cuda" raises where the task sees no card
    config, actor_dev, _ = pickle.loads(cfg_blob)
    device = shard_devices(actor_dev, 1)[0]
    client = worker.get_client()

    with tracing.span(
        "podracer.param_sync", stage="podracer.param_sync",
        role="actor", actor=actor_idx,
    ):
        version, params = _fetch_params(client, config, device)

    init_envs, act = _acting_programs(config)
    with tracing.span(
        "podracer.env_step", stage="podracer.env_step",
        role="actor", actor=actor_idx, round=round_idx,
    ):
        if carry is None:
            gen = torch.Generator(device=device).manual_seed(
                mix_seed(config.seed, 7919 + actor_idx))
            env_state, obs, ep_ret = init_envs(gen, config.envs_per_actor, device)
        else:
            env_state = to_tensors(carry["env_state"], device)
            env_state["t"] = env_state["t"].to(torch.int32)
            obs, ep_ret = to_tensors({"obs": carry["obs"], "r": carry["ep_ret"]},
                                     device).values()
        frag_gen = torch.Generator(device=device).manual_seed(
            mix_seed(config.seed, 104729 + actor_idx, round_idx))
        env_state, obs, ep_ret, batch, ep_sum, ep_n = act(
            params, env_state, obs, ep_ret, frag_gen
        )

    traj = params_to_numpy(batch)
    traj["behavior_version"] = version
    new_carry = {
        "env_state": params_to_numpy(env_state),
        "obs": obs.cpu().numpy(),
        "ep_ret": ep_ret.cpu().numpy(),
        "ep_sum": float(ep_sum),
        "ep_n": float(ep_n),
        "behavior_version": version,
    }
    return traj, new_carry


def _learner_group(config, devices):
    key = ("group", config.namespace, tuple(str(d) for d in devices))
    group = _PROC_CACHE.get(key)
    if group is None:
        from ...util.collective.collective_group.nccl_group import NcclGroup

        group = NcclGroup(len(devices), 0, f"podracer-{config.namespace}", devices=devices)
        _PROC_CACHE[key] = group
    return group


@ray_tpu_torch.remote
def learner_update(cfg_blob: bytes, state, *trajs):
    """One learner round: ingest the handed-off fragments, run
    ``num_sgd_steps`` sharded updates (grad all-reduce over the
    collective group), publish params on the KV channel every
    ``param_sync_interval`` steps. Pure function of (state, trajs) —
    the KV publish is idempotent per version, so lineage retry after a
    worker_kill republishes the same bytes and resumes the counter."""
    from ray_tpu_torch._private import worker

    from ..core import params_from_numpy, params_to_numpy
    from .learner import make_sharded_update, replicate, shard_batch, shard_devices

    config, _, learner_dev = pickle.loads(cfg_blob)
    devices = shard_devices(learner_dev, config.learner_shards)
    client = worker.get_client()
    spec = config.spec

    with tracing.span(
        "podracer.traj_handoff", stage="podracer.traj_handoff",
        fragments=len(trajs),
        bytes=sum(sum(a.nbytes for a in t.values()
                      if isinstance(a, np.ndarray)) for t in trajs),
    ):
        batch = {
            k: np.concatenate(
                [t[k] for t in trajs], axis=0 if k == "final_obs" else 1
            )
            for k in ("obs", "actions", "rewards", "dones", "logp_mu",
                      "final_obs")
        }
        shards = shard_batch(batch, devices)

    group = _learner_group(config, devices)
    _, update = make_sharded_update(config, spec, group)
    params = replicate(params_from_numpy(state["params"], devices[0]), devices)
    opt_state = replicate(params_from_numpy(state["opt_state"], devices[0]), devices)
    with tracing.span(
        "podracer.learner_update", stage="podracer.learner_update",
        step=state["step"] + 1, shards=group.world_size,
    ):
        for _ in range(config.num_sgd_steps):
            params, opt_state, metrics = update(params, opt_state, shards)
        host_params = params_to_numpy(params[0])

    step = state["step"] + 1
    version = state["version"]
    new_state = {
        "params": host_params,
        "opt_state": params_to_numpy(opt_state[0]),
        "step": step,
        "version": version,
    }
    if step % config.param_sync_interval == 0:
        version = step
        new_state["version"] = version
        with tracing.span(
            "podracer.param_sync", stage="podracer.param_sync",
            role="learner", version=version,
        ):
            client.kv_put(
                _kv_key(config.namespace),
                pickle.dumps((version, host_params)),
            )
    out_metrics = {
        "step": step,
        "version": version,
        "device": str(devices[0]),
        "behavior_versions": sorted(
            {int(t.get("behavior_version", -1)) for t in trajs}
        ),
        **{k: float(v) for k, v in metrics.items()},
    }
    return new_state, out_metrics


def sebulba_layout(config, cluster: Dict[str, float]):
    """(strategy, actor bundle, learner bundle, actor device, learner
    device) for ``config`` on a cluster with these resources."""
    shards = max(1, config.learner_shards)
    if config.device is not None and torch.device(config.device).type == "cpu":
        cpu = {"CPU": 1}
        return config.placement_strategy or "PACK", cpu, cpu, "cpu", "cpu"
    gpus = int(cluster.get("GPU", 0))
    if gpus < shards:
        raise RuntimeError(
            f"the Sebulba learner wants {shards} GPU(s), the cluster holds {gpus}; "
            "pass device='cpu' to run on the CPU"
        )
    if config.placement_strategy in (None, "SLICE") and gpus >= config.num_actors + shards:
        return "SLICE", {"GPU": 1}, {"GPU": shards}, "cuda", "cuda"
    return config.placement_strategy or "PACK", {"CPU": 1}, {"GPU": shards}, "cpu", "cuda"


def _task_options(bundle: Dict[str, float]) -> Dict[str, float]:
    """A task's resources inside its bundle: the bundle's GPUs (so the
    runtime pins them) and no CPU beside them, or one CPU."""
    if bundle.get("GPU"):
        return {"num_gpus": bundle["GPU"], "num_cpus": 0}
    return {"num_cpus": 1}


class SebulbaDriver:
    """Round-based driver: each round is one bulk-submitted actor
    fan-out plus one learner task chained on the state ref. Up to
    ``max_inflight_rounds`` learner rounds run behind the actors —
    the Sebulba decoupling: actors never block on the learner (params
    arrive via the KV channel), the driver never touches rollout
    bytes (they flow actor -> object plane -> learner by reference).
    """

    def __init__(self, config):
        if not ray_tpu_torch.is_initialized():
            ray_tpu_torch.init(ignore_reinit_error=True)
        config.validate()
        self.config = config
        (strategy, actor_bundle, learner_bundle, actor_dev,
         learner_dev) = sebulba_layout(config, ray_tpu_torch.cluster_resources())
        self.layout = {"strategy": strategy, "actor_bundle": actor_bundle,
                       "learner_bundle": learner_bundle, "actor_device": actor_dev,
                       "learner_device": learner_dev}
        self._cfg_blob = pickle.dumps((config, actor_dev, learner_dev))

        # gang placement: the runtime's own SLICE needs chip coordinates,
        # which GPUs do not report, so GPU bundles are reserved as PACK
        from ...util.placement_group import placement_group

        pg_strategy = "PACK" if strategy == "SLICE" else strategy
        self._pg_actors = placement_group(
            [dict(actor_bundle) for _ in range(config.num_actors)],
            strategy=pg_strategy, name="podracer-actors",
        )
        self._pg_learner = placement_group(
            [dict(learner_bundle)], strategy=pg_strategy, name="podracer-learner",
        )
        if not (self._pg_actors.wait(60) and self._pg_learner.wait(60)):
            raise RuntimeError("Podracer placement groups failed to place")

        self._sample = sample_fragment.options(
            num_returns=2,
            scheduling_strategy=PlacementGroupSchedulingStrategy(
                self._pg_actors, -1
            ),
            **_task_options(actor_bundle),
        )
        self._learn = learner_update.options(
            num_returns=2,
            scheduling_strategy=PlacementGroupSchedulingStrategy(
                self._pg_learner, 0
            ),
            **_task_options(learner_bundle),
        )

        # initial state: version 0 published before the first round so
        # the actor loop can always make progress
        from ..core import init_mlp_module, params_to_numpy
        from .learner import make_optimizer

        params = init_mlp_module(
            torch.Generator().manual_seed(config.seed), config.spec, "cpu"
        )
        opt_state = make_optimizer(config).init(params)
        host_params = params_to_numpy(params)
        state = {
            "params": host_params,
            "opt_state": params_to_numpy(opt_state),
            "step": 0,
            "version": 0,
        }
        from ray_tpu_torch._private import worker as _worker

        _worker.get_client().kv_put(
            _kv_key(config.namespace),
            pickle.dumps((0, host_params)),
        )
        self._state_ref = ray_tpu_torch.put(state)
        self._carries: List[Optional[dict]] = [None] * config.num_actors
        self._round = 0
        self._ep_sum = 0.0
        self._ep_n = 0.0
        self._last_metrics: Dict[str, Any] = {"step": 0, "version": 0}

    # -- round machinery ----------------------------------------------
    def _submit_round(self, inflight: deque) -> None:
        items = [
            (self._cfg_blob, i, self._round, self._carries[i])
            for i in range(self.config.num_actors)
        ]
        rows = self._sample.map(items)
        traj_refs = [row[0] for row in rows]
        carry_refs = [row[1] for row in rows]
        self._state_ref, metrics_ref = self._learn.remote(
            self._cfg_blob, self._state_ref, *traj_refs
        )
        # hold the traj refs until the learner round is harvested so
        # the segments can't be freed under an in-flight (or chaos-
        # retried) learner task
        inflight.append((metrics_ref, traj_refs))
        self._round += 1

        # the actors' small continuations: fetched eagerly (they gate
        # the next round anyway), harvested for episode stats
        carries = ray_tpu_torch.get(carry_refs, timeout=300)
        self._carries = list(carries)
        for c in carries:
            self._ep_sum += c["ep_sum"]
            self._ep_n += c["ep_n"]

    def _harvest_one(self, inflight: deque) -> Dict[str, Any]:
        metrics_ref, _traj_refs = inflight.popleft()
        metrics = ray_tpu_torch.get(metrics_ref, timeout=300)
        self._last_metrics = metrics
        return metrics

    def train(self, num_rounds: int) -> Dict[str, Any]:
        """Run ``num_rounds`` actor->learner rounds; returns throughput
        and learning stats. Actor rounds pipeline up to
        ``max_inflight_rounds`` ahead of the learner chain."""
        cfg = self.config
        inflight: deque = deque()
        learner_steps: List[int] = []
        round_returns: List[float] = []
        t0 = time.perf_counter()
        for _ in range(num_rounds):
            before_n, before_sum = self._ep_n, self._ep_sum
            self._submit_round(inflight)
            dn = self._ep_n - before_n
            round_returns.append(
                (self._ep_sum - before_sum) / dn if dn > 0 else float("nan")
            )
            while len(inflight) > cfg.max_inflight_rounds:
                learner_steps.append(self._harvest_one(inflight)["step"])
        while inflight:
            learner_steps.append(self._harvest_one(inflight)["step"])
        elapsed = time.perf_counter() - t0
        env_steps = (
            num_rounds * cfg.num_actors * cfg.envs_per_actor
            * cfg.rollout_fragment_length
        )
        return {
            "mode": "sebulba",
            "rounds": num_rounds,
            "env_steps": env_steps,
            "time_s": elapsed,
            "steps_per_sec": env_steps / elapsed if elapsed > 0 else 0.0,
            "learner_steps": learner_steps,
            "learner_step": self._last_metrics.get("step", 0),
            "param_version": self._last_metrics.get("version", 0),
            "episode_return_mean": (
                self._ep_sum / self._ep_n if self._ep_n > 0 else float("nan")
            ),
            "num_episodes": int(self._ep_n),
            "reward_trajectory": round_returns,
            "learner_metrics": dict(self._last_metrics),
        }

    def stop(self) -> None:
        from ...util.placement_group import remove_placement_group

        for pg in (self._pg_actors, self._pg_learner):
            try:
                remove_placement_group(pg)
            except Exception:
                pass
