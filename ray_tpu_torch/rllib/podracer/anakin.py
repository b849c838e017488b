"""Anakin: env step and learner update in one loop on the device.

The architecture from Hessel et al. 2021 §3.1, ported from
``ray_tpu/rllib/podracer/anakin.py``: batched torch envs and the SGD
update run back to back on the worker's card each superstep (the acting
loop feeding straight into the gradient step, then clip and Adam), with
the whole carry (params, Adam state, env state, obs, episode returns)
resident on the device. The reference compiles the superstep ahead of
time into one XLA program; here it runs eagerly, a few hundred small
kernel launches a superstep. The driver never re-dispatches per step: a
compiled-DAG resident exec loop parks on the worker, and each host
"tick" is pure shm-channel I/O (one command array in, one metrics array
out) covering ``anakin_supersteps_per_call`` supersteps.

Placement: the worker asks for ``num_gpus=anakin_num_devices`` (the
port's runtime starts a worker without GPU ids with
``CUDA_VISIBLE_DEVICES=""``, so an unpinned worker would see no card);
one that still finds none raises and never runs on the CPU instead.
With ``device="cpu"`` it asks for none and runs on the CPU. With more
than one device the env axis is sharded over them and the update is
``learner.make_sharded_update`` over an NCCL group of those devices
(``["cpu"] * N`` on the CPU), so Anakin and Sebulba share one sharded
update.

Determinism: the whole tick stream is a pure function of
``config.seed``: superstep k draws from a generator seeded from
``(seed, k)`` (and the shard), the port's form of
``fold_in(seed_key, k)``, so a same-seed run reproduces the metrics
bitwise on the CPU, and on the card given deterministic cuBLAS
(``CUBLAS_WORKSPACE_CONFIG``).
"""

from __future__ import annotations

import dataclasses
import pickle
import time
from typing import Any, Dict, List

import numpy as np
import torch

from ...util import tracing
from ..core import init_mlp_module
from .learner import (
    make_acting_fns,
    make_sharded_update,
    make_update_fn,
    mix_seed,
    replicate,
    shard_devices,
)

CMD_DIM = 2  # [tick_index, reserved]
METRICS_DIM = 10
# metrics vector layout (float32):
#   0 ticks_done      1 updates_total    2 env_steps_total
#   3 ep_return_sum   4 ep_return_count  (cumulative completed episodes)
#   5 policy_loss     6 vf_loss          7 entropy   (last superstep)
#   8 ep_return_sum_tick  9 ep_return_count_tick  (this tick only)


def _sync(devices) -> None:
    for d in set(devices):
        if d.type == "cuda":
            torch.cuda.synchronize(d)


class AnakinWorker:
    """The single resident actor: owns the devices, the carry (params,
    opt_state, env state) and the superstep."""

    def __init__(self, config_blob: bytes):
        config = pickle.loads(config_blob)
        self.config = config
        self.devices = shard_devices(config.device, config.anakin_num_devices or 1)
        n_dev = len(self.devices)
        if config.num_envs % n_dev != 0:
            raise ValueError(
                f"num_envs ({config.num_envs}) must divide over the "
                f"{n_dev} devices"
            )
        spec = config.spec
        init_envs, self._act = make_acting_fns(
            config.env_cls, config.rollout_fragment_length)
        if n_dev == 1:
            optimizer, update = make_update_fn(config, spec)
            self._update = lambda p, s, b: _one(update, p, s, b)
        else:
            from ...util.collective.collective_group.nccl_group import NcclGroup

            group = NcclGroup(n_dev, 0, f"anakin-{config.seed}", devices=self.devices)
            optimizer, self._update = make_sharded_update(config, spec, group)

        # -- the carry, one replica (params, opt_state) and one env shard
        # a device
        params = init_mlp_module(torch.Generator().manual_seed(config.seed), spec,
                                 self.devices[0])
        params = replicate(params, self.devices)
        opt_state = [optimizer.init(p) for p in params]
        per = config.num_envs // n_dev
        envs = [init_envs(self._generator(d, -1, i), per, d)
                for i, d in enumerate(self.devices)]
        self._carry = (params, opt_state, envs)
        self._supersteps = 0
        self._ticks = 0
        self._ep_sum = 0.0
        self._ep_n = 0.0
        self._last_losses = (0.0, 0.0, 0.0)
        self._steps_per_superstep = (
            config.rollout_fragment_length * config.num_envs
        )

    def ready(self) -> bool:
        return True

    def device(self) -> str:
        """Where the carry lives ("cuda:0", or "cpu")."""
        return str(self.devices[0])

    def _generator(self, device, superstep: int, shard: int) -> torch.Generator:
        """The generator of ``shard`` at ``superstep`` (-1: the envs'
        initial states)."""
        return torch.Generator(device=device).manual_seed(
            mix_seed(self.config.seed, superstep + 1, shard))

    def _act_all(self, params, envs):
        """The acting loop on every shard; returns (envs', batches,
        ep_sum, ep_n), the episode sums as 0-d tensors on device 0."""
        k = self._supersteps
        out, batches, sums, ns = [], [], [], []
        for i, (p, (env_state, obs, ep_ret), d) in enumerate(zip(params, envs, self.devices)):
            env_state, obs, ep_ret, batch, ep_sum, ep_n = self._act(
                p, env_state, obs, ep_ret, self._generator(d, k, i))
            out.append((env_state, obs, ep_ret))
            batches.append(batch)
            sums.append(ep_sum.to(self.devices[0]))
            ns.append(ep_n.to(self.devices[0]))
        return out, batches, sum(sums), sum(ns)

    def _fold_stats(self, ep_sum, ep_n, metrics):
        vals = torch.stack([ep_sum, ep_n, metrics["policy_loss"], metrics["vf_loss"],
                            metrics["entropy"]]).tolist()
        self._last_losses = tuple(vals[2:])
        return vals[0], vals[1]

    def _superstep(self):
        params, opt_state, envs = self._carry
        envs, batches, ep_sum, ep_n = self._act_all(params, envs)
        params, opt_state, metrics = self._update(params, opt_state, batches)
        self._carry = (params, opt_state, envs)
        self._supersteps += 1
        return self._fold_stats(ep_sum, ep_n, metrics)

    def _tick_fused(self, n: int):
        tick_sum = tick_n = 0.0
        for _ in range(n):
            s, c = self._superstep()
            tick_sum += s
            tick_n += c
        return tick_sum, tick_n

    def _tick_traced(self, n: int):
        """Trace mode: the acting loop and the update each get their own
        span, each ended by a device synchronize so the span holds the
        device's time. Slower than the untraced loop; only taken when
        tracing is live."""
        tick_sum = tick_n = 0.0
        for _ in range(n):
            params, opt_state, envs = self._carry
            with tracing.span(
                "podracer.env_step", stage="podracer.env_step", mode="anakin"
            ):
                envs, batches, ep_sum, ep_n = self._act_all(params, envs)
                _sync(self.devices)
            with tracing.span(
                "podracer.learner_update",
                stage="podracer.learner_update",
                mode="anakin",
            ):
                params, opt_state, metrics = self._update(params, opt_state, batches)
                _sync(self.devices)
            self._carry = (params, opt_state, envs)
            self._supersteps += 1
            s, c = self._fold_stats(ep_sum, ep_n, metrics)
            tick_sum += s
            tick_n += c
        return tick_sum, tick_n

    def tick(self, cmd: np.ndarray) -> np.ndarray:
        """One resident-loop turn: run ``anakin_supersteps_per_call``
        supersteps, return the fixed-shape metrics vector."""
        n = self.config.anakin_supersteps_per_call
        if tracing.is_enabled():
            tick_sum, tick_n = self._tick_traced(n)
        else:
            tick_sum, tick_n = self._tick_fused(n)
        self._ep_sum += tick_sum
        self._ep_n += tick_n
        pi_l, vf_l, ent = self._last_losses
        self._ticks += 1
        return np.array(
            [
                self._ticks,
                self._supersteps,
                self._supersteps * self._steps_per_superstep,
                self._ep_sum,
                self._ep_n,
                pi_l,
                vf_l,
                ent,
                tick_sum,
                tick_n,
            ],
            dtype=np.float32,
        )


def _one(update, params, opt_state, batches):
    """The one-device update in the sharded update's list form."""
    p, s, metrics = update(params[0], opt_state[0], batches[0])
    return [p], [s], metrics


class AnakinDriver:
    """Drives the resident AnakinWorker through a channel-compiled DAG:
    ``train(n)`` is n shm ring-buffer round trips, zero scheduler
    round trips after compile."""

    def __init__(self, config):
        import ray_tpu_torch

        if not ray_tpu_torch.is_initialized():
            ray_tpu_torch.init(ignore_reinit_error=True)
        self._ray = ray_tpu_torch
        config.validate()
        on_cpu = config.device is not None and torch.device(config.device).type == "cpu"
        if not on_cpu:
            gpus = int(ray_tpu_torch.cluster_resources().get("GPU", 0))
            if config.anakin_num_devices is None:
                config = dataclasses.replace(config, anakin_num_devices=max(gpus, 1))
            if gpus < config.anakin_num_devices:
                raise RuntimeError(
                    f"Anakin wants {config.anakin_num_devices} GPU(s), the cluster "
                    f"holds {gpus}; pass device='cpu' to run on the CPU"
                )
        self.config = config
        blob = pickle.dumps(config)
        worker_cls = ray_tpu_torch.remote(
            num_gpus=0 if on_cpu else config.anakin_num_devices)(AnakinWorker)
        self._worker = worker_cls.remote(blob)
        ray_tpu_torch.get(self._worker.ready.remote(), timeout=300)
        self.device = ray_tpu_torch.get(self._worker.device.remote(), timeout=60)
        self._compiled = None
        if config.use_compiled_dag:
            from ...dag import InputNode

            with InputNode() as inp:
                dag = self._worker.tick.bind(
                    inp.with_shm_channel((CMD_DIM,), "float32")
                ).with_shm_channel((METRICS_DIM,), "float32")
            self._compiled = dag.experimental_compile(
                max_inflight_executions=2
            )
        self._tick_idx = 0
        self._env_steps_seen = 0.0

    def _tick(self, timeout: float = 300.0) -> np.ndarray:
        cmd = np.array([self._tick_idx, 0], dtype=np.float32)
        self._tick_idx += 1
        if self._compiled is not None:
            return self._compiled.execute(cmd).get(timeout=timeout)
        return self._ray.get(self._worker.tick.remote(cmd), timeout=timeout)

    def train(self, num_ticks: int) -> Dict[str, Any]:
        """Run ``num_ticks`` resident-loop turns; returns aggregate
        throughput plus the per-tick reward trajectory (bitwise
        reproducible for a given seed)."""
        rows: List[np.ndarray] = []
        t0 = time.perf_counter()
        for _ in range(num_ticks):
            rows.append(self._tick())
        elapsed = time.perf_counter() - t0
        last = rows[-1]
        env_steps = float(last[2]) - self._env_steps_seen
        self._env_steps_seen = float(last[2])
        trajectory = [
            (float(r[8] / r[9]) if r[9] > 0 else float("nan")) for r in rows
        ]
        return {
            "mode": "anakin",
            "device": self.device,
            "ticks": int(last[0]),
            "updates": int(last[1]),
            "env_steps_total": int(last[2]),
            "env_steps": int(env_steps),
            "time_s": elapsed,
            "steps_per_sec": env_steps / elapsed if elapsed > 0 else 0.0,
            "episode_return_mean": (
                float(last[3] / last[4]) if last[4] > 0 else float("nan")
            ),
            "num_episodes": int(last[4]),
            "policy_loss": float(last[5]),
            "vf_loss": float(last[6]),
            "entropy": float(last[7]),
            "reward_trajectory": trajectory,
            "metrics_rows": np.stack(rows),
        }

    def stop(self) -> None:
        if self._compiled is not None:
            self._compiled.teardown()
            self._compiled = None
        try:
            self._ray.kill(self._worker)
        except Exception:
            pass
