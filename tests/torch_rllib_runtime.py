"""The port's runtime for the RLlib test files: no GPU, one compute
thread a process.

``port_runtime(**env)`` starts ``ray_tpu_torch`` with four CPUs and
``RAY_TPU_TORCH_NUM_GPUS=0``, with ``env`` and ``OMP_NUM_THREADS=1`` in
the environment for as long as it runs (workers are spawned lazily and
inherit it) and torch's intra-op threads at 1 in this process: the RL
nets are a few 64-wide layers, for which each of several processes
spinning up a pool of threads on a shared host costs ten times the
arithmetic. Everything is restored on exit. Imports no JAX.
"""

import contextlib
import os

import torch

import ray_tpu_torch


@contextlib.contextmanager
def port_runtime(**env):
    env = {"RAY_TPU_TORCH_NUM_GPUS": "0", "OMP_NUM_THREADS": "1", **env}
    old_env = {k: os.environ.get(k) for k in env}
    old_threads = torch.get_num_threads()
    os.environ.update(env)
    torch.set_num_threads(1)
    try:
        ray_tpu_torch.init(num_cpus=4, max_workers=4)
        yield ray_tpu_torch
    finally:
        ray_tpu_torch.shutdown()
        torch.set_num_threads(old_threads)
        for k, v in old_env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
