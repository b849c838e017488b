#!/usr/bin/env python3
"""Peak device memory by phase of a benchmark cell's train step, on one
NVIDIA GPU:

    python3 peak_by_phase.py <cell> <seed> [steps]

Runs from the root of a checkout (the tree whose ``ray_tpu_torch`` is
read). It builds the cell's model, weights, optimizer and batches as
``gpubench`` does, then runs ``steps`` (default 3) train steps of
``parallel.make_train_step`` with ``torch.cuda.max_memory_allocated``
reset and read around each phase: the forward (``loss_fn``), the
backward (from the forward's end to the optimizer's start) and the
update (``default_optimizer``'s update). Prints one line a step: each
phase's peak and the memory held after the step, in GiB. The probe
wraps the loss function and the optimizer's update in this script, so
no file that a benchmark cell runs carries it.
"""

import os
import sys

import torch


def main(argv) -> int:
    if len(argv) not in (2, 3):
        print(f"usage: {sys.argv[0]} <cell> <seed> [steps]", file=sys.stderr)
        return 2
    cell, seed = argv[0], int(argv[1])
    steps = int(argv[2]) if len(argv) == 3 else 3
    sys.path.insert(0, os.getcwd())
    from gpubench import program, registry, traffic, weights
    from ray_tpu_torch import parallel

    wl = registry.workload(cell)
    cfg, tr = registry.config(wl["config"]), registry.traffic(wl["traffic"])
    dev = torch.device("cuda")
    mcfg, loss_fn = program.model_config(cfg)
    params = weights.make(cfg, seed, dev)
    opt = parallel.default_optimizer(**tr["optimizer"])
    state = parallel.create_train_state(None, lambda _g: params, opt, dev)
    peaks = {}

    def gib() -> float:
        return torch.cuda.max_memory_allocated(dev) / 2**30

    def forward(p, b):
        torch.cuda.reset_peak_memory_stats(dev)
        out = loss_fn(p, b, mcfg)
        peaks["forward"] = gib()
        torch.cuda.reset_peak_memory_stats(dev)
        return out

    def update(grads, s, prm, gnorm=None):
        peaks["backward"] = gib()
        torch.cuda.reset_peak_memory_stats(dev)
        out = opt.update(grads, s, prm, gnorm)
        peaks["update"] = gib()
        return out

    step = parallel.make_train_step(
        forward, parallel.Optimizer(opt.init, update, opt.learning_rate))
    for k in range(1, steps + 1):
        state, _ = step(state, traffic.batch(tr, cfg["vocab_size"], seed, k, dev))
        torch.cuda.synchronize()
        print(f"peak_by_phase {cell} step {k}: "
              + ", ".join(f"{n} {v:.4f} GiB" for n, v in peaks.items())
              + f"; after the step {torch.cuda.memory_allocated(dev) / 2**30:.4f} GiB",
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
