"""Plain float32 reference of the training steps the cells drive.

It imports nothing of the program. From the seed it makes the same
weights (``weights.py``) and batches (``traffic.py``) the program is
given, and works out the first ``check_steps`` steps itself: the loss and
gradients of the configuration's model from its family's ``Model``
(``families/<family>.py``), then what every family shares, here:

- clip by global norm, then AdamW (optax's formulas, bias-corrected, the
  weight decay added to the Adam direction, a warmup-cosine schedule read
  before the count is incremented); the moments live on the host between
  steps.

Every product is float32 with TF32 off. ``Numerics(fp8=True)`` rounds both
operands of every product (forward and backward) to float8 e4m3 with one
scale per tensor: the control, one precision below the program's bf16.

A cell laid over several cards is worked out over as many cards, in
processes of the reference's own (``run(..., ranks=n)``, one process a
card, a process group of their own): each holds the whole tree and takes
its share of the batch's rows one sequence at a time, the gradient of each
sequence's loss added into one tree; the ranks' trees are summed before
the clip. Each rank updates its share of the leaves' layers, their
moments on its host, and sends them to the others.
"""

from __future__ import annotations

import json
import math
import os
import socket
import subprocess
import sys
import time
from typing import Dict, List, Optional

import torch
import torch.distributed as dist

from . import banned_loaded, registry
from . import traffic as traffic_gen
from . import weights

F8_MAX = 448.0


def to_fp8(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to float8 e4m3 with one scale for the tensor (its
    largest magnitude goes to 448), returned in ``t``'s dtype."""
    amax = t.detach().abs().amax().float()
    scale = torch.where(amax > 0, F8_MAX / amax, torch.ones_like(amax))
    q = (t * scale).clamp_(-F8_MAX, F8_MAX).to(torch.float8_e4m3fn)
    return q.to(t.dtype) / scale


class _MatmulFP8(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return to_fp8(a) @ to_fp8(b)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        g8 = to_fp8(g)
        return g8 @ to_fp8(b).transpose(-1, -2), to_fp8(a).transpose(-1, -2) @ g8


class Numerics:
    """How the reference multiplies: float32, or float8 operands (the control)."""

    def __init__(self, fp8: bool = False):
        self.fp8 = fp8

    def q(self, t: torch.Tensor) -> torch.Tensor:
        return to_fp8(t) if self.fp8 else t

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """a (n, k) @ b (k, m), differentiable."""
        return _MatmulFP8.apply(a, b) if self.fp8 else a @ b


def schedule(opt: dict, count: int) -> float:
    """optax.warmup_cosine_decay_schedule(0, peak, warmup, max(total,
    warmup + 1)) at ``count``."""
    peak, warm = opt.get("learning_rate", 3e-4), opt.get("warmup_steps", 100)
    decay = max(opt.get("total_steps", 10000), warm + 1)
    if count < warm:
        return peak * count / warm
    t = min(count - warm, decay - warm)
    return peak * 0.5 * (1 + math.cos(math.pi * t / (decay - warm)))


def _flat(tree: dict, prefix: str = "") -> Dict[str, torch.Tensor]:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = v
    return out


def run(cfg: dict, traffic: dict, seed: int, device, num: Numerics = None, ranks: int = 1,
        pins: Optional[list] = None, workdir: Optional[str] = None) -> dict:
    """The reference's readings of the first ``check_steps`` steps: each
    step's loss, each leaf's gradient norm and a seeded sample of its
    elements in the first step (before clipping), and each leaf's change
    after the last, its norm and its elements at the same positions.

    ``ranks`` > 1: worked out over that many cards of ``device``'s type in
    processes of their own, which leave their result in ``workdir``.
    ``pins``: each check step's pins, one entry a row (the family's
    ``pins``), handed to the model with the rows they belong to."""
    num = num or Numerics()
    if ranks == 1:
        return steps(cfg, traffic, seed, device, num, pins)
    return _spread(cfg, traffic, seed, torch.device(device).type, num, ranks, pins, workdir)


def steps(cfg: dict, traffic: dict, seed: int, device, num: Numerics, pins: Optional[list] = None,
          rank: int = 0, world: int = 1) -> Optional[dict]:
    """``run``'s readings, worked out in this process, or as rank ``rank``
    of ``world`` ranks of the default process group: the readings on rank
    0, None on the others."""
    opt = traffic["optimizer"]
    b1, b2, eps = opt.get("b1", 0.9), opt.get("b2", 0.95), 1e-8
    wd, clip = opt.get("weight_decay", 0.1), opt.get("grad_clip", 1.0)
    tf32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        layered = {lf.name: lf.shape[0] if lf.layered else None for lf in weights.leaves(cfg)}
        params = weights.make(cfg, seed, device)
        flat = _flat(params)
        model = registry.family(cfg["program"]["family"]).Model(cfg, num)
        # what one rank updates: whole leaves in one process, layers over ranks
        units = {n: [None] if world == 1 or layered[n] is None else list(range(layered[n]))
                 for n in flat}
        moments = None
        out = {"losses": []}
        for step in range(1, traffic["check_steps"] + 1):
            tokens = traffic_gen.batch(traffic, cfg["vocab_size"], seed, step, device)["tokens"]
            step_pins = pins[step - 1] if pins else None
            if world == 1:
                loss, grads = model.loss_and_grads(params, tokens, pins=step_pins)
            else:
                loss, grads = _share(model, params, tokens, step_pins, rank, world)
            g = _flat(grads)
            norms = {n: float(torch.linalg.vector_norm(t)) for n, t in g.items()}
            gnorm = math.sqrt(sum(v * v for v in norms.values()))
            out["losses"].append(loss)
            if step == 1 and rank == 0:
                out["grad_norms"] = norms
                out["grad_sample"] = weights.sample(cfg, seed, grads)
            factor = 1.0 if gnorm < clip else clip / gnorm
            lr = schedule(opt, step - 1)
            bc1, bc2 = 1 - b1 ** step, 1 - b2 ** step
            new_moments = {}
            i = 0
            for n, p in flat.items():
                gl = g.pop(n)
                for l in units[n]:
                    i += 1
                    if (i - 1) % world != rank:
                        continue
                    pu = p if l is None else p[l]
                    gc = (gl if l is None else gl[l]).mul_(factor)
                    if moments is None:
                        mu, nu = (1 - b1) * gc, (1 - b2) * gc * gc
                    else:
                        mu, nu = (t.to(device) for t in moments.pop((n, l)))
                        mu.mul_(b1).add_((1 - b1) * gc)
                        nu.mul_(b2).add_((1 - b2) * gc * gc)
                    del gc
                    u = (mu / bc1) / ((nu / bc2).sqrt_() + eps) + wd * pu
                    pu.sub_(lr * u)
                    del u
                    if step < traffic["check_steps"]:
                        new_moments[(n, l)] = (mu.cpu(), nu.cpu())
                    del mu, nu
                del gl
            del grads, g
            moments = new_moments
            if world > 1:       # every rank's updated layers to every rank
                i = 0
                for n, p in flat.items():
                    for l in units[n]:
                        dist.broadcast(p if l is None else p[l], src=i % world)
                        i += 1
        del moments
        if rank != 0:
            return None
        out["update_norms"], out["update_sample"] = weights.change(cfg, seed, params)
        return out
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32


def _share(model, params: dict, tokens: torch.Tensor, pins: Optional[list], rank: int,
           world: int):
    """(the batch's mean loss, the gradient tree of it) summed over the
    ranks, this rank taking its block of rows one sequence at a time."""
    B = tokens.shape[0]
    if B % world:
        raise ValueError(f"a batch of {B} rows does not split over {world} ranks")
    grads, total = None, 0.0
    for b in range(rank * B // world, (rank + 1) * B // world):
        loss, grads = model.loss_and_grads(params, tokens[b:b + 1], grads, scale=1.0 / B,
                                           pins=pins[b:b + 1] if pins else None)
        total += loss
    for t in _flat(grads).values():
        dist.all_reduce(t)
    summed = torch.tensor(total, dtype=torch.float64, device=tokens.device)
    dist.all_reduce(summed)
    return float(summed) / B, grads


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _spread(cfg, traffic, seed, device_type: str, num: Numerics, ranks: int, pins, workdir):
    """``steps`` over ``ranks`` processes of their own, one card each
    (gloo on the CPU), started as ``python3 -m gpubench.reference <job>
    <rank>``; a rank that fails ends the others."""
    path = os.path.join(workdir, "reference.json")
    job = {"cfg": cfg, "traffic": traffic, "seed": seed, "device_type": device_type,
           "fp8": num.fp8, "pins": pins, "port": free_port(), "world": ranks, "out": path}
    job_path = os.path.join(workdir, "reference-job.json")
    with open(job_path, "w") as f:
        json.dump(job, f)
    run_ranks([[sys.executable, "-m", f"{__package__}.reference", job_path, str(r)]
               for r in range(ranks)], stdout=sys.stderr)
    with open(path) as f:
        return json.load(f)


def run_ranks(commands: List[List[str]], stdout=None) -> None:
    """Run one process a command (the ranks of a process group, their
    standard output to ``stdout``, this one's by default) and wait for them
    all; where one fails, end the others, which would wait on it, and raise."""
    procs = [subprocess.Popen(c, stdout=stdout) for c in commands]
    try:
        while True:
            codes = [p.poll() for p in procs]
            if any(c not in (None, 0) for c in codes):
                raise RuntimeError(f"a rank failed: exit codes {codes}")
            if all(c == 0 for c in codes):
                return
            time.sleep(0.2)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()


def _rank_main(job: dict, rank: int) -> int:
    """One rank of ``_spread``: rank 0 writes the readings to ``job["out"]``.
    Returns 3, with the readings unwritten, where this process has loaded a
    module that no run may load, else 0."""
    if job["device_type"] == "cuda":
        torch.cuda.set_device(rank)
        device, backend = torch.device("cuda", rank), "nccl"
    else:
        device, backend = torch.device("cpu"), "gloo"
    dist.init_process_group(backend, init_method=f"tcp://127.0.0.1:{job['port']}", rank=rank,
                            world_size=job["world"])
    try:
        out = steps(job["cfg"], job["traffic"], job["seed"], device, Numerics(job["fp8"]),
                    job["pins"], rank, job["world"])
    finally:
        dist.destroy_process_group()
    banned = banned_loaded()
    if banned:
        print(f"gpubench.reference rank {rank}: modules that no run may load were loaded: "
              f"{banned}", file=sys.stderr)
        return 3
    if rank == 0:
        with open(job["out"], "w") as f:
            json.dump(out, f)
    return 0


if __name__ == "__main__":
    with open(sys.argv[1]) as f:
        sys.exit(_rank_main(json.load(f), int(sys.argv[2])))
