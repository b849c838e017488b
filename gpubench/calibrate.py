"""The readings that each limit of ``limits/<cell>.json`` is set from, on
the cell's cards (no trainer, no window):

    python3 -m gpubench.calibrate --workload <cell> --seeds 1,2,3 \
        [--control 1,2,3] [--half 1,2,3]

For each seed the program's first steps (``program.first_steps``, the
train loop's own set-up at the cell's sizes) give its readings; the
float32 reference of the same seed gives its own; ``check.gaps`` compares
them. ``--half`` also runs the program with half of each batch left out of
the loss (a fault the check must catch); ``--control`` puts the reference
computed with float8 operands in the program's place (the control, one
precision below the program's bf16). A state left unchanged reads 1 on
both leaf gaps by construction and needs no run. One JSON line a reading.

A cell laid over a mesh runs in one process a card (this command again,
with ``--rank``), a process group over NCCL: each seed's program over the
cell's mesh, then the reference (and the control) over the same cards, as
``reference.run`` spreads it; rank 0 prints.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time

import torch
import torch.distributed as dist

from . import banned_loaded, check, program, reference, registry


def _free():
    gc.collect()
    torch.cuda.empty_cache()


def _ints(text: str):
    return [int(s) for s in text.split(",") if s]


def readings(args, dev, mesh=None, rank: int = 0, world: int = 1) -> None:
    """Every reading ``args`` asks for, printed by rank 0."""
    cell = registry.workload(args.workload)
    cfg, traffic = registry.config(cell["config"]), registry.traffic(cell["traffic"])

    def emit(seed, kind, prog, ref, seconds):
        if rank != 0:
            return
        row = {"workload": args.workload, "seed": seed, "kind": kind, "seconds": seconds,
               **check.gaps(prog, ref), "losses": prog["losses"], "ref_losses": ref["losses"]}
        for key in ("grad_norms", "update_norms"):      # each leaf's gap and norms, for the look
            floor = check.median(list(ref[key].values()))
            row[f"leaf_{key}"] = {n: [prog[key][n], r, abs(prog[key][n] - r) / max(r, floor)]
                                  for n, r in ref[key].items()}
        print(json.dumps(row), flush=True)

    for seed in args.seeds:
        runs = {}
        for fault in [None] + (["half"] if seed in args.half else []):
            t0 = time.time()
            state, step = program.setup(cfg, traffic, seed, dev, fault, mesh)
            state, runs[fault] = program.first_steps(state, step, cfg, traffic, seed, dev, fault,
                                                     mesh=mesh)
            del state, step
            _free()
            runs[fault]["seconds"] = time.time() - t0
        t0 = time.time()
        pins = runs[None].get("pins")
        ref = reference.steps(cfg, traffic, seed, dev, reference.Numerics(), pins, rank, world)
        ref_s = time.time() - t0
        _free()
        for fault, got in runs.items():
            emit(seed, fault or "program", got, ref, got["seconds"])
        if rank == 0:
            print(json.dumps({"workload": args.workload, "seed": seed, "kind": "reference_seconds",
                              "seconds": ref_s}), flush=True)
        if seed in args.control:
            t0 = time.time()
            ctrl = reference.steps(cfg, traffic, seed, dev, reference.Numerics(fp8=True), pins,
                                   rank, world)
            _free()
            emit(seed, "control", ctrl, ref, time.time() - t0)


def _rank_main(args) -> None:
    from ray_tpu_torch import parallel

    cell = registry.workload(args.workload)
    torch.cuda.set_device(args.rank)
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{args.port}", rank=args.rank,
                            world_size=cell["chips"])
    try:
        dev = torch.device("cuda", args.rank)
        readings(args, dev, parallel.make_mesh(device=dev, **cell["mesh"]), args.rank, cell["chips"])
    finally:
        dist.destroy_process_group()


def main(argv) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m gpubench.calibrate")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=_ints, required=True)
    ap.add_argument("--control", type=_ints, default=[])
    ap.add_argument("--half", type=_ints, default=[])
    ap.add_argument("--rank", type=int, default=None, help=argparse.SUPPRESS)   # a mesh's ranks
    ap.add_argument("--port", type=int, default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    cell = registry.workload(args.workload)
    if "mesh" not in cell:
        readings(args, torch.device("cuda", 0))
    elif args.rank is not None:
        _rank_main(args)
    else:
        port = reference.free_port()
        reference.run_ranks([[sys.executable, "-m", f"{__package__}.calibrate", *argv,
                              "--rank", str(r), "--port", str(port)] for r in range(cell["chips"])])
    banned = banned_loaded()
    if banned:
        print(f"gpubench.calibrate: modules that no run may load were loaded: {banned}",
              file=sys.stderr)
        return 3
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
