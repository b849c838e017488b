"""The readings that each limit of ``limits/<cell>.json`` is set from, in
one process on the card (no trainer, no window):

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
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time

import torch

from . import check, program, reference, registry


def _free():
    gc.collect()
    torch.cuda.empty_cache()


def _ints(text: str):
    return [int(s) for s in text.split(",") if s]


def main(argv) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m gpubench.calibrate")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=_ints, required=True)
    ap.add_argument("--control", type=_ints, default=[])
    ap.add_argument("--half", type=_ints, default=[])
    args = ap.parse_args(argv)
    cell = registry.workload(args.workload)
    cfg, traffic = registry.config(cell["config"]), registry.traffic(cell["traffic"])
    dev = torch.device("cuda", 0)

    def emit(seed, kind, readings, ref, seconds):
        row = {"workload": args.workload, "seed": seed, "kind": kind, "seconds": seconds,
               **check.gaps(readings, ref), "losses": readings["losses"],
               "ref_losses": ref["losses"]}
        for key in ("grad_norms", "update_norms"):      # each leaf's gap and norms, for the look
            floor = check.median(list(ref[key].values()))
            row[f"leaf_{key}"] = {n: [readings[key][n], r, abs(readings[key][n] - r) / max(r, floor)]
                                  for n, r in ref[key].items()}
        print(json.dumps(row), flush=True)

    for seed in args.seeds:
        runs = {}
        for fault in [None] + (["half"] if seed in args.half else []):
            t0 = time.time()
            state, step = program.setup(cfg, traffic, seed, dev, fault)
            state, runs[fault] = program.first_steps(state, step, cfg, traffic, seed, dev, fault)
            del state, step
            _free()
            runs[fault]["seconds"] = time.time() - t0
        t0 = time.time()
        ref = reference.run(cfg, traffic, seed, dev)
        ref_s = time.time() - t0
        _free()
        for fault, readings in runs.items():
            emit(seed, fault or "program", readings, ref, readings["seconds"])
        print(json.dumps({"workload": args.workload, "seed": seed, "kind": "reference_seconds",
                          "seconds": ref_s}), flush=True)
        if seed in args.control:
            t0 = time.time()
            ctrl = reference.run(cfg, traffic, seed, dev, reference.Numerics(fp8=True))
            _free()
            emit(seed, "control", ctrl, ref, time.time() - t0)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
