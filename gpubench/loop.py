"""The train loop the cell's ``TorchTrainer`` runs on its worker, written
as a user writes one: build the state and the step, run the steps,
``train.report`` the loss after each.

Set-up (counted in ``setup_s``): load the kernel library, make the
weights from the seed, build the state and step, and run the first
``check_steps`` steps, which warm up every shape the window uses and give
the readings the reference is compared with. The window then runs whole
steps until ``seconds`` have passed and ends on a synchronize; with
``trace`` it runs under ``torch.profiler`` and the trace is reduced in
this process (``trace.py``), after which each per-layer metric's probe,
if it has one, runs. The last report carries the record the driver reads.
"""

from __future__ import annotations

import math
import os
import sys
import time

from . import BANNED_MODULES

WINDOW = "gpubench.window"


def train_loop(config: dict) -> None:
    t_start = time.time()
    import torch

    from ray_tpu_torch import train

    from . import program, registry, trace
    from . import traffic as traffic_gen

    t_imported = time.time()
    cfg, traffic, seed = config["config"], config["traffic"], config["seed"]
    on_gpu = config["device"] == "cuda"
    if on_gpu and not torch.cuda.is_available():
        raise RuntimeError("the trainer's worker sees no CUDA card")
    dev = torch.device("cuda", 0) if on_gpu else torch.device("cpu")
    build_s = 0.0
    if on_gpu:
        from ray_tpu_torch._native import build

        build.library()
        build_s = build.build_seconds
    t_library = time.time()
    state, step = program.setup(cfg, traffic, seed, dev, config["fault"])
    t_state = time.time()
    state, readings = program.first_steps(
        state, step, cfg, traffic, seed, dev, config["fault"],
        on_step=lambda k, loss: train.report({"loss": loss, "phase": "first_steps"}))

    sync = torch.cuda.synchronize if on_gpu else (lambda: None)
    sync()
    if on_gpu:
        torch.cuda.reset_peak_memory_stats()
    prof = None
    if config["trace"]:
        acts = [torch.profiler.ProfilerActivity.CPU]
        if on_gpu:
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=acts)
        prof.__enter__()
    k, losses = traffic["check_steps"], []
    t_window = time.time()
    t0 = time.perf_counter()
    with torch.profiler.record_function(WINDOW):
        while True:
            k += 1
            batch = traffic_gen.batch(traffic, cfg["vocab_size"], seed, k, dev)
            state, m = step(state, batch)
            loss = m["loss"].item()
            losses.append(loss)
            train.report({"loss": loss, "phase": "window"})
            if time.perf_counter() - t0 >= config["seconds"]:
                break
        sync()
    window_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() if on_gpu else 0
    record = {
        "t_start": t_start, "t_imported": t_imported, "t_library": t_library, "t_state": t_state, "t_window": t_window,
        "build_s": build_s,
        "window": {"seconds": window_s, "steps": len(losses),
                   "tokens": len(losses) * traffic_gen.tokens_per_step(traffic),
                   "peak_bytes": peak,
                   "failed": sum(1 for v in losses if not math.isfinite(v))},
        "readings": readings, "trace": None, "probes": {},
        "kind": torch.cuda.get_device_name(0) if on_gpu else "cpu",
    }
    if prof is not None:
        prof.__exit__(None, None, None)
        readers = [registry.metric(m["name"]) for m in config["per_layer"]]
        ops = sorted({op for r in readers for op in getattr(r, "OPS", ())})
        path = os.path.join(config["tmp"], f"trace-{os.getpid()}.json")
        prof.export_chrome_trace(path)
        try:
            record["trace"] = trace.summarize(path, WINDOW, ops)
        finally:
            os.remove(path)
        ctx = {"state": state, "config": cfg, "traffic": traffic, "seed": seed, "device": dev}
        for r in readers:
            if hasattr(r, "probe"):
                record["probes"].update(r.probe(ctx))
    record["banned"] = sorted(m for m in sys.modules if m.split(".")[0] in BANNED_MODULES)
    train.report({"gpubench": record})
