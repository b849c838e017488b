"""The train loop the cell's ``TorchTrainer`` runs on each worker, written
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

A cell laid over a mesh runs one worker a card, each a rank of the
workers' process group: ``parallel.make_mesh()`` takes the shape that
``TorchConfig.mesh_shape`` gave the workers, and every rank runs the same
steps on the global batch. The ranks agree after each window step whether
the window is over, so every rank runs as many steps; they agree over a
gloo group of the harness's own, on the host, so that no kernel of the
harness runs on the cards in the window (its collectives would be counted
as the program's). Rank 0's record is the run's: its clocks, its trace and
its probes; the peak memory is the largest of the ranks', the device's
busy time their mean, and the modules that no run may load are every
rank's.
"""

from __future__ import annotations

import math
import os
import time

from . import banned_loaded

WINDOW = "gpubench.window"


def train_loop(config: dict) -> None:
    t_start = time.time()
    import torch
    import torch.distributed as dist

    from ray_tpu_torch import parallel, train

    from . import program, registry, trace
    from . import traffic as traffic_gen

    t_imported = time.time()
    cfg, traffic, seed = config["config"], config["traffic"], config["seed"]
    on_gpu = config["device"] == "cuda"
    if on_gpu and not torch.cuda.is_available():
        raise RuntimeError("the trainer's worker sees no CUDA card")
    dev = torch.device("cuda", 0) if on_gpu else torch.device("cpu")
    mesh = parallel.make_mesh(device=dev) if config["mesh"] else None
    rank = dist.get_rank() if mesh is not None else 0
    # the harness's own agreements, on the host: never a kernel on the card
    host_group = dist.new_group(backend="gloo") if mesh is not None else None

    def over_ranks(value: float, op) -> float:
        """``value`` reduced by ``op`` over the ranks (itself without a mesh)."""
        if host_group is None:
            return value
        t = torch.tensor([value], dtype=torch.float64)
        dist.all_reduce(t, op=op, group=host_group)
        return float(t.item())

    build_s = 0.0
    if on_gpu:
        from ray_tpu_torch._native import build

        build.library()
        build_s = build.build_seconds
    t_library = time.time()
    state, step = program.setup(cfg, traffic, seed, dev, config["fault"], mesh)
    t_state = time.time()
    state, readings = program.first_steps(
        state, step, cfg, traffic, seed, dev, config["fault"],
        on_step=lambda k, loss: train.report({"loss": loss, "phase": "first_steps"}), mesh=mesh)

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
            done = float(time.perf_counter() - t0 >= config["seconds"])
            if over_ranks(done, dist.ReduceOp.MAX):
                break
        sync()
    window_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() if on_gpu else 0
    peak = int(over_ranks(float(peak), dist.ReduceOp.MAX))
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
        world = dist.get_world_size() if mesh is not None else 1
        record["busy_s"] = over_ranks(record["trace"]["busy_s"], dist.ReduceOp.SUM) / world
        ctx = {"state": state, "step": step, "config": cfg, "traffic": traffic, "seed": seed,
               "device": dev, "rank": rank}
        for r in readers:
            if hasattr(r, "probe"):
                record["probes"].update(r.probe(ctx))
    banned = [banned_loaded()]
    if host_group is not None:
        banned = [None] * dist.get_world_size()
        dist.all_gather_object(banned, banned_loaded(), group=host_group)
    record["banned"] = sorted({m for ms in banned for m in ms})
    train.report({"gpubench": record if rank == 0 else {"rank": rank}})
