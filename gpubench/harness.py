"""Run one cell once and print its result line.

    python3 -m gpubench --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The driver process never touches the card, nor imports torch, while the
trainer runs: it starts ``ray_tpu_torch``'s runtime
with its session and object store under ``$TMPDIR`` (a run needs one, of
at most RUNTIME_BASE_MAX characters, else it uses ``build/rt`` in the
checkout, else it stops), checks that the runtime finds the cell's cards,
and fits a ``TorchTrainer`` (one GPU worker a card, a process group over
NCCL, and the workload's ``mesh`` as ``TorchConfig.mesh_shape``) whose
loop is ``loop.train_loop``; the loop stops where torch sees no card. When
the runtime is down and its worker processes have ended (the program's
state freed with them), this process imports torch, stops where torch sees
fewer cards than the cell asks for, and runs the reference on the cell's
cards, compares (``check.py``), reads every metric the cell reports
(``metrics/<name>.py``) and prints the numbers compared, each beside its
limit, as the last lines of standard error, and the result as the last
line of standard output.

``--device cpu`` (tests only) skips the look for a card and runs the
same path on the CPU (a mesh over gloo); ``--fault`` plants a fault in the
timed path that the comparison must catch.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import shutil
import signal
import subprocess
import sys
import tempfile
import time

from . import banned_loaded, check, peaks, registry

RUNTIME_BASE_MAX = 64   # + "/ray_tpu_torch_<8 hex>/object_agent.sock" < 108 bytes


def process_start_time() -> float:
    """This process's start, wall clock (from /proc; 10 ms ticks)."""
    with open("/proc/self/stat") as f:
        ticks = int(f.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/stat") as f:
        boot = next(int(line.split()[1]) for line in f if line.startswith("btime"))
    return boot + ticks / os.sysconf("SC_CLK_TCK")


def children() -> list:
    """Pids of this process's live child processes (zombies left out)."""
    me, out = os.getpid(), []
    for d in os.listdir("/proc"):
        if not d.isdigit():
            continue
        try:
            with open(f"/proc/{d}/stat") as f:
                fields = f.read().rsplit(")", 1)[1].split()
        except OSError:
            continue
        if int(fields[1]) == me and fields[0] != "Z":
            out.append(int(d))
    return out


def stop_children(timeout_s: float = 60.0) -> None:
    """Wait for every child process to end; kill what outlives the wait."""
    deadline = time.time() + timeout_s
    while children() and time.time() < deadline:
        time.sleep(0.2)
    for pid in children():
        try:
            os.kill(pid, signal.SIGKILL)
        except OSError:
            pass
    while children():
        time.sleep(0.1)


def runtime_base() -> str:
    """Where the runtime's session and object store go: ``$TMPDIR``, or
    ``build/rt`` in the checkout where ``$TMPDIR`` is too long for the
    session's socket paths; None where neither will do."""
    base = os.environ["TMPDIR"]
    if len(base) <= RUNTIME_BASE_MAX:
        return base
    inside = os.path.join(registry.ROOT, "build", "rt")
    if len(inside) <= RUNTIME_BASE_MAX:
        shutil.rmtree(inside, ignore_errors=True)
        os.makedirs(inside)
        return inside
    return None


def power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30).stdout
        return " | ".join(out.strip().splitlines())
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def parse(argv):
    ap = argparse.ArgumentParser(prog="python3 -m gpubench")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--fault", choices=("unchanged", "half", "ascent", "noexchange"), default=None)
    return ap.parse_args(argv)


class NoCards(Exception):
    """The machine has fewer CUDA cards than the cell asks for."""


def fit(loop_config: dict, chips: int, on_gpu: bool, storage: str):
    """(rank 0's record of the loop, the wall time ``fit()`` was called)
    from one TorchTrainer fit over ``chips`` workers."""
    import ray_tpu_torch as rt
    from ray_tpu_torch import train

    from .loop import train_loop

    rt.init(num_cpus=max(2, chips))
    try:
        found = int(rt.cluster_resources().get("GPU", 0))
        if on_gpu and found < chips:
            raise NoCards(f"the runtime finds {found} GPU(s)")
        trainer = train.TorchTrainer(
            train_loop, train_loop_config=loop_config,
            scaling_config=train.ScalingConfig(num_workers=chips, use_gpu=on_gpu),
            torch_config=train.TorchConfig(backend=None if on_gpu else "gloo",
                                           mesh_shape=loop_config["mesh"]),
            run_config=train.RunConfig(name="gpubench", storage_path=storage))
        t_fit = time.time()
        result = trainer.fit()
    finally:
        rt.shutdown()
        stop_children()
    if result.error is not None:
        raise RuntimeError(f"the train loop failed: {result.error}")
    return result.metrics["gpubench"], t_fit


def main(argv) -> int:
    t_process = process_start_time()
    args = parse(argv)
    cell = registry.workload(args.workload)
    cfg, traffic = registry.config(cell["config"]), registry.traffic(cell["traffic"])
    limits = registry.limits(args.workload)
    bench = registry.benchmark()
    chips, mesh = cell["chips"], cell.get("mesh")
    if chips != (math.prod(mesh.values()) if mesh else 1):
        print(f"gpubench: {args.workload} runs on {chips} cards and needs a mesh of as many "
              f"ranks, not {mesh}", file=sys.stderr)
        return 2
    on_gpu = args.device == "cuda"
    t_main = time.time()
    # the runtime's session (its sockets' paths must stay under 108 bytes)
    # and object store go under $TMPDIR or the checkout, not to /dev/shm
    if not os.environ.get("TMPDIR"):
        print("gpubench: a run needs TMPDIR set", file=sys.stderr)
        return 2
    base = runtime_base()
    if base is None:
        print(f"gpubench: TMPDIR and the checkout's build/rt are longer than "
              f"{RUNTIME_BASE_MAX} characters", file=sys.stderr)
        return 2
    os.environ["RAY_TPU_TORCH_TMPDIR"] = base
    tmp = tempfile.mkdtemp(prefix="gpubench-", dir=os.environ["TMPDIR"])
    os.environ["TRITON_CACHE_DIR"] = os.path.join(registry.ROOT, "build", "triton")
    os.environ["TORCHINDUCTOR_CACHE_DIR"] = os.path.join(registry.ROOT, "build", "inductor")
    os.environ["USE_FLAX"] = "0"
    try:
        per_layer = registry.cell_metrics(bench, args.workload, trace=True)
        loop_config = {"config": cfg, "traffic": traffic, "seed": args.seed, "mesh": mesh,
                       "seconds": args.seconds, "trace": bool(args.trace), "fault": args.fault,
                       "device": args.device, "tmp": tmp, "per_layer": per_layer}
        t_runtime = time.time()
        try:
            record, t_fit = fit(loop_config, chips, on_gpu, os.path.join(tmp, "runs"))
        except NoCards as e:
            print(f"gpubench: {args.workload} needs {chips} CUDA card(s); {e}", file=sys.stderr)
            return 2
        t_torch = time.time()
        import torch

        if on_gpu and (not torch.cuda.is_available() or torch.cuda.device_count() < chips):
            print(f"gpubench: {args.workload} needs {chips} CUDA card(s); torch sees "
                  f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
                  file=sys.stderr)
            return 2
        from . import reference

        dev = torch.device("cuda", 0) if on_gpu else torch.device("cpu")
        t_ref = time.time()
        ref = reference.run(cfg, traffic, args.seed, dev, ranks=chips,
                            pins=record["readings"].get("pins"), workdir=tmp)
        t_end = time.time()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
        if base != os.environ["TMPDIR"]:
            shutil.rmtree(base, ignore_errors=True)

    numbers = check.gaps(record["readings"], ref)
    checks = check.judge(numbers, limits)
    win = record["window"]
    correct = all(c["ok"] for c in checks.values()) and win["failed"] == 0
    trainer_start_s = record["t_start"] - t_fit
    dp = math.prod((mesh or {}).get(a, 1) for a in ("data", "fsdp"))
    run = {"cell": args.workload, "config": cfg, "traffic": traffic, "kind": record["kind"],
           "chips": chips, "batch_per_rank": traffic["batch"] // dp,
           "peaks": peaks.of(record["kind"]), "setup_s": record["t_window"] - t_process,
           "trainer_start_s": trainer_start_s, "window": win, "trace": record["trace"],
           "probes": record["probes"]}
    metrics = {}
    for m in registry.cell_metrics(bench, args.workload, trace=bool(args.trace)):
        value = registry.metric(m["name"]).read(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    device = {"platform": "gpu" if on_gpu else "cpu", "kind": record["kind"],
              "count": chips if on_gpu else 0, "memory_peak_bytes": win["peak_bytes"]}
    line = {"correct": correct, "attempted": win["steps"], "failed": win["failed"],
            "metrics": metrics, "device": device}
    if args.trace and record["trace"] is not None:
        t = record["trace"]
        device.update(busy_s=record["busy_s"], window_s=t["window_s"])
        line["breakdown"] = {"device_ops": t["device_ops"], "idle_gaps": t["idle_gaps"]}
    line["checks"] = {n: {"value": c["value"] if math.isfinite(c["value"]) else None,
                          "limit": c["limit"]} for n, c in checks.items()}

    banned = sorted(set(record["banned"]) | set(banned_loaded()))
    if banned:
        print(f"gpubench: modules that no run may load were loaded: {banned}", file=sys.stderr)
        return 3
    print(f"gpubench: {args.workload} seed {args.seed} on {record['kind']} ({power_limit()}): "
          f"losses {record['readings']['losses']} vs reference {ref['losses']}; "
          f"window {win['steps']} steps in {win['seconds']:.3f} s; runtime and fit "
          f"{t_torch - t_runtime:.1f} s, "
          f"the driver's torch import after the window {t_ref - t_torch:.1f} s, "
          f"reference {t_end - t_ref:.1f} s", file=sys.stderr)
    first = record["readings"]["seconds"]
    print(f"set-up {run['setup_s']:.2f} s: start to main {t_main - t_process:.2f}, to the "
          f"runtime {t_runtime - t_main:.2f}, the runtime's start {t_fit - t_runtime:.2f}, fit() to "
          f"the loop {trainer_start_s:.2f}, the loop's imports "
          f"{record['t_imported'] - record['t_start']:.2f}, kernel library "
          f"{record['t_library'] - record['t_imported']:.2f} (build {record['build_s']:.1f}), "
          f"weights and state {record['t_state'] - record['t_library']:.2f}, first steps "
          f"{record['t_window'] - record['t_state']:.2f} (steps "
          f"{', '.join(f'{x:.2f}' for x in first[:-1])}; readings {first[-1]:.2f})",
          file=sys.stderr)
    if record["trace"] is not None:
        t = record["trace"]
        print(f"trace: kernels linked {t['linked']}, ops {t['ops']}, gemm {t['gemm_s']:.4f} s "
              f"of {t['kernel_s']:.4f} s; NCCL {t['nccl_kernel_s']:.4f} s, exposed "
              f"{t['nccl_exposed_s']:.4f} s, by kernel {t['nccl_ops']}", file=sys.stderr)
    for n in check.NAMES:
        if n in checks:
            c = checks[n]
            print(f"check {n}: {c['value']:.6g} (limit {c['limit']:.6g}) "
                  f"{'ok' if c['ok'] else 'FAILED'}", file=sys.stderr)
        else:
            print(f"check {n}: {numbers[n]:.6g} (no limit: not compared)", file=sys.stderr)
    print(json.dumps(line))
    return 0
