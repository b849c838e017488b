"""Tune on the port: the reference's programs, and decisions held equal to
the JAX package's.

The twelve programs of tests/test_tune.py run on ``ray_tpu_torch.tune``
with the same assertions: grid search, random sampling, an errored trial
kept apart, ASHA stopping bad trials, checkpointed trials, PBT exploiting,
a wrapped Trainer, restore from checkpoints and of finished results, PB2's
GP proposals and a PB2 Tuner, and the ConcurrencyLimiter's cap. The
restore program's trials crash only once the experiment's state file holds
their step-2 checkpoint (the program waits on the file, not on time), so
the resume replays nothing.

Without a runtime: ``BasicVariantGenerator`` gives the same configs from
one seed in both packages, and ASHA's, PBT's and PB2's decisions on the
same result streams are equal in both.

With ``RAY_TPU_TORCH_NUM_GPUS=1`` (set only around ``init``): trials that
ask for "GPU" are pinned ``CUDA_VISIBLE_DEVICES='0'`` and run one after
another under the default concurrency (a second trial actor could not be
placed; the reference's loop would wait on it for ever), and a trial that
wraps a ``use_gpu`` Trainer holds no GPU itself, even when asked for one:
its gang does.

Cost: one runtime for the file, four CPUs and four pooled workers; every
trial is an actor of its own. Trainables are defined inside the tests, so
no worker imports this module.
"""

import os

import pytest

import ray_tpu_torch
from ray_tpu_torch import tune
from ray_tpu_torch.train import Checkpoint, RunConfig
from ray_tpu_torch.tune import (
    ASHAScheduler,
    PopulationBasedTraining,
    TuneConfig,
    Tuner,
)


@pytest.fixture(scope="module")
def rt():
    os.environ["RAY_TPU_TORCH_NUM_GPUS"] = "1"
    try:
        ray_tpu_torch.init(num_cpus=4, max_workers=4)
    finally:
        del os.environ["RAY_TPU_TORCH_NUM_GPUS"]
    assert ray_tpu_torch.cluster_resources()["GPU"] == 1.0
    yield ray_tpu_torch
    ray_tpu_torch.shutdown()


@pytest.fixture
def storage(tmp_path):
    return str(tmp_path / "tune")


# ------------------------------------------------ the reference's programs

def test_grid_search_runs_all(rt, storage):
    def trainable(config):
        tune.report({"score": config["a"] * 10 + config["b"]})

    tuner = Tuner(
        trainable,
        param_space={"a": tune.grid_search([1, 2, 3]), "b": tune.grid_search([0, 1])},
        tune_config=TuneConfig(metric="score", mode="max", max_concurrent_trials=2),
        run_config=RunConfig(name="grid", storage_path=storage),
    )
    results = tuner.fit()
    assert len(results) == 6
    best = results.get_best_result()
    assert best.metrics["score"] == 31
    assert best.metrics["config"] == {"a": 3, "b": 1}


def test_random_sampling(rt, storage):
    def trainable(config):
        tune.report({"v": config["lr"]})

    tuner = Tuner(
        trainable,
        param_space={"lr": tune.loguniform(1e-5, 1e-1)},
        tune_config=TuneConfig(metric="v", mode="min", num_samples=4, seed=7),
        run_config=RunConfig(name="rand", storage_path=storage),
    )
    results = tuner.fit()
    assert len(results) == 4
    vals = [r.metrics["v"] for r in results]
    assert all(1e-5 <= v <= 1e-1 for v in vals)
    assert len(set(vals)) > 1  # actually sampled


def test_trial_error_isolated(rt, storage):
    def trainable(config):
        if config["x"] == 1:
            raise ValueError("trial poisoned")
        tune.report({"ok": config["x"]})

    results = Tuner(
        trainable,
        param_space={"x": tune.grid_search([0, 1, 2])},
        tune_config=TuneConfig(metric="ok", mode="max"),
        run_config=RunConfig(name="err", storage_path=storage),
    ).fit()
    assert len(results) == 3
    assert len(results.errors) == 1
    assert results.get_best_result().metrics["ok"] == 2


def test_asha_stops_bad_trials(rt, storage):
    def trainable(config):
        for i in range(20):
            # bad trials plateau high; good trials descend
            loss = config["base"] - (i * 0.1 if config["base"] < 5 else 0.0)
            tune.report({"loss": loss})

    sched = ASHAScheduler(metric="loss", mode="min", max_t=20, grace_period=2, reduction_factor=2)
    results = Tuner(
        trainable,
        param_space={"base": tune.grid_search([1.0, 2.0, 8.0, 9.0])},
        tune_config=TuneConfig(metric="loss", mode="min", scheduler=sched,
                               max_concurrent_trials=4),
        run_config=RunConfig(name="asha", storage_path=storage),
    ).fit()
    assert len(results) == 4
    # the bad trials must have been stopped before finishing 20 iters
    iters = {r.metrics["config"]["base"]: r.metrics["training_iteration"] for r in results}
    assert iters[8.0] < 20 or iters[9.0] < 20
    assert results.get_best_result().metrics["config"]["base"] == 1.0


def test_checkpointed_trials(rt, storage):
    def trainable(config):
        ckpt = tune.get_checkpoint()
        start = ckpt.to_state()["i"] + 1 if ckpt else 0
        for i in range(start, 3):
            tune.report({"i": i}, checkpoint=Checkpoint.from_state({"i": i}))

    results = Tuner(
        trainable,
        param_space={"x": tune.grid_search([0])},
        tune_config=TuneConfig(metric="i", mode="max"),
        run_config=RunConfig(name="ckpt", storage_path=storage),
    ).fit()
    r = results[0]
    assert r.checkpoint is not None
    assert r.checkpoint.to_state()["i"] == 2


def test_pbt_exploits(rt, storage):
    """Bottom trial adopts top trial's checkpoint + mutated config."""

    def trainable(config):
        ckpt = tune.get_checkpoint()
        level = ckpt.to_state()["level"] if ckpt else 0.0
        for i in range(12):
            level += config["rate"]
            tune.report(
                {"score": level},
                checkpoint=Checkpoint.from_state({"level": level}),
            )

    sched = PopulationBasedTraining(
        metric="score",
        mode="max",
        perturbation_interval=3,
        hyperparam_mutations={"rate": tune.uniform(0.5, 2.0)},
        quantile_fraction=0.5,
        seed=3,
    )
    results = Tuner(
        trainable,
        param_space={"rate": tune.grid_search([0.01, 2.0])},
        tune_config=TuneConfig(metric="score", mode="max", scheduler=sched,
                               max_concurrent_trials=2),
        run_config=RunConfig(name="pbt", storage_path=storage),
    ).fit()
    results.get_best_result()
    # the slow trial exploited the fast one, so both finish far above
    # what rate=0.01 alone could reach (12 * 0.01 = 0.12)
    scores = sorted(r.metrics["score"] for r in results)
    assert scores[0] > 1.0


def test_tuner_wraps_trainer(rt, storage):
    from ray_tpu_torch.train import DataParallelTrainer, ScalingConfig

    def loop(config):
        from ray_tpu_torch import train

        train.report({"out": config["m"] * 2})

    trainer = DataParallelTrainer(
        loop,
        scaling_config=ScalingConfig(num_workers=1),
        run_config=RunConfig(name="inner", storage_path=storage),
    )
    results = Tuner(
        trainer,
        param_space={"m": tune.grid_search([3, 5])},
        tune_config=TuneConfig(metric="out", mode="max", max_concurrent_trials=1),
        run_config=RunConfig(name="wrap", storage_path=storage),
    ).fit()
    assert results.get_best_result().metrics["out"] == 10


def test_tuner_restore_resumes_from_checkpoints(rt, storage, tmp_path):
    """Kill-and-resume: trials crash mid-run; Tuner.restore rehydrates
    searcher/scheduler/trial state and continues each trial from its last
    checkpoint instead of from scratch. A trial crashes only once the
    state file records its step-2 checkpoint, so no step replays."""
    crash_dir = str(tmp_path / "markers")
    os.makedirs(crash_dir, exist_ok=True)
    state_file = os.path.join(storage, "resume_exp", "experiment_state.pkl")

    def trainable(config):
        import time

        import cloudpickle

        ckpt = tune.get_checkpoint()
        start = ckpt.to_state()["i"] + 1 if ckpt else 0
        marker = os.path.join(crash_dir, f"trial_{config['x']}")
        for i in range(start, 6):
            # record every executed step for the no-redo assertion
            with open(marker, "a") as f:
                f.write(f"{i},")
            tune.report({"i": i}, checkpoint=Checkpoint.from_state({"i": i}))
            if i == 2 and not os.path.exists(marker + ".crashed"):
                deadline = time.monotonic() + 60
                while time.monotonic() < deadline:
                    try:
                        with open(state_file, "rb") as f:
                            trials = cloudpickle.load(f)["trials"]
                    except (OSError, EOFError):
                        trials = []
                    if any(t["config"] == config and (t["checkpoint_path"] or "").endswith(
                            "checkpoint_000002") for t in trials):
                        break
                    time.sleep(0.02)
                open(marker + ".crashed", "w").close()
                os._exit(1)  # hard crash mid-experiment

    tuner = Tuner(
        trainable,
        param_space={"x": tune.grid_search([0, 1])},
        tune_config=TuneConfig(metric="i", mode="max"),
        run_config=RunConfig(name="resume_exp", storage_path=storage),
    )
    results = tuner.fit()
    assert len(results.errors) == 2  # both trials crashed

    exp_dir = os.path.join(storage, "resume_exp")
    assert Tuner.can_restore(exp_dir)
    restored = Tuner.restore(exp_dir, trainable, restart_errored=True)
    results2 = restored.fit()
    assert not results2.errors
    assert len(results2) == 2  # no extra trials suggested after restore
    for r in results2:
        assert r.metrics["i"] == 5
        assert r.checkpoint.to_state()["i"] == 5
    for x in (0, 1):
        steps = open(os.path.join(crash_dir, f"trial_{x}")).read()
        executed = [int(s) for s in steps.strip(",").split(",")]
        assert executed[-1] == 5
        assert executed.count(0) == 1 and executed.count(1) == 1, executed
        assert len(executed) <= 8, executed  # 6 steps + <=2 replays
        assert executed == [0, 1, 2, 3, 4, 5], executed  # the crash waited for step 2's record


def test_tuner_restore_keeps_finished_results(rt, storage):
    def trainable(config):
        tune.report({"score": config["x"]})

    Tuner(
        trainable,
        param_space={"x": tune.grid_search([1, 2])},
        tune_config=TuneConfig(metric="score", mode="max"),
        run_config=RunConfig(name="done_exp", storage_path=storage),
    ).fit()
    exp_dir = os.path.join(storage, "done_exp")
    restored = Tuner.restore(exp_dir, trainable)
    results = restored.fit()  # nothing to do: results come from state
    assert len(results) == 2
    assert results.get_best_result().metrics["score"] == 2


def test_pb2_gp_proposals_track_good_region():
    """With history showing reward improvement peaking at lr~0.5, the
    GP-UCB proposal lands near it and always inside the bounds."""
    import numpy as np

    from ray_tpu_torch.tune import PB2

    sched = PB2(metric="score", mode="max",
                hyperparam_bounds={"lr": (0.0, 1.0)},
                perturbation_interval=1, seed=0)
    score = {f"t{i}": 0.0 for i in range(4)}
    lrs = {"t0": 0.05, "t1": 0.35, "t2": 0.55, "t3": 0.95}
    for tid, lr in lrs.items():
        sched.register_config(tid, {"lr": lr})
    for step in range(1, 6):
        for tid, lr in lrs.items():
            score[tid] += 1.0 - (lr - 0.5) ** 2
            sched.on_result(tid, {"score": score[tid], "training_iteration": step})
    props = [sched._mutate({"lr": 0.1})["lr"] for _ in range(8)]
    assert all(0.0 <= p <= 1.0 for p in props)
    assert abs(float(np.median(props)) - 0.5) < 0.25, props


def test_pb2_end_to_end_tuner(rt, storage):
    """PB2 drives a real Tuner run (exploit/explore through checkpoint
    cloning, like the PBT integration path)."""
    from ray_tpu_torch import train
    from ray_tpu_torch.tune import PB2

    def trainable(config):
        value = 0.0
        for it in range(6):
            value += 1.0 - (config["lr"] - 0.5) ** 2
            train.report({"score": value})

    tuner = tune.Tuner(
        trainable,
        param_space={"lr": tune.uniform(0.0, 1.0)},
        tune_config=tune.TuneConfig(
            metric="score", mode="max", num_samples=4,
            scheduler=PB2(hyperparam_bounds={"lr": (0.0, 1.0)},
                          perturbation_interval=2, seed=1),
        ),
        run_config=RunConfig(storage_path=storage),
    )
    results = tuner.fit()
    assert len(results) == 4
    assert results.get_best_result().metrics["score"] > 0


def test_concurrency_limiter_caps_inflight(rt, tmp_path):
    """Never more than max_concurrent trials hold a live suggestion, and
    completions release slots so every sample still runs."""
    from ray_tpu_torch.tune import ConcurrencyLimiter
    from ray_tpu_torch.tune.search import BasicVariantGenerator

    peak_file = tmp_path / "peak.json"
    peak_file.write_text("0")
    live_file = tmp_path / "live.json"
    live_file.write_text("0")

    def trainable(config):
        import fcntl
        import time

        def bump(delta):
            with open(live_file, "r+") as f:
                fcntl.flock(f, fcntl.LOCK_EX)
                live = int(f.read() or 0) + delta
                f.seek(0)
                f.truncate()
                f.write(str(live))
                peak = int(peak_file.read_text() or 0)
                if live > peak:
                    peak_file.write_text(str(live))
            return live

        bump(+1)
        time.sleep(0.3)
        bump(-1)
        tune.report({"loss": config["x"]})

    base = BasicVariantGenerator({"x": tune.grid_search([1, 2, 3, 4, 5])})
    tuner = Tuner(
        trainable,
        tune_config=TuneConfig(
            search_alg=ConcurrencyLimiter(base, max_concurrent=2),
            metric="loss", mode="min", num_samples=5,
        ),
        run_config=RunConfig(name="climit", storage_path=str(tmp_path)),
    )
    results = tuner.fit()
    assert len(results) == 5
    assert results.get_best_result().metrics["loss"] == 1
    assert int(peak_file.read_text()) <= 2, "cap exceeded"


# ------------------------------------------- both packages, same decisions

def _packages():
    import ray_tpu.tune as ref_tune

    return [ref_tune, tune]


def test_seeded_variants_equal_the_reference():
    def space(t):
        return {
            "a": t.grid_search([1, 2]),
            "lr": t.loguniform(1e-4, 1e-1),
            "opt": {"name": t.choice(["adam", "sgd"]), "beta": t.uniform(0.8, 0.99),
                    "steps": t.grid_search([10, 20])},
            "n": t.randint(1, 10),
            "m": t.lograndint(1, 100),
            "q": t.quniform(0.0, 1.0, 0.25),
            "g": t.randn(0.0, 1.0),
            "twice_a": t.sample_from(lambda spec: spec["a"] * 2),
            "fixed": "x",
        }

    runs = []
    for t in _packages():
        gen = t.BasicVariantGenerator(space(t), num_samples=3, seed=7)
        cfgs = []
        while not gen.is_finished():
            cfgs.append(gen.suggest(f"trial_{len(cfgs)}"))
        runs.append(cfgs)
    assert len(runs[1]) == 2 * 2 * 3
    assert runs[1] == runs[0]
    assert runs[1][0]["twice_a"] == 2 * runs[1][0]["a"]


def _asha_stream(t):
    sched = t.ASHAScheduler(metric="loss", mode="min", max_t=16, grace_period=1,
                            reduction_factor=2)
    out = []
    for it in range(1, 17):
        for k in range(6):
            loss = (k + 1) * 1.0 / it + 0.01 * ((k * 7 + it) % 5)
            out.append(sched.on_result(f"t{k}", {"loss": loss, "training_iteration": it}))
    return out


def _pbt_stream(t, pb2=False):
    if pb2:
        sched = t.PB2(metric="score", mode="max", perturbation_interval=2,
                      hyperparam_bounds={"lr": (0.0, 1.0)}, quantile_fraction=0.25, seed=5)
        configs = {f"t{k}": {"lr": 0.1 + 0.2 * k} for k in range(4)}
    else:
        sched = t.PopulationBasedTraining(
            metric="score", mode="max", perturbation_interval=2, quantile_fraction=0.25,
            hyperparam_mutations={"lr": t.uniform(0.001, 0.1), "mom": [0.8, 0.9, 0.99]},
            seed=5)
        configs = {f"t{k}": {"lr": 0.01 * (k + 1), "mom": 0.9, "wd": 1e-4} for k in range(4)}
    for tid, cfg in configs.items():
        sched.register_config(tid, cfg)
    score = {tid: 0.0 for tid in configs}
    out = []
    for it in range(1, 11):
        for tid in configs:
            score[tid] += 1.0 - (configs[tid]["lr"] - 0.5) ** 2
            out.append(sched.on_result(tid, {"score": score[tid], "training_iteration": it}))
        for tid in configs:
            exploit = sched.exploit(tid)
            out.append(exploit)
            if exploit is not None:
                source, new_config = exploit
                sched.commit_exploit(tid, new_config)
                configs[tid] = dict(new_config)
                score[tid] = score[source]
    return out


@pytest.mark.parametrize("kind", ["asha", "pbt", "pb2"])
def test_scheduler_decisions_equal_the_reference(kind):
    streams = [_asha_stream(t) if kind == "asha" else _pbt_stream(t, pb2=kind == "pb2")
               for t in _packages()]
    assert streams[1] == streams[0]
    if kind == "asha":
        assert "STOP" in streams[1] and "CONTINUE" in streams[1]
    else:
        assert sum(d is not None and d not in ("CONTINUE", "STOP") for d in streams[1]) >= 2


# ---------------------------------------------------- GPUs without a card

def test_gpu_trials_are_pinned_and_run_one_after_another(rt, storage, tmp_path):
    log = str(tmp_path / "trials.jsonl")

    def trainable(config):
        import json
        import os
        import time

        with open(log, "a") as f:
            f.write(json.dumps({"lr": config["lr"], "event": "start", "t": time.time(),
                                "pid": os.getpid(),
                                "visible": os.environ.get("CUDA_VISIBLE_DEVICES")}) + "\n")
        for i in range(2):
            tune.report({"loss": config["lr"] * (2 - i)})
        with open(log, "a") as f:
            f.write(json.dumps({"lr": config["lr"], "event": "end", "t": time.time()}) + "\n")

    results = Tuner(
        tune.with_resources(trainable, {"GPU": 1}),
        param_space={"lr": tune.grid_search([0.1, 0.2])},
        tune_config=TuneConfig(metric="loss", mode="min"),  # default concurrency
        run_config=RunConfig(name="gpu_trials", storage_path=storage),
    ).fit()
    assert not results.errors
    assert results.get_best_result().metrics["config"] == {"lr": 0.1}
    import json

    events = [json.loads(line) for line in open(log)]
    assert [(e["lr"], e["event"]) for e in events] == [
        (0.1, "start"), (0.1, "end"), (0.2, "start"), (0.2, "end")]
    starts = [e for e in events if e["event"] == "start"]
    assert [e["visible"] for e in starts] == ["0", "0"]
    assert starts[0]["pid"] != starts[1]["pid"]
    assert ray_tpu_torch.available_resources().get("GPU") == 1.0


def test_trainer_wrapped_gpu_trial_holds_no_gpu(rt, storage):
    from ray_tpu_torch._private import worker
    from ray_tpu_torch.train import DataParallelTrainer, ScalingConfig

    def loop(config):
        import os

        from ray_tpu_torch import train

        train.report({"out": config["m"] * 2,
                      "visible": os.environ.get("CUDA_VISIBLE_DEVICES")})

    client = worker.get_client()
    before = {a["actor_id"] for a in client.list_state("actors")}
    trainer = DataParallelTrainer(
        loop,
        scaling_config=ScalingConfig(num_workers=1, use_gpu=True),
        run_config=RunConfig(name="inner_gpu", storage_path=storage),
    )
    results = Tuner(
        trainer,
        param_space={"m": tune.grid_search([3, 5])},
        tune_config=TuneConfig(metric="out", mode="max", max_concurrent_trials=1,
                               trial_resources={"CPU": 1, "GPU": 1}),
        run_config=RunConfig(name="wrap_gpu", storage_path=storage),
    ).fit()
    assert not results.errors, results.errors
    best = results.get_best_result()
    assert best.metrics["out"] == 10 and best.metrics["visible"] == "0"
    new = [a for a in client.list_state("actors") if a["actor_id"] not in before]
    gpu = [a for a in new if a["resources"].get("GPU")]
    assert len(new) == 4 and len(gpu) == 2, new  # per trial: its actor, its gang's worker
    assert all(a["resources"] == {"CPU": 1.0} for a in new if a not in gpu), new
