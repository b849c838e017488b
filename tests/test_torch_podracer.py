"""Podracer on the port (ray_tpu_torch.rllib.podracer): the reference's
programs (tests/test_podracer.py) with its assertions at its sizes, on
the port's runtime with ``device="cpu"``: Anakin end to end through the
compiled-DAG resident loop and bitwise deterministic for a seed, also
sharded over two CPU "devices" of an NCCL group; Sebulba's trajectory
hand-off over the direct object plane; trace-stage attribution of both
layouts; the seeded learner-kill resume. Also the Sebulba placement for
clusters with and without GPUs, and ``device=None`` raising on a
cluster without one.

Cost: one runtime (``torch_rllib_runtime.port_runtime``: no GPU, four
CPUs) for the plain programs; the traced programs share a second
one, and the chaos program starts its own, each after the one before is
shut down (so they come last in the file).
"""

import pickle
import time

import numpy as np
import pytest

import ray_tpu_torch
from ray_tpu_torch.rllib.podracer import PodracerConfig
from ray_tpu_torch.rllib.podracer.sebulba import sebulba_layout
from torch_rllib_runtime import port_runtime


def _client():
    from ray_tpu_torch._private import worker

    return worker.get_client()


def _hub():
    return ray_tpu_torch._private.worker._hub


@pytest.fixture(scope="module")
def rt():
    with port_runtime() as runtime:
        yield runtime


def _anakin_config(seed=3, **podracer):
    return (
        PodracerConfig()
        .environment("CartPole-v1")
        .podracer(mode="anakin", num_envs=32, anakin_supersteps_per_call=2, **podracer)
        .env_runners(rollout_fragment_length=16)
        .debugging(seed=seed)
        .training(device="cpu")
    )


def _sebulba_config(namespace, **overrides):
    cfg = (
        PodracerConfig()
        .environment("CartPole-v1")
        .podracer(mode="sebulba", namespace=namespace)
        .debugging(seed=7)
        .training(device="cpu")
    )
    return cfg.training(**overrides) if overrides else cfg


# ------------------------------------------------------------- config surface


def test_config_validation():
    with pytest.raises(ValueError, match="mode"):
        PodracerConfig().podracer(mode="impala").validate()
    with pytest.raises(ValueError, match="loss"):
        PodracerConfig().training(loss="sarsa").validate()
    with pytest.raises(ValueError, match="no torch env"):
        PodracerConfig().environment("Walker2d-v4").validate()
    # sebulba env total must shard evenly over the learner group
    with pytest.raises(ValueError, match="learner_shards"):
        (
            PodracerConfig()
            .podracer(mode="sebulba", learner_shards=3)
            .env_runners(num_actors=1, envs_per_actor=16)
            .validate()
        )


def test_podracer_stages_registered():
    """The four podracer stages sit in STAGE_PRECEDENCE above worker
    execute, so analyze_trace charges in-task time to the RL phase."""
    from ray_tpu_torch.util.tracing import STAGE_PRECEDENCE

    execute = STAGE_PRECEDENCE["execute"]
    for stage in (
        "podracer.env_step",
        "podracer.learner_update",
        "podracer.traj_handoff",
        "podracer.param_sync",
    ):
        assert STAGE_PRECEDENCE[stage] > execute


def test_sebulba_layout_follows_the_gpus():
    """SLICE (a GPU a role) with num_actors + 1 GPUs; the learner alone
    on a GPU with fewer; PACK on CPU bundles with device="cpu"; and a
    cluster without a GPU refuses device=None."""
    cfg = PodracerConfig().podracer(mode="sebulba")
    assert sebulba_layout(cfg, {"CPU": 8, "GPU": 3}) == (
        "SLICE", {"GPU": 1}, {"GPU": 1}, "cuda", "cuda")
    assert sebulba_layout(cfg, {"CPU": 8, "GPU": 1}) == (
        "PACK", {"CPU": 1}, {"GPU": 1}, "cpu", "cuda")
    assert sebulba_layout(cfg.training(placement_strategy="PACK"), {"GPU": 4})[0] == "PACK"
    cpu = PodracerConfig().training(device="cpu")
    assert sebulba_layout(cpu, {"CPU": 8, "GPU": 3}) == (
        "PACK", {"CPU": 1}, {"CPU": 1}, "cpu", "cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        sebulba_layout(PodracerConfig(), {"CPU": 8})


def test_drivers_refuse_a_cluster_without_a_gpu(rt):
    """device=None means the GPU: with none in the cluster both layouts
    raise before they place anything."""
    with pytest.raises(RuntimeError, match="device='cpu'"):
        _anakin_config().training(device=None).build()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        _sebulba_config("nogpu").training(device=None).build()


# --------------------------------------------------------------------- anakin


def test_anakin_trains_and_is_bitwise_deterministic(rt):
    """Two same-seed Anakin runs (compiled-DAG resident loop) reproduce
    the whole metrics stream bitwise on CPU — the Podracer determinism
    contract: every superstep's generator is seeded from (seed, k)."""

    def run(**podracer):
        driver = _anakin_config(seed=3, **podracer).build()
        try:
            return driver.train(num_ticks=4)
        finally:
            driver.stop()

    r1 = run()
    assert r1["mode"] == "anakin" and r1["device"] == "cpu"
    assert r1["ticks"] == 4
    assert r1["updates"] == 8  # 4 ticks x anakin_supersteps_per_call=2
    assert r1["env_steps_total"] == 8 * 16 * 32  # updates x T x num_envs
    assert r1["steps_per_sec"] > 0
    assert r1["metrics_rows"].shape == (4, 10)
    assert np.isfinite(r1["vf_loss"]) and np.isfinite(r1["entropy"])
    # CartPole rewards 1/step: any completed episode has a positive mean
    assert r1["num_episodes"] > 0 and r1["episode_return_mean"] > 0

    r2 = run()
    assert np.array_equal(r1["metrics_rows"], r2["metrics_rows"])
    assert r1["reward_trajectory"] == r2["reward_trajectory"]

    # the env axis sharded over two devices of an NCCL group (CPU here):
    # the same counts, deterministic too
    s1, s2 = run(anakin_num_devices=2), run(anakin_num_devices=2)
    assert s1["updates"] == 8 and s1["env_steps_total"] == 8 * 16 * 32
    assert s1["num_episodes"] > 0 and np.isfinite(s1["vf_loss"])
    assert np.array_equal(s1["metrics_rows"], s2["metrics_rows"])


# -------------------------------------------------------------------- sebulba


def test_sebulba_handoff_rides_object_plane(rt):
    """A Sebulba rollout fragment (>=100KiB) must cross actor->learner
    as a shm-backed object (direct object plane), never as hub-relayed
    payload bytes — and the full round loop trains end to end."""
    cfg = _sebulba_config(
        "handoff",
        num_actors=2,
        envs_per_actor=32,
        rollout_fragment_length=128,
        learner_shards=2,
        num_sgd_steps=1,
        max_inflight_rounds=1,
    )
    driver = cfg.build()
    try:
        # one fragment by hand, refs held, so the directory entry is
        # still live to inspect
        traj_ref, carry_ref = driver._sample.remote(
            driver._cfg_blob, 0, 0, None
        )
        traj = ray_tpu_torch.get(traj_ref, timeout=300)
        payload = sum(
            a.nbytes for a in traj.values() if isinstance(a, np.ndarray)
        )
        assert payload >= 100 * 1024  # the test premise: big enough to spill

        rows = {r["object_id"]: r for r in _client().list_state("objects")}
        trow = rows[traj_ref._id.hex()]
        assert trow["kind"] == "shm"  # a segment name, not bytes
        assert trow["size"] >= 100 * 1024
        # the carry continuation is small: must NOT occupy a segment
        crow = rows.get(carry_ref._id.hex())
        assert crow is None or crow["kind"] != "shm"
        # zero hub relay: no PUT_CHUNK frames carried rollout payloads
        relay = _hub().metrics.get(
            ("ray_tpu_hub_messages_total", (("type", "put_chunk"),))
        )
        assert relay is None or relay["value"] == 0

        res = driver.train(num_rounds=3)
    finally:
        driver.stop()

    assert res["mode"] == "sebulba"
    assert res["learner_step"] == 3
    assert res["param_version"] == 3  # param_sync_interval=1: every step
    assert sorted(res["learner_steps"]) == [1, 2, 3]
    assert res["env_steps"] == 3 * 2 * 32 * 128
    assert res["steps_per_sec"] > 0
    assert res["learner_metrics"]["device"] == "cpu"
    # bounded staleness: behaviour versions lag the learner, never lead
    assert max(res["learner_metrics"]["behavior_versions"]) <= 3


# -------------------------------------------------------------------- tracing


@pytest.fixture(scope="module")
def traced(rt):
    """Tracing on for the driver (which samples at submit) and the
    runtime's workers, for the rest of the module."""
    ray_tpu_torch.shutdown()
    with port_runtime(RAY_TPU_TORCH_TRACING="1") as runtime:
        yield runtime


def _find_trace_with_span(span_name, mode=None, deadline_s=20.0):
    """The spans of a trace holding a ``span_name`` span (of ``mode``,
    when given: the traced programs share one runtime)."""
    client = _client()
    deadline = time.monotonic() + deadline_s
    while time.monotonic() < deadline:
        for row in client.list_state("traces"):
            spans = client.list_state("traces", trace_id=row["trace_id"])
            if any(s.get("name") == span_name
                   and (mode is None or (s.get("attrs") or {}).get("mode") == mode)
                   for s in spans):
                return spans
        time.sleep(0.1)
    raise AssertionError(f"no trace contains a {span_name!r} span")


def test_trace_stages_answer_actor_or_learner_bound(traced):
    """Traced Sebulba round: analyze_trace on the learner task's trace
    reports podracer.traj_handoff + podracer.learner_update stages, the
    actor task's trace reports podracer.env_step + podracer.param_sync —
    the stage split that answers 'actor-bound or learner-bound'."""
    from ray_tpu_torch.util.tracing import analyze_trace

    cfg = _sebulba_config(
        "traced",
        num_actors=2,
        envs_per_actor=4,
        rollout_fragment_length=8,
        learner_shards=1,
        max_inflight_rounds=1,
    )
    driver = cfg.build()
    try:
        driver.train(num_rounds=2)
    finally:
        driver.stop()

    def stage_s(analysis, stage):
        return analysis["stages"].get(stage, {}).get("dur_s", 0.0)

    learner_spans = _find_trace_with_span("podracer.learner_update")
    analysis = analyze_trace(learner_spans)
    assert stage_s(analysis, "podracer.learner_update") > 0
    assert stage_s(analysis, "podracer.traj_handoff") > 0
    assert analysis["dominant_stage"] is not None

    actor_spans = _find_trace_with_span("podracer.env_step")
    analysis = analyze_trace(actor_spans)
    assert stage_s(analysis, "podracer.env_step") > 0
    assert stage_s(analysis, "podracer.param_sync") > 0


def test_anakin_traced_mode_splits_the_superstep(traced):
    """With tracing live the resident worker runs the acting loop and
    the update as two spanned phases, so the device loop still shows up
    stage-attributed."""
    cfg = (
        PodracerConfig()
        .environment("CartPole-v1")
        .podracer(mode="anakin", num_envs=8, use_compiled_dag=False)
        .env_runners(rollout_fragment_length=8)
        .debugging(seed=1)
        .training(device="cpu")
    )
    driver = cfg.build()
    try:
        res = driver.train(num_ticks=2)
    finally:
        driver.stop()
    assert res["updates"] == 2

    spans = _find_trace_with_span("podracer.env_step", mode="anakin")
    by_name = {s.get("name") for s in spans}
    assert "podracer.learner_update" in by_name
    modes = {
        (s.get("attrs") or {}).get("mode")
        for s in spans
        if s.get("name") == "podracer.env_step"
    }
    assert "anakin" in modes


# ------------------------------------------------------------ chaos: learner


def _chaos_rows():
    return _client().list_state("chaos")


def test_learner_kill_resumes_from_published_state(traced):
    """A chaos worker_kill lands mid learner_update (the only plain
    task in flight); lineage retry replays it against the same state
    ref + trajectory args, so the step counter resumes monotonically
    and the same param version is (re)published on the KV channel."""
    ray_tpu_torch.shutdown()
    with port_runtime(RAY_TPU_TORCH_CHAOS_PLAN="seed=5;worker_kill:1@2s"):
        cfg = _sebulba_config(
            "killres",
            num_actors=2,
            envs_per_actor=32,
            rollout_fragment_length=16,
            learner_shards=2,
            num_sgd_steps=1500,  # keeps the learner busy past the kill
        )
        driver = cfg.build()
        try:
            # synthetic trajectories (no actor tasks): the learner is
            # the only worker the cluster ever spawns, so the seeded
            # busy-plain-first victim choice is fully deterministic
            rng = np.random.default_rng(0)
            T, N = cfg.rollout_fragment_length, cfg.envs_per_actor

            def fake_traj():
                return {
                    "obs": rng.standard_normal((T, N, 4)).astype(np.float32),
                    "actions": rng.integers(0, 2, (T, N)).astype(np.int32),
                    "rewards": np.ones((T, N), np.float32),
                    "dones": (rng.random((T, N)) < 0.02).astype(np.float32),
                    "logp_mu": np.full((T, N), -0.693, np.float32),
                    "final_obs": rng.standard_normal((N, 4)).astype(
                        np.float32
                    ),
                    "behavior_version": 0,
                }

            trajs = [fake_traj(), fake_traj()]
            state_ref, metrics_ref = driver._learn.remote(
                driver._cfg_blob, driver._state_ref, *trajs
            )
            metrics = ray_tpu_torch.get(metrics_ref, timeout=300)
            assert metrics["step"] == 1
            assert metrics["version"] == 1

            # the kill fired, and exactly per plan
            rows = _chaos_rows()
            assert rows[0]["counts"].get("worker_kill") == 1
            assert [
                r["kind"] for r in rows[1:] if r.get("kind", "").startswith("chaos_")
            ] == ["chaos_worker_kill"]

            # the channel carries the resumed version's params
            blob = _client().kv_get(b"podracer/killres/params")
            version, _params = pickle.loads(blob)
            assert version == 1

            # chain a second step on the survived state: monotone resume
            state_ref, metrics_ref = driver._learn.remote(
                driver._cfg_blob, state_ref, *trajs
            )
            assert ray_tpu_torch.get(metrics_ref, timeout=300)["step"] == 2
        finally:
            driver.stop()
