"""Multi-agent RL on the port (ray_tpu_torch.rllib.multi_agent): the
reference's programs (tests/test_rllib_multi_agent.py) with its
assertions, on the port's runtime with ``device="cpu"`` (one runtime for
the file: ``torch_rllib_runtime.port_runtime``, no GPU, four CPUs); and
the flat masked PPO update held against the JAX package's on the same
padded batch, the JAX update's permutations fed to the port (rtol 1e-5,
atol 1e-6 in f32).
"""

import numpy as np
import pytest
import torch

from ray_tpu_torch.rllib import (
    MultiAgentEnv,
    MultiAgentEpisode,
    MultiAgentEnvRunner,
    PPOConfig,
    make_multi_agent,
)
from torch_rllib_runtime import port_runtime


@pytest.fixture(scope="module")
def rt():
    with port_runtime() as runtime:
        yield runtime


# ------------------------------------------------------------- env API
def test_make_multi_agent_env_api():
    env = make_multi_agent("CartPole-v1")({"num_agents": 3})
    assert env.possible_agents == ["agent_0", "agent_1", "agent_2"]
    obs, infos = env.reset(seed=7)
    assert set(obs) == set(env.possible_agents)
    acts = {a: env.get_action_space(a).sample() for a in env.agents}
    obs, rew, term, trunc, infos = env.step(acts)
    assert set(rew) == set(env.possible_agents)
    assert term["__all__"] is False
    # run until one sub-env terminates: that agent must drop out of
    # `agents`; an already-done agent never reappears in obs (the step
    # it dies it still returns its final obs, like the reference)
    for _ in range(500):
        done_before = [a for a in env.possible_agents if a not in env.agents]
        acts = {a: env.get_action_space(a).sample() for a in env.agents}
        obs, rew, term, trunc, infos = env.step(acts)
        for a in done_before:
            assert a not in obs
        if term["__all__"]:
            break
    assert term["__all__"] is True


# ------------------------------------------------- episode bookkeeping
def test_multi_agent_episode_turn_based_rewards():
    """A reward arriving while an agent is not acting accrues to its
    LAST action (reference: MultiAgentEpisode agent-step mapping)."""
    ep = MultiAgentEpisode(lambda aid: "default_policy")
    ep.add_env_reset({"a": [0.0], "b": [1.0]}, {})
    ep.add_action("a", 1, -0.5, 0.1)
    ep.add_action("b", 0, -0.5, 0.2)
    # only b acts this turn, but a receives a delayed reward
    ep.add_env_step({"b": [1.1]}, {"a": 5.0, "b": 1.0},
                    {"__all__": False}, {"__all__": False}, {})
    ep.add_action("b", 1, -0.6, 0.3)
    ep.add_env_step({"a": [0.2], "b": [1.2]}, {"a": 2.0, "b": 1.0},
                    {"__all__": True, "a": True, "b": True},
                    {"__all__": False}, {})
    seqs = ep.extract_sequences()["default_policy"]
    by_len = sorted(seqs, key=lambda s: len(s["actions"]))
    a_seq = by_len[0]
    assert a_seq["rewards"].tolist() == [7.0]  # 5.0 + 2.0 on one action
    assert ep.total_return() == pytest.approx(9.0)
    assert a_seq["terminated"] and by_len[1]["terminated"]


def test_episode_cut_carries_live_agents():
    ep = MultiAgentEpisode(lambda aid: "m")
    ep.add_env_reset({"a": [0.0], "b": [1.0]}, {})
    ep.add_action("a", 0, 0.0, 0.0)
    ep.add_action("b", 0, 0.0, 0.0)
    ep.add_env_step({"a": [0.1], "b": [1.1]}, {"a": 1.0, "b": 1.0},
                    {"__all__": False, "a": True}, {"__all__": False}, {})
    nxt = ep.cut()
    # a terminated -> dropped; b carries its last obs and running return
    assert list(nxt.tracks) == ["b"]
    assert nxt.tracks["b"].ep_return == pytest.approx(1.0)
    assert nxt.tracks["b"].obs[0].tolist() == [np.float32(1.1)]


# ------------------------------------------------------------- runner
def test_runner_groups_by_module_and_batches():
    runner = MultiAgentEnvRunner(
        make_multi_agent("CartPole-v1"),
        policy_mapping_fn=lambda aid, ep: f"p{int(aid[-1]) % 2}",
        env_config={"num_agents": 4},
        num_envs=2,
        seed=3,
        rollout_fragment_length=16,
    )
    specs = runner.module_specs()
    assert set(specs) == {"p0", "p1"} and specs["p0"] == (4, 2)
    from ray_tpu_torch.rllib.core import MLPSpec, init_mlp_module, params_to_numpy

    params = {
        m: params_to_numpy(init_mlp_module(torch.Generator().manual_seed(i), MLPSpec(4, 2),
                                           "cpu"))
        for i, m in enumerate(specs)
    }
    out = runner.sample(params, rng_seed=0)
    assert out["env_steps"] == 2 * 16
    for m in ("p0", "p1"):
        seqs = out["sequences"][m]
        assert seqs and all(len(s["actions"]) >= 1 for s in seqs)
        # fragment-cut sequences bootstrap from a final obs
        assert any(s["final_obs"] is not None for s in seqs)


# ------------------------------------------------------- convergence
@pytest.fixture
def ma_algo(rt):
    config = (
        PPOConfig()
        .environment(make_multi_agent("CartPole-v1"),
                     env_config={"num_agents": 2})
        .env_runners(num_env_runners=2, num_envs_per_env_runner=2,
                     rollout_fragment_length=64)
        .training(lr=3e-3, minibatch_size=64, num_epochs=4,
                  entropy_coeff=0.01, device="cpu")
        .multi_agent(
            policies={"shared"},
            policy_mapping_fn=lambda aid, ep: "shared",
        )
        .debugging(seed=42)
    )
    a = config.build_algo()
    yield a
    a.stop()


def test_multi_agent_ppo_shared_policy_learns(ma_algo, tmp_path):
    result = ma_algo.train()
    assert result["training_iteration"] == 1
    assert "shared" in result["learner"]
    assert np.isfinite(result["learner"]["shared"]["policy_loss"])
    first = last = (
        result["episode_return_mean"] if result["num_episodes"] else None
    )
    for _ in range(11):
        r = ma_algo.train()
        if first is None and r["num_episodes"] > 0:
            first = r["episode_return_mean"]
        if r["num_episodes"] > 0:
            last = r["episode_return_mean"]
    # 2-agent CartPole: total return is the SUM over both agents
    # (random ~40); PPO must be well up after ~12 iterations
    assert first is not None and last is not None
    assert last > first + 30, (first, last)

    path = ma_algo.save(str(tmp_path / "ck"))
    it = ma_algo.iteration
    ma_algo.train()
    ma_algo.restore(path)
    assert ma_algo.iteration == it

    import gymnasium as gym

    obs, _ = gym.make("CartPole-v1").reset(seed=0)
    assert ma_algo.compute_single_action(obs, "shared") in (0, 1)


def test_multi_agent_independent_policies(rt):
    """Two modules trained side by side: params must diverge from each
    other and both must update every iteration."""
    config = (
        PPOConfig()
        .environment(make_multi_agent("CartPole-v1"),
                     env_config={"num_agents": 2})
        .env_runners(num_env_runners=1, num_envs_per_env_runner=2,
                     rollout_fragment_length=32)
        .training(lr=3e-3, minibatch_size=32, num_epochs=2, device="cpu")
        .multi_agent(
            policies={"p_even", "p_odd"},
            policy_mapping_fn=lambda aid, ep: (
                "p_even" if int(aid[-1]) % 2 == 0 else "p_odd"
            ),
        )
        .debugging(seed=7)
    )
    algo = config.build_algo()
    try:
        before = {
            m: p["pi"]["w"].numpy().copy()
            for m, p in algo.params.items()
        }
        assert set(before) == {"p_even", "p_odd"}
        r = algo.train()
        assert set(r["learner"]) == {"p_even", "p_odd"}
        for m in ("p_even", "p_odd"):
            assert not np.allclose(
                before[m], algo.params[m]["pi"]["w"].numpy()
            ), f"module {m} did not update"
    finally:
        algo.stop()


def test_policy_mapping_validation(rt):
    config = (
        PPOConfig()
        .environment(make_multi_agent("CartPole-v1"),
                     env_config={"num_agents": 2})
        .env_runners(num_env_runners=1)
        .multi_agent(
            policies={"exists", "orphan"},
            policy_mapping_fn=lambda aid, ep: "exists",
        )
        .training(device="cpu")
    )
    with pytest.raises(ValueError, match="orphan"):
        config.build_algo()


# ------------------------------------------------------------ connectors
def test_connector_units():
    """ConnectorV2 pieces (reference: rllib/connectors/): flatten,
    running-mean-std normalize, per-agent frame stacking with peek."""
    from ray_tpu_torch.rllib import (
        ConnectorPipelineV2,
        FlattenObservations,
        FrameStackObservations,
        NormalizeObservations,
    )

    flat = FlattenObservations()
    out = flat({"obs": np.ones((3, 2, 2))})
    assert out["obs"].shape == (3, 4)

    norm = NormalizeObservations()
    rng = np.random.default_rng(0)
    data = rng.normal(5.0, 3.0, size=(500, 4)).astype(np.float32)
    norm({"obs": data})
    out = norm({"obs": data}, peek=True)["obs"]
    assert abs(out.mean()) < 0.1 and 0.8 < out.std() < 1.2

    fs = FrameStackObservations(3)
    keys = [(0, "a")]
    o1 = fs({"obs": np.array([[1.0]])}, keys=keys)["obs"]
    assert o1.tolist() == [[1.0, 1.0, 1.0]]  # first frame repeats
    fs({"obs": np.array([[2.0]])}, keys=keys)
    o3 = fs({"obs": np.array([[3.0]])}, keys=keys)["obs"]
    assert o3.tolist() == [[1.0, 2.0, 3.0]]
    # peek must not advance history
    pk = fs({"obs": np.array([[9.0]])}, keys=keys, peek=True)["obs"]
    assert pk.tolist() == [[2.0, 3.0, 9.0]]
    o4 = fs({"obs": np.array([[4.0]])}, keys=keys)["obs"]
    assert o4.tolist() == [[2.0, 3.0, 4.0]]
    fs.drop(keys)
    o5 = fs({"obs": np.array([[7.0]])}, keys=keys)["obs"]
    assert o5.tolist() == [[7.0, 7.0, 7.0]]

    pipe = ConnectorPipelineV2([FlattenObservations(),
                                FrameStackObservations(2)])
    assert pipe.output_dim(4) == 8
    out = pipe({"obs": np.ones((2, 2, 2))}, keys=[(0, "x"), (0, "y")])
    assert out["obs"].shape == (2, 8)


def test_normalize_small_sample_std_unbiased():
    """Regression: _m2 must start at zeros (the additive identity), not
    ones — a ones seed adds a phantom unit of variance per feature and
    inflates small-sample std estimates (normalized outputs read low)."""
    from ray_tpu_torch.rllib import NormalizeObservations

    norm = NormalizeObservations(clip=100.0)
    batch = np.array([[0.0], [2.0], [4.0]], np.float32)  # mean 2, m2 8
    norm({"obs": batch})
    st = norm.state()
    assert st["count"] == 3.0
    np.testing.assert_allclose(st["mean"], [2.0], atol=1e-9)
    # sum of squared deviations exactly; ones-seeded would report 9
    np.testing.assert_allclose(st["m2"], [8.0], atol=1e-6)
    # normalized output uses the unbiased sample std sqrt(8/2) = 2
    out = norm({"obs": batch}, peek=True)["obs"]
    np.testing.assert_allclose(out[:, 0], [-1.0, 0.0, 1.0], atol=1e-5)


def test_multi_agent_with_connector_pipeline(rt):
    """env→module connectors wired through the multi-agent runner: the
    module trains on stacked frames (obs_dim doubles) and learner
    sequences carry the PROCESSED obs."""
    from ray_tpu_torch.rllib import (
        ConnectorPipelineV2,
        FlattenObservations,
        FrameStackObservations,
    )

    config = (
        PPOConfig()
        .environment(make_multi_agent("CartPole-v1"),
                     env_config={"num_agents": 2})
        .env_runners(
            num_env_runners=1, num_envs_per_env_runner=2,
            rollout_fragment_length=32,
            env_to_module_connector=lambda: ConnectorPipelineV2(
                [FlattenObservations(), FrameStackObservations(2)]
            ),
        )
        .training(lr=3e-3, minibatch_size=32, num_epochs=2, device="cpu")
        .multi_agent(policies={"shared"},
                     policy_mapping_fn=lambda aid, ep: "shared")
        .debugging(seed=11)
    )
    algo = config.build_algo()
    try:
        # CartPole obs is 4 -> stacked module spec must be 8
        assert algo.module_specs["shared"].obs_dim == 8
        r = algo.train()
        assert r["num_env_steps_sampled_lifetime"] > 0
        assert np.isfinite(r["learner"]["shared"]["policy_loss"])
        r2 = algo.train()
        assert r2["training_iteration"] == 2
    finally:
        algo.stop()


# ------------------------------------------------------- the JAX package
def test_flat_ppo_update_matches_jax_with_its_permutations():
    """The masked flat update on a padded bucket (host GAE from
    ``_gae_flat``, as the driver builds it) against the JAX package's,
    the permutations the JAX update draws fed to the port."""
    import jax

    from ray_tpu.rllib import core as jcore, multi_agent as jma, ppo as jppo
    from ray_tpu_torch.rllib import core as tcore, multi_agent as tma

    rng = np.random.default_rng(0)
    seqs = [{"obs": rng.standard_normal((n, 4)).astype(np.float32),
             "actions": rng.integers(0, 2, n), "rewards": np.ones(n, np.float32),
             "logp": np.log(rng.uniform(0.3, 0.7, n)).astype(np.float32),
             "values": rng.standard_normal(n).astype(np.float32),
             "terminated": bool(n % 2)} for n in (40, 27, 33)]
    boot = rng.standard_normal(3).astype(np.float32)
    flat = tma._gae_flat(seqs, boot, 0.99, 0.95)
    ref = jma._gae_flat(seqs, boot, 0.99, 0.95)
    for k in ref:
        np.testing.assert_array_equal(flat[k], ref[k])
    n, bucket = len(flat["actions"]), 128
    flat["advantages"] = (flat["advantages"] - flat["advantages"].mean()) / (
        flat["advantages"].std() + 1e-8)
    padded = {k: np.concatenate([v, np.zeros((bucket - n,) + v.shape[1:], v.dtype)])
              for k, v in flat.items()}
    padded["mask"] = (np.arange(bucket) < n).astype(np.float32)
    jcfg = jppo.PPOConfig(lr=3e-3, minibatch_size=32, num_epochs=2)
    cfg = PPOConfig(lr=3e-3, minibatch_size=32, num_epochs=2)
    jp = jcore.init_mlp_module(jax.random.PRNGKey(3), jcore.MLPSpec(4, 2))
    jopt, jupd = jma.make_flat_ppo_update(jcfg, jcore.MLPSpec(4, 2), bucket)
    key = jax.random.PRNGKey(4)
    jparams, _, jm = jupd(jp, jopt.init(jp), padded, key)
    perms = np.stack([np.asarray(jax.random.permutation(k, bucket))
                      for k in jax.random.split(key, jcfg.num_epochs)])
    topt, tupd = tma.make_flat_ppo_update(cfg, tcore.MLPSpec(4, 2), bucket)
    tp = tcore.params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    tparams, _, tm = tupd(tp, topt.init(tp), padded, torch.from_numpy(perms))
    # the params after 8 Adam steps per tensor, ||port - jax|| <= 1e-5
    # ||jax|| + 1e-6: Adam divides each element by its own RMS, so an
    # element whose gradient is ~1e-10 turns f32 summation noise into a
    # visible step while the tensor agrees
    for a, b in zip(jax.tree_util.tree_leaves(jparams), tcore.tree_leaves(tparams)):
        a = np.asarray(a, np.float64)
        assert np.linalg.norm(b.numpy() - a) <= 1e-5 * np.linalg.norm(a) + 1e-6
    for k in jm:
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-5, atol=1e-6)
