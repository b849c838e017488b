"""RLlib on the port, held against the JAX package on the CPU.

Parity: the same numpy inputs, made from a seed, go through the JAX
function and its counterpart in ``ray_tpu_torch.rllib``; params carried
over with ``params_from_numpy``. Where the JAX function draws
randomness (PPO's minibatch permutations, SAC's Gaussian noise), its
draws are fed to the port, which takes them as arguments. Tolerance
rtol 1e-5, atol 1e-6 in f32 unless a test says otherwise: the same
arithmetic in another order (XLA's fusions against eager torch ops).

Behaviour: the reference's programs (tests/test_rllib.py) on the port's
runtime with ``device="cpu"``: PPO, IMPALA and APPO learning CartPole
with gymnasium, DQN, the replay buffers, BC from a Dataset, MARWIL and
CQL, with the reference's assertions at its sizes. One runtime for the
file (``torch_rllib_runtime.port_runtime``: no GPU, four CPUs, one
compute thread a process).
Learners given no device raise without a card.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import ray_tpu_torch
from ray_tpu.rllib import core as jcore
from ray_tpu_torch.rllib import core as tcore
from torch_rllib_runtime import port_runtime

RTOL, ATOL = 1e-5, 1e-6


def close(a, b, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=rtol, atol=atol)


def close_trees(a, b, rtol=RTOL, atol=ATOL, per_tensor=False):
    """Leaf by leaf; ``per_tensor``: ||b - a|| <= rtol ||a|| + atol for
    each leaf, for params after Adam steps whose gradients were summed in
    another order (Adam divides each element by its own RMS, so an
    element whose gradient is ~1e-10 turns f32 summation noise into a
    visible step while the tensor agrees)."""
    la = jax.tree_util.tree_leaves(jax.tree.map(np.asarray, a))
    lb = tcore.tree_leaves(tcore.params_to_numpy(b))
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        if per_tensor:
            err = float(np.linalg.norm(np.asarray(y, np.float64) - x))
            assert err <= rtol * float(np.linalg.norm(x)) + atol, (err, np.linalg.norm(x))
        else:
            close(y, x, rtol, atol)


def jax_params(spec_args, seed=0):
    """(JAX params, the same as numpy) of an MLP module."""
    spec = jcore.MLPSpec(*spec_args)
    p = jcore.init_mlp_module(jax.random.PRNGKey(seed), spec)
    return p, jax.tree.map(np.asarray, p)


def time_major_batch(rng, T, B, obs_dim=4, num_actions=2):
    return {
        "obs": rng.standard_normal((T, B, obs_dim)).astype(np.float32),
        "actions": rng.integers(0, num_actions, (T, B)).astype(np.int32),
        "rewards": rng.standard_normal((T, B)).astype(np.float32),
        "dones": (rng.random((T, B)) < 0.15).astype(np.float32),
        "logp_mu": np.log(rng.uniform(0.2, 0.8, (T, B))).astype(np.float32),
        "final_obs": rng.standard_normal((B, obs_dim)).astype(np.float32),
    }


# ------------------------------------------------------------ the module
def test_forward_and_logp_match_the_jax_module():
    jp, npp = jax_params((4, 3, (16, 8)))
    tp = tcore.params_from_numpy(npp, "cpu")
    assert set(tp) == {"pi_torso", "pi", "vf_torso", "vf"}
    obs = np.random.default_rng(0).standard_normal((32, 4)).astype(np.float32)
    acts = np.random.default_rng(1).integers(0, 3, 32)
    jl, jv = jcore.forward(jp, obs)
    tl, tv = tcore.forward(tp, torch.from_numpy(obs))
    close(tl, jl)
    close(tv, jv)
    jlogp = jax.nn.log_softmax(jl)[jnp.arange(32), acts]
    tlogp = tcore.take_along(torch.log_softmax(tl, -1), torch.from_numpy(acts))
    close(tlogp, jlogp)
    # sample_actions' contract: (actions, logp at them, value)
    a, lp, v = tcore.sample_actions(tp, torch.from_numpy(obs), torch.Generator().manual_seed(3))
    assert a.shape == (32,) and a.dtype == torch.int64 and int(a.min()) >= 0 and int(a.max()) < 3
    close(lp, np.asarray(jax.nn.log_softmax(jl))[np.arange(32), a.numpy()])
    close(v, jv)
    # the port's own init: the reference's shapes and gains (orthogonal
    # columns scaled by the gain), the same weights on any device
    spec = tcore.MLPSpec(4, 3, (16, 8))
    own = tcore.init_mlp_module(torch.Generator().manual_seed(0), spec, "cpu")
    assert tcore.tree_map(lambda t: tuple(t.shape), own) == jax.tree.map(
        lambda x: tuple(x.shape), npp)
    w = own["pi"]["w"]
    close(w.T @ w, 0.01**2 * torch.eye(3), atol=1e-7)
    again = tcore.init_mlp_module(torch.Generator().manual_seed(0), spec, "cpu")
    assert all(torch.equal(x, y) for x, y in zip(tcore.tree_leaves(own), tcore.tree_leaves(again)))


def test_sample_actions_draws_the_categorical_distribution():
    """The stream differs from jax.random.categorical's; the distribution
    does not: 20000 draws of one row's logits against its softmax."""
    logits = torch.tensor([[0.3, -1.0, 1.2]])
    u = torch.rand((20000, 3), generator=torch.Generator().manual_seed(0))
    draws = tcore.gumbel_argmax(logits.expand(20000, 3), u)
    freq = torch.bincount(draws, minlength=3).double() / 20000
    assert torch.allclose(freq, torch.softmax(logits[0].double(), 0), atol=0.015), freq


# ------------------------------------------------------------ the env
def test_torch_cartpole_step_matches_the_jax_env():
    """One step from random states, JAX's reset draws fed in: against the
    jitted JAX step within the tolerance (XLA contracts the Euler
    updates' mul-adds into FMAs, one rounding where torch rounds twice),
    and against the same step run op by op, bit for bit once both take
    the same sin and cos (the two libraries' f32 trig differ by an ulp)."""
    from ray_tpu.rllib.podracer.jax_env import JaxCartPole
    from ray_tpu_torch.rllib.podracer.torch_env import TorchCartPole

    n = 512
    rng = np.random.default_rng(0)
    phys = (rng.standard_normal((n, 4)) * np.array([1, 1, 0.1, 1])).astype(np.float32)
    t0 = rng.integers(0, 500, n).astype(np.int32)
    acts = rng.integers(0, 2, n).astype(np.int32)
    keys = jax.random.split(jax.random.PRNGKey(0), n)
    draws = np.array(jax.vmap(lambda k: jax.random.uniform(
        k, (4,), minval=-0.05, maxval=0.05))(keys))
    jin = ({"phys": jnp.asarray(phys), "t": jnp.asarray(t0)}, jnp.asarray(acts), keys)
    tin = ({"phys": torch.from_numpy(phys), "t": torch.from_numpy(t0)}, torch.from_numpy(acts),
           torch.from_numpy(draws))
    ts, to, tr, td = TorchCartPole.step(*tin)
    for step in (jax.jit(jax.vmap(JaxCartPole.step)), jax.vmap(JaxCartPole.step)):
        js, jo, jr, jd = step(*jin)
        np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
        np.testing.assert_array_equal(ts["t"].numpy(), np.asarray(js["t"]))
        close(to, jo)
        close(ts["phys"], js["phys"])
        close(tr, jr)
    assert 0 < int(td.sum()) < n
    # op by op, with JAX's sin and cos: bit for bit
    trig = {torch.cos: jnp.cos, torch.sin: jnp.sin}
    real = dict(cos=torch.cos, sin=torch.sin)
    try:
        for name, fn in real.items():
            setattr(torch, name, lambda x, f=trig[fn]: torch.from_numpy(
                np.array(f(jnp.asarray(x.numpy())))))
        ts, to, _, _ = TorchCartPole.step(*tin)
    finally:
        for name, fn in real.items():
            setattr(torch, name, fn)
    np.testing.assert_array_equal(ts["phys"].numpy(), np.asarray(js["phys"]))
    np.testing.assert_array_equal(to.numpy(), np.asarray(jo))


def test_torch_cartpole_rollout_matches_the_jax_env():
    """A 200-step rollout of 64 envs with the actions and reset draws
    fixed, against the JAX step run op by op (the jitted step's FMAs
    differ by an ulp a step, which CartPole's unstable pole grows past
    1e-5 within an episode): the dones equal, the observations within
    1e-5."""
    from ray_tpu.rllib.podracer.jax_env import JaxCartPole
    from ray_tpu_torch.rllib.podracer.torch_env import TorchCartPole

    n = 64
    keys = jax.random.split(jax.random.PRNGKey(0), n)
    jstate, jobs = jax.vmap(JaxCartPole.reset)(keys)
    draws = np.stack([np.asarray(jax.random.uniform(k, (4,), minval=-0.05, maxval=0.05))
                      for k in keys])
    np.testing.assert_array_equal(np.asarray(jobs), draws)
    tstate, tobs = TorchCartPole.reset(torch.from_numpy(draws))
    rng = np.random.default_rng(0)
    step_v = jax.vmap(JaxCartPole.step)
    n_done = 0
    for t in range(200):
        acts = rng.integers(0, 2, n).astype(np.int32)
        skeys = jax.random.split(jax.random.PRNGKey(1000 + t), n)
        jstate, jobs, jrew, jdone = step_v(jstate, jnp.asarray(acts), skeys)
        # the reset draws the JAX step made inside, fed to the port
        rdraw = np.array(jax.vmap(lambda k: jax.random.uniform(
            k, (4,), minval=-0.05, maxval=0.05))(skeys))
        tstate, tobs, trew, tdone = TorchCartPole.step(
            tstate, torch.from_numpy(acts), torch.from_numpy(rdraw))
        np.testing.assert_array_equal(tdone.numpy(), np.asarray(jdone))
        close(tobs, jobs, rtol=0, atol=1e-5)
        close(trew, jrew)
        np.testing.assert_array_equal(tstate["t"].numpy(), np.asarray(jstate["t"]))
        n_done += int(tdone.sum())
    assert n_done > 50  # random actions end many episodes: the reset path ran


# ------------------------------------------------------------ V-trace, GAE
def test_vtrace_matches_jax():
    from ray_tpu.rllib import vtrace as jvtrace
    from ray_tpu_torch.rllib import vtrace

    rng = np.random.default_rng(0)
    T, B = 16, 8
    b = rng.standard_normal((T, B)).astype(np.float32) - 1.0
    t = rng.standard_normal((T, B)).astype(np.float32) - 1.0
    r = rng.standard_normal((T, B)).astype(np.float32)
    d = (rng.random((T, B)) < 0.2).astype(np.float32)
    v = rng.standard_normal((T, B)).astype(np.float32)
    boot = rng.standard_normal(B).astype(np.float32)
    for clip_rho, clip_c in ((1.0, 1.0), (2.0, 0.5)):
        jvs, jpg = jvtrace(b, t, r, d, v, boot, gamma=0.97, clip_rho=clip_rho, clip_c=clip_c)
        tvs, tpg = vtrace(b, t, r, d, v, boot, gamma=0.97, clip_rho=clip_rho, clip_c=clip_c)
        close(tvs, jvs)
        close(tpg, jpg)


def test_vtrace_reduces_to_gae_like_onpolicy():
    """With rho == 1 (on-policy) and no clipping active, V-trace vs
    equals the n-step TD(lambda=1) return recursion."""
    from ray_tpu_torch.rllib import vtrace

    T, B = 5, 3
    rng = np.random.default_rng(0)
    behavior = np.zeros((T, B), np.float32)
    rewards = rng.normal(size=(T, B)).astype(np.float32)
    dones = np.zeros((T, B), np.float32)
    values = rng.normal(size=(T, B)).astype(np.float32)
    boot = rng.normal(size=(B,)).astype(np.float32)
    vs, pg = vtrace(behavior, behavior, rewards, dones, values, boot,
                    gamma=0.9, clip_rho=1.0, clip_c=1.0)
    expected = np.zeros((T, B), np.float32)
    nxt = boot
    for t in reversed(range(T)):
        expected[t] = rewards[t] + 0.9 * nxt
        nxt = expected[t]
    np.testing.assert_allclose(vs.numpy(), expected, rtol=1e-5, atol=1e-5)


def test_compute_gae_matches_jax():
    from ray_tpu.rllib.ppo import compute_gae as jgae
    from ray_tpu_torch.rllib.ppo import compute_gae

    rng = np.random.default_rng(1)
    T, N = 32, 6
    r, v = (rng.standard_normal((T, N)).astype(np.float32) for _ in range(2))
    d = (rng.random((T, N)) < 0.1).astype(np.float32)
    fv = rng.standard_normal(N).astype(np.float32)
    ja, jt = jgae(r, v, d, fv, 0.99, 0.95)
    ta, tt = compute_gae(*(torch.from_numpy(x) for x in (r, v, d, fv)), 0.99, 0.95)
    close(ta, ja)
    close(tt, jt)


# ------------------------------------------------------------ losses and updates
@pytest.mark.parametrize("loss", ["impala", "appo"])
def test_vtrace_losses_and_grads_match_jax(loss):
    from ray_tpu.rllib import appo as jappo, impala as jimpala
    from ray_tpu_torch.rllib import appo, impala

    cfg = appo.APPOConfig()
    jcfg = jappo.APPOConfig()
    jp, npp = jax_params((4, 2, (32, 32)), seed=1)
    batch = time_major_batch(np.random.default_rng(2), 16, 8)
    jloss = (jappo.make_appo_loss if loss == "appo" else jimpala.make_impala_loss)(
        jcfg, jcore.MLPSpec(4, 2, (32, 32)))
    tloss = (appo.make_appo_loss if loss == "appo" else impala.make_impala_loss)(
        cfg, tcore.MLPSpec(4, 2, (32, 32)))
    (jtot, jm), jg = jax.value_and_grad(jloss, has_aux=True)(jp, batch)
    tp = tcore.params_from_numpy(npp, "cpu")
    (ttot, tm), tg = tcore.value_and_grad(tloss, tp, tcore.to_tensors(batch, torch.device("cpu")))
    close(ttot, jtot)
    assert set(tm) == set(jm)
    for k in jm:
        close(tm[k], jm[k])
    close_trees(jg, tcore.tree_unflatten(tp, tg))


@pytest.mark.parametrize("grad_scale", [1e-3, 10.0])  # the clip idle, then active
def test_optimizer_matches_optax(grad_scale):
    """Three clip(1.0)+Adam(5e-3) steps against optax.chain on the same
    gradients, and optax.adam without a clip."""
    from ray_tpu_torch.rllib.podracer.learner import make_optimizer
    from ray_tpu_torch.rllib.podracer.config import PodracerConfig

    _, npp = jax_params((4, 2, (32, 32)), seed=3)
    rng = np.random.default_rng(4)
    grads = [jax.tree.map(lambda x: (rng.standard_normal(x.shape) * grad_scale).astype(
        np.float32), npp) for _ in range(3)]
    for jopt, topt in ((optax.chain(optax.clip_by_global_norm(1.0), optax.adam(5e-3)),
                        make_optimizer(PodracerConfig())),
                       (optax.adam(1e-3), tcore.adam(1e-3))):
        jparams, tparams = npp, tcore.params_from_numpy(npp, "cpu")
        jstate, tstate = jopt.init(jparams), topt.init(tparams)
        for g in grads:
            upd, jstate = jopt.update(g, jstate, jparams)
            jparams = optax.apply_updates(jparams, upd)
            tparams, tstate = topt.update(tcore.tree_leaves(tcore.params_from_numpy(g, "cpu")),
                                          tstate, tparams)
        close_trees(jparams, tparams)
        assert tstate.count == 3


def test_ppo_update_matches_jax_with_its_permutations():
    from ray_tpu.rllib import ppo as jppo
    from ray_tpu_torch.rllib import ppo

    cfg = ppo.PPOConfig(minibatch_size=16, num_epochs=2, lr=3e-3)
    jcfg = jppo.PPOConfig(minibatch_size=16, num_epochs=2, lr=3e-3)
    jp, npp = jax_params((4, 2, (16, 16)), seed=5)
    rng = np.random.default_rng(6)
    T, N = 8, 4
    rollout = {
        "obs": rng.standard_normal((T, N, 4)).astype(np.float32),
        "actions": rng.integers(0, 2, (T, N)).astype(np.int64),
        "rewards": np.ones((T, N), np.float32),
        "dones": (rng.random((T, N)) < 0.1).astype(np.float32),
        "logp": np.log(rng.uniform(0.3, 0.7, (T, N))).astype(np.float32),
        "values": rng.standard_normal((T, N)).astype(np.float32),
        "final_obs": rng.standard_normal((N, 4)).astype(np.float32),
    }
    jopt, jupdate = jppo.make_ppo_update(jcfg, jcore.MLPSpec(4, 2, (16, 16)))
    key = jax.random.PRNGKey(7)
    jparams, _, jm = jupdate(jp, jopt.init(jp), rollout, key)
    # the permutations the JAX update draws from its key, fed to the port
    perms = np.stack([np.asarray(jax.random.permutation(k, T * N))
                      for k in jax.random.split(key, jcfg.num_epochs)])
    topt, tupdate = ppo.make_ppo_update(cfg, tcore.MLPSpec(4, 2, (16, 16)))
    tp = tcore.params_from_numpy(npp, "cpu")
    tparams, tstate, tm = tupdate(tp, topt.init(tp), rollout, torch.from_numpy(perms))
    assert tstate.count == 2 * (T * N // 16)
    close_trees(jparams, tparams)
    for k in jm:
        close(tm[k], jm[k])


def test_double_q_target_matches_jax():
    from ray_tpu.rllib import dqn as jdqn
    from ray_tpu_torch.rllib import dqn

    spec = jcore.MLPSpec(4, 3, (16, 16))
    online = jax.tree.map(np.asarray, jdqn._init_q_net(jax.random.PRNGKey(0), spec))
    target = jax.tree.map(np.asarray, jdqn._init_q_net(jax.random.PRNGKey(1), spec))
    rng = np.random.default_rng(0)
    batch = {"next_obs": rng.standard_normal((64, 4)).astype(np.float32),
             "rewards": rng.standard_normal(64).astype(np.float32),
             "dones": (rng.random(64) < 0.3).astype(np.float32)}
    tb = tcore.to_tensors(batch, torch.device("cpu"))
    for double_q in (True, False):
        j = jdqn.double_q_target(online, target, batch, gamma=0.97, double_q=double_q)
        t = dqn.double_q_target(tcore.params_from_numpy(online, "cpu"),
                                tcore.params_from_numpy(target, "cpu"), tb,
                                gamma=0.97, double_q=double_q)
        close(t, j)


def _sac_setup():
    from ray_tpu.rllib import sac as jsac

    params = jsac.init_sac_params(jax.random.PRNGKey(0), 3, 2, (32, 32))
    return params, jax.tree.map(np.asarray, params)


def test_sac_squashed_logp_matches_jax_given_the_noise():
    from ray_tpu.rllib import sac as jsac
    from ray_tpu_torch.rllib import sac

    jp, npp = _sac_setup()
    obs = np.random.default_rng(0).standard_normal((50, 3)).astype(np.float32) * 3
    key = jax.random.PRNGKey(9)
    jact, jlogp = jsac._sample_squashed(jp["pi"], obs, key)
    eps = np.asarray(jax.random.normal(key, (50, 2)))
    tact, tlogp = sac._sample_squashed(tcore.params_from_numpy(npp["pi"], "cpu"),
                                       torch.from_numpy(obs), torch.from_numpy(eps))
    close(tact, jact)
    close(tlogp, jlogp, rtol=1e-5, atol=1e-5)


def test_sac_update_matches_jax_given_the_noise():
    """One SAC update (twin critics, actor, alpha, polyak) — the fast
    stand-in for the slow Pendulum convergence run."""
    from ray_tpu.rllib import sac as jsac
    from ray_tpu_torch.rllib import sac

    jp, npp = _sac_setup()
    cfg = sac.SACConfig(actor_lr=1e-3, critic_lr=1e-3, alpha_lr=1e-3)
    jcfg = jsac.SACConfig(actor_lr=1e-3, critic_lr=1e-3, alpha_lr=1e-3)
    rng = np.random.default_rng(1)
    B = 64
    batch = {"obs": rng.standard_normal((B, 3)).astype(np.float32),
             "actions": rng.uniform(-1, 1, (B, 2)).astype(np.float32),
             "rewards": rng.standard_normal(B).astype(np.float32),
             "next_obs": rng.standard_normal((B, 3)).astype(np.float32),
             "dones": (rng.random(B) < 0.1).astype(np.float32)}
    a_opt, c_opt, al_opt, jupdate = jsac.make_sac_update(jcfg, 2)
    jtq = {"q1": jp["q1"], "q2": jp["q2"]}
    jla = jnp.asarray(0.0, jnp.float32)
    jstate = (jp, jtq, jla, {"critic": c_opt.init(jtq), "actor": a_opt.init(jp["pi"]),
                             "alpha": al_opt.init(jla)})
    key = jax.random.PRNGKey(11)
    (jparams, jtarget, jlog_alpha, _), jcl, jal = jupdate(jstate, batch, key)
    k1, k2 = jax.random.split(key)
    e1, e2 = (torch.from_numpy(np.asarray(jax.random.normal(k, (B, 2)))) for k in (k1, k2))
    ta, tc, tal, tupdate = sac.make_sac_update(cfg, 2)
    tp = tcore.params_from_numpy(npp, "cpu")
    ttq = tcore.tree_map(torch.clone, {"q1": tp["q1"], "q2": tp["q2"]})
    tla = torch.tensor(0.0)
    tstate = (tp, ttq, tla, {"critic": tc.init(ttq), "actor": ta.init(tp["pi"]),
                             "alpha": tal.init(tla)})
    (tparams, ttarget, tlog_alpha, _), tcl, tall = tupdate(tstate, batch, e1, e2)
    close(tcl, jcl)
    close(tall, jal, atol=1e-5)
    close(tlog_alpha, jlog_alpha)
    close_trees(jparams, tparams)
    close_trees(jtarget, ttarget)


def _offline_rows(rng, n=256):
    return {"obs": rng.standard_normal((n, 4)).astype(np.float32),
            "actions": rng.integers(0, 2, n).astype(np.int64),
            "returns": rng.standard_normal(n).astype(np.float32),
            "rewards": rng.standard_normal(n).astype(np.float32),
            "next_obs": rng.standard_normal((n, 4)).astype(np.float32),
            "dones": (rng.random(n) < 0.1).astype(np.float32)}


@pytest.mark.parametrize("algo", ["bc", "marwil", "cql", "dqn"])
def test_offline_and_dqn_updates_match_jax(algo):
    """Two updates of each learner from the JAX learner's own params:
    the losses and the updated params (loss, gradient, clip and Adam)."""
    import importlib

    jmod = importlib.import_module(f"ray_tpu.rllib.{algo}")
    tmod = importlib.import_module(f"ray_tpu_torch.rllib.{algo}")
    rows = _offline_rows(np.random.default_rng(2))
    tb = tcore.to_tensors(rows, torch.device("cpu"))
    name = {"bc": "BC", "marwil": "MARWIL", "cql": "CQL", "dqn": "DQN"}[algo]
    if algo == "dqn":
        spec = jcore.MLPSpec(4, 2, (32, 32))
        jparams = jdqn_params = jmod._init_q_net(jax.random.PRNGKey(0), spec)
        jtarget = jax.tree.map(lambda x: x * 0.9, jdqn_params)
        jopt, jupd = jmod.make_dqn_update(jmod.DQNConfig(), spec)
        topt, tupd = tmod.make_dqn_update(tmod.DQNConfig(), tcore.MLPSpec(4, 2, (32, 32)))
        jstate = jopt.init(jparams)
    else:
        jalgo = getattr(jmod, f"{name}Config")().build_algo(4, 2)
        talgo = getattr(tmod, f"{name}Config")().training(device="cpu").build_algo(4, 2)
        jparams = jalgo.params
        jstate = jalgo.opt_state
        jupd, tupd, topt = jalgo._update, talgo._update, talgo.optimizer
        jtarget = jax.tree.map(lambda x: x * 0.9, jparams)
    tparams = tcore.params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    ttarget = tcore.params_from_numpy(jax.tree.map(np.asarray, jtarget), "cpu")
    tstate = topt.init(tparams)
    jma = jnp.asarray(1.0, jnp.float32)
    tma = torch.tensor(1.0)
    for _ in range(2):
        if algo == "bc":
            jparams, jstate, jl = jupd(jparams, jstate, rows["obs"], rows["actions"])
            tparams, tstate, tl = tupd(tparams, tstate, tb["obs"], tb["actions"])
        elif algo == "marwil":
            jparams, jstate, jma, jl, _, _ = jupd(jparams, jstate, jma, rows["obs"],
                                                  rows["actions"], rows["returns"])
            tparams, tstate, tma, tl, _, _ = tupd(tparams, tstate, tma, tb["obs"],
                                                  tb["actions"], tb["returns"])
            close(tma, jma)
        else:
            jparams, jstate, jl, *_ = jupd(jparams, jtarget, jstate, rows)
            tparams, tstate, tl, *_ = tupd(tparams, ttarget, tstate, rows)
        close(tl, jl)
    close_trees(jparams, tparams)


def test_sharded_update_on_two_cpu_ranks_matches_one_and_the_jax_group():
    """make_sharded_update over an NCCL group of 2 CPU "devices" against
    the one-device update (V-trace: the mean of the shards' means is the
    global mean) and against the JAX package's sharded update over an
    XlaGroup of 2 host devices (both losses)."""
    from ray_tpu.rllib.podracer import PodracerConfig as JConfig
    from ray_tpu.rllib.podracer.learner import make_sharded_update as jsharded
    from ray_tpu.util.collective.collective_group.xla_group import XlaGroup
    from ray_tpu_torch.rllib.podracer import PodracerConfig
    from ray_tpu_torch.rllib.podracer.learner import (
        make_sharded_update, make_update_fn, replicate, shard_batch)
    from ray_tpu_torch.util.collective.collective_group.nccl_group import NcclGroup

    jp, npp = jax_params((4, 2, (32, 32)), seed=8)
    batch = time_major_batch(np.random.default_rng(9), 16, 8)
    cpu2 = [torch.device("cpu")] * 2
    group = NcclGroup(2, 0, "test-sharded", devices=cpu2)
    for loss in ("vtrace", "appo"):
        cfg = PodracerConfig().training(loss=loss)
        spec = cfg.spec
        opt, upd = make_sharded_update(cfg, spec, group)
        tp = tcore.params_from_numpy(npp, "cpu")
        params, states = replicate(tp, cpu2), replicate(opt.init(tp), cpu2)
        for _ in range(2):
            params, states, tm = upd(params, states, shard_batch(batch, cpu2))
        close_trees(jax.tree.map(np.asarray, tcore.params_to_numpy(params[0])), params[1],
                    rtol=0, atol=0)
        jcfg = JConfig().training(loss=loss)
        jopt, jupd = jsharded(jcfg, jcfg.spec, XlaGroup(2, 0, f"test-sharded-{loss}"))
        jparams, jstate = jp, jopt.init(jp)
        for _ in range(2):
            jparams, jstate, jm = jupd(jparams, jstate, batch)
        close_trees(jparams, params[0], per_tensor=True)
        for k in jm:
            close(tm[k], jm[k])
        if loss == "vtrace":
            opt1, upd1 = make_update_fn(cfg, spec)
            p1, s1 = tp, opt1.init(tp)
            for _ in range(2):
                p1, s1, m1 = upd1(p1, s1, batch)
            close_trees(jax.tree.map(np.asarray, tcore.params_to_numpy(p1)), params[0],
                        per_tensor=True)


# ------------------------------------------------------------ no card
def test_learners_given_no_device_raise_without_a_card(monkeypatch):
    """device=None means the GPU; without one every entry point raises
    before it starts anything, and never carries on on the CPU."""
    from ray_tpu_torch.rllib import (
        APPOConfig, BCConfig, CQLConfig, DQNConfig, IMPALAConfig, MARWILConfig, PPOConfig,
        SACConfig)

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tcore.init_mlp_module(torch.Generator(), tcore.MLPSpec(4, 2))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tcore.params_from_numpy({"w": np.zeros(2, np.float32)})
    for cfg in (PPOConfig(), IMPALAConfig(), APPOConfig(), DQNConfig(), SACConfig()):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            cfg.environment("CartPole-v1").build_algo()
    multi = PPOConfig().environment("x").multi_agent(policies={"p"})
    with pytest.raises(RuntimeError, match="device='cpu'"):
        multi.build_algo()
    for cfg in (BCConfig(), MARWILConfig(), CQLConfig()):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            cfg.build_algo(4, 2)
    assert not ray_tpu_torch.is_initialized()


# ------------------------------------------------------------ the reference's programs
@pytest.fixture(scope="module")
def rt():
    with port_runtime() as runtime:
        yield runtime


def test_ppo_learns_cartpole(rt, tmp_path):
    """Convergence + per-iteration metrics + checkpoint roundtrip +
    action API in one algorithm's lifetime (reference:
    tests/test_rllib.py:26; learning read from the episodes finished
    during each iteration)."""
    from ray_tpu_torch.rllib import PPOConfig

    algo = (
        PPOConfig()
        .environment("CartPole-v1")
        .env_runners(num_env_runners=2, num_envs_per_env_runner=2,
                     rollout_fragment_length=64)
        .training(lr=3e-3, minibatch_size=64, num_epochs=4, entropy_coeff=0.01,
                  device="cpu")
        .debugging(seed=42)
        .build_algo()
    )
    try:
        result = algo.train()
        assert result["training_iteration"] == 1
        assert result["num_env_steps_sampled_lifetime"] == 2 * 2 * 64
        assert np.isfinite(result["policy_loss"])
        assert np.isfinite(result["vf_loss"])
        first = last = (
            result["episode_return_recent_mean"]
            if result["num_episodes_recent"] else None
        )
        for _ in range(11):
            r = algo.train()
            if first is None and r["num_episodes_recent"] > 0:
                first = r["episode_return_recent_mean"]
            if r["num_episodes_recent"] > 0:
                last = r["episode_return_recent_mean"]
        assert first is not None and last is not None
        # CartPole random policy ~20; after ~6k steps PPO should be well up
        assert last > first + 20, (first, last)

        path = algo.save(str(tmp_path / "ck"))
        it = algo.iteration
        before = tcore.params_to_numpy(algo.params)
        algo.train()
        algo.restore(path)
        assert algo.iteration == it
        for a, b in zip(tcore.tree_leaves(before), tcore.tree_leaves(algo.params)):
            np.testing.assert_array_equal(a, b.numpy())

        import gymnasium as gym

        env = gym.make("CartPole-v1")
        obs, _ = env.reset(seed=0)
        assert algo.compute_single_action(obs) in (0, 1)
    finally:
        algo.stop()


def test_impala_learns_cartpole(rt, tmp_path):
    """Async actor-learner convergence + metrics + checkpoint roundtrip
    (reference: tests/test_rllib.py:90)."""
    from ray_tpu_torch.rllib import IMPALAConfig

    algo = (
        IMPALAConfig()
        .environment("CartPole-v1")
        .env_runners(num_env_runners=2, num_envs_per_env_runner=2,
                     rollout_fragment_length=64)
        .training(lr=3e-3, entropy_coeff=0.005, updates_per_iteration=8, device="cpu")
        .debugging(seed=42)
        .build_algo()
    )
    try:
        r = algo.train()
        assert r["training_iteration"] == 1
        # 8 async updates x 2 envs x 64 steps
        assert r["num_env_steps_sampled_lifetime"] == 8 * 2 * 64
        assert np.isfinite(r["policy_loss"]) and np.isfinite(r["vf_loss"])
        # off-policyness is bounded: mean importance ratio stays near 1
        assert 0.5 < r["mean_rho"] < 2.0
        first = last = r["episode_return_mean"] if r["num_episodes"] else None
        for _ in range(11):
            r = algo.train()
            if first is None and r["num_episodes"] > 0:
                first = r["episode_return_mean"]
            if r["num_episodes"] > 0:
                last = r["episode_return_mean"]
        assert first is not None and last is not None
        assert last > first + 20, (first, last)

        path = algo.save(str(tmp_path / "ck"))
        it = algo.iteration
        algo.train()
        algo.restore(path)
        assert algo.iteration == it
    finally:
        algo.stop()


def test_appo_learns_cartpole(rt):
    """Async clipped-surrogate convergence on the IMPALA actor-learner
    machinery (reference: tests/test_rllib.py:271)."""
    from ray_tpu_torch.rllib import APPOConfig

    a = (
        APPOConfig()
        .environment("CartPole-v1")
        .env_runners(num_env_runners=2, num_envs_per_env_runner=4,
                     rollout_fragment_length=64)
        .training(lr=3e-3, updates_per_iteration=8, entropy_coeff=0.01, device="cpu")
        .debugging(seed=5)
        .build_algo()
    )
    try:
        first = last = None
        for _ in range(10):
            r = a.train()
            if r["num_episodes"] > 0:
                if first is None:
                    first = r["episode_return_mean"]
                last = r["episode_return_mean"]
        assert first is not None and last is not None
        assert last > first + 40, (first, last)
        assert a.compute_single_action([0.0, 0.0, 0.0, 0.0]) in (0, 1)
    finally:
        a.stop()


def test_dqn_learns_cartpole(rt):
    """Off-policy replay + target-network convergence (reference:
    tests/test_rllib.py:143), from the reference's own initial Q-net
    (``PRNGKey(7)``, carried over with ``params_from_numpy``): the runners'
    and the buffer's numpy streams are the reference's too, so the run
    follows the reference's. The +20 bar at this budget is seed-sensitive
    in both packages, and the port's own seed-7 init learns and then falls
    back (ROADMAP.md Queue C)."""
    from ray_tpu.rllib import dqn as jdqn
    from ray_tpu_torch.rllib import DQNConfig

    a = (
        DQNConfig()
        .environment("CartPole-v1")
        .training(lr=5e-4, updates_per_iteration=16, train_intensity=8,
                  num_steps_sampled_before_learning_starts=500,
                  epsilon_decay_steps=6000, target_network_update_freq=100,
                  device="cpu")
        .debugging(seed=7)
        .build_algo()
    )
    init = jdqn._init_q_net(jax.random.PRNGKey(7), jcore.MLPSpec(4, 2, (64, 64)))
    a.params = tcore.params_from_numpy(jax.tree.map(np.asarray, init), "cpu")
    a.target_params = tcore.tree_map(torch.clone, a.params)
    a.opt_state = a.optimizer.init(a.params)
    try:
        first = last = None
        for _ in range(21):
            r = a.train()
            if first is None and r["num_episodes"] > 0:
                first = r["episode_return_mean"]
            if r["num_episodes"] > 0:
                last = r["episode_return_mean"]
        assert first is not None and last is not None
        assert last > first + 20, (first, last)
        assert a.compute_single_action([0.0, 0.0, 0.0, 0.0]) in (0, 1)
    finally:
        a.stop()


def test_replay_buffer_ring_and_sampling():
    from ray_tpu_torch.rllib import ReplayBuffer

    buf = ReplayBuffer(capacity=100, seed=0)
    buf.add({"x": np.arange(60, dtype=np.int64)})
    assert len(buf) == 60
    buf.add({"x": np.arange(60, 130, dtype=np.int64)})  # wraps: keeps last 100
    assert len(buf) == 100
    sample = buf.sample(500)["x"]
    # oldest 30 entries were overwritten by the ring
    assert sample.min() >= 30 and sample.max() <= 129


def test_prioritized_replay_prefers_high_td():
    from ray_tpu_torch.rllib import PrioritizedReplayBuffer

    buf = PrioritizedReplayBuffer(capacity=64, alpha=1.0, seed=0)
    buf.add({"x": np.arange(64, dtype=np.int64)})
    s = buf.sample(32)
    td = np.where(s["x"] == s["x"][0], 10.0, 0.0)  # one item very surprising
    buf.update_priorities(td)
    hot = int(s["x"][0])
    counts = sum(
        int((buf.sample(64)["x"] == hot).sum()) for _ in range(20)
    )
    assert counts > 150, counts
    assert "weights" in s and s["weights"].max() <= 1.0


def test_bc_offline_from_dataset(rt):
    """Behavior cloning from a ray_tpu_torch.data Dataset, each batch
    staged on the learner's device by iter_batches (reference:
    tests/test_rllib.py:207)."""
    import ray_tpu_torch.data as rdata
    from ray_tpu_torch.rllib import BCConfig

    # expert policy: action = 1 iff obs[0] + obs[1] > 0
    rng = np.random.default_rng(0)
    obs = rng.normal(size=(2000, 4)).astype(np.float32)
    actions = (obs[:, 0] + obs[:, 1] > 0).astype(np.int64)
    ds = rdata.from_items(
        [{"obs": o, "actions": a} for o, a in zip(obs, actions)]
    )
    algo = BCConfig().training(lr=3e-3, device="cpu").build_algo(obs_dim=4, num_actions=2)
    result = algo.train_on_dataset(ds, epochs=25)
    assert result["num_samples_trained"] == 25 * 2000
    assert result["loss"] < 0.25
    test_obs = rng.normal(size=(200, 4)).astype(np.float32)
    preds = np.array([algo.compute_single_action(o) for o in test_obs])
    truth = (test_obs[:, 0] + test_obs[:, 1] > 0).astype(np.int64)
    assert (preds == truth).mean() > 0.9


def test_marwil_prefers_high_return_actions(rt):
    """MARWIL re-weights imitation by advantage: BC (beta=0) stays
    ambivalent on a 50/50 dataset while MARWIL clones the paying action
    (reference: tests/test_rllib.py:300)."""
    import ray_tpu_torch.data as rd
    from ray_tpu_torch.rllib import MARWILConfig

    rng = np.random.default_rng(0)
    rows = []
    for _ in range(600):
        obs = rng.normal(size=4).astype(np.float32)
        rows.append({"obs": obs, "actions": 0, "returns": 0.0})
        rows.append({"obs": obs, "actions": 1, "returns": 1.0})
    ds = rd.from_items(rows)

    def action_rate(algo):
        test_obs = rng.normal(size=(64, 4)).astype(np.float32)
        return float(
            np.mean([algo.compute_single_action(o) for o in test_obs])
        )

    marwil = MARWILConfig().training(beta=8.0, lr=5e-3, device="cpu").build_algo(4, 2)
    for _ in range(6):
        r = marwil.train_on_dataset(ds, epochs=1)
    assert r["num_samples_trained"] == 1200
    assert action_rate(marwil) > 0.85, "MARWIL should pick the paying action"

    bc_like = MARWILConfig().training(beta=0.0, lr=5e-3, device="cpu").build_algo(4, 2)
    for _ in range(6):
        bc_like.train_on_dataset(ds, epochs=1)
    test_obs = rng.normal(size=(64, 4)).astype(np.float32)
    logits, _ = tcore.forward(bc_like.params, torch.from_numpy(test_obs))
    probs = torch.softmax(logits, -1)[:, 1].detach().numpy()
    assert float(np.mean(np.abs(probs - 0.5))) < 0.15


def test_cql_offline_beats_behavior_policy(rt):
    """Conservative Q-learning from RANDOM-policy CartPole transitions
    gives a far better-than-random greedy policy (reference:
    tests/test_rllib.py:348)."""
    import gymnasium as gym

    import ray_tpu_torch.data as rdata
    from ray_tpu_torch.rllib import CQLConfig

    env = gym.make("CartPole-v1")
    rng = np.random.default_rng(0)
    rows = []
    obs, _ = env.reset(seed=0)
    for _ in range(8000):
        a = int(rng.integers(0, 2))
        nobs, r, term, trunc, _ = env.step(a)
        rows.append({
            "obs": np.asarray(obs, np.float32), "actions": a,
            "rewards": float(r), "next_obs": np.asarray(nobs, np.float32),
            "dones": float(term),
        })
        obs = nobs if not (term or trunc) else env.reset()[0]
    ds = rdata.from_items(rows)

    algo = CQLConfig().training(lr=5e-4, cql_alpha=1.0, device="cpu").build_algo(4, 2)
    assert algo.stage_dataset(ds) == 8000
    for _ in range(3):
        m = algo.train(num_updates=500)
    assert np.isfinite(m["loss"]) and m["cql_penalty"] > 0

    returns = []
    for i in range(5):
        o, _ = env.reset(seed=100 + i)
        total = 0.0
        for _ in range(300):
            o, r, term, trunc, _ = env.step(algo.compute_single_action(o))
            total += r
            if term or trunc:
                break
        returns.append(total)
    # random behavior policy scores ~25; offline CQL must far exceed it
    assert float(np.mean(returns)) > 80, returns


@pytest.mark.slow  # the reference's Pendulum convergence run is slow too
def test_sac_learns_pendulum(rt):
    """Continuous-control convergence: twin-critic max-entropy SAC on
    Pendulum (reference: tests/test_rllib.py:230). The fast stand-in is
    test_sac_update_matches_jax_given_the_noise."""
    from ray_tpu_torch.rllib import SACConfig

    a = (
        SACConfig()
        .environment("Pendulum-v1")
        .env_runners(num_env_runners=2, num_envs_per_env_runner=2,
                     rollout_fragment_length=16)
        .training(train_batch_size=128, updates_per_iteration=8,
                  train_intensity=64, hiddens=(128, 128),
                  num_steps_sampled_before_learning_starts=500, device="cpu")
        .debugging(seed=3)
        .build_algo()
    )
    try:
        first = last = None
        for _ in range(16):
            r = a.train()
            if r["num_episodes"] > 0:
                if first is None:
                    first = r["episode_return_mean"]
                last = r["episode_return_mean"]
        assert first is not None and last is not None
        assert last > first + 350, (first, last)
        assert last > -1050, (first, last)
        assert float(a.log_alpha) < 0.0
        act = a.compute_single_action(np.zeros(3, np.float32))
        assert act.shape == (1,) and -2.0 <= float(act[0]) <= 2.0
    finally:
        a.stop()
