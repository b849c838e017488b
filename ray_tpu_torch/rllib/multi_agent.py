"""Multi-agent RL: env API, episodes, env runner, and PPO learner.

Port of ``ray_tpu/rllib/multi_agent.py``: the env API, episodes and
runner bookkeeping are the reference's (numpy); the runner's inference
runs ``sample_actions`` on CPU tensors, and each module's learner update
on the driver's device (the GPU unless ``device="cpu"``).

Parity: python/ray/rllib/env/multi_agent_env.py (MultiAgentEnv,
make_multi_agent), multi_agent_episode.py (per-agent trajectories with
an env-step clock), multi_agent_env_runner.py (per-module batched
inference over the currently-acting agents), and the
policies/policy_mapping_fn surface of algorithm_config.multi_agent().

Design, as in the JAX package:
- Inference batches across envs AND agents per module, so each module
  does ONE forward per env step regardless of agent count.
- The learner consumes variable-length per-agent sequences by computing
  GAE host-side (numpy) and padding the flat per-module batch to a
  fixed bucket with a loss mask, so the update's shapes are the
  bucket's.
"""

from __future__ import annotations

import math
from collections import deque
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

__all__ = [
    "MultiAgentEnv",
    "make_multi_agent",
    "MultiAgentEpisode",
    "MultiAgentEnvRunner",
    "MultiAgentAlgorithm",
]


class MultiAgentEnv:
    """An environment hosting multiple independently-acting agents.

    Parity: rllib/env/multi_agent_env.py:29. Agents are string ids;
    `step` takes/returns per-agent dicts; the reserved "__all__" key in
    the terminated/truncated dicts signals episode end. Agents may act
    intermittently (turn-based envs simply omit non-acting agents from
    the obs dict).
    """

    # All agents that may ever appear; fixed for the env's lifetime.
    possible_agents: List[str] = []
    # Agents currently active (may change during an episode).
    agents: List[str] = []
    observation_spaces: Optional[Dict[str, Any]] = None
    action_spaces: Optional[Dict[str, Any]] = None

    def get_observation_space(self, agent_id: str):
        return (self.observation_spaces or {})[agent_id]

    def get_action_space(self, agent_id: str):
        return (self.action_spaces or {})[agent_id]

    def reset(self, *, seed: Optional[int] = None, options: Optional[dict] = None
              ) -> Tuple[Dict[str, Any], Dict[str, Any]]:
        raise NotImplementedError

    def step(self, action_dict: Dict[str, Any]) -> Tuple[
        Dict[str, Any], Dict[str, float], Dict[str, bool],
        Dict[str, bool], Dict[str, Any],
    ]:
        raise NotImplementedError

    def close(self) -> None:
        pass


def make_multi_agent(env_name_or_creator) -> type:
    """Wrap a single-agent gym env into an N-agent MultiAgentEnv of
    independent copies (reference: multi_agent_env.py make_multi_agent —
    the standard multi-agent CartPole test env). Config: {"num_agents"}.
    """

    class IndependentMultiAgent(MultiAgentEnv):
        def __init__(self, config: Optional[dict] = None):
            import gymnasium as gym

            config = config or {}
            n = int(config.get("num_agents", 2))
            if isinstance(env_name_or_creator, str):
                self.envs = [gym.make(env_name_or_creator) for _ in range(n)]
            else:
                self.envs = [env_name_or_creator(config) for _ in range(n)]
            self.possible_agents = [f"agent_{i}" for i in range(n)]
            self.agents = list(self.possible_agents)
            self.observation_spaces = {
                a: e.observation_space
                for a, e in zip(self.possible_agents, self.envs)
            }
            self.action_spaces = {
                a: e.action_space
                for a, e in zip(self.possible_agents, self.envs)
            }
            self._done: Dict[str, bool] = {}

        def reset(self, *, seed=None, options=None):
            self.agents = list(self.possible_agents)
            self._done = {a: False for a in self.possible_agents}
            obs, infos = {}, {}
            for i, (a, e) in enumerate(zip(self.possible_agents, self.envs)):
                o, inf = e.reset(seed=None if seed is None else seed + i,
                                 options=options)
                obs[a], infos[a] = o, inf
            return obs, infos

        def step(self, action_dict):
            obs, rew, term, trunc, infos = {}, {}, {}, {}, {}
            for a, act in action_dict.items():
                if self._done.get(a):
                    continue
                e = self.envs[self.possible_agents.index(a)]
                o, r, te, tr, inf = e.step(act)
                obs[a], rew[a] = o, float(r)
                term[a], trunc[a], infos[a] = bool(te), bool(tr), inf
                if te or tr:
                    self._done[a] = True
            self.agents = [a for a in self.possible_agents if not self._done[a]]
            term["__all__"] = all(self._done.values())
            trunc["__all__"] = False
            return obs, rew, term, trunc, infos

        def close(self):
            for e in self.envs:
                e.close()

    return IndependentMultiAgent


class _AgentTrack:
    """Per-agent trajectory inside one MultiAgentEpisode fragment."""

    __slots__ = ("obs", "proc_obs", "actions", "rewards", "logp", "values",
                 "terminated", "truncated", "ep_return")

    def __init__(self):
        self.obs: List[np.ndarray] = []
        # what the MODULE saw (post env→module connectors) — the
        # learner must train on these, not the raw env obs
        self.proc_obs: List[np.ndarray] = []
        self.actions: List[int] = []
        self.rewards: List[float] = []
        self.logp: List[float] = []
        self.values: List[float] = []
        self.terminated = False
        self.truncated = False
        self.ep_return = 0.0


class MultiAgentEpisode:
    """Per-agent trajectories sharing one env-step clock.

    Parity: rllib/env/multi_agent_episode.py (the essentials: per-agent
    obs/action/reward columns, agents_to_act from the latest obs dict,
    per-agent terminations plus "__all__", and cut() for fragment
    continuation). Rewards arriving for a non-acting agent accumulate
    onto its last action, as in the reference's agent-step mapping.
    """

    def __init__(self, agent_to_module: Callable[[str], str]):
        self._agent_to_module = agent_to_module
        self.tracks: Dict[str, _AgentTrack] = {}
        self.module_of: Dict[str, str] = {}
        self.agents_to_act: List[str] = []
        self.env_t = 0
        self.is_done = False

    def module_for(self, agent_id: str) -> str:
        m = self.module_of.get(agent_id)
        if m is None:
            m = self.module_of[agent_id] = self._agent_to_module(agent_id)
        return m

    def _track(self, agent_id: str) -> _AgentTrack:
        t = self.tracks.get(agent_id)
        if t is None:
            t = self.tracks[agent_id] = _AgentTrack()
        return t

    def add_env_reset(self, obs: Dict[str, Any], infos: Dict[str, Any]):
        for a, o in obs.items():
            self._track(a).obs.append(np.asarray(o, np.float32).reshape(-1))
        self.agents_to_act = list(obs.keys())

    def add_action(self, agent_id: str, action: int, logp: float,
                   value: float, proc_obs: Optional[np.ndarray] = None):
        t = self.tracks[agent_id]
        if proc_obs is None:
            proc_obs = t.obs[len(t.actions)]
        t.proc_obs.append(np.asarray(proc_obs, np.float32))
        t.actions.append(int(action))
        t.logp.append(float(logp))
        t.values.append(float(value))
        t.rewards.append(0.0)

    def add_env_step(self, obs, rewards, terms, truncs, infos):
        self.env_t += 1
        for a, r in rewards.items():
            t = self._track(a)
            if t.rewards:
                t.rewards[-1] += float(r)
            t.ep_return += float(r)
        for a, o in obs.items():
            t = self._track(a)
            if not (t.terminated or t.truncated):
                t.obs.append(np.asarray(o, np.float32).reshape(-1))
        all_done = terms.get("__all__", False) or truncs.get("__all__", False)
        for a, t in self.tracks.items():
            if terms.get(a) or (all_done and terms.get("__all__", False)):
                t.terminated = True
            elif truncs.get(a) or all_done:
                t.truncated = True
        self.is_done = all_done
        self.agents_to_act = [
            a for a in obs
            if not (self.tracks[a].terminated or self.tracks[a].truncated)
        ]

    def total_return(self) -> float:
        return sum(t.ep_return for t in self.tracks.values())

    def extract_sequences(self) -> Dict[str, List[dict]]:
        """Per-module list of per-agent sequence dicts for the learner.
        A sequence bootstraps from its final obs unless terminated."""
        out: Dict[str, List[dict]] = {}
        for a, t in self.tracks.items():
            n = len(t.actions)
            if n == 0:
                continue
            final_obs = t.obs[n] if len(t.obs) > n else None
            seq = {
                "obs": np.stack(t.proc_obs[:n]),
                "actions": np.asarray(t.actions, np.int64),
                "rewards": np.asarray(t.rewards, np.float32),
                "logp": np.asarray(t.logp, np.float32),
                "values": np.asarray(t.values, np.float32),
                "terminated": t.terminated,
                "final_obs": final_obs,
                "agent_id": a,
            }
            out.setdefault(self.module_for(a), []).append(seq)
        return out

    def cut(self) -> "MultiAgentEpisode":
        """Continuation episode carrying live agents' last obs (the
        reference's MultiAgentEpisode.cut): trajectory buffers reset,
        episode-return accounting carries over."""
        nxt = MultiAgentEpisode(self._agent_to_module)
        nxt.env_t = self.env_t
        nxt.module_of = dict(self.module_of)
        for a, t in self.tracks.items():
            if t.terminated or t.truncated:
                continue
            n = len(t.actions)
            if len(t.obs) > n:
                nt = nxt._track(a)
                nt.obs.append(t.obs[n])
                nt.ep_return = t.ep_return
        nxt.agents_to_act = [
            a for a in self.agents_to_act if a in nxt.tracks
        ]
        return nxt


class MultiAgentEnvRunner:
    """Rollout actor for MultiAgentEnv (reference:
    multi_agent_env_runner.py:61). Owns num_envs env copies; each env
    step groups the currently-acting agents of ALL envs by module and
    runs one forward per module, on the CPU."""

    def __init__(
        self,
        env_creator,
        policy_mapping_fn: Optional[Callable[[str, Any], str]] = None,
        env_config: Optional[dict] = None,
        num_envs: int = 1,
        seed: Optional[int] = None,
        rollout_fragment_length: int = 128,
        env_to_module_connector: Optional[Callable] = None,
    ):
        if isinstance(env_creator, str):
            raise ValueError(
                "multi-agent env must be a MultiAgentEnv subclass or "
                "callable(config) -> MultiAgentEnv"
            )
        mk = (env_creator if not isinstance(env_creator, type)
              else (lambda cfg: env_creator(cfg)))
        self.envs = [mk(env_config or {}) for _ in range(num_envs)]
        self.num_envs = num_envs
        self.fragment = rollout_fragment_length
        self._mapping = policy_mapping_fn or (lambda aid, ep=None: "default_policy")
        self.seed = seed
        self._ep_seed = 0 if seed is None else seed
        self.episodes: List[Optional[MultiAgentEpisode]] = [None] * num_envs
        # bounded: only the trailing window is ever reported, and a
        # plain list leaks for the runner's lifetime (GL005)
        self.completed_returns: deque = deque(maxlen=100)
        self._needs_reset = True
        # per-module env→module connector pipelines (reference:
        # config.env_to_module_connector building ConnectorV2 stacks)
        self._conn_builder = env_to_module_connector
        self._conns: Dict[str, Any] = {}

    def _connector(self, module_id: str):
        if self._conn_builder is None:
            return None
        conn = self._conns.get(module_id)
        if conn is None:
            conn = self._conns[module_id] = self._conn_builder()
        return conn

    # ---- space discovery (driver builds module specs from this)
    def module_specs(self) -> Dict[str, Tuple[int, int]]:
        env = self.envs[0]
        specs: Dict[str, Tuple[int, int]] = {}
        for a in env.possible_agents:
            m = self._mapping(a, None)
            dim = int(np.prod(env.get_observation_space(a).shape))
            conn = self._connector(m)
            if conn is not None:
                dim = int(conn.output_dim(dim))
            n_act = int(env.get_action_space(a).n)
            prev = specs.get(m)
            if prev is not None and prev != (dim, n_act):
                raise ValueError(
                    f"module {m!r} maps agents with mismatched spaces: "
                    f"{prev} vs {(dim, n_act)}"
                )
            specs[m] = (dim, n_act)
        return specs

    def _reset_env(self, i: int):
        ep = MultiAgentEpisode(lambda aid: self._mapping(aid, None))
        self._ep_seed += 1
        obs, infos = self.envs[i].reset(seed=self._ep_seed * 10007)
        ep.add_env_reset(obs, infos)
        self.episodes[i] = ep
        return ep

    def _emit_sequences(self, env_i: int, ep: MultiAgentEpisode,
                        sequences: Dict[str, List[dict]]) -> None:
        """Collect a (finished or cut) episode's sequences, running
        bootstrap obs through the connectors in peek mode (state must
        not advance — the same obs re-enters the pipeline as the next
        fragment's first inference input)."""
        for mid, seqs in ep.extract_sequences().items():
            conn = self._connector(mid)
            if conn is not None:
                for s in seqs:
                    if s["final_obs"] is not None:
                        s["final_obs"] = conn(
                            {"obs": np.asarray(s["final_obs"])[None]},
                            keys=[(env_i, s["agent_id"])],
                            module_id=mid,
                            peek=True,
                        )["obs"][0]
            sequences.setdefault(mid, []).extend(seqs)

    def sample(self, params_by_module: Dict[str, Any], rng_seed: int
               ) -> Dict[str, Any]:
        """Collect one fragment. Returns {"sequences": {module: [seq]},
        "episode_returns": [...], "env_steps": int}."""
        import torch

        from .core import params_from_numpy, sample_actions

        params_by_module = {m: params_from_numpy(p, "cpu")
                            for m, p in params_by_module.items()}
        gen = torch.Generator().manual_seed(rng_seed)
        if self._needs_reset:
            for i in range(self.num_envs):
                self._reset_env(i)
            self._needs_reset = False
        sequences: Dict[str, List[dict]] = {}
        env_steps = 0
        for _t in range(self.fragment):
            # group (env_idx, agent) by module over all envs
            by_module: Dict[str, List[Tuple[int, str, np.ndarray]]] = {}
            for i, ep in enumerate(self.episodes):
                for a in ep.agents_to_act:
                    tr = ep.tracks[a]
                    by_module.setdefault(ep.module_for(a), []).append(
                        (i, a, tr.obs[len(tr.actions)])
                    )
            actions_for_env: List[Dict[str, int]] = [
                {} for _ in range(self.num_envs)
            ]
            for mid, items in by_module.items():
                obs_batch = np.stack([o for _, _, o in items])
                conn = self._connector(mid)
                if conn is not None:
                    obs_batch = conn(
                        {"obs": obs_batch},
                        keys=[(i, a) for i, a, _ in items],
                        module_id=mid,
                    )["obs"]
                acts, logp, vals = sample_actions(
                    params_by_module[mid],
                    torch.as_tensor(np.asarray(obs_batch, np.float32)), gen
                )
                acts = acts.numpy()
                logp = logp.numpy()
                vals = vals.numpy()
                for j, (i, a, _) in enumerate(items):
                    self.episodes[i].add_action(
                        a, acts[j], logp[j], vals[j],
                        proc_obs=obs_batch[j],
                    )
                    actions_for_env[i][a] = int(acts[j])
            for i, ep in enumerate(self.episodes):
                if not actions_for_env[i]:
                    continue
                obs, rew, term, trunc, infos = self.envs[i].step(
                    actions_for_env[i]
                )
                env_steps += 1
                ep.add_env_step(obs, rew, term, trunc, infos)
                if ep.is_done:
                    self.completed_returns.append(ep.total_return())
                    self._emit_sequences(i, ep, sequences)
                    if self._conns:
                        done_keys = [(i, a) for a in ep.tracks]
                        for conn in self._conns.values():
                            conn.drop(done_keys)
                    self._reset_env(i)
        # fragment cut: emit partial sequences, carry live episodes over
        # (connector state persists — the episodes continue)
        for i, ep in enumerate(self.episodes):
            self._emit_sequences(i, ep, sequences)
            self.episodes[i] = ep.cut()
        return {
            "sequences": sequences,
            "episode_returns": np.asarray(
                list(self.completed_returns), np.float32
            ),
            "env_steps": env_steps,
        }


# ------------------------------------------------------------- learner
def make_flat_ppo_update(config, spec, bucket: int):
    """Clipped-surrogate update over a FLAT padded batch {obs (B,D),
    actions, logp_old, advantages, value_targets, mask (B,)} with B ==
    bucket: ``update(params, opt_state, flat, perms)``, each epoch's
    minibatches cut in the order of ``perms[epoch]`` ((num_epochs,
    bucket)). Mask zeroes padded rows out of every mean, so one update
    serves any real batch size <= bucket."""
    import torch

    from .core import adam, device_of, forward, to_tensors
    from .ppo import ppo_loss_terms, run_minibatch_epochs

    optimizer = adam(config.lr, config.grad_clip)

    def masked_mean(x, m):
        return torch.sum(x * m) / torch.clamp(torch.sum(m), min=1.0)

    def loss_fn(params, batch):
        logits, values = forward(params, batch["obs"])
        surr, vf, ent = ppo_loss_terms(config, logits, values, batch)
        m = batch["mask"]
        pi_loss = -masked_mean(surr, m)
        vf_loss = masked_mean(vf, m)
        entropy = masked_mean(ent, m)
        total = (
            pi_loss
            + config.vf_loss_coeff * vf_loss
            - config.entropy_coeff * entropy
        )
        return total, {
            "policy_loss": pi_loss, "vf_loss": vf_loss, "entropy": entropy,
        }

    mb = min(config.minibatch_size, bucket)

    def update(params, opt_state, flat, perms):
        flat = to_tensors(flat, device_of(params))
        return run_minibatch_epochs(loss_fn, optimizer, params, opt_state, flat, perms, mb)

    return optimizer, update


def _gae_flat(seqs: List[dict], bootstrap: np.ndarray, gamma: float,
              lam: float) -> Dict[str, np.ndarray]:
    """Host-side GAE over variable-length sequences -> one flat batch."""
    obs, actions, logp, advs, vtargs = [], [], [], [], []
    for s, bv in zip(seqs, bootstrap):
        r, v = s["rewards"], s["values"]
        n = len(r)
        adv = np.zeros(n, np.float32)
        next_adv = 0.0
        next_v = 0.0 if s["terminated"] else float(bv)
        for t in range(n - 1, -1, -1):
            delta = r[t] + gamma * next_v - v[t]
            adv[t] = delta + gamma * lam * next_adv
            next_adv = adv[t]
            next_v = v[t]
        obs.append(s["obs"])
        actions.append(s["actions"])
        logp.append(s["logp"])
        advs.append(adv)
        vtargs.append(adv + v)
    return {
        "obs": np.concatenate(obs),
        "actions": np.concatenate(actions),
        "logp_old": np.concatenate(logp),
        "advantages": np.concatenate(advs),
        "value_targets": np.concatenate(vtargs),
    }


class MultiAgentAlgorithm:
    """PPO training driver over a MultiAgentEnv (reference:
    algorithm.py training_step with a MultiRLModule): one params tree
    and optimizer state per module, rollouts fanned out to
    MultiAgentEnvRunner actors, and one masked flat update per module
    per iteration."""

    def __init__(self, config):
        import torch

        import ray_tpu_torch

        from .._private.device import resolve_device
        from .core import MLPSpec, init_mlp_module

        if config.env is None:
            raise ValueError("config.environment(env) is required")
        self.device = resolve_device(config.device)
        if not ray_tpu_torch.is_initialized():
            ray_tpu_torch.init(ignore_reinit_error=True)
        self.config = config
        runner_cls = ray_tpu_torch.remote(MultiAgentEnvRunner)
        self.env_runners = [
            runner_cls.remote(
                config.env,
                config.policy_mapping_fn,
                config.env_config,
                config.num_envs_per_env_runner,
                config.seed + 1000 * i,
                config.rollout_fragment_length,
                getattr(config, "env_to_module_connector", None),
            )
            for i in range(config.num_env_runners)
        ]
        specs = ray_tpu_torch.get(self.env_runners[0].module_specs.remote())
        if config.policies:
            missing = set(config.policies) - set(specs)
            if missing:
                raise ValueError(
                    f"policies {sorted(missing)} are never produced by "
                    f"policy_mapping_fn (got {sorted(specs)})"
                )
        self.module_specs = {
            m: MLPSpec(dim, n_act, tuple(config.hiddens))
            for m, (dim, n_act) in specs.items()
        }
        gen = torch.Generator().manual_seed(config.seed)
        self.params: Dict[str, Any] = {}
        self.opt_states: Dict[str, Any] = {}
        self._optimizers: Dict[str, Any] = {}
        for m, spec in sorted(self.module_specs.items()):
            self.params[m] = init_mlp_module(gen, spec, self.device)
        # the minibatch permutations' generator (the reference's rng key)
        self._gen = torch.Generator().manual_seed(config.seed + 1)
        self.iteration = 0
        self._timesteps = 0

    def _bucket(self, n: int) -> int:
        mb = self.config.minibatch_size
        unit = max(mb, 256)
        return max(unit, int(math.ceil(n / unit)) * unit)

    def train(self) -> Dict[str, Any]:
        import torch

        import ray_tpu_torch

        from .core import params_to_numpy, values_only

        host_params = {m: params_to_numpy(p) for m, p in self.params.items()}
        rollouts = ray_tpu_torch.get([
            r.sample.remote(
                host_params, self.config.seed + self.iteration * 97 + i
            )
            for i, r in enumerate(self.env_runners)
        ])
        result: Dict[str, Any] = {}
        metrics_by_module: Dict[str, Dict[str, float]] = {}
        for mid, spec in self.module_specs.items():
            seqs = [
                s for ro in rollouts
                for s in ro["sequences"].get(mid, [])
            ]
            if not seqs:
                continue
            # bootstrap values for non-terminated sequences in one
            # batch
            boot = np.zeros(len(seqs), np.float32)
            need = [
                (i, s["final_obs"]) for i, s in enumerate(seqs)
                if not s["terminated"] and s["final_obs"] is not None
            ]
            if need:
                fo = np.stack([o for _, o in need])
                v = values_only(self.params[mid], torch.as_tensor(
                    fo, device=self.device)).cpu().numpy()
                for (i, _), vi in zip(need, v):
                    boot[i] = vi
            flat = _gae_flat(
                seqs, boot, self.config.gamma, self.config.lambda_
            )
            learner_conn = getattr(self.config, "learner_connector", None)
            if learner_conn is not None:
                # learner-side ConnectorV2 stage (reference:
                # connectors/learner/) — transforms the flat batch
                # before it enters the update
                flat = learner_conn(flat, module_id=mid)
            n = len(flat["actions"])
            a = flat["advantages"]
            flat["advantages"] = (a - a.mean()) / (a.std() + 1e-8)
            bucket = self._bucket(n)
            mask = np.zeros(bucket, np.float32)
            mask[:n] = 1.0
            padded = {
                k: np.concatenate(
                    [v, np.zeros((bucket - n,) + v.shape[1:], v.dtype)]
                )
                for k, v in flat.items()
            }
            padded["mask"] = mask
            optimizer, update = make_flat_ppo_update(
                self.config, spec, bucket
            )
            if mid not in self.opt_states:
                self._optimizers[mid] = optimizer
                self.opt_states[mid] = optimizer.init(self.params[mid])
            perms = torch.stack([torch.randperm(bucket, generator=self._gen)
                                 for _ in range(self.config.num_epochs)])
            self.params[mid], self.opt_states[mid], metrics = update(
                self.params[mid], self.opt_states[mid], padded, perms
            )
            metrics_by_module[mid] = {
                k: float(v) for k, v in metrics.items()
            }
            self._timesteps += n
        self.iteration += 1
        ep_returns = np.concatenate(
            [ro["episode_returns"] for ro in rollouts]
        )
        result.update({
            "training_iteration": self.iteration,
            "num_env_steps_sampled_lifetime": self._timesteps,
            "episode_return_mean": (
                float(ep_returns.mean()) if len(ep_returns) else float("nan")
            ),
            "num_episodes": int(len(ep_returns)),
            "learner": metrics_by_module,
        })
        return result

    def compute_single_action(self, obs, policy_id: str = "default_policy") -> int:
        import torch

        from .core import forward

        with torch.no_grad():
            logits, _ = forward(
                self.params[policy_id],
                torch.as_tensor(np.asarray(obs, np.float32), device=self.device).reshape(1, -1),
            )
        return int(torch.argmax(logits[0]))

    def save(self, checkpoint_dir: str) -> str:
        import os
        import pickle

        from .core import params_to_numpy

        os.makedirs(checkpoint_dir, exist_ok=True)
        state = {
            "params": {m: params_to_numpy(p) for m, p in self.params.items()},
            "opt_states": {m: params_to_numpy(s) for m, s in self.opt_states.items()},
            "iteration": self.iteration,
            "timesteps": self._timesteps,
        }
        with open(os.path.join(checkpoint_dir, "algorithm_state.pkl"), "wb") as f:
            pickle.dump(state, f)
        return checkpoint_dir

    def restore(self, checkpoint_dir: str) -> None:
        import os
        import pickle

        from .core import params_from_numpy

        with open(os.path.join(checkpoint_dir, "algorithm_state.pkl"), "rb") as f:
            state = pickle.load(f)
        self.params = {m: params_from_numpy(p, self.device)
                       for m, p in state["params"].items()}
        self.opt_states = {m: params_from_numpy(s, self.device)
                           for m, s in state["opt_states"].items()}
        self.iteration = state["iteration"]
        self._timesteps = state["timesteps"]

    def stop(self) -> None:
        import ray_tpu_torch

        for r in self.env_runners:
            try:
                ray_tpu_torch.kill(r)
            except Exception:
                pass
        self.env_runners = []
