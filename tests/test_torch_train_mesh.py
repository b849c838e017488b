"""Sharded train steps of the port (``ray_tpu_torch.parallel`` over a mesh
of gloo ranks on the CPU) against the JAX package's sharded steps on a
sub-mesh of the same shape of the 8 host devices, and against the port's
one-device step, from the same parameters (the JAX package's, through a
``.npz``) and the same seeded numpy batches.

Cases: Llama at (fsdp 2, model 2); at (seq 2, model 2) with
``attention_impl="ring"`` (the JAX side under ``set_mesh``); at (data 2,
fsdp 2) with the flash attention and fused CE paths on the port (their
plain versions on the CPU) against the JAX package's einsum paths; MoE
Llama at expert 2 and at (data 2, expert 2); ViT at (fsdp 2, model 2).
Then a two-worker gloo ``TorchTrainer`` with ``TorchConfig(mesh_shape=
{"fsdp": 2})``, whose loop calls ``make_mesh()`` with no arguments,
against a ``JaxTrainer`` on the same ``.npz``.

Tolerances: f32 losses and grad norms rtol 1e-5, and parameters atol 1e-5
after the steps, as the one-device parity (test_torch_train_step.py): the
sums across shards run in another order than one device's, which moves
them by a few ulps, well inside these. Every rank reports the same loss
and norm bit for bit (they are all-reduced).

Ranks are processes started by ``tests/torch_mesh_ranks.py`` on a
``FileStore``, each join and wait bounded: one launch for each world size
runs every case of that size.
"""

import dataclasses
import math
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ray_tpu
import ray_tpu_torch
import torch_mesh_ranks as ranks
from ray_tpu import parallel as jpar
from ray_tpu.llm import save_params_npz
from ray_tpu.models import llama as jl
from ray_tpu.models import moe_llama as jm
from ray_tpu.models import vit as jv
from ray_tpu_torch import parallel as tpar
from ray_tpu_torch.models import convert, params_from_numpy
from ray_tpu_torch.models import llama as tl
from ray_tpu_torch.models import moe_llama as tm
from ray_tpu_torch.models import vit as tv

RTOL = 1e-5
PARAM_ATOL = 1e-5
STEPS = 2

FAMILIES = {"llama": (jl, jl.LLAMA_TINY, tl, tl.LLAMA_TINY),
            "moe": (jm, jm.MOE_TINY, tm, tm.MOE_TINY),
            "vit": (jv, jv.VIT_TINY, tv, tv.VIT_TINY)}

CASES = [
    ("llama", {"fsdp": 2, "model": 2}, {}, {}),
    ("llama", {"seq": 2, "model": 2}, {"attention_impl": "ring"}, {"attention_impl": "ring"}),
    ("llama", {"data": 2, "fsdp": 2}, {}, {"attention_impl": "flash", "ce_impl": "fused"}),
    ("moe", {"expert": 2}, {}, {}),
    ("moe", {"data": 2, "expert": 2}, {}, {}),
    ("vit", {"fsdp": 2, "model": 2}, {}, {}),
]


def _batches(family, cfg, rng):
    """STEPS seeded batches; rows divide by every case's data split."""
    if family == "vit":
        return [{"image": rng.standard_normal((4, 32, 32, 3)).astype(np.float32),
                 "label": rng.integers(0, cfg.num_classes, (4,)).astype(np.int32)}
                for _ in range(STEPS)]
    return [{"tokens": rng.integers(0, cfg.vocab_size, (8, 65)).astype(np.int32)}
            for _ in range(STEPS)]


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = np.asarray(v, np.float32)
    return out


def _jax_run(jmod, cfg, mesh_shape, params, batches):
    """The JAX package's sharded step on a sub-mesh of the host devices."""
    world = math.prod(mesh_shape.values())
    mesh = jpar.make_mesh(devices=jax.devices()[:world], **mesh_shape)
    opt = jpar.default_optimizer(1e-3, warmup_steps=2, total_steps=10)
    with jax.sharding.set_mesh(mesh):
        state, sh = jpar.create_train_state(mesh, jax.random.PRNGKey(0), lambda _: params, opt,
                                            jmod.param_specs(cfg))
        # a batch spec no longer than its labels' rank (1) for ViT
        step = jpar.make_train_step(partial(jmod.loss_fn, config=cfg), opt, mesh, sh,
                                    batch_ndim_extra=0 if jmod is jv else 1)
        out = []
        for b in batches:
            state, m = step(state, {k: jnp.asarray(v) for k, v in b.items()})
            out.append((float(m["loss"]), float(m["grad_norm"])))
        return out, _flat(jax.tree.map(np.asarray, state.params))


def _one_device(tmod, cfg, npz, batches):
    """The port's one-device step on the CPU."""
    full = convert.load_params_npz(npz)
    opt = tpar.default_optimizer(1e-3, warmup_steps=2, total_steps=10)
    state = tpar.create_train_state(None, lambda _: params_from_numpy(full, "cpu"), opt,
                                    device="cpu")
    step = tpar.make_train_step(lambda p, b: tmod.loss_fn(p, b, cfg), opt)
    out = []
    for b in batches:
        state, m = step(state, {k: torch.from_numpy(v) for k, v in b.items()})
        out.append((float(m["loss"]), float(m["grad_norm"])))
    return out


CASE_IDS = [f"{f}-{'-'.join(f'{k}{v}' for k, v in m.items())}" for f, m, _, _ in CASES]


def _jax_cfg(family, jax_extra):
    jmod, jbase, _, _ = FAMILIES[family]
    return jmod, dataclasses.replace(jbase, dtype=jnp.float32, **jax_extra)


@pytest.fixture(scope="module")
def mesh_runs(tmp_path_factory):
    """Every case's inputs in a folder of its own, and the port's ranks run
    once for each world size, every case of that size in one process group
    (a rank process costs seconds to start; its steps cost little)."""
    root = tmp_path_factory.mktemp("train_mesh")
    inputs, worlds = {}, {}
    for tag, (family, mesh_shape, jax_extra, port_extra) in zip(CASE_IDS, CASES):
        jmod, jcfg = _jax_cfg(family, jax_extra)
        params = jmod.init_params(jax.random.PRNGKey(0), jcfg)
        d = root / tag
        d.mkdir()
        save_params_npz(params, str(d / "params.npz"))
        batches = _batches(family, jcfg, np.random.default_rng(1))
        np.savez(d / "batches.npz",
                 **{f"{i}/{k}": v for i, b in enumerate(batches) for k, v in b.items()})
        inputs[tag] = (params, str(d / "params.npz"), batches)
        worlds.setdefault(math.prod(mesh_shape.values()), []).append(
            {"tag": tag, "family": family, "mesh": mesh_shape, "config": port_extra})
    outs = {}
    for world, runs in worlds.items():
        per_rank = ranks.launch("train", world, root, runs=runs, steps=STEPS)
        for run in runs:
            outs[run["tag"]] = [o[run["tag"]] for o in per_rank]
    return inputs, outs


@pytest.mark.parametrize("family,mesh_shape,jax_extra,port_extra", CASES, ids=CASE_IDS)
def test_sharded_steps_match_jax_and_one_device(mesh_runs, family, mesh_shape, jax_extra,
                                                port_extra):
    jmod, jcfg = _jax_cfg(family, jax_extra)
    _, _, tmod, tbase = FAMILIES[family]
    tcfg = dataclasses.replace(tbase, dtype=torch.float32, **port_extra)
    tag = CASE_IDS[CASES.index((family, mesh_shape, jax_extra, port_extra))]
    params, npz, batches = mesh_runs[0][tag]
    outs = mesh_runs[1][tag]

    jax_steps, jax_params = _jax_run(jmod, jcfg, mesh_shape, params, batches)
    one = _one_device(tmod, tcfg, npz, batches)
    for r, o in enumerate(outs):
        assert (o["losses"], o["grad_norms"]) == (outs[0]["losses"], outs[0]["grad_norms"]), r
        assert math.isfinite(o["eval_loss"])
    port = list(zip(outs[0]["losses"], outs[0]["grad_norms"]))
    np.testing.assert_allclose(port, jax_steps, rtol=RTOL)
    np.testing.assert_allclose(port, one, rtol=RTOL)
    for name, value in jax_params.items():
        np.testing.assert_allclose(outs[0]["params"][name], value, atol=PARAM_ATOL,
                                   err_msg=name)


@pytest.fixture(scope="module")
def trainer_runtime(tmp_path_factory):
    root = tmp_path_factory.mktemp("trainer_mesh")
    jcfg = dataclasses.replace(jl.LLAMA_TINY, dtype=jnp.float32)
    npz = str(root / "tiny.npz")
    save_params_npz(jl.init_params(jax.random.PRNGKey(0), jcfg), npz)
    tokens = np.random.default_rng(0).integers(0, jcfg.vocab_size, (3, 4, 65)).astype(np.int32)
    ray_tpu.init(num_cpus=2, max_workers=2, ignore_reinit_error=True)
    ray_tpu_torch.init(num_cpus=2, max_workers=2)
    yield {"npz": npz, "tokens": tokens, "root": root}
    ray_tpu_torch.shutdown()
    ray_tpu.shutdown()


def test_torch_trainer_mesh_shape_matches_jax_trainer(trainer_runtime):
    """Three steps of LLAMA_TINY (f32) at fsdp 2: a JaxTrainer worker on a
    2-device mesh, and two gloo TorchTrainer workers whose loops build
    their mesh with ``make_mesh()`` from ``TorchConfig.mesh_shape``. The
    loops are defined here, so they are pickled by value."""
    from ray_tpu import air as jair
    from ray_tpu import train as jtrain
    from ray_tpu_torch import air as tair
    from ray_tpu_torch import train as ttrain

    def jax_loop(config):
        import dataclasses
        from functools import partial

        import jax
        import jax.numpy as jnp

        from ray_tpu import parallel, train
        from ray_tpu.llm import LLMConfig
        from ray_tpu.models import llama

        cfg = dataclasses.replace(llama.LLAMA_TINY, dtype=jnp.float32)
        mesh = parallel.make_mesh(fsdp=2, devices=jax.devices()[:2])
        opt = parallel.default_optimizer(1e-3, warmup_steps=1, total_steps=10)
        params = LLMConfig(model_config=cfg, checkpoint_path=config["npz"]).load_params()
        state, sh = parallel.create_train_state(mesh, jax.random.PRNGKey(0), lambda _: params,
                                                opt, llama.param_specs(cfg))
        step = parallel.make_train_step(partial(llama.loss_fn, config=cfg), opt, mesh, sh)
        for tokens in config["tokens"]:
            state, m = step(state, {"tokens": jnp.asarray(tokens)})
            train.report({"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"])})

    def torch_loop(config):
        import dataclasses

        import torch

        from ray_tpu_torch import parallel, train
        from ray_tpu_torch.llm import LLMConfig
        from ray_tpu_torch.models import llama

        cfg = dataclasses.replace(llama.LLAMA_TINY, dtype=torch.float32)
        mesh = parallel.make_mesh(device="cpu")  # TorchConfig.mesh_shape
        sizes = {a: parallel.mesh_axis_size(mesh, a) for a in parallel.AXIS_ORDER}
        opt = parallel.default_optimizer(1e-3, warmup_steps=1, total_steps=10)
        llm = LLMConfig(model_config=cfg, checkpoint_path=config["npz"])
        state, sh = parallel.create_train_state(mesh, None, lambda _: llm.load_params("cpu"),
                                                opt, llama.param_specs(cfg))
        step = parallel.make_train_step(lambda p, b: llama.loss_fn(p, b, cfg), opt, mesh, sh)
        for tokens in config["tokens"]:
            state, m = step(state, {"tokens": torch.from_numpy(tokens)})
            train.report({"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
                          "sizes": sizes, "wq": tuple(state.params["blocks"]["wq"].shape)})

    class Collect:
        def __init__(self):
            self.rows = []

        def on_result(self, metrics):
            self.rows.append(dict(metrics))

    config = {"npz": trainer_runtime["npz"], "tokens": trainer_runtime["tokens"]}
    root = str(trainer_runtime["root"])
    jcol, tcol = Collect(), Collect()
    jres = jtrain.JaxTrainer(
        jax_loop, train_loop_config=config,
        scaling_config=jair.ScalingConfig(num_workers=1),
        run_config=jair.RunConfig(name="jax_mesh", storage_path=root, callbacks=[jcol])).fit()
    tres = ttrain.TorchTrainer(
        torch_loop, train_loop_config=config,
        torch_config=ttrain.TorchConfig(backend="gloo", mesh_shape={"fsdp": 2}),
        scaling_config=tair.ScalingConfig(num_workers=2),
        run_config=tair.RunConfig(name="torch_mesh", storage_path=root, callbacks=[tcol])).fit()
    assert jres.error is None and tres.error is None, (jres.error, tres.error)
    jrows = [(r["loss"], r["grad_norm"]) for r in jcol.rows]
    trows = [(r["loss"], r["grad_norm"]) for r in tcol.rows]
    assert len(jrows) == len(trows) == 3
    np.testing.assert_allclose(trows, jrows, rtol=RTOL)
    last = tcol.rows[-1]
    assert last["sizes"] == {"data": 1, "fsdp": 2, "expert": 1, "seq": 1, "model": 1}
    cfg = tl.LLAMA_TINY
    assert last["wq"] == (cfg.n_layers, cfg.dim // 2, cfg.n_heads, cfg.head_dim)
