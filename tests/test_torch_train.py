"""The port's Train library against the JAX package's, on the CPU.

One ``LLAMA_TINY`` (f32) checkpoint is written to a ``.npz``; numpy
tokens seeded 0 feed three train steps. ``ray_tpu.train.JaxTrainer``
runs them with the reference's ``parallel.make_train_step`` on JAX's CPU
(plain attention and CE, as its own tests run them), reporting an orbax
checkpoint (``Checkpoint.from_jax``) each step;
``ray_tpu_torch.train.TorchTrainer(use_gpu=False)`` runs them with the
port's ``make_train_step`` on ``device="cpu"`` (flash attention and the
fused CE, whose plain versions run on the CPU), reporting
``Checkpoint.from_torch``. The per-step losses and grad norms agree
within rtol 1e-5 (the train-step tolerance of test_torch_train_step.py),
and so do the losses of a run resumed from each package's step-2
checkpoint, which must also equal its package's uninterrupted step 3.
Also: ``from_torch``/``to_torch`` round-trip a bf16 ``TrainState`` bit for
bit, the configs bind like the reference's, and every name of
``ray_tpu.train`` is in the port or mapped.

Cost: one runtime per package for the whole file, two CPUs and two
pooled workers each; remote code names no helper of this module, so no
worker imports it.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ray_tpu
import ray_tpu_torch
from ray_tpu import air as jair
from ray_tpu import train as jtrain
from ray_tpu.llm import save_params_npz
from ray_tpu.models import llama as jl
from ray_tpu_torch import air as tair
from ray_tpu_torch import parallel as tpar
from ray_tpu_torch import train as ttrain

STEP_RTOL = 1e-5  # test_torch_train_step.py, f32 losses and grad norms
STEPS = 3


class _Collect:
    """A run callback: every processed report's metrics, in order."""

    def __init__(self):
        self.rows = []

    def on_result(self, metrics):
        self.rows.append(dict(metrics))


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    root = tmp_path_factory.mktemp("train")
    jcfg = dataclasses.replace(jl.LLAMA_TINY, dtype=jnp.float32)
    npz = str(root / "tiny.npz")
    save_params_npz(jl.init_params(jax.random.PRNGKey(0), jcfg), npz)
    tokens = np.random.default_rng(0).integers(0, jcfg.vocab_size, (STEPS, 2, 65)).astype(np.int32)
    ray_tpu.init(num_cpus=2, max_workers=2, ignore_reinit_error=True)
    ray_tpu_torch.init(num_cpus=2, max_workers=2)
    yield {"npz": npz, "tokens": tokens, "steps": STEPS, "root": root}
    ray_tpu_torch.shutdown()
    ray_tpu.shutdown()


@pytest.fixture(scope="module")
def loops():
    """The train loops, defined here so that they are pickled by value:
    a function at module level would make each worker import this file."""

    def _jax_loop(config):
        """The reference's side, as a JaxTrainer user writes it."""
        import dataclasses
        import os
        from functools import partial

        import jax
        import jax.numpy as jnp

        from ray_tpu import parallel, train
        from ray_tpu.llm import LLMConfig
        from ray_tpu.models import llama

        cfg = dataclasses.replace(llama.LLAMA_TINY, dtype=jnp.float32)
        mesh = parallel.make_mesh(devices=jax.devices()[:1])
        opt = parallel.default_optimizer(1e-3, warmup_steps=1, total_steps=10)
        params = LLMConfig(model_config=cfg, checkpoint_path=config["npz"]).load_params()
        state, shardings = parallel.create_train_state(
            mesh, jax.random.PRNGKey(0), lambda _: params, opt, llama.param_specs(cfg))
        ckpt = train.get_checkpoint()
        if ckpt is not None:
            # as a dict: to_jax orders a NamedTuple target's leaves by field
            # and orbax's restored dict by sorted key (ROADMAP.md Queue C)
            state = type(state)(**ckpt.to_jax(target=state._asdict(),
                                              shardings=shardings._asdict()))
        step = parallel.make_train_step(partial(llama.loss_fn, config=cfg), opt, mesh, shardings)
        for i in range(int(state.step), config["steps"]):
            state, m = step(state, {"tokens": jnp.asarray(config["tokens"][i])})
            path = os.path.join(config["scratch"], f"step_{i}")
            train.report({"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
                          "step": int(m["step"])},
                         checkpoint=train.Checkpoint.from_jax(state._asdict(), path=path))

    def _torch_loop(config):
        """The port's side: the same program on ray_tpu_torch."""
        import dataclasses
        import os

        import torch

        from ray_tpu_torch import parallel, train
        from ray_tpu_torch.llm import LLMConfig
        from ray_tpu_torch.models import llama

        cfg = dataclasses.replace(llama.LLAMA_TINY, dtype=torch.float32, attention_impl="flash",
                                  ce_impl="fused")
        opt = parallel.default_optimizer(1e-3, warmup_steps=1, total_steps=10)
        llm = LLMConfig(model_config=cfg, checkpoint_path=config["npz"])
        state = parallel.create_train_state(None, lambda _: llm.load_params("cpu"), opt, "cpu")
        ckpt = train.get_checkpoint()
        if ckpt is not None:
            state = ckpt.to_torch(target=state, device="cpu")
        step = parallel.make_train_step(lambda p, b: llama.loss_fn(p, b, cfg), opt)
        for i in range(state.step, config["steps"]):
            state, m = step(state, {"tokens": torch.from_numpy(config["tokens"][i])})
            path = os.path.join(config["scratch"], f"step_{i}")
            train.report({"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
                          "step": int(m["step"])},
                         checkpoint=train.Checkpoint.from_torch(state, path=path))

    return {"jax": _jax_loop, "torch": _torch_loop}


def _fit(pkg, loop, setup, name, resume=None):
    """(Result, the metrics of every step) of one run on ``pkg``."""
    scratch = setup["root"] / f"{name}_scratch"
    scratch.mkdir()
    collect = _Collect()
    kw = {"scaling_config": pkg.ScalingConfig(num_workers=1),
          "run_config": pkg.RunConfig(name=name, storage_path=str(setup["root"] / "runs"),
                                      callbacks=[collect]),
          "train_loop_config": {**setup, "root": None, "scratch": str(scratch)},
          "resume_from_checkpoint": resume}
    trainer = pkg.JaxTrainer(loop, **kw) if pkg is jtrain else pkg.TorchTrainer(loop, **kw)
    result = trainer.fit()
    assert result.error is None, result.error
    return result, collect.rows


@pytest.fixture(scope="module")
def runs(setup, loops):
    return {"jax": _fit(jtrain, loops["jax"], setup, "jax"),
            "torch": _fit(ttrain, loops["torch"], setup, "torch")}


def test_trainers_agree_step_by_step(runs):
    (jres, jrows), (tres, trows) = runs["jax"], runs["torch"]
    assert [r["step"] for r in trows] == [r["step"] for r in jrows] == [1, 2, 3]
    for key in ("loss", "grad_norm"):
        np.testing.assert_allclose([r[key] for r in trows], [r[key] for r in jrows],
                                   rtol=STEP_RTOL, err_msg=key)
    assert tres.metrics["training_iteration"] == jres.metrics["training_iteration"] == STEPS
    assert set(tres.metrics) == set(jres.metrics)
    assert len(tres.best_checkpoints) == len(jres.best_checkpoints) == STEPS
    assert os.path.basename(tres.checkpoint.path) == os.path.basename(jres.checkpoint.path)


def test_resume_from_step_two_checkpoint_agrees(setup, loops, runs):
    """Each package resumes from its own step-2 checkpoint and runs step 3
    only: the loss equals its uninterrupted step 3 and the other
    package's."""
    resumed = {}
    for label, pkg in (("jax", jtrain), ("torch", ttrain)):
        ckpt = pkg.Checkpoint(runs[label][0].best_checkpoints[1][0].path)
        result, rows = _fit(pkg, loops[label], setup, f"{label}_resumed", resume=ckpt)
        assert [r["step"] for r in rows] == [3]
        assert result.metrics["training_iteration"] == 1
        np.testing.assert_allclose(rows[0]["loss"], runs[label][1][2]["loss"], rtol=STEP_RTOL)
        resumed[label] = rows[0]
    for key in ("loss", "grad_norm"):
        np.testing.assert_allclose(resumed["torch"][key], resumed["jax"][key], rtol=STEP_RTOL)


def _bf16_state():
    gen = torch.Generator().manual_seed(3)
    opt = tpar.default_optimizer(1e-3, warmup_steps=1, total_steps=10)

    def init(g):
        return {"embed": torch.randn(16, 8, generator=g).bfloat16(),
                "blocks": {"wq": torch.randn(2, 8, 8, generator=g).bfloat16()},
                "norm": [torch.ones(8, dtype=torch.bfloat16)]}

    state = tpar.create_train_state(gen, init, opt, "cpu")
    for mu, nu in zip(tpar.tree_leaves(state.opt_state.mu), tpar.tree_leaves(state.opt_state.nu)):
        mu.normal_(generator=gen)
        nu.uniform_(generator=gen)
    return tpar.TrainState(5, state.params, dataclasses.replace(state.opt_state, count=5))


def test_torch_checkpoint_round_trips_a_bf16_train_state(tmp_path):
    state = _bf16_state()
    ckpt = ttrain.Checkpoint.from_torch(state, path=str(tmp_path / "c"))
    assert os.listdir(ckpt.path) == ["torch_state.pt"]
    template = _bf16_state()
    back = ckpt.to_torch(target=template, device="cpu")
    assert type(back) is tpar.TrainState and type(back.opt_state) is type(state.opt_state)
    assert back.step == 5 and back.opt_state.count == 5
    assert list(back.params["blocks"]) == ["wq"] and isinstance(back.params["norm"], list)
    for a, b in zip(tpar.tree_leaves([back.params, back.opt_state.mu, back.opt_state.nu]),
                    tpar.tree_leaves([state.params, state.opt_state.mu, state.opt_state.nu])):
        assert a.dtype == b.dtype == torch.bfloat16
        assert torch.equal(a.view(torch.int16), b.view(torch.int16))
        assert a.device == torch.device("cpu")
    assert all(p.requires_grad for p in tpar.tree_leaves(back.params))
    assert not any(m.requires_grad for m in tpar.tree_leaves(back.opt_state.mu))
    # without a target: plain dicts and lists, the fields by name
    plain = ckpt.to_torch(device="cpu")
    assert set(plain) == {"step", "params", "opt_state"}
    assert set(plain["opt_state"]) == {"count", "mu", "nu"}
    assert torch.equal(plain["params"]["embed"], state.params["embed"])
    with pytest.raises(ValueError, match="the root"):
        ckpt.to_torch(target={"only": torch.zeros(1)}, device="cpu")
    bad = template._replace(params={**template.params, "norm": [1, 2]})
    with pytest.raises(ValueError, match=r"\.params\.norm is not a sequence of 2"):
        ckpt.to_torch(target=bad, device="cpu")


def test_to_torch_runs_on_the_gpu_unless_asked(tmp_path, monkeypatch):
    ckpt = ttrain.Checkpoint.from_torch({"w": torch.zeros(2)}, path=str(tmp_path / "c"))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ckpt.to_torch()
    assert torch.equal(ckpt.to_torch(device="cpu")["w"], torch.zeros(2))


def test_checkpoint_directory_methods_match_the_reference(tmp_path):
    for pkg, sub in ((jtrain, "j"), (ttrain, "t")):
        ckpt = pkg.Checkpoint.from_state({"step": 7, "w": [1.0, 2.0]}, path=str(tmp_path / sub))
        ckpt.update_metadata({"epoch": 1})
        assert ckpt.get_metadata() == {"epoch": 1}
        copy = pkg.Checkpoint.from_directory(ckpt.to_directory(str(tmp_path / f"{sub}_copy")))
        assert copy.to_state() == {"step": 7, "w": [1.0, 2.0]}
        with copy.as_directory() as d:
            assert sorted(os.listdir(d)) == [".metadata.json", "pytree.msgpack.pkl"]


def test_every_reference_name_is_ported_or_mapped():
    mapped = ttrain.MAPPED
    assert mapped == {"JaxTrainer": "TorchTrainer", "JaxConfig": "TorchConfig"}
    for name in jtrain.__all__:
        assert name in ttrain.__all__ or name in mapped, name
        assert hasattr(ttrain, mapped.get(name, name)), name
    assert set(ttrain.__all__) == set(jtrain.__all__) - set(mapped)
    assert jair.__all__ == tair.__all__
    assert issubclass(ttrain.TorchTrainer, ttrain.DataParallelTrainer)
    assert issubclass(ttrain.TorchConfig, ttrain.BackendConfig)


def test_configs_bind_like_the_reference(monkeypatch):
    """The reference's fields in its order (positional binding alike),
    then the port's ``gpus_per_worker``; ``use_gpu`` asks for GPUs where
    the reference maps it onto nothing; the storage default is the
    port's own."""
    names = [f.name for f in dataclasses.fields(tair.ScalingConfig)]
    ref = [f.name for f in dataclasses.fields(jair.ScalingConfig)]
    assert names == ref + ["gpus_per_worker"]
    for cls in ("FailureConfig", "CheckpointConfig", "RunConfig"):
        assert ([f.name for f in dataclasses.fields(getattr(tair, cls))]
                == [f.name for f in dataclasses.fields(getattr(jair, cls))])
    assert tair.ScalingConfig(2, False, True)._resources_per_worker_not_none() == {
        "CPU": 1.0, "GPU": 1.0}
    assert jair.ScalingConfig(2, False, True)._resources_per_worker_not_none() == {"CPU": 1.0}
    sc = tair.ScalingConfig(num_workers=2, use_gpu=True, gpus_per_worker=2)
    assert sc.num_gpus_per_worker == 2.0 and sc.total_resources == {"CPU": 2.0, "GPU": 4.0}
    tpu = tair.ScalingConfig(use_tpu=True, tpu_chips_per_worker=4)
    assert tpu._resources_per_worker_not_none() == jair.ScalingConfig(
        use_tpu=True, tpu_chips_per_worker=4)._resources_per_worker_not_none() == {
        "CPU": 1.0, "TPU": 4.0}
    assert tpu.num_gpus_per_worker == 0.0
    monkeypatch.delenv("RAY_TPU_TORCH_STORAGE_PATH", raising=False)
    assert tair.RunConfig().storage_path == os.path.expanduser("~/ray_tpu_torch_results")
    monkeypatch.setenv("RAY_TPU_TORCH_STORAGE_PATH", "/x/y")
    assert tair.RunConfig().storage_path == "/x/y"
    assert jair.RunConfig().storage_path != "/x/y"
    with pytest.raises(ValueError):
        tair.CheckpointConfig(num_to_keep=0)
