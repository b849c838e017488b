"""Pipeline parallelism of the port (``parallel/pipeline.py``) on a
``pipe`` mesh of 4 gloo ranks on the CPU, against the JAX package's
``pipeline_train`` and ``pipeline_sharded`` on 4 host devices and against
the sequential computation, on the same seeded numpy stages and batches
(the JAX package's ``test_pipeline_1f1b.py`` and ``test_ops_parallel.py``
setup: tanh(x @ w + b) stages of width 16, mean-square loss).

1F1B and GPipe: the mean loss and every stage's gradients (gathered
whole) against ``jax.value_and_grad`` of the sequential microbatched loss
and against the JAX pipeline's, at 8 microbatches of 4; and 1F1B's lower
peak at 32 microbatches: the port measures the inputs it stashes at once
(at most min(M, 2P - 1) = 7 against GPipe's 32), where the reference's
test reads XLA's compiled temp memory. The forward pipeline against the
sequential stages, and a single microbatch on 2 stages.

Tolerances (f32): loss rtol 1e-5, gradients and outputs atol 1e-5 (the
reference's own test's).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh

import torch_mesh_ranks as ranks
from ray_tpu.parallel.pipeline import pipeline_sharded, pipeline_train

P_STAGES = 4
FDIM = 16
MICRO = 4


def _stage(params, x):
    return jnp.tanh(x @ params["w"] + params["b"])


def _loss(y, t):
    return jnp.mean((y - t) ** 2)


@pytest.fixture(scope="module")
def pipe_run(tmp_path_factory):
    d = tmp_path_factory.mktemp("pipe")
    rng = np.random.default_rng(0)
    arrays = {"w": (rng.standard_normal((P_STAGES, FDIM, FDIM)) * 0.3).astype(np.float32),
              "b": (rng.standard_normal((P_STAGES, FDIM)) * 0.1).astype(np.float32),
              "batch": rng.standard_normal((32, FDIM)).astype(np.float32),
              "targets": rng.standard_normal((32, FDIM)).astype(np.float32),
              "big_batch": rng.standard_normal((128, FDIM)).astype(np.float32),
              "big_targets": rng.standard_normal((128, FDIM)).astype(np.float32)}
    np.savez(d / "pipe.npz", **arrays)
    outs = ranks.launch("pipeline", P_STAGES, d, microbatch=MICRO)
    return arrays, outs


def _sequential(arrays, batch, targets):
    stacked = {k: jnp.asarray(arrays[k]) for k in ("w", "b")}
    x_all, t_all = jnp.asarray(arrays[batch]), jnp.asarray(arrays[targets])

    def full_loss(params):
        M = x_all.shape[0] // MICRO
        total = 0.0
        for m in range(M):
            x = x_all[m * MICRO:(m + 1) * MICRO]
            for p in range(P_STAGES):
                x = _stage(jax.tree.map(lambda v: v[p], params), x)
            total = total + _loss(x, t_all[m * MICRO:(m + 1) * MICRO])
        return total / M

    return jax.value_and_grad(full_loss)(stacked)


@pytest.mark.parametrize("schedule", ["1f1b", "gpipe"])
def test_grads_match_sequential_and_jax(pipe_run, schedule):
    arrays, outs = pipe_run
    ref_loss, ref_grads = _sequential(arrays, "batch", "targets")
    mesh = Mesh(np.asarray(jax.devices()[:P_STAGES]), ("pipe",))
    stacked = {k: jnp.asarray(arrays[k]) for k in ("w", "b")}
    run = pipeline_train(_stage, stacked, mesh, loss_fn=_loss, microbatch_size=MICRO,
                         schedule=schedule)
    jloss, jgrads = jax.jit(run)(jnp.asarray(arrays["batch"]), jnp.asarray(arrays["targets"]))
    for o in outs:
        got = o[f"small/{schedule}"]
        np.testing.assert_allclose(got["loss"], float(ref_loss), rtol=1e-5)
        np.testing.assert_allclose(got["loss"], float(jloss), rtol=1e-5)
        for k in ("w", "b"):
            np.testing.assert_allclose(got["grads"][k].numpy(), np.asarray(ref_grads[k]),
                                       atol=1e-5, err_msg=f"{schedule}:{k}")
            np.testing.assert_allclose(got["grads"][k].numpy(), np.asarray(jgrads[k]),
                                       atol=1e-5, err_msg=f"{schedule}:{k}")
        assert got["stats"]["microbatches"] == 8


def test_1f1b_stashes_less_than_gpipe(pipe_run):
    """32 microbatches on 4 stages: 1F1B holds at most 2P - 1 = 7 inputs at
    once on stage 0, GPipe all 32; both give the same gradients."""
    arrays, outs = pipe_run
    peaks = {s: [o[f"big/{s}"]["stats"] for o in outs] for s in ("1f1b", "gpipe")}
    assert peaks["1f1b"][0]["peak_stash"] == 2 * P_STAGES - 1
    assert max(p["peak_stash"] for p in peaks["1f1b"]) <= min(32, 2 * P_STAGES - 1)
    assert peaks["gpipe"][0]["peak_stash"] == 32
    one, gp = (max(p["peak_stash_bytes"] for p in peaks[s]) for s in ("1f1b", "gpipe"))
    assert one < 0.7 * gp, (one, gp)
    ref_loss, ref_grads = _sequential(arrays, "big_batch", "big_targets")
    for o in outs:
        for s in ("1f1b", "gpipe"):
            np.testing.assert_allclose(o[f"big/{s}"]["loss"], float(ref_loss), rtol=1e-5)
            for k in ("w", "b"):
                np.testing.assert_allclose(o[f"big/{s}"]["grads"][k].numpy(),
                                           np.asarray(ref_grads[k]), atol=1e-5)


def test_forward_pipeline_matches_sequential(pipe_run):
    arrays, outs = pipe_run
    ref = jnp.asarray(arrays["batch"])
    for i in range(P_STAGES):
        ref = _stage({"w": arrays["w"][i], "b": arrays["b"][i]}, ref)
    mesh = Mesh(np.asarray(jax.devices()[:P_STAGES]), ("pipe",))
    stacked = {k: jnp.asarray(arrays[k]) for k in ("w", "b")}
    jout = jax.jit(pipeline_sharded(_stage, stacked, mesh, microbatch_size=MICRO))(
        jnp.asarray(arrays["batch"]))
    for o in outs:
        np.testing.assert_allclose(o["forward"].numpy(), np.asarray(ref), atol=1e-5)
        np.testing.assert_allclose(o["forward"].numpy(), np.asarray(jout), atol=1e-5)


def test_single_microbatch(tmp_path):
    outs = ranks.launch("pipeline_one_microbatch", 2, tmp_path)
    for o in outs:
        np.testing.assert_allclose(o.numpy(), np.full((4, 3), 11.0))
