"""A sharded ``Checkpoint.from_torch``/``to_torch`` of the port, against
``shard_params`` of the gathered tree and against the JAX package's
``from_jax``/``to_jax(target, shardings)``.

The port's ranks (gloo on the CPU, started by ``tests/torch_mesh_ranks.py``)
train LLAMA_TINY (f32, the JAX package's parameters through a ``.npz``)
for two steps at the save mesh, save the sharded TrainState, take a third
step, and restore the checkpoint onto meshes of the same and of other
shapes in the same ranks (``make_mesh`` builds a second mesh in one
process). Every restored shard (parameters and both Adam moments) is held
bit for bit against ``shard_params`` of the tree the ranks gathered at the
save, and one step on the restored state against the third step of the
uninterrupted run (rtol 1e-5: the new mesh sums its shards in another
order). On the JAX side, a checkpoint of the same parameters restored by
``to_jax`` over ``models.llama.param_specs`` at (fsdp 2, model 2) on the
8-device CPU mesh gives device i the same shard as the port's rank i,
exactly.
"""

import dataclasses
import json
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import NamedSharding, PartitionSpec

import torch_mesh_ranks as ranks
from ray_tpu import parallel as jpar
from ray_tpu import train as jtrain
from ray_tpu.llm import save_params_npz
from ray_tpu.models import llama as jl
from ray_tpu_torch import train
from ray_tpu_torch.models import convert

RTOL = 1e-5
STEPS = 2

# (world, save mesh, restore meshes, a mesh a spec does not divide)
RUNS = {
    4: ({"fsdp": 2, "model": 2}, [{"fsdp": 4}, {"fsdp": 2, "model": 2}, {"data": 2, "model": 2}],
        {"model": 4}),
    2: ({"fsdp": 2}, [{"model": 2}, {"fsdp": 2}], None),
}
CASES = [(w, json.dumps(s, sort_keys=True)) for w, (_, shapes, _) in RUNS.items()
         for s in shapes]
CASE_IDS = [f"world{w}-to-{'-'.join(f'{k}{v}' for k, v in json.loads(s).items())}"
            for w, s in CASES]


def _jax_cfg():
    return dataclasses.replace(jl.LLAMA_TINY, dtype=jnp.float32)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = np.asarray(v, np.float32)
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The JAX package's parameters, batches, an unsharded checkpoint of the
    parameters written by the port, and each world size's ranks run once."""
    root = tmp_path_factory.mktemp("checkpoint_mesh")
    params = jl.init_params(jax.random.PRNGKey(0), _jax_cfg())
    rng = np.random.default_rng(3)
    tokens = {str(i): rng.integers(0, jl.LLAMA_TINY.vocab_size, (8, 65)).astype(np.int32)
              for i in range(STEPS + 1)}
    outs = {}
    for world, (save, restores, indivisible) in RUNS.items():
        d = root / f"world{world}"
        d.mkdir()
        save_params_npz(params, str(d / "params.npz"))
        np.savez(d / "batches.npz", **tokens)
        unsharded = None
        if world == 4:
            full = convert.params_from_numpy(convert.load_params_npz(str(d / "params.npz")),
                                             "cpu")
            unsharded = train.Checkpoint.from_torch(full, str(d / "unsharded")).path
        outs[world] = (ranks.launch("checkpoint", world, d, steps=STEPS, save=save,
                                    restores=restores, indivisible=indivisible,
                                    unsharded=unsharded), d)
    return params, outs


@pytest.mark.parametrize("world,shape", CASES, ids=CASE_IDS)
def test_restored_shards_equal_shard_params_of_the_gathered_tree(runs, world, shape):
    per_rank, _ = runs[1][world]
    for r, o in enumerate(per_rank):
        got = o["restores"][shape]
        assert got["bit_equal"] == {"params": True, "mu": True, "nu": True}, r
        assert got["contiguous"] and all(got["requires_grad"]), r
        assert got["counts"] == (STEPS, STEPS), r
    mesh = json.loads(shape)
    # the head dim of wq is split over model, the embedding dim over fsdp
    d, h = jl.LLAMA_TINY.dim, jl.LLAMA_TINY.n_heads
    hd = d // h
    assert per_rank[0]["restores"][shape]["wq_shape"] == (
        jl.LLAMA_TINY.n_layers, d // mesh.get("fsdp", 1), h // mesh.get("model", 1), hd)


@pytest.mark.parametrize("world,shape", CASES, ids=CASE_IDS)
def test_a_step_on_the_restored_state_matches_the_uninterrupted_run(runs, world, shape):
    per_rank, _ = runs[1][world]
    losses = {o["restores"][shape]["loss"] for o in per_rank}
    assert len(losses) == 1, losses       # all-reduced: one loss on every rank
    np.testing.assert_allclose(losses.pop(), per_rank[0]["uninterrupted"], rtol=RTOL)


@pytest.mark.parametrize("world", sorted(RUNS))
def test_a_sharded_save_writes_the_global_tree(runs, world):
    """The file holds the whole tree (the mesh's first rank wrote what every
    rank gathered), so ``to_torch`` without shardings restores whole
    tensors."""
    per_rank, d = runs[1][world]
    whole = train.Checkpoint(str(d / "ckpt")).to_torch(device="cpu")
    assert whole["step"] == STEPS and whole["opt_state"]["count"] == STEPS
    for key, tree in (("params", whole["params"]), ("mu", whole["opt_state"]["mu"]),
                      ("nu", whole["opt_state"]["nu"])):
        flat = ranks._flat(tree)
        for o in per_rank:
            assert flat.keys() == o["saved"][key].keys()
            for name, value in o["saved"][key].items():
                np.testing.assert_array_equal(flat[name], value, err_msg=f"{key}/{name}")
    assert whole["params"]["blocks"]["wq"].shape == (
        jl.LLAMA_TINY.n_layers, jl.LLAMA_TINY.dim, jl.LLAMA_TINY.n_heads,
        jl.LLAMA_TINY.dim // jl.LLAMA_TINY.n_heads)


def test_a_spec_that_does_not_divide_raises(runs):
    """model 4 over LLAMA_TINY's 2 KV heads: ``shard_params`` raises there,
    and so does the restore (GSPMD would pad)."""
    per_rank, _ = runs[1][4]
    for o in per_rank:
        assert o["indivisible"] is not None
        assert "not divisible by 4" in o["indivisible"], o["indivisible"]
        assert "params.blocks" in o["indivisible"], o["indivisible"]


def test_restore_onto_a_mesh_equals_jax_to_jax_shards(runs, tmp_path):
    """JAX's ``from_jax`` then ``to_jax(target, shardings)`` over
    ``param_specs`` at (fsdp 2, model 2) on host devices 0-3: device i's
    shard of every parameter equals the port's rank i shard of the same
    parameters restored by ``to_torch(shardings=)``."""
    params, outs = runs
    per_rank, _ = outs[4]
    save = RUNS[4][0]
    world = math.prod(save.values())
    mesh = jpar.make_mesh(devices=jax.devices()[:world], **save)
    shardings = jax.tree.map(lambda s: NamedSharding(mesh, s), jl.param_specs(_jax_cfg()),
                             is_leaf=lambda x: isinstance(x, PartitionSpec))
    ckpt = jtrain.Checkpoint.from_jax(params, str(tmp_path / "jax"))
    restored = ckpt.to_jax(target=params, shardings=shardings)
    flat = {}

    def visit(path, arr):
        flat["/".join(str(getattr(k, "key", k)) for k in path)] = arr

    jax.tree_util.tree_map_with_path(visit, restored)
    assert flat.keys() == per_rank[0]["unsharded"].keys()
    for name, arr in flat.items():
        assert arr.sharding == shardings_at(shardings, name)
        by_device = {s.device: np.asarray(s.data) for s in arr.addressable_shards}
        for r, device in enumerate(mesh.devices.flat):
            np.testing.assert_array_equal(per_rank[r]["unsharded"][name], by_device[device],
                                          err_msg=f"{name} rank {r}")


def shardings_at(tree, name):
    for k in name.split("/"):
        tree = tree[k]
    return tree
