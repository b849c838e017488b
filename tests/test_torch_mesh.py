"""The port's meshes (``ray_tpu_torch.parallel.mesh``) and sharded state
against the JAX package's, on the CPU: ``make_mesh`` over 4 gloo ranks
(default all fsdp, explicit sizes with the auto axis taking the rest, the
indivisible error) against ``ray_tpu.parallel.make_mesh`` over 4 host
devices; ``single_device_mesh`` in a world of one; ``shard_params`` and
``gather_params`` round trips of LLAMA_TINY at (fsdp 2, model 2), each
shard the JAX package's shard of the same array
(``addressable_shards``); and ``create_train_state`` over that mesh,
whose Adam moments shadow their parameter's shard and spec while counts
and the step are replicated, as ``state_shardings`` gives them.

Exact comparisons throughout (shapes, specs and copied values). Ranks are
processes of ``tests/torch_mesh_ranks.py`` on a ``FileStore`` under
``tmp_path``, each join and wait bounded.
"""

import jax
import pytest
from jax.sharding import PartitionSpec as JP

import torch_mesh_ranks as ranks
from ray_tpu import parallel as jpar
from ray_tpu.llm import save_params_npz
from ray_tpu.models import llama as jl
from ray_tpu_torch import parallel as tpar
from ray_tpu_torch.models import llama as tl


@pytest.fixture(scope="module")
def mesh_run(tmp_path_factory):
    d = tmp_path_factory.mktemp("mesh")
    params = jl.init_params(jax.random.PRNGKey(0), jl.LLAMA_TINY)
    save_params_npz(params, str(d / "params.npz"))
    return params, ranks.launch("mesh", 4, d)


def _jax_shape(mesh):
    return {a: mesh.shape[a] for a in jpar.AXIS_ORDER}


def test_default_mesh_is_all_fsdp(mesh_run):
    _, outs = mesh_run
    ref = jpar.make_mesh(devices=jax.devices()[:4])
    for shape, dp in (o["default"] for o in outs):
        assert shape == _jax_shape(ref) and dp == jpar.dp_degree(ref) == 4


def test_explicit_sizes_and_the_auto_axis(mesh_run):
    _, outs = mesh_run
    ref = jpar.make_mesh(data=2, devices=jax.devices()[:4])
    coords = set()
    for shape, dp, coord in (o["data2"] for o in outs):
        assert shape == _jax_shape(ref) == {"data": 2, "fsdp": 2, "expert": 1, "seq": 1,
                                             "model": 1}
        assert dp == jpar.dp_degree(ref)
        coords.add(tuple(coord))
    # ranks laid out row-major, as the JAX package reshapes its devices
    assert [list(o["data2"][2]) for o in outs] == [[d, f, 0, 0, 0] for d in (0, 1)
                                                   for f in (0, 1)]
    assert len(coords) == 4


def test_indivisible_mesh_raises(mesh_run):
    _, outs = mesh_run
    with pytest.raises(ValueError, match="not divisible"):
        jpar.make_mesh(data=3, devices=jax.devices()[:4])
    for o in outs:
        assert o["indivisible"] is not None and "not divisible" in o["indivisible"]


def test_single_device_mesh(tmp_path):
    (sizes,) = ranks.launch("single", 1, tmp_path)
    assert sizes == _jax_shape(jpar.single_device_mesh()) == {a: 1 for a in jpar.AXIS_ORDER}


def test_shards_are_the_jax_shards(mesh_run):
    """Each rank's shard of every LLAMA_TINY parameter at (fsdp 2, model 2)
    has the shape of the JAX package's shard of the same device, and the
    shards gather back to the whole tree bit for bit."""
    params, outs = mesh_run
    mesh = jpar.make_mesh(fsdp=2, model=2, devices=jax.devices()[:4])
    specs = jl.param_specs(jl.LLAMA_TINY)
    state, _ = jpar.create_train_state(mesh, jax.random.PRNGKey(0), lambda _: params,
                                       jpar.default_optimizer(), specs)
    flat = {"embed": state.params["embed"], "final_norm": state.params["final_norm"],
            "lm_head": state.params["lm_head"],
            **{f"blocks/{k}": v for k, v in state.params["blocks"].items()}}
    for r, o in enumerate(outs):
        assert o["contiguous"] and o["round_trip"], r
        for name, arr in flat.items():
            (shard,) = [s for s in arr.addressable_shards if s.device == jax.devices()[r]]
            assert o["shard_shapes"][name] == shard.data.shape, (r, name)
    assert list(outs[0]["coordinate"]) == [0, 0, 0, 0, 0]
    assert list(outs[3]["coordinate"]) == [0, 1, 0, 0, 1]


def test_state_moments_shadow_their_parameter(mesh_run):
    _, outs = mesh_run
    specs = tl.param_specs(tl.LLAMA_TINY)
    jspecs = jl.param_specs(jl.LLAMA_TINY)
    assert tuple(specs["blocks"]["wq"]) == tuple(jspecs["blocks"]["wq"])
    for o in outs:
        assert o["param_spec_wq"] == tuple(JP(None, "fsdp", "model", None))
        assert o["param_spec_embed"] == tuple(JP("model", "fsdp"))
        assert o["mu_spec_wq"] == o["param_spec_wq"]
        assert o["count_spec"] == o["step_spec"] == ()
        assert o["moments_shadow"] and o["state_shardings_match"]


def test_specs_match_the_reference():
    """Every family's param_specs names the reference's axes per dim."""
    from ray_tpu.models import moe_llama as jm
    from ray_tpu.models import vit as jv
    from ray_tpu_torch.models import moe_llama as tm
    from ray_tpu_torch.models import vit as tv

    def flat(tree, prefix=""):
        out = {}
        for k, v in tree.items():
            out.update(flat(v, f"{prefix}{k}/") if isinstance(v, dict) else {prefix + k: v})
        return out

    for jmod, tmod, jc, tc in ((jl, tl, jl.LLAMA_TINY, tl.LLAMA_TINY),
                               (jm, tm, jm.MOE_TINY, tm.MOE_TINY),
                               (jv, tv, jv.VIT_TINY, tv.VIT_TINY)):
        js, ts = flat(jmod.param_specs(jc)), flat(tmod.param_specs(tc))
        assert set(js) == set(ts)
        for k in js:
            assert tuple(ts[k]) == tuple(js[k]), k
    assert tpar.batch_spec(2) == tpar.P(("data", "fsdp"), None, None)
    assert tuple(tpar.batch_spec(2)) == tuple(jpar.batch_spec(2))


def test_exports_cover_the_reference():
    """ray_tpu_torch.parallel and .ops export every name the JAX package's
    parallel and ops export."""
    from ray_tpu import ops as jops
    from ray_tpu_torch import ops as tops

    assert set(jpar.__all__) <= set(tpar.__all__), set(jpar.__all__) - set(tpar.__all__)
    assert set(jops.__all__) <= set(tops.__all__), set(jops.__all__) - set(tops.__all__)
