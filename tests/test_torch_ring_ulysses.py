"""Ring and Ulysses attention of the port (``ops/ring_attention.py``,
``ops/ulysses.py``) over a ``seq`` mesh of gloo ranks on the CPU, against
the JAX package's naive attention and its ``ring_attention_sharded`` /
``ulysses_attention`` under ``shard_map`` on the same seeded numpy inputs.

Each rank takes its block of the sequence; outputs and the gradients of
sum(o * g) for a seeded cotangent g are gathered whole and held against
``jax.grad`` of the naive attention. Cases: causal and not, GQA (4 query
heads on 2 KV heads) and MHA, on 2 and 4 ranks (ring) and 2 (Ulysses),
and Ulysses's refusal of KV heads that do not divide the degree. The
ring's whole-tensor wrapper (``ring_attention_sharded``) gives the whole
output and the whole dq on every rank.

Tolerances (f32): outputs atol 2e-5, gradients atol 5e-5, the port's
attention parity (test_torch_attention.py); the JAX ring and Ulysses are
held to the naive attention at 1e-4 by the reference's own tests.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as JP

import torch_mesh_ranks as ranks
from ray_tpu.ops import ring_attention_sharded, ulysses_attention

O_ATOL = 2e-5
GRAD_ATOL = 5e-5

SHAPES = {"gqa": (2, 64, 4, 2, 16), "mha": (1, 64, 2, 2, 16)}
CASES = [{"tag": f"{kind}_{'causal' if causal else 'full'}", "causal": causal, "kind": kind}
         for kind in ("gqa", "mha") for causal in (True, False)]


def naive_attention(q, k, v, causal=True):
    B, S, H, hd = q.shape
    KVH = k.shape[2]
    qg = q.reshape(B, S, KVH, H // KVH, hd)
    logits = jnp.einsum("bqkgh,btkh->bqkgt", qg, k) / np.sqrt(hd)
    if causal:
        mask = jnp.tril(jnp.ones((S, k.shape[1]), bool))
        logits = jnp.where(mask[None, :, None, None, :], logits, -jnp.inf)
    p = jax.nn.softmax(logits, axis=-1)
    return jnp.einsum("bqkgt,btkh->bqkgh", p, v).reshape(B, S, H, hd)


def _inputs(path):
    rng = np.random.default_rng(0)
    arrays = {}
    for c in CASES:
        B, S, H, KVH, hd = SHAPES[c["kind"]]
        for n, shape in (("q", (B, S, H, hd)), ("k", (B, S, KVH, hd)), ("v", (B, S, KVH, hd)),
                         ("g", (B, S, H, hd))):
            arrays[f"{c['tag']}/{n}"] = rng.standard_normal(shape).astype(np.float32)
    np.savez(path / "qkv.npz", **arrays)
    return arrays


def _reference(arrays, tag, causal):
    q, k, v, g = (jnp.asarray(arrays[f"{tag}/{n}"]) for n in ("q", "k", "v", "g"))
    o, vjp = jax.vjp(lambda q, k, v: naive_attention(q, k, v, causal), q, k, v)
    dq, dk, dv = vjp(g)
    return {"o": o, "dq": dq, "dk": dk, "dv": dv}


def _check(got, ref):
    np.testing.assert_allclose(got["o"].numpy(), np.asarray(ref["o"]), atol=O_ATOL)
    for n in ("dq", "dk", "dv"):
        np.testing.assert_allclose(got[n].numpy(), np.asarray(ref[n]), atol=GRAD_ATOL,
                                   err_msg=n)


@pytest.fixture(scope="module", params=[2, 4], ids=["ring2", "ring4"])
def ring_run(request, tmp_path_factory):
    d = tmp_path_factory.mktemp(f"ring{request.param}")
    arrays = _inputs(d)
    outs = ranks.launch("ring", request.param, d, cases=CASES, sharded=True)
    return request.param, arrays, outs


@pytest.mark.parametrize("case", CASES, ids=[c["tag"] for c in CASES])
def test_ring_matches_naive_with_grads(ring_run, case):
    degree, arrays, outs = ring_run
    ref = _reference(arrays, case["tag"], case["causal"])
    for o in outs:
        _check(o[case["tag"]], ref)
    # the JAX ring on the same inputs agrees with the same reference
    mesh = Mesh(np.asarray(jax.devices()[:degree]), ("seq",))
    q, k, v = (jnp.asarray(arrays[f"{case['tag']}/{n}"]) for n in "qkv")
    jring = ring_attention_sharded(q, k, v, mesh, causal=case["causal"], block_q=16,
                                   block_kv=16)
    np.testing.assert_allclose(outs[0][case["tag"]]["o"].numpy(), np.asarray(jring), atol=1e-4)


def test_ring_attention_sharded_gives_the_whole(ring_run):
    """The whole-tensor wrapper: every rank gets the whole output and the
    whole dq of its replicated q."""
    _, arrays, outs = ring_run
    tag = CASES[0]["tag"]
    ref = _reference(arrays, tag, CASES[0]["causal"])
    for o in outs:
        np.testing.assert_allclose(o["sharded"]["o"].numpy(), np.asarray(ref["o"]), atol=O_ATOL)
        np.testing.assert_allclose(o["sharded"]["dq"].numpy(), np.asarray(ref["dq"]),
                                   atol=GRAD_ATOL)


@pytest.fixture(scope="module")
def ulysses_run(tmp_path_factory):
    d = tmp_path_factory.mktemp("ulysses")
    arrays = _inputs(d)
    return arrays, ranks.launch("ulysses", 2, d, cases=CASES)


@pytest.mark.parametrize("case", CASES, ids=[c["tag"] for c in CASES])
def test_ulysses_matches_naive_with_grads(ulysses_run, case):
    arrays, outs = ulysses_run
    ref = _reference(arrays, case["tag"], case["causal"])
    for o in outs:
        _check(o[case["tag"]], ref)
    mesh = Mesh(np.asarray(jax.devices()[:2]), ("seq",))
    fn = shard_map(lambda a, b, c: ulysses_attention(a, b, c, causal=case["causal"]),
                   mesh=mesh, in_specs=(JP(None, "seq"),) * 3, out_specs=JP(None, "seq"),
                   check_vma=False)
    q, k, v = (jnp.asarray(arrays[f"{case['tag']}/{n}"]) for n in "qkv")
    np.testing.assert_allclose(outs[0][case["tag"]]["o"].numpy(), np.asarray(jax.jit(fn)(q, k, v)),
                               atol=1e-4)


def test_ulysses_head_divisibility_enforced(tmp_path):
    """KV heads 2 on 4 ranks: refused with the reference's message, on
    every rank, before any collective."""
    arrays = _inputs(tmp_path)
    case = [c for c in CASES if c["kind"] == "gqa"][:1]
    outs = ranks.launch("ulysses", 4, tmp_path, cases=case)
    mesh = Mesh(np.asarray(jax.devices()[:4]), ("seq",))
    fn = shard_map(lambda a, b, c: ulysses_attention(a, b, c), mesh=mesh,
                   in_specs=(JP(None, "seq"),) * 3, out_specs=JP(None, "seq"), check_vma=False)
    q, k, v = (jnp.asarray(arrays[f"{case[0]['tag']}/{n}"]) for n in "qkv")
    with pytest.raises(ValueError, match="n_kv_heads") as jerr:
        jax.jit(fn)(q, k, v)
    for o in outs:
        assert "n_kv_heads 2 must divide by seq-parallel degree 4" in o[case[0]["tag"]]["error"]
        assert o[case[0]["tag"]]["error"].split(";")[0] in str(jerr.value)
