"""``util.collective`` on the port against the JAX package's.

The port's "nccl" group takes the place of the JAX package's "xla" group.
Here its plain path (CPU tensors, the path no card takes) runs on 8 CPU
tensors against ``XlaGroup`` on the 8-device virtual CPU mesh
(tests/conftest.py), fed the same numpy inputs: every op, and every
``ReduceOp`` of allreduce, reduce and reducescatter, in f32 and int32.
int32 results and MIN/MAX are held exactly, f32 sums, products and
averages at rtol 1e-6 (8 positive terms, summed in another order); the
result dtypes must agree too (an int32 AVERAGE is f32 in both).

The "store" group runs the same program in both runtimes over 4 rank
actors (and a coordinator actor each), on the same numpy data: the port's
ranks hand it torch tensors and get torch tensors back, bit-equal to the
JAX package's numpy results. Also: "xla" is refused with an error that
names "nccl", "gloo" stays an alias of "store", and a list of CUDA tensors
that cannot reach NCCL (fake tensors here, where there is no card)
raises. The card's path is in test_torch_cuda.py.

Cost: one runtime per package for the store tests, four CPUs each; XLA
compiles one small program per op, shape and dtype.
"""

import numpy as np
import pytest
import torch

import ray_tpu
import ray_tpu_torch
from ray_tpu.util import collective as ref_col
from ray_tpu.util.collective import types as ref_types
from ray_tpu_torch.util import collective as col
from ray_tpu_torch.util.collective import types

WORLD = 8
OPS = ["SUM", "PRODUCT", "MIN", "MAX", "AVERAGE"]
DTYPES = ["float32", "int32"]
T = 60


@pytest.fixture(scope="module")
def groups():
    ref = ref_col.init_collective_group(WORLD, 0, backend="xla", group_name="torch_parity")
    port = col.init_collective_group(WORLD, 0, backend="nccl", group_name="torch_parity",
                                     devices=["cpu"] * WORLD)
    yield ref, port
    ref_col.destroy_collective_group("torch_parity")
    col.destroy_collective_group("torch_parity")


def _inputs(dtype, shape=(16, 3), seed=0):
    """One array per rank. Positive f32 (no cancellation in a sum of 8);
    int32 in [-3, 3], whose product of 8 stays far inside int32."""
    rng = np.random.default_rng(seed)
    if dtype == "int32":
        return [rng.integers(-3, 4, shape).astype(np.int32) for _ in range(WORLD)]
    return [rng.uniform(0.5, 1.5, shape).astype(np.float32) for _ in range(WORLD)]


def _same(ref_out, port_out, exact):
    assert len(port_out) == len(ref_out) == WORLD
    for r, p in zip(ref_out, port_out):
        r = np.asarray(r)
        assert isinstance(p, torch.Tensor) and p.device.type == "cpu"
        p = p.numpy()
        assert p.dtype == r.dtype and p.shape == r.shape
        if exact:
            np.testing.assert_array_equal(p, r)
        else:
            np.testing.assert_allclose(p, r, rtol=1e-6)


def _exact(dtype, op):
    return dtype == "int32" or op in ("MIN", "MAX")


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("op", OPS)
def test_allreduce_matches_xla_group(groups, op, dtype):
    ref, port = groups
    xs = _inputs(dtype)
    out_ref = ref.allreduce(xs, ref_types.AllReduceOptions(reduceOp=ref_types.ReduceOp[op]))
    out = port.allreduce([torch.from_numpy(x) for x in xs],
                         types.AllReduceOptions(reduceOp=types.ReduceOp[op]))
    _same(out_ref, out, _exact(dtype, op))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("op", OPS)
def test_reduce_matches_xla_group(groups, op, dtype):
    ref, port = groups
    xs = _inputs(dtype, seed=1)
    out_ref = ref.reduce(xs, ref_types.ReduceOptions(reduceOp=ref_types.ReduceOp[op],
                                                     root_rank=5))
    out = port.reduce([torch.from_numpy(x) for x in xs],
                      types.ReduceOptions(reduceOp=types.ReduceOp[op], root_rank=5))
    _same(out_ref, out, _exact(dtype, op))
    # the other ranks keep their input
    np.testing.assert_array_equal(out[0].numpy(), xs[0].astype(out[0].numpy().dtype))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("op", OPS)
def test_reducescatter_matches_xla_group(groups, op, dtype):
    ref, port = groups
    xs = _inputs(dtype, seed=2)
    out_ref = ref.reducescatter(
        xs, ref_types.ReduceScatterOptions(reduceOp=ref_types.ReduceOp[op]))
    out = port.reducescatter([torch.from_numpy(x) for x in xs],
                             types.ReduceScatterOptions(reduceOp=types.ReduceOp[op]))
    _same(out_ref, out, _exact(dtype, op))
    assert out[3].shape == (2, 3)


@pytest.mark.parametrize("dtype", DTYPES)
def test_broadcast_allgather_and_p2p_match_xla_group(groups, dtype):
    ref, port = groups
    xs = _inputs(dtype, shape=(5, 2), seed=3)
    ts = [torch.from_numpy(x) for x in xs]
    _same(ref.broadcast(xs, ref_types.BroadcastOptions(root_rank=3)),
          port.broadcast(ts, types.BroadcastOptions(root_rank=3)), exact=True)
    ag_ref, ag = ref.allgather(xs), port.allgather(ts)
    _same(ag_ref, ag, exact=True)
    assert ag[0].shape == (WORLD, 5, 2)
    # eager p2p: FIFO per destination rank, a copy of what was sent
    port.send([ts[1]], types.SendOptions(dst_rank=2))
    port.send([ts[4]], types.SendOptions(dst_rank=2))
    ref.send([xs[1]], ref_types.SendOptions(dst_rank=2))
    ref.send([xs[4]], ref_types.SendOptions(dst_rank=2))
    got = [port.recv(types.RecvOptions(src_rank=2)) for _ in range(2)]
    want = [ref.recv(ref_types.RecvOptions(src_rank=2)) for _ in range(2)]
    for g, w, sent in zip(got, want, (ts[1], ts[4])):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        assert g.data_ptr() != sent.data_ptr()
    with pytest.raises(RuntimeError, match="no pending p2p message"):
        port.recv(types.RecvOptions(src_rank=1))
    port.barrier()


def test_module_api_and_backends():
    col.init_collective_group(2, 0, group_name="torch_mod_api", devices=["cpu", "cpu"])
    try:
        assert col.is_group_initialized("torch_mod_api")
        assert col.get_group_handle("torch_mod_api").backend == "nccl"  # the default
        assert col.get_rank("torch_mod_api") == 0
        assert col.get_collective_group_size("torch_mod_api") == 2
        out = col.allreduce([torch.ones(2), torch.ones(2)], group_name="torch_mod_api")
        assert out[0].tolist() == [2.0, 2.0]
        with pytest.raises(RuntimeError, match="already initialized"):
            col.init_collective_group(2, 0, group_name="torch_mod_api")
    finally:
        col.destroy_collective_group("torch_mod_api")
    assert not col.is_group_initialized("torch_mod_api")
    with pytest.raises(ValueError, match="'nccl'"):
        col.init_collective_group(2, 0, backend="xla", group_name="torch_xla")
    assert types.Backend("gloo") == types.Backend("store") == "store"
    assert types.Backend("NCCL") == "nccl"
    # the JAX package refuses NCCL as the port refuses XLA
    with pytest.raises(ValueError, match="backend='xla'"):
        ref_types.Backend("nccl")


def test_cuda_tensors_that_cannot_reach_nccl_raise():
    from torch._subclasses.fake_tensor import FakeTensorMode

    group = col.init_collective_group(2, 0, group_name="torch_no_card")
    try:
        with FakeTensorMode():
            fake = [torch.empty(4, device="cuda"), torch.empty(4, device="cuda")]
        for op in (group.allreduce, group.allgather, group.broadcast, group.reduce,
                   group.reducescatter):
            with pytest.raises(RuntimeError, match="cannot reach NCCL"):
                op(fake)
        with pytest.raises(ValueError, match="all on the CPU or all on GPUs"):
            group.allreduce([torch.zeros(4), fake[1]])
        with pytest.raises(ValueError, match="expected 2 per-rank tensors"):
            group.allreduce([torch.zeros(4)])
    finally:
        col.destroy_collective_group("torch_no_card")


# ----------------------------------------------------------- store groups

@pytest.fixture(scope="module")
def runtimes():
    ray_tpu.init(num_cpus=4, max_workers=4, ignore_reinit_error=True)
    ray_tpu_torch.init(num_cpus=4, max_workers=4)
    yield
    ray_tpu_torch.shutdown()
    ray_tpu.shutdown()


STORE_WORLD = 4


def _store_program(rt, group_name):
    """Every store op on 4 rank actors of runtime ``rt``; each rank's
    results as numpy, with the types it got them as."""

    @rt.remote
    class Rank:
        def run(self, pkg, world, rank, group_name, f32, i32):
            import importlib

            import numpy as np

            c = importlib.import_module(f"{pkg}.util.collective")
            t = importlib.import_module(f"{pkg}.util.collective.types")
            if pkg == "ray_tpu_torch":
                import torch

                f32, i32 = torch.from_numpy(f32), torch.from_numpy(i32)
            g = c.init_collective_group(world, rank, backend="gloo", group_name=group_name)
            out = {}
            try:
                for op in ("SUM", "PRODUCT", "MIN", "MAX", "AVERAGE"):
                    red = t.ReduceOp[op]
                    out[f"allreduce_{op}_f32"] = g.allreduce(f32, t.AllReduceOptions(reduceOp=red))
                    out[f"allreduce_{op}_i32"] = g.allreduce(i32, t.AllReduceOptions(reduceOp=red))
                    out[f"reducescatter_{op}"] = g.reducescatter(
                        f32, t.ReduceScatterOptions(reduceOp=red))
                out["reduce"] = g.reduce(f32, t.ReduceOptions(root_rank=2))
                out["broadcast"] = g.broadcast(i32, t.BroadcastOptions(root_rank=1))
                out["allgather"] = g.allgather(f32)
                g.barrier()
                if rank == 0:
                    g.send(f32 * 3, t.SendOptions(dst_rank=3))
                if rank == 3:
                    out["recv"] = g.recv(t.RecvOptions(src_rank=0))
            finally:
                c.destroy_collective_group(group_name)
            kinds = sorted({type(v).__module__.split(".")[0] for v in out.values()})
            return {k: np.asarray(v) for k, v in out.items()}, kinds

    data = []
    for r in range(STORE_WORLD):
        rng = np.random.default_rng(10 + r)
        data.append((rng.standard_normal((8, 3)).astype(np.float32),
                     rng.integers(-5, 6, (8, 3)).astype(np.int32)))
    ranks = [Rank.remote() for _ in range(STORE_WORLD)]
    try:
        return rt.get([a.run.remote(rt.__name__, STORE_WORLD, r, group_name, *data[r])
                       for r, a in enumerate(ranks)], timeout=T)
    finally:
        for a in ranks:
            rt.kill(a)


def test_store_group_bit_equal_in_both_runtimes(runtimes):
    ref = _store_program(ray_tpu, "torch_store_parity")
    port = _store_program(ray_tpu_torch, "torch_store_parity")
    for rank, ((want, ref_kinds), (got, kinds)) in enumerate(zip(ref, port)):
        assert ref_kinds == ["numpy"] and kinds == ["torch"], (ref_kinds, kinds)
        assert sorted(got) == sorted(want)
        for key in want:
            assert got[key].dtype == want[key].dtype, (rank, key)
            assert got[key].tobytes() == want[key].tobytes(), (rank, key)
    assert "recv" in port[3][0] and port[3][0]["recv"].shape == (8, 3)


def test_store_group_coordinator_carries_the_port_prefix(runtimes):
    @ray_tpu_torch.remote
    def join(rank):
        from ray_tpu_torch.util import collective as c

        c.init_collective_group(2, rank, backend="store", group_name="torch_store_name")
        try:
            import torch

            return c.allgather(torch.tensor([rank], dtype=torch.int64),
                               group_name="torch_store_name").tolist()
        finally:
            c.destroy_collective_group("torch_store_name")

    assert ray_tpu_torch.get([join.remote(r) for r in range(2)], timeout=T) == [[[0], [1]]] * 2
    coord = ray_tpu_torch.get_actor("__ray_tpu_torch_collective_torch_store_name_w2")
    ray_tpu_torch.kill(coord)
