"""Torch tensors through the port's object store, on the CPU.

Round trips through ``put``/``get``, task arguments and returns, and
actor calls, for f32, bf16 (no numpy dtype), int64, a non-contiguous
tensor, a zero-size tensor and one above the inline threshold (which
lands in shared memory). A 64 MiB tensor's pickle header stays small: its
bytes travel out of band. A CUDA tensor's ``get`` in a process that sees
no GPU raises and names the device; here the device check of the writer
is monkeypatched, since this machine has no card.

Cost: one runtime for the whole file, two CPUs and two pooled workers;
every get has a timeout.
"""

import pickle

import numpy as np
import pytest
import torch

import ray_tpu_torch as rt
from ray_tpu_torch._private import serialization
from ray_tpu_torch._private.object_store import INLINE_THRESHOLD
from ray_tpu_torch.exceptions import TaskError

T = 60


def _cases():
    g = torch.Generator().manual_seed(0)
    big = torch.randn(INLINE_THRESHOLD // 4 + 4096, generator=g)  # > inline threshold
    return {
        "f32": torch.randn(3, 5, generator=g),
        "bf16": torch.randn(4, 7, generator=g).to(torch.bfloat16),
        "int64": torch.arange(-5, 30, dtype=torch.int64).reshape(5, 7),
        "non_contiguous": torch.randn(6, 4, generator=g).t()[:, ::2],
        "zero_size": torch.empty(0, 3, dtype=torch.float16),
        "scalar": torch.tensor(2.5, dtype=torch.float64),
        "above_inline": big,
    }


CASES = _cases()


@pytest.fixture(scope="module")
def runtime():
    rt.init(num_cpus=2, max_workers=2)
    yield
    rt.shutdown()


def _same(got, want):
    assert isinstance(got, torch.Tensor) and got.device.type == "cpu"
    assert got.dtype == want.dtype and got.shape == want.shape
    assert got.is_contiguous()
    assert torch.equal(got, want)


@pytest.mark.parametrize("name", list(CASES))
def test_serialization_round_trip(name):
    t = CASES[name]
    header, buffers = serialization.dumps_oob({"t": t})
    got = serialization.loads_oob(header, [b.raw() for b in buffers])["t"]
    _same(got, t)
    assert got.stride() == t.contiguous().stride()
    assert sum(b.raw().nbytes for b in buffers) == t.numel() * t.element_size()
    _same(serialization.loads_inline(serialization.dumps_inline(t)), t)


def test_a_64_mib_tensor_goes_out_of_band():
    t = torch.zeros(16 * 2**20, dtype=torch.float32)
    header, buffers = serialization.dumps_oob(t)
    assert len(header) < 512
    assert [b.raw().nbytes for b in buffers] == [64 * 2**20]
    # and the bytes are the tensor's own, not a copy made for pickling
    assert np.shares_memory(np.asarray(buffers[0].raw()), t.numpy())


def test_parameter_and_requires_grad_round_trip():
    p = torch.nn.Parameter(torch.randn(3))
    got = pickle.loads(serialization.dumps_inline(p)[1:])
    assert type(got) is torch.nn.Parameter and got.requires_grad
    assert torch.equal(got.detach(), p.detach())
    x = torch.randn(2, requires_grad=True)
    got = serialization.loads_inline(serialization.dumps_inline(x))
    assert got.requires_grad and got.is_leaf


@pytest.fixture(scope="module")
def holder(runtime):
    """One actor for every case: a new actor process imports torch anew."""

    @rt.remote
    class Holder:
        def put(self, x):
            self.x = x
            return x

        def add(self, y):
            return self.x + y

    h = Holder.remote()
    yield h
    rt.kill(h)


@pytest.mark.parametrize("name", list(CASES))
def test_put_get_task_and_actor(runtime, holder, name):
    # defined here, not at module level, so that workers pickle them by
    # value and never import this file
    @rt.remote
    def echo(x):
        return x

    @rt.remote
    def double(x):
        return x * 2

    t = CASES[name]
    want = t.contiguous()
    ref = rt.put(t)
    _same(rt.get(ref, timeout=T), want)
    # a task fetching the put object, an argument passed inline or
    # spilled, and a return value
    _same(rt.get(echo.remote(ref), timeout=T), want)
    _same(rt.get(echo.remote(t), timeout=T), want)
    _same(rt.get(double.remote(t), timeout=T), want * 2)
    # an actor call's argument and return value, and an ObjectRef argument
    _same(rt.get(holder.put.remote(t), timeout=T), want)
    _same(rt.get(holder.add.remote(ref), timeout=T), want + want)


def test_cuda_tensor_get_raises_without_a_gpu(runtime, monkeypatch):
    # pretend the writer's tensor lives on a card: it is then stored as a
    # CUDA tensor (staged through the host) and must come back on a card
    monkeypatch.setattr(serialization, "_on_cuda", lambda t: True)
    t = torch.arange(8, dtype=torch.float32)
    header, buffers = serialization.dumps_oob(t)
    with pytest.raises(RuntimeError, match="CUDA tensor.*sees no GPU"):
        serialization.loads_oob(header, [b.raw() for b in buffers])
    ref = rt.put(t)

    @rt.remote(num_gpus=0)
    def fetch(refs):
        return rt.get(refs[0], timeout=30)

    with pytest.raises(TaskError) as info:
        rt.get(fetch.remote([ref]), timeout=T)
    assert isinstance(info.value.cause, RuntimeError)
    assert "CUDA tensor" in str(info.value.cause)
    assert "sees no GPU" in str(info.value.cause)
