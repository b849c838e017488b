"""Client mode (``init(address="tcp://...")``) and the durable KV, on
both packages.

The reference's programs of tests/test_platform.py run once per package:
a second process connects to a TCP head with ``init(address=...)`` and
uses the cluster (tasks, a large result fetched through the object
plane, an actor), and the cluster survives the client's exit. The large
object plane moves 256 MiB each way: a numpy array on ``ray_tpu``, a CPU
tensor on the port. The port's client also puts and gets CPU tensors of
every size class the client path knows, each checked on the cluster and
back: inline below ``INLINE_THRESHOLD`` (100 KiB), inline under
``inline_only`` below ``CLIENT_CHUNK_THRESHOLD`` (4 MiB), and streamed
into the head's store above it, both by direct put to the head's object
agent and, with ``RAY_TPU_TORCH_OBJECT_DIRECT=0``, by ``PUT_CHUNK``
through the hub.

From tests/test_cluster.py: the KV written through one head is read back
by a head restarted on the same store, on both packages.

Cost: one head per test (two CPUs, two pooled workers), one client
process each; the client scripts import only their own package.
"""

import json
import os
import subprocess
import sys

import pytest

import ray_tpu
import ray_tpu_torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTS = [ray_tpu, ray_tpu_torch]
IDS = ["ray_tpu", "ray_tpu_torch"]


def _run_client(script, env=None, timeout=120):
    out = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True,
                         timeout=timeout, env=dict(os.environ, **(env or {})))
    return out


def _head(rt):
    ctx = rt.init(num_cpus=2, max_workers=2, _tcp_hub=True)
    return ctx.address_info["address"]


ROUNDTRIP = """
import sys; sys.path.insert(0, {repo})
import numpy as np
import {rt} as rt
rt.init(address={addr})
@rt.remote
def f(x):
    return x * 2
assert rt.get(f.remote(21)) == 42
@rt.remote
def big():
    return np.ones(300_000)  # shm on the cluster; fetched by the client
assert float(rt.get(big.remote()).sum()) == 300_000.0
@rt.remote
class C:
    def __init__(self): self.n = 0
    def inc(self): self.n += 1; return self.n
c = C.remote()
assert rt.get([c.inc.remote() for _ in range(3)]) == [1, 2, 3]
foreign = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "ray_tpu"))
rt.shutdown()
print("CLIENT_OK", foreign if {rt!r} == "ray_tpu_torch" else [])
"""


@pytest.mark.parametrize("rt", RTS, ids=IDS)
def test_client_connect_roundtrip(rt):
    addr = _head(rt)
    try:
        out = _run_client(ROUNDTRIP.format(repo=json.dumps(REPO), rt=rt.__name__,
                                           addr=json.dumps(addr)))
        assert "CLIENT_OK []" in out.stdout, out.stderr[-2000:]

        @rt.remote
        def alive():
            return True

        assert rt.get(alive.remote(), timeout=30)  # the cluster outlives its client
    finally:
        rt.shutdown()


LARGE_REF = """
import sys; sys.path.insert(0, {repo})
import numpy as np
import ray_tpu as rt
rt.init(address={addr})
n = 256 * 1024 * 1024
ref = rt.put(np.arange(n, dtype=np.uint8))  # wraps mod 256
@rt.remote
def consume(a):
    return (a.nbytes, int(a[0]), int(a[-1]))
assert rt.get(consume.remote(ref)) == (n, 0, (n - 1) % 256)
@rt.remote
def produce():
    return np.full(n, 7, dtype=np.uint8)
back = rt.get(produce.remote())
assert back.nbytes == n and back[0] == 7 and back[-1] == 7
rt.free([ref])
rt.shutdown()
print("CLIENT_BIG_OK")
"""

LARGE_PORT = """
import sys; sys.path.insert(0, {repo})
import torch
import ray_tpu_torch as rt
rt.init(address={addr})
@rt.remote
def consume(t):
    import torch
    return (type(t).__name__, t.dtype == torch.uint8, t.numel(), int(t[0]), int(t[-1]))
@rt.remote
def produce(n):
    import torch
    return torch.full((n,), 7, dtype=torch.uint8)
for n in {sizes}:
    t = torch.arange(n, dtype=torch.int64).remainder(256).to(torch.uint8)
    ref = rt.put(t)
    assert rt.get(consume.remote(ref)) == ("Tensor", True, n, 0, (n - 1) % 256), n
    assert torch.equal(rt.get(ref), t), n
    back = rt.get(produce.remote(n))
    assert isinstance(back, torch.Tensor) and back.numel() == n, n
    assert int(back[0]) == 7 and int(back[-1]) == 7 and back.is_contiguous(), n
    rt.free([ref])
rt.shutdown()
print("CLIENT_BIG_OK")
"""

# below INLINE_THRESHOLD, inline under inline_only, streamed (and 256 MiB)
PORT_SIZES = [1 << 10, 1 << 20, 16 << 20, 256 << 20]


@pytest.mark.parametrize("rt", RTS, ids=IDS)
def test_client_large_object_plane(rt):
    addr = _head(rt)
    try:
        if rt is ray_tpu:
            script = LARGE_REF.format(repo=json.dumps(REPO), addr=json.dumps(addr))
        else:
            script = LARGE_PORT.format(repo=json.dumps(REPO), addr=json.dumps(addr),
                                       sizes=PORT_SIZES)
        out = _run_client(script, timeout=300)
        assert "CLIENT_BIG_OK" in out.stdout, out.stderr[-2000:]
    finally:
        rt.shutdown()


def test_client_tensor_put_relayed_through_the_hub():
    """With the direct object plane off, a streamed put goes PUT_CHUNK by
    PUT_CHUNK through the hub."""
    addr = _head(ray_tpu_torch)
    try:
        script = LARGE_PORT.format(repo=json.dumps(REPO), addr=json.dumps(addr),
                                   sizes=[1 << 20, 16 << 20])
        out = _run_client(script, env={"RAY_TPU_TORCH_OBJECT_DIRECT": "0"})
        assert "CLIENT_BIG_OK" in out.stdout, out.stderr[-2000:]
    finally:
        ray_tpu_torch.shutdown()


@pytest.mark.parametrize("rt", RTS, ids=IDS)
def test_kv_survives_head_restart(rt, tmp_path):
    store = str(tmp_path / "gcs_store")
    rt.init(num_cpus=1, _kv_store_path=store)
    try:
        client = rt._private.worker.get_client()
        client.kv_put(b"durable_key", b"v1")
        client.kv_put(b"temp_key", b"x")
        client.kv_del(b"temp_key")
        client.kv_put(b"durable_key2", b"v2", overwrite=True)
    finally:
        rt.shutdown()
    rt.init(num_cpus=1, _kv_store_path=store)  # the restarted head
    try:
        client = rt._private.worker.get_client()
        got = [client.kv_get(k) for k in (b"durable_key", b"durable_key2", b"temp_key")]
        client.kv_put(b"durable_key3", b"v3")  # written after the recovery
    finally:
        rt.shutdown()
    rt.init(num_cpus=1, _kv_store_path=store)
    try:
        got.append(rt._private.worker.get_client().kv_get(b"durable_key3"))
    finally:
        rt.shutdown()
    assert got == [b"v1", b"v2", None, b"v3"]
