"""The port's Serve against the reference's, side by side.

Each program below runs once on ``ray_tpu.serve`` and once on
``ray_tpu_torch.serve``, both runtimes up at once in this process, and
the two results must be equal. The programs are taken from
test_serve.py (basic, function and class deployments, init args and
methods, two replicas round-robin, composition, ``@serve.batch``,
redeploy, status and delete, local testing mode, the HTTP ingress
through aiohttp), test_serve_payloads.py (a large request spills and
arrives as a memoryview while a small one stays inline, an ndarray
spills with dtype and shape kept, the members of a batch share one
fetch) and test_serve_resilience.py (shedding past the queue cap, a
request deadline bounding ``result()``). A CPU torch tensor takes the
ndarray's path in the port: it spills and arrives with dtype and shape
kept.

Cost: one runtime per package for the whole file, two CPUs and two
pooled workers each; Serve is shut down after every program; every
result and get has a timeout. Deployments are defined inside the
programs, so that they are pickled by value and no worker imports this
module.
"""

import hashlib
import threading
import time

import numpy as np
import pytest
import torch

import ray_tpu
import ray_tpu_torch
from ray_tpu import serve as ref_serve
from ray_tpu_torch import serve as port_serve

T = 60  # seconds: the timeout of every result that should arrive
BIG = 1024 * 1024  # above the 64 KiB inline threshold: spills
SMALL = 1024  # stays inline


@pytest.fixture(scope="module")
def runtimes():
    ray_tpu.init(num_cpus=2, max_workers=2, ignore_reinit_error=True)
    ray_tpu_torch.init(num_cpus=2, max_workers=2)
    yield
    ray_tpu_torch.shutdown()
    ray_tpu.shutdown()


def both(program, *args):
    """(reference's result, port's result) of one program, Serve shut
    down after each run."""
    out = []
    for rt, serve in ((ray_tpu, ref_serve), (ray_tpu_torch, port_serve)):
        try:
            out.append(program(rt, serve, *args))
        finally:
            serve.shutdown()
    return out


# ------------------------------------------------------------ test_serve.py
def basic_function_and_methods(rt, serve):
    @serve.deployment
    class Echo:
        def __call__(self, x):
            return {"echo": x}

    @serve.deployment
    def double(x):
        return x * 2

    @serve.deployment
    class Counter:
        def __init__(self, start):
            self.n = start

        def incr(self, by):
            self.n += by
            return self.n

    return (serve.run(Echo.bind()).remote("hi").result(timeout_s=T),
            serve.run(double.bind()).remote(21).result(timeout_s=T),
            serve.run(Counter.bind(10)).incr.remote(5).result(timeout_s=T))


def two_replicas_round_robin(rt, serve):
    @serve.deployment(num_replicas=2)
    class WhoAmI:
        def __call__(self, _):
            import os

            return os.getpid()

    handle = serve.run(WhoAmI.bind())
    return len({handle.remote(None).result(timeout_s=T) for _ in range(16)})


def composition(rt, serve):
    @serve.deployment
    class Adder:
        def __init__(self, amount):
            self.amount = amount

        def __call__(self, x):
            return x + self.amount

    @serve.deployment
    class Pipeline:
        def __init__(self, a, b):
            self.a = a
            self.b = b

        def __call__(self, x):
            y = self.a.remote(x).result(timeout_s=60)
            return self.b.remote(y).result(timeout_s=60)

    app = Pipeline.bind(Adder.bind(1), Adder.options(name="Adder2").bind(10))
    return serve.run(app).remote(0).result(timeout_s=T)


def batching(rt, serve):
    @serve.deployment(max_ongoing_requests=32)
    class Batched:
        @serve.batch(max_batch_size=8, batch_wait_timeout_s=0.2)
        async def __call__(self, items):
            n = len(items)
            return [{"value": x * 2, "batch_size": n} for x in items]

    handle = serve.run(Batched.bind())
    results = [r.result(timeout_s=T) for r in [handle.remote(i) for i in range(8)]]
    return [r["value"] for r in results], max(r["batch_size"] for r in results) > 1


def redeploy(rt, serve):
    @serve.deployment
    class V:
        def __call__(self, _):
            return 1

    first = serve.run(V.bind()).remote(None).result(timeout_s=T)

    @serve.deployment(name="V")
    class V2:
        def __call__(self, _):
            return 2

    handle = serve.run(V2.bind())
    deadline = time.time() + 20
    while time.time() < deadline and handle.remote(None).result(timeout_s=T) != 2:
        time.sleep(0.2)
    return first, handle.remote(None).result(timeout_s=T)


def status_and_delete(rt, serve):
    @serve.deployment(num_replicas=1)
    class S:
        def __call__(self, _):
            return "ok"

    serve.run(S.bind())
    before = serve.status()["applications"]["S"]
    serve.delete("S")
    deadline = time.time() + 10
    while time.time() < deadline and "S" in serve.status()["applications"]:
        time.sleep(0.1)
    return before, "S" in serve.status()["applications"]


@pytest.mark.parametrize("program", [basic_function_and_methods, two_replicas_round_robin,
                                     composition, batching, redeploy, status_and_delete])
def test_serve_programs_agree(runtimes, program):
    ref, port = both(program)
    assert ref == port


def local_testing_mode(serve):
    @serve.deployment
    class Embedder:
        def __call__(self, x):
            return x * 2

    @serve.deployment
    class Head:
        def __init__(self, embedder):
            self.embedder = embedder

        def __call__(self, x):
            return self.embedder.remote(x).result() + 1

        async def agen(self, n):
            return [i for i in range(n)]

        def stream(self, n):
            for i in range(n):
                yield i * 10

        @serve.multiplexed(max_num_models_per_replica=2)
        def get_model(self, mid):
            return mid.upper()

        def which_model(self):
            return self.get_model(serve.get_multiplexed_model_id())

    h = serve.run(Head.bind(Embedder.bind()), local_testing_mode=True)

    @serve.deployment
    def boom():
        raise ValueError("nope")

    resp = serve.run(boom.bind(), local_testing_mode=True).remote()
    try:
        resp.result()
        raised = None
    except ValueError as e:
        raised = str(e)
    return (h.remote(10).result(), h.agen.remote(3).result(),
            list(h.options(stream=True).stream.remote(3)),
            h.options(multiplexed_model_id="ma").which_model.remote().result(), raised)


def test_local_testing_mode_agrees():
    # in-process: no runtime, no controller, no actors
    assert local_testing_mode(ref_serve) == local_testing_mode(port_serve) == (
        21, [0, 1, 2], [0, 10, 20], "MA", "nope")


def http_ingress(rt, serve, port):
    import json
    import urllib.request

    @serve.deployment
    class App:
        def __call__(self, request):
            return {"path": request["path"], "method": request["method"]}

    serve.run(App.bind(), route_prefix="/api", http_options={"port": port})
    deadline = time.time() + 15
    last = None
    while time.time() < deadline:
        try:
            with urllib.request.urlopen(f"http://127.0.0.1:{port}/api/x", timeout=5) as r:
                return json.loads(r.read())
        except Exception as e:  # the route table refreshes ~1 s after serve.run
            last = e
            time.sleep(0.3)
    return repr(last)


def test_http_ingress_agrees(runtimes):
    ref = http_ingress(ray_tpu, ref_serve, 18971)
    ref_serve.shutdown()
    try:
        port = http_ingress(ray_tpu_torch, port_serve, 18972)
    finally:
        port_serve.shutdown()
    assert ref == port == {"path": "/api/x", "method": "GET"}


# --------------------------------------------------- test_serve_payloads.py
def large_and_small_requests(rt, serve):
    @serve.deployment
    class TypeProbe:
        def __call__(self, x):
            import hashlib

            import numpy as np

            body = x["body"] if isinstance(x, dict) else x
            if isinstance(body, (bytes, bytearray, memoryview)):
                return type(body).__name__, len(body), hashlib.sha1(body).hexdigest()
            if isinstance(body, np.ndarray):
                return (type(body).__name__, str(body.dtype), list(body.shape),
                        float(body.sum()))
            return type(body).__name__, -1, ""

    handle = serve.run(TypeProbe.bind())
    big = np.random.default_rng(0).bytes(BIG)
    small = big[:SMALL]
    arr = np.arange(512 * 600, dtype=np.float32).reshape(512, 600)  # ~1.2 MB
    return (handle.remote(big).result(timeout_s=T), handle.remote(small).result(timeout_s=T),
            handle.remote({"method": "POST", "body": big}).result(timeout_s=T),
            handle.remote(arr).result(timeout_s=T),
            hashlib.sha1(big).hexdigest(), hashlib.sha1(small).hexdigest())


def test_large_requests_spill_small_stay_inline(runtimes):
    ref, port = both(large_and_small_requests)
    assert ref == port
    (kind, n, digest), small, body, arr, want, want_small = port
    assert (kind, n, digest) == ("memoryview", BIG, want)
    assert small == ("bytes", SMALL, want_small)
    assert body == ("memoryview", BIG, want)
    assert arr == ("ndarray", "float32", [512, 600],
                   float(np.arange(512 * 600, dtype=np.float32).sum()))


def batch_members_share_one_fetch(rt, serve):
    payloads = f"{rt.__name__}.serve._private.payloads"

    @serve.deployment
    class BatchProbe:
        @serve.batch(max_batch_size=8, batch_wait_timeout_s=2.0)
        async def __call__(self, items):
            import importlib

            fetches = importlib.import_module(payloads).FETCH_CALLS
            return [{"batch": len(items), "fetches": fetches, "n": len(it["body"])}
                    for it in items]

        def fetches(self):
            import importlib

            return importlib.import_module(payloads).FETCH_CALLS

    handle = serve.run(BatchProbe.bind())
    before = handle.fetches.remote().result(timeout_s=T)
    results = [None] * 8
    body = np.random.default_rng(1).bytes(BIG)

    def one(i):
        results[i] = handle.remote({"body": body}).result(timeout_s=T)

    threads = [threading.Thread(target=one, args=(i,)) for i in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(T)
    after = handle.fetches.remote().result(timeout_s=T)
    batches = {(r["batch"], r["fetches"]) for r in results if r is not None}
    return (all(r is not None and r["n"] == BIG for r in results),
            sum(b for b, _ in batches) == 8, after - before == len(batches), len(batches) < 8)


def test_batch_members_share_one_fetch(runtimes):
    ref, port = both(batch_members_share_one_fetch)
    assert ref == port == (True, True, True, True)


def test_cpu_tensor_spills_with_dtype_and_shape(runtimes):
    """The port's counterpart of the ndarray spill: a CPU tensor above
    the threshold rides the payload plane (one fetch in the replica) and
    arrives as a tensor of the same dtype, shape and values; bf16, which
    numpy lacks, included."""
    serve = port_serve

    @serve.deployment
    class TensorProbe:
        def __call__(self, t):
            from ray_tpu_torch.serve._private import payloads

            return (type(t).__name__, str(t.dtype), list(t.shape), float(t.double().sum()),
                    payloads.FETCH_CALLS)

        def fetches(self):
            from ray_tpu_torch.serve._private import payloads

            return payloads.FETCH_CALLS

    try:
        handle = serve.run(TensorProbe.bind())
        arr = np.arange(512 * 600, dtype=np.float32).reshape(512, 600)
        seen = []
        for t in (torch.from_numpy(arr), torch.from_numpy(arr).bfloat16(),
                  torch.from_numpy(arr).t()):  # the last one not contiguous
            before = handle.fetches.remote().result(timeout_s=T)
            kind, dtype, shape, total, fetches = handle.remote(t).result(timeout_s=T)
            seen.append((kind, dtype, shape, total == float(t.double().sum()),
                         fetches - before))
        small = handle.remote(torch.ones(4, 4)).result(timeout_s=T)
    finally:
        serve.shutdown()
    assert seen == [("Tensor", "torch.float32", [512, 600], True, 1),
                    ("Tensor", "torch.bfloat16", [512, 600], True, 1),
                    ("Tensor", "torch.float32", [600, 512], True, 1)]
    assert small[:4] == ("Tensor", "torch.float32", [4, 4], 16.0)


# ------------------------------------------------- test_serve_resilience.py
def _serve_rows(rt, name):
    """Sum of the hub's serve metric rows of deployment ``name``."""
    client = __import__(f"{rt.__name__}._private.worker", fromlist=["w"]).get_client()
    out = {}
    for row in client.list_state("serve"):
        if row["deployment"] == name:
            for k, v in row.items():
                if isinstance(v, (int, float)):
                    out[k] = out.get(k, 0) + v
    return out


def shed_past_queue_cap(rt, serve):
    @serve.deployment(max_queued_requests=2)
    class Slow:
        def __call__(self, x):
            import time

            time.sleep(1.0)
            return x

    handle = serve.run(Slow.bind())
    warm = handle.remote(0).result(timeout_s=T)
    admitted, shed = [], []
    for i in range(6):
        try:
            admitted.append(handle.remote(i))
        except rt.exceptions.RequestShedError as e:
            shed.append(e)
    first = shed[0] if shed else None
    results = [r.result(timeout_s=T) for r in admitted]
    deadline = time.time() + 15
    rows = {}
    while time.time() < deadline:
        rows = _serve_rows(rt, "Slow")
        if rows.get("shed_total", 0) >= len(shed):
            break
        time.sleep(0.2)
    return (warm, bool(shed), len(admitted) <= 2, results == list(range(len(admitted))),
            first is not None and (first.deployment, first.cap, first.queued >= 2),
            rows.get("shed_total", 0) >= len(shed),
            rows.get("requests_total") == 1 + len(admitted),
            rows.get("dropped_requests_total", 0), rows.get("drained_requests_total", 0))


def test_shed_past_queue_cap(runtimes):
    ref, port = both(shed_past_queue_cap)
    assert ref == port == (0, True, True, True, ("Slow", 2, True), True, True, 0, 0)


def request_deadline_bounds_result(rt, serve):
    @serve.deployment
    class Sleepy:
        def __call__(self, s):
            import time

            time.sleep(s)
            return "done"

    handle = serve.run(Sleepy.bind())
    warm = handle.remote(0).result(timeout_s=T)
    t0 = time.monotonic()
    resp = handle.options(request_timeout_s=0.4).remote(5.0)
    try:
        resp.result()
        raised = None
    except rt.exceptions.GetTimeoutError as e:
        raised = type(e).__name__
    elapsed = time.monotonic() - t0
    return warm, raised, elapsed < 3.0, handle.remote(0).result(timeout_s=T)


def test_request_deadline_bounds_result(runtimes):
    ref, port = both(request_deadline_bounds_result)
    assert ref == port == ("done", "GetTimeoutError", True, "done")
