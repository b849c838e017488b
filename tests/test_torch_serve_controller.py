"""The port's Serve controller with a replica that is slow to build and
one that stops answering, both pinned to a GPU.

The reference's health sweep (``ray_tpu/serve/_private/controller.py``)
waits 5 s a round for every replica's stats and gives a replica up after
three misses in a row, without killing it, then starts another. A
replica whose constructor outlasts three sweeps (about 15.75 s; a model
loading onto its card) is therefore built twice, in two processes, and
the abandoned one keeps its pinned GPU, so that on a one-GPU node the
second cannot be placed. The port counts misses only once a replica has
answered a ping (Ray Serve health-checks running replicas only), and
kills a replica it gives up on, so that its GPU returns to the pool.

Cost: one port runtime with one GPU given by ``RAY_TPU_TORCH_NUM_GPUS``
(set only around ``init``); about 40 s, most of it the sweeps' own
waits. Every result has a timeout.
"""

import os
import time

import pytest

import ray_tpu_torch
from ray_tpu_torch import serve

T = 60


@pytest.fixture(scope="module")
def one_gpu():
    os.environ["RAY_TPU_TORCH_NUM_GPUS"] = "1"
    try:
        ray_tpu_torch.init(num_cpus=2, max_workers=2)
    finally:
        del os.environ["RAY_TPU_TORCH_NUM_GPUS"]
    yield
    serve.shutdown()
    ray_tpu_torch.shutdown()


def _alive(pid):
    try:
        with open(f"/proc/{pid}/status") as f:
            return "\nState:\tZ" not in f.read()
    except OSError:
        return False


def _constructions(path):
    with open(path) as f:
        return [int(line) for line in f]


def test_replica_slower_than_three_sweeps_is_built_once(one_gpu, tmp_path):
    log = str(tmp_path / "constructions")

    @serve.deployment(ray_actor_options={"num_gpus": 1})
    class Slow:
        def __init__(self, log, seconds):
            import os
            import time

            with open(log, "a") as f:
                f.write(f"{os.getpid()}\n")
            time.sleep(seconds)

        def __call__(self):
            import os

            return os.getpid(), os.environ.get("CUDA_VISIBLE_DEVICES")

    try:
        t0 = time.monotonic()
        handle = serve.run(Slow.bind(log, 17.0))
        pid, visible = handle.remote().result(timeout_s=T)
        waited = time.monotonic() - t0
        assert waited > 17.0
        assert visible == "0"
        # a fresh handle routes to the replica the controller holds: the
        # same one (given up on, it would be a second replica that waits
        # for the GPU the first still pins)
        again = serve.get_deployment_handle("Slow").remote().result(timeout_s=10)
        assert again == (pid, "0")
        assert _constructions(log) == [pid]
        assert serve.status()["applications"]["Slow"]["live_replicas"] == 1
    finally:
        serve.delete("Slow")


def test_replica_given_up_on_is_killed_and_its_gpu_reused(one_gpu, tmp_path):
    log = str(tmp_path / "constructions")

    @serve.deployment(max_ongoing_requests=1, ray_actor_options={"num_gpus": 1})
    class Stuck:
        def __init__(self, log):
            import os

            with open(log, "a") as f:
                f.write(f"{os.getpid()}\n")

        def pid(self):
            import os

            return os.getpid(), os.environ.get("CUDA_VISIBLE_DEVICES")

        def hang(self):
            import time

            time.sleep(120)

    handle = serve.run(Stuck.bind(log))
    first, visible = handle.pid.remote().result(timeout_s=T)
    assert visible == "0"
    time.sleep(1.0)  # the controller's pings have been answered
    # max_concurrency is max(2, max_ongoing_requests): two hanging calls
    # leave no thread for the controller's pings
    hung = [handle.hang.remote() for _ in range(2)]
    deadline = time.monotonic() + 45
    second = first
    while second == first and time.monotonic() < deadline:
        try:
            second, visible = handle.pid.remote().result(timeout_s=10)
        except Exception:
            time.sleep(0.5)
    assert second != first, "the unresponsive replica was not replaced"
    assert visible == "0"  # the killed replica's GPU, pinned again
    assert _constructions(log) == [first, second]
    deadline = time.monotonic() + 10
    while _alive(first) and time.monotonic() < deadline:
        time.sleep(0.1)
    assert not _alive(first)
    del hung
