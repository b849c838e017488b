"""The rest of ``util/`` on the port: the reference's programs for the
distributed queue, ``Pool`` (two programs), ``ActorGroup`` and the joblib
backend (tests/test_platform.py, tests/test_small_components.py), with the
same assertions, and ``util.accelerators.gpu``, the counterpart of the
TPU pod helpers: the node's GPU count as the runtime detects it and the
card's name from ``nvidia-smi -L`` (a stand-in script on ``PATH`` here).

Cost: one runtime for the file, two CPUs and two pooled workers; remote
code is defined inside the tests, so no worker imports this module.
"""

import os
import stat

import pytest

import ray_tpu_torch


@pytest.fixture(scope="module")
def rt():
    ray_tpu_torch.init(num_cpus=2, max_workers=2)
    yield ray_tpu_torch
    ray_tpu_torch.shutdown()


def test_util_queue(rt):
    from ray_tpu_torch.util.queue import Empty, Full, Queue

    q = Queue(maxsize=2)
    q.put("a")
    q.put("b")
    with pytest.raises(Full):
        q.put("c", block=False)
    assert q.qsize() == 2 and q.full()
    assert q.get() == "a"
    assert q.get() == "b"
    assert q.empty()
    with pytest.raises(Empty):
        q.get(block=False)
    with pytest.raises(Empty):
        q.get(timeout=0.2)
    q.shutdown()


def test_actor_group(rt):
    from ray_tpu_torch.util.actor_group import ActorGroup

    class Member:
        def __init__(self, base):
            self.base = base

        def add(self, x):
            return self.base + x

    grp = ActorGroup(Member, 3, init_args=(100,))
    assert grp.execute("add", 5) == [105, 105, 105]
    assert grp.execute_single(1, "add", 1) == 101
    grp.restart_actor(0)
    assert grp.execute("add", 2) == [102, 102, 102]
    grp.shutdown()


def test_multiprocessing_pool(rt):
    from ray_tpu_torch.util.multiprocessing import Pool

    def square(x):
        return x * x

    def add(a, b):
        return a + b

    with Pool() as pool:
        assert pool.map(square, range(6)) == [0, 1, 4, 9, 16, 25]
        assert pool.starmap(add, [(1, 2), (3, 4)]) == [3, 7]
        assert pool.apply(add, (5, 6)) == 11
        r = pool.map_async(square, [7])
        assert r.get(timeout=30) == [49]
        assert sorted(pool.imap_unordered(square, range(4))) == [0, 1, 4, 9]
    with pytest.raises(ValueError):
        pool.map(square, [1])


def test_pool_windowed_lazy_imap(rt):
    from ray_tpu_torch._private.ids import ObjectID
    from ray_tpu_torch.object_ref import ObjectRef
    from ray_tpu_torch.util.multiprocessing import AsyncResult, Pool

    def ident(x):
        return x

    with Pool(processes=2) as pool:
        assert list(pool.imap(ident, range(9))) == list(range(9))
        assert sorted(pool.imap_unordered(ident, range(7))) == list(range(7))
        r = pool.map_async(ident, [1])
        assert r.get(timeout=30) == [1]
        assert r.ready() and r.successful()

    # successful() on an unfinished result raises (multiprocessing
    # contract): a result that can never complete
    ghost = AsyncResult([ObjectRef(ObjectID.generate())], single=False)
    with pytest.raises(ValueError):
        ghost.successful()


def test_joblib_backend_sklearn(rt):
    import joblib
    from sklearn.datasets import make_classification
    from sklearn.ensemble import RandomForestClassifier

    from ray_tpu_torch.util.joblib import register_ray

    register_ray()

    def cube(x):
        return x ** 3

    with joblib.parallel_backend("ray_tpu_torch"):
        out = joblib.Parallel(n_jobs=2)(joblib.delayed(cube)(i) for i in range(6))
    assert out == [0, 1, 8, 27, 64, 125]

    X, y = make_classification(n_samples=120, n_features=6, random_state=0)
    with joblib.parallel_backend("ray_tpu_torch"):
        clf = RandomForestClassifier(n_estimators=6, n_jobs=2, random_state=0)
        clf.fit(X, y)
    assert clf.score(X, y) > 0.9


def test_gpu_node_helpers(monkeypatch, tmp_path):
    from ray_tpu_torch.util.accelerators import gpu

    smi = tmp_path / "nvidia-smi"
    smi.write_text("#!/bin/sh\n"
                   "echo 'GPU 0: NVIDIA H100 80GB HBM3 (UUID: GPU-0b1c2d3e-aaaa)'\n"
                   "echo 'GPU 1: NVIDIA H100 80GB HBM3 (UUID: GPU-4f5a6b7c-bbbb)'\n")
    smi.chmod(smi.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setenv("PATH", f"{tmp_path}{os.pathsep}{os.environ['PATH']}")
    monkeypatch.delenv("RAY_TPU_TORCH_NUM_GPUS", raising=False)
    monkeypatch.delenv("CUDA_VISIBLE_DEVICES", raising=False)
    assert gpu.get_accelerator_type() == "NVIDIA H100 80GB HBM3"
    assert gpu.get_num_gpus_on_node() == 2
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "1")
    assert gpu.get_num_gpus_on_node() == 1
    monkeypatch.setenv("RAY_TPU_TORCH_NUM_GPUS", "8")
    assert gpu.get_num_gpus_on_node() == 8
    monkeypatch.setenv("PATH", str(tmp_path / "empty"))
    assert gpu.get_accelerator_type() is None
