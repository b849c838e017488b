"""GPUs pinned to workers the way the reference pins TPU chips, on the CPU.

``ray_tpu_torch.init(num_gpus=2)`` is given the count (nothing is
detected here), and every program runs again on ``ray_tpu.init(
num_tpus=2)`` reading ``TPU_VISIBLE_CHIPS`` where the port reads
``CUDA_VISIBLE_DEVICES``: a ``num_gpus=1`` task sees one id, two live
actors see disjoint ids, the ids come back when an actor dies, a
fractional request truncates as a TPU request does, and the placement
group of ``LLMConfig(tensor_parallel_size=2).placement_bundles()``
reserves both cards for the actor placed in it. The results must be the
reference's. The port's detection (``GPUAcceleratorManager``) is tested
apart.

Cost: one runtime per package for the whole file, two CPUs and two
pooled workers each; every get has a timeout.
"""

import os
import shutil
import tempfile
import time

import pytest

import ray_tpu
import ray_tpu_torch
from ray_tpu.llm import LLMConfig as JaxLLMConfig
from ray_tpu_torch._private.accelerators import detect_resources
from ray_tpu_torch._private.accelerators.gpu import GPUAcceleratorManager
from ray_tpu_torch.llm import LLMConfig

T = 60

# (package, resource key, option, env var of the pinned ids)
SIDES = {
    "ray_tpu": (ray_tpu, "TPU", "num_tpus", "TPU_VISIBLE_CHIPS"),
    "ray_tpu_torch": (ray_tpu_torch, "GPU", "num_gpus", "CUDA_VISIBLE_DEVICES"),
}


@pytest.fixture(scope="module")
def runtimes():
    ray_tpu.init(num_cpus=2, num_tpus=2, max_workers=2, ignore_reinit_error=True)
    ray_tpu_torch.init(num_cpus=2, num_gpus=2, max_workers=2)
    yield
    ray_tpu_torch.shutdown()
    ray_tpu.shutdown()


def _ids(value):
    return [x for x in (value or "").split(",") if x]


def _avail(rt, key):
    return rt.available_resources().get(key, 0.0)


def _wait_avail(rt, key, want):
    deadline = time.time() + T
    while _avail(rt, key) != want and time.time() < deadline:
        time.sleep(0.05)
    return _avail(rt, key)


def pinning(side):
    rt, key, opt, env = SIDES[side]

    # remote code reads the env var only: a helper of this module would be
    # pickled by reference, and each worker would import this file
    @rt.remote(**{opt: 1})
    def one():
        return os.environ.get(env)

    @rt.remote
    def none():
        return os.environ.get(env)

    @rt.remote(**{opt: 1})
    class Holder:
        def ids(self):
            return os.environ.get(env)

    cpu_raw = rt.get(none.remote(), timeout=T)  # before any worker is pinned
    task_ids = _ids(rt.get(one.remote(), timeout=T))
    a, b = Holder.remote(), Holder.remote()
    ia, ib = map(_ids, rt.get([a.ids.remote(), b.ids.remote()], timeout=T))
    held = _avail(rt, key)
    rt.kill(a)
    back = _wait_avail(rt, key, 1.0)
    c = Holder.remote()
    ic = _ids(rt.get(c.ids.remote(), timeout=T))
    rt.kill(b)
    rt.kill(c)
    after = _wait_avail(rt, key, 2.0)
    return {
        "task": len(task_ids), "cpu_task": _ids(cpu_raw), "cpu_raw": cpu_raw,
        "actors": (len(ia), len(ib)),
        "disjoint": not set(ia) & set(ib), "in_range": set(ia + ib) <= {"0", "1"},
        "held": held, "back": back, "reused": ic == ia, "after": after,
    }


def fractional(side):
    rt, key, opt, env = SIDES[side]
    # The 0.5 task pins no id, and a task that pins none may be given an
    # idle worker that an earlier task pinned (then it sees that worker's
    # ids). So the 1.5 task, which takes the worker `pinning` pinned one
    # id to, holds it busy until the 0.5 task has run: the 0.5 task
    # cannot be placed there, whatever the timing.
    marks = tempfile.mkdtemp()
    started, half_ran = os.path.join(marks, "started"), os.path.join(marks, "half_ran")

    @rt.remote(**{opt: 1.5})
    def one_and_a_half(started, half_ran):
        open(started, "w").close()
        deadline = time.time() + T
        while not os.path.exists(half_ran) and time.time() < deadline:
            time.sleep(0.01)
        return os.environ.get(env)

    @rt.remote(**{opt: 0.5})
    def half(half_ran):
        open(half_ran, "w").close()
        return os.environ.get(env)

    ref15 = one_and_a_half.remote(started, half_ran)
    deadline = time.time() + T
    while not os.path.exists(started) and time.time() < deadline:
        time.sleep(0.01)
    ids15, ids05 = rt.get([ref15, half.remote(half_ran)], timeout=T)
    shutil.rmtree(marks)
    return len(_ids(ids15)), len(_ids(ids05)), _wait_avail(rt, key, 2.0)


def tensor_parallel_group(side):
    rt, key, opt, env = SIDES[side]
    util = __import__(f"{rt.__name__}.util", fromlist=["util"])
    cfg = (JaxLLMConfig if side == "ray_tpu" else LLMConfig)(tensor_parallel_size=2)
    bundles, strategy = cfg.placement_bundles()
    pg = util.placement_group(bundles, strategy=strategy)
    assert rt.get(pg.ready(), timeout=T) is True
    reserved = _avail(rt, key)

    @rt.remote(**{opt: 2})
    class Shard:
        def ids(self):
            return os.environ.get(env)

    s = Shard.options(scheduling_strategy=util.PlacementGroupSchedulingStrategy(pg, 0)).remote()
    ids = _ids(rt.get(s.ids.remote(), timeout=T))
    rt.kill(s)
    util.remove_placement_group(pg)
    return ([{k.replace(key, "ACCEL"): v for k, v in b.items()} for b in bundles],
            strategy, reserved, sorted(ids), _wait_avail(rt, key, 2.0))


# in this order: as in the reference, ids pinned to a pooled worker stay
# with it while it idles, so the fractional program (whose 1.5-GPU task
# leaves one pinned) comes last
@pytest.mark.parametrize("program", [pinning, tensor_parallel_group, fractional],
                         ids=lambda p: p.__name__)
def test_gpus_pin_like_tpu_chips(runtimes, program):
    ref = program("ray_tpu")
    got = program("ray_tpu_torch")
    if program is pinning:
        # by design a port worker without ids is told so; the reference
        # leaves TPU_VISIBLE_CHIPS unset
        assert got.pop("cpu_raw") == "" and ref.pop("cpu_raw") is None
    assert got == ref
    if program is pinning:
        assert got["task"] == 1 and got["actors"] == (1, 1) and got["disjoint"]
        assert got["cpu_task"] == [] and got["held"] == 0.0 and got["back"] == 1.0
    if program is tensor_parallel_group:
        assert got[3] == ["0", "1"] and got[2] == 0.0


def test_slice_placement_is_inert(runtimes):
    """SLICE reserves ICI-contiguous chips from node coordinates; the GPU
    manager reports none, so the port refuses it as the reference does on
    a host of unknown topology."""
    for side in SIDES:
        rt, key, _, _ = SIDES[side]
        util = __import__(f"{rt.__name__}.util", fromlist=["util"])
        with pytest.raises(ValueError, match="SLICE requires ICI topology"):
            util.placement_group([{key: 1}], strategy="SLICE")
        assert _avail(rt, key) == 2.0


def test_detection_without_cuda(monkeypatch):
    monkeypatch.delenv("RAY_TPU_TORCH_NUM_GPUS", raising=False)
    monkeypatch.delenv("CUDA_VISIBLE_DEVICES", raising=False)
    monkeypatch.setenv("PATH", "/nonexistent")  # no nvidia-smi
    assert GPUAcceleratorManager.get_current_node_num_accelerators() == 0
    assert "GPU" not in detect_resources()
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "3,5")
    assert detect_resources()["GPU"] == 2.0
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "")
    assert GPUAcceleratorManager.get_current_node_num_accelerators() == 0
    monkeypatch.setenv("RAY_TPU_TORCH_NUM_GPUS", "4")
    assert GPUAcceleratorManager.get_current_node_num_accelerators() == 4
    assert GPUAcceleratorManager.get_resource_name() == "GPU"
    assert GPUAcceleratorManager.get_visible_accelerator_ids_env_var() == "CUDA_VISIBLE_DEVICES"
