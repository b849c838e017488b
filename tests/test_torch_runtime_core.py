"""The port's runtime core against the reference's, side by side.

Each program below runs once on ``ray_tpu`` and once on
``ray_tpu_torch``, both runtimes up at once in this process, and the two
results must be equal: tasks with args and kwargs, ObjectRef arguments,
multiple returns, nested tasks, errors (class names and messages),
``wait`` and ``get`` timeouts, sync, async and threaded actors, named
actors, kill and restart, and placement groups under PACK, STRICT_PACK
and SPREAD with their bundles reserved. ``available_resources()`` must
agree but for the accelerator key ("TPU" there, "GPU" here). The
programs are taken from test_core_tasks.py, test_core_actors.py and
test_placement_groups.py.

Cost: one runtime per package for the whole file, two CPUs and two
pooled workers each; every get and wait has a timeout.
"""

import os
import threading
import time

import pytest

import ray_tpu
import ray_tpu_torch

T = 60  # seconds: the timeout of every get that should succeed


@pytest.fixture(scope="module")
def runtimes():
    ray_tpu.init(num_cpus=2, max_workers=2, ignore_reinit_error=True)
    ray_tpu_torch.init(num_cpus=2, max_workers=2)
    yield
    ray_tpu_torch.shutdown()
    ray_tpu.shutdown()


def _util(rt):
    return __import__(f"{rt.__name__}.util", fromlist=["util"])


def _no_accel(res):
    return {k: v for k, v in res.items() if k not in ("TPU", "GPU")}


def _err(rt, fn):
    """(class name, cause's class name, cause's message) of what fn raises."""
    try:
        fn()
    except rt.exceptions.RayError as e:
        cause = getattr(e, "cause", None)
        return (type(e).__name__, type(cause).__name__ if cause else None,
                str(cause) if cause else str(e))
    raise AssertionError("no error raised")


def tasks_args_kwargs(rt):
    @rt.remote
    def f(a, b=2, *, c=3):
        return (a, b, c)

    return rt.get([f.remote(1), f.remote(1, 5), f.remote(a=4, c=9), f.remote("x", b=[1, 2])],
                  timeout=T)


def object_ref_args(rt):
    @rt.remote
    def add(x, y):
        return x + y

    ref = rt.put(10)
    chained = add.remote(add.remote(ref, 1), ref)
    return rt.get([add.remote(ref, 5), chained], timeout=T), rt.get(ref, timeout=T)


def multiple_returns(rt):
    @rt.remote(num_returns=3)
    def three():
        return 1, "two", [3]

    a, b, c = three.remote()
    return rt.get([a, b, c], timeout=T)


def nested_tasks(rt):
    @rt.remote
    def inner(x):
        return x + 1

    @rt.remote
    def outer(x):
        return rt.get(inner.remote(x), timeout=T) + 100

    return rt.get(outer.remote(1), timeout=T)


def errors(rt):
    @rt.remote
    def boom(k):
        raise ValueError(f"boom {k}")

    @rt.remote
    def dependent(x):
        return x

    return (_err(rt, lambda: rt.get(boom.remote(7), timeout=T)),
            _err(rt, lambda: rt.get(dependent.remote(boom.remote(8)), timeout=T))[:2])


def wait_and_get_timeouts(rt):
    @rt.remote
    def fast():
        return 1

    @rt.remote
    def slow():
        time.sleep(1.5)
        return 2

    s = slow.remote()
    ready, not_ready = rt.wait([s], num_returns=1, timeout=0.1)
    timed_out = _err(rt, lambda: rt.get(s, timeout=0.1))[0]
    f = fast.remote()
    first, rest = rt.wait([f, s], num_returns=2, timeout=T)
    return (len(ready), len(not_ready), timed_out, len(first), len(rest),
            rt.get([f, s], timeout=T))


def sync_actor(rt):
    @rt.remote
    class Counter:
        def __init__(self, start=0):
            self.n = start

        def inc(self, k=1):
            self.n += k
            return self.n

    c = Counter.remote(100)
    out = rt.get([c.inc.remote() for _ in range(20)] + [c.inc.remote(5)], timeout=T)
    rt.kill(c)
    return out


def async_actor(rt):
    @rt.remote
    class AsyncWorker:
        async def work(self, i):
            import asyncio

            await asyncio.sleep(0.01)
            return i * 2

    a = AsyncWorker.remote()
    out = rt.get([a.work.remote(i) for i in range(8)], timeout=T)
    rt.kill(a)
    return out


def threaded_actor(rt):
    @rt.remote(max_concurrency=4)
    class Gate:
        def __init__(self):
            self.barrier = threading.Barrier(4)

        def enter(self, i):
            # returns only when four calls run at once
            self.barrier.wait(timeout=30)
            return i

    g = Gate.remote()
    out = sorted(rt.get([g.enter.remote(i) for i in range(4)], timeout=T))
    rt.kill(g)
    return out


def named_actors(rt):
    @rt.remote
    class Counter:
        def __init__(self):
            self.n = 0

        def inc(self):
            self.n += 1
            return self.n

    c = Counter.options(name="parity_counter").remote()
    rt.get(c.inc.remote(), timeout=T)
    again = rt.get_actor("parity_counter")
    value = rt.get(again.inc.remote(), timeout=T)
    with pytest.raises(ValueError):
        Counter.options(name="parity_counter").remote()
    with pytest.raises(ValueError):
        rt.get_actor("parity_missing")
    rt.kill(c)
    return value


def kill_and_restart(rt):
    @rt.remote(max_restarts=1)
    class Phoenix:
        def __init__(self):
            self.n = 0

        def pid(self):
            return os.getpid()

        def inc(self):
            self.n += 1
            return self.n

    p = Phoenix.remote()
    pid1 = rt.get(p.pid.remote(), timeout=T)
    rt.get(p.inc.remote(), timeout=T)
    rt.kill(p, no_restart=False)
    deadline, pid2 = time.time() + T, None
    while pid2 is None and time.time() < deadline:
        try:
            pid2 = rt.get(p.pid.remote(), timeout=10)
        except (rt.exceptions.ActorDiedError, rt.exceptions.GetTimeoutError):
            time.sleep(0.2)
    restarted = (pid2 is not None and pid2 != pid1, rt.get(p.inc.remote(), timeout=T))
    rt.kill(p)
    dead = _err(rt, lambda: rt.get(p.inc.remote(), timeout=T))[0]
    return restarted, dead


def _pg_program(strategy, bundles):
    def program(rt):
        u = _util(rt)
        before = _no_accel(rt.available_resources())
        pg = u.placement_group(bundles, strategy=strategy)
        assert rt.get(pg.ready(), timeout=T) is True
        reserved = _no_accel(rt.available_resources())

        pkg = rt.__name__  # remote code must not name this module's helpers

        @rt.remote(num_cpus=1)
        def where():
            util = __import__(f"{pkg}.util", fromlist=["util"])
            return util.get_current_placement_group() is not None

        @rt.remote(num_cpus=1)
        class A:
            def ping(self):
                return "pong"

        strat = u.PlacementGroupSchedulingStrategy(pg, placement_group_bundle_index=0)
        in_task = rt.get(where.options(scheduling_strategy=strat).remote(), timeout=T)
        a = A.options(scheduling_strategy=strat).remote()
        pong = rt.get(a.ping.remote(), timeout=T)
        rt.kill(a)
        table = [(v["strategy"], v["bundles"]) for v in u.placement_group_table().values()]
        u.remove_placement_group(pg)
        deadline = time.time() + T
        while _no_accel(rt.available_resources()) != before and time.time() < deadline:
            time.sleep(0.05)
        return before, reserved, in_task, pong, table, _no_accel(rt.available_resources())

    program.__name__ = f"placement_group_{strategy.lower()}"
    return program


PROGRAMS = [
    tasks_args_kwargs, object_ref_args, multiple_returns, nested_tasks, errors,
    wait_and_get_timeouts, sync_actor, async_actor, threaded_actor, named_actors,
    kill_and_restart,
    _pg_program("PACK", [{"CPU": 1}, {"CPU": 1}]),
    _pg_program("STRICT_PACK", [{"CPU": 1}]),
    _pg_program("SPREAD", [{"CPU": 1}]),
]


@pytest.mark.parametrize("program", PROGRAMS, ids=lambda p: p.__name__)
def test_same_program_same_result(runtimes, program):
    ref = program(ray_tpu)
    got = program(ray_tpu_torch)
    assert got == ref


def test_resources_agree_but_for_the_accelerator_key(runtimes):
    ref, got = ray_tpu.cluster_resources(), ray_tpu_torch.cluster_resources()
    assert _no_accel(got) == _no_accel(ref)
    assert "TPU" not in got and got.get("GPU", 0) == ref.get("TPU", 0) == 0
    assert _no_accel(ray_tpu_torch.available_resources()) == _no_accel(
        ray_tpu.available_resources())


def test_bind_raises_until_dag_is_ported(runtimes):
    @ray_tpu_torch.remote
    def f(x):
        return x

    @ray_tpu_torch.remote
    class A:
        def m(self):
            return 1

    with pytest.raises(NotImplementedError, match="dag"):
        f.bind(1)
    a = A.remote()
    with pytest.raises(NotImplementedError, match="dag"):
        a.m.bind()
    ray_tpu_torch.kill(a)


def test_client_mode_is_not_ported():
    with pytest.raises(NotImplementedError, match="Queue A"):
        ray_tpu_torch.init(address="tcp://127.0.0.1:1")


@pytest.mark.parametrize("rt", [ray_tpu, ray_tpu_torch], ids=lambda m: m.__name__)
def test_progress_bars_and_the_html_card(runtimes, rt):
    """experimental.tqdm_ray and widgets are copied (worker.py imports
    both): a worker's bar reaches the driver's bar manager, and the init
    card names the pinned accelerator."""
    pkg = rt.__name__

    @rt.remote
    def count(n):
        tqdm_ray = __import__(f"{pkg}.experimental.tqdm_ray", fromlist=["tqdm_ray"])
        return sum(tqdm_ray.tqdm(range(n), desc="parity"))

    assert rt.get(count.remote(5), timeout=T) == 10
    html = __import__(f"{pkg}._private.worker", fromlist=["worker"]).RuntimeContext()._repr_html_()
    assert ("GPU" if rt is ray_tpu_torch else "TPU") in html
