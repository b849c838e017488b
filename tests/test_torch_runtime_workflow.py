"""Durable workflows of the port against the reference's.

Each program runs once on ``ray_tpu`` and once on ``ray_tpu_torch``
(each package's ``workflow`` storage in its own directory), both
runtimes up at once in this process, and the two results must be equal:
test_platform.py's durable resume (a node that fails once; the status is
FAILED, then the resume replays only that node and the status is
SUCCEEDED), a diamond whose two branches both run before the join, an
external event that is polled and acknowledged exactly once across two
failed runs and a resume, and ``list_all`` of every workflow run.

Cost: one runtime per package for the whole file, two CPUs and two
pooled workers each. The event program waits out its listener's 5 s
timeout once per package.
"""

import importlib
import os

import pytest

import ray_tpu
import ray_tpu_torch


@pytest.fixture(scope="module")
def runtimes():
    ray_tpu.init(num_cpus=2, max_workers=2, ignore_reinit_error=True)
    ray_tpu_torch.init(num_cpus=2, max_workers=2)
    yield
    ray_tpu_torch.shutdown()
    ray_tpu.shutdown()


def _mods(rt, tmp_path):
    workflow = importlib.import_module(f"{rt.__name__}.workflow")
    workflow.init(str(tmp_path / rt.__name__ / "wf"))
    work = tmp_path / rt.__name__ / "calls"
    work.mkdir()
    return workflow, importlib.import_module(f"{rt.__name__}.dag").InputNode, work


def durable_resume(rt, tmp_path):
    workflow, InputNode, calls = _mods(rt, tmp_path)

    @rt.remote
    def step_a(x):
        open(calls / "a", "a").write("x")
        return x + 1

    @rt.remote
    def step_b(x):
        open(calls / "b", "a").write("x")
        if not os.path.exists(calls / "b_ok"):
            open(calls / "b_ok", "w").close()
            raise RuntimeError("transient failure")
        return x * 10

    with InputNode() as inp:
        dag = step_b.bind(step_a.bind(inp))
    with pytest.raises(Exception):
        workflow.run(dag, workflow_id="wf1", args=4)
    out = [workflow.get_status("wf1")]
    out.append(workflow.run(dag, workflow_id="wf1", args=4))
    out += [workflow.get_status("wf1"), open(calls / "a").read(), open(calls / "b").read(),
            sorted(os.listdir(tmp_path / rt.__name__ / "wf" / "wf1" / "results")),
            workflow.list_all(), workflow.get_status("nope")]
    return out


def diamond(rt, tmp_path):
    workflow, InputNode, calls = _mods(rt, tmp_path)

    @rt.remote
    def branch(x, tag):
        open(calls / tag, "w").write(str(x))
        return tag

    @rt.remote
    def join(a, b):
        return (a, b)

    with InputNode() as inp:
        dag = join.bind(branch.bind(inp, "l"), branch.bind(inp, "r"))
    out = workflow.run(dag, workflow_id="wfp", args=0)
    return out, sorted(os.listdir(calls)), workflow.list_all()


def events_exactly_once(rt, tmp_path):
    workflow, InputNode, work = _mods(rt, tmp_path)
    evt_file, polls, acks, late_ok = (work / n for n in ("event", "polls", "acks", "late_ok"))

    class FileEvent(workflow.EventListener):
        def __init__(self, path, polls_path, acks_path):
            self.path = path
            self.polls_path = polls_path
            self.acks_path = acks_path

        def poll_for_event(self):
            import time as _t

            deadline = _t.monotonic() + 5
            while _t.monotonic() < deadline:
                if os.path.exists(self.path):
                    open(self.polls_path, "a").write("p")
                    return open(self.path).read()
                _t.sleep(0.1)
            raise TimeoutError("event never fired")

        def event_checkpointed(self, event):
            open(self.acks_path, "a").write("a")

    @rt.remote
    def consume(payload, x):
        if not os.path.exists(late_ok):
            open(late_ok, "w").close()
            raise RuntimeError("crash after event checkpoint")
        return f"{payload}:{x}"

    with InputNode() as inp:
        dag = consume.bind(workflow.wait_for_event(FileEvent, str(evt_file), str(polls),
                                                   str(acks)), inp)
    with pytest.raises(Exception):
        workflow.run(dag, workflow_id="wf_ev", args=7)  # the listener times out
    out = [workflow.get_status("wf_ev"), polls.exists()]
    evt_file.write_text("hello")
    with pytest.raises(Exception):
        workflow.resume("wf_ev", dag, args=7)  # the node after the event fails
    out += [polls.read_text(), acks.read_text()]
    out += [workflow.resume("wf_ev", dag, args=7), polls.read_text(), acks.read_text(),
            workflow.get_status("wf_ev")]
    return out


PROGRAMS = [durable_resume, diamond, events_exactly_once]


@pytest.mark.parametrize("program", PROGRAMS, ids=lambda p: p.__name__)
def test_same_program_same_result(runtimes, tmp_path, program):
    ref = program(ray_tpu, tmp_path)
    got = program(ray_tpu_torch, tmp_path)
    assert got == ref


def test_durable_resume_replays_only_the_failed_node(runtimes, tmp_path):
    status, out, final, a, b, results, listed, missing = durable_resume(ray_tpu_torch, tmp_path)
    assert (status, out, final, missing) == ("FAILED", 50, "SUCCEEDED", "NOT_FOUND")
    assert (a, b) == ("x", "xx")  # step_a ran once; step_b failed once, ran once more
    assert results == ["0001_step_a.pkl", "0002_step_b.pkl"]
    assert listed == [{"workflow_id": "wf1", "status": "SUCCEEDED"}]
