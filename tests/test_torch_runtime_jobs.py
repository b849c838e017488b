"""Job submission, the state API and the dashboard on the port, against
the reference's, on the programs of tests/test_platform.py.

Both runtimes run at once in this process. On each: a job's lifecycle
(SUCCEEDED with its logs, listed, and a failing job FAILED), a running
job stopped, the dashboard's JSON API and ``/metrics``, the state API's
lists and summaries, and the dashboard's HTML index. The two results
must be equal but for the HTML title, which names the package. The
dashboards listen on ports of their own (18951-18954), apart from any
other test file's; a stopped dashboard's port is not taken again.

Cost: one runtime per package for the whole file, two CPUs and two
pooled workers each; remote code names no helper of this module.
"""

import importlib
import json
import sys
import time
import urllib.request

import pytest

import ray_tpu
import ray_tpu_torch

T = 60
RTS = [ray_tpu, ray_tpu_torch]
PORTS = {ray_tpu: (18952, 18954), ray_tpu_torch: (18951, 18953)}


def _mod(rt, name):
    return importlib.import_module(f"{rt.__name__}.{name}")


@pytest.fixture(scope="module")
def runtimes():
    ray_tpu.init(num_cpus=2, max_workers=2, ignore_reinit_error=True)
    ray_tpu_torch.init(num_cpus=2, max_workers=2)
    yield
    ray_tpu_torch.shutdown()
    ray_tpu.shutdown()


def job_lifecycle(rt):
    js = _mod(rt, "job_submission")
    client = js.JobSubmissionClient()
    job_id = client.submit_job(entrypoint=f"{sys.executable} -c \"print('job ran ok')\"")
    status = client.wait_until_finished(job_id, timeout=T)
    bad = client.submit_job(entrypoint=f"{sys.executable} -c 'raise SystemExit(3)'")
    return (status, "job ran ok" in client.get_job_logs(job_id),
            any(j["job_id"] == job_id for j in client.list_jobs()),
            client.wait_until_finished(bad, timeout=T))


def job_stop(rt):
    js = _mod(rt, "job_submission")
    client = js.JobSubmissionClient()
    job_id = client.submit_job(entrypoint=f"{sys.executable} -c 'import time; time.sleep(60)'")
    deadline = time.time() + 30
    while client.get_job_status(job_id) == js.JobStatus.PENDING:
        assert time.time() < deadline
        time.sleep(0.1)
    return client.stop_job(job_id), client.wait_until_finished(job_id, timeout=30)


def _get(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=10) as r:
        return r.status, r.read()


def dashboard_api(rt):
    port = PORTS[rt][0]
    dash = _mod(rt, "dashboard").Dashboard(port=port).start()
    try:
        @rt.remote
        def noop():
            return 1

        rt.get(noop.remote(), timeout=T)
        status = json.loads(_get(port, "/api/cluster_status")[1])
        tasks = json.loads(_get(port, "/api/tasks")[1])
        return (status["nodes"][0]["node_id"], status["resources_total"]["CPU"],
                isinstance(json.loads(_get(port, "/api/actors")[1]), list),
                any(e.get("state") == "FINISHED" for e in tasks),
                isinstance(json.loads(_get(port, "/api/timeline")[1]), list),
                _get(port, "/metrics")[0])
    finally:
        dash.stop()


def state_lists_and_summaries(rt):
    state = _mod(rt, "util.state")

    @rt.remote
    def traced_fn():
        return 1

    @rt.remote
    class StateActor:
        def ping(self):
            return 1

    a = StateActor.remote()
    rt.get([a.ping.remote(), traced_fn.remote()], timeout=T)
    actors = state.list_actors(filters=[("state", "=", "ALIVE")])
    summary = state.summarize_tasks()
    out = (bool(actors) and all(x["state"] == "ALIVE" for x in actors),
           state.list_nodes()[0]["node_id"], summary["total"] >= 1,
           summary["by_state"].get("FINISHED", 0) >= 1,
           "traced_fn" in summary["by_func_name"],
           state.summarize_actors()["by_state"].get("ALIVE", 0) >= 1,
           state.summarize_objects()["total"] >= 1, isinstance(state.summarize_serve(), dict))
    rt.kill(a)
    return out


def dashboard_html_index(rt):
    port = PORTS[rt][1]
    d = _mod(rt, "dashboard").Dashboard(port=port).start()
    try:
        html = _get(port, "/")[1].decode()
        return f"{rt.__name__} dashboard" in html, "/api/cluster_status" in html
    finally:
        d.stop()


PROGRAMS = {f.__name__: f for f in (job_lifecycle, job_stop, dashboard_api,
                                    state_lists_and_summaries, dashboard_html_index)}


@pytest.mark.parametrize("name", list(PROGRAMS))
def test_platform_program_agrees(runtimes, name):
    ref, port = (PROGRAMS[name](rt) for rt in RTS)
    assert ref == port, (ref, port)
    assert all(x not in (False, None) for x in ref), ref
