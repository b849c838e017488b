"""Dashboard: the cluster's HTTP observability surface.

Parity: python/ray/dashboard/ (head.py:46 DashboardHead + modules) —
TPU-native scope: the operational API, not a React frontend. One aiohttp
server exposes the state API, metrics (Prometheus exposition), the
chrome-trace timeline, and job submission/inspection:

    GET  /api/cluster_status     nodes + aggregate resources
    GET  /api/nodes|actors|tasks|workers|objects|placement_groups
    GET  /api/shards             control-plane topology: per-reactor-
                                 shard conn/frame counters + state-
                                 service message counts (hub_shards.py)
    GET  /api/timeline           chrome://tracing JSON
    GET  /api/events             flight-recorder runtime events
    GET  /api/traces             sampled distributed traces (summaries)
    GET  /api/traces/{trace_id}  one trace: raw spans + critical-path
                                 breakdown (util/tracing.analyze_trace)
    GET  /api/serve              serve-plane SLOs: raw per-(deployment,
                                 route) metric rows + the per-deployment
                                 summary (latency percentiles, batch
                                 efficiency, drain/drop counters)
    GET  /api/profile            folded profiler samples + per-process
                                 sampler meta (empty unless
                                 RAY_TPU_TORCH_PROFILE_HZ > 0 somewhere);
                                 ?fold=1 returns flamegraph collapsed
                                 text instead of JSON
    GET  /metrics                Prometheus text (user + ray_tpu_torch_* builtin)
    GET  /api/jobs               scheduler view: {tenants (usage vs
                                 quota), jobs (fairsched registry),
                                 submissions (entrypoint job table)}
    GET  /api/tenants            per-tenant usage vs quota only
    POST /api/jobs               {"entrypoint": ..., "tenant": ...,
                                 "priority": ..., "quota": ...}
                                 -> {"job_id": ...}
    GET  /api/jobs/{id}          status
    GET  /api/jobs/{id}/logs     captured driver output
"""

from __future__ import annotations

import threading
from typing import Optional


class Dashboard:
    def __init__(self, host: str = "127.0.0.1", port: int = 8265):
        self.host = host
        self.port = port
        self._thread: Optional[threading.Thread] = None
        self._loop = None
        self._started = threading.Event()

    # ------------------------------------------------------------------
    def start(self) -> "Dashboard":
        self._thread = threading.Thread(
            target=self._serve, daemon=True, name="ray-tpu-torch-dashboard"
        )
        self._thread.start()
        if not self._started.wait(10):
            raise RuntimeError("dashboard failed to start within 10s")
        return self

    def _client(self):
        from ray_tpu_torch._private import worker

        return worker.get_client()

    def _serve(self):
        import asyncio

        from aiohttp import web

        async def cluster_status(request):
            client = self._client()
            return web.json_response(
                {
                    "nodes": client.list_state("nodes"),
                    "resources_total": client.cluster_resources(False),
                    "resources_available": client.cluster_resources(True),
                }
            )

        async def list_kind(request):
            kind = request.match_info["kind"]
            allowed = {
                "nodes", "actors", "tasks", "workers", "objects",
                "placement_groups", "events", "tenants", "shards",
                "traces", "profile",
            }
            if kind not in allowed:
                raise web.HTTPNotFound(text=f"unknown kind {kind}")
            return web.json_response(self._client().list_state(kind))

        async def timeline(request):
            return web.json_response(self._client().list_state("timeline"))

        async def trace_detail(request):
            # one trace's raw spans + the critical-path breakdown
            from ray_tpu_torch.util.tracing import analyze_trace

            spans = self._client().list_state(
                "traces", trace_id=request.match_info["trace_id"]
            )
            if not spans:
                raise web.HTTPNotFound(text="unknown or evicted trace")
            return web.json_response(
                {"spans": spans, "critical_path": analyze_trace(spans)}
            )

        async def data_stats(request):
            import json as _json

            client = self._client()
            out = []
            for key in sorted(client.kv_keys(b"__data_stats__"))[-20:]:
                blob = client.kv_get(key)
                if blob:
                    try:
                        out.append(_json.loads(blob))
                    except ValueError:
                        pass
            return web.json_response(out)

        async def metrics(request):
            from ray_tpu_torch.util.metrics import prometheus_text

            return web.Response(text=prometheus_text(),
                                content_type="text/plain")

        async def profile_state(request):
            rows = self._client().list_state("profile")
            if request.query.get("fold"):
                from ray_tpu_torch.util.profiler import fold_lines

                return web.Response(
                    text="\n".join(fold_lines(rows)) + "\n",
                    content_type="text/plain",
                )
            return web.json_response(rows)

        async def serve_state(request):
            from ray_tpu_torch.util.state import summarize_serve

            return web.json_response({
                "rows": self._client().list_state("serve"),
                "summary": summarize_serve(),
            })

        def _jobs_client():
            from ray_tpu_torch.job_submission import JobSubmissionClient

            return JobSubmissionClient()

        async def jobs_list(request):
            # the scheduler view (fairsched: per-tenant usage vs quota,
            # registered jobs) plus the entrypoint submission table.
            # Submissions are best-effort: reading them instantiates
            # the job-manager actor, which needs a live worker — the
            # scheduler tables must render even when that fails.
            client = self._client()
            try:
                submissions = _jobs_client().list_jobs()
            except Exception:
                submissions = []
            return web.json_response({
                "tenants": client.list_state("tenants"),
                "jobs": client.list_state("jobs"),
                "submissions": submissions,
            })

        async def jobs_submit(request):
            body = await request.json()
            job_id = _jobs_client().submit_job(
                entrypoint=body["entrypoint"],
                submission_id=body.get("submission_id"),
                runtime_env=body.get("runtime_env"),
                metadata=body.get("metadata"),
                tenant=body.get("tenant"),
                priority=body.get("priority"),
                quota=body.get("quota"),
            )
            return web.json_response({"job_id": job_id})

        async def job_status(request):
            return web.json_response(
                _jobs_client().get_job_info(request.match_info["job_id"])
            )

        async def job_logs(request):
            return web.Response(
                text=_jobs_client().get_job_logs(request.match_info["job_id"]),
                content_type="text/plain",
            )

        import os

        with open(os.path.join(os.path.dirname(__file__), "index.html")) as f:
            index_html = f.read()  # once: no per-request blocking read
                                   # on the event-loop thread

        async def index(request):
            return web.Response(text=index_html, content_type="text/html")

        app = web.Application()
        # literal routes BEFORE the /api/{kind} catch-all
        app.router.add_get("/", index)
        app.router.add_get("/api/cluster_status", cluster_status)
        app.router.add_get("/api/timeline", timeline)
        app.router.add_get("/api/data_stats", data_stats)
        app.router.add_get("/api/jobs", jobs_list)
        app.router.add_post("/api/jobs", jobs_submit)
        app.router.add_get("/api/jobs/{job_id}", job_status)
        app.router.add_get("/api/jobs/{job_id}/logs", job_logs)
        app.router.add_get("/api/traces/{trace_id}", trace_detail)
        app.router.add_get("/api/serve", serve_state)
        app.router.add_get("/api/profile", profile_state)
        app.router.add_get("/api/{kind}", list_kind)
        app.router.add_get("/metrics", metrics)

        self._loop = asyncio.new_event_loop()
        asyncio.set_event_loop(self._loop)
        runner = web.AppRunner(app)
        self._loop.run_until_complete(runner.setup())
        site = web.TCPSite(runner, self.host, self.port)
        self._loop.run_until_complete(site.start())
        if self.port == 0:  # ephemeral bind: report the real port
            self.port = site._server.sockets[0].getsockname()[1]
        self._started.set()
        self._loop.run_forever()

    def stop(self) -> None:
        if self._loop is not None:
            self._loop.call_soon_threadsafe(self._loop.stop)


_dashboard: Optional[Dashboard] = None


def start_dashboard(host: str = "127.0.0.1", port: int = 8265) -> Dashboard:
    """Start (or return) the process-wide dashboard server."""
    global _dashboard
    if _dashboard is None:
        _dashboard = Dashboard(host, port).start()
    return _dashboard
