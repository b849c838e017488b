"""HTTP proxy actor: aiohttp ingress routing to deployments.

Parity: python/ray/serve/_private/proxy.py (uvicorn there; aiohttp
here — it's what the environment ships, and it's the reference's own
dashboard HTTP stack) + proxy_router.py longest-prefix route matching.
The request reaches the app as a dict {method, path, query, body,
headers}; the deployment's return value is JSON-encoded (bytes/str pass
through).
"""

from __future__ import annotations

import asyncio
import json
import threading
from typing import Any, Dict, Optional


def _error_status(e: BaseException) -> int:
    """HTTP status bucket for an ingress failure. Replica-raised
    exceptions arrive wrapped in TaskError — classify on the cause.
    503 = shed (admission control, retriable), 504 = deadline expired
    (router wait, pre-execute drop, or result() deadline), 500 = rest.
    """
    from ray_tpu_torch.exceptions import (
        GetTimeoutError,
        RequestExpiredError,
        RequestShedError,
        TaskError,
    )

    cause = e
    if isinstance(e, TaskError) and e.cause is not None:
        cause = e.cause
    if isinstance(cause, RequestShedError):
        return 503
    if isinstance(cause, (RequestExpiredError, GetTimeoutError)):
        return 504
    return 500


def _request_timeout_override(raw: Optional[str]) -> Optional[float]:
    """Parse a per-request deadline override (header/metadata value)."""
    if not raw:
        return None
    try:
        return float(raw)
    except ValueError:
        return None


class HTTPProxy:
    def __init__(self, host: str = "127.0.0.1", port: int = 8000):
        self.host = host
        self.port = port
        self._routes: Dict[str, str] = {}
        self._routes_refreshed = float("-inf")
        self._handles: Dict[str, Any] = {}
        self._loop = asyncio.new_event_loop()
        self._ready = threading.Event()
        self._thread = threading.Thread(
            target=self._serve_forever, daemon=True, name="serve-http"
        )
        self._thread.start()
        self._ready.wait(timeout=10)  # graftlint: disable=GL017 — pre-request startup gate; no request (hence no deadline) exists yet

    def _serve_forever(self):
        asyncio.set_event_loop(self._loop)
        self._loop.run_until_complete(self._start())
        self._loop.run_forever()

    async def _start(self):
        from aiohttp import web

        # aiohttp's default client_max_size (1 MiB) would 413 exactly
        # the bodies the zero-copy payload plane exists for; cap at the
        # configurable ingress limit instead (default 1 GiB)
        from ..._private import config as _config

        max_body = int(
            _config.RAY_TPU_TORCH_CONFIG.get("serve_http_max_body", 1 << 30)
        )
        app = web.Application(client_max_size=max_body)
        app.router.add_route("*", "/{tail:.*}", self._handle)
        runner = web.AppRunner(app, access_log=None)
        await runner.setup()
        site = web.TCPSite(runner, self.host, self.port)
        await site.start()
        self._ready.set()

    def update_routes(self, routes: Dict[str, str]) -> None:
        self._routes = dict(routes)

    def ping(self) -> bool:
        return self._ready.is_set()

    def _match(self, path: str) -> Optional[tuple]:
        """Longest-prefix route match -> (route_prefix, deployment name)."""
        best = None
        for prefix, name in self._routes.items():
            if path == prefix or path.startswith(prefix.rstrip("/") + "/") or prefix == "/":
                if best is None or len(prefix) > len(best[0]):
                    best = (prefix, name)
        return best

    async def _handle(self, request):
        from aiohttp import web

        import time as _time

        from ...util import tracing as _tracing
        from . import observability as obs

        t_in = _time.monotonic()
        # periodic cached refresh, off the event loop (a controller
        # stall must not freeze unrelated in-flight requests)
        if _time.monotonic() - self._routes_refreshed > 1.0:
            self._routes_refreshed = _time.monotonic()
            await asyncio.get_running_loop().run_in_executor(
                None, self._refresh_routes
            )
        matched = self._match(request.path)
        if matched is None:
            return web.Response(status=404, text="no deployment matches path")
        route_prefix, name = matched
        handle = self._handles.get(name)
        if handle is None:
            from ..handle import DeploymentHandle

            handle = DeploymentHandle(name)
            self._handles[name] = handle
        handle._metric_route = route_prefix
        # per-request deadline override; otherwise the handle derives
        # the deadline from serve_request_timeout_s and every blocking
        # wait below (route + result) is capped by it — no literal 60 s
        t_override = _request_timeout_override(
            request.headers.get("X-Request-Timeout-S")
        )
        if t_override is not None:
            handle = handle.options(request_timeout_s=t_override)
        body = await request.read()
        req = {
            "method": request.method,
            "path": request.path,
            "query": dict(request.query),
            "body": body,
            "headers": dict(request.headers),
        }
        # head-sample here — the ingress is the trace root for a serve
        # request. serve.proxy_recv covers recv + parse + route match.
        tr = obs.begin_trace()
        proxy_sid = None
        if tr is not None:
            proxy_sid = obs.emit_span(
                "serve.proxy_recv", "serve.proxy_recv", tr[0], tr[1],
                t_in, _time.monotonic(),
                http_method=request.method, path=request.path,
                deployment=name,
            )
        try:
            # routing involves blocking control-plane calls; keep the
            # event loop free by doing route+wait on a worker thread.
            # run_in_executor does NOT carry contextvars: re-push the
            # trace context inside the worker-thread closure so the
            # router inherits it.
            if proxy_sid is None:
                result = await asyncio.get_running_loop().run_in_executor(
                    None, lambda: handle.remote(req).result()
                )
            else:

                def _routed():
                    token = _tracing.push_context((tr[0], proxy_sid))
                    try:
                        return handle.remote(req).result()
                    finally:
                        _tracing.pop_context(token)

                result = await asyncio.get_running_loop().run_in_executor(
                    None, _routed
                )
        except Exception as e:
            status = _error_status(e)
            headers = {"Retry-After": "1"} if status == 503 else None
            return web.Response(
                status=status,
                text=f"{type(e).__name__}: {e}",
                headers=headers,
            )
        t_resp0 = _time.monotonic()
        resp = self._encode(result)
        if proxy_sid is not None:
            obs.emit_span(
                "serve.response_return", "serve.response_return",
                tr[0], proxy_sid, t_resp0, _time.monotonic(),
                status=resp.status, deployment=name,
            )
        return resp

    def _encode(self, result):
        """Deployment return value -> aiohttp Response."""
        from aiohttp import web

        from ..response import Response as ServeResponse

        if isinstance(result, ServeResponse):
            # explicit status/content-type/headers from the deployment
            # (reference: returning a starlette Response). aiohttp
            # forbids (a) a Content-Type header alongside the
            # content_type param and (b) a charset inside content_type
            # — normalize both starlette-style spellings.
            headers = {
                k: v for k, v in result.headers.items()
                if k.lower() != "content-type"
            }
            ctype = next(
                (v for k, v in result.headers.items()
                 if k.lower() == "content-type"),
                result.content_type,
            )
            charset = None
            if ";" in ctype:
                ctype, _, rest = ctype.partition(";")
                ctype = ctype.strip()
                rest = rest.strip()
                if rest.lower().startswith("charset="):
                    charset = rest.split("=", 1)[1]
            return web.Response(
                status=result.status,
                body=result.body_bytes(),
                content_type=ctype,
                charset=charset,
                headers=headers,
            )
        if isinstance(result, (bytes, bytearray, memoryview)):
            # memoryview: a zero-copy payload-plane body straight off the
            # mapped response segment — aiohttp's BytesPayload writes
            # bytes-like objects as-is, so no copy here either
            return web.Response(
                body=result, content_type="application/octet-stream"
            )
        if isinstance(result, str):
            return web.Response(text=result)
        return web.json_response(result)

    def _refresh_routes(self) -> None:
        try:
            import ray_tpu_torch

            from .controller import CONTROLLER_NAME

            controller = ray_tpu_torch.get_actor(CONTROLLER_NAME)
            self._routes = ray_tpu_torch.get(controller.get_routes.remote())
        except Exception:
            pass


class GrpcIngress:
    """gRPC ingress (reference: serve/_private/proxy.py gRPCProxy +
    grpc_util.py). A generic unary-unary service — no protoc step:
    requests route by the `route` metadata key (falling back to the
    first segment of the method path, mirroring the reference's
    `application` metadata routing), the deployment receives
    {"grpc_method", "body", "metadata"} and returns bytes/str/JSON-able,
    serialized back as raw response bytes."""

    def __init__(self, host: str = "127.0.0.1", port: int = 9000):
        import time as _time
        from concurrent import futures

        import grpc

        self.host = host
        self._routes: Dict[str, str] = {}
        self._routes_refreshed = float("-inf")
        self._handles: Dict[str, Any] = {}
        ingress = self

        class _Generic(grpc.GenericRpcHandler):
            def service(self, details):
                method = details.method

                def call(request: bytes, context):
                    return ingress._call(method, request, context)

                return grpc.unary_unary_rpc_method_handler(
                    call,
                    request_deserializer=None,   # raw bytes in
                    response_serializer=None,    # raw bytes out
                )

        self._server = grpc.server(
            futures.ThreadPoolExecutor(max_workers=16)
        )
        self._server.add_generic_rpc_handlers((_Generic(),))
        self.port = self._server.add_insecure_port(f"{host}:{port}")
        self._server.start()
        self._time = _time

    def ping(self) -> int:
        return self.port

    def _call(self, method: str, request: bytes, context) -> bytes:
        import grpc

        from ...util import tracing as _tracing
        from . import observability as obs

        t_in = self._time.monotonic()
        if self._time.monotonic() - self._routes_refreshed > 1.0:
            self._routes_refreshed = self._time.monotonic()
            self._refresh_routes()
        md = {k: v for k, v in (context.invocation_metadata() or ())}
        route = md.get("route")
        if route is None:
            # "/pkg.Service/Method" -> "/pkg.Service"
            route = "/" + method.strip("/").split("/")[0]
        matched = self._match(route if route.startswith("/") else f"/{route}")
        if matched is None:
            context.abort(
                grpc.StatusCode.NOT_FOUND,
                f"no deployment matches route {route!r}",
            )
        route_prefix, name = matched
        handle = self._handles.get(name)
        if handle is None:
            from ..handle import DeploymentHandle

            handle = DeploymentHandle(name)
            self._handles[name] = handle
        handle._metric_route = route_prefix
        # per-request deadline override via metadata (the gRPC twin of
        # the X-Request-Timeout-S header)
        t_override = _request_timeout_override(md.get("request-timeout-s"))
        if t_override is not None:
            handle = handle.options(request_timeout_s=t_override)
        req = {"grpc_method": method, "body": request, "metadata": md}
        tr = obs.begin_trace()
        proxy_sid = None
        if tr is not None:
            proxy_sid = obs.emit_span(
                "serve.proxy_recv", "serve.proxy_recv", tr[0], tr[1],
                t_in, self._time.monotonic(),
                grpc_method=method, deployment=name,
            )
        token = (
            _tracing.push_context((tr[0], proxy_sid))
            if proxy_sid is not None
            else None
        )
        try:
            result = handle.remote(req).result()
        except Exception as e:  # noqa: BLE001
            status = _error_status(e)
            code = (
                grpc.StatusCode.RESOURCE_EXHAUSTED
                if status == 503
                else grpc.StatusCode.DEADLINE_EXCEEDED
                if status == 504
                else grpc.StatusCode.INTERNAL
            )
            context.abort(code, f"{type(e).__name__}: {e}")
        finally:
            if token is not None:
                _tracing.pop_context(token)
        t_resp0 = self._time.monotonic()
        try:
            return self._encode_grpc(result, context)
        finally:
            if proxy_sid is not None:
                obs.emit_span(
                    "serve.response_return", "serve.response_return",
                    tr[0], proxy_sid, t_resp0, self._time.monotonic(),
                    deployment=name,
                )

    def _encode_grpc(self, result, context) -> bytes:
        import grpc
        from ..response import Response as ServeResponse

        if isinstance(result, ServeResponse):
            # shared deployments may return serve.Response on either
            # ingress: gRPC carries the body; an error status maps to
            # an INTERNAL abort (no HTTP status channel here)
            if result.status >= 400:
                context.abort(
                    grpc.StatusCode.INTERNAL,
                    f"deployment returned status {result.status}",
                )
            return result.body_bytes()
        if isinstance(result, (bytes, bytearray, memoryview)):
            # memoryview: payload-plane body; grpc wants real bytes
            return bytes(result)
        if isinstance(result, str):
            return result.encode()
        return json.dumps(result).encode()

    _match = HTTPProxy._match
    _refresh_routes = HTTPProxy._refresh_routes

    def stop(self) -> None:
        self._server.stop(grace=0.5)
