"""ray_tpu_torch.serve — model serving.

Parity: python/ray/serve/ (api.py:591 serve.run; @serve.deployment;
DeploymentHandle composition; @serve.batch; controller/replica/proxy
architecture §3.6). GPU angle: replicas with ``num_gpus`` pin cards for
their lifetime (``CUDA_VISIBLE_DEVICES``) so models stay resident on the
card, and @serve.batch feeds them batches sized for its matrix units.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Union

from .batching import batch
from .handle import DeploymentHandle, DeploymentResponse
from .multiplex import get_multiplexed_model_id, multiplexed
from .response import Response
from ._private.controller import CONTROLLER_NAME, DeploymentInfo, ServeController

__all__ = [
    "Application",
    "Deployment",
    "DeploymentHandle",
    "DeploymentResponse",
    "Response",
    "batch",
    "delete",
    "deployment",
    "get_deployment_handle",
    "get_multiplexed_model_id",
    "multiplexed",
    "grpc_port",
    "run",
    "shutdown",
    "start",
    "status",
]


@dataclass
class Application:
    """A bound deployment graph node (parity: serve.Application from
    Deployment.bind)."""

    deployment: "Deployment"
    args: tuple
    kwargs: dict


class Deployment:
    def __init__(
        self,
        func_or_class: Any,
        name: str,
        *,
        num_replicas: Union[int, str, None] = None,
        max_ongoing_requests: int = 16,
        max_queued_requests: int = 0,
        ray_actor_options: Optional[Dict[str, Any]] = None,
        user_config: Any = None,
        autoscaling_config: Optional[Dict[str, Any]] = None,
    ):
        self.func_or_class = func_or_class
        self.name = name
        self.num_replicas = num_replicas
        self.max_ongoing_requests = max_ongoing_requests
        self.max_queued_requests = max_queued_requests
        self.ray_actor_options = ray_actor_options or {}
        self.user_config = user_config
        self.autoscaling_config = autoscaling_config

    def options(self, **opts) -> "Deployment":
        merged = {
            "num_replicas": self.num_replicas,
            "max_ongoing_requests": self.max_ongoing_requests,
            "max_queued_requests": self.max_queued_requests,
            "ray_actor_options": self.ray_actor_options,
            "user_config": self.user_config,
            "autoscaling_config": self.autoscaling_config,
        }
        name = opts.pop("name", self.name)
        merged.update(opts)
        return Deployment(self.func_or_class, name, **merged)

    def bind(self, *args, **kwargs) -> Application:
        return Application(self, args, kwargs)

    def __call__(self, *a, **k):
        raise RuntimeError(
            f"Deployment {self.name!r} cannot be called directly; "
            "use .bind() + serve.run, then handle.remote()"
        )


def deployment(
    _func_or_class: Optional[Any] = None,
    *,
    name: Optional[str] = None,
    num_replicas: Union[int, str, None] = None,
    max_ongoing_requests: int = 16,
    max_queued_requests: int = 0,
    ray_actor_options: Optional[Dict[str, Any]] = None,
    user_config: Any = None,
    autoscaling_config: Optional[Dict[str, Any]] = None,
):
    """@serve.deployment decorator (reference: serve/api.py).
    ``max_queued_requests`` is the admission-control cap: outstanding
    routed requests past it are shed with a retriable error (HTTP 503)
    instead of queueing into a timeout; 0 defers to the
    ``serve_max_queued_requests`` config knob (default unlimited)."""

    def wrap(target):
        return Deployment(
            target,
            name or getattr(target, "__name__", "deployment"),
            num_replicas=num_replicas,
            max_ongoing_requests=max_ongoing_requests,
            max_queued_requests=max_queued_requests,
            ray_actor_options=ray_actor_options,
            user_config=user_config,
            autoscaling_config=autoscaling_config,
        )

    if _func_or_class is not None:
        return wrap(_func_or_class)
    return wrap


# ---------------------------------------------------------------- control


def _get_or_start_controller():
    import ray_tpu_torch

    try:
        return ray_tpu_torch.get_actor(CONTROLLER_NAME)
    except ValueError:
        ctrl_cls = ray_tpu_torch.remote(ServeController)
        try:
            return ctrl_cls.options(
                name=CONTROLLER_NAME, lifetime="detached", max_concurrency=16,
                num_cpus=0.1,
            ).remote()
        except Exception:
            return ray_tpu_torch.get_actor(CONTROLLER_NAME)


_proxy = None
_grpc_proxy = None
_grpc_port = None


def start(*, http_options: Optional[Dict[str, Any]] = None, proxy: bool = False,
          grpc_options: Optional[Dict[str, Any]] = None):
    """Start serve system actors (reference: serve.start). The HTTP
    proxy starts on demand (serve.run(..., route_prefix=...) or
    proxy=True); pass grpc_options={"port": N} for the gRPC ingress
    (reference: serve.start(grpc_options=gRPCOptions(...)))."""
    global _proxy, _grpc_proxy
    import ray_tpu_torch

    if not ray_tpu_torch.is_initialized():
        ray_tpu_torch.init(ignore_reinit_error=True)
    controller = _get_or_start_controller()
    if proxy and _proxy is None:
        opts = http_options or {}
        proxy_cls = ray_tpu_torch.remote(
            __import__(
                "ray_tpu_torch.serve._private.proxy", fromlist=["HTTPProxy"]
            ).HTTPProxy
        )
        _proxy = proxy_cls.options(max_concurrency=64, num_cpus=0.1).remote(
            opts.get("host", "127.0.0.1"), opts.get("port", 8000)
        )
        ray_tpu_torch.get(_proxy.ping.remote())
    if grpc_options is not None and _grpc_proxy is None:
        grpc_cls = ray_tpu_torch.remote(
            __import__(
                "ray_tpu_torch.serve._private.proxy", fromlist=["GrpcIngress"]
            ).GrpcIngress
        )
        _grpc_proxy = grpc_cls.options(
            max_concurrency=64, num_cpus=0.1
        ).remote(
            grpc_options.get("host", "127.0.0.1"),
            grpc_options.get("port", 9000),
        )
        # ping returns the BOUND port (0 = ephemeral pick)
        global _grpc_port
        _grpc_port = ray_tpu_torch.get(_grpc_proxy.ping.remote())
    return controller


def grpc_port() -> int:
    """The gRPC ingress's bound port (after serve.start(grpc_options=...));
    raises if the ingress is not running."""
    if _grpc_port is None:
        raise RuntimeError(
            "gRPC ingress is not running; pass grpc_options to serve.start"
        )
    return _grpc_port


def _collect_deployments(app: Application, out: Dict[str, DeploymentInfo], route_prefix):
    """DFS the bound graph: child Applications in args become
    DeploymentHandles (model composition)."""

    def convert(v):
        if isinstance(v, Application):
            _collect_deployments(v, out, None)
            return DeploymentHandle(v.deployment.name)
        return v

    args = tuple(convert(a) for a in app.args)
    kwargs = {k: convert(v) for k, v in app.kwargs.items()}
    d = app.deployment
    num = d.num_replicas
    if num in (None, "auto"):
        num = (d.autoscaling_config or {}).get("min_replicas", 1)
    out[d.name] = DeploymentInfo(
        name=d.name,
        cls=d.func_or_class,
        init_args=args,
        init_kwargs=kwargs,
        num_replicas=int(num),
        max_ongoing_requests=d.max_ongoing_requests,
        max_queued_requests=d.max_queued_requests,
        ray_actor_options=d.ray_actor_options,
        user_config=d.user_config,
        autoscaling_config=d.autoscaling_config,
        route_prefix=route_prefix,
    )


def run(
    app: Application,
    *,
    name: str = "default",
    route_prefix: Optional[str] = None,
    blocking: bool = False,
    local_testing_mode: bool = False,
    _http: bool = False,
    http_options: Optional[Dict[str, Any]] = None,
) -> DeploymentHandle:
    """Deploy an application; returns the ingress deployment's handle
    (reference: serve.run, api.py:591). ``local_testing_mode=True``
    runs the whole app in-process with no cluster (reference:
    serve/_private/local_testing_mode.py)."""
    import ray_tpu_torch

    if local_testing_mode:
        from ._private.local_testing_mode import run_local

        return run_local(app)  # type: ignore[return-value]

    controller = start(proxy=_http or route_prefix is not None, http_options=http_options)
    infos: Dict[str, DeploymentInfo] = {}
    _collect_deployments(app, infos, route_prefix)
    # submit every deploy before blocking (controller tasks execute in
    # submission order); unlike the old one-at-a-time loop, a failing
    # deploy no longer stops later ones from being submitted, so on
    # failure tear the whole app down rather than leave it half-live
    try:
        ray_tpu_torch.get([controller.deploy.remote(info) for info in infos.values()])
    except Exception:
        down = [controller.delete_deployment.remote(n) for n in infos]
        try:
            ray_tpu_torch.get(down)
        except Exception:
            pass
        raise
    # wait until every deployment has live replicas; poll cadence backs
    # off gently so a slow first deploy doesn't hammer the controller
    deadline = time.monotonic() + 60
    delay = 0.05
    while time.monotonic() < deadline:
        if ray_tpu_torch.get(controller.ready.remote()):  # graftlint: disable=GL004 — readiness poll
            break
        time.sleep(delay)
        delay = min(0.5, delay * 1.5)
    handle = DeploymentHandle(app.deployment.name)
    if blocking:
        try:
            while True:
                time.sleep(1)
        except KeyboardInterrupt:
            pass
    return handle


def get_deployment_handle(deployment_name: str, app_name: str = "default") -> DeploymentHandle:
    return DeploymentHandle(deployment_name)


def status() -> Dict[str, Any]:
    import ray_tpu_torch

    try:
        controller = ray_tpu_torch.get_actor(CONTROLLER_NAME)
    except ValueError:
        return {"applications": {}}
    return {"applications": ray_tpu_torch.get(controller.list_deployments.remote())}


def delete(name: str) -> None:
    import ray_tpu_torch

    controller = ray_tpu_torch.get_actor(CONTROLLER_NAME)
    ray_tpu_torch.get(controller.delete_deployment.remote(name))


def shutdown() -> None:
    global _proxy, _grpc_proxy, _grpc_port
    import ray_tpu_torch

    try:
        controller = ray_tpu_torch.get_actor(CONTROLLER_NAME)
        ray_tpu_torch.get(controller.shutdown.remote())
        ray_tpu_torch.kill(controller)
    except Exception:
        pass
    if _proxy is not None:
        try:
            ray_tpu_torch.kill(_proxy)
        except Exception:
            pass
        _proxy = None
    if _grpc_proxy is not None:
        try:
            ray_tpu_torch.get(_grpc_proxy.stop.remote(), timeout=5)  # graftlint: disable=GL017 — bounded shutdown drain, requests already rejected
        except Exception:
            pass
        try:
            ray_tpu_torch.kill(_grpc_proxy)
        except Exception:
            pass
        _grpc_proxy = None
        _grpc_port = None

from ray_tpu_torch._private import usage as _usage

_usage.record_library_usage("serve")
