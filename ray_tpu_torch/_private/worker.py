"""Driver-process global runtime: init/shutdown and the public verbs.

Parity: python/ray/_private/worker.py in the reference (ray.init :1286,
ray.get :2718, ray.put :2854, ray.wait :2919, ray.kill :3099). The
driver hosts the control hub in-process (a thread) instead of spawning
gcs_server/raylet binaries — on a single host there is no benefit
to extra control processes, and it makes `init()` ~instant.

Port of ``ray_tpu/_private/worker.py``: GPUs take the place of TPU chips
as the pinned accelerator (detected by ``accelerators.gpu`` without
initialising CUDA here), and the runtime is single-node: ``address=``
(client mode against a TCP hub) is not ported yet.
"""

from __future__ import annotations

import atexit
import os
import shutil
import tempfile
import threading
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

from .. import exceptions
from ..object_ref import ObjectRef
from .client import CoreClient
from .hub import Hub
from .ids import ObjectID

_lock = threading.RLock()
_client: Optional[CoreClient] = None
_hub: Optional[Hub] = None
_session_dir: Optional[str] = None
_is_worker = False
_worker_runtime = None  # set by worker_process: get_runtime_context() actor ids


def _set_global_client(client: CoreClient) -> None:
    """Called by worker_process to make the API work inside tasks."""
    global _client, _is_worker
    _client = client
    _is_worker = True


def is_initialized() -> bool:
    return _client is not None


def get_client() -> CoreClient:
    if _client is None:
        init()
    return _client


def init(
    address: Optional[str] = None,
    *,
    num_cpus: Optional[int] = None,
    num_tpus: Optional[int] = None,
    num_gpus: Optional[int] = None,
    resources: Optional[Dict[str, float]] = None,
    namespace: Optional[str] = None,
    ignore_reinit_error: bool = False,
    max_workers: Optional[int] = None,
    worker_env: Optional[Dict[str, str]] = None,
    object_store_memory: Optional[float] = None,
    job_config=None,
    **kwargs,
):
    """Start the runtime (hub thread + on-demand worker pool). Client mode
    (``address="tcp://host:port"``) is not ported yet and raises."""
    global _client, _hub, _session_dir
    if address:
        raise NotImplementedError(
            "init(address=...) (client mode against a TCP hub, multi-host) "
            "is not ported yet; see ROADMAP.md Queue A item 4"
        )
    with _lock:
        if _client is not None:
            if ignore_reinit_error or _is_worker:
                return RuntimeContext()
            raise RuntimeError("ray_tpu_torch.init() called twice; pass ignore_reinit_error=True")
        import sys

        # The hub thread shares this process's GIL; a shorter switch interval
        # keeps control-plane latency low under CPU-bound driver code.
        sys.setswitchinterval(0.001)
        ncpu = num_cpus if num_cpus is not None else (os.cpu_count() or 1)
        res: Dict[str, float] = {"CPU": float(ncpu)}
        # accelerator-manager detection (reference: node resources built
        # from AcceleratorManager plugins) — explicit args still win. GPUs
        # are the pinned accelerator here (RAY_TPU_TORCH_NUM_GPUS, then
        # CUDA_VISIBLE_DEVICES, then nvidia-smi -L; no CUDA context is
        # made in the driver); "TPU" is a plain countable resource.
        from .accelerators import detect_resources

        detected = detect_resources()
        if num_gpus is not None:
            detected.pop("GPU", None)
        res.update(detected)
        ngpu = num_gpus if num_gpus is not None else detected.get("GPU", 0)
        if ngpu:
            res["GPU"] = float(ngpu)
        if num_tpus:
            res["TPU"] = float(num_tpus)
        res["memory"] = float(kwargs.get("_memory", 64 * 1024**3))
        if resources:
            res.update(resources)
        from .session import new_session_dir

        _session_dir = new_session_dir()
        os.makedirs(_session_dir, exist_ok=True)
        _hub = Hub(
            _session_dir,
            res,
            max_workers=max_workers,
            # GPU ids take the place of chip ids; a GPU manager reports no
            # chip coordinates, so the ICI (SLICE) placement stays inert
            tpu_chip_ids=list(range(int(ngpu))) if ngpu else [],
            tpu_chip_coords={},
            worker_env=worker_env,
            # cluster mode: listen on TCP so node agents on other hosts
            # (or simulated hosts in tests) can register
            tcp=bool(kwargs.get("_tcp_hub") or os.environ.get("RAY_TPU_TORCH_TCP_HUB")),
            host=kwargs.get("_hub_host", "127.0.0.1"),
            port=int(kwargs.get("_hub_port", 0)),
            kv_store_path=kwargs.get("_kv_store_path"),
            object_store_memory=object_store_memory,
        )
        _hub.start()
        _client = CoreClient(_hub.addr, _session_dir, role="driver", worker_id="driver")
        _client.start_prewarm(store_cap=_hub.nodes["node0"].store_cap)
        _register_job_config(_client, job_config)
        if os.environ.get("RAY_TPU_TORCH_LOG_TO_DRIVER", "1") != "0":
            _subscribe_worker_logs(_client)
        from . import usage

        usage.flush_pending()
        atexit.register(shutdown)
        return RuntimeContext()


def _register_job_config(client: CoreClient, job_config) -> None:
    """Register the driver's multi-tenant scheduling identity with the
    hub (fairsched): explicit JobConfig wins; otherwise `job submit`'s
    RAY_TPU_TORCH_JOB_* env handoff applies; otherwise stay unregistered (the
    policy engine stays inert for plain single-tenant sessions)."""
    from ..job_config import JobConfig

    if job_config is None:
        job_config = JobConfig.from_env()
    if job_config is None:
        return
    if not isinstance(job_config, JobConfig):
        raise TypeError(
            f"init(job_config=...) expects a ray_tpu_torch.JobConfig, got "
            f"{type(job_config)}"
        )
    client.register_job(
        job_config.job_id, job_config.tenant, job_config.priority,
        job_config.quota,
    )


def _subscribe_worker_logs(client: CoreClient) -> None:
    """Print worker stdout/stderr on the driver with a worker prefix
    (reference: the (fn pid=...) lines ray drivers show)."""
    import sys as _sys

    def on_log(rec):
        stream = _sys.stderr if rec.get("stream") == "stderr" else _sys.stdout
        for line in rec.get("lines", []):
            print(f"(worker pid={rec.get('pid')}) {line}", file=stream)

    client.subscribe("__logs__", on_log)
    from ..experimental import tqdm_ray

    tqdm_ray._driver_subscribe(client)


def shutdown() -> None:
    global _client, _hub, _session_dir
    with _lock:
        if _is_worker:
            return
        # the driver-process sampler (started by the client or the
        # in-process hub) must die with the cluster, or a later init()
        # in the same interpreter would profile into a dead sink
        from . import profiling as _profiling

        _profiling.stop()
        if _client is not None:
            _client.close()
            _client = None
        if _hub is not None:
            _hub.shutdown()
            _hub = None
        if _session_dir is not None:
            shutil.rmtree(_session_dir, ignore_errors=True)
            import tempfile

            shutil.rmtree(
                os.path.join(
                    tempfile.gettempdir(),
                    "ray_tpu_torch_spill_" + os.path.basename(_session_dir),
                ),
                ignore_errors=True,
            )
            _session_dir = None
        try:
            atexit.unregister(shutdown)
        except Exception:
            pass


class RuntimeContext:
    """Returned by init(); mirrors ray's RayContext/RuntimeContext."""

    @property
    def address_info(self) -> dict:
        return {"session_dir": _session_dir, "address": _hub.addr if _hub else None}

    def __enter__(self):
        return self

    def __exit__(self, *a):
        shutdown()

    def _repr_html_(self):
        # Jupyter card (reference: python/ray/widgets context repr).
        from .. import widgets

        res = cluster_resources()
        return widgets.card_html(
            "ray_tpu cluster",
            {
                "address": self.address_info["address"],
                "nodes": len(nodes()),
                "CPU": res.get("CPU", 0),
                "GPU": res.get("GPU", 0),
                "memory": f"{res.get('memory', 0) / 1024**3:.1f} GiB",
            },
        )


# --------------------------------------------------------------------- verbs
def put(value: Any) -> ObjectRef:
    if isinstance(value, ObjectRef):
        raise TypeError("Calling put() on an ObjectRef is not allowed.")
    client = get_client()
    oid = client.put_value(value)
    return ObjectRef(oid, _owned=True)


def get(
    refs: Union[ObjectRef, Sequence[ObjectRef]],
    *,
    timeout: Optional[float] = None,
) -> Any:
    client = get_client()
    if isinstance(refs, ObjectRef):
        return client.get([refs._id], timeout=timeout)[0]
    if not isinstance(refs, (list, tuple)):
        raise TypeError(f"get() expects an ObjectRef or list of ObjectRefs, got {type(refs)}")
    if not refs:
        return []
    for r in refs:
        if not isinstance(r, ObjectRef):
            raise TypeError(f"get() list elements must be ObjectRefs, got {type(r)}")
    return client.get([r._id for r in refs], timeout=timeout)


def wait(
    refs: Sequence[ObjectRef],
    *,
    num_returns: int = 1,
    timeout: Optional[float] = None,
    fetch_local: bool = True,
) -> Tuple[List[ObjectRef], List[ObjectRef]]:
    if isinstance(refs, ObjectRef):
        raise TypeError("wait() expects a list of ObjectRefs")
    if num_returns <= 0:
        raise ValueError("num_returns must be > 0")
    client = get_client()
    # position-based mapping: the wait() pop-loop shape re-calls this
    # with ~the same 1k refs per pop, so a per-call {id: ref} dict build
    # was the dominant client-side cost of the drain (O(n^2) overall);
    # _bin is the construction-time cached raw id (one slot load/ref)
    ready_pos, not_ready_pos = client.wait_pos(
        [r._bin for r in refs], num_returns, timeout
    )
    return [refs[i] for i in ready_pos], [refs[i] for i in not_ready_pos]


def kill(actor, *, no_restart: bool = True) -> None:
    from ..actor import ActorHandle

    if not isinstance(actor, ActorHandle):
        raise TypeError("kill() expects an ActorHandle")
    get_client().kill_actor(actor._actor_id, no_restart=no_restart)


def cancel(ref: ObjectRef, *, force: bool = False, recursive: bool = True) -> None:
    get_client().cancel(ref._id, force=force)


def free(refs: Sequence[ObjectRef]) -> None:
    get_client().free([r._id for r in refs])


def get_actor(name: str, namespace: Optional[str] = None):
    from ..actor import ActorHandle
    from .ids import ActorID

    aid = get_client().get_named_actor(name, namespace)
    if aid is None:
        raise ValueError(f"Failed to look up actor with name '{name}'")
    return ActorHandle(ActorID(aid))


def available_resources() -> Dict[str, float]:
    return get_client().cluster_resources(available=True)


def cluster_resources() -> Dict[str, float]:
    return get_client().cluster_resources(available=False)


def nodes() -> List[dict]:
    return get_client().list_state("nodes")


def timeline(filename: Optional[str] = None) -> List[dict]:
    """Chrome-trace task timeline (reference: ray.timeline) — open the
    returned/saved JSON in chrome://tracing or Perfetto."""
    events = get_client().list_state("timeline")
    if filename:
        import json

        with open(filename, "w") as f:
            json.dump(events, f)
    return events
