"""Worker process: executes tasks and hosts actors.

The analogue of the reference's default_worker.py + the execution half
of CoreWorker (reference: python/ray/_private/workers/default_worker.py,
src/ray/core_worker/transport/task_receiver.h). One process executes one
task at a time; an actor pins its process for its lifetime (the
reference's WorkerPool does the same, src/ray/raylet/worker_pool.h).

Concurrency model per the reference's scheduling queues
(src/ray/core_worker/transport/):
  - plain tasks and sync actors: strict FIFO on the main executor thread
    (ActorSchedulingQueue ordering),
  - actors with max_concurrency>1: a thread pool (concurrency groups),
  - async actors (coroutine methods): a persistent asyncio event loop,
    many calls in flight (the reference runs async actors on an asyncio
    loop owned by the core worker).

GPU visibility (the port's counterpart of the reference's TPU chip
visibility): the hub assigns GPU ids at dispatch and they stay pinned to
the worker. A worker starts with CUDA_VISIBLE_DEVICES="" (it sees no
card) and exports its ids before user code first touches CUDA — what
the reference does with TPU_VISIBLE_CHIPS before jax is imported, and
what GPUAcceleratorManager.set_current_process_visible_accelerators
does in Ray (python/ray/_private/accelerators/nvidia_gpu.py).
"""

from __future__ import annotations

import asyncio
import os
import sys
import threading
import time
import traceback
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, Optional

from . import profiling as _prof
from . import protocol as P
from .client import CoreClient
from .serialization import dumps_inline, loads_function, loads_inline
from ..util import tracing as _t
from .accelerators import gpu as _gpu
from .accelerators.gpu import VISIBLE_ENV, visible_ids

# the driver's CUDA_VISIBLE_DEVICES, read before this process narrows it:
# GPU ids index into it (and are physical ids when it was unset)
_DRIVER_VISIBLE = os.environ.get(VISIBLE_ENV)


def _pin_gpus(ids) -> None:
    _gpu.pinned_positions[:] = [int(i) for i in ids]
    base = visible_ids(_DRIVER_VISIBLE)
    os.environ[VISIBLE_ENV] = ",".join(
        base[i] if base is not None else str(i) for i in ids
    )


class _ExecTrace:
    """Runtime spans for one traced task execution (the exec payload
    carried a "trace" field — sampling decided at the CLIENT; this
    class never runs for untraced tasks). Collects monotonic stamps
    around the three worker stages (arg fetch, execute, result store),
    holds the ambient tracing context during the function body so
    nested submits and user spans stitch into the trace, and ships the
    finished spans through the worker's existing hub connection."""

    __slots__ = ("client", "trace_id", "parent", "exec_id", "t", "_tok")

    def __init__(self, client, trace):
        self.client = client
        self.trace_id, self.parent = trace[0], trace[1]
        self.exec_id = _t.new_span_id()  # parent for nested work
        self.t: Dict[str, float] = {"start": time.monotonic()}
        self._tok = None

    def stamp(self, key: str) -> None:
        self.t[key] = time.monotonic()

    def enter_exec(self) -> None:
        self.stamp("exec0")
        self._tok = _t.push_context((self.trace_id, self.exec_id))

    def exit_exec(self) -> None:
        if self._tok is not None:
            _t.pop_context(self._tok)
            self._tok = None
        self.stamp("exec1")

    def emit(self, name: str, error: Optional[str] = None,
             **extra) -> None:
        t = self.t
        recs = []
        if "args0" in t and "args1" in t:
            recs.append(_t.make_runtime_record(
                "worker.arg_fetch", "arg_fetch", self.trace_id,
                self.parent, t["args0"], t["args1"],
            ))
        if "exec0" in t:
            attrs = {"name": name, **extra}
            if error is not None:
                attrs["error"] = error
            recs.append(_t.make_runtime_record(
                "worker.execute", "execute", self.trace_id, self.parent,
                t["exec0"], t.get("exec1", time.monotonic()),
                span_id=self.exec_id, attrs=attrs,
            ))
        elif error is not None:
            # failed before the body ran (fn fetch / arg decode): the
            # error span still lands so the trace shows WHERE it died
            recs.append(_t.make_runtime_record(
                "worker.execute", "execute", self.trace_id, self.parent,
                t["start"], time.monotonic(), span_id=self.exec_id,
                attrs={"name": name, "error": error},
            ))
        if "store0" in t and "store1" in t:
            recs.append(_t.make_runtime_record(
                "worker.result_store", "result_store", self.trace_id,
                self.parent, t["store0"], t["store1"],
            ))
        try:
            for rec in recs:
                self.client.send_async(P.SPAN_RECORD, rec)
        except Exception:
            pass  # tracing must never fail the task


class WorkerRuntime:
    def __init__(self, client: CoreClient):
        self.client = client
        self.fn_cache: Dict[str, Any] = {}
        self.actor_instance: Any = None
        self.actor_id: Optional[bytes] = None
        self.actor_restarted = False
        self.actor_pg: Optional[tuple] = None  # (pg_id, bundle_idx)
        self.pool: Optional[ThreadPoolExecutor] = None
        self.aio_loop: Optional[asyncio.AbstractEventLoop] = None

    # ----------------------------------------------------------- arg decode
    def _decode_args(self, args_kind: str, args_payload: Any):
        if args_kind == "inline":
            args, kwargs = loads_inline(args_payload)
        else:  # "ref": oversized arg tuple was spilled to the object store
            from .ids import ObjectID

            args, kwargs = self.client.get([ObjectID(args_payload)])[0]
        args = tuple(self._resolve(a) for a in args)
        kwargs = {k: self._resolve(v) for k, v in kwargs.items()}
        return args, kwargs

    def _resolve(self, v):
        from ..object_ref import ObjectRef

        if isinstance(v, ObjectRef):
            return self.client.get([v._id])[0]
        return v

    def _get_fn(self, fn_id: str, fn_blob):
        fn = self.fn_cache.get(fn_id)
        if fn is None:
            if fn_blob is None:
                reply = self.client.request(P.GET_FUNCTION, {"fn_id": fn_id})
                fn_blob = reply["blob"]
            fn = loads_function(fn_blob)
            self.fn_cache[fn_id] = fn
        return fn

    def _store_returns(self, return_ids, result, num_expected):
        from .ids import ObjectID

        if num_expected == 1:
            values = [result]
        elif num_expected == 0:
            values = []
        else:
            values = list(result)
            if len(values) != num_expected:
                raise ValueError(
                    f"task declared num_returns={num_expected} but returned {len(values)} values"
                )
        out = []
        for oid_bytes, val in zip(return_ids, values):
            kind, payload, size = self.client.encode_value(ObjectID(oid_bytes), val)
            out.append((oid_bytes, kind, payload, size))
        return out

    def _error_returns(self, return_ids, fn_name: str):
        from ..exceptions import TaskCancelledError, TaskError

        tb = traceback.format_exc()
        exc_type, exc, _ = sys.exc_info()
        if exc_type is KeyboardInterrupt:
            # hub-sent SIGINT = cooperative cancellation (ray.cancel)
            err: Exception = TaskCancelledError("task was cancelled")
        else:
            # keep the original exception as the cause (retry_exceptions
            # type filters and user handlers match on it); fall back to
            # cause=None when it does not pickle
            err = TaskError(fn_name, tb, cause=exc)
        try:
            blob = dumps_inline(err)
        except Exception:
            try:
                err = TaskError(fn_name, tb, cause=None)
                blob = dumps_inline(err)
            except Exception:
                blob = dumps_inline(TaskError(fn_name, tb))
        return [(oid, P.VAL_ERROR, blob, 0) for oid in return_ids]

    def _stream_yield_one(self, p: dict, value) -> None:
        from .ids import ObjectID

        oid = ObjectID.generate()
        kind, payload, size = self.client.encode_value(oid, value)
        self.client.send(
            P.STREAM_YIELD,
            {
                "task_id": p["task_id"],
                "object_id": oid.binary(),
                "kind": kind,
                "payload": payload,
                "size": size,
            },
        )

    def _stream_results(self, p: dict, gen) -> None:
        """Drive a generator task: yield values become incremental stream
        objects (reference: streaming generator protocol, the worker
        reports each return as it is produced, _raylet.pyx:280). The
        TASK_DONE at the end frees the worker; the stream itself ends via
        STREAM_END (error carried as the stream's final object)."""
        task_id = p["task_id"]
        bp = (p.get("options") or {}).get("_generator_backpressure_num_objects")
        try:
            idx = 0
            for value in gen:
                self._stream_yield_one(p, value)
                idx += 1
                if bp and idx >= bp:
                    # wait until the consumer is within the window
                    self.client.request(
                        P.STREAM_CREDIT,
                        {"task_id": task_id, "min_consumed": idx - bp + 1},
                    )
            self.client.send(P.STREAM_END, {"task_id": task_id, "error": None})
        except Exception:
            from ..exceptions import TaskError

            err = TaskError("streaming_generator", traceback.format_exc())
            self.client.send(
                P.STREAM_END, {"task_id": task_id, "error": dumps_inline(err)}
            )
        self.client.send(P.TASK_DONE, {"task_id": task_id, "returns": []})

    def _adopt_job_identity(self, p: dict) -> None:
        """Inherit the submitting job's scheduling identity (fairsched
        tenant/priority/job_id, forwarded in the exec options) so
        NESTED submits from inside this task are stamped with it —
        quota admission and fair-share accounting must not be escapable
        by fanning work out through a worker. Context-local, not client
        fields: a max_concurrency actor serves different tenants
        concurrently, and caller A's nested submits must never carry
        caller B's identity."""
        from .client import _job_identity

        opts = p.get("options") or {}
        try:
            priority = int(opts.get("priority") or 0)
        except (TypeError, ValueError):
            priority = 0
        _job_identity.set(
            (opts.get("job_id"), opts.get("tenant"), priority)
        )

    def _chaos_stall(self) -> None:
        """Fault injection (chaos.py, "worker" scope): a
        ``delay:worker.exec@lo-hi`` rule stalls the task body before it
        runs — an in-worker slow-execute fault that needs no signals
        (the SIGSTOP-style stall is the hub's worker_hang). Inert (one
        attribute load) without a plan."""
        eng = self.client._chaos
        if eng is not None:
            act = eng.message_action("exec")
            if act is not None and act[0] == "delay":
                time.sleep(act[1])

    # ------------------------------------------------------------ execution
    def exec_task(self, p: dict):
        self._adopt_job_identity(p)
        self._chaos_stall()
        if p.get("tpu_chips"):
            _pin_gpus(p["tpu_chips"])
        from ..runtime_context import _current_pg

        pg = (p.get("options") or {}).get("placement_group")
        _current_pg.set(tuple(pg) if pg else None)
        fn_name = p["fn_id"]
        tr = p.get("trace")
        et = _ExecTrace(self.client, tr) if tr is not None else None
        try:
            fn = self._get_fn(p["fn_id"], p.get("fn_blob"))
            fn_name = getattr(fn, "__name__", fn_name)
            if et is not None:
                et.stamp("args0")
            args, kwargs = self._decode_args(p["args_kind"], p["args_payload"])
            if et is not None:
                et.stamp("args1")
                et.enter_exec()
            try:
                result = fn(*args, **kwargs)
            finally:
                if et is not None:
                    et.exit_exec()
            if (p.get("options") or {}).get("streaming"):
                if et is not None:
                    # the generator body runs lazily inside
                    # _stream_results; the execute span here covers
                    # only its construction
                    et.emit(fn_name, streaming=True)
                self._stream_results(p, result)
                return
            if et is not None:
                et.stamp("store0")
            returns = self._store_returns(p["return_ids"], result, len(p["return_ids"]))
            if et is not None:
                et.stamp("store1")
                et.emit(fn_name)
        except (Exception, KeyboardInterrupt):
            if et is not None:
                et.exit_exec()
                et.emit(fn_name, error=sys.exc_info()[0].__name__)
            if (p.get("options") or {}).get("streaming"):
                # failed before the generator started: the stream (not
                # return objects) carries the error
                self._stream_fail(p, fn_name)
                return
            returns = self._error_returns(p["return_ids"], fn_name)
        self._send_done({"task_id": p["task_id"], "returns": returns})

    def _send_done(self, payload: dict) -> None:
        """TASK_DONE with load-adaptive batching: while more work is
        queued, completions ride the async buffer (the next send — or
        the flusher — coalesces them into one hub message); when the
        queue is empty, send immediately for latency. send() flushes
        the buffer first, so completion order is preserved."""
        if self.client.task_queue.qsize() > 0:
            self.client.send_async(P.TASK_DONE, payload)
        else:
            self.client.send(P.TASK_DONE, payload)

    def reply_cancelled(self, p: dict) -> None:
        # the reader thread already resolved the caller (CANCEL_TASK
        # fast path); dequeue just discards the stale assignment
        self.client.cancelled_tasks.discard(p["task_id"])

    def _stream_fail(self, p: dict, name: str) -> None:
        from ..exceptions import TaskError

        err = TaskError(name, traceback.format_exc())
        self.client.send(
            P.STREAM_END, {"task_id": p["task_id"], "error": dumps_inline(err)}
        )
        self.client.send(P.TASK_DONE, {"task_id": p["task_id"], "returns": []})

    def exec_actor_create(self, p: dict):
        self._adopt_job_identity(p)
        if p.get("tpu_chips"):
            _pin_gpus(p["tpu_chips"])
        # the hub marks respawned incarnations so user __init__ can
        # branch on was_current_actor_reconstructed; always assigned so
        # a later actor on a reused worker never inherits the flag
        self.actor_restarted = bool((p.get("options") or {}).get("_restarted"))
        from ..runtime_context import _current_pg

        pg = (p.get("options") or {}).get("placement_group")
        self.actor_pg = tuple(pg) if pg else None
        _current_pg.set(self.actor_pg)
        try:
            cls = self._get_fn(p["fn_id"], p.get("fn_blob"))
            args, kwargs = self._decode_args(p["args_kind"], p["args_payload"])
            self.actor_instance = cls(*args, **kwargs)
            self.actor_id = p["actor_id"]
            maxc = (p.get("options") or {}).get("max_concurrency") or 1
            if maxc > 1:
                self.pool = ThreadPoolExecutor(max_workers=maxc)
            self.client.send(P.ACTOR_READY, {"actor_id": p["actor_id"], "error": None})
        except Exception:
            from ..exceptions import TaskError

            err = TaskError(p["fn_id"], traceback.format_exc())
            self.client.send(
                P.ACTOR_READY, {"actor_id": p["actor_id"], "error": dumps_inline(err)}
            )

    def _run_actor_method(self, p: dict):
        # pool threads don't inherit the main loop's contextvars: pin
        # the task id (and the caller's job identity, for nested
        # submits) here so get_runtime_context() and fairsched stamping
        # work under max_concurrency > 1
        from ..runtime_context import _current_pg, _current_task_id

        _current_task_id.set(p.get("task_id"))
        if _prof._ACTIVE:  # sample attribution for pool threads
            _prof.set_task(p.get("task_id"))
        _current_pg.set(getattr(self, "actor_pg", None))
        self._adopt_job_identity(p)
        self._chaos_stall()
        method_name = p["method"]
        tr = p.get("trace")
        et = _ExecTrace(self.client, tr) if tr is not None else None
        try:
            if method_name == "__ray_ready__":
                result = None
            elif method_name == "__ray_terminate__":
                self.client.send(
                    P.TASK_DONE,
                    {
                        "task_id": p["task_id"],
                        "returns": self._store_returns(p["return_ids"], None, len(p["return_ids"])),
                    },
                )
                os._exit(0)
            elif method_name == "__ray_call__":
                # run an arbitrary callable against the actor instance
                # (reference: ray's ActorHandle.__ray_call__)
                args, kwargs = self._decode_args(p["args_kind"], p["args_payload"])
                fn, rest = args[0], args[1:]
                result = fn(self.actor_instance, *rest, **kwargs)
            else:
                method = getattr(self.actor_instance, method_name)
                if et is not None:
                    et.stamp("args0")
                args, kwargs = self._decode_args(p["args_kind"], p["args_payload"])
                if et is not None:
                    et.stamp("args1")
                    et.enter_exec()
                try:
                    result = method(*args, **kwargs)
                finally:
                    if et is not None:
                        et.exit_exec()
            if (p.get("options") or {}).get("streaming"):
                if et is not None:
                    et.emit(method_name, streaming=True)
                self._stream_results(p, result)
                return
            if et is not None:
                et.stamp("store0")
            returns = self._store_returns(p["return_ids"], result, len(p["return_ids"]))
            if et is not None:
                et.stamp("store1")
                et.emit(method_name)
        except Exception:
            if et is not None:
                et.exit_exec()
                et.emit(method_name, error=sys.exc_info()[0].__name__)
            if (p.get("options") or {}).get("streaming"):
                self._stream_fail(p, method_name)
                return
            returns = self._error_returns(p["return_ids"], method_name)
        self._send_done({"task_id": p["task_id"], "returns": returns})

    def _ensure_aio_loop(self):
        if self.aio_loop is None:
            self.aio_loop = asyncio.new_event_loop()
            t = threading.Thread(target=self.aio_loop.run_forever, daemon=True, name="actor-aio")
            t.start()
        return self.aio_loop

    def exec_actor_task(self, p: dict):
        self._adopt_job_identity(p)
        import inspect

        method = getattr(type(self.actor_instance), p["method"], None) if p["method"] not in (
            "__ray_ready__",
            "__ray_terminate__",
        ) else None
        if (
            method is not None
            and inspect.isasyncgenfunction(method)
            and (p.get("options") or {}).get("streaming")
        ):
            loop = self._ensure_aio_loop()

            async def run_stream():
                try:
                    args, kwargs = self._decode_args(p["args_kind"], p["args_payload"])
                    agen = method(self.actor_instance, *args, **kwargs)
                    items = []
                    async for v in agen:
                        items.append(v)
                        # flush incrementally: one yield per item keeps
                        # streaming semantics without a sync bridge
                        self._stream_yield_one(p, v)
                    self.client.send(
                        P.STREAM_END, {"task_id": p["task_id"], "error": None}
                    )
                except Exception:
                    from ..exceptions import TaskError

                    err = TaskError(p["method"], traceback.format_exc())
                    self.client.send(
                        P.STREAM_END,
                        {"task_id": p["task_id"], "error": dumps_inline(err)},
                    )
                self.client.send(
                    P.TASK_DONE, {"task_id": p["task_id"], "returns": []}
                )

            asyncio.run_coroutine_threadsafe(run_stream(), loop)
        elif method is not None and asyncio.iscoroutinefunction(method):
            loop = self._ensure_aio_loop()

            async def run():
                # coroutines interleave on the one aio thread, so the
                # thread-keyed register is last-writer-wins: a sample
                # lands on whichever call most recently resumed — the
                # one holding the loop between awaits, which is the one
                # burning the CPU being sampled
                if _prof._ACTIVE:
                    _prof.set_task(p.get("task_id"))
                tr = p.get("trace")
                et = _ExecTrace(self.client, tr) if tr is not None else None
                try:
                    if et is not None:
                        et.stamp("args0")
                    args, kwargs = self._decode_args(p["args_kind"], p["args_payload"])
                    if et is not None:
                        et.stamp("args1")
                        et.enter_exec()
                    try:
                        result = await method(self.actor_instance, *args, **kwargs)
                    finally:
                        if et is not None:
                            et.exit_exec()
                    if et is not None:
                        et.stamp("store0")
                    returns = self._store_returns(p["return_ids"], result, len(p["return_ids"]))
                    if et is not None:
                        et.stamp("store1")
                        et.emit(p["method"])
                except Exception:
                    if et is not None:
                        et.exit_exec()
                        et.emit(p["method"], error=sys.exc_info()[0].__name__)
                    returns = self._error_returns(p["return_ids"], p["method"])
                self._send_done({"task_id": p["task_id"], "returns": returns})

            asyncio.run_coroutine_threadsafe(run(), loop)
        elif self.pool is not None:
            self.pool.submit(self._run_actor_method, p)
        else:
            self._run_actor_method(p)


def _setup_runtime_env(client, session_dir: str) -> None:
    """Materialize this worker's runtime env (reference: the runtime-env
    agent's env-context application, runtime_env_agent.py:303): env_vars
    into the process env; working_dir fetched by URI from the cluster KV
    once per content hash (cached extract dir) then chdir + sys.path."""
    import json

    renv_json = os.environ.get("RAY_TPU_TORCH_RUNTIME_ENV")
    if not renv_json:
        return
    renv = json.loads(renv_json)
    for k, v in (renv.get("env_vars") or {}).items():
        os.environ[k] = v
    # conda was handled pre-connect in main() (execv re-entry)
    if renv.get("pip"):
        _materialize_pip_env(client, session_dir, renv["pip"])
    for mod_uri in renv.get("py_modules") or ():
        # reference: py_modules.py — one cached extract dir per content
        # hash, prepended to sys.path (no chdir, unlike working_dir)
        target = os.path.join(session_dir, "runtime_envs", f"pymod_{mod_uri}")
        if not os.path.isdir(target):
            blob = client.kv_get(f"__runtime_env_pkg__{mod_uri}".encode())
            if blob is None:
                raise RuntimeError(
                    f"runtime env py_module {mod_uri} missing from KV"
                )
            import io
            import zipfile

            tmp = target + f".tmp.{os.getpid()}"
            os.makedirs(tmp, exist_ok=True)
            with zipfile.ZipFile(io.BytesIO(blob)) as zf:
                zf.extractall(tmp)
            try:
                os.replace(tmp, target)
            except OSError:
                import shutil

                shutil.rmtree(tmp, ignore_errors=True)
        sys.path.insert(0, target)
    uri = renv.get("working_dir_uri")
    if uri:
        import zipfile

        target = os.path.join(session_dir, "runtime_envs", uri)
        if not os.path.isdir(target):
            blob = client.kv_get(f"__runtime_env_pkg__{uri}".encode())
            if blob is None:
                raise RuntimeError(f"runtime env package {uri} missing from KV")
            tmp = target + f".tmp.{os.getpid()}"
            os.makedirs(tmp, exist_ok=True)
            import io

            with zipfile.ZipFile(io.BytesIO(blob)) as zf:
                zf.extractall(tmp)
            try:
                os.replace(tmp, target)
            except OSError:
                # another worker won the race; use its copy
                import shutil

                shutil.rmtree(tmp, ignore_errors=True)
        os.chdir(target)
        sys.path.insert(0, target)


def _materialize_conda_env(spec: dict) -> None:
    """Re-exec this worker inside a conda env (reference:
    _private/runtime_env/conda.py — get_or_create_conda_env + the
    context's python override). Named envs resolve directly; dict specs
    materialize once per content hash under the conda root, guarded by
    the same create-exclusive lock pattern as the pip cache. Requires a
    conda/mamba/micromamba binary (RAY_TPU_TORCH_CONDA_EXE, CONDA_EXE, or
    PATH) — absent tooling fails loudly at task dispatch, matching the
    reference's behavior when conda is not installed."""
    import hashlib
    import json as _json
    import shutil
    import subprocess
    import time

    if os.environ.get("RAY_TPU_TORCH_IN_CONDA_ENV"):
        return  # already re-exec'd inside the target env
    exe = os.environ.get("RAY_TPU_TORCH_CONDA_EXE") or os.environ.get("CONDA_EXE")
    if not exe:
        for cand in ("conda", "mamba", "micromamba"):
            exe = shutil.which(cand)
            if exe:
                break
    if not exe:
        raise RuntimeError(
            "runtime_env conda requires a conda/mamba/micromamba binary "
            "(set RAY_TPU_TORCH_CONDA_EXE or install one); none found on PATH"
        )
    if spec.get("name"):
        # named env: resolve its prefix via conda itself
        out = subprocess.run(
            [exe, "env", "list", "--json"], capture_output=True, text=True,
            timeout=60,
        )
        envs = _json.loads(out.stdout or "{}").get("envs", [])
        prefix = next(
            (e for e in envs if os.path.basename(e) == spec["name"]), None
        )
        if prefix is None:
            raise RuntimeError(f"conda env {spec['name']!r} not found")
    else:
        blob = _json.dumps(spec["spec"], sort_keys=True).encode()
        env_id = hashlib.sha1(blob).hexdigest()[:16]
        root = os.environ.get(
            "RAY_TPU_TORCH_CONDA_ENV_ROOT",
            os.path.join(os.path.expanduser("~"), ".ray_tpu_conda_envs"),
        )
        prefix = os.path.join(root, env_id)
        done = os.path.join(prefix, ".create_done")
        if not os.path.exists(done):
            os.makedirs(root, exist_ok=True)
            lock = os.path.join(root, f"{env_id}.lock")
            deadline = time.monotonic() + 1800
            acquired = False
            while time.monotonic() < deadline:
                try:
                    fd = os.open(lock, os.O_CREAT | os.O_EXCL | os.O_WRONLY)
                    os.close(fd)
                    acquired = True
                    break
                except FileExistsError:
                    if os.path.exists(done):
                        break
                    time.sleep(0.5)
            if acquired:
                try:
                    if not os.path.exists(done):
                        spec_file = os.path.join(root, f"{env_id}.yml")
                        with open(spec_file, "w") as f:
                            _json.dump(spec["spec"], f)
                        proc = subprocess.run(
                            [exe, "env", "create", "--prefix", prefix,
                             "--file", spec_file, "--json"],
                            capture_output=True, text=True, timeout=1700,
                        )
                        if proc.returncode != 0:
                            # a partial prefix poisons every retry
                            # (conda refuses an existing non-empty dir)
                            shutil.rmtree(prefix, ignore_errors=True)
                            raise RuntimeError(
                                f"conda env create failed:\n{proc.stderr}"
                            )
                        with open(done, "w") as f:
                            f.write(env_id)
                finally:
                    try:
                        os.unlink(lock)
                    except OSError:
                        pass
            if not os.path.exists(done):
                raise RuntimeError(
                    f"conda env create did not complete for {env_id}"
                )
    env_python = os.path.join(prefix, "bin", "python")
    if not os.path.exists(env_python):
        raise RuntimeError(f"conda env at {prefix} has no python")
    # the env's interpreter must also see ray_tpu itself
    os.environ["RAY_TPU_TORCH_IN_CONDA_ENV"] = prefix
    os.environ["PYTHONPATH"] = os.pathsep.join(
        dict.fromkeys(
            [os.path.dirname(os.path.dirname(os.path.dirname(
                os.path.abspath(__file__))))]
            + os.environ.get("PYTHONPATH", "").split(os.pathsep)
        )
    ).rstrip(os.pathsep)
    os.execv(env_python, [env_python, "-m", "ray_tpu_torch._private.worker_process"])


def _materialize_pip_env(client, session_dir: str, spec: dict) -> None:
    """Install the env's requirements into a per-node content-hash
    cached directory and prepend it to sys.path (reference:
    _private/runtime_env/pip.py virtualenv build + uri_cache.py; here
    the interpreter is shared, so isolation is an import-path overlay
    rather than a separate venv — workers only serve matching
    runtime_env hashes, so cross-env leakage cannot happen).

    Shipped wheels install offline (--no-index --find-links on the KV
    fetch dir); plain requirements go to the configured index and fail
    loudly without egress."""
    import hashlib
    import json as _json
    import subprocess
    import time

    key = _json.dumps(spec, sort_keys=True).encode()
    env_id = hashlib.sha1(key).hexdigest()[:16]
    base = os.path.join(session_dir, "runtime_envs")
    target = os.path.join(base, f"pip_{env_id}")
    done = os.path.join(target, ".install_done")
    if not os.path.exists(done):
        os.makedirs(base, exist_ok=True)
        lock = os.path.join(base, f"pip_{env_id}.lock")
        acquired = False
        deadline = time.monotonic() + 300
        while time.monotonic() < deadline:
            try:
                fd = os.open(lock, os.O_CREAT | os.O_EXCL | os.O_WRONLY)
                os.close(fd)
                acquired = True
                break
            except FileExistsError:
                if os.path.exists(done):
                    break  # another worker finished the install
                try:
                    # break locks orphaned by a killed installer; the
                    # atomic rename means exactly one waiter wins the
                    # break (unlink-by-path could kill a FRESH lock)
                    if time.time() - os.path.getmtime(lock) > 300:
                        claimed = f"{lock}.stale.{os.getpid()}"
                        os.rename(lock, claimed)
                        os.unlink(claimed)
                        continue
                except OSError:
                    continue  # lock vanished or another waiter won
                time.sleep(0.2)
        if acquired:
            try:
                if not os.path.exists(done):
                    args = [sys.executable, "-m", "pip", "install",
                            "--quiet", "--no-warn-script-location",
                            "--target", target]
                    wheels = spec.get("wheels") or {}  # uri -> filename
                    wheel_paths = []
                    for uri, fname in wheels.items():
                        blob = client.kv_get(
                            f"__runtime_env_whl__{uri}".encode()
                        )
                        if blob is None:
                            raise RuntimeError(
                                f"runtime env wheel {fname} missing from KV"
                            )
                        # one subdir per content hash: same-named wheels
                        # with different contents cannot collide
                        wdir = os.path.join(target, ".wheels", uri)
                        os.makedirs(wdir, exist_ok=True)
                        wpath = os.path.join(wdir, fname)
                        with open(wpath, "wb") as f:
                            f.write(blob)
                        wheel_paths.append(wpath)
                    # every wheel dir is a findable index so a shipped
                    # wheel can satisfy another shipped wheel's
                    # dependency; wheels-only installs are fully offline
                    for wpath in wheel_paths:
                        args += ["--find-links", os.path.dirname(wpath)]
                    if wheels and not spec.get("reqs"):
                        args += ["--no-index"]
                    args += list(spec.get("reqs") or [])
                    args += wheel_paths
                    proc = subprocess.run(
                        args, capture_output=True, text=True, timeout=280
                    )
                    if proc.returncode != 0:
                        raise RuntimeError(
                            f"runtime_env pip install failed:\n{proc.stderr}"
                        )
                    with open(done, "w") as f:
                        f.write(env_id)
            finally:
                try:
                    os.unlink(lock)
                except OSError:
                    pass
        if not os.path.exists(done):
            raise RuntimeError(
                f"runtime_env pip install did not complete for {env_id}"
            )
    sys.path.insert(0, target)


class _LogTee:
    """Mirror worker stdout/stderr to the driver (reference: worker log
    redirection + log_monitor.py streaming to the driver). Lines batch
    through the existing hub connection; the original stream still gets
    everything (container logs)."""

    def __init__(self, client, orig, stream_name: str):
        self._client = client
        self._orig = orig
        self._name = stream_name
        self._buf = ""
        self._lock = threading.Lock()

    def _emit(self, lines):
        lines = [l for l in lines if l.strip()]
        if lines:
            try:
                self._client.send_async(
                    P.LOG_RECORD,
                    {"stream": self._name, "lines": lines,
                     "pid": os.getpid()},
                )
            except Exception:
                pass

    def write(self, s):
        self._orig.write(s)
        with self._lock:  # concurrent print()s must not corrupt the buffer
            self._buf += s
            if "\n" not in self._buf:
                return len(s)
            *lines, self._buf = self._buf.split("\n")
        self._emit(lines)
        return len(s)

    def flush(self):
        self._orig.flush()
        with self._lock:
            tail, self._buf = self._buf, ""
        if tail:
            self._emit([tail])

    def __getattr__(self, name):
        return getattr(self._orig, name)


def main():
    sys.setswitchinterval(0.001)
    hub_addr = os.environ["RAY_TPU_TORCH_HUB_ADDR"]
    session_dir = os.environ["RAY_TPU_TORCH_SESSION_DIR"]
    worker_id = os.environ["RAY_TPU_TORCH_WORKER_ID"]
    # conda re-exec must happen BEFORE the hub connection exists: execv
    # closes the socket (CLOEXEC) and the replacement process redoes
    # HELLO — connecting first would surface as a spurious worker death.
    # Materialization failures are RECORDED, not raised: the worker
    # still connects and fails its tasks with the setup error
    # (reference: RuntimeEnvSetupError delivered to the task), instead
    # of dying pre-connect and triggering a respawn storm.
    setup_error: Optional[Exception] = None
    renv_json = os.environ.get("RAY_TPU_TORCH_RUNTIME_ENV")
    if renv_json:
        import json as _json

        conda_spec = _json.loads(renv_json).get("conda")
        if conda_spec:
            try:
                _materialize_conda_env(conda_spec)  # may not return (execv)
            except Exception as e:  # noqa: BLE001
                setup_error = e
    # no card until the hub pins GPU ids to this worker (a num_gpus=0
    # task sees none); set after the conda re-exec, which re-reads
    # _DRIVER_VISIBLE
    os.environ[VISIBLE_ENV] = ""
    client = CoreClient(hub_addr, session_dir, role="worker", worker_id=worker_id)
    if setup_error is None:
        try:
            _setup_runtime_env(client, session_dir)
        except Exception as e:  # noqa: BLE001
            setup_error = e
    if os.environ.get("RAY_TPU_TORCH_LOG_TO_DRIVER", "1") != "0":
        sys.stdout = _LogTee(client, sys.stdout, "stdout")
        sys.stderr = _LogTee(client, sys.stderr, "stderr")

    # make ray_tpu_torch.* API work inside tasks (auto-connect)
    from . import worker as worker_mod

    worker_mod._set_global_client(client)

    rt = WorkerRuntime(client)
    worker_mod._worker_runtime = rt  # get_runtime_context() actor ids

    from ..runtime_context import _current_task_id

    while True:
        try:
            msg_type, payload = client.task_queue.get()
            if isinstance(payload, dict) and "task_id" in payload:
                _current_task_id.set(payload["task_id"])
                if _prof._ACTIVE:  # sample attribution (profiler on)
                    _prof.set_task(payload["task_id"])
            if msg_type == P.KILL:
                # a just-finished task's TASK_DONE may still sit in the
                # async send buffer (_send_done batching) — flush so the
                # hub never retries a task that already completed
                try:
                    client.flush()
                except Exception:
                    pass
                os._exit(0)
            elif msg_type in (P.EXEC_TASK, P.EXEC_ACTOR_TASK) and (
                payload["task_id"] in client.cancelled_tasks
            ):
                rt.reply_cancelled(payload)
            elif setup_error is not None and msg_type in (
                P.EXEC_TASK, P.EXEC_ACTOR_TASK, P.EXEC_ACTOR_CREATE,
            ):
                # runtime env never materialized: every task fails with
                # the setup error (reference: RuntimeEnvSetupError)
                from ..exceptions import TaskError

                err = TaskError(
                    "runtime_env_setup",
                    f"runtime env setup failed: {setup_error}",
                    cause=setup_error,
                )
                blob = dumps_inline(err)
                returns = [
                    (oid, P.VAL_ERROR, blob, 0)
                    for oid in payload.get("return_ids", [])
                ]
                if msg_type == P.EXEC_ACTOR_CREATE:
                    client.send(P.ACTOR_READY, {
                        "actor_id": payload["actor_id"], "error": blob,
                    })
                else:
                    if (payload.get("options") or {}).get("streaming"):
                        # generator callers wait on the STREAM, not the
                        # (empty) return ids
                        client.send(P.STREAM_END, {
                            "task_id": payload["task_id"], "error": blob,
                        })
                    client.send(P.TASK_DONE, {
                        "task_id": payload["task_id"], "returns": returns,
                    })
            elif msg_type == P.EXEC_TASK:
                rt.exec_task(payload)
            elif msg_type == P.EXEC_ACTOR_CREATE:
                rt.exec_actor_create(payload)
            elif msg_type == P.EXEC_ACTOR_TASK:
                rt.exec_actor_task(payload)
        except KeyboardInterrupt:
            # cancellation SIGINT landed between tasks: stay alive
            continue


if __name__ == "__main__":
    main()
