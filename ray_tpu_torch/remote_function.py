"""RemoteFunction: the object `@remote` turns a function into.

Parity: python/ray/remote_function.py:41 in the reference. The function
is cloudpickled once per process and exported to the hub's function
table keyed by a content digest (the reference exports via GCS KV,
python/ray/_private/function_manager.py:196); workers fetch + cache.
"""

from __future__ import annotations

import hashlib
from typing import Any, Dict, List, Optional, Tuple

import pickle
import sys

from ._private.object_store import INLINE_THRESHOLD
from ._private.serialization import (
    MARKER_PLAIN,
    PICKLE5,
    dumps_function,
    dumps_inline,
)
from .object_ref import ObjectRef

# encode_args fast path: exact types that can't need spilling (beyond
# the blob-size check), carry no ObjectRef deps, and pickle identically
# under stdlib pickle and cloudpickle — no by-reference trap, so the
# cloudpickle encoder (~5x slower, pure python) can be skipped
_INLINE_FAST_TYPES = frozenset((int, float, bool, str, bytes, type(None)))

# Options accepted by @remote / .options() — superset kept aligned with
# the reference's ray_option_utils.py validation table.
_TASK_OPTION_KEYS = {
    "num_cpus",
    "num_gpus",
    "num_tpus",
    "resources",
    "num_returns",
    "max_retries",
    "retry_exceptions",
    "name",
    "scheduling_strategy",
    "runtime_env",
    "memory",
    "max_calls",
    "priority",
    "tenant",
    "timeout_s",
    "_metadata",
}


def canonical_resources(opts: Dict[str, Any], is_actor: bool) -> Dict[str, float]:
    res: Dict[str, float] = {}
    ncpu = opts.get("num_cpus")
    if ncpu is None:
        ncpu = 0 if is_actor else 1
    if ncpu:
        res["CPU"] = float(ncpu)
    if opts.get("num_gpus"):
        res["GPU"] = float(opts["num_gpus"])
    if opts.get("num_tpus"):
        res["TPU"] = float(opts["num_tpus"])
    if opts.get("memory"):
        res["memory"] = float(opts["memory"])
    for k, v in (opts.get("resources") or {}).items():
        res[k] = float(v)
    return res


def encode_args(client, args: tuple, kwargs: dict):
    """Encode call args: spill large ndarray/bytes args to the object store,
    collect top-level ObjectRef dependencies, inline the rest.

    Mirrors the reference's arg handling: small args inline with the task
    spec, large args become owned objects passed by reference
    (python/ray/_raylet.pyx prepare_args). Returns
    (args_kind, payload, deps, holds): `holds` are owned twin refs for
    the spilled objects — the caller attaches them to the task's return
    refs so spilled args are freed when the call's results are dropped
    (the hub pins them while the task is in flight), instead of leaking
    one shm segment per call."""
    if not kwargs:
        # all-primitive positional call (the .remote() hot-path shape):
        # nothing can be an ObjectRef or ndarray, so skip the spill
        # scan, and stdlib pickle's C encoder replaces cloudpickle.
        # Plain loop, not all(genexpr) — this runs per .remote() call.
        for a in args:
            if type(a) not in _INLINE_FAST_TYPES:
                break
        else:
            blob = MARKER_PLAIN + pickle.dumps((args, kwargs), PICKLE5)
            if len(blob) <= INLINE_THRESHOLD:
                return "inline", blob, [], []
            # an oversized str/bytes arg still spills — fall through
    import numpy as np

    torch = sys.modules.get("torch")  # a process holding tensors has it
    deps: List[bytes] = []
    holds: List[ObjectRef] = []

    def spill(v):
        if isinstance(v, ObjectRef):
            deps.append(v._id.binary())
            return v
        big = False
        if isinstance(v, np.ndarray) and v.nbytes > INLINE_THRESHOLD:
            big = True
        elif isinstance(v, (bytes, bytearray)) and len(v) > INLINE_THRESHOLD:
            big = True
        elif (
            torch is not None and isinstance(v, torch.Tensor)
            and v.numel() * v.element_size() > INLINE_THRESHOLD
        ):
            big = True  # port: a large tensor spills like a large ndarray
        if big:
            oid = client.put_value(v)
            deps.append(oid.binary())
            holds.append(ObjectRef(oid, _owned=True))
            # the pickled copy is a plain (non-owned) ref; the owned
            # twin above stays unpickled so ownership GC can fire
            return ObjectRef(oid)
        return v

    args = tuple(spill(a) for a in args)
    kwargs = {k: spill(v) for k, v in kwargs.items()}
    blob = dumps_inline((args, kwargs))
    if len(blob) > INLINE_THRESHOLD:
        oid = client.put_value((args, kwargs))
        deps.append(oid.binary())
        holds.append(ObjectRef(oid, _owned=True))
        return "ref", oid.binary(), deps, holds
    return "inline", blob, deps, holds


def scheduling_options(opts: Dict[str, Any]) -> Dict[str, Any]:
    """Extract hub-visible scheduling options (placement group etc.)."""
    out: Dict[str, Any] = {}
    strategy = opts.get("scheduling_strategy")
    if strategy is not None:
        from .util.scheduling_strategies import PlacementGroupSchedulingStrategy

        from .util.scheduling_strategies import NodeAffinitySchedulingStrategy

        if isinstance(strategy, PlacementGroupSchedulingStrategy):
            pg = strategy.placement_group
            out["placement_group"] = (pg.id.binary(), strategy.placement_group_bundle_index)
        elif isinstance(strategy, NodeAffinitySchedulingStrategy):
            out["node_affinity"] = (strategy.node_id, strategy.soft)
        elif isinstance(strategy, str):
            out["strategy"] = strategy
    if opts.get("max_retries") is not None:
        out["max_retries"] = opts["max_retries"]
    if opts.get("timeout_s"):
        # execute deadline: past it the hub SIGKILLs the (possibly
        # hung) worker and retries the task against its crash budget,
        # failing with TaskTimeoutError once exhausted
        out["timeout_s"] = float(opts["timeout_s"])
    # multi-tenant scheduling (fairsched): per-call priority/tenant
    # override the driver's registered JobConfig (client._stamp_job
    # fills the defaults with setdefault, so explicit values win)
    if opts.get("priority") is not None:
        out["priority"] = int(opts["priority"])
    if opts.get("tenant"):
        out["tenant"] = str(opts["tenant"])
    if opts.get("retry_exceptions"):
        # True = retry any application error; exception type(s) retry
        # only matching errors (reference: ray_option_utils semantics).
        # Class objects must not ride the plain-pickle frame codec raw —
        # a __main__-defined exception class pickles by reference and
        # fails to resolve in a remote hub — so anything non-bool ships
        # as a cloudpickle blob (hub._maybe_retry_app_error unwraps it).
        rex = opts["retry_exceptions"]
        if not isinstance(rex, bool):
            rex = _retry_exceptions_blob(rex)
        out["retry_exceptions"] = rex
    return out


# retry_exceptions blob memo: the class list is static per decoration,
# but scheduling_options runs per .remote() call — without the memo
# every submit would pay a CloudPickler round (by-value for __main__
# classes) on the hot path. Keyed by the class tuple itself.
_REX_BLOB_MEMO: Dict[tuple, bytes] = {}


def _retry_exceptions_blob(rex) -> bytes:
    classes = tuple(rex) if isinstance(rex, (list, tuple)) else (rex,)
    blob = _REX_BLOB_MEMO.get(classes)
    if blob is None:
        if len(_REX_BLOB_MEMO) > 256:
            _REX_BLOB_MEMO.clear()
        blob = _REX_BLOB_MEMO[classes] = dumps_inline(classes)
    return blob


def _uploaded_env_uris(client) -> set:
    """Per-CLIENT memo of wheel URIs already uploaded (content-hashed,
    one upload serves every later submit). Keyed on the client object:
    a new cluster connection starts empty, so a fresh hub's KV gets the
    wheels again."""
    memo = getattr(client, "_env_upload_memo", None)
    if memo is None:
        memo = client._env_upload_memo = set()
    return memo


def process_runtime_env(client, opts: Dict[str, Any], out: Dict[str, Any]) -> None:
    """Package a runtime_env for the hub (reference: the runtime-env
    agent's URI flow, _private/runtime_env/agent/runtime_env_agent.py:167
    + working_dir plugin): env_vars travel inline; working_dir is zipped
    once per content hash into the cluster KV (the GCS-KV upload path)
    and workers materialize it from the URI with local caching."""
    renv = opts.get("runtime_env")
    if not renv:
        return
    import hashlib
    import io
    import json
    import os
    import zipfile

    processed: Dict[str, Any] = {}
    if renv.get("env_vars"):
        processed["env_vars"] = {
            str(k): str(v) for k, v in renv["env_vars"].items()
        }
    wd = renv.get("working_dir")
    if wd:
        buf = io.BytesIO()
        with zipfile.ZipFile(buf, "w", zipfile.ZIP_DEFLATED) as zf:
            for root, _, files in os.walk(wd):
                for fname in sorted(files):
                    full = os.path.join(root, fname)
                    zf.write(full, os.path.relpath(full, wd))
        blob = buf.getvalue()
        uri = hashlib.sha1(blob).hexdigest()[:16]
        client.kv_put(f"__runtime_env_pkg__{uri}".encode(), blob,
                      overwrite=True)
        processed["working_dir_uri"] = uri
    if renv.get("pip") is not None and renv.get("uv") is not None:
        raise ValueError(
            "runtime_env accepts 'pip' OR 'uv', not both"
        )
    pip = renv.get("pip") if renv.get("pip") is not None else renv.get("uv")
    if pip:
        # reference: _private/runtime_env/pip.py / uv.py — requirements
        # materialize node-side into a cached env dir. Local wheel/sdist
        # paths upload once (content-hash URI) into the cluster KV so
        # every node can install them offline; plain requirement strings
        # pass through (they need an index reachable from the nodes).
        if isinstance(pip, dict):
            pip = pip.get("packages", [])
        if isinstance(pip, str):
            # reference form: a requirements.txt path (runtime_env pip
            # accepts the file path directly)
            path = os.path.expanduser(pip)
            if os.path.isfile(path):
                with open(path) as f:
                    pip = [
                        ln.strip() for ln in f
                        if ln.strip() and not ln.strip().startswith("#")
                    ]
            else:
                pip = [pip]
        reqs: list = []
        wheels: Dict[str, str] = {}  # content uri -> original filename
        memo = _uploaded_env_uris(client)
        for r in pip:
            r = str(r)
            path = os.path.expanduser(r)
            if os.path.isfile(path) and path.endswith(
                (".tar.gz", ".zip")
            ):
                # sdists need a build backend (setuptools) pip would
                # fetch from an index — impossible on egress-less nodes
                raise ValueError(
                    f"runtime_env pip: ship built wheels, not sdists "
                    f"({r}); run `pip wheel {r}` first"
                )
            if os.path.isfile(path) and path.endswith(".whl"):
                with open(path, "rb") as f:
                    blob = f.read()
                uri = hashlib.sha1(blob).hexdigest()[:16]
                if uri not in memo:
                    # upload once per client; the KV keeps it for nodes
                    client.kv_put(f"__runtime_env_whl__{uri}".encode(),
                                  blob, overwrite=True)
                    memo.add(uri)
                wheels[uri] = os.path.basename(path)
            else:
                reqs.append(r)
        processed["pip"] = {"reqs": sorted(reqs),
                            "wheels": dict(sorted(wheels.items()))}
    mods = renv.get("py_modules")
    if mods:
        # reference: _private/runtime_env/py_modules.py — each entry is
        # a local package dir (zipped once per content hash into the
        # cluster KV, extracted onto sys.path node-side) or a built
        # wheel (rides the pip/offline-wheel machinery)
        mod_uris: list = []
        memo = _uploaded_env_uris(client)
        for m in mods:
            path = os.path.expanduser(str(m))
            if os.path.isfile(path) and path.endswith(".whl"):
                with open(path, "rb") as f:
                    blob = f.read()
                uri = hashlib.sha1(blob).hexdigest()[:16]
                if uri not in memo:
                    client.kv_put(f"__runtime_env_whl__{uri}".encode(),
                                  blob, overwrite=True)
                    memo.add(uri)
                pip_spec = processed.setdefault(
                    "pip", {"reqs": [], "wheels": {}}
                )
                pip_spec["wheels"][uri] = os.path.basename(path)
            elif os.path.isdir(path):
                buf = io.BytesIO()
                base = os.path.basename(path.rstrip(os.sep))
                with zipfile.ZipFile(buf, "w", zipfile.ZIP_DEFLATED) as zf:
                    for root, _, files in os.walk(path):
                        for fname in sorted(files):
                            full = os.path.join(root, fname)
                            rel = os.path.join(
                                base, os.path.relpath(full, path)
                            )
                            zf.write(full, rel)
                blob = buf.getvalue()
                uri = hashlib.sha1(blob).hexdigest()[:16]
                if uri not in memo:  # upload once per client per content
                    client.kv_put(f"__runtime_env_pkg__{uri}".encode(),
                                  blob, overwrite=True)
                    memo.add(uri)
                mod_uris.append(uri)
            else:
                raise ValueError(
                    f"runtime_env py_modules entry {m!r} must be a local "
                    "package directory or a built wheel"
                )
        if mod_uris:
            processed["py_modules"] = mod_uris
    conda = renv.get("conda")
    if conda is not None:
        # reference: _private/runtime_env/conda.py — a named env or an
        # environment.yml-style dict; materialization happens node-side
        # (hash-cached, file-locked) and the worker re-execs inside the
        # env's interpreter
        if isinstance(conda, str):
            processed["conda"] = {"name": conda}
        elif isinstance(conda, dict):
            processed["conda"] = {
                "spec": json.loads(json.dumps(conda, sort_keys=True))
            }
        else:
            raise ValueError(
                "runtime_env conda must be an env name or an "
                "environment dict"
            )
    unknown = set(renv) - {
        "env_vars", "working_dir", "pip", "uv", "py_modules", "conda",
    }
    if unknown:
        raise ValueError(
            f"unsupported runtime_env keys {sorted(unknown)} (supported: "
            "env_vars, working_dir, pip, uv, py_modules, conda; "
            "'container' needs a container runtime this environment "
            "does not ship)"
        )
    out["runtime_env"] = processed
    out["runtime_env_hash"] = hashlib.sha1(
        json.dumps(processed, sort_keys=True).encode()
    ).hexdigest()[:16]


class _SubmitTemplate:
    """The invariant half of this function's submit payload, computed
    once per (RemoteFunction, client generation) instead of per call:
    fn export, canonical resources, scheduling options (including the
    runtime_env packaging, which may upload wheels/zips), and the
    max_retries default. Per call only the args/ids re-encode; callers
    shallow-copy ``options`` before submitting because the client's
    job stamp (setdefault) and the hub mutate options in place.

    ``splice`` extends the template to raw bytes: (job-identity tuple,
    frame prefix) — the invariant fields of a SUBMIT_TASKS frame
    pickled ONCE (serialization.submit_frame_prefix) with the job
    stamp baked in, so a plain ``.remote()`` call splices only its
    per-call fragment (client.submit_batched). Rebuilt when the
    identity changes; ``splice_broken`` latches a template whose
    options defeat splicing (memo-reading pickle) onto the classic
    per-call path permanently."""

    __slots__ = ("fn_id", "num_returns", "resources", "options",
                 "splice", "splice_broken")


class RemoteFunction:
    def __init__(self, fn, options: Optional[Dict[str, Any]] = None):
        self._fn = fn
        self._options = dict(options or {})
        self._fn_blob = None
        self._fn_id: Optional[str] = None
        # registration memo: client.client_epoch at last export. A
        # reconnect (shutdown + re-init) builds a NEW CoreClient with a
        # fresh epoch, so the steady-state "is it exported?" check is
        # one int compare with natural invalidation.
        self._export_epoch = 0
        self._tpl: Optional[_SubmitTemplate] = None
        self._tpl_epoch = 0
        # .options() variants keep the classic unbatched frame: the
        # override is the caller saying "this call is different" —
        # auto-batching stays reserved for the plain decorated function
        self._variant = False
        self.__name__ = getattr(fn, "__name__", "remote_fn")
        self.__doc__ = getattr(fn, "__doc__", None)

    def _ensure_exported(self, client) -> str:
        if self._export_epoch == getattr(client, "client_epoch", None):
            return self._fn_id
        if self._fn_blob is None:
            self._fn_blob = dumps_function(self._fn)
            digest = hashlib.sha1(self._fn_blob).hexdigest()[:16]
            self._fn_id = f"{self.__name__}:{digest}"
        client.register_function(self._fn_id, self._fn_blob)
        self._export_epoch = getattr(client, "client_epoch", None)
        return self._fn_id

    def _template(self, client) -> _SubmitTemplate:
        tpl = self._tpl
        if tpl is not None and self._tpl_epoch == client.client_epoch:
            return tpl
        opts = self._options
        tpl = _SubmitTemplate()
        tpl.fn_id = self._ensure_exported(client)
        tpl.num_returns = opts.get("num_returns", 1)
        tpl.resources = canonical_resources(opts, is_actor=False)
        options = scheduling_options(opts)
        process_runtime_env(client, opts, options)
        options.setdefault("max_retries", opts.get("max_retries", 3))
        tpl.options = options
        tpl.splice = None
        tpl.splice_broken = False
        self._tpl = tpl
        self._tpl_epoch = client.client_epoch
        return tpl

    def _splice_prefix(self, client, tpl: _SubmitTemplate):
        """The template's (frame prefix, classic-payload base) for the
        CURRENT job identity (cached on the template; one slot —
        identity changes mid-process are worker-side rarities, not a
        hot path). The base dict carries the same stamped invariant
        fields as the prefix so a singleton drain can fall back to the
        classic SUBMIT_TASK frame without re-stamping. None = this
        template cannot splice; the caller falls back to the classic
        frame and splice_broken stops re-trying."""
        ident = client._current_job_identity()
        cached = tpl.splice
        if cached is not None and cached[0] == ident:
            return cached[1], cached[2]
        from ._private import protocol as P
        from ._private.serialization import submit_frame_prefix

        stamped = dict(tpl.options)
        client._stamp_job(stamped)
        prefix = submit_frame_prefix(P.SUBMIT_TASKS, {
            "fn_id": tpl.fn_id,
            "resources": tpl.resources,
            "options": stamped,
            # strict .remote() placement semantics: auto-batched tasks
            # must not opt into bulk pipelining (hub _pipeline_ok)
            "pipeline": False,
        })
        if prefix is None:
            tpl.splice_broken = True
            return None
        base = {
            "fn_id": tpl.fn_id,
            "resources": tpl.resources,
            "options": stamped,
        }
        tpl.splice = (ident, prefix, base)
        return prefix, base

    def options(self, **opts) -> "RemoteFunction":
        merged = dict(self._options)
        merged.update(opts)
        rf = RemoteFunction(self._fn, merged)
        rf._fn_blob = self._fn_blob
        rf._fn_id = self._fn_id
        rf._variant = True
        return rf

    def remote(self, *args, **kwargs):
        return self._remote(args, kwargs, self._options)

    def bind(self, *args, **kwargs):
        """Lazy DAG node (reference: ray.dag — fn.bind). The port has no
        ``dag/`` yet, so this raises until it does."""
        raise NotImplementedError(
            ".bind() needs ray_tpu_torch.dag, which is not ported yet "
            "(ROADMAP.md Queue A item 4)"
        )

    def _remote(self, args, kwargs, opts):
        from ._private import worker

        client = worker.get_client()
        if opts.get("num_returns", 1) == "streaming":
            # streaming keeps the untemplated path: its options are
            # call-variant (forced max_retries=0, backpressure knobs)
            fn_id = self._ensure_exported(client)
            args_kind, args_payload, deps, holds = encode_args(
                client, args, kwargs)
            resources = canonical_resources(opts, is_actor=False)
            options = scheduling_options(opts)
            process_runtime_env(client, opts, options)
            from .object_ref import ObjectRefGenerator

            options["streaming"] = True
            if opts.get("_generator_backpressure_num_objects"):
                options["_generator_backpressure_num_objects"] = opts[
                    "_generator_backpressure_num_objects"
                ]
            # a partially-consumed stream cannot be transparently
            # re-executed; no retries (reference behaves likewise for
            # yielded-and-consumed prefixes)
            options["max_retries"] = 0
            task_id, _ = client.submit_task(
                fn_id, args_kind, args_payload, deps, 0, resources, options,
                return_task_id=True,
            )
            gen = ObjectRefGenerator(task_id)
            gen._hold = holds or None
            return gen
        tpl = self._template(client)
        args_kind, args_payload, deps, holds = encode_args(
            client, args, kwargs)
        # transparent auto-batching: a plain single-return call with a
        # spliceable template rides the bulk ABI through the client's
        # window. num_returns/options() overrides, window=0, broken
        # splices, and per-call head-sampled tracing (no ambient
        # context to key the batch on) all keep the classic frame.
        if (tpl.num_returns == 1 and not self._variant
                and not tpl.splice_broken and client._ab_window_s > 0.0):
            trace_ctx = None
            batchable = True
            if client._tracing_live():
                trace_ctx = client._trace_ctx()
                if trace_ctx is None:
                    batchable = False
            if batchable:
                spl = self._splice_prefix(client, tpl)
                if spl is not None:
                    from ._private.ids import ObjectID

                    rid = client.submit_batched(
                        spl[0], spl[1], args_kind, args_payload, deps,
                        trace_ctx)
                    ref = ObjectRef(ObjectID(rid), _owned=True)
                    if holds:
                        ref._hold = holds
                    return ref
        return_ids = client.submit_task(
            tpl.fn_id, args_kind, args_payload, deps, tpl.num_returns,
            tpl.resources, dict(tpl.options),
        )
        refs = [ObjectRef(r, _owned=True) for r in return_ids]
        if holds:
            for r in refs:
                r._hold = holds
        if tpl.num_returns == 1:
            return refs[0]
        return refs

    def map(self, items) -> list:
        """Submit one task per item in a SINGLE wire frame and return
        the ObjectRefs up front (vectorized fan-out; parity target:
        the Podracer-style thousands-of-homogeneous-tasks-per-step
        pattern). Each item supplies the call's positional arguments —
        a tuple is splatted (``f.map([(1, 2)])`` calls ``f(1, 2)``, so
        ``f.map([()] * n)`` makes n nullary calls), anything else is
        the single argument. Keyword arguments are not supported.

        Compared to ``[f.remote(x) for x in items]`` this encodes the
        shared fields once, draws every id from one entropy slab, and
        costs one frame + one hub admission pass instead of n — use it
        whenever the calls are homogeneous and the refs are needed
        together; use ``.remote`` when calls trickle in or vary in
        options."""
        from ._private import worker

        items = list(items)
        if not items:
            return []
        client = worker.get_client()
        tpl = self._template(client)
        if tpl.num_returns == "streaming":
            raise ValueError("map() does not support streaming tasks")
        encoded = []
        hold_rows = []
        for it in items:
            call_args = it if isinstance(it, tuple) else (it,)
            args_kind, args_payload, deps, holds = encode_args(
                client, call_args, {})
            encoded.append((args_kind, args_payload, deps))
            hold_rows.append(holds)
        _task_ids, rid_rows = client.submit_many(
            tpl.fn_id, encoded, tpl.num_returns, tpl.resources,
            dict(tpl.options),
        )
        from ._private.ids import ObjectID

        out = []
        for row, holds in zip(rid_rows, hold_rows):
            refs = [ObjectRef(ObjectID(r), _owned=True) for r in row]
            if holds:
                for ref in refs:
                    ref._hold = holds
            out.append(refs[0] if tpl.num_returns == 1 else refs)
        return out

    def __call__(self, *args, **kwargs):
        raise TypeError(
            f"Remote function '{self.__name__}' cannot be called directly; "
            f"use '{self.__name__}.remote()'."
        )
