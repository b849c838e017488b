"""Sampling wall-clock profiler + on-demand remote stack dumps.

The reference treats live profiling as a first-class debugging surface
(`ray stack`, py-spy-backed dashboard flamegraphs — reference:
python/ray/util/check_open_ports.py's sibling tooling and
dashboard/modules/reporter's profiling endpoints). Here the runtime is
pure Python in-process threads, so a py-spy subprocess is unnecessary:
a daemon thread snapshotting ``sys._current_frames()`` at
RAY_TPU_TORCH_PROFILE_HZ sees every thread of its process — client, hub,
reactor shards, workers, serve replicas — for the cost of one frame
walk per thread per tick.

Three layers, all in this module:

- **Task register** (:func:`set_task`): worker execution paths bind
  their thread to the task id they are running, so each sample is
  attributable to a task/actor call. Call sites gate on the module
  attribute ``_ACTIVE`` (one load) — profiler off means no dict
  traffic, matching the chaos/tracing inert-when-off idiom.
- **Frame classifier** (:func:`classify_stage`): buckets a sampled
  stack into the named runtime stages (serialize, frame-encode,
  reactor-poll, lock-wait, recv/send, user-code, idle, runtime) that
  decompose ``analyze_trace``'s queue_wait into CPU causes.
- **Sampler** (:class:`Sampler` / :func:`maybe_start`): folds samples
  locally into collapsed stacks keyed (thread domain, stage, task,
  stack), flushes ~1 s batches through an injected sink (clients send
  P.PROFILE_BATCH over their hub connection; the hub's own sampler
  appends to a ring its control thread drains), tracks its own
  overhead ratio, and auto-clamps the rate past the configured budget.

Default off: with RAY_TPU_TORCH_PROFILE_HZ unset/0, :func:`maybe_start`
returns None having created NOTHING — no thread, no state, no wire
frames. The tier-1 zero-cost guard asserts exactly this.

:func:`dump_threads` is independent of the sampler: `ray_tpu stack`
reads ``sys._current_frames()`` at request time, profiler or not.
"""

from __future__ import annotations

import os
import sys
import threading
import time
import traceback
from typing import Callable, Dict, List, Optional, Tuple

# ------------------------------------------------------------ process state
# One sampler per process; first maybe_start caller wins (in the local
# driver the hub thread and the driver client share a process — both
# call maybe_start, exactly one sampler samples every thread).
_SAMPLER: Optional["Sampler"] = None
# Gate read by task-register call sites (worker exec loop): one module
# attribute load when the profiler is off.
_ACTIVE = False
# thread ident -> task label. Plain dict, GIL-atomic store/pop — the
# sampler reads it racily by design (a sample landing on a task
# boundary attributes to either side, both true within one tick).
_TASK_REGISTER: Dict[int, str] = {}
# process-scoped label a serve replica sets to its deployment name so
# its samples read "worker:serve:<deployment>" instead of bare "worker"
_PROC_LABEL = ""


def set_task(task_id) -> None:
    """Bind the calling thread to a task id for sample attribution."""
    if isinstance(task_id, bytes):
        task_id = task_id.hex()
    _TASK_REGISTER[threading.get_ident()] = str(task_id)


def clear_task() -> None:
    _TASK_REGISTER.pop(threading.get_ident(), None)


def set_process_label(label: str) -> None:
    """Tag every future batch from this process (serve replicas pass
    their deployment name; attribution then reads
    worker:serve:<deployment>)."""
    global _PROC_LABEL
    _PROC_LABEL = str(label)


# ------------------------------------------------------- frame classifier
_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_STDLIB_DIR = os.path.dirname(os.__file__)

# hand-emitted wire codec (serialization.py's frame fast paths) — more
# specific than the serialize bucket, so checked first
_FRAME_ENCODE_FUNCS = frozenset((
    "dumps_frame", "loads_frame", "splice_tasks_frame", "splice_frame",
    "_emit_frame", "_splice",
))
_SERIALIZE_FILES = frozenset((
    "serialization.py", "pickle.py", "cloudpickle.py",
    "cloudpickle_fast.py", "copyreg.py",
))
_POLL_FUNCS = frozenset(("wait", "poll", "_poll", "select", "epoll"))
_SOCKET_FILES = frozenset(("socket.py", "connection.py", "ssl.py"))
_SOCKET_FUNCS = frozenset((
    "send", "sendall", "recv", "recv_into", "recv_bytes", "send_bytes",
    "_send", "_recv", "_send_bytes", "_recv_bytes", "accept",
))
_WAIT_FILES = frozenset(("threading.py", "queue.py"))
_WAIT_FUNCS = frozenset((
    "wait", "acquire", "get", "put", "join", "_wait_for_tstate_lock",
))

STAGES = (
    "serialize", "frame-encode", "reactor-poll", "lock-wait",
    "recv/send", "user-code", "idle", "runtime",
)


def _is_idle(frames: List[Tuple[str, str]]) -> bool:
    """A worker executor parked between tasks (queue.get directly under
    the dispatch loop) is idle, not lock-wait — without this the
    flamegraph of a quiet cluster reads as one giant lock stall."""
    for i in range(min(len(frames), 4)):
        fname, func = frames[i]
        if fname.rsplit("/", 1)[-1] == "queue.py" and func == "get":
            if i + 1 < len(frames):
                nfile, nfunc = frames[i + 1]
                tail = nfile.rsplit("/", 1)[-1]
                return (
                    (tail == "worker_process.py" and nfunc == "main")
                    or (tail == "replica.py")
                )
            return False
    return False


def classify_stage(frames: List[Tuple[str, str]]) -> str:
    """Bucket one sampled stack — leaf-first (filename, funcname)
    pairs — into a named runtime stage. First match walking from the
    leaf wins: the innermost recognizable activity is what the CPU (or
    the blocked syscall) was actually doing."""
    if not frames:
        return "runtime"
    idle = _is_idle(frames)
    for filename, func in frames:
        tail = filename.rsplit("/", 1)[-1]
        if func in _FRAME_ENCODE_FUNCS:
            return "frame-encode"
        if tail in _SERIALIZE_FILES:
            return "serialize"
        if tail == "selectors.py" or (
            tail == "connection.py" and func in _POLL_FUNCS
        ):
            return "reactor-poll"
        if tail in _SOCKET_FILES and func in _SOCKET_FUNCS:
            return "recv/send"
        if tail in _WAIT_FILES and func in _WAIT_FUNCS:
            return "idle" if idle else "lock-wait"
        if (
            not filename.startswith(_PKG_DIR)
            and not filename.startswith(_STDLIB_DIR)
            # <frozen importlib...> is runtime; <stdin>/<string> are
            # user code (REPL-defined functions keep their synthetic
            # filename through cloudpickle into the worker)
            and not filename.startswith("<frozen")
        ):
            return "user-code"
    return "runtime"


def classify_thread(name: str) -> str:
    """Map a thread name to its runtime domain (reader / flusher /
    reactor / shard / executor / aio / ...). Unknown names pass
    through — a user thread keeps its own name as its domain."""
    if name == "MainThread":
        return "main"
    if "hub-shard" in name:
        return "shard"
    if name == "ray-tpu-hub":
        return "reactor"
    if "reader" in name:
        return "reader"
    if "flusher" in name:
        return "flusher"
    if "profile" in name:
        return "profiler"
    if "aio" in name or "asyncio" in name:
        return "aio"
    if "dashboard" in name:
        return "dashboard"
    if "object-agent" in name or "object_agent" in name:
        return "object-agent"
    return name


def _frame_pairs(frame, limit: int = 64) -> List[Tuple[str, str]]:
    """Walk one thread's frame chain leaf-first into (filename,
    funcname) pairs — the classifier's and folder's shared input."""
    pairs: List[Tuple[str, str]] = []
    f = frame
    while f is not None and len(pairs) < limit:
        code = f.f_code
        pairs.append((code.co_filename, code.co_name))
        f = f.f_back
    return pairs


def _collapse(pairs: List[Tuple[str, str]]) -> str:
    """Root->leaf semicolon-joined folded-stack string (flamegraph
    collapsed format): ``module:func;module:func;...``."""
    parts = []
    for filename, func in reversed(pairs):
        tail = filename.rsplit("/", 1)[-1]
        if tail.endswith(".py"):
            tail = tail[:-3]
        parts.append(f"{tail}:{func}")
    return ";".join(parts)


# --------------------------------------------------------------- sampler
class Sampler:
    """Per-process sampling daemon. Folds locally, flushes through the
    injected sink every ``flush_period`` seconds, self-measures its
    overhead (sample-pass time / wall window) and halves its rate when
    the ratio exceeds ``budget`` (auto-clamp — a profiler that costs
    more than its budget silently degrades resolution, never the
    workload)."""

    def __init__(self, hz: float, kind: str, sink: Callable[[dict], None],
                 budget: float = 0.03, flush_period: float = 1.0):
        self.hz = float(hz)
        self.kind = kind
        self.sink = sink
        self.budget = float(budget)
        self.flush_period = float(flush_period)
        self.overhead = 0.0
        self.clamped = False
        self._stop = threading.Event()
        self.thread = threading.Thread(
            target=self._loop, daemon=True, name="ray-tpu-profile-sampler",
        )

    def start(self) -> None:
        self.thread.start()

    def stop(self) -> None:
        self._stop.set()

    def _kind(self) -> str:
        return f"{self.kind}:{_PROC_LABEL}" if _PROC_LABEL else self.kind

    def _sample_once(self, fold: Dict[tuple, int], my_ident: int) -> None:
        names = {t.ident: t.name for t in threading.enumerate()}
        for ident, frame in sys._current_frames().items():
            if ident == my_ident:
                continue  # never profile the profiler
            pairs = _frame_pairs(frame)
            key = (
                classify_thread(names.get(ident) or f"tid-{ident}"),
                classify_stage(pairs),
                _TASK_REGISTER.get(ident, ""),
                _collapse(pairs),
            )
            fold[key] = fold.get(key, 0) + 1

    def _loop(self) -> None:
        fold: Dict[tuple, int] = {}
        cost = 0.0
        my_ident = threading.get_ident()
        window0 = time.monotonic()
        while not self._stop.wait(1.0 / self.hz):
            t0 = time.perf_counter()
            try:
                self._sample_once(fold, my_ident)
            except Exception:
                pass  # a torn frame walk must never kill the sampler
            cost += time.perf_counter() - t0
            now = time.monotonic()
            window = now - window0
            if window >= self.flush_period:
                self.overhead = cost / window if window > 0 else 0.0
                if (
                    self.budget > 0
                    and self.overhead > self.budget
                    and self.hz > 1.0
                ):
                    # auto-clamp: halve the rate, floor at 1 Hz
                    self.hz = max(1.0, self.hz / 2.0)
                    self.clamped = True
                if fold:
                    try:
                        self.sink({
                            "pid": os.getpid(),
                            "kind": self._kind(),
                            "samples": fold,
                            "overhead": self.overhead,
                            "hz": self.hz,
                        })
                    except Exception:
                        pass  # hub going away must not kill the sampler
                    fold = {}
                cost = 0.0
                window0 = now


def maybe_start(kind: str, sink: Callable[[dict], None],
                hz: Optional[float] = None,
                budget: Optional[float] = None,
                flush_period: Optional[float] = None) -> Optional["Sampler"]:
    """Start the process-wide sampler iff the sample rate is > 0.

    Rate/budget default to the RAY_TPU_TORCH_PROFILE_* env knobs (workers and
    clients inherit env from their spawner and never run config
    reload(), same as chaos_plan). First caller wins; with the rate at
    its default 0 nothing at all is created."""
    global _SAMPLER, _ACTIVE
    if _SAMPLER is not None:
        return _SAMPLER
    if hz is None:
        hz = _env_float("RAY_TPU_TORCH_PROFILE_HZ", 0.0)
    if float(hz) <= 0:
        return None
    if budget is None:
        budget = _env_float("RAY_TPU_TORCH_PROFILE_OVERHEAD_BUDGET", 0.03)
    if flush_period is None:
        flush_period = _env_float("RAY_TPU_TORCH_PROFILE_FLUSH_PERIOD_S", 1.0)
    s = Sampler(float(hz), kind, sink, float(budget),
                max(0.05, float(flush_period)))
    _SAMPLER = s
    _ACTIVE = True
    s.start()
    return s


def stop() -> None:
    """Tear the process sampler down (tests; a stopped sampler flushes
    nothing further and the register gate goes back to inert)."""
    global _SAMPLER, _ACTIVE
    if _SAMPLER is not None:
        _SAMPLER.stop()
        _SAMPLER = None
    _ACTIVE = False
    _TASK_REGISTER.clear()


def _env_float(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name) or default)
    except (TypeError, ValueError):
        return default


# ------------------------------------------------------------ stack dumps
def dump_threads() -> List[dict]:
    """All-thread stack dump of THIS process (`ray_tpu stack` — the
    STACK_DUMP handler in clients/workers and the hub's inline answer
    for target "hub"). Reads sys._current_frames() at call time; no
    sampler involved."""
    frames = sys._current_frames()
    out = []
    for t in threading.enumerate():
        f = frames.get(t.ident)
        lines: List[str] = []
        if f is not None:
            lines = [
                ln.rstrip("\n")
                for entry in traceback.format_stack(f)
                for ln in entry.splitlines()
            ]
        out.append({
            "thread": t.name,
            "ident": t.ident,
            "daemon": t.daemon,
            "frames": lines,
        })
    return out
