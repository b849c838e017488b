"""User-visible exceptions.

Parity with the reference's python/ray/exceptions.py: RayError,
RayTaskError, RayActorError/ActorDiedError, GetTimeoutError,
WorkerCrashedError, ObjectLostError, TaskCancelledError.
"""

from __future__ import annotations


class RayError(Exception):
    """Base class for all framework errors."""


class TaskError(RayError):
    """A task raised an exception during execution.

    Carries the remote traceback; re-raised at every `get()` on the
    task's return refs (reference behavior: python/ray/exceptions.py
    RayTaskError wraps the cause and as_instanceof_cause()).
    """

    def __init__(self, function_name: str, traceback_str: str, cause: Exception | None = None):
        self.function_name = function_name
        self.traceback_str = traceback_str
        self.cause = cause
        super().__init__(f"task {function_name} failed:\n{traceback_str}")

    def __reduce__(self):
        return (TaskError, (self.function_name, self.traceback_str, self.cause))


class WorkerCrashedError(RayError):
    """The worker process executing the task died unexpectedly."""


class ActorError(RayError):
    pass


class ActorDiedError(ActorError):
    """The actor is dead; pending and future calls fail with this."""

    def __init__(self, actor_id=None, msg: str = "The actor died."):
        self.actor_id = actor_id
        self.msg = msg
        super().__init__(msg)

    def __reduce__(self):
        return (ActorDiedError, (self.actor_id, self.msg))


class ActorUnavailableError(ActorError):
    """The actor is temporarily unavailable (e.g. restarting)."""


class GetTimeoutError(RayError, TimeoutError):
    """`get(timeout=...)` expired before the object became available."""


class ObjectLostError(RayError):
    """The object's value was lost and could not be reconstructed."""


class TaskCancelledError(RayError):
    """The task was cancelled before/while running."""


class RuntimeEnvSetupError(RayError):
    """Preparing the runtime environment for a task/actor failed."""


class OutOfMemoryError(RayError):
    """A worker was killed by the memory monitor."""


class TaskTimeoutError(RayError):
    """The task's execute exceeded options(timeout_s=...) (or the
    cluster-wide hung-worker watchdog deadline) and its retry budget is
    exhausted. The runtime SIGKILLs the stalled worker — a hung process
    (e.g. a SIGSTOP'd or deadlocked worker) never EOFs on its own — and
    retries the task first; this error is the give-up."""


class RequestShedError(RayError):
    """Serve admission control shed this request: the deployment's
    ``max_queued_requests`` cap was reached, so the router refused it
    immediately instead of queueing it into a timeout. Retriable — the
    HTTP ingress maps it to 503 with a Retry-After hint."""

    def __init__(self, deployment: str = "", queued: int = 0, cap: int = 0):
        self.deployment = deployment
        self.queued = queued
        self.cap = cap
        super().__init__(
            f"request to deployment {deployment!r} shed: "
            f"{queued} outstanding >= max_queued_requests={cap}"
        )

    def __reduce__(self):
        return (RequestShedError, (self.deployment, self.queued, self.cap))


class RequestExpiredError(RayError, TimeoutError):
    """The request's deadline passed before the user callable ran (in
    the router's replica wait, the replica's pre-execute check, or the
    batch queue). Dropped without burning replica time; the HTTP
    ingress maps it to 504."""

    def __init__(self, deployment: str = "", msg: str = ""):
        self.deployment = deployment
        self.msg = msg or (
            f"request to deployment {deployment!r} expired before execute"
        )
        super().__init__(self.msg)

    def __reduce__(self):
        return (RequestExpiredError, (self.deployment, self.msg))


# Reference-compatible aliases
RayTaskError = TaskError
RayActorError = ActorError
