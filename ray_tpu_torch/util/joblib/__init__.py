"""joblib backend: run scikit-learn's `n_jobs` parallelism on the
cluster.

Parity: python/ray/util/joblib/ (`register_ray` + the ray joblib
backend over the multiprocessing-Pool API). Here each joblib batch
(a zero-arg BatchedCalls closure) ships as one task; callbacks fire
from a small watcher thread per in-flight batch, matching the
multiprocessing.Pool callback contract joblib expects.

    from ray_tpu_torch.util.joblib import register_ray
    import joblib

    register_ray()
    with joblib.parallel_backend("ray_tpu_torch"):
        GridSearchCV(...).fit(X, y)   # n_jobs=-1 fans out as tasks
"""

from __future__ import annotations

import threading
from typing import Any, Callable, Optional


def _run_batch(batch: Callable) -> Any:
    return batch()


class _RayAsyncResult:
    def __init__(self, ref):
        self._ref = ref

    def get(self, timeout: Optional[float] = None):
        import ray_tpu_torch

        return ray_tpu_torch.get(self._ref, timeout=timeout)


def _get_remote():
    # no module-level cache: a cached RemoteFunction would outlive
    # ray_tpu_torch.shutdown()/init() cycles and submit into a dead client
    import ray_tpu_torch

    if not ray_tpu_torch.is_initialized():
        ray_tpu_torch.init(ignore_reinit_error=True)
    return ray_tpu_torch.remote(_run_batch)


def register_ray() -> None:
    """Register the 'ray_tpu_torch' joblib parallel backend."""
    from joblib.parallel import ParallelBackendBase, register_parallel_backend

    class RayTpuBackend(ParallelBackendBase):
        supports_timeout = True

        def configure(self, n_jobs=1, parallel=None, **backend_args):
            import ray_tpu_torch

            if not ray_tpu_torch.is_initialized():
                ray_tpu_torch.init(ignore_reinit_error=True)
            self.parallel = parallel
            return self.effective_n_jobs(n_jobs)

        def effective_n_jobs(self, n_jobs):
            import ray_tpu_torch

            if n_jobs == 0:
                raise ValueError("n_jobs == 0 has no meaning")
            if n_jobs is None:
                return 1
            if n_jobs < 0:
                if not ray_tpu_torch.is_initialized():
                    ray_tpu_torch.init(ignore_reinit_error=True)
                return max(1, int(ray_tpu_torch.cluster_resources().get("CPU", 1)))
            return n_jobs

        def apply_async(self, func, callback=None):
            ref = _get_remote().remote(func)
            result = _RayAsyncResult(ref)
            if callback is not None:
                # multiprocessing.Pool contract: callback(result_value)
                # from a helper thread once the task completes
                def _watch():
                    try:
                        value = result.get()
                    except Exception:
                        return  # error surfaces via .get() in retrieval
                    callback(value)

                threading.Thread(target=_watch, daemon=True).start()
            return result

        def abort_everything(self, ensure_ready=True):
            if ensure_ready:
                self.configure(
                    n_jobs=self.parallel.n_jobs, parallel=self.parallel
                )

    register_parallel_backend("ray_tpu_torch", RayTpuBackend)


__all__ = ["register_ray"]
