"""Job submission: run driver entrypoints on the cluster.

Parity: python/ray/job_submission/ + dashboard/modules/job/
(job_manager.py:60 submit_job, job_supervisor.py:55 JobSupervisor) —
a detached named manager actor owns job lifecycle: each job's
entrypoint shell command runs as a subprocess of a supervisor with the
job's runtime env applied and RAY_TPU_TORCH_ADDRESS pointing at this cluster,
so `ray_tpu_torch.init()` inside the job connects instead of starting a new
runtime. Logs are captured per job; statuses follow the reference's
PENDING/RUNNING/SUCCEEDED/FAILED/STOPPED machine.
"""

from __future__ import annotations

import uuid
from typing import Any, Dict, List, Optional

JOB_MANAGER_NAME = "_ray_tpu_torch_job_manager"


class JobStatus:
    PENDING = "PENDING"
    RUNNING = "RUNNING"
    SUCCEEDED = "SUCCEEDED"
    FAILED = "FAILED"
    STOPPED = "STOPPED"

    TERMINAL = {SUCCEEDED, FAILED, STOPPED}


class _JobManager:
    """Named actor: job table + one supervisor thread per job."""

    def __init__(self):
        import threading

        self._jobs: Dict[str, dict] = {}
        self._procs: Dict[str, Any] = {}
        self._lock = threading.Lock()

    def submit(
        self,
        entrypoint: str,
        submission_id: Optional[str] = None,
        runtime_env: Optional[dict] = None,
        metadata: Optional[dict] = None,
        tenant: Optional[str] = None,
        priority: Optional[int] = None,
        quota: Optional[dict] = None,
    ) -> str:
        import os
        import subprocess
        import tempfile
        import threading

        job_id = submission_id or f"raysubmit_{uuid.uuid4().hex[:12]}"
        with self._lock:
            if job_id in self._jobs:
                raise ValueError(f"job {job_id} already exists")
            log_path = os.path.join(
                tempfile.gettempdir(), f"ray_tpu_torch_job_{job_id}.log"
            )
            self._jobs[job_id] = {
                "job_id": job_id,
                "entrypoint": entrypoint,
                "status": JobStatus.PENDING,
                "metadata": metadata or {},
                "log_path": log_path,
                "returncode": None,
            }

        def run():
            env = dict(os.environ)
            # the job's driver connects to THIS cluster
            env["RAY_TPU_TORCH_ADDRESS"] = os.environ.get("RAY_TPU_TORCH_HUB_ADDR", "")
            if tenant is not None or priority is not None or quota is not None:
                # multi-tenant scheduling handoff: the entrypoint's
                # init() reads RAY_TPU_TORCH_JOB_* and registers with the
                # hub's fairsched engine under this identity
                from .job_config import JobConfig

                env.update(
                    JobConfig(
                        tenant=tenant or "default",
                        priority=priority or 0,
                        quota=quota,
                        job_id=job_id,
                    ).env_vars()
                )
            cwd = None
            renv = runtime_env or {}
            for k, v in (renv.get("env_vars") or {}).items():
                env[str(k)] = str(v)
            if renv.get("working_dir"):
                cwd = renv["working_dir"]
            with open(log_path, "wb") as logf:
                try:
                    proc = subprocess.Popen(
                        entrypoint, shell=True, env=env, cwd=cwd,
                        stdout=logf, stderr=subprocess.STDOUT,
                    )
                except OSError as e:
                    with self._lock:
                        self._jobs[job_id]["status"] = JobStatus.FAILED
                        self._jobs[job_id]["message"] = str(e)
                    return
                with self._lock:
                    self._jobs[job_id]["status"] = JobStatus.RUNNING
                    self._procs[job_id] = proc
                code = proc.wait()
            with self._lock:
                job = self._jobs[job_id]
                job["returncode"] = code
                if job["status"] != JobStatus.STOPPED:
                    job["status"] = (
                        JobStatus.SUCCEEDED if code == 0 else JobStatus.FAILED
                    )
                self._procs.pop(job_id, None)

        threading.Thread(target=run, daemon=True, name=f"job-{job_id}").start()
        return job_id

    def status(self, job_id: str) -> dict:
        with self._lock:
            job = self._jobs.get(job_id)
            if job is None:
                raise ValueError(f"no such job {job_id}")
            return dict(job)

    def list_jobs(self) -> List[dict]:
        with self._lock:
            return [dict(j) for j in self._jobs.values()]

    def logs(self, job_id: str) -> str:
        info = self.status(job_id)
        try:
            with open(info["log_path"], "r", errors="replace") as f:
                return f.read()
        except OSError:
            return ""

    def stop(self, job_id: str) -> bool:
        with self._lock:
            proc = self._procs.get(job_id)
            job = self._jobs.get(job_id)
            if job is None:
                raise ValueError(f"no such job {job_id}")
            if proc is None:
                return False
            job["status"] = JobStatus.STOPPED
        try:
            proc.terminate()
        except Exception:
            pass
        return True


class JobSubmissionClient:
    """SDK over the manager actor (reference: job_submission.JobSubmissionClient)."""

    def __init__(self, address: Optional[str] = None):
        import ray_tpu_torch

        if not ray_tpu_torch.is_initialized():
            ray_tpu_torch.init(address=address, ignore_reinit_error=True)
        self._ray = ray_tpu_torch
        try:
            self._mgr = ray_tpu_torch.get_actor(JOB_MANAGER_NAME)
        except ValueError:
            try:
                mgr_cls = ray_tpu_torch.remote(_JobManager)
                self._mgr = mgr_cls.options(
                    name=JOB_MANAGER_NAME, lifetime="detached", num_cpus=0
                ).remote()
                ray_tpu_torch.get(self._mgr.__ray_ready__())
            except ValueError:
                # lost the creation race: someone else owns the name
                self._mgr = ray_tpu_torch.get_actor(JOB_MANAGER_NAME)

    def submit_job(
        self,
        *,
        entrypoint: str,
        submission_id: Optional[str] = None,
        runtime_env: Optional[dict] = None,
        metadata: Optional[dict] = None,
        tenant: Optional[str] = None,
        priority: Optional[int] = None,
        quota: Optional[dict] = None,
    ) -> str:
        return self._ray.get(
            self._mgr.submit.remote(
                entrypoint, submission_id, runtime_env, metadata,
                tenant, priority, quota,
            )
        )

    def get_job_status(self, job_id: str) -> str:
        return self._ray.get(self._mgr.status.remote(job_id))["status"]

    def get_job_info(self, job_id: str) -> dict:
        return self._ray.get(self._mgr.status.remote(job_id))

    def get_job_logs(self, job_id: str) -> str:
        return self._ray.get(self._mgr.logs.remote(job_id))

    def list_jobs(self) -> List[dict]:
        return self._ray.get(self._mgr.list_jobs.remote())

    def stop_job(self, job_id: str) -> bool:
        return self._ray.get(self._mgr.stop.remote(job_id))

    def wait_until_finished(self, job_id: str, timeout: float = 60.0) -> str:
        import time

        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            status = self.get_job_status(job_id)
            if status in JobStatus.TERMINAL:
                return status
            time.sleep(0.2)
        raise TimeoutError(f"job {job_id} still {status} after {timeout}s")
