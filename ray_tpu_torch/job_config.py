"""JobConfig: a driver/job's multi-tenant scheduling identity.

Parity target: ``ray.job_config.JobConfig`` (python/ray/job_config.py)
— extended with the fairsched fields this runtime's multi-tenant
scheduler consumes (ray_tpu/_private/fairsched.py):

- ``tenant``: the accounting/fairness principal. All jobs of one tenant
  share its quota and its fair-share clock.
- ``priority``: integer, higher wins. Orders dispatch ahead of lower
  priorities, and lets this job's placement-group / SLICE reservations
  preempt strictly-lower-priority gangs when they cannot fit.
- ``quota``: optional resource caps (hub units: whole TPU chips, CPU
  cores, "memory" bytes). Tasks that would push the tenant's admitted
  usage over quota park as ``pending_quota`` instead of dispatching.

Pass to ``ray_tpu_torch.init(job_config=...)``; submitted jobs
(``ray_tpu job submit --tenant ... --priority ...``) inherit theirs
through ``RAY_TPU_TORCH_JOB_*`` environment variables, which ``init()`` reads
when no explicit config is given.
"""

from __future__ import annotations

import json
import os
import uuid
from typing import Dict, Optional

_ENV_TENANT = "RAY_TPU_TORCH_JOB_TENANT"
_ENV_PRIORITY = "RAY_TPU_TORCH_JOB_PRIORITY"
_ENV_QUOTA = "RAY_TPU_TORCH_JOB_QUOTA"  # JSON dict, e.g. '{"TPU": 4}'
_ENV_JOB_ID = "RAY_TPU_TORCH_JOB_ID"


class JobConfig:
    def __init__(
        self,
        tenant: str = "default",
        priority: int = 0,
        quota: Optional[Dict[str, float]] = None,
        job_id: Optional[str] = None,
    ):
        self.tenant = tenant or "default"
        self.priority = int(priority or 0)
        # tri-state: None = no opinion (an existing tenant cap stands);
        # a dict — including {} — is declared and replaces the tenant's
        # cap (quota={} lifts an earlier one)
        self.quota = (
            None if quota is None
            else {k: float(v) for k, v in quota.items()}
        )
        if self.quota and any(v < 0 for v in self.quota.values()):
            raise ValueError(f"quota amounts must be >= 0, got {quota}")
        self.job_id = job_id or f"job-{uuid.uuid4().hex[:12]}"

    @classmethod
    def from_env(cls) -> Optional["JobConfig"]:
        """Build from RAY_TPU_TORCH_JOB_* env vars (set by `job submit`), or
        None when no identity was handed down."""
        if not (
            os.environ.get(_ENV_TENANT)
            or os.environ.get(_ENV_PRIORITY)
            or os.environ.get(_ENV_QUOTA)
            or os.environ.get(_ENV_JOB_ID)
        ):
            return None
        quota: Optional[Dict[str, float]] = None
        raw = os.environ.get(_ENV_QUOTA)
        if raw is not None:
            try:
                quota = {
                    str(k): float(v) for k, v in json.loads(raw).items()
                }
            except (ValueError, TypeError, AttributeError):
                import sys

                sys.stderr.write(
                    f"[ray_tpu_torch] ignoring malformed {_ENV_QUOTA}={raw!r} "
                    "(expected a JSON object of resource: amount)\n"
                )
        try:
            priority = int(os.environ.get(_ENV_PRIORITY) or 0)
        except ValueError:
            priority = 0
        return cls(
            tenant=os.environ.get(_ENV_TENANT) or "default",
            priority=priority,
            quota=quota,
            job_id=os.environ.get(_ENV_JOB_ID) or None,
        )

    def env_vars(self) -> Dict[str, str]:
        """The env handoff `job submit` gives its entrypoint so the
        job's own init() registers under this identity."""
        out = {_ENV_TENANT: self.tenant, _ENV_PRIORITY: str(self.priority),
               _ENV_JOB_ID: self.job_id}
        if self.quota is not None:
            out[_ENV_QUOTA] = json.dumps(self.quota)
        return out

    def __repr__(self) -> str:
        return (
            f"JobConfig(tenant={self.tenant!r}, priority={self.priority}, "
            f"quota={self.quota}, job_id={self.job_id!r})"
        )
