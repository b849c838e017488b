"""Session-directory policy, shared by every runtime entrypoint
(driver init, Cluster harness, CLI node join): RAM-backed /dev/shm when
available (the object store mmaps segments out of it), RAY_TPU_TORCH_TMPDIR
to override."""

from __future__ import annotations

import os
import tempfile
import uuid


def session_base() -> str:
    return os.environ.get("RAY_TPU_TORCH_TMPDIR") or (
        "/dev/shm" if os.path.isdir("/dev/shm") else tempfile.gettempdir()
    )


def new_session_dir(prefix: str = "ray_tpu_torch") -> str:
    """Unique session path under the base (not created)."""
    return os.path.join(session_base(), f"{prefix}_{uuid.uuid4().hex[:8]}")
