"""Opt-out usage-stats collection.

Parity: python/ray/_private/usage/usage_lib.py — the reference collects
cluster metadata + library-usage tags into GCS KV under a usage prefix,
then a head-node thread periodically serializes a report. This runtime
keeps the same shape minus egress (none exists here): libraries call
``record_library_usage``/``record_extra_usage_tag`` which land in hub
KV; ``get_usage_report``/``write_usage_report`` aggregate them with
cluster metadata into a JSON blob written under the session dir.

Disable with RAY_TPU_TORCH_USAGE_STATS_ENABLED=0 (reference env:
RAY_USAGE_STATS_ENABLED).
"""

from __future__ import annotations

import json
import os
import platform
import time
from typing import Any, Dict, List

_KV_LIB_PREFIX = b"__usage_lib:"
_KV_TAG_PREFIX = b"__usage_tag:"

# Recorded before init(): buffered locally, flushed on first connect
# (reference: usage_lib.py module-level _recorded_library_usages set).
_pending_libs: List[str] = []
_pending_tags: Dict[str, str] = {}


def usage_stats_enabled() -> bool:
    return os.environ.get("RAY_TPU_TORCH_USAGE_STATS_ENABLED", "1").lower() not in (
        "0",
        "false",
        "no",
    )


def _client_or_none():
    from . import worker

    if not worker.is_initialized():
        return None
    try:
        return worker.get_client()
    except Exception:
        return None


def record_library_usage(name: str) -> None:
    """Called by library __init__ (data/train/tune/serve/rllib/llm)."""
    if not usage_stats_enabled():
        return
    client = _client_or_none()
    if client is None:
        if name not in _pending_libs:
            _pending_libs.append(name)
        return
    try:
        client.kv_put(_KV_LIB_PREFIX + name.encode(), b"1", overwrite=True)
    except Exception:
        pass


def record_extra_usage_tag(key: str, value: str) -> None:
    if not usage_stats_enabled():
        return
    client = _client_or_none()
    if client is None:
        _pending_tags[key] = value
        return
    try:
        client.kv_put(_KV_TAG_PREFIX + key.encode(), value.encode(), overwrite=True)
    except Exception:
        pass


def flush_pending() -> None:
    """Re-record anything buffered before init (called from init())."""
    libs, _pending_libs[:] = list(_pending_libs), []
    tags = dict(_pending_tags)
    _pending_tags.clear()
    for name in libs:
        record_library_usage(name)
    for k, v in tags.items():
        record_extra_usage_tag(k, v)


def get_usage_report() -> Dict[str, Any]:
    """Aggregate cluster metadata + recorded tags (usage_lib.py
    generate_report_data parity)."""
    from . import worker

    client = worker.get_client()
    libs = sorted(
        k[len(_KV_LIB_PREFIX):].decode()
        for k in client.kv_keys(_KV_LIB_PREFIX)
    )
    tags = {}
    for k in client.kv_keys(_KV_TAG_PREFIX):
        val = client.kv_get(k)
        if val is not None:
            tags[k[len(_KV_TAG_PREFIX):].decode()] = val.decode()
    nodes = worker.nodes()
    total = worker.cluster_resources()
    return {
        "schema_version": "0.1",
        "source": "ray_tpu",
        "collect_timestamp_ms": int(time.time() * 1000),
        "os": platform.system().lower(),
        "python_version": platform.python_version(),
        "total_num_nodes": len(nodes),
        "total_num_cpus": int(total.get("CPU", 0)),
        "total_num_gpus": int(total.get("GPU", 0)),
        "library_usages": libs,
        "extra_usage_tags": tags,
    }


def write_usage_report(session_dir: str) -> str:
    """Serialize the report under the session dir (the reference writes
    usage_stats.json on the head node before any export attempt)."""
    path = os.path.join(session_dir, "usage_stats.json")
    with open(path, "w") as f:
        json.dump(get_usage_report(), f, indent=2, sort_keys=True)
    return path
