"""Last-resort error reporting for control-plane threads.

The hub reactor, timers, and the client reader all follow the same
rule: a stray exception must cost one unit of work (a connection, a
timer tick), never the thread — but the traceback has to surface
somewhere. This is the one place that banner format lives.
"""

from __future__ import annotations

import sys
import traceback


def log_exc(prefix: str) -> None:
    """Write the active exception's traceback to stderr under the
    ``[ray_tpu_torch]`` banner. For broad-``except`` arms where raising is
    not an option and losing the traceback is worse."""
    sys.stderr.write(f"[ray_tpu_torch] {prefix}:\n{traceback.format_exc()}\n")


def proc_rss_bytes(pid: int) -> int:
    """Resident set size of a live process, 0 if unreadable (process
    gone, or no /proc). Shared by the hub's memory monitor and the
    hub/agent heartbeat samplers."""
    import os

    try:
        with open(f"/proc/{pid}/statm") as f:
            return int(f.read().split()[1]) * os.sysconf("SC_PAGESIZE")
    except (OSError, IndexError, ValueError):
        return 0
