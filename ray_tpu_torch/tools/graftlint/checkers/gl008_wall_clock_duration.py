"""GL008 — wall-clock delta used as a duration.

``time.time()`` steps with NTP adjustments and leap smearing; a
difference of two wall-clock reads is NOT a duration. Inside the
runtime core (``ray_tpu_torch/_private/``) every interval measurement —
handler latency, queue wait, deadline arithmetic — must come from
``time.monotonic()`` / ``time.perf_counter()``. The task-lifecycle
stamps keep both: wall stamps position timeline slices in absolute
time, monotonic twins feed every subtraction.

The checker flags a subtraction (``a - b``) where either operand is
wall-derived — a direct ``time.time()`` call, or a local name whose
assignment contains one (including ``x = ev.get("t") or time.time()``)
— scoped to files under ``_private/`` PLUS ``ray_tpu_torch/util/tracing.py``:
tracing is runtime infrastructure whose span durations feed the
critical-path analyzer (it anchors wall time once per process and
derives every interval from monotonic stamps — this rule keeps a
wall-delta duration from regressing in). Other user-facing code
(usage timestamps, display stamps) legitimately carries wall time.

Exception: an operand derived from file mtimes (``os.path.getmtime``,
``os.stat``/``os.fstat``, ``.st_mtime``) exempts the subtraction —
mtimes ARE wall clock, so comparing them against ``time.time()`` is
the only correct spelling (e.g. the runtime-env stale-lock breaker).

Fix shape: stamp ``t0 = time.monotonic()`` (or ``perf_counter`` for
sub-ms intervals) and subtract monotonic from monotonic.
"""

from __future__ import annotations

import ast
import os
from typing import List, Set

from ..core import (
    FileContext,
    Finding,
    dotted_name,
    qualname_map,
    register,
    walk_local,
)

_MTIME_CALLS = {
    "os.path.getmtime",
    "os.path.getctime",
    "os.path.getatime",
    "os.stat",
    "os.fstat",
    "posixpath.getmtime",
}


def _contains_wall_call(ctx: FileContext, node: ast.AST) -> bool:
    for n in ast.walk(node):
        if isinstance(n, ast.Call):
            if ctx.resolve(dotted_name(n.func)) == "time.time":
                return True
    return False


def _is_mtime_derived(ctx: FileContext, node: ast.AST) -> bool:
    for n in ast.walk(node):
        if isinstance(n, ast.Call):
            if ctx.resolve(dotted_name(n.func)) in _MTIME_CALLS:
                return True
        if isinstance(n, ast.Attribute) and n.attr in (
            "st_mtime", "st_ctime", "st_atime"
        ):
            return True
    return False


def _derived_names(ctx: FileContext, scope: ast.AST, contains) -> Set[str]:
    """Local names assigned from an expression satisfying `contains`
    (wall-clock and mtime provenance are tracked symmetrically, so an
    mtime stored in a local still exempts the subtraction)."""
    out: Set[str] = set()
    for n in walk_local(scope):
        value = None
        targets: List[ast.AST] = []
        if isinstance(n, ast.Assign):
            value, targets = n.value, n.targets
        elif isinstance(n, ast.AnnAssign) and n.value is not None:
            value, targets = n.value, [n.target]
        elif isinstance(n, ast.AugAssign):
            value, targets = n.value, [n.target]
        if value is None or not contains(ctx, value):
            continue
        for t in targets:
            if isinstance(t, ast.Name):
                out.add(t.id)
    return out


def _matches(node: ast.AST, names: Set[str], contains, ctx) -> bool:
    if isinstance(node, ast.Name):
        return node.id in names
    return contains(ctx, node)


@register("GL008", "wall-clock-duration")
def check(ctx: FileContext) -> List[Finding]:
    norm = "/" + ctx.path.replace(os.sep, "/")
    if "/_private/" not in norm and not norm.endswith("/util/tracing.py"):
        return []
    out: List[Finding] = []
    quals = qualname_map(ctx.tree)
    scopes = [(ctx.tree, "<module>")]
    for node in ast.walk(ctx.tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            scopes.append((node, quals.get(id(node), node.name)))
    for scope, qual in scopes:
        wall = _derived_names(ctx, scope, _contains_wall_call)
        mtime = _derived_names(ctx, scope, _is_mtime_derived)
        for n in walk_local(scope):
            if not (isinstance(n, ast.BinOp) and isinstance(n.op, ast.Sub)):
                continue
            left_wall = _matches(n.left, wall, _contains_wall_call, ctx)
            right_wall = _matches(n.right, wall, _contains_wall_call, ctx)
            if not (left_wall or right_wall):
                continue
            if _matches(n.left, mtime, _is_mtime_derived, ctx) or _matches(
                n.right, mtime, _is_mtime_derived, ctx
            ):
                continue  # comparing against file mtimes IS wall clock
            out.append(
                Finding(
                    path=ctx.path,
                    line=n.lineno,
                    code="GL008",
                    message=(
                        "time.time() delta used as a duration — wall "
                        "clock steps with NTP; stamp time.monotonic()/"
                        "perf_counter() and subtract those instead"
                    ),
                    symbol=qual,
                )
            )
    return out
