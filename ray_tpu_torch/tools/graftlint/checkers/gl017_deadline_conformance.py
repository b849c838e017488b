"""GL017 — deadline conformance in the serve plane.

The serve plane's literal 60s/30s waits were removed in favor of
deadline-derived timeouts: every blocking wait computes its bound from
``request_meta``'s deadline (``_remaining_s()`` and friends), so a
request either finishes inside its budget or fails fast — it never
parks a replica thread for a hard-coded interval that ignores how much
budget the caller has left.

This pass keeps that contract: inside ``ray_tpu_torch/serve/``, a blocking
wait (``result``, ``wait``, ``asyncio.wait_for``, ``get``, ``acquire``,
``join``) whose timeout is a positive numeric **literal** is a finding.
The fix is to derive the bound from the request deadline; genuinely
request-independent waits (startup gates, shutdown drains) carry an
inline ``# graftlint: disable=GL017 — why`` justification instead.

Zero timeouts are exempt (``timeout=0`` is a poll, not a wait), as is
positional ``.get(...)`` (that shape is overwhelmingly ``dict.get``).
"""

from __future__ import annotations

import ast
import os
from typing import List, Optional

from ..core import Finding, register_project
from ..project import ProjectSession, _call_name, _functions_in, _local_nodes

_WAIT_TAILS = frozenset(
    {"result", "wait", "wait_for", "get", "acquire", "join"}
)
# calls where a bare positional numeric is the timeout
_POSITIONAL_ARG0 = frozenset({"result", "wait", "join", "acquire"})
_TIMEOUT_KWARGS = frozenset({"timeout", "timeout_s"})


def _serve_path(path: str) -> bool:
    parts = path.replace(os.sep, "/").split("/")
    return "serve" in parts and "ray_tpu_torch" in parts


def _positive_literal(node: ast.AST) -> Optional[float]:
    if (
        isinstance(node, ast.Constant)
        and isinstance(node.value, (int, float))
        and not isinstance(node.value, bool)
        and node.value > 0
    ):
        return float(node.value)
    return None


def _literal_timeout(call: ast.Call, tail: str) -> Optional[float]:
    for kw in call.keywords:
        if kw.arg in _TIMEOUT_KWARGS:
            return _positive_literal(kw.value)
    if tail in _POSITIONAL_ARG0 and call.args:
        return _positive_literal(call.args[0])
    if tail == "wait_for" and len(call.args) >= 2:
        return _positive_literal(call.args[1])
    return None


@register_project("GL017", "deadline-conformance")
def check(session: ProjectSession) -> List[Finding]:
    out: List[Finding] = []
    for mod in session.modules:
        if not _serve_path(mod.path):
            continue
        for fn in _functions_in(mod.ctx.tree):
            qual = mod.qualnames.get(id(fn), fn.name)
            # local walk: nested defs are visited as their own fn, so
            # each call is attributed to exactly one qualname
            for node in _local_nodes(fn):
                if not isinstance(node, ast.Call):
                    continue
                tail = _call_name(node)
                if tail not in _WAIT_TAILS:
                    continue
                secs = _literal_timeout(node, tail)
                if secs is None:
                    continue
                out.append(
                    Finding(
                        path=mod.path,
                        line=node.lineno,
                        code="GL017",
                        message=(
                            f"`{tail}(...)` in `{qual}` waits a literal "
                            f"{secs:g}s instead of a deadline-derived "
                            f"bound — compute the timeout from the request "
                            f"deadline (request_meta) so the wait respects "
                            f"the caller's remaining budget, or justify "
                            f"with an inline disable"
                        ),
                        symbol=f"{qual}.{tail}.literal_timeout",
                    )
                )
    return out
