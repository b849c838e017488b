"""GL016 — resource lifecycle: acquire/release pairing with escape
analysis.

The runtime's hot paths hold four kinds of handles whose leaks are
silent until a node runs out of fds, mmaps, or wakes a dead timer:

- **mmap segment mappings** — ``MappedSegment`` / ``mmap`` /
  ``from_fd``; the object store's mapping table (``self._segments``)
  is the sanctioned owner, ``drop_mapping``/``free`` the drop side.
- **selectors** — every ``register`` needs an ``unregister`` path and
  the selector itself a ``close`` on teardown.
- **sockets** — ``socket(...)`` / ``create_connection(...)`` must be
  closed (or handed off) on every exit path.
- **one-shot timers and span records** — timers pushed onto a
  ``*timer*`` heap must be cleared on teardown; ``make_runtime_record``
  spans must be emitted or handed off.

Two layers, both over :meth:`ProjectSession.resources`:

*Class layer* — a class that registers selector fds but has no
unregister (or never closes the selector), pushes timers with no
teardown clear, or fills a handle registry it never drops from.

*Function layer (escape analysis)* — a local handle assigned from an
acquire constructor must be **resolved**: released
(``close``/``unmap``/…), transferred (stored into an attribute or
registry, passed to another call, returned/yielded, or used as a
context manager). No resolution at all is a leak. A call that can
raise strictly *between* the acquire and its first resolution is a
leak-on-raise finding — unless the acquire sits in a ``try`` with
cleanup (handlers/``finally``), the intervening call is infallible
(builtin allowlist), touches the handle itself, or lives on an
error-path span (``except``/``finally`` bodies).
"""

from __future__ import annotations

import ast
from typing import List, Optional, Set, Tuple

from ..core import Finding, register_project
from ..project import (
    ACQUIRE_CTORS,
    RELEASE_METHODS,
    ProjectSession,
    _call_name,
    _functions_in,
)

# calls that cannot raise in a way worth modelling between acquire and
# release (attribute/arith errors there are programming bugs, not
# resource-pressure paths)
_INFALLIBLE = frozenset({
    "len", "isinstance", "issubclass", "id", "repr", "str", "int",
    "float", "bool", "min", "max", "abs", "round", "sorted", "list",
    "dict", "set", "tuple", "frozenset", "enumerate", "zip", "range",
    "getattr", "hasattr", "format", "print", "append", "debug", "info",
    "warning", "monotonic", "time", "perf_counter",
})


def _contains_name(node: ast.AST, name: str) -> bool:
    for sub in ast.walk(node):
        if isinstance(sub, ast.Name) and sub.id == name:
            return True
    return False


def _protected_spans(fn: ast.AST) -> List[Tuple[int, int]]:
    """Line spans of except-handler and finally bodies: calls there run
    on the error/cleanup path, not between acquire and release."""
    spans: List[Tuple[int, int]] = []
    for node in ast.walk(fn):
        if not isinstance(node, ast.Try):
            continue
        for part in list(node.handlers) + [node.finalbody, node.orelse]:
            stmts = part.body if isinstance(part, ast.ExceptHandler) else part
            if stmts:
                spans.append((
                    stmts[0].lineno,
                    max(getattr(s, "end_lineno", s.lineno) for s in stmts),
                ))
    return spans


def _try_wrapped(fn: ast.AST, line: int) -> bool:
    """True when ``line`` sits in the body of a try that has cleanup
    (handlers or finally) — the function already owns an error path."""
    for node in ast.walk(fn):
        if not isinstance(node, ast.Try):
            continue
        if not (node.handlers or node.finalbody):
            continue
        if node.body and (
            node.body[0].lineno
            <= line
            <= max(getattr(s, "end_lineno", s.lineno) for s in node.body)
        ):
            return True
    return False


def _acquires(fn: ast.AST) -> List[Tuple[str, str, int]]:
    """(handle name, resource kind, line) for local-only acquires.
    Multi-target assigns that also hit ``self.<attr>`` transfer
    ownership to the instance at the acquire itself — class layer."""
    out = []
    for node in ast.walk(fn):
        if not isinstance(node, ast.Assign) or not isinstance(
            node.value, ast.Call
        ):
            continue
        kind = ACQUIRE_CTORS.get(_call_name(node.value) or "")
        if kind is None:
            continue
        if any(not isinstance(t, ast.Name) for t in node.targets):
            continue
        for t in node.targets:
            out.append((t.id, kind, node.lineno))
            break
    return out


def _first_resolution(fn: ast.AST, handle: str, after: int) -> Optional[int]:
    """Line of the first release/transfer of ``handle`` past the
    acquire, or None when the handle never escapes."""
    best: Optional[int] = None

    def note(line: int) -> None:
        nonlocal best
        if best is None or line < best:
            best = line

    for node in ast.walk(fn):
        line = getattr(node, "lineno", None)
        if line is None or line < after:
            continue
        if isinstance(node, ast.Call):
            f = node.func
            if (
                isinstance(f, ast.Attribute)
                and f.attr in RELEASE_METHODS
                and _contains_name(f.value, handle)
            ):
                note(line)
            elif any(_contains_name(a, handle) for a in node.args) or any(
                _contains_name(kw.value, handle) for kw in node.keywords
            ):
                note(line)
        elif isinstance(node, ast.Assign):
            if any(
                isinstance(t, (ast.Attribute, ast.Subscript))
                for t in node.targets
            ) and _contains_name(node.value, handle):
                note(line)
        elif isinstance(node, (ast.Return, ast.Yield, ast.YieldFrom)):
            if node.value is not None and _contains_name(node.value, handle):
                note(line)
        elif isinstance(node, (ast.With, ast.AsyncWith)):
            if any(
                _contains_name(item.context_expr, handle)
                for item in node.items
            ):
                note(line)
    return best


@register_project("GL016", "resource-lifecycle")
def check(session: ProjectSession) -> List[Finding]:
    out: List[Finding] = []
    rm = session.resources()

    # ------------------------------------------------------- class layer
    for qual, rc in sorted(rm.classes.items()):
        path = rc.module.path
        if rc.register_sites and not rc.unregister_sites:
            out.append(
                Finding(
                    path=path,
                    line=min(rc.register_sites),
                    code="GL016",
                    message=(
                        f"`{qual}` registers fds on its selector but has no "
                        f"unregister path — dead connections keep their "
                        f"registration and the reactor spins on stale fds"
                    ),
                    symbol=f"{qual}.selector.unregister_missing",
                )
            )
        if rc.register_sites and not rc.selector_close_sites:
            out.append(
                Finding(
                    path=path,
                    line=min(rc.register_sites),
                    code="GL016",
                    message=(
                        f"`{qual}` never closes its selector — the epoll fd "
                        f"outlives teardown"
                    ),
                    symbol=f"{qual}.selector.close_missing",
                )
            )
        for attr, lines in sorted(rc.timer_attrs.items()):
            if attr in rc.timer_clears:
                continue
            out.append(
                Finding(
                    path=path,
                    line=min(lines),
                    code="GL016",
                    message=(
                        f"`{qual}` pushes one-shot timers onto "
                        f"`self.{attr}` but never clears it on teardown — "
                        f"pending timers fire into a dead runtime (clear "
                        f"the heap in the teardown path)"
                    ),
                    symbol=f"{qual}.{attr}.teardown_clear_missing",
                )
            )
        for attr, lines in sorted(rc.registry_attrs.items()):
            if attr in rc.registry_drops:
                continue
            out.append(
                Finding(
                    path=path,
                    line=min(lines),
                    code="GL016",
                    message=(
                        f"`{qual}` stores acquired handles into "
                        f"`self.{attr}` but never drops entries — the "
                        f"registry grows without bound and pins every "
                        f"mapping it holds"
                    ),
                    symbol=f"{qual}.{attr}.drop_missing",
                )
            )

    # ---------------------------------------------- function escape layer
    for mod in session.modules:
        for fn in _functions_in(mod.ctx.tree):
            qual = mod.qualnames.get(id(fn), fn.name)
            for handle, kind, line in _acquires(fn):
                resolved = _first_resolution(fn, handle, line)
                if resolved is None:
                    out.append(
                        Finding(
                            path=mod.path,
                            line=line,
                            code="GL016",
                            message=(
                                f"{kind} `{handle}` acquired in `{qual}` is "
                                f"never released or transferred — close it, "
                                f"store it in a tracked registry, or return "
                                f"it to the caller"
                            ),
                            symbol=f"{qual}.{handle}.unreleased",
                        )
                    )
                    continue
                if _try_wrapped(fn, line):
                    continue
                spans = _protected_spans(fn)
                for node in ast.walk(fn):
                    if not isinstance(node, ast.Call):
                        continue
                    cl = node.lineno
                    if not (line < cl < resolved):
                        continue
                    if any(lo <= cl <= hi for lo, hi in spans):
                        continue
                    if _try_wrapped(fn, cl):
                        continue  # cleanup runs on raise — the fix shape
                    if _contains_name(node, handle):
                        continue
                    if (_call_name(node) or "") in _INFALLIBLE:
                        continue
                    out.append(
                        Finding(
                            path=mod.path,
                            line=cl,
                            code="GL016",
                            message=(
                                f"`{_call_name(node)}(...)` can raise "
                                f"between acquiring {kind} `{handle}` "
                                f"(line {line}) and its release/transfer "
                                f"(line {resolved}) in `{qual}` — wrap the "
                                f"gap in try/finally or acquire later"
                            ),
                            symbol=f"{qual}.{handle}.leak_on_raise",
                        )
                    )
                    break  # one finding per handle is enough
    return out
