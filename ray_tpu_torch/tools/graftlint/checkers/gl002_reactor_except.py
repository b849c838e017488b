"""GL002 — narrow except in a daemon reactor loop.

The hub ``_handle_disconnect`` bug class: a long-running ``while`` loop
on a thread does its per-iteration work under ``try ... except
(EOFError, OSError):``, and the handler itself performs fallible work
(e.g. connection cleanup). Any exception type outside the tuple — or
raised *by* the handler — escapes the loop and silently kills the
daemon thread, taking the whole control plane with it.

The checker flags, inside functions used as ``threading.Thread``
targets:

- a ``try`` nested in a long-running ``while`` loop, **and**
- a ``try`` whose body *contains* such a loop (the loop-inside-try
  shape),

when no handler can catch ``Exception`` and at least one narrow handler
does real work (contains a call outside a ``raise``). Handlers that are
pure control flow (``break`` / ``continue`` / ``pass`` / ``return`` /
``raise``) are idiomatic signals (``except queue.Empty: break``) and
are not flagged.

Fix shape: add an ``except Exception:`` arm that logs and keeps the
loop (or performs last-resort cleanup), and make the narrow handler's
work itself non-throwing.
"""

from __future__ import annotations

import ast
from typing import List, Set

from ..core import FileContext, Finding, qualname_map, register, walk_local

_BROAD = {"Exception", "BaseException"}


def _thread_targets(tree: ast.Module) -> Set[str]:
    """Names of functions passed as ``target=`` to a Thread() call
    anywhere in the module (bare names and ``self.x`` attributes)."""
    out: Set[str] = set()
    for n in ast.walk(tree):
        if not isinstance(n, ast.Call):
            continue
        fname = None
        if isinstance(n.func, ast.Attribute):
            fname = n.func.attr
        elif isinstance(n.func, ast.Name):
            fname = n.func.id
        if fname != "Thread":
            continue
        for kw in n.keywords:
            if kw.arg != "target":
                continue
            v = kw.value
            if isinstance(v, ast.Name):
                out.add(v.id)
            elif isinstance(v, ast.Attribute):
                out.add(v.attr)
    return out


def _long_running(test: ast.AST) -> bool:
    """``while True`` / ``while self._running`` / ``while not done``-style
    conditions: no bounded iteration, the loop lives as long as the
    thread does."""
    if isinstance(test, ast.Constant) and test.value is True:
        return True
    if isinstance(test, (ast.Name, ast.Attribute)):
        return True
    if isinstance(test, ast.UnaryOp) and isinstance(test.op, ast.Not):
        return isinstance(test.operand, (ast.Name, ast.Attribute))
    return False


def _has_broad_handler(try_node: ast.Try) -> bool:
    for h in try_node.handlers:
        if h.type is None:
            return True  # bare except
        elts = h.type.elts if isinstance(h.type, ast.Tuple) else [h.type]
        for e in elts:
            name = e.id if isinstance(e, ast.Name) else (
                e.attr if isinstance(e, ast.Attribute) else None
            )
            if name in _BROAD:
                return True
    return False


def _handler_does_work(try_node: ast.Try) -> bool:
    """True if some handler body contains a call outside a ``raise``
    statement — i.e. work that can itself raise and escape."""
    for h in try_node.handlers:
        for stmt in h.body:
            if isinstance(stmt, ast.Raise):
                continue
            for n in ast.walk(stmt):
                if isinstance(n, ast.Call):
                    return True
    return False


def _finding(ctx: FileContext, fn: ast.FunctionDef, try_node: ast.Try,
             shape: str, qual: str) -> Finding:
    return Finding(
        path=ctx.path,
        line=try_node.lineno,
        code="GL002",
        message=(
            f"narrow `except` {shape} the long-running loop of thread "
            f"target `{fn.name}` does fallible cleanup — a stray "
            f"exception kills the daemon thread; add an `except "
            f"Exception:` arm (log + drop the connection, never the "
            f"loop)"
        ),
        symbol=qual,
    )


@register("GL002", "narrow-except-in-reactor-loop")
def check(ctx: FileContext) -> List[Finding]:
    targets = _thread_targets(ctx.tree)
    if not targets:
        return []
    out: List[Finding] = []
    seen: Set[int] = set()
    quals = qualname_map(ctx.tree)
    for fn in ast.walk(ctx.tree):
        if not isinstance(fn, ast.FunctionDef) or fn.name not in targets:
            continue
        qual = quals.get(id(fn), fn.name)
        loops = [
            n for n in walk_local(fn)
            if isinstance(n, ast.While) and _long_running(n.test)
        ]
        for loop in loops:
            for n in walk_local(loop):
                if (
                    isinstance(n, ast.Try)
                    and id(n) not in seen
                    and not _has_broad_handler(n)
                    and _handler_does_work(n)
                ):
                    seen.add(id(n))
                    out.append(_finding(ctx, fn, n, "inside", qual))
        # loop-inside-try: the try wraps the loop from outside
        for n in walk_local(fn):
            if not isinstance(n, ast.Try) or id(n) in seen:
                continue
            body_ids = {id(s) for stmt in n.body for s in ast.walk(stmt)}
            if (
                any(id(loop) in body_ids for loop in loops)
                and not _has_broad_handler(n)
                and _handler_does_work(n)
            ):
                seen.add(id(n))
                out.append(_finding(ctx, fn, n, "wrapping", qual))
    return out
