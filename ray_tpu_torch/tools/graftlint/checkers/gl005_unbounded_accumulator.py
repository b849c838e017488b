"""GL005 — unbounded steady-state accumulator.

The ``multi_agent.completed_returns`` leak class: an instance (or
module-level) list initialized empty, appended to *inside a loop* in a
steady-state method, and never trimmed, rotated, cleared, or
reassigned anywhere in the class. Every fragment/iteration grows it; a
long-running worker leaks without bound.

Reads don't save it: ``self.xs[-100:]`` keeps the window but still
retains the whole history. Fix shape::

    self.completed_returns = collections.deque(maxlen=100)

or trim explicitly (``del self.xs[:-100]``) where the window is
consumed.

Only append-in-a-loop sites are flagged: a list appended once per call
on a request path is usually a registry with an external lifecycle,
and flagging those drowns the signal. A growth site inside an ``if``
that tests the list itself (``if not _TABLE: ... append``) is a
build-once memo and is exempt — it converges, it doesn't accumulate.
"""

from __future__ import annotations

import ast
from typing import Dict, List, Optional, Set, Tuple

from ..core import FileContext, Finding, register, self_attr, walk_local

_GROWERS = {"append", "extend", "insert", "appendleft"}
_TRIMMERS = {"pop", "popleft", "popitem", "remove", "clear", "__delitem__"}


def _empty_list(value: Optional[ast.AST]) -> bool:
    return isinstance(value, ast.List) and not value.elts


def _methods(cls: ast.ClassDef):
    for item in cls.body:
        if isinstance(item, (ast.FunctionDef, ast.AsyncFunctionDef)):
            yield item


def _init_list_attrs(cls: ast.ClassDef) -> Set[str]:
    attrs: Set[str] = set()
    for fn in _methods(cls):
        if fn.name != "__init__":
            continue
        for n in walk_local(fn):
            if isinstance(n, ast.Assign) and _empty_list(n.value):
                for t in n.targets:
                    a = self_attr(t)
                    if a is not None:
                        attrs.add(a)
            elif isinstance(n, ast.AnnAssign) and _empty_list(n.value):
                a = self_attr(n.target)
                if a is not None:
                    attrs.add(a)
    return attrs


def _memo_guard_ids(root: ast.AST, attr_of) -> Dict[str, Set[int]]:
    """For each guarded name X: ids of nodes inside an ``if`` whose test
    reads X (the ``if not X: ... X.append`` build-once memo shape)."""
    out: Dict[str, Set[int]] = {}
    for n in walk_local(root):
        if not isinstance(n, ast.If):
            continue
        tested = {
            a for t in ast.walk(n.test)
            for a in [attr_of(t)] if a is not None
        }
        if not tested:
            continue
        ids = {id(s) for stmt in n.body for s in ast.walk(stmt)}
        for a in tested:
            out.setdefault(a, set()).update(ids)
    return out


def _classify_class(
    cls: ast.ClassDef, attrs: Set[str]
) -> Tuple[Dict[str, List[Tuple[str, int]]], Set[str]]:
    """(grow sites inside loops per attr, attrs that are ever trimmed
    or reassigned outside __init__)."""
    grows: Dict[str, List[Tuple[str, int]]] = {}
    bounded: Set[str] = set()
    for fn in _methods(cls):
        if fn.name == "__init__":
            continue
        memo = _memo_guard_ids(fn, self_attr)

        def visit(node: ast.AST, in_loop: bool) -> None:
            for child in ast.iter_child_nodes(node):
                if isinstance(
                    child,
                    (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda),
                ):
                    continue
                il = in_loop or isinstance(
                    child, (ast.For, ast.While, ast.AsyncFor)
                )
                if (
                    isinstance(child, ast.Call)
                    and isinstance(child.func, ast.Attribute)
                ):
                    a = self_attr(child.func.value)
                    if a in attrs:
                        if (
                            child.func.attr in _GROWERS
                            and il
                            and id(child) not in memo.get(a, ())
                        ):
                            grows.setdefault(a, []).append(
                                (fn.name, child.lineno)
                            )
                        elif child.func.attr in _TRIMMERS:
                            bounded.add(a)
                if isinstance(child, (ast.Assign, ast.AugAssign)):
                    targets = (
                        child.targets
                        if isinstance(child, ast.Assign)
                        else [child.target]
                    )
                    # expand tuple unpacking: `out, self.buf = self.buf, []`
                    targets = [
                        e
                        for t in targets
                        for e in (
                            t.elts if isinstance(t, (ast.Tuple, ast.List))
                            else [t]
                        )
                    ]
                    for t in targets:
                        a = self_attr(t)
                        if a in attrs and isinstance(child, ast.Assign):
                            bounded.add(a)  # reassignment resets it
                        if isinstance(t, (ast.Subscript,)):
                            a = self_attr(t.value)
                            if a in attrs:
                                bounded.add(a)  # slice-assign can shrink
                if isinstance(child, ast.Delete):
                    for t in child.targets:
                        if isinstance(t, ast.Subscript):
                            a = self_attr(t.value)
                            if a in attrs:
                                bounded.add(a)
                visit(child, il)

        visit(fn, False)
    return grows, bounded


def _module_level(ctx: FileContext) -> List[Finding]:
    """Module-global empty lists appended in loops and never bounded."""
    globals_: Set[str] = set()
    for stmt in ctx.tree.body:
        if isinstance(stmt, ast.Assign) and _empty_list(stmt.value):
            for t in stmt.targets:
                if isinstance(t, ast.Name):
                    globals_.add(t.id)
        elif (
            isinstance(stmt, ast.AnnAssign)
            and _empty_list(stmt.value)
            and isinstance(stmt.target, ast.Name)
        ):
            globals_.add(stmt.target.id)
    if not globals_:
        return []
    grows: Dict[str, List[int]] = {}
    bounded: Set[str] = set()
    memo: Dict[str, Set[int]] = {}
    for n in ast.walk(ctx.tree):
        if not isinstance(n, ast.If):
            continue
        tested = {
            t.id for t in ast.walk(n.test)
            if isinstance(t, ast.Name) and t.id in globals_
        }
        if not tested:
            continue
        ids = {id(s) for stmt in n.body for s in ast.walk(stmt)}
        for name in tested:
            memo.setdefault(name, set()).update(ids)

    def visit(node: ast.AST, in_loop: bool) -> None:
        for child in ast.iter_child_nodes(node):
            il = in_loop or isinstance(child, (ast.For, ast.While, ast.AsyncFor))
            if (
                isinstance(child, ast.Call)
                and isinstance(child.func, ast.Attribute)
                and isinstance(child.func.value, ast.Name)
                and child.func.value.id in globals_
            ):
                if (
                    child.func.attr in _GROWERS
                    and il
                    and id(child) not in memo.get(child.func.value.id, ())
                ):
                    grows.setdefault(child.func.value.id, []).append(
                        child.lineno
                    )
                elif child.func.attr in _TRIMMERS:
                    bounded.add(child.func.value.id)
            if isinstance(child, (ast.Assign, ast.Delete)):
                for t in child.targets:
                    if isinstance(t, ast.Name) and t.id in globals_:
                        if child.col_offset > 0:  # rebinding inside a fn
                            bounded.add(t.id)
                    if isinstance(t, ast.Subscript) and isinstance(
                        t.value, ast.Name
                    ) and t.value.id in globals_:
                        bounded.add(t.value.id)
            visit(child, il)

    visit(ctx.tree, False)
    out: List[Finding] = []
    for name, lines in grows.items():
        if name in bounded:
            continue
        out.append(
            Finding(
                path=ctx.path,
                line=lines[0],
                code="GL005",
                message=(
                    f"module-level list `{name}` grows inside a loop and "
                    f"is never trimmed — long-running processes leak; "
                    f"bound it (deque(maxlen=...)) or rotate it"
                ),
                symbol=f"<module>.{name}",
            )
        )
    return out


@register("GL005", "unbounded-accumulator")
def check(ctx: FileContext) -> List[Finding]:
    out: List[Finding] = []
    for cls in ast.walk(ctx.tree):
        if not isinstance(cls, ast.ClassDef):
            continue
        attrs = _init_list_attrs(cls)
        if not attrs:
            continue
        grows, bounded = _classify_class(cls, attrs)
        for attr, sites in grows.items():
            if attr in bounded:
                continue
            meth, line = sites[0]
            out.append(
                Finding(
                    path=ctx.path,
                    line=line,
                    code="GL005",
                    message=(
                        f"`self.{attr}` grows inside a loop in "
                        f"`{cls.name}.{meth}` and is never trimmed, "
                        f"cleared, or reassigned — a long-lived instance "
                        f"leaks; use `collections.deque(maxlen=...)` or "
                        f"trim where the window is consumed"
                    ),
                    symbol=f"{cls.name}.{attr}",
                )
            )
    out.extend(_module_level(ctx))
    return out
