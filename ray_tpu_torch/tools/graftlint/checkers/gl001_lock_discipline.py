"""GL001 — lock discipline.

Infers a "guarded-by" relation per class: any ``self.<attr>`` that is
*written* inside a ``with self._lock:`` block anywhere in the class is
considered guarded by that lock. Two violations are reported:

1. **unguarded write** — a write (assignment, ``+=``, subscript store,
   or mutating method call like ``.append``/``.pop``) to a guarded
   attribute outside any lock block, in a method other than
   ``__init__`` (construction happens-before sharing).

2. **split check-then-act** — the ``object_store.free()`` bug class: a
   local computed *from guarded attributes* under one lock acquisition
   gates (via ``if``) a *second* lock acquisition that writes those same
   attributes without re-validating them. Between the two acquisitions
   another thread may invalidate the check, e.g. a byte-cap test that
   two concurrent frees both pass::

       with self._lock:
           room = self._pool_bytes + cap <= MAX     # check
       if room:
           with self._lock:
               self._pool_bytes += cap              # act — cap exceeded

   The safe shape re-checks under the *same* acquisition that acts.
"""

from __future__ import annotations

import ast
from typing import Dict, List, Optional, Set, Tuple

from ..core import FileContext, Finding, register, self_attr, walk_local

_LOCK_HINTS = ("lock", "mutex", "cond", "cv")
_MUTATORS = {
    "append", "extend", "insert", "add", "pop", "popleft", "popitem",
    "remove", "discard", "clear", "update", "setdefault", "appendleft",
    "move_to_end",
}


def _is_lock_attr(name: str) -> bool:
    low = name.lower()
    return any(h in low for h in _LOCK_HINTS)


def _lock_with(node: ast.AST) -> bool:
    """True for ``with self._lock:`` / ``async with self._cv:`` blocks."""
    if not isinstance(node, (ast.With, ast.AsyncWith)):
        return False
    for item in node.items:
        attr = self_attr(item.context_expr)
        if attr is not None and _is_lock_attr(attr):
            return True
    return False


def _attr_writes(node: ast.AST) -> List[Tuple[str, int]]:
    """(attr, line) for every write to a ``self.<attr>`` under node."""
    return [
        w for n in walk_local(node) for w in _attr_writes_shallow(n)
    ]


def _attr_reads(node: ast.AST) -> Set[str]:
    out: Set[str] = set()
    for n in walk_local(node):
        a = self_attr(n)
        if a is not None and isinstance(getattr(n, "ctx", None), ast.Load):
            out.add(a)
    return out


def _methods(cls: ast.ClassDef):
    for item in cls.body:
        if isinstance(item, (ast.FunctionDef, ast.AsyncFunctionDef)):
            yield item


def _guarded_attrs(cls: ast.ClassDef) -> Set[str]:
    guarded: Set[str] = set()
    for fn in _methods(cls):
        for n in ast.walk(fn):
            if _lock_with(n):
                for attr, _line in _attr_writes(n):
                    if not _is_lock_attr(attr):
                        guarded.add(attr)
    return guarded


def _locked_node_ids(fn: ast.AST) -> Set[int]:
    ids: Set[int] = set()
    for n in ast.walk(fn):
        if _lock_with(n):
            for sub in ast.walk(n):
                ids.add(id(sub))
    return ids


def _unguarded_writes(
    cls: ast.ClassDef, guarded: Set[str], path: str
) -> List[Finding]:
    out: List[Finding] = []
    for fn in _methods(cls):
        if fn.name == "__init__":
            continue
        locked = _locked_node_ids(fn)
        seen: Set[Tuple[str, int]] = set()
        for n in walk_local(fn):
            if id(n) in locked:
                continue
            for attr, line in _attr_writes_shallow(n):
                if attr in guarded and (attr, line) not in seen:
                    seen.add((attr, line))
                    out.append(
                        Finding(
                            path=path,
                            line=line,
                            code="GL001",
                            message=(
                                f"write to `self.{attr}` outside the lock "
                                f"that guards it elsewhere in "
                                f"`{cls.name}` — take the lock or move "
                                f"the attribute out of the guarded set"
                            ),
                            symbol=f"{cls.name}.{fn.name}.{attr}",
                        )
                    )
    return out


def _attr_writes_shallow(n: ast.AST) -> List[Tuple[str, int]]:
    """Writes attributable to exactly this node (no recursion), so the
    locked-region filter in _unguarded_writes is per-statement."""
    out: List[Tuple[str, int]] = []
    if isinstance(n, (ast.Assign, ast.AugAssign, ast.AnnAssign)):
        targets = n.targets if isinstance(n, ast.Assign) else [n.target]
        for t in targets:
            a = self_attr(t)
            if a is not None:
                out.append((a, n.lineno))
            if isinstance(t, ast.Subscript):
                a = self_attr(t.value)
                if a is not None:
                    out.append((a, n.lineno))
    elif (
        isinstance(n, ast.Call)
        and isinstance(n.func, ast.Attribute)
        and n.func.attr in _MUTATORS
    ):
        a = self_attr(n.func.value)
        if a is not None:
            out.append((a, n.lineno))
    elif isinstance(n, ast.Delete):
        for t in n.targets:
            if isinstance(t, ast.Subscript):
                a = self_attr(t.value)
                if a is not None:
                    out.append((a, n.lineno))
    return out


def _top_level_lock_blocks(fn: ast.AST) -> List[ast.AST]:
    """Lock blocks in source order, not nested inside another lock block."""
    blocks: List[ast.AST] = []

    def visit(node: ast.AST) -> None:
        for child in ast.iter_child_nodes(node):
            if isinstance(
                child, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)
            ):
                continue
            if _lock_with(child):
                blocks.append(child)
                continue  # don't descend: inner acquisitions are one region
            visit(child)

    visit(fn)
    blocks.sort(key=lambda b: b.lineno)
    return blocks


def _checked_locals(block: ast.AST, guarded: Set[str]) -> Dict[str, Set[str]]:
    """Locals assigned inside a lock block whose value reads guarded
    attributes: {local_name: {guarded attrs read}}."""
    out: Dict[str, Set[str]] = {}
    for n in walk_local(block):
        if isinstance(n, ast.Assign) and n.value is not None:
            reads = _attr_reads(n.value) & guarded
            if not reads:
                continue
            for t in n.targets:
                if isinstance(t, ast.Name):
                    out.setdefault(t.id, set()).update(reads)
    return out


def _test_reads_name(test: ast.AST, name: str) -> bool:
    for n in ast.walk(test):
        if isinstance(n, ast.Name) and n.id == name:
            return True
    return False


def _block_retests(block: ast.AST, attrs: Set[str]) -> bool:
    """True if the block re-validates any of `attrs` under its own lock
    (an If/While/Assert/ternary test reading the attribute)."""
    for n in walk_local(block):
        test = None
        if isinstance(n, (ast.If, ast.While, ast.Assert, ast.IfExp)):
            test = n.test
        if test is not None and _attr_reads(test) & attrs:
            return True
    return False


def _split_check_then_act(
    cls: ast.ClassDef, guarded: Set[str], path: str
) -> List[Finding]:
    out: List[Finding] = []
    for fn in _methods(cls):
        blocks = _top_level_lock_blocks(fn)
        if len(blocks) < 2:
            continue
        for i, check_block in enumerate(blocks):
            checked = _checked_locals(check_block, guarded)
            if not checked:
                continue
            # gating ifs after the check block whose test uses a checked local
            for n in walk_local(fn):
                if not isinstance(n, ast.If) or n.lineno < check_block.lineno:
                    continue
                gating = [
                    (name, attrs)
                    for name, attrs in checked.items()
                    if _test_reads_name(n.test, name)
                ]
                if not gating:
                    continue
                body_ids = {
                    id(s) for stmt in n.body for s in ast.walk(stmt)
                }
                for act_block in blocks[i + 1:]:
                    if id(act_block) not in body_ids:
                        continue
                    acted = {a for a, _ in _attr_writes(act_block)}
                    for name, attrs in gating:
                        stale = acted & attrs
                        if stale and not _block_retests(act_block, stale):
                            out.append(
                                Finding(
                                    path=path,
                                    line=act_block.lineno,
                                    code="GL001",
                                    message=(
                                        f"check-then-act across two lock "
                                        f"acquisitions: `{name}` (line "
                                        f"{check_block.lineno}) checks "
                                        f"{_fmt(stale)} but this block "
                                        f"re-writes it without "
                                        f"re-validating — merge the check "
                                        f"and the write under one "
                                        f"acquisition"
                                    ),
                                    symbol=f"{cls.name}.{fn.name}",
                                )
                            )
                            break
    return out


def _fmt(attrs: Set[str]) -> str:
    return ", ".join(f"`self.{a}`" for a in sorted(attrs))


@register("GL001", "lock-discipline")
def check(ctx: FileContext) -> List[Finding]:
    out: List[Finding] = []
    for node in ast.walk(ctx.tree):
        if not isinstance(node, ast.ClassDef):
            continue
        guarded = _guarded_attrs(node)
        if not guarded:
            continue
        out.extend(_unguarded_writes(node, guarded, ctx.path))
        out.extend(_split_check_then_act(node, guarded, ctx.path))
    return out
