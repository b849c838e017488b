"""GL014 — cross-file lock-order cycles.

Deadlock by inverted acquisition order is invisible per-file: thread 1
holds ``A`` and wants ``B`` in one module, thread 2 holds ``B`` and
wants ``A`` in another, and each file looks locally sensible. This pass
builds the project-wide lock-acquisition graph and flags cycles.

Lock identity reuses GL001's modelling: ``with self._lock:`` names the
lock ``module.Class._lock`` (per-class, since each instance's lock is
distinct but acquisition *order* is a per-class property;
module-qualified so same-named classes in different modules hold
different locks), and a module-level ``with _REGISTRY_LOCK:`` names it
``module._REGISTRY_LOCK``. An edge
``A -> B`` exists when:

- a ``with B:`` is lexically nested inside a ``with A:``; or
- a method is called while holding ``A`` (``self.m()``, or ``obj.m()``
  with an inferable receiver class) and that method — transitively
  through the intra-class call graph — acquires ``B``.

Every cycle in the resulting digraph is a potential deadlock and is
reported once, anchored at one participating acquisition, with a
rotation-canonical symbol so the baseline fingerprint is stable no
matter which edge the walker happens to find first. Self-cycles
(``with self._lock:`` nested under itself) are reported too, unless
the lock is constructed as a ``threading.RLock`` (reentrant by
design).
"""

from __future__ import annotations

import ast
from typing import Dict, List, Optional, Set, Tuple

from ..core import Finding, register_project, self_attr
from ..project import (
    ModuleInfo,
    ProjectSession,
    _call_name,
    is_lockish as _is_lockish,
)

_CODE = "GL014"


def _lock_id(mod: ModuleInfo, cls_name: Optional[str],
             expr: ast.AST) -> Optional[str]:
    a = self_attr(expr)
    if a is not None and _is_lockish(a):
        # module-qualified: two same-named classes in different modules
        # hold DIFFERENT locks (merging them fabricates phantom cycles)
        if cls_name:
            return f"{mod.basename}.{cls_name}.{a}"
        return f"{mod.basename}.{a}"
    if isinstance(expr, ast.Name) and _is_lockish(expr.id):
        return f"{mod.basename}.{expr.id}"
    return None


def _with_locks(mod: ModuleInfo, cls_name: Optional[str],
                node: ast.AST) -> List[str]:
    if not isinstance(node, (ast.With, ast.AsyncWith)):
        return []
    out = []
    for item in node.items:
        lid = _lock_id(mod, cls_name, item.context_expr)
        if lid is not None:
            out.append(lid)
    return out


class _Graph:
    def __init__(self) -> None:
        # A -> {B: (path, line, context)}
        self.edges: Dict[str, Dict[str, Tuple[str, int, str]]] = {}

    def add(self, a: str, b: str, site: Tuple[str, int, str]) -> None:
        self.edges.setdefault(a, {}).setdefault(b, site)
        self.edges.setdefault(b, {})


def _direct_locks(fn: ast.AST, mod: ModuleInfo,
                  cls_name: Optional[str]) -> Set[str]:
    out: Set[str] = set()
    for n in ast.walk(fn):
        out.update(_with_locks(mod, cls_name, n))
    return out


def _self_calls(fn: ast.AST) -> Set[str]:
    out: Set[str] = set()
    for n in ast.walk(fn):
        if isinstance(n, ast.Call):
            a = self_attr(n.func)
            if a is not None:
                out.add(a)
    return out


def _rlock_locks(session: ProjectSession) -> Set[str]:
    out: Set[str] = set()
    for mod in session.modules:
        for cls_name, cls in mod.classes.items():
            for n in ast.walk(cls):
                if isinstance(n, ast.Assign) and _call_name(
                        n.value) == "RLock":
                    for t in n.targets:
                        a = self_attr(t)
                        if a is not None:
                            out.add(f"{mod.basename}.{cls_name}.{a}")
        for n in mod.ctx.tree.body:
            if isinstance(n, ast.Assign) and _call_name(n.value) == "RLock":
                for t in n.targets:
                    if isinstance(t, ast.Name):
                        out.add(f"{mod.basename}.{t.id}")
    return out


def _transitive_locks(session: ProjectSession) -> Dict[Tuple[str, str],
                                                       Set[str]]:
    """(class, method) -> every lock the method may acquire, following
    intra-class calls to a fixpoint."""
    direct: Dict[Tuple[int, str, str], Set[str]] = {}
    calls: Dict[Tuple[int, str, str], Set[str]] = {}
    for mod in session.modules:
        for cls_name, cls in mod.classes.items():
            for mname, fn in mod.methods(cls).items():
                key = (id(mod), cls_name, mname)
                direct[key] = _direct_locks(fn, mod, cls_name)
                calls[key] = _self_calls(fn)
    trans = {k: set(v) for k, v in direct.items()}
    changed = True
    while changed:
        changed = False
        for (mid, cls_name, mname), callees in calls.items():
            cur = trans[(mid, cls_name, mname)]
            for c in callees:
                sub = trans.get((mid, cls_name, c))
                if sub and not sub <= cur:
                    cur |= sub
                    changed = True
    return trans


def _collect_edges(session: ProjectSession, graph: _Graph,
                   trans: Dict[Tuple[str, str], Set[str]]) -> None:
    for mod in session.modules:
        scopes: List[Tuple[Optional[str], ast.AST]] = [
            (None, fnode) for fnode in mod.functions.values()
        ]
        for cls_name, cls in mod.classes.items():
            for fn in mod.methods(cls).values():
                scopes.append((cls_name, fn))
        for cls_name, fn in scopes:
            ctx_name = (f"{cls_name}.{fn.name}" if cls_name else fn.name)

            def visit(node: ast.AST, held: List[str]) -> None:
                for child in ast.iter_child_nodes(node):
                    if isinstance(child, (ast.FunctionDef,
                                          ast.AsyncFunctionDef,
                                          ast.Lambda)):
                        continue
                    locks = _with_locks(mod, cls_name, child)
                    if locks:
                        for a in held:
                            for b in locks:
                                graph.add(a, b, (mod.path, child.lineno,
                                                 ctx_name))
                        visit(child, held + locks)
                        continue
                    if held and isinstance(child, ast.Call):
                        callee_locks: Set[str] = set()
                        a = self_attr(child.func)
                        if a is not None and cls_name is not None:
                            callee_locks = trans.get(
                                (id(mod), cls_name, a), set())
                        if callee_locks:
                            for ha in held:
                                for b in callee_locks:
                                    if b == ha:
                                        continue  # re-entry is GL001's beat
                                    graph.add(ha, b,
                                              (mod.path, child.lineno,
                                               ctx_name))
                    visit(child, held)

            visit(fn, [])


def _find_cycles(graph: _Graph) -> List[List[str]]:
    """Elementary cycles, deduped by rotation-canonical form. DFS with
    a bound that is far above any plausible lock graph here."""
    cycles: Set[Tuple[str, ...]] = set()
    edges = graph.edges

    def canon(path: List[str]) -> Tuple[str, ...]:
        i = path.index(min(path))
        return tuple(path[i:] + path[:i])

    for start in sorted(edges):
        stack = [(start, [start])]
        while stack:
            node, path = stack.pop()
            for nxt in sorted(edges.get(node, ())):
                if nxt == start:
                    cycles.add(canon(path))
                elif nxt not in path and len(path) < 6:
                    stack.append((nxt, path + [nxt]))
    return [list(c) for c in sorted(cycles)]


@register_project(_CODE, "lock-order")
def check(session: ProjectSession) -> List[Finding]:
    graph = _Graph()
    trans = _transitive_locks(session)
    _collect_edges(session, graph, trans)
    reentrant = _rlock_locks(session)
    out: List[Finding] = []
    for cycle in _find_cycles(graph):
        if len(cycle) == 1 and cycle[0] in reentrant:
            continue
        ring = cycle + [cycle[0]]
        path, line, ctx = graph.edges[cycle[0]][ring[1]]
        order = " -> ".join(ring)
        if len(cycle) == 1:
            msg = (
                f"lock {cycle[0]} is acquired while already held "
                f"(in {ctx}) and is not an RLock — guaranteed "
                f"self-deadlock on this path"
            )
        else:
            msg = (
                f"lock-order cycle {order}: two threads taking these "
                f"locks in opposite orders can deadlock; pick one "
                f"global order (or collapse to one lock)"
            )
        out.append(Finding(
            path=path, line=line, code=_CODE, message=msg,
            symbol="cycle:" + "->".join(ring),
        ))
    return out
