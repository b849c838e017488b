"""GL009 — unbounded registry growth in message handlers.

The hub-side leak class this repo grows around: a long-lived reactor
class keeps dict/list registries (``self.objects``, ``self.workers``,
``self.jobs``...) that message handlers insert into on every inbound
request. If no code path anywhere in the class ever removes entries —
no ``pop``/``del``/``clear``/``remove``/reassignment in a disconnect or
cleanup handler — the registry grows for the lifetime of the control
plane: client churn alone OOMs a multi-tenant hub that never restarts.

Flagged shape::

    class Hub:
        def __init__(self):
            self.jobs = {}
        def _on_register_job(self, conn, p):
            self.jobs[p["job_id"]] = make_entry(p)   # GL009
        # ...no method ever pops/dels/clears/reassigns self.jobs

Fix shape: prune in the disconnect/cleanup path (or bound the table)::

        def _handle_disconnect(self, conn):
            for job_id in self._jobs_of(conn):
                self.jobs.pop(job_id, None)

Scope is deliberately narrow to keep the signal clean:

- only instance attrs initialized EMPTY (``{}``/``dict()``/``[]``/
  ``list()``) in ``__init__`` — seeded tables are usually static maps;
- only growth sites written directly in *handler-shaped* methods
  (``_on_*`` message handlers and ``register_*`` registration
  endpoints) — request-path helpers have their own lifecycles;
- any trim anywhere in the class (``pop``/``popitem``/``popleft``/
  ``clear``/``remove``/``del x[k]``/slice-assign/reassignment outside
  ``__init__``) counts as the cleanup edge.
"""

from __future__ import annotations

import ast
from typing import Dict, List, Optional, Set, Tuple

from ..core import FileContext, Finding, register, self_attr, walk_local

_GROW_CALLS = {"append", "extend", "insert", "appendleft", "setdefault"}
_TRIM_CALLS = {
    "pop", "popitem", "popleft", "remove", "clear", "discard",
}
_HANDLER_PREFIXES = ("_on_", "register_")


def _empty_container(value: Optional[ast.AST]) -> bool:
    if isinstance(value, ast.Dict) and not value.keys:
        return True
    if isinstance(value, ast.List) and not value.elts:
        return True
    if (
        isinstance(value, ast.Call)
        and isinstance(value.func, ast.Name)
        and value.func.id in ("dict", "list")
        and not value.args
        and not value.keywords
    ):
        return True
    return False


def _methods(cls: ast.ClassDef):
    for item in cls.body:
        if isinstance(item, (ast.FunctionDef, ast.AsyncFunctionDef)):
            yield item


def _registry_attrs(cls: ast.ClassDef) -> Set[str]:
    attrs: Set[str] = set()
    for fn in _methods(cls):
        if fn.name != "__init__":
            continue
        for n in walk_local(fn):
            targets: List[ast.AST] = []
            if isinstance(n, ast.Assign) and _empty_container(n.value):
                targets = list(n.targets)
            elif isinstance(n, ast.AnnAssign) and _empty_container(n.value):
                targets = [n.target]
            for t in targets:
                a = self_attr(t)
                if a is not None:
                    attrs.add(a)
    return attrs


def _grow_sites(
    cls: ast.ClassDef, attrs: Set[str]
) -> Dict[str, List[Tuple[str, int]]]:
    """attr -> [(handler, line)] for growth written directly in a
    handler-shaped method (_on_* / register_*)."""
    grows: Dict[str, List[Tuple[str, int]]] = {}
    for fn in _methods(cls):
        if not fn.name.startswith(_HANDLER_PREFIXES):
            continue
        for n in walk_local(fn):
            # self.X[key] = ... (dict insert), possibly chained
            # (`m = self.X[key] = {...}`)
            if isinstance(n, ast.Assign):
                for t in n.targets:
                    if isinstance(t, ast.Subscript):
                        a = self_attr(t.value)
                        if a in attrs:
                            grows.setdefault(a, []).append(
                                (fn.name, n.lineno)
                            )
            # self.X.append(...) / self.X.setdefault(...)
            elif (
                isinstance(n, ast.Call)
                and isinstance(n.func, ast.Attribute)
                and n.func.attr in _GROW_CALLS
            ):
                a = self_attr(n.func.value)
                if a in attrs:
                    grows.setdefault(a, []).append((fn.name, n.lineno))
    return grows


def _trimmed_attrs(cls: ast.ClassDef, attrs: Set[str]) -> Set[str]:
    trimmed: Set[str] = set()
    for fn in _methods(cls):
        in_init = fn.name == "__init__"
        for n in walk_local(fn):
            if (
                isinstance(n, ast.Call)
                and isinstance(n.func, ast.Attribute)
                and n.func.attr in _TRIM_CALLS
            ):
                a = self_attr(n.func.value)
                if a in attrs:
                    trimmed.add(a)
            elif isinstance(n, ast.Delete):
                for t in n.targets:
                    if isinstance(t, ast.Subscript):
                        a = self_attr(t.value)
                        if a in attrs:
                            trimmed.add(a)
            elif isinstance(n, ast.Assign) and not in_init:
                targets = [
                    e
                    for t in n.targets
                    for e in (
                        t.elts if isinstance(t, (ast.Tuple, ast.List))
                        else [t]
                    )
                ]
                for t in targets:
                    # reassignment resets; slice-assign can shrink
                    a = self_attr(t)
                    if a in attrs:
                        trimmed.add(a)
                    if isinstance(t, ast.Subscript):
                        a = self_attr(t.value)
                        if a in attrs and isinstance(t.slice, ast.Slice):
                            trimmed.add(a)
    return trimmed


@register("GL009", "unbounded-registry-growth")
def check(ctx: FileContext) -> List[Finding]:
    out: List[Finding] = []
    for cls in ast.walk(ctx.tree):
        if not isinstance(cls, ast.ClassDef):
            continue
        attrs = _registry_attrs(cls)
        if not attrs:
            continue
        grows = _grow_sites(cls, attrs)
        if not grows:
            continue
        trimmed = _trimmed_attrs(cls, attrs)
        for attr, sites in sorted(grows.items()):
            if attr in trimmed:
                continue
            meth, line = sites[0]
            out.append(
                Finding(
                    path=ctx.path,
                    line=line,
                    code="GL009",
                    message=(
                        f"registry `self.{attr}` is inserted into by "
                        f"handler `{cls.name}.{meth}` but no method of "
                        f"`{cls.name}` ever prunes it — a long-lived "
                        f"control plane leaks one entry per request; "
                        f"remove entries in the disconnect/cleanup path "
                        f"or bound the table"
                    ),
                    symbol=f"{cls.name}.{attr}",
                )
            )
    return out
