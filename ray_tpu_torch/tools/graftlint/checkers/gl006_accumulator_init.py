"""GL006 — additive accumulator initialized to ones.

The ``NormalizeObservations._m2`` bug class: an attribute that is only
ever grown with ``+=`` (a running sum — Welford/Chan second moments,
counters, loss totals) but seeded with ``np.ones(...)`` instead of the
additive identity. The spurious +1 per element biases every early
estimate (e.g. std estimates read high until the count washes it out)
and the bug is invisible at convergence — exactly the kind of defect
tests on trained policies never catch.

Flags, per class: an ``Assign`` of ``*.ones(...)`` (numpy / jnp /
np.ones_like etc.) to a ``self.<attr>`` that some method accumulates
into with ``+=``. Seed additive accumulators with ``zeros``; if a
multiplicative or epsilon-floor seed is really intended, suppress the
line with ``# graftlint: disable=GL006`` and say why.
"""

from __future__ import annotations

import ast
from typing import List, Set

from ..core import FileContext, Finding, dotted_name, register, self_attr, walk_local


def _is_ones_call(node: ast.AST, ctx: FileContext) -> bool:
    if not isinstance(node, ast.Call):
        return False
    name = ctx.resolve(dotted_name(node.func))
    if name is None:
        return False
    last = name.rsplit(".", 1)[-1]
    return last in ("ones", "ones_like")


def _added_attrs(cls: ast.ClassDef) -> Set[str]:
    out: Set[str] = set()
    for fn in cls.body:
        if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        for n in walk_local(fn):
            if isinstance(n, ast.AugAssign) and isinstance(n.op, ast.Add):
                a = self_attr(n.target)
                if a is not None:
                    out.add(a)
    return out


@register("GL006", "accumulator-ones-init")
def check(ctx: FileContext) -> List[Finding]:
    out: List[Finding] = []
    for cls in ast.walk(ctx.tree):
        if not isinstance(cls, ast.ClassDef):
            continue
        added = _added_attrs(cls)
        if not added:
            continue
        for fn in cls.body:
            if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            for n in walk_local(fn):
                if not isinstance(n, ast.Assign):
                    continue
                if not _is_ones_call(n.value, ctx):
                    continue
                for t in n.targets:
                    a = self_attr(t)
                    if a in added:
                        out.append(
                            Finding(
                                path=ctx.path,
                                line=n.lineno,
                                code="GL006",
                                message=(
                                    f"`self.{a}` is accumulated with "
                                    f"`+=` but seeded with `ones(...)` — "
                                    f"the additive identity is "
                                    f"`zeros(...)`; a ones seed biases "
                                    f"every early estimate"
                                ),
                                symbol=f"{cls.name}.{a}",
                            )
                        )
    return out
