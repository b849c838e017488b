"""GL007 — reflection dispatch in a message loop.

The hub ``_handle`` bug class: a reactor/dispatch loop resolves its
handler per message with ``getattr(obj, f"_on_{msg_type}")``. Every
message then pays an f-string build plus a dynamic attribute lookup —
pure overhead on the control plane's hottest path — and the handler
set is invisible to static analysis (a typo'd handler name silently
becomes "unknown message, drop").

The checker flags a ``getattr`` call whose *name* argument is built
dynamically from strings — an f-string (``ast.JoinedStr``), a
``"_on_" + x`` concatenation, a ``"_on_%s" % x`` format, or a
``"_on_{}".format(x)`` call — when the call sits inside a ``while`` or
``for`` loop. One-off reflection outside a loop (CLI subcommand
resolution, test helpers) is idiomatic and not flagged, as is a
constant name (``getattr(mod, "handler", None)``: a feature probe,
not per-message dispatch).

Fix shape: build a ``{msg_type: bound_method}`` dispatch table once at
construction time and do a dict lookup per message.
"""

from __future__ import annotations

import ast
from typing import List

from ..core import FileContext, Finding, qualname_map, register, walk_local


def _is_dynamic_str(node: ast.AST) -> bool:
    """A string built per evaluation: f-string, str concat/format with a
    literal component, or "...".format(...). A plain Name/Attribute is
    NOT flagged (passing a precomputed name through getattr is the
    table pattern itself)."""
    if isinstance(node, ast.JoinedStr):
        return True
    if isinstance(node, ast.BinOp) and isinstance(node.op, (ast.Add, ast.Mod)):
        return any(
            isinstance(side, ast.Constant) and isinstance(side.value, str)
            or _is_dynamic_str(side)
            for side in (node.left, node.right)
        )
    if (
        isinstance(node, ast.Call)
        and isinstance(node.func, ast.Attribute)
        and node.func.attr == "format"
        and isinstance(node.func.value, ast.Constant)
        and isinstance(node.func.value.value, str)
    ):
        return True
    return False


def _is_dynamic_getattr(node: ast.AST) -> bool:
    return (
        isinstance(node, ast.Call)
        and isinstance(node.func, ast.Name)
        and node.func.id == "getattr"
        and len(node.args) >= 2
        and _is_dynamic_str(node.args[1])
    )


@register("GL007", "reflection-dispatch-in-loop")
def check(ctx: FileContext) -> List[Finding]:
    out: List[Finding] = []
    quals = qualname_map(ctx.tree)
    seen = set()
    scopes = [(ctx.tree, "<module>")]
    for node in ast.walk(ctx.tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            scopes.append((node, quals.get(id(node), node.name)))
    for scope, qual in scopes:
        for loop in walk_local(scope):
            if not isinstance(loop, (ast.While, ast.For, ast.AsyncFor)):
                continue
            for n in walk_local(loop):
                if _is_dynamic_getattr(n) and id(n) not in seen:
                    seen.add(id(n))
                    out.append(
                        Finding(
                            path=ctx.path,
                            line=n.lineno,
                            code="GL007",
                            message=(
                                "string-built getattr handler resolution "
                                "inside a loop — every iteration pays string "
                                "build + dynamic lookup; build a "
                                "{key: bound_method} dispatch table once "
                                "and index it"
                            ),
                            symbol=qual,
                        )
                    )
    return out
