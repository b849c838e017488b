"""GL018 — per-call invariant re-serialization in a send loop.

The client-hot-path bug class the runtime removed twice: a submit
loop re-pickles the SAME value on every iteration — fn_id / resources /
options re-encoded per ``.remote()`` call, a template dict re-dumped
per task before ``send_bytes`` — when one encode hoisted above the
loop (or one cached opcode prefix, ``serialization.submit_frame_prefix``)
serves every iteration. At 10k calls/s the redundant encode is the
dominant client-side cost (bench_core ``submit_path_overhead``).

The checker flags a ``dumps``-family call (``dumps`` /
``dumps_frame`` / ``dumps_inline`` / ``dumps_function`` — covering
``pickle.dumps`` and ``cloudpickle.dumps`` through the attribute
spelling) inside a ``for``/``while`` loop in runtime-core code
(``_private/`` packages plus ``remote_function.py``) when

  1. the serialized expression mentions at least one variable (a bare
     literal is not "re-serializing an invariant" — it is just odd),
  2. every variable it mentions is LOOP-INVARIANT: plain names never
     bound inside the loop (for-targets, assignments, aug-assignments,
     walrus, ``with ... as``, ``except ... as``) and ``self.x``
     attributes never assigned inside the loop,
  3. the expression contains no call/comprehension/lambda/await (a
     nested call could produce a different value per iteration even
     from invariant inputs), AND
  4. the loop actually transmits — it contains a send-like call
     (``send`` / ``send_async`` / ``send_bytes`` / ``sendall`` /
     ``submit_task`` / ``submit_actor_task`` / ``request`` /
     ``publish``): encode-only loops (tests, codecs building corpora)
     are not the hot path this rule protects.

Fix shape: hoist the encode above the loop, or build a spliceable
template prefix once and hand-emit only the per-iteration fragment
(``serialization.submit_frame_prefix`` / ``task_entry_fragment``).
"""

from __future__ import annotations

import ast
import os
from typing import List, Optional, Set, Tuple

from ..core import FileContext, Finding, qualname_map, register, self_attr, walk_local

_DUMPS_NAMES = {"dumps", "dumps_frame", "dumps_inline", "dumps_function"}
_SEND_ATTRS = {
    "send", "send_async", "send_bytes", "sendall",
    "submit_task", "submit_actor_task", "request", "publish",
}
# constructs inside the serialized expression that can yield a fresh
# value per iteration even from invariant inputs
_DYNAMIC_NODES = (
    ast.Call, ast.ListComp, ast.SetComp, ast.DictComp,
    ast.GeneratorExp, ast.Lambda, ast.Await, ast.Yield, ast.YieldFrom,
)


def _is_dumps_call(node: ast.Call) -> bool:
    fn = node.func
    if isinstance(fn, ast.Attribute):
        return fn.attr in _DUMPS_NAMES
    if isinstance(fn, ast.Name):
        return fn.id in _DUMPS_NAMES
    return False


def _is_send_call(node: ast.Call) -> bool:
    fn = node.func
    return isinstance(fn, ast.Attribute) and fn.attr in _SEND_ATTRS


def _target_names(t: ast.AST) -> Set[str]:
    if isinstance(t, ast.Name):
        return {t.id}
    if isinstance(t, ast.Starred):
        return _target_names(t.value)
    if isinstance(t, (ast.Tuple, ast.List)):
        out: Set[str] = set()
        for e in t.elts:
            out |= _target_names(e)
        return out
    return set()


def _bound_in_loop(loop: ast.AST) -> Tuple[Set[str], Set[str]]:
    """(plain names, self-attributes) bound anywhere inside the loop —
    including the loop's own iteration target and nested loops (but not
    nested function bodies, per walk_local)."""
    names: Set[str] = set()
    attrs: Set[str] = set()
    if isinstance(loop, ast.For):
        names |= _target_names(loop.target)

    def bind(t: ast.AST) -> None:
        names.update(_target_names(t))
        sa = self_attr(t)
        if sa is not None:
            attrs.add(sa)

    for n in walk_local(loop):
        if isinstance(n, ast.For):
            bind(n.target)
        elif isinstance(n, ast.Assign):
            for t in n.targets:
                bind(t)
        elif isinstance(n, (ast.AugAssign, ast.AnnAssign)):
            bind(n.target)
        elif isinstance(n, ast.NamedExpr):
            bind(n.target)
        elif isinstance(n, ast.withitem) and n.optional_vars is not None:
            bind(n.optional_vars)
        elif isinstance(n, ast.ExceptHandler) and n.name:
            names.add(n.name)
    return names, attrs


def _roots(expr: ast.AST) -> Optional[Tuple[Set[str], Set[str]]]:
    """(plain names, self-attributes) the expression reads, or None if
    it contains a dynamic construct (condition 3)."""
    names: Set[str] = set()
    attrs: Set[str] = set()
    for n in ast.walk(expr):
        if isinstance(n, _DYNAMIC_NODES):
            return None
        if isinstance(n, ast.Attribute):
            sa = self_attr(n)
            if sa is not None:
                attrs.add(sa)
        elif isinstance(n, ast.Name) and n.id not in ("self", "cls"):
            names.add(n.id)
    return names, attrs


@register("GL018", "invariant-reserialization")
def check(ctx: FileContext) -> List[Finding]:
    norm = "/" + ctx.path.replace(os.sep, "/")
    if "/_private/" not in norm and not norm.endswith("/remote_function.py"):
        return []
    out: List[Finding] = []
    quals = qualname_map(ctx.tree)
    fns = [
        n for n in ast.walk(ctx.tree)
        if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))
    ]
    for fn in fns:
        for loop in walk_local(fn):
            if not isinstance(loop, (ast.For, ast.While)):
                continue
            calls = [
                n for n in walk_local(loop) if isinstance(n, ast.Call)
            ]
            if not any(_is_send_call(c) for c in calls):
                continue
            bound_names, bound_attrs = None, None
            for c in calls:
                if not (_is_dumps_call(c) and c.args):
                    continue
                roots = _roots(c.args[0])
                if roots is None:
                    continue  # dynamic expression: may vary per iteration
                names, attrs = roots
                if not names and not attrs:
                    continue  # pure literal (condition 1)
                if bound_names is None:
                    bound_names, bound_attrs = _bound_in_loop(loop)
                if names & bound_names or attrs & bound_attrs:
                    continue  # reads something the loop rebinds
                out.append(
                    Finding(
                        path=ctx.path,
                        line=c.lineno,
                        code="GL018",
                        message=(
                            "loop-invariant value re-serialized on "
                            "every iteration of a send loop: hoist the "
                            "encode above the loop (or cache a spliced "
                            "template prefix, serialization."
                            "submit_frame_prefix) instead of paying it "
                            "per call"
                        ),
                        symbol=quals.get(id(fn), fn.name),
                    )
                )
    return out
