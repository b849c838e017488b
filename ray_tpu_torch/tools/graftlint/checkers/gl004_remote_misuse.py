"""GL004 — remote-API misuse.

Three sub-rules over the ``.remote()`` / ``ray_tpu_torch.get`` surface:

1. **discarded ObjectRef** — an expression statement that is a bare
   ``x.remote(...)`` call throws its ObjectRef away: errors are never
   observed and the task's return value is pinned until ownership GC
   guesses. Keep the ref (``_ = ...`` at minimum) or ``get``/``wait``
   it.

2. **get-of-fresh-ref in a loop** — ``ray_tpu_torch.get(f.remote(...))``
   inside a ``for``/``while`` loop *or comprehension* serializes what
   the API exists to parallelize: each iteration blocks on its own
   round-trip. Submit the whole batch first, then ``get`` the list
   once (``get`` of a *list comprehension* of refs is the good pattern
   and is not flagged).

3. **unserializable argument** — passing a lock/socket/file (or a
   ``self._lock``-style attribute) into ``.remote(...)``: the argument
   is pickled to another process, which either fails at call time or —
   worse — silently gives the worker a *different* lock.
"""

from __future__ import annotations

import ast
from typing import Dict, List, Optional

from ..core import FileContext, Finding, dotted_name, register, self_attr

_GET_BASES = {"ray", "ray_tpu", "ray_tpu_torch"}
_LOCK_HINTS = ("lock", "mutex", "cond", "cv", "sock", "conn")
_UNSERIALIZABLE_CTORS = {
    "threading.Lock", "threading.RLock", "threading.Condition",
    "threading.Event", "threading.Semaphore", "threading.BoundedSemaphore",
    "socket.socket", "socket.create_connection",
}


def _is_get_call(ctx: FileContext, call: ast.Call) -> bool:
    name = ctx.resolve(dotted_name(call.func))
    if not name or "." not in name:
        return False
    base, _, rest = name.rpartition(".")
    return rest == "get" and base.split(".")[0] in _GET_BASES


def _is_remote_call(node: ast.AST) -> bool:
    return (
        isinstance(node, ast.Call)
        and isinstance(node.func, ast.Attribute)
        and node.func.attr == "remote"
    )


def _scope_name(stack: List[str]) -> str:
    return ".".join(stack) or "<module>"


@register("GL004", "remote-api-misuse")
def check(ctx: FileContext) -> List[Finding]:
    out: List[Finding] = []

    def visit(node: ast.AST, scope: List[str], loop_depth: int,
              lock_locals: Dict[str, str]) -> None:
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                visit(child, scope + [child.name], 0, {})
                continue
            if isinstance(child, ast.ClassDef):
                visit(child, scope + [child.name], 0, {})
                continue
            if isinstance(child, ast.Lambda):
                continue

            # track locals bound to known-unserializable constructors
            if isinstance(child, ast.Assign) and isinstance(child.value, ast.Call):
                ctor = ctx.resolve(dotted_name(child.value.func))
                if ctor in _UNSERIALIZABLE_CTORS:
                    for t in child.targets:
                        if isinstance(t, ast.Name):
                            lock_locals[t.id] = ctor

            # rule 1: discarded ObjectRef
            if isinstance(child, ast.Expr) and _is_remote_call(child.value):
                out.append(
                    Finding(
                        path=ctx.path,
                        line=child.lineno,
                        code="GL004",
                        message=(
                            "ObjectRef from `.remote(...)` is discarded — "
                            "task errors are never observed; keep the ref "
                            "and `get`/`wait` it (or bind it explicitly)"
                        ),
                        symbol=f"{_scope_name(scope)}.discarded",
                    )
                )

            if isinstance(child, ast.Call):
                # rule 2: get of a ref created in this same loop body
                if loop_depth > 0 and _is_get_call(ctx, child):
                    args = child.args
                    if args and _is_remote_call(args[0]):
                        out.append(
                            Finding(
                                path=ctx.path,
                                line=child.lineno,
                                code="GL004",
                                message=(
                                    "`get(x.remote(...))` inside a loop "
                                    "serializes the remote calls — submit "
                                    "all refs first, then `get` the list "
                                    "once"
                                ),
                                symbol=f"{_scope_name(scope)}.get_in_loop",
                            )
                        )
                # rule 3: unserializable args to .remote(...) —
                # keyword arguments pickle the same way positionals do
                if _is_remote_call(child):
                    for arg in list(child.args) + [
                        kw.value for kw in child.keywords
                    ]:
                        bad: Optional[str] = None
                        a = self_attr(arg)
                        if a is not None and any(
                            h in a.lower() for h in _LOCK_HINTS
                        ):
                            bad = f"self.{a}"
                        elif (
                            isinstance(arg, ast.Name)
                            and arg.id in lock_locals
                        ):
                            bad = f"{arg.id} ({lock_locals[arg.id]}())"
                        elif isinstance(arg, ast.Call):
                            ctor = ctx.resolve(dotted_name(arg.func))
                            if ctor in _UNSERIALIZABLE_CTORS:
                                bad = f"{ctor}()"
                        if bad is not None:
                            out.append(
                                Finding(
                                    path=ctx.path,
                                    line=child.lineno,
                                    code="GL004",
                                    message=(
                                        f"`{bad}` passed to `.remote(...)` "
                                        f"— locks/sockets don't pickle "
                                        f"(or arrive as a disconnected "
                                        f"copy); pass plain data and "
                                        f"rebuild the handle worker-side"
                                    ),
                                    symbol=(
                                        f"{_scope_name(scope)}.unserializable"
                                    ),
                                )
                            )

            # a comprehension's element expression runs once per item,
            # so `[get(f.remote(x)) for x in xs]` serializes exactly
            # like the for-loop spelling
            entered_loop = isinstance(
                child,
                (ast.For, ast.While, ast.AsyncFor,
                 ast.ListComp, ast.SetComp, ast.DictComp, ast.GeneratorExp),
            )
            visit(child, scope, loop_depth + (1 if entered_loop else 0),
                  lock_locals)

    visit(ctx.tree, [], 0, {})
    return out
