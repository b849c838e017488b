"""GL015 — whole-program async discipline.

GL003 sees a coroutine that blocks *directly*; it cannot see the three
shapes the runtime actually shipped bugs (or hand-fixes) for:

(a) an ``async def`` calling a **sync helper** that transitively —
    through the project call graph — reaches a known-blocking API
    (GL003's tables are the roots) or takes a lock that a non-loop
    thread holds around blocking work. The coroutine never says
    ``sleep`` itself, but the loop stalls all the same.
(b) a call to a project ``async def`` whose coroutine is neither
    awaited nor stored: the body silently never runs (Python only
    warns at GC time, and only with warnings enabled).
(c) a closure handed to ``run_in_executor`` / ``Thread(target=)`` from
    a function that reads the ambient trace contextvar
    (``current_context`` / ``begin_trace``) without re-pushing it via
    ``push_context``: executor threads do not inherit contextvars, so
    the span parentage once restored by hand silently drops again.
    ``asyncio.to_thread`` copies context and bound-method targets carry
    no ambient reads, so only local lambdas/nested defs are checked;
    an ``if <x> is None:`` guard marks the no-trace fast path exempt.

All three read the lazily built :meth:`ProjectSession.flow` model;
see ``project._build_flow_model`` for the resolution rules.
"""

from __future__ import annotations

from typing import List

from ..core import Finding, register_project
from ..project import ProjectSession


@register_project("GL015", "async-discipline")
def check(session: ProjectSession) -> List[Finding]:
    out: List[Finding] = []
    fm = session.flow()
    for key, ff in fm.functions.items():
        # ---- (c) context-dropping dispatches (sync or async callers)
        for line, closure in ff.ctx_unsafe_dispatches:
            out.append(
                Finding(
                    path=ff.module.path,
                    line=line,
                    code="GL015",
                    message=(
                        f"`{ff.qual}` reads the ambient trace context but "
                        f"dispatches `{closure}` to an executor/thread "
                        f"without re-pushing it (`push_context(...)` inside "
                        f"the closure) — executor threads do not inherit "
                        f"contextvars, so the span parent is silently lost"
                    ),
                    symbol=f"{ff.qual}.{closure}.ctx_dropped",
                )
            )
        if not ff.is_async:
            continue
        seen_blocking = set()
        for line, callee, under_await, is_stmt in ff.calls:
            target = fm.functions.get(callee)
            if target is None:
                continue
            # ---- (b) coroutine created, never awaited or stored
            if target.is_async and is_stmt and not under_await:
                out.append(
                    Finding(
                        path=ff.module.path,
                        line=line,
                        code="GL015",
                        message=(
                            f"`{ff.qual}` calls `async def {callee}` "
                            f"without awaiting or storing the coroutine — "
                            f"the body never runs; add `await` or keep the "
                            f"task (`asyncio.create_task`)"
                        ),
                        symbol=f"{ff.qual}.{callee}.never_awaited",
                    )
                )
                continue
            # ---- (a) sync helper that transitively blocks
            if target.is_async or under_await or callee in seen_blocking:
                continue
            chain = fm.blocking_chain(callee)
            if chain is None:
                continue
            seen_blocking.add(callee)
            out.append(
                Finding(
                    path=ff.module.path,
                    line=line,
                    code="GL015",
                    message=(
                        f"`async def {ff.qual.rsplit('.', 1)[-1]}` calls "
                        f"sync `{callee}`, which blocks the event loop via "
                        f"{' -> '.join(chain)} — await an async equivalent "
                        f"or move the call to `run_in_executor`"
                    ),
                    symbol=f"{ff.qual}.{callee}.blocking",
                )
            )
    return out
