"""GL003 — blocking call inside ``async def``.

The serve proxy and actor event loops run many requests on one thread;
a single synchronous sleep, file read, subprocess, or socket round-trip
inside a coroutine stalls *every* in-flight request on that loop (the
reference's "blocking call in asyncio loop" anti-pattern).

Flags calls to a known-blocking API inside an ``async def`` body
(nested sync ``def``s are excluded — they execute wherever they're
called). Resolution goes through the file's imports, so ``from time
import sleep`` / ``import subprocess as sp`` are caught too.

Two table shapes:

- ``BLOCKING``: dotted names resolved through imports (``time.sleep``);
- ``BLOCKING_METHODS``: the no-timeout *method* forms —
  ``Future.result()``, ``Event.wait()``, ``Queue.get()`` — which park
  the calling thread forever if the other side never shows up. These
  are receiver-typed: ``fut.result()`` only blocks when ``fut`` really
  is a future, so recognition pairs the method name with a local
  constructor scan plus receiver-name hints. Awaited calls are exempt
  (``await queue.get()`` on an ``asyncio.Queue`` is the fix shape, not
  the bug). The same tables seed the whole-program flow model's
  transitive-blocking roots (GL015), so a sync helper reaching one of
  these forms taints every coroutine that calls the helper.

Fix shape: ``await asyncio.sleep(...)``, ``loop.run_in_executor(...)``,
or move the work to a worker thread before entering the coroutine.
"""

from __future__ import annotations

import ast
from typing import Dict, List, Optional, Tuple

from ..core import FileContext, Finding, dotted_name, qualname_map, register

BLOCKING = {
    "time.sleep": "use `await asyncio.sleep(...)`",
    "subprocess.run": "use `await asyncio.create_subprocess_exec(...)`",
    "subprocess.call": "use `await asyncio.create_subprocess_exec(...)`",
    "subprocess.check_call": "use `await asyncio.create_subprocess_exec(...)`",
    "subprocess.check_output": "use `await asyncio.create_subprocess_exec(...)`",
    "os.system": "use `await asyncio.create_subprocess_shell(...)`",
    "os.popen": "use `await asyncio.create_subprocess_shell(...)`",
    "socket.create_connection": "use `await asyncio.open_connection(...)`",
    "urllib.request.urlopen": "use an async client or run_in_executor",
    "requests.get": "use an async client or run_in_executor",
    "requests.post": "use an async client or run_in_executor",
    "requests.put": "use an async client or run_in_executor",
    "requests.delete": "use an async client or run_in_executor",
    "requests.head": "use an async client or run_in_executor",
    "requests.request": "use an async client or run_in_executor",
    "open": "read via run_in_executor (sync file IO blocks the loop)",
}

# back-compat alias (the table predates the method-form growth)
_BLOCKING = BLOCKING

# no-timeout blocking method forms: method name -> (receiver kind, fix)
BLOCKING_METHODS: Dict[str, Tuple[str, str]] = {
    "result": ("future", "await the future, or pass a deadline-derived "
                         "timeout so a lost reply cannot park the thread"),
    "wait": ("event", "await an asyncio.Event, or pass a timeout and "
                      "re-check the condition"),
    "get": ("queue", "use asyncio.Queue + await get(), or pass a timeout"),
}

# constructor/factory trailing names -> receiver kind, for the local
# ctor scan (``fut = pool.submit(...)`` types ``fut`` as a future)
_CTOR_KINDS = {
    "Future": "future",
    "submit": "future",
    "run_coroutine_threadsafe": "future",
    "Event": "event",
    "Queue": "queue",
    "SimpleQueue": "queue",
    "LifoQueue": "queue",
    "PriorityQueue": "queue",
}

# receiver-name substrings typing self-attrs and parameters the ctor
# scan cannot see (``self._ready.wait()``)
_NAME_HINTS = {
    "future": ("fut", "promise"),
    "event": ("event", "evt", "ready", "stopped", "shutdown", "_stop",
              "done"),
    "queue": ("queue", "_q", "inbox", "outbox"),
}


def local_ctor_kinds(fn: ast.AST) -> Dict[str, str]:
    """name -> receiver kind for locals assigned from a recognized
    constructor/factory inside ``fn`` (nested defs excluded — their
    locals are not this function's)."""
    out: Dict[str, str] = {}
    stack = list(ast.iter_child_nodes(fn))
    while stack:
        n = stack.pop()
        if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
            continue
        if isinstance(n, ast.Assign) and isinstance(n.value, ast.Call):
            f = n.value.func
            tail = f.attr if isinstance(f, ast.Attribute) else (
                f.id if isinstance(f, ast.Name) else None)
            kind = _CTOR_KINDS.get(tail or "")
            if kind:
                for t in n.targets:
                    if isinstance(t, ast.Name):
                        out[t.id] = kind
        stack.extend(ast.iter_child_nodes(n))
    return out


def _receiver_name(call: ast.Call) -> Optional[str]:
    """Trailing identifier of the method call's receiver:
    ``self._ready.wait()`` -> "_ready", ``q.get()`` -> "q"."""
    f = call.func
    if not isinstance(f, ast.Attribute):
        return None
    base = f.value
    if isinstance(base, ast.Attribute):
        return base.attr
    if isinstance(base, ast.Name):
        return base.id
    return None


def blocking_method_form(
    call: ast.Call, local_kinds: Dict[str, str]
) -> Optional[Tuple[str, str, str]]:
    """(receiver, kind, fix hint) when ``call`` is a no-timeout blocking
    method form (``fut.result()`` / ``evt.wait()`` / ``q.get()`` with no
    arguments at all — any argument may bound the wait)."""
    if call.args or call.keywords:
        return None
    f = call.func
    if not isinstance(f, ast.Attribute) or f.attr not in BLOCKING_METHODS:
        return None
    want_kind, hint = BLOCKING_METHODS[f.attr]
    recv = _receiver_name(call)
    if recv is None:
        return None
    kind = local_kinds.get(recv)
    if kind is None:
        low = recv.lower()
        for k, hints in _NAME_HINTS.items():
            if any(h in low for h in hints):
                kind = k
                break
    if kind != want_kind:
        return None
    return recv, kind, hint


def _async_body_calls(fn: ast.AsyncFunctionDef):
    """Calls lexically inside the coroutine (not nested sync defs)."""
    stack = list(ast.iter_child_nodes(fn))
    while stack:
        n = stack.pop()
        if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
            # sync defs run wherever they're *called*; nested async
            # defs are visited by check() themselves — descending here
            # too would report their calls once per enclosing coroutine
            continue
        if isinstance(n, ast.Call):
            yield n
        stack.extend(ast.iter_child_nodes(n))


@register("GL003", "blocking-call-in-async")
def check(ctx: FileContext) -> List[Finding]:
    out: List[Finding] = []
    quals = qualname_map(ctx.tree)
    for fn in ast.walk(ctx.tree):
        if not isinstance(fn, ast.AsyncFunctionDef):
            continue
        qual = quals.get(id(fn), fn.name)
        # every node under an Await: `await q.get()` is the asyncio
        # primitive, and `await asyncio.wait_for(q.get(), t)` hands the
        # coroutine to the scheduler — neither blocks the thread
        awaited = {
            id(sub)
            for n in ast.walk(fn)
            if isinstance(n, ast.Await)
            for sub in ast.walk(n)
        }
        local_kinds = local_ctor_kinds(fn)
        for call in _async_body_calls(fn):
            if id(call) in awaited:
                continue
            name = ctx.resolve(dotted_name(call.func))
            hint = BLOCKING.get(name or "")
            if hint is not None:
                out.append(
                    Finding(
                        path=ctx.path,
                        line=call.lineno,
                        code="GL003",
                        message=(
                            f"blocking `{name}(...)` inside `async def "
                            f"{fn.name}` stalls every request on this event "
                            f"loop — {hint}"
                        ),
                        symbol=f"{qual}.{name}",
                    )
                )
                continue
            form = blocking_method_form(call, local_kinds)
            if form is not None:
                recv, kind, fix = form
                method = call.func.attr
                out.append(
                    Finding(
                        path=ctx.path,
                        line=call.lineno,
                        code="GL003",
                        message=(
                            f"no-timeout `{recv}.{method}()` inside "
                            f"`async def {fn.name}` parks the event loop "
                            f"until the {kind} resolves — {fix}"
                        ),
                        symbol=f"{qual}.{recv}.{method}",
                    )
                )
    return out
