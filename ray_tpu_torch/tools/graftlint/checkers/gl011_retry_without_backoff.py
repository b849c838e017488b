"""GL011 — fixed-interval retry/retransmit loop (no backoff).

The client bug class: ``CoreClient.request`` parked on a reply future
and re-sent the request every fixed ~2s, forever. Fixed-cadence
retransmit turns every hub stall into a synchronized storm — all
clients resend on the same beat, the recovering peer takes the full
herd at once, stalls again, and the system ratchets into lockstep
congestion (the thundering-herd failure the reference avoids with
exponential backoff in ``rpc/retryable_grpc_client.h``).

The checker flags a ``while`` loop in runtime-core code
(any ``_private/`` package, plus ``ray_tpu_torch/serve/`` — the serve plane's
ejection re-probe and transparent handle-retry loops resend on exactly
this shape) that

  1. parks on a *wait-like* call (``.wait(...)``, a ``*wait`` helper
     such as ``concurrent.futures.wait``, or ``time.sleep``) whose
     timeout/duration argument never grows, AND
  2. re-sends something (``send`` / ``send_async`` / ``send_bytes`` /
     ``request``) in the same loop, AND
  3. contains no backoff term for the delay: no ``delay *= k`` /
     ``delay += k`` aug-assign and no re-assignment of the delay
     variable whose value refers to the variable itself through a
     multiplicative/additive expression (``delay = min(cap, delay*2)``
     counts; ``remaining = min(remaining, deadline - now)`` — a pure
     deadline clamp — does not).

Periodic *senders* (heartbeat loops pacing on ``conn.poll``; flush
loops with no resend call) are not wait-like + resend pairs and stay
clean. Fix shape: capped exponential backoff with jitter —
``delay = min(CAP, delay * 2)`` plus a randomized wait.
"""

from __future__ import annotations

import ast
import os
from typing import List, Optional, Set

from ..core import FileContext, Finding, qualname_map, register, walk_local

# attribute/function spellings that park the loop for a bounded time
_WAIT_ATTRS = {"wait", "sleep"}
# attribute spellings that (re-)transmit on the wire; "remote" covers
# the serve plane (handle retries / health re-probes dispatch through
# actor_method.remote(...))
_RESEND_ATTRS = {"send", "send_async", "send_bytes", "request", "remote"}


def _is_wait_call(node: ast.Call, ctx: FileContext) -> bool:
    fn = node.func
    if isinstance(fn, ast.Attribute):
        return fn.attr in _WAIT_ATTRS
    if isinstance(fn, ast.Name):
        resolved = ctx.resolve(fn.id) or fn.id
        return resolved == "time.sleep" or fn.id.endswith("wait")
    return False


def _is_resend_call(node: ast.Call) -> bool:
    fn = node.func
    return isinstance(fn, ast.Attribute) and fn.attr in _RESEND_ATTRS


def _timeout_expr(node: ast.Call) -> Optional[ast.AST]:
    """The duration the wait parks for: a `timeout=` kwarg, else the
    last positional arg (Event.wait(t) / time.sleep(t)); None for a
    bare wait() (wakes only by signal — not a cadence)."""
    for kw in node.keywords:
        if kw.arg == "timeout":
            return kw.value
    if node.args:
        return node.args[-1]
    return None


def _delay_names(expr: ast.AST) -> Set[str]:
    """Local variable names the wait duration is computed from
    (`self`/`cls` excluded: every method call mentions them, and a
    receiver is not a delay value — keeping them would let ANY
    `x = self.f(...)` masquerade as a backoff term)."""
    return {
        n.id for n in ast.walk(expr)
        if isinstance(n, ast.Name) and n.id not in ("self", "cls")
    }


_GROWTH_OPS = (ast.Mult, ast.Pow, ast.Add)


def _assign_targets(node: ast.Assign) -> Set[str]:
    out: Set[str] = set()
    for t in node.targets:
        if isinstance(t, ast.Name):
            out.add(t.id)
        elif isinstance(t, (ast.Tuple, ast.List)):
            out |= {e.id for e in t.elts if isinstance(e, ast.Name)}
    return out


def _expand_delay_names(loop: ast.While, names: Set[str]) -> Set[str]:
    """Backward dataflow closure: every local name the wait duration is
    derived from inside the loop (`remaining = resync * jitter` puts
    `resync` in the closure, so growth on it counts as backoff)."""
    out = set(names)
    changed = True
    while changed:
        changed = False
        for node in walk_local(loop):
            if not isinstance(node, ast.Assign):
                continue
            if not (_assign_targets(node) & out):
                continue
            new = _delay_names(node.value) - out
            if new:
                out |= new
                changed = True
    return out


def _has_growth(loop: ast.While, names: Set[str]) -> bool:
    """Does any statement in the loop grow a delay-chain variable —
    reassign it *in terms of itself* through a multiplicative/additive
    expression or a helper call (aug-assign counts too)? A pure clamp
    (`remaining = min(remaining, deadline - now)`) is not growth."""
    for node in walk_local(loop):
        if isinstance(node, ast.AugAssign):
            if (
                isinstance(node.target, ast.Name)
                and node.target.id in names
                and isinstance(node.op, _GROWTH_OPS)
            ):
                return True
        elif isinstance(node, ast.Assign):
            rhs_names = _delay_names(node.value)
            targets = _assign_targets(node)
            if not (targets & names):
                continue
            # growth-helper call: a delay-chain variable rebound from a
            # call fed by the chain (`wait, delay = self._retry_delay(delay)`,
            # or the conditional shape `wait, nxt = self._retry_delay(cur)`
            # + `cur = nxt` — nxt/cur are both in the closure). Bare
            # min()/max() are clamps, not growth — the pre-fix GET
            # loop's deadline clamp must still flag.
            if isinstance(node.value, ast.Call) and not (
                isinstance(node.value.func, ast.Name)
                and node.value.func.id in ("min", "max")
            ):
                if rhs_names & names:
                    return True
                continue
            # min()/max() falls through: `min(cap, delay * 2)` is
            # growth by its BinOp; a pure deadline clamp has none
            # self-referential: some delay-chain variable is rebound
            # from an expression that mentions it
            if not (targets & names & rhs_names):
                continue
            if any(
                isinstance(n, ast.BinOp) and isinstance(n.op, _GROWTH_OPS)
                for n in ast.walk(node.value)
            ):
                return True
    return False


@register("GL011", "retry-without-backoff")
def check(ctx: FileContext) -> List[Finding]:
    norm = "/" + ctx.path.replace(os.sep, "/")
    if "/_private/" not in norm and "ray_tpu_torch/serve/" not in norm:
        return []
    out: List[Finding] = []
    quals = qualname_map(ctx.tree)
    fns = [
        n for n in ast.walk(ctx.tree)
        if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))
    ]
    for fn in fns:
        for loop in walk_local(fn):
            if not isinstance(loop, ast.While):
                continue
            waits = [
                n for n in walk_local(loop)
                if isinstance(n, ast.Call) and _is_wait_call(n, ctx)
            ]
            resends = [
                n for n in walk_local(loop)
                if isinstance(n, ast.Call) and _is_resend_call(n)
            ]
            if not waits or not resends:
                continue
            names: Set[str] = set()
            constant_only = False
            for w in waits:
                expr = _timeout_expr(w)
                if expr is None:
                    continue
                n = _delay_names(expr)
                if n:
                    names |= n
                else:
                    constant_only = True  # .wait(2.0): literal cadence
            if not names and not constant_only:
                continue  # bare wait(): signal-driven, no cadence
            if names and _has_growth(
                loop, _expand_delay_names(loop, names)
            ):
                continue
            out.append(
                Finding(
                    path=ctx.path,
                    line=loop.lineno,
                    code="GL011",
                    message=(
                        "fixed-interval retransmit loop: the wait "
                        "duration never grows between resends — a hub "
                        "stall makes every client resend on the same "
                        "beat. Use capped exponential backoff with "
                        "jitter (delay = min(CAP, delay * 2))"
                    ),
                    symbol=quals.get(id(fn), fn.name),
                )
            )
    return out
