"""GL010 — cross-shard / state-service attribute access from reactor code.

The multi-reactor hub (ray_tpu_torch/_private/hub_shards.py) splits the
control plane into reactor shards (threads owning sockets + wire codec)
and single-thread-owned state services (scheduler+fairsched, object
directory) living behind the state plane.  The whole design rests on
one invariant: **reactor code never touches hub/service/peer-shard
mutable state directly** — everything crosses the boundary as a message
on an SPSC ring.  One stray ``self.hub.objects[oid] = ...`` from a
shard thread reintroduces exactly the data races the split exists to
remove, and it does so silently (the GIL makes most such races rare
enough to pass tests and corrupt state in production).

The checker flags, inside methods of reactor classes (class name
containing ``Shard`` or ``Reactor`` — the repo's reactor-code marker),
any attribute read or write whose base resolves to a hub / state-plane
/ service / peer-shard reference (``self.hub.x``, ``hub.x``,
``self.peers[i].x``, or a local alias assigned from one), unless the
accessed attribute is part of the message-queue API allow-list
(``push``/``drain``/``adopt``/``post``/``wake``/``stop``/``idx`` —
the ring and shard control surface, all single-writer safe).

Ring/stat containers the shard itself owns (``self._state_ring``,
``self.outbound``, ``self.stats``) are not banned bases: ownership is
the point, not indirection for its own sake.
"""

from __future__ import annotations

import ast
import re
from typing import List, Set

from ..core import FileContext, Finding, register

_REACTOR_CLASS = re.compile(r"(Shard|Reactor)")

# object families reactor code must only reach by message
BANNED_BASES = {
    "hub", "state", "state_plane", "service", "services",
    "scheduler_service", "object_service", "object_directory",
    "shard", "shards", "peer", "peers",
}
# the message-queue / control API (single-writer-safe by construction)
ALLOWED_ATTRS = {"push", "drain", "adopt", "post", "wake", "stop", "idx"}


def _base_name(node: ast.AST) -> str:
    """Innermost meaningful base identifier of an attribute access:
    ``self.hub`` -> "hub", ``hub`` -> "hub", ``self.peers[i]`` ->
    "peers", anything else -> ""."""
    while isinstance(node, ast.Subscript):
        node = node.value
    if isinstance(node, ast.Attribute):
        if isinstance(node.value, ast.Name) and node.value.id == "self":
            return node.attr
        return ""
    if isinstance(node, ast.Name):
        return node.id
    return ""


def _banned_locals(fn: ast.AST, banned: Set[str]) -> Set[str]:
    """Names assigned from a banned base alias it:
    ``target = self.peers[i]`` makes ``target`` banned too."""
    out = set(banned)
    changed = True
    while changed:  # tiny fixpoint: aliases of aliases
        changed = False
        for node in ast.walk(fn):
            if not isinstance(node, ast.Assign):
                continue
            if not isinstance(
                node.value, (ast.Attribute, ast.Subscript, ast.Name)
            ):
                continue
            if _base_name(node.value) not in out:
                continue
            for tgt in node.targets:
                if isinstance(tgt, ast.Name) and tgt.id not in out:
                    out.add(tgt.id)
                    changed = True
    return out


@register("GL010", "cross-shard-state-access")
def check(ctx: FileContext) -> List[Finding]:
    out: List[Finding] = []
    for cls in ast.walk(ctx.tree):
        if not isinstance(cls, ast.ClassDef):
            continue
        if not _REACTOR_CLASS.search(cls.name):
            continue
        for fn in cls.body:
            if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            banned = _banned_locals(fn, BANNED_BASES)
            for node in ast.walk(fn):
                if not isinstance(node, ast.Attribute):
                    continue
                base = _base_name(node.value)
                if base in banned and node.attr not in ALLOWED_ATTRS:
                    out.append(
                        Finding(
                            path=ctx.path,
                            line=node.lineno,
                            code="GL010",
                            message=(
                                f"reactor code touches {base}.{node.attr} "
                                "directly — shards must reach hub/service/"
                                "peer-shard state via the message ring "
                                "(push/post/adopt), never shared "
                                "attributes; see hub_shards.py"
                            ),
                            symbol=f"{cls.name}.{fn.name}.{base}.{node.attr}",
                        )
                    )
    return out
