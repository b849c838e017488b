"""GL012 — whole-program protocol conformance.

The reference encodes its wire contract in 21 checked ``.proto`` files;
ours is ``protocol.py`` string constants plus ``(msg_type, payload)``
dicts with **no compiler watching either side**. A typo'd payload key or
a handler nobody sends to isn't a build error here — it's a wedged
cluster at 2am. This pass rebuilds the message model the way a protobuf
compiler would, from the whole tree at once:

- **constants** from ``protocol.py``;
- **send sites**: ``_send``/``send``/``send_async``/``request``/
  ``_traced_send``/``_reply`` calls and raw ``dumps_frame((msg, p))``
  framing, with payload keys tracked through literal dicts, local
  augmentation (``payload["k"] = ...``) and ``dict(payload, k=...)``;
- **dispatch tables** in all three repo spellings: dict literals
  (``CoreClient._inbound_handlers``), the ``dir()``/``_on_`` convention
  table (``Hub._handlers``), and ``if/elif msg_type == P.X`` chains
  (node agent, worker main loop, object agent);
- **routing sets** (``SCHEDULER_MSGS``/``OBJECT_MSGS`` →
  ``SERVICE_OF``) for the sharded topology.

Findings:

1. *unregistered message string* — a send site or dispatch entry uses a
   message value no ``protocol.py`` constant defines (the contract file
   is THE catalog; a string that bypasses it is invisible to readers
   and to this pass's other checks);
2. *sent-but-unhandled* — a type some process sends that no dispatch
   table handles and no inline comparison consumes (the object plane's
   request/response replies are read inline, so ``mt != "obj_data"``
   counts as consumption);
3. *handled-but-never-sent* — dead dispatch surface, or a sender that
   was never written;
4. *topology divergence* — the single-reactor handler table
   (``Hub._handlers``) and the sharded routing sets must cover the
   IDENTICAL message set: a type missing from ``SERVICE_OF`` silently
   falls to the default service, a type only in ``SERVICE_OF`` is
   routed to a handler that doesn't exist;
5. *required payload key missing* — a key a handler reads by plain
   unconditional subscript is absent from some send site's tracked
   literal payload (``.get`` reads and reads under ``if`` are treated
   as optional);
6. *payload key never read* — a key every send site includes that no
   handler ever reads (dead wire weight), checked only when every
   handler's payload use is fully visible (no escapes/iteration);
7. *required item key missing* — vector payloads (bulk frames like
   ``SUBMIT_TASKS`` carrying ``tasks: [{...}, ...]``): a handler that
   loops ``for t in payload[k]`` and subscripts ``t["x"]``
   unconditionally requires ``x`` on EVERY item; a send site building
   the item list from tracked dict literals must include it.

The pass is inert in sessions without a ``protocol.py`` (single-file
fixture runs of other rules), so per-file checks stay per-file.
"""

from __future__ import annotations

from typing import Dict, List, Set

from ..core import Finding, register_project
from ..project import ProjectSession

_CODE = "GL012"


def _f(path: str, line: int, message: str, symbol: str) -> Finding:
    return Finding(path=path, line=line, code=_CODE, message=message,
                   symbol=symbol)


@register_project(_CODE, "protocol-conformance")
def check(session: ProjectSession) -> List[Finding]:
    pm = session.protocol()
    if pm.protocol_module is None or not pm.constants:
        return []
    out: List[Finding] = []
    sent = {s.msg for s in pm.sends}
    handled: Set[str] = set()
    for t in pm.tables:
        handled |= t.msgs

    # ---- 1. unregistered message strings
    for msg in sorted((sent | handled) - pm.constant_values):
        sites = pm.sends_of(msg)
        hs = pm.handlers_of(msg)
        if sites:
            anchor_path, anchor_line = sites[0].module.path, sites[0].line
        elif hs:
            anchor_path, anchor_line = hs[0].module.path, hs[0].line
        else:  # prefix-table entry with no method body found
            t = next(t for t in pm.tables if msg in t.msgs)
            anchor_path, anchor_line = t.module.path, t.line
        out.append(_f(
            anchor_path, anchor_line,
            f"message type {msg!r} is not defined in protocol.py — add a "
            f"constant (the protocol module is the wire contract; a bare "
            f"string bypasses it and every conformance check)",
            f"<protocol>.{msg}.unregistered",
        ))

    # ---- 2. sent but unhandled
    for msg in sorted(sent - handled - pm.compared):
        s = pm.sends_of(msg)[0]
        out.append(_f(
            s.module.path, s.line,
            f"message {msg!r} is sent here but no dispatch table handles "
            f"it and no receiver compares against it — a typo'd type or "
            f"a missing handler; the frame would be silently dropped",
            f"<protocol>.{msg}.unhandled",
        ))

    # ---- 3. handled but never sent
    for msg in sorted(handled - sent):
        hs = pm.handlers_of(msg)
        if hs:
            path, line, sym = hs[0].module.path, hs[0].line, hs[0].symbol
        else:
            t = next(t for t in pm.tables if msg in t.msgs)
            path, line, sym = t.module.path, t.line, t.owner
        out.append(_f(
            path, line,
            f"message {msg!r} has a handler ({sym}) but no send site "
            f"anywhere in the tree — dead dispatch surface, or the "
            f"sender was never wired up",
            f"<protocol>.{msg}.never_sent",
        ))

    # ---- 4. topology parity (single-reactor vs sharded routing)
    prefix_tables = [t for t in pm.tables if t.kind == "prefix"]
    routed: Set[str] = set()
    routed_anchor = None
    for r in pm.routing_sets:
        if r.sharded:
            routed |= r.msgs
            routed_anchor = routed_anchor or r
    if prefix_tables and routed_anchor is not None:
        hub_t = max(prefix_tables, key=lambda t: len(t.msgs))
        for msg in sorted(hub_t.msgs - routed):
            out.append(_f(
                routed_anchor.module.path, routed_anchor.line,
                f"message {msg!r} has a {hub_t.owner} handler but is "
                f"missing from the sharded routing sets — it would fall "
                f"to the default service implicitly; both topologies "
                f"must route the identical message set",
                f"<topology>.{msg}.unrouted",
            ))
        for msg in sorted(routed - hub_t.msgs):
            out.append(_f(
                routed_anchor.module.path, routed_anchor.line,
                f"message {msg!r} is routed by the sharded topology but "
                f"{hub_t.owner} has no handler for it — the single-"
                f"reactor hub would drop it; both topologies must cover "
                f"the identical message set",
                f"<topology>.{msg}.unhandled",
            ))

    # ---- 5./6. payload key conformance
    for msg in sorted(sent & handled):
        hs = pm.handlers_of(msg)
        ss = pm.sends_of(msg)
        if not hs or not ss:
            continue
        required: Dict[str, object] = {}
        for h in hs:
            for k in h.required_keys:
                required.setdefault(k, h)
        # ---- 7. vector payloads: per-item required keys
        item_required: Dict[object, object] = {}
        for h in hs:
            for pk, iks in h.item_required.items():
                for ik in iks:
                    item_required.setdefault((pk, ik), h)
        for s in ss:
            for (pk, ik), h in sorted(item_required.items()):
                iks = s.item_keys.get(pk)
                if iks is None or ik in iks:
                    # untracked item list = opaque (no claim either way)
                    continue
                out.append(_f(
                    s.module.path, s.line,
                    f"send site for {msg!r} builds {pk!r} items without "
                    f"key {ik!r} which {h.symbol} reads unconditionally "
                    f"on every item (for t in payload[{pk!r}]: "
                    f"t[{ik!r}]) — this send would KeyError in the "
                    f"handler",
                    f"{s.symbol}.{msg}.{pk}[].{ik}.missing",
                ))
        for s in ss:
            if s.keys is None:
                continue
            for k in sorted(set(required) - set(s.keys)):
                h = required[k]
                out.append(_f(
                    s.module.path, s.line,
                    f"send site for {msg!r} omits key {k!r} which "
                    f"{h.symbol} reads unconditionally "
                    f"(payload[{k!r}]) — this send would KeyError in "
                    f"the handler",
                    f"{s.symbol}.{msg}.{k}.missing",
                ))
        if any(h.opaque for h in hs) or any(s.keys is None for s in ss):
            continue
        read: Set[str] = set()
        for h in hs:
            read |= h.read_keys
        common = None
        for s in ss:
            common = set(s.keys) if common is None else common & set(s.keys)
        for k in sorted((common or set()) - read - {"req_id", "trace"}):
            s = ss[0]
            out.append(_f(
                s.module.path, s.line,
                f"payload key {k!r} of {msg!r} is produced by every send "
                f"site but never read by any handler "
                f"({', '.join(sorted({h.symbol for h in hs}))}) — dead "
                f"wire weight, or the read was lost in a refactor",
                f"<protocol>.{msg}.{k}.never_read",
            ))
    return out
