"""GL013 — thread-ownership conformance (the whole-program GL010).

GL010 polices one hand-labelled boundary (reactor classes must not
touch hub/service state) by *syntactic base names*. This pass infers
the ownership map instead: every thread entry point the repo actually
has — ``threading.Thread(target=...)`` constructions, Thread-subclass /
reactor ``run`` methods, ``CoreClient._read_loop``, dispatch-table
handlers (they run wherever their dispatcher runs), ``_add_timer``
callbacks — seeds a **domain**, and domains propagate through the
intra-class call graph. Code whose domain we cannot see (public API
methods called from arbitrary user threads) is NOT policed: the pass
reports only conflicts between two *known* domains, which keeps it
quiet on the tree and loud on the bug class it exists for.

Findings:

1. *intra-class conflict* — an attribute written in one domain and
   read/written in another, with no lock held at either site. Exempt:
   ``__init__`` writes (construction happens-before thread start),
   channel attributes (rings/queues/events/locks — mutating one IS the
   sanctioned crossing), and GIL-atomic flag attributes whose every
   write stores a constant (``self._running = False`` — the repo's
   cooperative-shutdown idiom);
2. *cross-object call* — a domain-owned method calling a method that
   is owned by a DIFFERENT domain of another class, e.g. the
   first-draft bug this rule re-catches: a reactor shard calling
   ``hub._handle_disconnect(conn)`` directly instead of pushing
   ``CONN_LOST`` onto its state ring. The ring crossing
   (``self._state_ring.push(...)``) passes because ``ShardRing`` has
   no thread domains — its whole point is to be safely shared;
3. *cross-object write* — a domain-owned method writing attributes of
   an instance whose class runs under a disjoint domain set.
   Construction is exempt: a function that just built the object (and
   hasn't started its thread) owns it outright;
4. *cross-object read* of an attribute the owning class writes
   post-init from its own domains (reading a foreign thread's mutable
   state without a lock). Reads of construction-set attributes and of
   stats objects without domains stay legal — scrape-time reads of
   monotonic counters are a documented pattern here.

Type inference is deliberately modest (constructor assignments,
annotations, iteration over known collections, and a name fallback
``self.hub`` -> class ``Hub``); what it cannot resolve it does not
flag.
"""

from __future__ import annotations

import ast
from typing import Dict, List, Optional, Set, Tuple

from ..core import Finding, register_project, self_attr, walk_local
from ..project import (
    ClassThreads,
    ProjectSession,
    ThreadModel,
    is_lockish as _is_lockish,
)

_CODE = "GL013"
_MUTATORS = {
    "append", "extend", "insert", "add", "pop", "popleft", "popitem",
    "remove", "discard", "clear", "update", "setdefault", "appendleft",
    "move_to_end", "put", "put_nowait",
}


def _lock_with(node: ast.AST) -> bool:
    if not isinstance(node, (ast.With, ast.AsyncWith)):
        return False
    for item in node.items:
        attr = self_attr(item.context_expr)
        if attr is not None and _is_lockish(attr):
            return True
        if isinstance(item.context_expr, ast.Name) and _is_lockish(
                item.context_expr.id):
            return True
    return False


def _locked_ids(fn: ast.AST) -> Set[int]:
    out: Set[int] = set()
    for n in ast.walk(fn):
        if _lock_with(n):
            for sub in ast.walk(n):
                out.add(id(sub))
    return out


def _const_flag_attrs(info: ClassThreads) -> Set[str]:
    """Attributes whose every write (anywhere in the class) assigns a
    bare constant — GIL-atomic signal flags like ``self._running``."""
    methods = info.module.methods(info.cls)
    flag: Dict[str, bool] = {}
    for fn in methods.values():
        for n in ast.walk(fn):
            if isinstance(n, (ast.Assign, ast.AnnAssign)):
                if isinstance(n, ast.AnnAssign) and n.value is None:
                    continue  # bare annotation: declares, assigns nothing
                targets = n.targets if isinstance(n, ast.Assign) else [n.target]
                for t in targets:
                    a = self_attr(t)
                    if a is None:
                        continue
                    is_const = isinstance(n.value, ast.Constant)
                    flag[a] = flag.get(a, True) and is_const
            elif isinstance(n, ast.AugAssign):
                a = self_attr(n.target)
                if a is not None:
                    flag[a] = False
    return {a for a, ok in flag.items() if ok}


def _attr_accesses(
    fn: ast.AST,
) -> List[Tuple[str, str, int, bool]]:
    """(attr, kind, line, locked) for self.<attr> accesses in fn:
    kind is "read" or "write" (assign/augassign/subscript store/
    mutator call/delete)."""
    locked = _locked_ids(fn)
    out: List[Tuple[str, str, int, bool]] = []
    for n in walk_local(fn):
        if isinstance(n, (ast.Assign, ast.AugAssign, ast.AnnAssign)):
            if isinstance(n, ast.AnnAssign) and n.value is None:
                continue  # bare annotation: declares, assigns nothing
            targets = n.targets if isinstance(n, ast.Assign) else [n.target]
            for t in targets:
                a = self_attr(t)
                if a is not None:
                    out.append((a, "write", n.lineno, id(n) in locked))
                if isinstance(t, (ast.Subscript, ast.Attribute)):
                    a = self_attr(t.value)
                    if a is not None:
                        out.append((a, "write", n.lineno, id(n) in locked))
        elif (
            isinstance(n, ast.Call)
            and isinstance(n.func, ast.Attribute)
            and n.func.attr in _MUTATORS
        ):
            a = self_attr(n.func.value)
            if a is not None:
                out.append((a, "write", n.lineno, id(n) in locked))
        elif isinstance(n, ast.Delete):
            for t in n.targets:
                if isinstance(t, ast.Subscript):
                    a = self_attr(t.value)
                    if a is not None:
                        out.append((a, "write", n.lineno, id(n) in locked))
        elif isinstance(n, ast.Attribute) and isinstance(n.ctx, ast.Load):
            a = self_attr(n)
            if a is not None:
                out.append((a, "read", n.lineno, id(n) in locked))
    return out


def _intra_class(info: ClassThreads) -> List[Finding]:
    if len(info.all_domains()) < 2:
        return []
    methods = info.module.methods(info.cls)
    flags = _const_flag_attrs(info)
    # attr -> [(kind, domains, method, line)]
    acc: Dict[str, List[Tuple[str, Set[str], str, int]]] = {}
    for mname, fn in methods.items():
        domains = info.domains.get(mname) or set()
        if not domains or mname == "__init__":
            continue
        for attr, kind, line, locked in _attr_accesses(fn):
            if locked or _is_lockish(attr) or attr in info.channel_attrs:
                continue
            if attr in flags:
                continue
            acc.setdefault(attr, []).append((kind, domains, mname, line))
    out: List[Finding] = []
    for attr, uses in sorted(acc.items()):
        writes = [u for u in uses if u[0] == "write"]
        for _k, wdoms, wmeth, wline in writes:
            clash = next(
                (
                    u for u in uses
                    if not (wdoms & u[1])
                ),
                None,
            )
            if clash is None:
                continue
            _ck, cdoms, cmeth, _cline = clash
            out.append(Finding(
                path=info.module.path,
                line=wline,
                code=_CODE,
                message=(
                    f"`self.{attr}` is written in {info.cls.name}."
                    f"{wmeth} under {_fmt(wdoms)} and accessed in "
                    f"{cmeth} under {_fmt(cdoms)} with no lock at "
                    f"either site — cross-thread state needs a lock, a "
                    f"ring/queue crossing, or single-domain ownership"
                ),
                symbol=f"{info.cls.name}.{wmeth}.{attr}",
            ))
            break  # one finding per written attr
    return out


def _fmt(domains: Set[str]) -> str:
    return "{" + ", ".join(sorted(domains)) + "}"


# ----------------------------------------------------------- cross-object


def _name_fallback(session: ProjectSession, name: str) -> Optional[str]:
    """``self.hub`` -> class Hub when the tree defines exactly such a
    class (case-insensitive exact match on the bare name)."""
    for cls_name in session.class_index:
        if cls_name.lower() == name.lower():
            return cls_name
    return None


def _local_types(
    session: ProjectSession, info: ClassThreads, fn: ast.FunctionDef,
) -> Tuple[Dict[str, str], Set[str]]:
    """(local/attr base -> class name, construction-phase bases).

    Bases constructed *in this function* (``shards = [ReactorShard(...)
    ...]``) are construction-phase: the builder owns the object until
    its thread starts, so accesses here are exempt."""
    from ..project import _annotation_class, _ctor_class  # reuse inference

    types: Dict[str, str] = {}
    constructed: Set[str] = set()
    for arg in list(fn.args.args) + list(fn.args.kwonlyargs):
        ann = _annotation_class(arg.annotation)
        if ann and session.class_index.get(ann):
            types[arg.arg] = ann
    for node in ast.walk(fn):
        if isinstance(node, ast.Assign):
            ctor = _ctor_class(node.value)
            src_attr = None
            v = node.value
            while isinstance(v, ast.Subscript):
                v = v.value
            src_attr = self_attr(v)
            for t in node.targets:
                names = []
                if isinstance(t, ast.Name):
                    names = [t.id]
                a = self_attr(t)
                if a is not None:
                    names.append(f"self.{a}")
                for nm in names:
                    if ctor and session.class_index.get(ctor):
                        types[nm] = ctor
                        constructed.add(nm)
                    elif src_attr and src_attr in info.attr_types:
                        types[nm] = info.attr_types[src_attr]
                    elif isinstance(node.value, ast.Name) and \
                            node.value.id in types:
                        types[nm] = types[node.value.id]
        elif isinstance(node, ast.For):
            a = self_attr(node.iter)
            elem = None
            if a is not None and a in info.attr_types:
                elem = info.attr_types[a]
            elif isinstance(node.iter, ast.Name) and node.iter.id in types:
                elem = types[node.iter.id]
            if elem and isinstance(node.target, ast.Name):
                types[node.target.id] = elem
                if node.iter and isinstance(node.iter, ast.Name) and \
                        node.iter.id in constructed:
                    constructed.add(node.target.id)
    for a, t in info.attr_types.items():
        types.setdefault(f"self.{a}", t)
    return types, constructed


def _base_key(node: ast.AST) -> Optional[str]:
    """Lookup key for the base of an attribute access: ``self.hub`` ->
    "self.hub", ``s`` -> "s", ``self.shards[i]`` -> "self.shards"."""
    while isinstance(node, ast.Subscript):
        node = node.value
    a = self_attr(node)
    if a is not None:
        return f"self.{a}"
    if isinstance(node, ast.Name) and node.id != "self":
        return node.id
    return None


def _domain_written_attrs(info: ClassThreads) -> Dict[str, Set[str]]:
    """attr -> domains of methods that write it post-init."""
    methods = info.module.methods(info.cls)
    out: Dict[str, Set[str]] = {}
    for mname, fn in methods.items():
        if mname == "__init__":
            continue
        domains = info.domains.get(mname) or set()
        if not domains:
            continue
        for attr, kind, _line, locked in _attr_accesses(fn):
            if kind == "write" and not locked:
                out.setdefault(attr, set()).update(domains)
    return out


def _cross_object(session: ProjectSession, tm: ThreadModel,
                  info: ClassThreads) -> List[Finding]:
    methods = info.module.methods(info.cls)
    out: List[Finding] = []
    written_cache: Dict[str, Dict[str, Set[str]]] = {}
    for mname, fn in methods.items():
        domains = info.domains.get(mname) or set()
        if not domains or mname == "__init__":
            continue
        types, constructed = _local_types(session, info, fn)
        locked = _locked_ids(fn)
        seen: Set[Tuple[str, str, str]] = set()
        for node in ast.walk(fn):
            target: Optional[ast.Attribute] = None
            kind = ""
            if isinstance(node, ast.Call) and isinstance(node.func,
                                                         ast.Attribute):
                target, kind = node.func, "call"
            elif isinstance(node, (ast.Assign, ast.AugAssign)):
                targets = (node.targets if isinstance(node, ast.Assign)
                           else [node.target])
                for t in targets:
                    if isinstance(t, ast.Attribute) and self_attr(t) is None:
                        target, kind = t, "write"
            elif isinstance(node, ast.Attribute) and isinstance(
                    node.ctx, ast.Load) and self_attr(node) is None:
                target, kind = node, "read"
            if target is None or id(node) in locked:
                continue
            base = _base_key(target.value)
            if base is None:
                continue
            cls2_name = types.get(base)
            if cls2_name is None and base.startswith("self."):
                cls2_name = _name_fallback(session, base[5:])
            elif cls2_name is None and not base.startswith("self."):
                cls2_name = None  # bare locals need explicit inference
            if cls2_name is None or cls2_name == info.cls.name:
                continue
            if base in constructed:
                continue
            info2 = tm.resolve(cls2_name)
            if info2 is None or not info2.all_domains():
                continue
            attr = target.attr
            key = (base, attr, kind)
            if key in seen:
                continue
            seen.add(key)
            if _is_lockish(attr) or attr in info2.channel_attrs:
                continue
            if kind == "call":
                d2 = info2.domains.get(attr) or set()
                if d2 and not (d2 & domains):
                    out.append(Finding(
                        path=info.module.path, line=node.lineno, code=_CODE,
                        message=(
                            f"{info.cls.name}.{mname} ({_fmt(domains)}) "
                            f"calls {cls2_name}.{attr} which runs under "
                            f"{_fmt(d2)} — cross to a foreign thread "
                            f"domain through its ring/queue, not a "
                            f"direct call"
                        ),
                        symbol=f"{info.cls.name}.{mname}.{base}.{attr}",
                    ))
            elif kind == "write":
                out.append(Finding(
                    path=info.module.path, line=node.lineno, code=_CODE,
                    message=(
                        f"{info.cls.name}.{mname} ({_fmt(domains)}) "
                        f"writes {base}.{attr} owned by {cls2_name} "
                        f"({_fmt(info2.all_domains())}) — foreign-domain "
                        f"state must be reached by message, not "
                        f"assignment"
                    ),
                    symbol=f"{info.cls.name}.{mname}.{base}.{attr}",
                ))
            else:  # read
                if cls2_name not in written_cache:
                    written_cache[cls2_name] = _domain_written_attrs(info2)
                wdoms = written_cache[cls2_name].get(attr) or set()
                if wdoms and not (wdoms & domains):
                    out.append(Finding(
                        path=info.module.path, line=node.lineno, code=_CODE,
                        message=(
                            f"{info.cls.name}.{mname} ({_fmt(domains)}) "
                            f"reads {base}.{attr}, which {cls2_name} "
                            f"writes from {_fmt(wdoms)} — an unlocked "
                            f"cross-thread read of mutable state"
                        ),
                        symbol=f"{info.cls.name}.{mname}.{base}.{attr}",
                    ))
    return out


@register_project(_CODE, "thread-ownership")
def check(session: ProjectSession) -> List[Finding]:
    tm = session.threads()
    out: List[Finding] = []
    for _name, info in sorted(tm.classes.items()):
        out.extend(_intra_class(info))
        out.extend(_cross_object(session, tm, info))
    return out
