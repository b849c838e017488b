"""Project-level analysis session for graftlint's whole-program passes.

The per-file rules (GL001–GL011) see one ``FileContext`` at a time; the
whole-program passes (GL012–GL017) need the whole tree at once: the
wire contract lives in ``protocol.py`` but is *exercised* by send sites
in five different processes, thread ownership crosses the
``hub.py``/``hub_shards.py`` module boundary, a lock cycle is only
visible when both acquisition orders are in the graph, the sync helper
that stalls a coroutine lives modules away from the ``async def`` that
calls it, and a selector registered in one method is unregistered in
another.

``ProjectSession`` wraps one shared parse of the tree (every
``FileContext`` comes from ``core.parse_cached``, so nothing here costs
a second ``ast.parse``) and exposes the derived models the passes
consume:

- a **module/class index** with import-alias resolution that understands
  the repo's relative imports (``from . import protocol as P``);
- the **protocol model** (:meth:`ProjectSession.protocol`): message
  constants, every recognized send site (``_send``/``send``/
  ``send_async``/``request``/``_traced_send``/``_reply``, raw
  ``dumps_frame((msg, payload))`` framing, and ``(msg, payload)``
  tuples appended to a send buffer (batch coalescing: the append IS
  the send; for ``send_async`` itself coalescing happens *below* the
  call, so the call site is the send), and
  every dispatch table in its three spellings: dict literals
  (``self._inbound_handlers = {...}``), convention tables
  (``{name[len("_on_"):]: getattr(self, name) for name in
  dir(type(self)) if name.startswith("_on_")}``), and
  ``if/elif msg_type == P.X`` chains; plus module-level routing sets
  (``SCHEDULER_MSGS``/``OBJECT_MSGS`` feeding ``SERVICE_OF``) for the
  sharded topology;
- the **thread model** (:meth:`ProjectSession.threads`): per-class
  ownership domains seeded from entry points (``threading.Thread``
  construction targets, Thread-subclass/reactor ``run``, dispatch-table
  handlers, ``_add_timer`` callbacks, ``_read_loop``) and propagated
  through the intra-class call graph, plus a light attribute-type
  inference (``self.x = Cls(...)``, ``[Cls(...) for ...]``,
  annotations) so a pass can tell that ``s`` in
  ``for s in self._shards:`` is a ``ReactorShard``;
- the **flow model** (:meth:`ProjectSession.flow`): the project call
  graph keyed ``module.Class.method``, with GL003's blocking tables as
  roots (shared recognition — the per-file and whole-program notions
  of "a blocking op" cannot diverge), locks held by thread-domain
  methods around blocking work, trace-contextvar reads, and
  executor/thread closure dispatches (GL015);
- the **resource model** (:meth:`ProjectSession.resources`): per-class
  acquire/release pairing sites — selector names (constructor-typed
  attrs/locals plus aliases), register/unregister/close sites, timer
  heaps and their teardown clears, and handle registries with their
  drop paths (GL016).

Everything is lazy and cached per session; a session is cheap to build
(no parsing — the trees come from the core parse cache) and throwaway
by design.
"""

from __future__ import annotations

import ast
import os
import re
from dataclasses import dataclass, field
from typing import Dict, FrozenSet, List, Optional, Sequence, Set, Tuple

from .core import FileContext, dotted_name, qualname_map, self_attr

__all__ = [
    "ProjectSession",
    "ModuleInfo",
    "SendSite",
    "Handler",
    "DispatchTable",
    "RoutingSet",
    "ProtocolModel",
    "ClassThreads",
    "ThreadModel",
    "FlowFunction",
    "FlowModel",
    "ResourceClass",
    "ResourceModel",
    "session_for",
]

# method names that put a (msg_type, payload) message on a wire/queue.
# _reply is special-cased below (implicit REPLY + keyword payload).
SEND_APIS = frozenset({"send", "send_async", "request", "_send",
                       "_traced_send"})

# wire-framing / in-process sentinels, never part of the message model
FRAMING_TYPES = frozenset({"batch"})

# variable names that identify an if/elif chain as message dispatch
# (``if kind == P.VAL_SHM`` style value comparisons must NOT register
# as handler tables, so the chain form is gated on the variable name)
MSG_VAR_NAMES = frozenset({"msg_type", "mt", "msg", "message_type"})

_REACTOR_CLASS = re.compile(r"(Shard|Reactor)")


def _is_internal(msg: str) -> bool:
    return msg.startswith("__") and msg.endswith("__")


# --------------------------------------------------------------------- module


@dataclass
class ModuleInfo:
    ctx: FileContext
    basename: str                       # "hub" for .../hub.py
    classes: Dict[str, ast.ClassDef] = field(default_factory=dict)
    functions: Dict[str, ast.FunctionDef] = field(default_factory=dict)
    qualnames: Dict[int, str] = field(default_factory=dict)
    # local alias -> session-module basename ("P" -> "protocol")
    module_aliases: Dict[str, str] = field(default_factory=dict)

    @property
    def path(self) -> str:
        return self.ctx.path

    def methods(self, cls: ast.ClassDef) -> Dict[str, ast.FunctionDef]:
        return {
            item.name: item
            for item in cls.body
            if isinstance(item, (ast.FunctionDef, ast.AsyncFunctionDef))
        }


# ------------------------------------------------------------- protocol model


@dataclass
class SendSite:
    module: ModuleInfo
    line: int
    msg: str                            # resolved message-type value
    symbol: str                         # enclosing qualname for fingerprints
    # payload keys when the payload is a fully-tracked literal dict
    # (literal at the call, or a local assigned a literal and augmented
    # only by `var["k"] = ...` before the send); None = opaque
    keys: Optional[FrozenSet[str]]
    via: str                            # the send API spelling used
    raw_string: bool                    # msg given as a bare string literal
    # vector payloads (bulk frames like SUBMIT_TASKS): payload key ->
    # keys of the homogeneous dict items under it, when the value is a
    # tracked list-of-dict-literals ([{...}, ...] or [{...} for ...]).
    # Only keys EVERY item carries are recorded, so handler-side
    # per-item required reads can be checked against them.
    item_keys: Dict[str, FrozenSet[str]] = field(default_factory=dict)


@dataclass
class Handler:
    module: ModuleInfo
    line: int
    msg: str
    symbol: str
    required_keys: FrozenSet[str]       # plain-subscript reads, unconditional
    read_keys: FrozenSet[str]           # every key read in any way
    opaque: bool                        # payload escapes / is iterated: the
                                        # read set is a lower bound only
    raw_string: bool
    # vector payloads: payload key -> item keys the handler reads on
    # EVERY element of ``for t in payload[k]:`` loops (plain subscript,
    # unconditional within the loop body). item_read is every item key
    # read in any way (.get included).
    item_required: Dict[str, FrozenSet[str]] = field(default_factory=dict)
    item_read: Dict[str, FrozenSet[str]] = field(default_factory=dict)


@dataclass
class DispatchTable:
    module: ModuleInfo
    line: int
    kind: str                           # "dict" | "prefix" | "elif"
    owner: str                          # class or function qualname
    msgs: FrozenSet[str]


@dataclass
class RoutingSet:
    module: ModuleInfo
    line: int
    name: str
    msgs: FrozenSet[str]
    sharded: bool                       # lives in a reactor-shard module


@dataclass
class ProtocolModel:
    constants: Dict[str, str]           # NAME -> value (protocol module)
    constant_values: Set[str]
    protocol_module: Optional[ModuleInfo]
    sends: List[SendSite]
    handlers: List[Handler]
    tables: List[DispatchTable]
    routing_sets: List[RoutingSet]
    # message values consumed by ad-hoc comparison (``mt != "obj_data"``)
    # — the request/response object plane reads replies inline rather
    # than through a dispatch table, and a comparison is evidence the
    # type is expected by a receiver
    compared: Set[str] = field(default_factory=set)

    def sends_of(self, msg: str) -> List[SendSite]:
        return [s for s in self.sends if s.msg == msg]

    def handlers_of(self, msg: str) -> List[Handler]:
        return [h for h in self.handlers if h.msg == msg]


# --------------------------------------------------------------- thread model


@dataclass
class ClassThreads:
    module: ModuleInfo
    cls: ast.ClassDef
    qual: str                           # "hub_shards.ReactorShard"
    # method name -> set of domain labels it may run under
    domains: Dict[str, Set[str]] = field(default_factory=dict)
    # attr name -> constructed/annotated class name, when inferable
    attr_types: Dict[str, str] = field(default_factory=dict)
    # attrs holding recognized cross-thread channels (rings, queues,
    # events, locks): mutating them IS the sanctioned crossing
    channel_attrs: Set[str] = field(default_factory=set)

    def all_domains(self) -> Set[str]:
        out: Set[str] = set()
        for d in self.domains.values():
            out |= d
        return out


@dataclass
class ThreadModel:
    # keyed by qualified name ("hub_shards.ReactorShard") so two
    # same-named classes in different modules are BOTH analyzed
    classes: Dict[str, ClassThreads]
    # bare name -> every definition, for type-inference lookups
    by_name: Dict[str, List[ClassThreads]] = field(default_factory=dict)

    def resolve(self, cls_name: str) -> Optional["ClassThreads"]:
        """First definition carrying that bare name (the same
        first-hit rule as ``ProjectSession.resolve_class``, which the
        type inference producing these names uses)."""
        hits = self.by_name.get(cls_name)
        return hits[0] if hits else None

    def domains_of(self, cls_name: str, method: str) -> Set[str]:
        info = self.resolve(cls_name)
        if info is None:
            return set()
        return info.domains.get(method, set())


# ----------------------------------------------------------------- flow model


@dataclass
class FlowFunction:
    """One function in the project call/blocking graph (GL015)."""

    module: ModuleInfo
    node: ast.AST                       # FunctionDef / AsyncFunctionDef
    key: str                            # "hub.Hub._run" / "client.connect"
    qual: str                           # module-local qualname
    is_async: bool
    cls_name: Optional[str] = None
    # direct known-blocking ops in this function's own body:
    # (line, human description)
    blocking: List[Tuple[int, str]] = field(default_factory=list)
    # resolved direct calls: (line, callee key, under-an-await,
    # bare-statement)
    calls: List[Tuple[int, str, bool, bool]] = field(default_factory=list)
    # lockish self-attrs acquired via ``with self.X:``
    # ("module.Class.X")
    locks: Set[str] = field(default_factory=set)
    # the function reads the ambient trace contextvar (directly or via
    # begin_trace, which samples against the current context)
    reads_trace_ctx: bool = False
    # run_in_executor/Thread(target=) dispatches of a local closure
    # that does NOT re-push the trace context and is not under an
    # ``if <name> is None:`` no-trace guard: (line, closure name)
    ctx_unsafe_dispatches: List[Tuple[int, str]] = field(
        default_factory=list)


@dataclass
class FlowModel:
    """Project-wide call graph + blocking roots (GL015).

    ``functions`` is keyed ``module.Class.method`` / ``module.fn``.
    ``slow_thread_locks`` maps a lock id ("module.Class.attr") to a
    description of the thread-domain holder that performs a blocking op
    while holding it — waiting on such a lock from the event loop can
    stall for the holder's full blocking window, so acquiring one
    counts as a blocking root for the transitive analysis.
    """

    functions: Dict[str, FlowFunction]
    slow_thread_locks: Dict[str, str] = field(default_factory=dict)

    def blocking_chain(self, key: str) -> Optional[List[str]]:
        """["module.fn", ..., "<op description>"] for the first found
        path from ``key`` into a blocking root; None when ``key``
        cannot block. Memoized; cycles are cut (a cycle with no
        blocking op on it never blocks)."""
        memo: Dict[str, Optional[List[str]]] = self.__dict__.setdefault(
            "_chain_memo", {})

        def walk(k: str, visiting: Set[str]) -> Optional[List[str]]:
            if k in memo:
                return memo[k]
            fn = self.functions.get(k)
            if fn is None or k in visiting:
                return None
            visiting.add(k)
            result: Optional[List[str]] = None
            if fn.blocking:
                result = [k, fn.blocking[0][1]]
            else:
                for lock in sorted(fn.locks):
                    holder = self.slow_thread_locks.get(lock)
                    if holder is not None:
                        result = [k, f"`with {lock}:` — {holder}"]
                        break
            if result is None:
                for _line, callee, awaited, _stmt in fn.calls:
                    if awaited:
                        continue
                    sub_fn = self.functions.get(callee)
                    if sub_fn is None or sub_fn.is_async:
                        continue
                    sub = walk(callee, visiting)
                    if sub is not None:
                        result = [k] + sub
                        break
            visiting.discard(k)
            memo[k] = result
            return result

        return walk(key, set())


# ------------------------------------------------------------- resource model


# constructor/factory trailing names that hand back an owned OS-level
# handle (or a record that must reach an emitter). The value is the
# human-readable resource kind.
ACQUIRE_CTORS = {
    "mmap": "mmap segment",
    "MappedSegment": "mmap segment",
    "from_fd": "mmap segment",
    "DefaultSelector": "selector",
    "socket": "socket",
    "create_connection": "socket",
    "make_runtime_record": "span record",
}

# method names that release an owned handle
RELEASE_METHODS = frozenset({"close", "unmap", "shutdown", "release",
                             "cancel", "detach", "terminate"})


@dataclass
class ResourceClass:
    """Per-class resource-lifecycle sites (GL016)."""

    module: ModuleInfo
    cls_name: str
    qual: str                           # "hub.Hub"
    # attrs/locals typed as selectors (assigned from DefaultSelector(),
    # or aliased from such an attr)
    selector_names: Set[str] = field(default_factory=set)
    register_sites: List[int] = field(default_factory=list)
    unregister_sites: List[int] = field(default_factory=list)
    selector_close_sites: List[int] = field(default_factory=list)
    # one-shot timer heaps: attr -> heappush lines
    timer_attrs: Dict[str, List[int]] = field(default_factory=dict)
    # attr -> clear/teardown-reassign lines
    timer_clears: Dict[str, List[int]] = field(default_factory=dict)
    # handle registries: attr -> store lines (``self.X[k] = handle``
    # where the handle was acquired locally — ownership transfer)
    registry_attrs: Dict[str, List[int]] = field(default_factory=dict)
    # attr -> removal lines (pop / del / clear)
    registry_drops: Dict[str, List[int]] = field(default_factory=dict)


@dataclass
class ResourceModel:
    classes: Dict[str, ResourceClass]   # keyed by qual

    def resolve(self, cls_name: str) -> Optional["ResourceClass"]:
        for info in self.classes.values():
            if info.cls_name == cls_name:
                return info
        return None


# recognized channel constructors: pushing/popping one of these crosses
# threads by design, so the attribute itself is exempt from ownership
# conflicts (the GL013 "ring/queue crossing")
CHANNEL_CTORS = frozenset({
    "deque", "Queue", "SimpleQueue", "LifoQueue", "PriorityQueue",
    "Event", "Condition", "Semaphore", "BoundedSemaphore", "Barrier",
    "Lock", "RLock", "ShardRing",
})
_CHANNEL_NAME_HINTS = ("ring", "queue", "lock", "cond", "evt", "event",
                       "sem", "mutex", "_buf")

# name hints identifying a lock-like object. ONE definition shared by
# GL013 (exempts lock-ish attrs from ownership conflicts) and GL014
# (identifies acquisitions) — the two rules' notions of "a lock" must
# never diverge, or an attr one pass exempts stops being modelled by
# the other.
LOCK_NAME_HINTS = ("lock", "mutex", "cond", "cv")


def is_lockish(name: str) -> bool:
    low = name.lower()
    return any(h in low for h in LOCK_NAME_HINTS)


def _channel_name(attr: str) -> bool:
    low = attr.lower()
    return any(h in low for h in _CHANNEL_NAME_HINTS)


# ------------------------------------------------------------------- helpers


def _call_name(node: ast.AST) -> Optional[str]:
    """Trailing name of the called thing: ``threading.Thread`` ->
    "Thread", ``ShardRing(...)`` -> "ShardRing"."""
    if not isinstance(node, ast.Call):
        return None
    f = node.func
    if isinstance(f, ast.Attribute):
        return f.attr
    if isinstance(f, ast.Name):
        return f.id
    return None


def _const_str(node: ast.AST) -> Optional[str]:
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value
    return None


def _functions_in(tree: ast.Module):
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            yield node


class _FnIndex:
    """Per-module map node-id -> enclosing (class name, function name)."""

    def __init__(self, mod: ModuleInfo):
        self.owner: Dict[int, Tuple[Optional[str], Optional[str]]] = {}

        def visit(node, cls, fn):
            for child in ast.iter_child_nodes(node):
                c, f = cls, fn
                if isinstance(child, ast.ClassDef):
                    c, f = child.name, None
                elif isinstance(child, (ast.FunctionDef,
                                        ast.AsyncFunctionDef)):
                    f = child.name
                self.owner[id(child)] = (c, f)
                visit(child, c, f)

        visit(mod.ctx.tree, None, None)


# -------------------------------------------------------------------- session


class ProjectSession:
    """One shared view of a set of parsed files (see module docstring)."""

    def __init__(self, contexts: Sequence[FileContext]):
        self.modules: List[ModuleInfo] = []
        self.by_basename: Dict[str, List[ModuleInfo]] = {}
        self.class_index: Dict[str, List[Tuple[ModuleInfo, ast.ClassDef]]] = {}
        for ctx in contexts:
            base = os.path.splitext(os.path.basename(ctx.path))[0]
            mod = ModuleInfo(ctx=ctx, basename=base)
            mod.qualnames = qualname_map(ctx.tree)
            for node in ctx.tree.body:
                if isinstance(node, ast.ClassDef):
                    mod.classes[node.name] = node
                elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    mod.functions[node.name] = node
            self.modules.append(mod)
            self.by_basename.setdefault(base, []).append(mod)
        for mod in self.modules:
            mod.module_aliases = self._module_aliases(mod)
            for name, cls in mod.classes.items():
                self.class_index.setdefault(name, []).append((mod, cls))
        self._protocol: Optional[ProtocolModel] = None
        self._threads: Optional[ThreadModel] = None
        self._flow: Optional[FlowModel] = None
        self._resources: Optional[ResourceModel] = None

    # ------------------------------------------------------------ module refs
    def _module_aliases(self, mod: ModuleInfo) -> Dict[str, str]:
        """Aliases bound to *session* modules, through absolute AND
        relative imports: ``from . import protocol as P`` -> {"P":
        "protocol"} when a ``protocol`` module is in the session."""
        out: Dict[str, str] = {}
        for node in ast.walk(mod.ctx.tree):
            if isinstance(node, ast.Import):
                for a in node.names:
                    tail = a.name.split(".")[-1]
                    if tail in self.by_basename:
                        out[a.asname or tail] = tail
            elif isinstance(node, ast.ImportFrom):
                for a in node.names:
                    if a.name == "*":
                        continue
                    if a.name in self.by_basename:
                        out[a.asname or a.name] = a.name
        return out

    def resolve_class(
        self, name: Optional[str]
    ) -> Optional[Tuple[ModuleInfo, ast.ClassDef]]:
        if not name:
            return None
        hits = self.class_index.get(name)
        return hits[0] if hits else None

    # --------------------------------------------------------- derived models
    def protocol(self) -> ProtocolModel:
        if self._protocol is None:
            self._protocol = _build_protocol_model(self)
        return self._protocol

    def threads(self) -> ThreadModel:
        if self._threads is None:
            self._threads = _build_thread_model(self)
        return self._threads

    def flow(self) -> FlowModel:
        if self._flow is None:
            self._flow = _build_flow_model(self)
        return self._flow

    def resources(self) -> ResourceModel:
        if self._resources is None:
            self._resources = _build_resource_model(self)
        return self._resources

    # ------------------------------------------------------------ msg resolve
    def resolve_msg(self, mod: ModuleInfo, node: ast.AST,
                    constants: Dict[str, str]) -> Tuple[Optional[str], bool]:
        """(message value, was_raw_string) for a msg-type expression:
        a string literal, ``P.NAME`` where P aliases the protocol
        module, or a bare NAME from ``from .protocol import NAME``."""
        s = _const_str(node)
        if s is not None:
            return s, True
        if isinstance(node, ast.Attribute) and isinstance(node.value, ast.Name):
            alias = mod.module_aliases.get(node.value.id)
            if alias is not None and node.attr in constants:
                return constants[node.attr], False
            return None, False
        if isinstance(node, ast.Name):
            origin = mod.ctx.import_aliases.get(node.id, "")
            if origin.split(".")[-1] == node.id and node.id in constants:
                return constants[node.id], False
        return None, False


def session_for(paths: Sequence[str],
                overrides: Optional[Dict[str, str]] = None) -> ProjectSession:
    """Build a session over files/directories, with optional source
    overrides (used by revert tests to lint a modified copy of one real
    file against the rest of the live tree)."""
    from .core import iter_python_files, parse_cached

    overrides = overrides or {}
    contexts = []
    for p in iter_python_files(paths):
        try:
            if p in overrides:
                contexts.append(FileContext.parse(p, overrides[p]))
            else:
                contexts.append(parse_cached(p))
        except (SyntaxError, UnicodeDecodeError):
            continue
    return ProjectSession(contexts)


# ===================================================== protocol model builder


def _protocol_constants(mod: ModuleInfo) -> Dict[str, str]:
    out: Dict[str, str] = {}
    for node in mod.ctx.tree.body:
        if (
            isinstance(node, ast.Assign)
            and len(node.targets) == 1
            and isinstance(node.targets[0], ast.Name)
            and node.targets[0].id.isupper()
        ):
            v = _const_str(node.value)
            if v is not None:
                out[node.targets[0].id] = v
    return out


def _literal_dict_keys(node: ast.AST) -> Optional[Set[str]]:
    """Keys of a dict literal; None when any key is non-constant or a
    ``**`` spread is present (opaque)."""
    if not isinstance(node, ast.Dict):
        return None
    keys: Set[str] = set()
    for k in node.keys:
        if k is None:                    # ** spread
            return None
        s = _const_str(k)
        if s is None:
            return None
        keys.add(s)
    return keys


def _item_literal_keys(node: ast.AST) -> Optional[FrozenSet[str]]:
    """Item keys when ``node`` builds a list of dict literals — a
    ``[{...}, ...]`` literal or a ``[{...} for ...]`` comprehension.
    Only keys every element carries count (intersection), so a handler
    relying on one is guaranteed it on each item. None = not a tracked
    vector value."""
    if isinstance(node, ast.List) and node.elts:
        elts = node.elts
    elif isinstance(node, ast.ListComp):
        elts = [node.elt]
    else:
        return None
    keys: Optional[Set[str]] = None
    for e in elts:
        k = _literal_dict_keys(e)
        if k is None:
            return None
        keys = set(k) if keys is None else keys & k
    return frozenset(keys) if keys else None


def _tracked_item_keys(fn: ast.AST, call: ast.Call,
                       payload_node: ast.AST) -> Dict[str, FrozenSet[str]]:
    """Vector values inside a send payload: payload key -> item keys,
    for every payload entry whose value is a tracked list-of-dicts.
    Covers the same payload shapes _tracked_payload_keys follows — a
    dict literal at the call, or a local dict augmented by
    ``var["k"] = [...]`` before the send."""
    out: Dict[str, FrozenSet[str]] = {}

    def harvest_dict(d: ast.AST) -> None:
        if not isinstance(d, ast.Dict):
            return
        for k, v in zip(d.keys, d.values):
            s = k is not None and _const_str(k)
            if not s:
                continue
            iks = _item_literal_keys(v)
            if iks is not None:
                out[s] = iks

    harvest_dict(payload_node)
    if not isinstance(payload_node, ast.Name):
        return out
    name = payload_node.id
    for node in ast.walk(fn):
        line = getattr(node, "lineno", None)
        if line is None or line > call.lineno:
            continue
        if not isinstance(node, ast.Assign):
            continue
        for t in node.targets:
            if isinstance(t, ast.Name) and t.id == name:
                harvest_dict(node.value)
            elif (
                isinstance(t, ast.Subscript)
                and isinstance(t.value, ast.Name)
                and t.value.id == name
            ):
                s = _const_str(t.slice)
                if s:
                    iks = _item_literal_keys(node.value)
                    if iks is not None:
                        out[s] = iks
    return out


def _tracked_payload_keys(fn: ast.AST, call: ast.Call,
                          payload_node: ast.AST,
                          depth: int = 0) -> Optional[Set[str]]:
    """Payload keys for a send site (see :class:`SendSite.keys`)."""
    if depth > 2:
        return None
    direct = _literal_dict_keys(payload_node)
    if direct is not None:
        return direct
    if (isinstance(payload_node, ast.Call)
            and _call_name(payload_node) == "dict"):
        base: Set[str] = set()
        if payload_node.args:
            if len(payload_node.args) != 1:
                return None
            inner = _literal_dict_keys(payload_node.args[0])
            if inner is None:
                inner = _tracked_payload_keys(
                    fn, call, payload_node.args[0], depth + 1)
            if inner is None:
                return None
            base = set(inner)
        for k in payload_node.keywords:
            if k.arg is None:
                return None
            base.add(k.arg)
        return base
    if not isinstance(payload_node, ast.Name):
        return None
    name = payload_node.id
    keys: Optional[Set[str]] = None
    opaque = False
    for node in ast.walk(fn):
        line = getattr(node, "lineno", None)
        if line is None or line > call.lineno:
            continue
        if isinstance(node, ast.Assign):
            for t in node.targets:
                if isinstance(t, ast.Name) and t.id == name:
                    k = _literal_dict_keys(node.value)
                    if k is None and (
                        isinstance(node.value, ast.Call)
                        and _call_name(node.value) == "dict"
                    ):
                        k = _tracked_payload_keys(
                            fn, call, node.value, depth + 1)
                    keys, opaque = k, k is None
                elif (
                    isinstance(t, ast.Subscript)
                    and isinstance(t.value, ast.Name)
                    and t.value.id == name
                ):
                    s = _const_str(t.slice)
                    if s is None:
                        opaque = True
                    elif keys is not None:
                        keys.add(s)
        elif isinstance(node, ast.Call) and node is not call:
            # name.update(...) mutates it opaquely; passing the name to
            # any other call may too (the callee can add/remove keys)
            if (
                isinstance(node.func, ast.Attribute)
                and isinstance(node.func.value, ast.Name)
                and node.func.value.id == name
            ):
                if node.func.attr not in ("get", "pop", "keys", "items",
                                          "values", "copy"):
                    opaque = True
            else:
                for a in node.args:
                    if isinstance(a, ast.Name) and a.id == name:
                        opaque = True
                for kw in node.keywords:
                    if isinstance(kw.value, ast.Name) and kw.value.id == name:
                        opaque = True
    if opaque or keys is None:
        return None
    return keys


def _find_sends(session: ProjectSession, mod: ModuleInfo,
                constants: Dict[str, str]) -> List[SendSite]:
    out: List[SendSite] = []
    for fn in _functions_in(mod.ctx.tree):
        qual = mod.qualnames.get(id(fn), fn.name)
        for node in ast.walk(fn):
            if not isinstance(node, ast.Call):
                continue
            api = _call_name(node)
            if api == "_reply":
                keys: Optional[Set[str]] = {"req_id"}
                for k in node.keywords:
                    if k.arg is None:
                        keys = None
                        break
                    keys.add(k.arg)
                out.append(SendSite(
                    module=mod, line=node.lineno, msg="reply", symbol=qual,
                    keys=frozenset(keys) if keys is not None else None,
                    via="_reply", raw_string=False,
                ))
                continue
            msg = raw = payload_node = None
            msgs: List[Tuple[str, bool]] = []
            if api in SEND_APIS:
                for i, a in enumerate(node.args[:2]):
                    m, r = session.resolve_msg(mod, a, constants)
                    if m is None and isinstance(a, ast.Name):
                        # a local like `msg = P.EXEC_ACTOR_CREATE if
                        # spec.is_actor_create else P.EXEC_TASK`: every
                        # resolvable value assigned to it counts as sent
                        vals = _local_msg_values(
                            session, mod, fn, node, a.id, constants)
                        if vals:
                            msgs = vals
                            if len(node.args) > i + 1:
                                payload_node = node.args[i + 1]
                            break
                    if m is not None:
                        msg, raw = m, r
                        if len(node.args) > i + 1:
                            payload_node = node.args[i + 1]
                        break
            elif api == "dumps_frame" and len(node.args) == 1:
                tup = node.args[0]
                if isinstance(tup, ast.Tuple) and len(tup.elts) == 2:
                    m, r = session.resolve_msg(mod, tup.elts[0], constants)
                    if m is not None:
                        msg, raw = m, r
                        payload_node = tup.elts[1]
            elif api == "append" and len(node.args) == 1:
                # batch coalescing: a (msg_type, payload) tuple pushed
                # onto a send buffer goes out inside the next "batch"
                # frame — that append IS the send site (client.flush()'s
                # release_owned ride-along). Gated on the buffer's name
                # so data-shaped tuple appends elsewhere don't register.
                tup = node.args[0]
                f = node.func
                base = f.value if isinstance(f, ast.Attribute) else None
                base_name = self_attr(base) or (
                    base.id if isinstance(base, ast.Name) else None)
                if (
                    isinstance(tup, ast.Tuple)
                    and len(tup.elts) == 2
                    and base_name is not None
                    and any(h in base_name.lower()
                            for h in ("send", "outbox", "out_buf"))
                ):
                    m, r = session.resolve_msg(mod, tup.elts[0], constants)
                    if m is not None:
                        msg, raw = m, r
                        payload_node = tup.elts[1]
            if msg is not None:
                msgs = [(msg, raw)]
            keys = None
            item_keys: Dict[str, FrozenSet[str]] = {}
            if msgs and payload_node is not None:
                keys = _tracked_payload_keys(fn, node, payload_node)
                item_keys = _tracked_item_keys(fn, node, payload_node)
                if keys is not None and api == "request":
                    # CoreClient.request() stamps the req_id itself
                    # (payload = dict(payload, req_id=req_id))
                    keys = set(keys) | {"req_id"}
            for m, r in msgs:
                if m in FRAMING_TYPES or _is_internal(m):
                    continue
                out.append(SendSite(
                    module=mod, line=node.lineno, msg=m, symbol=qual,
                    keys=frozenset(keys) if keys is not None else None,
                    via=api, raw_string=r, item_keys=item_keys,
                ))
    return out


def _local_msg_values(session: ProjectSession, mod: ModuleInfo,
                      fn: ast.AST, call: ast.Call, name: str,
                      constants: Dict[str, str]) -> List[Tuple[str, bool]]:
    out: List[Tuple[str, bool]] = []
    for node in ast.walk(fn):
        if not isinstance(node, ast.Assign):
            continue
        if getattr(node, "lineno", 0) > call.lineno:
            continue
        if not any(isinstance(t, ast.Name) and t.id == name
                   for t in node.targets):
            continue
        candidates = [node.value]
        if isinstance(node.value, ast.IfExp):
            candidates = [node.value.body, node.value.orelse]
        for c in candidates:
            m, r = session.resolve_msg(mod, c, constants)
            if m is not None and (m, r) not in out:
                out.append((m, r))
    return out


# ------------------------------------------------------------ handler bodies

_CONDITIONAL_BODIES = (
    ("body", ast.If), ("orelse", ast.If),
    ("body", ast.IfExp), ("orelse", ast.IfExp),
    ("body", ast.While), ("orelse", ast.While),
    ("body", ast.For), ("orelse", ast.For),
)


def _conditional_ids(scope_nodes: Sequence[ast.AST]) -> Set[int]:
    """ids of nodes that may not execute on every entry into the scope:
    anything inside an if/else arm, loop body, try block/handler, the
    right side of a short-circuit, or a comprehension."""
    out: Set[int] = set()

    def mark(n: ast.AST) -> None:
        for sub in ast.walk(n):
            out.add(id(sub))

    for top in scope_nodes:
        for n in ast.walk(top):
            if isinstance(n, (ast.If, ast.While, ast.For)):
                for s in list(n.body) + list(n.orelse):
                    mark(s)
            elif isinstance(n, ast.IfExp):
                mark(n.body)
                mark(n.orelse)
            elif isinstance(n, ast.Try):
                for s in (list(n.body) + list(n.orelse)
                          + list(n.finalbody)):
                    mark(s)
                for h in n.handlers:
                    mark(h)
            elif isinstance(n, ast.BoolOp):
                for v in n.values[1:]:
                    mark(v)
            elif isinstance(n, (ast.ListComp, ast.SetComp, ast.DictComp,
                                ast.GeneratorExp)):
                mark(n)
    return out


class _PayloadReads:
    def __init__(self) -> None:
        self.required: Set[str] = set()
        self.read: Set[str] = set()
        self.opaque = False
        # vector payloads: payload key -> reads of the loop variable of
        # a ``for t in payload[k]:`` loop (t["x"] per-item subscripts)
        self.item: Dict[str, "_PayloadReads"] = {}


def _collect_payload_reads(
    mod: ModuleInfo,
    methods: Dict[str, ast.FunctionDef],
    scope_nodes: Sequence[ast.AST],
    payload_name: str,
    acc: _PayloadReads,
    visited: Set[str],
    depth: int = 0,
) -> None:
    """Key reads of ``payload_name`` within ``scope_nodes``, following
    ``self.m(payload)`` calls into same-class methods (the repo's
    handler-helper idiom) up to a small depth."""
    cond = _conditional_ids(scope_nodes)
    for top in scope_nodes:
        for node in ast.walk(top):
            if (
                isinstance(node, ast.Subscript)
                and isinstance(node.value, ast.Name)
                and node.value.id == payload_name
            ):
                key = _const_str(node.slice)
                if key is None:
                    continue
                if isinstance(node.ctx, ast.Load):
                    acc.read.add(key)
                    if id(node) not in cond:
                        acc.required.add(key)
            elif isinstance(node, ast.Call):
                f = node.func
                if (
                    isinstance(f, ast.Attribute)
                    and isinstance(f.value, ast.Name)
                    and f.value.id == payload_name
                ):
                    if f.attr in ("get", "setdefault"):
                        k = node.args and _const_str(node.args[0])
                        if k:
                            acc.read.add(k)
                    elif f.attr == "pop":
                        k = node.args and _const_str(node.args[0])
                        if k:
                            acc.read.add(k)
                            if len(node.args) == 1 and id(node) not in cond:
                                acc.required.add(k)
                    elif f.attr in ("items", "keys", "values", "copy"):
                        acc.opaque = True
                    else:
                        acc.opaque = True
                    continue
                # payload passed onward: into a same-class helper we can
                # follow; anywhere else it escapes our view
                arg_idx = None
                for i, a in enumerate(node.args):
                    if isinstance(a, ast.Name) and a.id == payload_name:
                        arg_idx = i
                        break
                passes_kw = any(
                    isinstance(kw.value, ast.Name)
                    and kw.value.id == payload_name
                    for kw in node.keywords
                )
                if arg_idx is None and not passes_kw:
                    continue
                callee = None
                if (
                    isinstance(f, ast.Attribute)
                    and isinstance(f.value, ast.Name)
                    and f.value.id == "self"
                ):
                    callee = methods.get(f.attr)
                if (callee is None or passes_kw or depth >= 3
                        or callee.name in visited):
                    acc.opaque = True
                    continue
                params = [a.arg for a in callee.args.args]
                pidx = arg_idx + 1  # skip self
                if pidx >= len(params):
                    acc.opaque = True
                    continue
                visited.add(callee.name)
                sub = _PayloadReads()
                _collect_payload_reads(
                    mod, methods, list(callee.body), params[pidx], sub,
                    visited, depth + 1,
                )
                acc.read |= sub.read
                acc.opaque = acc.opaque or sub.opaque
                if id(node) not in cond:
                    acc.required |= sub.required
                for pk, sv in sub.item.items():
                    dst = acc.item.setdefault(pk, _PayloadReads())
                    dst.read |= sv.read
                    dst.opaque = dst.opaque or sv.opaque
                    if id(node) not in cond:
                        dst.required |= sv.required
            elif (
                isinstance(node, ast.Compare)
                and len(node.ops) == 1
                and isinstance(node.ops[0], (ast.In, ast.NotIn))
                and isinstance(node.comparators[0], ast.Name)
                and node.comparators[0].id == payload_name
            ):
                k = _const_str(node.left)
                if k:
                    acc.read.add(k)
            elif isinstance(node, (ast.Assign, ast.Return, ast.For)):
                # ``for t in payload["k"]:`` — a vector read: collect
                # the loop variable's per-item subscripts so bulk-frame
                # senders can be checked against them (the subscript on
                # payload itself already registered "k" as a read above)
                if (
                    isinstance(node, ast.For)
                    and isinstance(node.iter, ast.Subscript)
                    and isinstance(node.iter.value, ast.Name)
                    and node.iter.value.id == payload_name
                    and isinstance(node.target, ast.Name)
                ):
                    pk = _const_str(node.iter.slice)
                    if pk:
                        sub = acc.item.setdefault(pk, _PayloadReads())
                        got = _PayloadReads()
                        _collect_payload_reads(
                            mod, methods, list(node.body), node.target.id,
                            got, visited, depth + 1,
                        )
                        sub.read |= got.read
                        sub.opaque = sub.opaque or got.opaque
                        if id(node) not in cond:
                            sub.required |= got.required
                        continue
                # payload stored, returned, or iterated: escapes
                vals = []
                if isinstance(node, ast.Assign):
                    vals = [node.value]
                elif isinstance(node, ast.Return) and node.value is not None:
                    vals = [node.value]
                elif isinstance(node, ast.For):
                    vals = [node.iter]
                for v in vals:
                    if isinstance(v, ast.Name) and v.id == payload_name:
                        acc.opaque = True
                    elif (
                        isinstance(v, (ast.Tuple, ast.List))
                        and any(
                            isinstance(e, ast.Name) and e.id == payload_name
                            for e in v.elts
                        )
                    ):
                        acc.opaque = True


def _handler_from_method(mod: ModuleInfo, cls: ast.ClassDef,
                         fn: ast.FunctionDef, msg: str,
                         raw: bool) -> Handler:
    methods = mod.methods(cls)
    params = [a.arg for a in fn.args.args]
    payload_name = params[-1] if len(params) > 1 else None
    acc = _PayloadReads()
    if payload_name:
        _collect_payload_reads(
            mod, methods, list(fn.body), payload_name, acc, {fn.name})
    return Handler(
        module=mod, line=fn.lineno, msg=msg,
        symbol=f"{cls.name}.{fn.name}",
        required_keys=frozenset(acc.required),
        read_keys=frozenset(acc.read),
        opaque=acc.opaque or payload_name is None,
        raw_string=raw,
        item_required={k: frozenset(v.required)
                       for k, v in acc.item.items() if v.required},
        item_read={k: frozenset(v.read)
                   for k, v in acc.item.items() if v.read},
    )


def _prefix_table(cls: ast.ClassDef, v: ast.AST) -> Optional[str]:
    """The ``_on_`` prefix when ``v`` is the convention table
    ``{name[len(prefix):]: getattr(self, name) for name in dir(...)
    if name.startswith(prefix)}``; else None."""
    if not isinstance(v, ast.DictComp):
        return None
    if _call_name(v.value) != "getattr":
        return None
    for gen in v.generators:
        for test in gen.ifs:
            if (
                isinstance(test, ast.Call)
                and isinstance(test.func, ast.Attribute)
                and test.func.attr == "startswith"
                and test.args
            ):
                prefix = _const_str(test.args[0])
                if prefix:
                    return prefix
    return None


def _extract_chain_compare(test: ast.AST):
    """(var_name, [msg exprs]) for ``var == X`` / ``var in (X, Y)``
    tests, looking through a leading ``and``."""
    if isinstance(test, ast.BoolOp) and isinstance(test.op, ast.And):
        test = test.values[0]
    if not (isinstance(test, ast.Compare) and len(test.ops) == 1):
        return None
    left, op, comp = test.left, test.ops[0], test.comparators[0]
    if not isinstance(left, ast.Name):
        return None
    if isinstance(op, ast.Eq):
        return left.id, [comp]
    if isinstance(op, ast.In) and isinstance(comp, (ast.Tuple, ast.List,
                                                    ast.Set)):
        return left.id, list(comp.elts)
    return None


def _payload_partner(fn: ast.FunctionDef, msg_var: str) -> Optional[str]:
    """The payload variable travelling with ``msg_var``: the second
    target of a ``msg_var, payload = ...`` unpack, else the last
    parameter that isn't self/conn/the msg var."""
    for node in ast.walk(fn):
        if isinstance(node, ast.Assign):
            for t in node.targets:
                if (
                    isinstance(t, ast.Tuple)
                    and len(t.elts) == 2
                    and isinstance(t.elts[0], ast.Name)
                    and t.elts[0].id == msg_var
                    and isinstance(t.elts[1], ast.Name)
                ):
                    return t.elts[1].id
    params = [a.arg for a in fn.args.args
              if a.arg not in ("self", "conn", msg_var)]
    return params[-1] if params else None


def _elif_chain(session: ProjectSession, mod: ModuleInfo,
                cls: Optional[ast.ClassDef], fn: ast.FunctionDef,
                constants: Dict[str, str],
                ) -> Tuple[Optional[DispatchTable], List[Handler]]:
    arms: List[Tuple[str, bool, ast.If]] = []   # (msg, raw, branch)
    msg_var_seen: Optional[str] = None
    for node in ast.walk(fn):
        if not isinstance(node, ast.If):
            continue
        got = _extract_chain_compare(node.test)
        if got is None:
            continue
        var, exprs = got
        if var not in MSG_VAR_NAMES:
            continue
        for e in exprs:
            m, raw = session.resolve_msg(mod, e, constants)
            if m is None or m in FRAMING_TYPES or _is_internal(m):
                continue
            msg_var_seen = var
            arms.append((m, raw, node))
    if len({m for m, _r, _n in arms}) < 2:
        return None, []
    payload_name = _payload_partner(fn, msg_var_seen)
    methods = mod.methods(cls) if cls is not None else {}
    qual = mod.qualnames.get(id(fn), fn.name)
    handlers = []
    for msg, raw, branch in arms:
        acc = _PayloadReads()
        if payload_name:
            _collect_payload_reads(
                mod, methods, list(branch.body), payload_name, acc,
                {fn.name})
        handlers.append(Handler(
            module=mod, line=branch.lineno, msg=msg, symbol=qual,
            required_keys=frozenset(acc.required),
            read_keys=frozenset(acc.read),
            opaque=acc.opaque or payload_name is None,
            raw_string=raw,
            item_required={k: frozenset(v.required)
                           for k, v in acc.item.items() if v.required},
            item_read={k: frozenset(v.read)
                       for k, v in acc.item.items() if v.read},
        ))
    table = DispatchTable(
        module=mod, line=fn.lineno, kind="elif", owner=qual,
        msgs=frozenset({m for m, _r, _n in arms}),
    )
    return table, handlers


def _find_tables(session: ProjectSession, mod: ModuleInfo,
                 constants: Dict[str, str],
                 ) -> Tuple[List[DispatchTable], List[Handler]]:
    tables: List[DispatchTable] = []
    handlers: List[Handler] = []
    fn_index = _FnIndex(mod)
    for cls_name, cls in mod.classes.items():
        methods = mod.methods(cls)
        for node in ast.walk(cls):
            if isinstance(node, ast.Assign) and len(node.targets) == 1:
                tgt, value = node.targets[0], node.value
            elif isinstance(node, ast.AnnAssign) and node.value is not None:
                tgt, value = node.target, node.value
            else:
                continue
            if not (self_attr(tgt) or isinstance(tgt, ast.Name)):
                continue
            # convention table: {name[len("_on_"):]: getattr(self, name)
            #                    for name in dir(...) ...}
            prefix = _prefix_table(cls, value)
            if prefix is not None:
                msgs = set()
                for mname, meth in methods.items():
                    if not mname.startswith(prefix) or mname == prefix:
                        continue
                    msg = mname[len(prefix):]
                    msgs.add(msg)
                    handlers.append(
                        _handler_from_method(mod, cls, meth, msg, False))
                if msgs:
                    tables.append(DispatchTable(
                        module=mod, line=node.lineno, kind="prefix",
                        owner=cls_name, msgs=frozenset(msgs),
                    ))
                continue
            # dict-literal table: {P.REPLY: self._on_reply, ...}
            if isinstance(value, ast.Dict) and value.keys:
                entries = []
                ok = True
                for k, v in zip(value.keys, value.values):
                    if k is None:
                        ok = False
                        break
                    msg, raw = session.resolve_msg(mod, k, constants)
                    target = self_attr(v)
                    if msg is None or target is None:
                        ok = False
                        break
                    entries.append((msg, raw, target))
                # a handler table maps every entry to a method of this
                # class — a dict of plain self-attributes (config
                # snapshots, serve deployment options) is not dispatch
                if ok and entries and all(
                    t in methods for _m, _r, t in entries
                ):
                    msgs = set()
                    for msg, raw, target in entries:
                        if msg in FRAMING_TYPES or _is_internal(msg):
                            continue
                        msgs.add(msg)
                        handlers.append(_handler_from_method(
                            mod, cls, methods[target], msg, raw))
                    if msgs:
                        tables.append(DispatchTable(
                            module=mod, line=node.lineno, kind="dict",
                            owner=cls_name, msgs=frozenset(msgs),
                        ))
    # if/elif chains, in methods and module functions
    for fn in _functions_in(mod.ctx.tree):
        cls_name, _f = fn_index.owner.get(id(fn), (None, None))
        cls = mod.classes.get(cls_name) if cls_name else None
        table, hs = _elif_chain(session, mod, cls, fn, constants)
        if table is not None:
            tables.append(table)
            handlers.extend(hs)
    return tables, handlers


def _routing_sets(session: ProjectSession, mod: ModuleInfo,
                  constant_values: Set[str]) -> List[RoutingSet]:
    out: List[RoutingSet] = []
    sharded_mod = bool(
        "shard" in mod.basename
        or any(_REACTOR_CLASS.search(c) for c in mod.classes)
    )
    for node in mod.ctx.tree.body:
        if not (isinstance(node, ast.Assign) and len(node.targets) == 1):
            continue
        tgt = node.targets[0]
        if not (isinstance(tgt, ast.Name) and tgt.id.isupper()):
            continue
        v = node.value
        if isinstance(v, ast.Call) and _call_name(v) in ("frozenset", "set"):
            if len(v.args) != 1:
                continue
            v = v.args[0]
        if not isinstance(v, ast.Set):
            continue
        msgs = set()
        ok = True
        for e in v.elts:
            s = _const_str(e)
            if s is None:
                ok = False
                break
            msgs.add(s)
        if not ok or len(msgs) < 3:
            continue
        # a routing set routes MESSAGES: most elements must be known
        # protocol values or the set is some other string table (an
        # allow-list, a keyword set) that happens to live nearby
        if constant_values:
            known = len(msgs & constant_values)
            if known / len(msgs) < 0.8:
                continue
        out.append(RoutingSet(
            module=mod, line=node.lineno, name=tgt.id,
            msgs=frozenset(msgs), sharded=sharded_mod,
        ))
    return out


def _build_protocol_model(session: ProjectSession) -> ProtocolModel:
    proto_mod: Optional[ModuleInfo] = None
    constants: Dict[str, str] = {}
    for mod in session.by_basename.get("protocol", []):
        consts = _protocol_constants(mod)
        if consts:
            proto_mod = mod
            constants = consts
            break
    sends: List[SendSite] = []
    handlers: List[Handler] = []
    tables: List[DispatchTable] = []
    routing: List[RoutingSet] = []
    compared: Set[str] = set()
    for mod in session.modules:
        sends.extend(_find_sends(session, mod, constants))
        t, h = _find_tables(session, mod, constants)
        tables.extend(t)
        handlers.extend(h)
        routing.extend(_routing_sets(session, mod, set(constants.values())))
        for node in ast.walk(mod.ctx.tree):
            if not (isinstance(node, ast.Compare) and len(node.ops) == 1):
                continue
            if not isinstance(node.ops[0], (ast.Eq, ast.NotEq, ast.In,
                                            ast.NotIn)):
                continue
            comps = [node.comparators[0], node.left]
            exprs: List[ast.AST] = []
            for c in comps:
                if isinstance(c, (ast.Tuple, ast.List, ast.Set)):
                    exprs.extend(c.elts)
                else:
                    exprs.append(c)
            for e in exprs:
                m, _r = session.resolve_msg(mod, e, constants)
                if m is not None:
                    compared.add(m)
    return ProtocolModel(
        constants=constants,
        constant_values=set(constants.values()),
        protocol_module=proto_mod,
        sends=sends,
        handlers=handlers,
        tables=tables,
        routing_sets=routing,
        compared=compared,
    )


# ======================================================= thread model builder


def _ctor_class(node: ast.AST) -> Optional[str]:
    """Class name constructed by ``node``: ``Cls(...)``,
    ``[Cls(...) for ...]``, ``[Cls(...), ...]``."""
    if isinstance(node, ast.Call):
        n = _call_name(node)
        if n and n[:1].isupper():
            return n
    if isinstance(node, (ast.ListComp, ast.SetComp, ast.GeneratorExp)):
        return _ctor_class(node.elt)
    if isinstance(node, (ast.List, ast.Tuple)) and node.elts:
        names = {_ctor_class(e) for e in node.elts}
        if len(names) == 1:
            return names.pop()
    return None


def _annotation_class(node: Optional[ast.AST]) -> Optional[str]:
    if isinstance(node, ast.Name) and node.id[:1].isupper():
        return node.id
    if isinstance(node, ast.Attribute) and node.attr[:1].isupper():
        return node.attr
    if isinstance(node, ast.Subscript):  # List[Cls] / Optional[Cls]
        return _annotation_class(node.slice)
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        # string annotation: 'ReactorShard' / List["ReactorShard"]
        name = node.value.strip("'\"").split("[")[-1].rstrip("]").strip(
            "'\"")
        if name[:1].isupper():
            return name
    return None


def _is_thread_subclass(cls: ast.ClassDef) -> bool:
    for b in cls.bases:
        tail = b.attr if isinstance(b, ast.Attribute) else (
            b.id if isinstance(b, ast.Name) else "")
        if tail == "Thread":
            return True
    return False


def _thread_targets(node: ast.Call) -> List[str]:
    """Self-method names referenced by a Thread(...) construction's
    ``target=`` expression (looks through ``a if c else b``)."""
    out: List[str] = []
    for kw in node.keywords:
        if kw.arg != "target":
            continue
        for sub in ast.walk(kw.value):
            a = self_attr(sub)
            if a is not None:
                out.append(a)
    return out


def _call_edges(methods: Dict[str, ast.FunctionDef]) -> Dict[str, Set[str]]:
    """Intra-class call graph: method -> self-methods it calls or
    references (a bound-method reference handed to a timer/executor
    runs in the consumer's domain, so references count as edges)."""
    edges: Dict[str, Set[str]] = {m: set() for m in methods}
    for mname, fn in methods.items():
        for node in ast.walk(fn):
            a = self_attr(node)
            if a is not None and a in methods:
                edges[mname].add(a)
    return edges


def _build_thread_model(session: ProjectSession) -> ThreadModel:
    protocol = session.protocol()
    # (module, class name) -> handler method names (dict/prefix
    # tables). Module-scoped so two same-named owner classes in
    # different modules don't pool their handler sets.
    table_handlers: Dict[Tuple[int, str], Set[str]] = {}
    for t in protocol.tables:
        if t.kind == "elif":
            continue
        owner = t.owner
        hs = table_handlers.setdefault((id(t.module), owner), set())
        for h in protocol.handlers:
            if h.module is t.module and h.symbol.startswith(owner + "."):
                hs.add(h.symbol.split(".", 1)[1])
    classes: Dict[str, ClassThreads] = {}
    by_name: Dict[str, List[ClassThreads]] = {}
    for mod in session.modules:
        for cls_name, cls in mod.classes.items():
            info = ClassThreads(
                module=mod, cls=cls,
                qual=f"{mod.basename}.{cls_name}",
            )
            methods = mod.methods(cls)
            # ---- attribute types + channel attrs
            for fn in methods.values():
                for node in ast.walk(fn):
                    if isinstance(node, ast.Assign):
                        ctor = _ctor_class(node.value)
                        for t in node.targets:
                            a = self_attr(t)
                            if a is None:
                                continue
                            if ctor:
                                info.attr_types.setdefault(a, ctor)
                                if ctor in CHANNEL_CTORS:
                                    info.channel_attrs.add(a)
                            if _channel_name(a):
                                info.channel_attrs.add(a)
                    elif isinstance(node, ast.AnnAssign):
                        a = self_attr(node.target)
                        if a is not None:
                            ann = _annotation_class(node.annotation)
                            if ann:
                                info.attr_types.setdefault(a, ann)
                            if _channel_name(a):
                                info.channel_attrs.add(a)
            # ---- seeds
            seeds: Dict[str, Set[str]] = {}
            ctor_labels: List[str] = []

            def seed(method: str, label: str) -> None:
                if method in methods:
                    seeds.setdefault(method, set()).add(label)

            for mname, fn in methods.items():
                for node in ast.walk(fn):
                    if (isinstance(node, ast.Call)
                            and _call_name(node) == "Thread"):
                        targets = _thread_targets(node)
                        if not targets:
                            continue
                        label = f"thread:{info.qual}.{targets[0]}"
                        ctor_labels.append(label)
                        for t in targets:
                            seed(t, label)
            if _is_thread_subclass(cls) or _REACTOR_CLASS.search(cls_name):
                seed("run", f"thread:{info.qual}.run")
            if "_read_loop" in methods:
                seed("_read_loop", f"thread:{info.qual}._read_loop")
            # timer callbacks run on the class's main loop thread
            main_label = ctor_labels[0] if len(ctor_labels) >= 1 else None
            if main_label is not None:
                for mname, fn in methods.items():
                    for node in ast.walk(fn):
                        if (isinstance(node, ast.Call)
                                and _call_name(node) in ("_add_timer",
                                                         "add_timer")):
                            for a in node.args:
                                for sub in ast.walk(a):
                                    cb = self_attr(sub)
                                    if cb is not None and cb in methods:
                                        seed(cb, main_label)
            # ---- propagate through the intra-class call graph, then
            # fold dispatch-table handlers into their dispatcher's domain
            edges = _call_edges(methods)

            def propagate() -> None:
                domains = info.domains
                for m, labels in seeds.items():
                    domains.setdefault(m, set()).update(labels)
                changed = True
                while changed:
                    changed = False
                    for m, callees in edges.items():
                        src = domains.get(m)
                        if not src:
                            continue
                        for c in callees:
                            dst = domains.setdefault(c, set())
                            if not src <= dst:
                                dst |= src
                                changed = True

            propagate()
            hmethods = table_handlers.get((id(mod), cls_name), set())
            if hmethods:
                # the dispatcher that consumes the table already has the
                # right domain after propagation (e.g. _dispatch_inbound
                # under the reader thread); handler methods inherit it.
                # Fall back to the class main loop, then a synthetic
                # label, so handler-vs-handler conflicts still surface
                # in classes whose thread plumbing we can't see.
                inherited: Set[str] = set()
                for cand in ("_dispatch_msg", "_dispatch_inbound",
                             "_dispatch", "_handle"):
                    if info.domains.get(cand):
                        inherited = set(info.domains[cand])
                        break
                if not inherited and main_label is not None:
                    inherited = {main_label}
                if not inherited:
                    inherited = {f"handlers:{info.qual}"}
                for h in hmethods:
                    seeds.setdefault(h, set()).update(inherited)
                propagate()
            classes[info.qual] = info
            by_name.setdefault(cls_name, []).append(info)
    return ThreadModel(classes=classes, by_name=by_name)


# ========================================================== flow model builder
#
# The GL015 pass needs what no per-file rule can see: whether a SYNC
# helper called from a coroutine eventually parks the thread. Blocking
# recognition is shared with GL003 (same dotted table, same no-timeout
# method forms) so the two rules' notions of "a blocking op" cannot
# diverge; this builder adds the transitive closure over the project
# call graph plus the slow-thread-lock roots.

_TRACE_READ_CALLS = frozenset({"current_context", "begin_trace"})
_CLOSURE_DISPATCH_THREAD = frozenset({"Thread"})


def _local_nodes(fn: ast.AST):
    """Nodes lexically inside ``fn``, not descending into nested
    defs/lambdas/classes (their bodies run where they are *called*)."""
    stack = list(ast.iter_child_nodes(fn))
    while stack:
        n = stack.pop()
        yield n
        if not isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef,
                              ast.Lambda, ast.ClassDef)):
            stack.extend(ast.iter_child_nodes(n))


def _callee_key(session: ProjectSession, mod: ModuleInfo,
                cls_name: Optional[str],
                methods: Dict[str, ast.FunctionDef],
                call: ast.Call) -> Optional[str]:
    """Flow-graph key of the function a call resolves to: a same-class
    ``self.m()``, a same-module ``fn()``, a from-imported ``fn()``, or
    a ``mod_alias.fn()`` into another session module."""
    f = call.func
    a = self_attr(f)
    if a is not None:
        if cls_name is not None and a in methods:
            return f"{mod.basename}.{cls_name}.{a}"
        return None
    if isinstance(f, ast.Name):
        if f.id in mod.functions:
            return f"{mod.basename}.{f.id}"
        origin = mod.ctx.import_aliases.get(f.id, "")
        if "." in origin:
            mpath, fname = origin.rsplit(".", 1)
            tail = mpath.split(".")[-1]
            for tm in session.by_basename.get(tail, []):
                if fname in tm.functions:
                    return f"{tm.basename}.{fname}"
        return None
    if isinstance(f, ast.Attribute) and isinstance(f.value, ast.Name):
        alias = mod.module_aliases.get(f.value.id)
        if alias is not None:
            for tm in session.by_basename.get(alias, []):
                if f.attr in tm.functions:
                    return f"{tm.basename}.{f.attr}"
    return None


def _is_none_guard(test: ast.AST) -> bool:
    """``<name> is None`` — the no-trace fast path: inside its body a
    closure has no ambient context worth re-pushing."""
    return (
        isinstance(test, ast.Compare)
        and len(test.ops) == 1
        and isinstance(test.ops[0], ast.Is)
        and isinstance(test.comparators[0], ast.Constant)
        and test.comparators[0].value is None
    )


def _calls_push_context(node: ast.AST) -> bool:
    for sub in ast.walk(node):
        if isinstance(sub, ast.Call) and _call_name(sub) == "push_context":
            return True
    return False


def _unsafe_ctx_dispatches(fn: ast.AST) -> List[Tuple[int, str]]:
    """(line, closure name) for every local lambda/nested-def handed to
    ``run_in_executor`` / ``Thread(target=)`` without re-pushing the
    trace context, outside an ``if <x> is None:`` no-trace guard.
    Bound-method and partial targets are exempt: the rule exists for
    closures written next to a live trace read (the proxy's hand-fix)."""
    nested: Dict[str, ast.AST] = {
        n.name: n for n in _local_nodes(fn)
        if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))
    }
    out: List[Tuple[int, str]] = []

    def closure_of(node: ast.AST) -> Optional[Tuple[str, ast.AST]]:
        if isinstance(node, ast.Lambda):
            return "<lambda>", node
        if isinstance(node, ast.Name) and node.id in nested:
            return node.id, nested[node.id]
        return None

    def check_call(call: ast.Call, guarded: bool) -> None:
        target: Optional[ast.AST] = None
        f = call.func
        if isinstance(f, ast.Attribute) and f.attr == "run_in_executor":
            if len(call.args) >= 2:
                target = call.args[1]
        elif _call_name(call) in _CLOSURE_DISPATCH_THREAD:
            for kw in call.keywords:
                if kw.arg == "target":
                    target = kw.value
        if target is None:
            return
        got = closure_of(target)
        if got is None:
            return
        name, body = got
        if guarded or _calls_push_context(body):
            return
        out.append((call.lineno, name))

    def visit(node: ast.AST, guarded: bool) -> None:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda, ast.ClassDef)):
            return
        if isinstance(node, ast.Call):
            check_call(node, guarded)
        if isinstance(node, ast.If) and _is_none_guard(node.test):
            visit(node.test, guarded)
            for s in node.body:
                visit(s, True)
            for s in node.orelse:
                visit(s, guarded)
            return
        for child in ast.iter_child_nodes(node):
            visit(child, guarded)

    for stmt in ast.iter_child_nodes(fn):
        visit(stmt, False)
    return out


def _build_flow_model(session: ProjectSession) -> FlowModel:
    # shared blocking recognition — GL003's tables ARE the roots
    from .checkers.gl003_blocking_async import (
        BLOCKING,
        blocking_method_form,
        local_ctor_kinds,
    )

    functions: Dict[str, FlowFunction] = {}
    for mod in session.modules:
        fn_index = _FnIndex(mod)
        for fn in _functions_in(mod.ctx.tree):
            qual = mod.qualnames.get(id(fn), fn.name)
            key = f"{mod.basename}.{qual}"
            if key in functions:
                continue  # first-hit rule, same as resolve_class
            cls_name, _owner_fn = fn_index.owner.get(id(fn), (None, None))
            cls = mod.classes.get(cls_name) if cls_name else None
            methods = mod.methods(cls) if cls is not None else {}
            ff = FlowFunction(
                module=mod, node=fn, key=key, qual=qual,
                is_async=isinstance(fn, ast.AsyncFunctionDef),
                cls_name=cls_name,
            )
            awaited = {
                id(sub)
                for n in _local_nodes(fn)
                if isinstance(n, ast.Await)
                for sub in ast.walk(n)
            }
            stmt_calls = {
                id(n.value)
                for n in _local_nodes(fn)
                if isinstance(n, ast.Expr) and isinstance(n.value, ast.Call)
            }
            kinds = local_ctor_kinds(fn)
            for node in _local_nodes(fn):
                if isinstance(node, (ast.With, ast.AsyncWith)):
                    for item in node.items:
                        a = self_attr(item.context_expr)
                        if a is not None and is_lockish(a) and cls_name:
                            ff.locks.add(f"{mod.basename}.{cls_name}.{a}")
                if not isinstance(node, ast.Call):
                    continue
                tail = _call_name(node)
                if tail in _TRACE_READ_CALLS:
                    ff.reads_trace_ctx = True
                if id(node) not in awaited:
                    name = mod.ctx.resolve(dotted_name(node.func))
                    hint = BLOCKING.get(name or "")
                    if hint is not None:
                        ff.blocking.append(
                            (node.lineno, f"blocking `{name}(...)`"))
                    else:
                        form = blocking_method_form(node, kinds)
                        if form is not None:
                            recv, _kind, _fix = form
                            ff.blocking.append((
                                node.lineno,
                                f"no-timeout `{recv}.{node.func.attr}()`",
                            ))
                callee = _callee_key(session, mod, cls_name, methods, node)
                if callee is not None:
                    ff.calls.append((
                        node.lineno, callee,
                        id(node) in awaited, id(node) in stmt_calls,
                    ))
            if ff.reads_trace_ctx:
                ff.ctx_unsafe_dispatches = _unsafe_ctx_dispatches(fn)
            functions[key] = ff

    # slow-thread locks: a thread-domain method that performs one of
    # the recognized blocking ops INSIDE `with self.<lock>:` makes that
    # lock a blocking root for everyone else
    tm = session.threads()
    slow: Dict[str, str] = {}
    for key, ff in functions.items():
        if not ff.blocking or ff.cls_name is None:
            continue
        cq = f"{ff.module.basename}.{ff.cls_name}"
        info = tm.classes.get(cq)
        if info is None:
            continue
        mname = ff.qual.rsplit(".", 1)[-1]
        doms = info.domains.get(mname, set())
        if not any(d.startswith("thread:") for d in doms):
            continue
        blines = [ln for ln, _d in ff.blocking]
        for node in _local_nodes(ff.node):
            if not isinstance(node, (ast.With, ast.AsyncWith)):
                continue
            end = getattr(node, "end_lineno", node.lineno)
            if not any(node.lineno <= b <= end for b in blines):
                continue
            for item in node.items:
                a = self_attr(item.context_expr)
                if a is not None and is_lockish(a):
                    lock = f"{ff.module.basename}.{ff.cls_name}.{a}"
                    op = next(d for ln, d in ff.blocking
                              if node.lineno <= ln <= end)
                    slow.setdefault(
                        lock,
                        f"held around {op} by {key} "
                        f"(runs on {sorted(doms)[0]})",
                    )
    return FlowModel(functions=functions, slow_thread_locks=slow)


# ====================================================== resource model builder


def _acquire_kind(value: ast.AST) -> Optional[str]:
    if isinstance(value, ast.Call):
        return ACQUIRE_CTORS.get(_call_name(value) or "")
    return None


def _build_resource_model(session: ProjectSession) -> ResourceModel:
    classes: Dict[str, ResourceClass] = {}
    for mod in session.modules:
        for cls_name, cls in mod.classes.items():
            rc = ResourceClass(
                module=mod, cls_name=cls_name,
                qual=f"{mod.basename}.{cls_name}",
            )
            methods = mod.methods(cls)
            # ---- sweep A: typed names (selector ctors, timer pushes)
            sel_names: Set[str] = set()
            for fn in methods.values():
                for node in _local_nodes(fn):
                    if isinstance(node, ast.Assign):
                        if _acquire_kind(node.value) == "selector":
                            for t in node.targets:
                                a = self_attr(t)
                                if a is not None:
                                    sel_names.add(a)
                                elif isinstance(t, ast.Name):
                                    sel_names.add(t.id)
                    elif isinstance(node, ast.Call):
                        tail = _call_name(node)
                        if (
                            tail in ("heappush", "append")
                            and node.args
                        ):
                            a = self_attr(node.args[0]) if tail == "heappush" \
                                else None
                            if tail == "append":
                                f = node.func
                                base = (f.value if isinstance(f, ast.Attribute)
                                        else None)
                                a = self_attr(base) if base is not None else None
                            if a is not None and "timer" in a.lower():
                                rc.timer_attrs.setdefault(a, []).append(
                                    node.lineno)
            # ---- sweep B: aliases, pairing sites, drops, clears, stores
            drops_raw: Dict[str, List[int]] = {}
            clears_raw: Dict[str, List[int]] = {}
            for mname, fn in methods.items():
                # precollect: _local_nodes is unordered (stack walk), and
                # the registry store may be visited before its acquire
                acquired_locals: Set[str] = {
                    t.id
                    for node in _local_nodes(fn)
                    if isinstance(node, ast.Assign)
                    and _acquire_kind(node.value) is not None
                    for t in node.targets
                    if isinstance(t, ast.Name)
                }
                # aliases too: `sel = self._selector` before `sel.unregister`
                for node in _local_nodes(fn):
                    if isinstance(node, ast.Assign):
                        va = self_attr(node.value)
                        if va is not None and va in sel_names:
                            for t in node.targets:
                                if isinstance(t, ast.Name):
                                    sel_names.add(t.id)
                for node in _local_nodes(fn):
                    if isinstance(node, ast.Assign):
                        v = node.value
                        for t in node.targets:
                            # handle-registry store: self.X[k] = handle
                            if (
                                isinstance(t, ast.Subscript)
                                and isinstance(v, ast.Name)
                                and v.id in acquired_locals
                            ):
                                a = self_attr(t.value)
                                if a is not None:
                                    rc.registry_attrs.setdefault(
                                        a, []).append(node.lineno)
                            # teardown reassign: self.X = [] outside init
                            a = self_attr(t)
                            if (
                                a is not None
                                and mname != "__init__"
                                and isinstance(node.value, (ast.List,
                                                            ast.Dict))
                                and not getattr(node.value, "elts", None)
                                and not getattr(node.value, "keys", None)
                            ):
                                clears_raw.setdefault(a, []).append(
                                    node.lineno)
                    elif isinstance(node, ast.Delete):
                        for t in node.targets:
                            if isinstance(t, ast.Subscript):
                                a = self_attr(t.value)
                                if a is not None:
                                    drops_raw.setdefault(a, []).append(
                                        node.lineno)
                    elif isinstance(node, ast.Call):
                        f = node.func
                        if not isinstance(f, ast.Attribute):
                            continue
                        base = f.value
                        bname = self_attr(base) or (
                            base.id if isinstance(base, ast.Name) else None)
                        if bname is None:
                            continue
                        if f.attr in ("register", "unregister", "close") \
                                and bname in sel_names:
                            if f.attr == "register":
                                rc.register_sites.append(node.lineno)
                            elif f.attr == "unregister":
                                rc.unregister_sites.append(node.lineno)
                            else:
                                rc.selector_close_sites.append(node.lineno)
                        if f.attr in ("pop", "popitem") \
                                and self_attr(base) is not None:
                            drops_raw.setdefault(self_attr(base), []).append(
                                node.lineno)
                        if f.attr == "clear" and self_attr(base) is not None:
                            a = self_attr(base)
                            drops_raw.setdefault(a, []).append(node.lineno)
                            clears_raw.setdefault(a, []).append(node.lineno)
            rc.selector_names = sel_names
            rc.registry_drops = {
                a: drops_raw[a] for a in rc.registry_attrs if a in drops_raw
            }
            rc.timer_clears = {
                a: clears_raw[a] for a in rc.timer_attrs if a in clears_raw
            }
            if (
                rc.selector_names or rc.register_sites or rc.timer_attrs
                or rc.registry_attrs
            ):
                classes[rc.qual] = rc
    return ResourceModel(classes=classes)
