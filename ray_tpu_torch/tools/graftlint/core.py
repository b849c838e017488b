"""graftlint core: findings, suppression, baseline, and the file runner.

graftlint is a repo-specific static analyzer for the concurrency and
distributed-runtime invariants of this codebase (see README.md in this
directory). It is stdlib-only (`ast` + `json`) so it can run inside the
tier-1 test gate with no extra dependencies.

Design notes:

- Checkers are plain functions ``check(ctx) -> list[Finding]`` registered
  via :func:`register`. Keeping them stateless functions (no accumulating
  instance attributes) is deliberate — the analyzer lints its own package.
- Whole-program passes (GL012+) are ``check(session) -> list[Finding]``
  functions registered via :func:`register_project`; ``check_paths``
  builds one :class:`~.project.ProjectSession` over the full file list
  and runs them after the per-file rules.
- Every file is parsed exactly ONCE per process, whatever the number of
  checkers or passes that look at it: :func:`parse_cached` keys on
  ``(mtime_ns, size)`` so per-file rules, the project session, and
  repeated test invocations all share one AST.
- Findings are fingerprinted as ``(path, code, symbol)`` rather than by
  line number, so a baseline survives unrelated edits to the same file.
- Two suppression mechanisms:
  * inline: a ``# graftlint: disable=GL001,GL004`` (or bare
    ``# graftlint: disable``) comment on the flagged line;
  * baseline: a JSON file of fingerprints for accepted findings, loaded
    with ``--baseline`` (the packaged ``baseline.json`` by default).
"""

from __future__ import annotations

import ast
import json
import os
import tokenize
from dataclasses import dataclass, field
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Set, Tuple

__all__ = [
    "Finding",
    "FileContext",
    "register",
    "register_project",
    "all_checkers",
    "all_project_checkers",
    "check_file",
    "check_paths",
    "parse_cached",
    "parse_stats",
    "load_baseline",
    "write_baseline",
    "DEFAULT_BASELINE_PATH",
]

DEFAULT_BASELINE_PATH = os.path.join(os.path.dirname(__file__), "baseline.json")

_DISABLE_MARKER = "graftlint: disable"


@dataclass(frozen=True)
class Finding:
    """One reported violation.

    ``symbol`` is a stable anchor (usually ``Class.method`` or
    ``Class.method.attr``) used for baseline fingerprints instead of the
    line number, which churns with unrelated edits.
    """

    path: str
    line: int
    code: str
    message: str
    symbol: str = ""

    def fingerprint(self) -> Tuple[str, str, str]:
        return (_norm_path(self.path), self.code, self.symbol)

    def render(self) -> str:
        return f"{self.path}:{self.line} {self.code} {self.message}"


@dataclass
class FileContext:
    """Everything a checker gets to look at for one file."""

    path: str
    source: str
    tree: ast.Module
    lines: List[str] = field(default_factory=list)
    # module alias -> full module name ("np" -> "numpy"); from-imports
    # map the bound name to its dotted origin ("sleep" -> "time.sleep")
    import_aliases: Dict[str, str] = field(default_factory=dict)

    @classmethod
    def parse(cls, path: str, source: Optional[str] = None) -> "FileContext":
        if source is None:
            with tokenize.open(path) as f:
                source = f.read()
        parse_stats["parses"] += 1
        tree = ast.parse(source, filename=path)
        ctx = cls(path=path, source=source, tree=tree,
                  lines=source.splitlines())
        ctx.import_aliases = _collect_imports(tree)
        return ctx

    def resolve(self, dotted: Optional[str]) -> Optional[str]:
        """Expand the leading segment of a dotted name through the
        file's imports: with ``import numpy as np``, ``np.ones`` ->
        ``numpy.ones``; with ``from time import sleep``, ``sleep`` ->
        ``time.sleep``."""
        if dotted is None:
            return None
        head, sep, rest = dotted.partition(".")
        full = self.import_aliases.get(head)
        if full is None:
            return dotted
        return full + sep + rest


# --------------------------------------------------------------- parse cache
#
# One process-wide AST cache: 11 per-file rules plus the six
# whole-program passes all want the same tree, and the tier-1 gate
# re-lints the full
# package several times per test run (fixtures, revert tests, the gate
# itself). Keyed on (mtime_ns, size) so an edited fixture file re-parses
# while untouched runtime files never do. ``parse_stats`` is exported so
# tests can assert the single-parse property directly.

_PARSE_CACHE: Dict[str, Tuple[Tuple[int, int], "FileContext"]] = {}
parse_stats = {"parses": 0, "hits": 0}


def parse_cached(path: str) -> "FileContext":
    """FileContext for ``path``, parsed at most once per file version."""
    try:
        st = os.stat(path)
        key = (st.st_mtime_ns, st.st_size)
    except OSError:
        key = None
    if key is not None:
        hit = _PARSE_CACHE.get(path)
        if hit is not None and hit[0] == key:
            parse_stats["hits"] += 1
            return hit[1]
    ctx = FileContext.parse(path)
    if key is not None:
        _PARSE_CACHE[path] = (key, ctx)
    return ctx


# ------------------------------------------------------------------ registry

CheckerFn = Callable[[FileContext], List[Finding]]
_CHECKERS: List[Tuple[str, str, CheckerFn]] = []
# whole-program passes: fn(session: project.ProjectSession) -> findings
_PROJECT_CHECKERS: List[Tuple[str, str, Callable]] = []


def register(code: str, name: str) -> Callable[[CheckerFn], CheckerFn]:
    def deco(fn: CheckerFn) -> CheckerFn:
        _CHECKERS.append((code, name, fn))
        return fn

    return deco


def register_project(code: str, name: str) -> Callable:
    def deco(fn):
        _PROJECT_CHECKERS.append((code, name, fn))
        return fn

    return deco


def all_checkers() -> List[Tuple[str, str, CheckerFn]]:
    from . import checkers as _checkers  # noqa: F401  (registration side effect)

    return list(_CHECKERS)


def all_project_checkers() -> List[Tuple[str, str, Callable]]:
    from . import checkers as _checkers  # noqa: F401  (registration side effect)

    return list(_PROJECT_CHECKERS)


# ------------------------------------------------------------------- helpers


def dotted_name(node: ast.AST) -> Optional[str]:
    """``a.b.c`` for an Attribute/Name chain, else None."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def self_attr(node: ast.AST) -> Optional[str]:
    """``x`` for ``self.x``, else None."""
    if (
        isinstance(node, ast.Attribute)
        and isinstance(node.value, ast.Name)
        and node.value.id == "self"
    ):
        return node.attr
    return None


def walk_local(node: ast.AST) -> Iterable[ast.AST]:
    """ast.walk that does not descend into nested function/class defs
    (so per-function analyses stay per-function)."""
    stack = list(ast.iter_child_nodes(node))
    while stack:
        n = stack.pop()
        yield n
        if not isinstance(
            n, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef, ast.Lambda)
        ):
            stack.extend(ast.iter_child_nodes(n))


def qualname_map(tree: ast.Module) -> Dict[int, str]:
    """``id(def-node) -> "Outer.inner"`` for every function/class def,
    so checkers can emit collision-free baseline symbols (two
    same-named methods in different classes must not share a
    fingerprint)."""
    out: Dict[int, str] = {}

    def visit(node: ast.AST, prefix: str) -> None:
        for child in ast.iter_child_nodes(node):
            if isinstance(
                child,
                (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef),
            ):
                qual = f"{prefix}.{child.name}" if prefix else child.name
                out[id(child)] = qual
                visit(child, qual)
            else:
                visit(child, prefix)

    visit(tree, "")
    return out


def _collect_imports(tree: ast.Module) -> Dict[str, str]:
    aliases: Dict[str, str] = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                aliases[a.asname or a.name.split(".")[0]] = (
                    a.name if a.asname else a.name.split(".")[0]
                )
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            for a in node.names:
                if a.name == "*":
                    continue
                aliases[a.asname or a.name] = f"{node.module}.{a.name}"
    return aliases


def _norm_path(path: str) -> str:
    """Stable fingerprint path: keep the trailing components from the
    package root down, so the baseline works from any CWD."""
    p = path.replace(os.sep, "/")
    for anchor in ("ray_tpu_torch/", "tests/"):
        idx = p.find(anchor)
        if idx >= 0:
            return p[idx:]
    return os.path.basename(p)


# --------------------------------------------------------------- suppression


def _suppressed(finding: Finding, ctx: FileContext) -> bool:
    if 1 <= finding.line <= len(ctx.lines):
        line = ctx.lines[finding.line - 1]
        idx = line.find(_DISABLE_MARKER)
        if idx >= 0:
            spec = line[idx + len(_DISABLE_MARKER):].lstrip()
            if not spec.startswith("="):
                return True  # bare "graftlint: disable" — all codes
            codes = spec[1:].split("#", 1)[0]
            # tolerate trailing prose: "disable=GL004 — readiness poll"
            parts = {
                c.strip().split()[0]
                for c in codes.split(",")
                if c.strip()
            }
            return finding.code in parts
    return False


# ------------------------------------------------------------------ baseline


def load_baseline(path: Optional[str]) -> Set[Tuple[str, str, str]]:
    if path is None or not os.path.exists(path):
        return set()
    with open(path) as f:
        data = json.load(f)
    return {
        (e["path"], e["code"], e.get("symbol", ""))
        for e in data.get("entries", [])
    }


def write_baseline(path: str, findings: Sequence[Finding]) -> None:
    entries = sorted(
        {f.fingerprint() for f in findings},
    )
    data = {
        "version": 1,
        "comment": (
            "Accepted graftlint findings. Each entry is fingerprinted by "
            "(path, code, symbol), not line, so it survives unrelated "
            "edits. Remove entries as the underlying code is fixed."
        ),
        "entries": [
            {"path": p, "code": c, "symbol": s} for p, c, s in entries
        ],
    }
    with open(path, "w") as f:
        json.dump(data, f, indent=2)
        f.write("\n")


# -------------------------------------------------------------------- runner


def check_file(
    path: str,
    source: Optional[str] = None,
    codes: Optional[Set[str]] = None,
) -> List[Finding]:
    """All (non-inline-suppressed) findings for one file.

    The whole-program passes run too, over a single-file session — so
    fixtures exercise GL012+ without a tree. Passes needing more than
    one module (GL012 is inert without a ``protocol`` module in the
    session) are exercised through ``check_paths``, whose ``overrides``
    let revert tests lint a modified copy of one real file against the
    rest of the live tree.
    """
    ctx, err = _parse_context(path, source)
    if ctx is None:
        return [err]
    out = _per_file_findings(ctx, codes)
    out.extend(_project_findings_for([ctx], codes))
    out.sort(key=lambda f: (f.path, f.line, f.code))
    return out


def _parse_context(
    path: str, source: Optional[str] = None
) -> Tuple[Optional[FileContext], Optional[Finding]]:
    """(context, None), or (None, GL000 finding) on a parse failure."""
    try:
        if source is None:
            return parse_cached(path), None
        return FileContext.parse(path, source), None
    except (SyntaxError, UnicodeDecodeError) as err:
        return None, Finding(
            path=path,
            line=getattr(err, "lineno", 1) or 1,
            code="GL000",
            message=f"could not parse: {err.__class__.__name__}: {err}",
            symbol="<parse>",
        )


def _per_file_findings(
    ctx: FileContext, codes: Optional[Set[str]]
) -> List[Finding]:
    """All non-suppressed per-file-rule findings for one context."""
    out: List[Finding] = []
    for code, _name, fn in all_checkers():
        if codes is not None and code not in codes:
            continue
        for f in fn(ctx):
            if not _suppressed(f, ctx):
                out.append(f)
    return out


def _project_findings_for(
    contexts: Sequence[FileContext], codes: Optional[Set[str]]
) -> List[Finding]:
    """Run the whole-program passes over one prepared session."""
    selected = [
        (code, name, fn)
        for code, name, fn in all_project_checkers()
        if codes is None or code in codes
    ]
    if not selected:
        return []
    from .project import ProjectSession

    session = ProjectSession(list(contexts))
    by_path = {ctx.path: ctx for ctx in contexts}
    out: List[Finding] = []
    for _code, _name, fn in selected:
        for f in fn(session):
            ctx = by_path.get(f.path)
            if ctx is None or not _suppressed(f, ctx):
                out.append(f)
    return out


def iter_python_files(paths: Sequence[str]) -> Iterable[str]:
    for p in paths:
        if os.path.isdir(p):
            for root, dirs, files in os.walk(p):
                dirs[:] = sorted(
                    d for d in dirs
                    if d not in ("__pycache__", ".git", "node_modules")
                )
                for fname in sorted(files):
                    if fname.endswith(".py"):
                        yield os.path.join(root, fname)
        else:
            # a file named explicitly is linted regardless of extension
            # (e.g. an executable script) — silently skipping it would
            # report a false "0 finding(s)" green
            yield p


def check_paths(
    paths: Sequence[str],
    baseline: Optional[Set[Tuple[str, str, str]]] = None,
    codes: Optional[Set[str]] = None,
    overrides: Optional[Dict[str, str]] = None,
    report_only: Optional[Set[str]] = None,
) -> Tuple[List[Finding], List[Finding]]:
    """Returns (new_findings, baselined_findings).

    The whole tree is parsed ONCE (per-file rules and the project
    session share the cache) and the whole-program passes run over one
    session covering every file.

    ``overrides`` maps path -> replacement source (revert tests lint a
    modified copy of a real file against the rest of the live tree).
    ``report_only`` restricts reported PER-FILE findings to those paths
    while still analyzing everything — the ``--changed-only`` mode.
    Whole-program findings always report: their anchor line can sit in
    an unchanged file while the causal edit is on the other side of the
    relationship (delete a handler and the sent-but-unhandled finding
    anchors at the untouched send site), so scoping them to the diff
    would green-light exactly the breakage the passes exist to catch.
    """
    baseline = baseline or set()
    overrides = overrides or {}
    report_abs = (
        None if report_only is None
        else {os.path.abspath(p) for p in report_only}
    )
    new: List[Finding] = []
    old: List[Finding] = []
    contexts: List[FileContext] = []
    per_file: List[Finding] = []
    for fpath in iter_python_files(paths):
        ctx, err = _parse_context(fpath, overrides.get(fpath))
        if ctx is None:
            per_file.append(err)
            continue
        contexts.append(ctx)
        per_file.extend(_per_file_findings(ctx, codes))
    if report_abs is not None:
        per_file = [
            f for f in per_file
            if os.path.abspath(f.path) in report_abs
        ]
    findings = per_file + _project_findings_for(contexts, codes)
    findings.sort(key=lambda f: (f.path, f.line, f.code))
    for f in findings:
        (old if f.fingerprint() in baseline else new).append(f)
    return new, old
