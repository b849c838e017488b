"""CLI: ``python -m ray_tpu_torch.tools.graftlint [paths] [options]``.

Exit status: 0 when every finding is suppressed or baselined, 1 when
new findings exist, 2 on usage errors. Findings print one per line as
``path:line GLxxx message`` (or as one JSON object with
``--format json``, or as a SARIF 2.1.0 log with ``--format sarif`` for
CI annotation uploads).

``--changed-only`` reports per-file findings only in files git
considers changed (worktree/index vs HEAD, plus untracked) — the fast
pre-commit mode. The whole tree is still ANALYZED, and whole-program
findings (GL012–GL017) always report regardless of where they anchor:
deleting a handler must surface the sent-but-unhandled finding even
though it anchors at the untouched send site. Both structured formats
compose with it.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
from typing import List, Optional, Set

from .core import (
    DEFAULT_BASELINE_PATH,
    all_checkers,
    all_project_checkers,
    check_paths,
    load_baseline,
    write_baseline,
)


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m ray_tpu_torch.tools.graftlint",
        description=(
            "AST-based concurrency & distributed-runtime invariant "
            "checker for this repo: per-file rules GL001-GL011 plus "
            "whole-program passes GL012-GL017 (see the package README)."
        ),
    )
    parser.add_argument(
        "paths", nargs="*", default=["ray_tpu_torch"],
        help="files or directories to check (default: ray_tpu_torch)",
    )
    parser.add_argument(
        "--baseline", default=DEFAULT_BASELINE_PATH, metavar="FILE",
        help="baseline JSON of accepted findings "
             "(default: the packaged baseline.json)",
    )
    parser.add_argument(
        "--no-baseline", action="store_true",
        help="ignore the baseline; report every finding",
    )
    parser.add_argument(
        "--write-baseline", metavar="FILE",
        help="write all current findings to FILE as the new baseline "
             "and exit 0",
    )
    parser.add_argument(
        "--select", metavar="CODES",
        help="comma-separated rule codes to run (e.g. GL001,GL005)",
    )
    parser.add_argument(
        "--list-rules", action="store_true", help="list rules and exit",
    )
    parser.add_argument(
        "-q", "--quiet", action="store_true",
        help="suppress the summary line; print findings only",
    )
    parser.add_argument(
        "--format", choices=["text", "json", "sarif"], default="text",
        help="output format (json: one object with findings + counts; "
             "sarif: a SARIF 2.1.0 log for CI annotation uploads)",
    )
    parser.add_argument(
        "--changed-only", action="store_true",
        help="report per-file findings only in git-changed files "
             "(whole-program findings always report; the whole tree "
             "is always analyzed)",
    )
    args = parser.parse_args(argv)

    if args.list_rules:
        for code, name, _fn in sorted(all_checkers() + all_project_checkers()):
            print(f"{code}  {name}")
        return 0

    for p in args.paths:
        if not os.path.exists(p):
            print(f"graftlint: no such path: {p}", file=sys.stderr)
            return 2

    codes = None
    if args.select:
        codes = {c.strip().upper() for c in args.select.split(",") if c.strip()}
        known = {
            code
            for code, _name, _fn in all_checkers() + all_project_checkers()
        }
        unknown = sorted(codes - known)
        if unknown:
            # a typo'd code must not silently run zero checkers and
            # green-light the tree
            print(
                f"graftlint: unknown rule code(s): {', '.join(unknown)} "
                f"(known: {', '.join(sorted(known))})",
                file=sys.stderr,
            )
            return 2

    report_only: Optional[Set[str]] = None
    if args.changed_only:
        if args.write_baseline:
            # a diff-scoped run drops every out-of-scope finding, so
            # the written baseline would silently lose all accepted
            # fingerprints outside the diff
            print(
                "graftlint: --write-baseline needs the full finding "
                "set; drop --changed-only",
                file=sys.stderr,
            )
            return 2
        report_only = _git_changed_files(args.paths)
        if report_only is None:
            print(
                "graftlint: --changed-only needs the analyzed paths "
                "inside a git checkout (git rev-parse failed)",
                file=sys.stderr,
            )
            return 2

    baseline = (
        set() if (args.no_baseline or args.write_baseline)
        else load_baseline(args.baseline)
    )
    new, old = check_paths(
        args.paths, baseline=baseline, codes=codes,
        report_only=report_only,
    )

    if args.write_baseline:
        write_baseline(args.write_baseline, new + old)
        if not args.quiet:
            print(
                f"graftlint: wrote {len(new) + len(old)} finding(s) to "
                f"{args.write_baseline}"
            )
        return 0

    if args.format == "json":
        print(json.dumps(
            {
                "findings": [dataclasses.asdict(f) for f in new],
                "baselined": len(old),
                "changed_only": bool(args.changed_only),
            },
            indent=2, sort_keys=True,
        ))
        return 1 if new else 0

    if args.format == "sarif":
        print(json.dumps(_sarif_log(new), indent=2, sort_keys=True))
        return 1 if new else 0

    for f in new:
        print(f.render())
    if not args.quiet:
        suffix = f" ({len(old)} baselined)" if old else ""
        print(
            f"graftlint: {len(new)} finding(s){suffix}",
            file=sys.stderr,
        )
    return 1 if new else 0


def _sarif_log(findings) -> dict:
    """SARIF 2.1.0: the interchange format CI systems (GitHub code
    scanning, pre-commit annotators) ingest directly. One run, one
    result per finding; ``partialFingerprints`` carries the same
    (path, code, symbol) identity the baseline uses, so an uploader
    dedupes findings across pushes exactly as the baseline would."""
    rules_seen = {}
    results = []
    for f in findings:
        rules_seen.setdefault(f.code, {
            "id": f.code,
            "defaultConfiguration": {"level": "error"},
        })
        results.append({
            "ruleId": f.code,
            "level": "error",
            "message": {"text": f.message},
            "locations": [{
                "physicalLocation": {
                    "artifactLocation": {
                        "uri": f.path.replace(os.sep, "/"),
                    },
                    "region": {"startLine": max(f.line, 1)},
                },
            }],
            "partialFingerprints": {
                "graftlint/v1": f"{f.path}:{f.code}:{f.symbol}",
            },
        })
    return {
        "$schema": (
            "https://raw.githubusercontent.com/oasis-tcs/sarif-spec/"
            "master/Schemata/sarif-schema-2.1.0.json"
        ),
        "version": "2.1.0",
        "runs": [{
            "tool": {
                "driver": {
                    "name": "graftlint",
                    "rules": [
                        rules_seen[c] for c in sorted(rules_seen)
                    ],
                },
            },
            "results": results,
        }],
    }


def _git_changed_files(paths: List[str]) -> Optional[Set[str]]:
    """Absolute paths of files changed vs HEAD (worktree + index) plus
    untracked files, for the checkout CONTAINING the analyzed paths —
    not the process CWD, which may sit in an unrelated repo (running
    graftlint on an absolute path from $HOME must not diff the
    operator's dotfiles). None when no git checkout is found there."""
    anchor = os.path.abspath(paths[0]) if paths else os.getcwd()
    if not os.path.isdir(anchor):
        anchor = os.path.dirname(anchor) or "."

    def run(*cmd: str) -> Optional[List[str]]:
        try:
            r = subprocess.run(
                list(cmd), capture_output=True, text=True, timeout=30,
            )
        except (OSError, subprocess.TimeoutExpired):
            return None
        if r.returncode != 0:
            return None
        return [ln for ln in r.stdout.splitlines() if ln.strip()]

    top = run("git", "-C", anchor, "rev-parse", "--show-toplevel")
    if not top:
        return None
    root = top[0]
    names: Set[str] = set()
    # vs HEAD covers both staged and unstaged edits; a repo with no
    # commit yet has no HEAD — fall back to the index diff
    diff = run("git", "-C", root, "diff", "--name-only", "HEAD", "--")
    if diff is None:
        diff = run("git", "-C", root, "diff", "--name-only", "--") or []
    names.update(diff)
    names.update(
        run("git", "-C", root, "ls-files", "--others",
            "--exclude-standard") or []
    )
    return {os.path.join(root, n) for n in names}


if __name__ == "__main__":
    sys.exit(main())
