"""graftlint: AST-based concurrency & distributed-runtime invariant
checker for this repository. See README.md in this directory for the
rule catalogue and ``python -m ray_tpu_torch.tools.graftlint --help`` for the
CLI."""

from .core import (  # noqa: F401
    DEFAULT_BASELINE_PATH,
    Finding,
    all_checkers,
    all_project_checkers,
    check_file,
    check_paths,
    load_baseline,
    write_baseline,
)

__all__ = [
    "DEFAULT_BASELINE_PATH",
    "Finding",
    "all_checkers",
    "all_project_checkers",
    "check_file",
    "check_paths",
    "load_baseline",
    "write_baseline",
]
