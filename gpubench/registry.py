"""Find configurations, cells, traffic mixes, limits, model families and
metric readers by name, and the metrics ``BENCHMARK.json`` asks of a cell."""

from __future__ import annotations

import importlib
import importlib.util
import json
import os
import re
import sys
from typing import Any, Dict, List

from . import PKG_DIR, ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def _load(kind: str, name: str) -> Dict[str, Any]:
    if not NAME.match(name):
        raise ValueError(f"bad {kind} name {name!r}")
    path = os.path.join(PKG_DIR, kind, f"{name}.json")
    if not os.path.exists(path):
        raise FileNotFoundError(f"no {kind} named {name!r} ({path})")
    with open(path) as f:
        return json.load(f)


def config(name: str) -> Dict[str, Any]:
    return _load("configs", name)


def workload(name: str) -> Dict[str, Any]:
    return _load("workloads", name)


def traffic(name: str) -> Dict[str, Any]:
    return _load("traffic", name)


def limits(name: str) -> Dict[str, float]:
    return _load("limits", name)


def names(kind: str) -> List[str]:
    """Every name of ``kind`` (configs, workloads, traffic, limits, families,
    metrics) that has a file."""
    ext = ".py" if kind in ("families", "metrics") else ".json"
    d = os.path.join(PKG_DIR, kind)
    return sorted(f[:-len(ext)] for f in os.listdir(d)
                  if f.endswith(ext) and not f.startswith("_"))


def metric(name: str):
    """The reader module of metric ``name``, loaded from
    ``metrics/<name>.py`` (a name may hold dots)."""
    if not NAME.match(name):
        raise ValueError(f"bad metric name {name!r}")
    key = f"{__package__}.metrics._{name.replace('.', '_').replace('-', '_')}"
    if key not in sys.modules:
        path = os.path.join(PKG_DIR, "metrics", f"{name}.py")
        spec = importlib.util.spec_from_file_location(key, path)
        if spec is None or not os.path.exists(path):
            raise FileNotFoundError(f"no metric reader named {name!r} ({path})")
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        sys.modules[key] = module
    return sys.modules[key]


def family(name: str):
    """The module of model family ``name``, ``families/<name>.py`` (a name
    is a Python identifier)."""
    if not name.isidentifier():
        raise ValueError(f"bad family name {name!r}")
    if not os.path.exists(os.path.join(PKG_DIR, "families", f"{name}.py")):
        raise FileNotFoundError(f"no model family named {name!r}")
    return importlib.import_module(f"{__package__}.families.{name}")


def benchmark() -> Dict[str, Any]:
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def cell_metrics(bench: Dict[str, Any], cell: str, trace: bool) -> List[Dict[str, Any]]:
    """The metrics of ``BENCHMARK.json`` that ``cell`` reports: its
    end-to-end metrics in an untraced run, its per-layer ones in a traced
    run (a metric with a ``workloads`` key only in the cells it lists)."""
    group = bench["per_layer"] if trace else bench["end_to_end"]
    return [m for m in group if "workloads" not in m or cell in m["workloads"]]
