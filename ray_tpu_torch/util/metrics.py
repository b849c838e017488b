"""Application metrics: Counter / Gauge / Histogram.

Parity: python/ray/util/metrics.py over the reference's OpenCensus
registry (src/ray/stats/metric.h:104). TPU-native simplification: no
sidecar exporter chain — metric records batch through the client's
existing hub connection and aggregate in the hub's registry; scrape via
``ray_tpu_torch.util.metrics.snapshot()`` or render with
``prometheus_text()`` for a /metrics endpoint.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

_DEFAULT_HIST_BOUNDARIES = [
    0.001, 0.005, 0.01, 0.05, 0.1, 0.5, 1.0, 5.0, 10.0, 50.0, 100.0
]


class Metric:
    """Base: name + default tags; subclasses choose the aggregation."""

    _TYPE = "none"

    def __init__(
        self,
        name: str,
        description: str = "",
        tag_keys: Optional[Sequence[str]] = None,
    ):
        if not name:
            raise ValueError("metric name is required")
        self._name = name
        self._description = description
        self._tag_keys = tuple(tag_keys or ())
        self._default_tags: Dict[str, str] = {}

    def set_default_tags(self, tags: Dict[str, str]) -> "Metric":
        self._default_tags = dict(tags)
        return self

    @property
    def info(self) -> Dict:
        return {
            "name": self._name,
            "description": self._description,
            "tag_keys": self._tag_keys,
            "default_tags": dict(self._default_tags),
        }

    def _record(self, value: float, tags: Optional[Dict[str, str]], op: str,
                **extra):
        from .._private import protocol as P
        from .._private import worker

        merged = dict(self._default_tags)
        if tags:
            merged.update(tags)
        client = worker.get_client()
        client.send_async(
            P.METRIC_RECORD,
            dict(
                extra,
                name=self._name,
                type=self._TYPE,
                description=self._description,
                value=float(value),
                tags=tuple(sorted(merged.items())),
                op=op,
            ),
        )


class Counter(Metric):
    """Monotonic cumulative count (reference: metrics.Counter)."""

    _TYPE = "counter"

    def inc(self, value: float = 1.0, tags: Optional[Dict[str, str]] = None):
        if value <= 0:
            raise ValueError("Counter.inc value must be > 0")
        self._record(value, tags, "add")


class Gauge(Metric):
    """Last-value-wins (reference: metrics.Gauge)."""

    _TYPE = "gauge"

    def set(self, value: float, tags: Optional[Dict[str, str]] = None):
        self._record(value, tags, "set")


class Histogram(Metric):
    """Bucketed distribution (reference: metrics.Histogram)."""

    _TYPE = "histogram"

    def __init__(
        self,
        name: str,
        description: str = "",
        boundaries: Optional[Sequence[float]] = None,
        tag_keys: Optional[Sequence[str]] = None,
    ):
        super().__init__(name, description, tag_keys)
        bounds = [float(b) for b in (boundaries or _DEFAULT_HIST_BOUNDARIES)]
        # the registry buckets observations by FIRST boundary >= value in
        # list order, which is only a histogram if boundaries ascend; and
        # Prometheus le="..." labels assume positive finite bounds. An
        # unsorted list used to mis-bucket silently.
        if not bounds:
            raise ValueError("Histogram boundaries must be non-empty")
        if any(b <= 0 for b in bounds):
            raise ValueError(
                f"Histogram boundaries must be positive, got {bounds}"
            )
        if any(b2 <= b1 for b1, b2 in zip(bounds, bounds[1:])):
            raise ValueError(
                "Histogram boundaries must be sorted ascending with no "
                f"duplicates, got {bounds}"
            )
        self.boundaries = bounds

    def observe(self, value: float, tags: Optional[Dict[str, str]] = None):
        self._record(value, tags, "observe", boundaries=tuple(self.boundaries))

    @property
    def info(self) -> Dict:
        d = super().info
        d["boundaries"] = list(self.boundaries)
        return d


def snapshot() -> List[Dict]:
    """Current aggregated metrics from the hub registry."""
    from .._private import worker

    return worker.get_client().list_state("metrics")


def _sanitize_name(name: str) -> str:
    """Clamp a metric name to the exposition-format charset
    ``[a-zA-Z_:][a-zA-Z0-9_:]*`` (invalid runs become ``_``)."""
    import re

    name = re.sub(r"[^a-zA-Z0-9_:]", "_", name)
    if not name or not re.match(r"[a-zA-Z_:]", name[0]):
        name = "_" + name
    return name


def _sanitize_label_name(name: str) -> str:
    """Label names are stricter than metric names: no ``:`` allowed
    (``[a-zA-Z_][a-zA-Z0-9_]*``)."""
    import re

    name = re.sub(r"[^a-zA-Z0-9_]", "_", name)
    if not name or not re.match(r"[a-zA-Z_]", name[0]):
        name = "_" + name
    return name


def _escape_label(value) -> str:
    """Label-value escaping per the exposition format: backslash,
    double-quote, and newline must be escaped or a crafted tag value
    breaks (or injects) series in the scrape."""
    return (
        str(value)
        .replace("\\", "\\\\")
        .replace('"', '\\"')
        .replace("\n", "\\n")
    )


def _escape_help(text: str) -> str:
    return str(text).replace("\\", "\\\\").replace("\n", "\\n")


# last successful rendering: a scrape racing hub teardown (or hitting a
# partitioned head) serves stale-but-well-formed exposition instead of a
# 500 — Prometheus treats a failed scrape as a gap, but an exception
# here used to take the whole dashboard handler down with it
_last_exposition = ""


def prometheus_text() -> str:
    """Render the registry in Prometheus exposition format (the
    reference exports via its metrics agent to Prometheus; here the
    caller mounts this on whatever HTTP surface it likes). Degrades
    gracefully when the hub is unreachable: returns the last successful
    exposition (or an empty one) rather than raising."""
    global _last_exposition
    try:
        metrics = snapshot()
    except Exception:
        return _last_exposition
    lines: List[str] = []
    seen_help = set()
    for m in metrics:
        name = _sanitize_name(m["name"])
        if name not in seen_help:
            seen_help.add(name)
            if m.get("description"):
                lines.append(f"# HELP {name} {_escape_help(m['description'])}")
            kind = {"counter": "counter", "gauge": "gauge",
                    "histogram": "histogram"}.get(m["type"], "untyped")
            lines.append(f"# TYPE {name} {kind}")
        labels = ",".join(
            f'{_sanitize_label_name(k)}="{_escape_label(v)}"'
            for k, v in m["tags"]
        )
        suffix = "{" + labels + "}" if labels else ""
        if m["type"] == "histogram":
            acc = 0
            for bound, count in m["buckets"]:
                acc += count
                lb = ",".join(filter(None, [labels, f'le="{bound}"']))
                lines.append(f"{name}_bucket{{{lb}}} {acc}")
            lb = ",".join(filter(None, [labels, 'le="+Inf"']))
            lines.append(f"{name}_bucket{{{lb}}} {m['count']}")
            lines.append(f"{name}_sum{suffix} {m['sum']}")
            lines.append(f"{name}_count{suffix} {m['count']}")
        else:
            lines.append(f"{name}{suffix} {m['value']}")
    _last_exposition = "\n".join(lines) + "\n"
    return _last_exposition
