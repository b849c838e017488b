"""Jupyter HTML reprs.

Parity: python/ray/widgets/ — the reference templates HTML cards for
``ray.init()`` context and datasets (widgets/render.py Template). Same
idea, no template files: small helpers that subsystems call from
``_repr_html_``.
"""

from __future__ import annotations

from html import escape
from typing import Any, Dict, List, Sequence

_CARD = (
    '<div style="border:1px solid #ddd;border-radius:6px;padding:10px 14px;'
    'display:inline-block;font-family:monospace;font-size:12px">'
    "<b>{title}</b>{body}</div>"
)


def table_html(rows: Dict[str, Any]) -> str:
    trs = "".join(
        f"<tr><td style='padding-right:12px;color:#666'>{escape(str(k))}</td>"
        f"<td>{escape(str(v))}</td></tr>"
        for k, v in rows.items()
    )
    return f"<table>{trs}</table>"


def card_html(title: str, rows: Dict[str, Any]) -> str:
    return _CARD.format(title=escape(title), body=table_html(rows))


def dataset_html(name: str, count, schema_names: Sequence[str], extra: Dict[str, Any]) -> str:
    rows: Dict[str, Any] = {"num_rows": count if count is not None else "?"}
    rows["schema"] = ", ".join(schema_names) if schema_names else "unknown"
    rows.update(extra)
    return card_html(name, rows)
