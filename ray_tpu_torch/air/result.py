"""Result of a training/tuning run (parity: python/ray/air/result.py)."""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple


@dataclass
class Result:
    metrics: Optional[Dict[str, Any]]
    checkpoint: Optional[Any]  # ray_tpu_torch.train.Checkpoint
    error: Optional[Exception] = None
    path: Optional[str] = None
    metrics_dataframe: Optional[Any] = None
    best_checkpoints: Optional[List[Tuple[Any, Dict[str, Any]]]] = None
    _metrics_history: List[Dict[str, Any]] = field(default_factory=list)

    @property
    def config(self) -> Optional[Dict[str, Any]]:
        return (self.metrics or {}).get("config")

    def get_best_checkpoint(self, metric: str, mode: str = "max"):
        if not self.best_checkpoints:
            return self.checkpoint
        sign = 1 if mode == "max" else -1
        best = max(
            (c for c in self.best_checkpoints if metric in c[1]),
            key=lambda c: sign * c[1][metric],
            default=None,
        )
        return best[0] if best else self.checkpoint

    def __repr__(self):
        err = f", error={type(self.error).__name__}" if self.error else ""
        return f"Result(metrics={self.metrics}, path={self.path!r}{err})"
