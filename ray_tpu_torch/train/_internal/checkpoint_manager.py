"""Top-k checkpoint retention.

Parity: python/ray/train/_internal/checkpoint_manager.py (register
reported checkpoints, keep num_to_keep best by score attribute, delete
the rest from storage).
"""

from __future__ import annotations

import os
import shutil
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

from ...air.config import CheckpointConfig
from .._checkpoint import Checkpoint


@dataclass
class _Tracked:
    checkpoint: Checkpoint
    metrics: Dict[str, Any]
    index: int


class CheckpointManager:
    def __init__(self, config: CheckpointConfig):
        self.config = config
        self._tracked: List[_Tracked] = []
        self._count = 0

    def register(self, checkpoint: Checkpoint, metrics: Dict[str, Any]) -> None:
        self._tracked.append(_Tracked(checkpoint, dict(metrics), self._count))
        self._count += 1
        self._enforce()

    def _score(self, t: _Tracked) -> Tuple:
        attr = self.config.checkpoint_score_attribute
        if attr is None:
            return (t.index,)  # recency
        sign = 1.0 if self.config.checkpoint_score_order == "max" else -1.0
        val = t.metrics.get(attr)
        if val is None:
            return (float("-inf"), t.index)
        return (sign * float(val), t.index)

    def _enforce(self) -> None:
        k = self.config.num_to_keep
        if k is None or len(self._tracked) <= k:
            return
        self._tracked.sort(key=self._score, reverse=True)
        keep, drop = self._tracked[:k], self._tracked[k:]
        # never delete the most recent checkpoint — it's the resume point
        latest = max(self._tracked, key=lambda t: t.index)
        if latest in drop:
            drop.remove(latest)
            if keep:
                worst = min(keep, key=self._score)
                keep.remove(worst)
                drop.append(worst)
            keep.append(latest)
        for t in drop:
            if os.path.isdir(t.checkpoint.path):
                shutil.rmtree(t.checkpoint.path, ignore_errors=True)
        self._tracked = sorted(keep, key=lambda t: t.index)

    @property
    def latest_checkpoint(self) -> Optional[Checkpoint]:
        if not self._tracked:
            return None
        return max(self._tracked, key=lambda t: t.index).checkpoint

    def best_checkpoint(
        self, metric: Optional[str] = None, mode: str = "max"
    ) -> Optional[Checkpoint]:
        if not self._tracked:
            return None
        attr = metric or self.config.checkpoint_score_attribute
        if attr is None:
            return self.latest_checkpoint
        sign = 1.0 if mode == "max" else -1.0
        scored = [t for t in self._tracked if attr in t.metrics]
        if not scored:
            return self.latest_checkpoint
        return max(scored, key=lambda t: sign * float(t.metrics[attr])).checkpoint

    @property
    def best_checkpoints(self) -> List[Tuple[Checkpoint, Dict[str, Any]]]:
        return [(t.checkpoint, t.metrics) for t in self._tracked]
