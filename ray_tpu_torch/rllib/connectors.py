"""ConnectorV2: composable env→module / learner transform pipelines.

Parity: python/ray/rllib/connectors/ (connector_v2.py ConnectorV2 +
connector_pipeline_v2.py) — small reusable pieces that transform
batches on their way from the env into the module (obs preprocessing,
frame stacking) and from the rollout into the learner, instead of
per-algorithm hand-rolled preprocessing.

TPU-native shape: a connector maps a COLUMN BATCH (dict of numpy
arrays, batched across all (env, agent) pairs of one module) to a new
column batch. Keeping the transform outside jit and returning plain
arrays preserves the runner's one-jitted-forward-per-module property;
anything shape-static a connector does could later fold into the
jitted program itself.
"""

from __future__ import annotations

from collections import deque
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

__all__ = [
    "ConnectorV2",
    "ConnectorPipelineV2",
    "FlattenObservations",
    "NormalizeObservations",
    "FrameStackObservations",
]


class ConnectorV2:
    """One transform stage (reference: connector_v2.py:66).

    `batch` is a dict of columns — at minimum {"obs": (B, ...)}; the
    context carries `keys` (the (env_idx, agent_id) pair per row, for
    stateful per-agent connectors) and `module_id`."""

    def __call__(self, batch: Dict[str, np.ndarray], *,
                 keys: Optional[Sequence[Tuple[int, Any]]] = None,
                 module_id: str = "default_policy",
                 **kwargs) -> Dict[str, np.ndarray]:
        raise NotImplementedError

    # output feature size for a given input size; pipelines use this to
    # derive the module's obs_dim (reference: connectors recompute the
    # observation space)
    def output_dim(self, in_dim: int) -> int:
        return in_dim

    def reset(self) -> None:
        """Drop per-episode state (called between episodes/fragments
        where relevant)."""

    def drop(self, keys: Sequence[Tuple[int, Any]]) -> None:
        """Drop per-(env, agent) state for finished episodes."""


class ConnectorPipelineV2(ConnectorV2):
    """Ordered composition (reference: connector_pipeline_v2.py)."""

    def __init__(self, connectors: Optional[List[ConnectorV2]] = None):
        self.connectors = list(connectors or [])

    def append(self, connector: ConnectorV2) -> "ConnectorPipelineV2":
        self.connectors.append(connector)
        return self

    def __call__(self, batch, **ctx):
        for c in self.connectors:
            batch = c(batch, **ctx)
        return batch

    def output_dim(self, in_dim: int) -> int:
        for c in self.connectors:
            in_dim = c.output_dim(in_dim)
        return in_dim

    def reset(self) -> None:
        for c in self.connectors:
            c.reset()

    def drop(self, keys) -> None:
        for c in self.connectors:
            c.drop(keys)


class FlattenObservations(ConnectorV2):
    """(B, ...) obs -> (B, D) (reference:
    connectors/env_to_module/flatten_observations.py)."""

    def __call__(self, batch, **ctx):
        obs = np.asarray(batch["obs"])
        return dict(batch, obs=obs.reshape(obs.shape[0], -1))


class NormalizeObservations(ConnectorV2):
    """Running mean/std normalization (reference:
    connectors/env_to_module/mean_std_filter.py — Welford-style running
    moments, updated on every batch that flows through)."""

    def __init__(self, clip: float = 10.0, update: bool = True):
        self.clip = clip
        self.update = update
        self._count = 0.0
        self._mean: Optional[np.ndarray] = None
        self._m2: Optional[np.ndarray] = None

    def __call__(self, batch, *, peek: bool = False, **ctx):
        obs = np.asarray(batch["obs"], np.float32)
        flat = obs.reshape(obs.shape[0], -1)
        if self.update and not peek and len(flat):
            if self._mean is None:
                self._mean = np.zeros(flat.shape[1], np.float64)
                # zeros, not ones: _m2 is the running sum of squared
                # deviations — a ones seed adds a phantom unit of
                # variance per feature and biases early std estimates
                # upward (GL006)
                self._m2 = np.zeros(flat.shape[1], np.float64)
            # batched Chan's parallel-moments merge: one vectorized
            # update per batch instead of a per-row Python loop (this
            # runs in the rollout hot path)
            nb = float(len(flat))
            b_mean = flat.mean(axis=0, dtype=np.float64)
            b_m2 = ((flat - b_mean) ** 2).sum(axis=0, dtype=np.float64)
            delta = b_mean - self._mean
            tot = self._count + nb
            self._mean += delta * (nb / tot)
            self._m2 += b_m2 + delta**2 * (self._count * nb / tot)
            self._count = tot
        if self._mean is None or self._count < 2:
            return dict(batch, obs=flat)
        std = np.sqrt(self._m2 / max(self._count - 1.0, 1.0)) + 1e-8
        out = np.clip(
            (flat - self._mean) / std, -self.clip, self.clip
        ).astype(np.float32)
        return dict(batch, obs=out)

    def state(self) -> dict:
        return {"count": self._count, "mean": self._mean, "m2": self._m2}


class FrameStackObservations(ConnectorV2):
    """Stack the last k observations per (env, agent) along the feature
    axis (reference: connectors/env_to_module/frame_stacking.py). Rows
    early in an episode repeat the first frame."""

    def __init__(self, num_frames: int = 4):
        if num_frames < 1:
            raise ValueError("num_frames must be >= 1")
        self.k = num_frames
        self._hist: Dict[Tuple[Any, Any], deque] = {}

    def __call__(self, batch, *, keys=None, peek: bool = False, **ctx):
        obs = np.asarray(batch["obs"], np.float32)
        flat = obs.reshape(obs.shape[0], -1)
        if keys is None:
            keys = [(0, i) for i in range(flat.shape[0])]
        rows = []
        for key, row in zip(keys, flat):
            h = self._hist.get(key)
            if peek:
                # bootstrap transforms must not advance episode state
                frames = (
                    [row] * self.k if h is None
                    else list(h)[1:] + [row]
                )
                rows.append(np.concatenate(frames))
                continue
            if h is None:
                h = self._hist[key] = deque(
                    [row] * self.k, maxlen=self.k
                )
            else:
                h.append(row)
            rows.append(np.concatenate(list(h)))
        return dict(batch, obs=np.stack(rows))

    def output_dim(self, in_dim: int) -> int:
        return in_dim * self.k

    def reset(self) -> None:
        self._hist.clear()

    def drop(self, keys) -> None:
        for key in keys:
            self._hist.pop(key, None)
