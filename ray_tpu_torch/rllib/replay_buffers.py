"""Replay buffers (reference: rllib/utils/replay_buffers/).

Ring-buffer storage in preallocated numpy arrays (O(1) add, vectorized
uniform sampling) — the TPU-friendly layout: sample() returns contiguous
arrays that device_put straight into the jitted learner.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np


class ReplayBuffer:
    """Uniform-sampling FIFO replay (reference: ReplayBuffer /
    EpisodeReplayBuffer storage semantics)."""

    def __init__(self, capacity: int, seed: Optional[int] = None):
        self.capacity = capacity
        self._arrays: Optional[Dict[str, np.ndarray]] = None
        self._next = 0
        self._size = 0
        self._rng = np.random.default_rng(seed)

    def __len__(self) -> int:
        return self._size

    def add(self, batch: Dict[str, np.ndarray]) -> None:
        """Add a batch of transitions {key: (N, ...)}."""
        n = len(next(iter(batch.values())))
        if self._arrays is None:
            self._arrays = {
                k: np.zeros((self.capacity, *np.asarray(v).shape[1:]),
                            np.asarray(v).dtype)
                for k, v in batch.items()
            }
        for k, v in batch.items():
            v = np.asarray(v)
            idx = (self._next + np.arange(n)) % self.capacity
            self._arrays[k][idx] = v
        self._next = (self._next + n) % self.capacity
        self._size = min(self.capacity, self._size + n)

    def sample(self, batch_size: int) -> Dict[str, np.ndarray]:
        if self._size == 0:
            raise ValueError("cannot sample from an empty buffer")
        idx = self._rng.integers(0, self._size, size=batch_size)
        return {k: a[idx] for k, a in self._arrays.items()}


class PrioritizedReplayBuffer(ReplayBuffer):
    """Proportional prioritized replay (Schaul et al.; reference:
    rllib PrioritizedReplayBuffer). Priorities default to the max seen
    so new transitions are sampled at least once."""

    def __init__(self, capacity: int, alpha: float = 0.6,
                 seed: Optional[int] = None):
        super().__init__(capacity, seed)
        self.alpha = alpha
        self._prios = np.zeros(capacity, np.float64)
        self._max_prio = 1.0
        self._last_idx: Optional[np.ndarray] = None

    def add(self, batch: Dict[str, np.ndarray]) -> None:
        n = len(next(iter(batch.values())))
        idx = (self._next + np.arange(n)) % self.capacity
        super().add(batch)
        self._prios[idx] = self._max_prio

    def sample(self, batch_size: int, beta: float = 0.4) -> Dict[str, np.ndarray]:
        if self._size == 0:
            raise ValueError("cannot sample from an empty buffer")
        p = self._prios[: self._size] ** self.alpha
        p = p / p.sum()
        idx = self._rng.choice(self._size, size=batch_size, p=p)
        self._last_idx = idx
        out = {k: a[idx] for k, a in self._arrays.items()}
        weights = (self._size * p[idx]) ** (-beta)
        out["weights"] = (weights / weights.max()).astype(np.float32)
        return out

    def update_priorities(self, td_errors: np.ndarray, eps: float = 1e-6) -> None:
        assert self._last_idx is not None, "sample() before update_priorities()"
        prios = np.abs(td_errors) + eps
        self._prios[self._last_idx] = prios
        self._max_prio = max(self._max_prio, float(prios.max()))
