"""Replay buffers for off-policy algorithms.

Counterpart: ``ray_tpu/rllib/utils/replay_buffers.py``, copied: host numpy
storage, columnar (not per-sample python objects), so sampling produces
batches ready to copy to the card in one transfer per column, and a
proportional prioritized variant with importance weights. The same seed
draws the same rows as the JAX package's buffers.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np


class ReplayBuffer:
    """Uniform FIFO replay over columnar transition batches.

    `add` takes a dict of equal-length arrays (one row per transition);
    `sample(n)` returns a dict batch drawn uniformly with replacement.
    """

    def __init__(self, capacity: int = 100_000, seed: Optional[int] = None):
        self.capacity = int(capacity)
        self._store: Dict[str, np.ndarray] = {}
        self._next = 0
        self._size = 0
        self._rng = np.random.default_rng(seed)

    def __len__(self) -> int:
        return self._size

    def add(self, batch: Dict[str, np.ndarray]) -> None:
        n = len(next(iter(batch.values())))
        if not self._store:
            for k, v in batch.items():
                v = np.asarray(v)
                self._store[k] = np.zeros((self.capacity,) + v.shape[1:],
                                          v.dtype)
        for i in range(0, n, self.capacity):
            chunk = {k: np.asarray(v)[i:i + self.capacity]
                     for k, v in batch.items()}
            self._add_chunk(chunk)

    def _add_chunk(self, batch: Dict[str, np.ndarray]) -> int:
        n = len(next(iter(batch.values())))
        idx = (self._next + np.arange(n)) % self.capacity
        for k, v in batch.items():
            self._store[k][idx] = np.asarray(v)
        self._next = int((self._next + n) % self.capacity)
        self._size = min(self._size + n, self.capacity)
        return idx

    def sample(self, num_items: int) -> Dict[str, np.ndarray]:
        assert self._size > 0, "buffer empty"
        idx = self._rng.integers(0, self._size, num_items)
        return {k: v[idx] for k, v in self._store.items()}

    def get_state(self) -> Dict[str, Any]:
        return {"store": {k: v[:self._size].copy()
                          for k, v in self._store.items()},
                "next": self._next, "size": self._size}

    def set_state(self, state: Dict[str, Any]) -> None:
        self._store = {}
        if state["size"]:
            self.add({k: v for k, v in state["store"].items()})
        self._next = state["next"] % self.capacity
        self._size = min(state["size"], self.capacity)


class PrioritizedReplayBuffer(ReplayBuffer):
    """Proportional prioritized replay (Schaul et al. 2016).

    Priorities are held in a flat array and sampled with cumulative-sum
    inverse transform (O(n) per sample batch via np.searchsorted on the
    cumsum — simpler than a segment tree and fast enough at 1e6 rows).
    `sample` additionally returns `weights` (importance-sampling, max-
    normalized) and `batch_indexes` for `update_priorities`.
    """

    def __init__(self, capacity: int = 100_000, alpha: float = 0.6,
                 seed: Optional[int] = None):
        super().__init__(capacity, seed)
        assert alpha >= 0
        self._alpha = alpha
        self._priorities = np.zeros((self.capacity,), np.float64)
        self._max_priority = 1.0

    def _add_chunk(self, batch: Dict[str, np.ndarray]) -> np.ndarray:
        idx = super()._add_chunk(batch)
        self._priorities[idx] = self._max_priority ** self._alpha
        return idx

    def sample(self, num_items: int,
               beta: float = 0.4) -> Dict[str, np.ndarray]:
        assert self._size > 0, "buffer empty"
        pri = self._priorities[:self._size]
        cum = np.cumsum(pri)
        mass = self._rng.random(num_items) * cum[-1]
        idx = np.minimum(np.searchsorted(cum, mass), self._size - 1)
        probs = pri[idx] / cum[-1]
        weights = (self._size * probs) ** (-beta)
        weights = weights / weights.max()
        out = {k: v[idx] for k, v in self._store.items()}
        out["weights"] = weights.astype(np.float32)
        out["batch_indexes"] = idx
        return out

    def update_priorities(self, idx: np.ndarray,
                          priorities: np.ndarray) -> None:
        priorities = np.abs(np.asarray(priorities, np.float64)) + 1e-6
        self._priorities[idx] = priorities ** self._alpha
        self._max_priority = max(self._max_priority,
                                 float(priorities.max()))
