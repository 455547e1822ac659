"""Top-k checkpoint retention.

Counterpart: ``ray_tpu/train/_internal/checkpoint_manager.py``. Analog of
`ray.train._internal.checkpoint_manager.CheckpointManager`
(`python/ray/train/_internal/checkpoint_manager.py`): orders reported
checkpoints by a score attribute, keeps ``num_to_keep``, deletes evicted
checkpoint directories from storage.
"""

from __future__ import annotations

import logging
import shutil
from typing import Any, Dict, List, Optional, Tuple

from ray_tpu_torch.air.config import CheckpointConfig
from ray_tpu_torch.train._checkpoint import Checkpoint

logger = logging.getLogger(__name__)


class _TrackedCheckpoint:
    def __init__(self, checkpoint: Checkpoint, metrics: Dict[str, Any],
                 index: int):
        self.checkpoint = checkpoint
        self.metrics = metrics
        self.index = index


class CheckpointManager:
    def __init__(self, checkpoint_config: Optional[CheckpointConfig] = None):
        self._config = checkpoint_config or CheckpointConfig()
        self._checkpoints: List[_TrackedCheckpoint] = []
        self._latest: Optional[_TrackedCheckpoint] = None

    def register_checkpoint(
        self, checkpoint: Checkpoint, metrics: Dict[str, Any], index: int
    ) -> None:
        tracked = _TrackedCheckpoint(checkpoint, metrics, index)
        self._latest = tracked
        self._checkpoints.append(tracked)
        self._enforce_retention()

    def _score(self, t: _TrackedCheckpoint) -> float:
        attr = self._config.checkpoint_score_attribute
        if attr is None:
            return float(t.index)  # recency
        try:
            v = float(t.metrics[attr])
        except (KeyError, TypeError, ValueError):
            logger.warning(
                "checkpoint %d has no numeric metric %r; scoring lowest",
                t.index, attr)
            return float("-inf")
        return v if self._config.checkpoint_score_order == "max" else -v

    def _enforce_retention(self) -> None:
        keep = self._config.num_to_keep
        if keep is None or len(self._checkpoints) <= keep:
            return
        ranked = sorted(self._checkpoints, key=self._score, reverse=True)
        survivors = ranked[:keep]
        # the latest checkpoint is always kept (needed for resume)
        if self._latest is not None and self._latest not in survivors:
            survivors[-1] = self._latest
        for t in self._checkpoints:
            if t not in survivors:
                shutil.rmtree(t.checkpoint.path, ignore_errors=True)
        self._checkpoints = [t for t in self._checkpoints if t in survivors]

    @property
    def latest_checkpoint(self) -> Optional[Checkpoint]:
        return self._latest.checkpoint if self._latest else None

    @property
    def best_checkpoint(self) -> Optional[Checkpoint]:
        if not self._checkpoints:
            return None
        return max(self._checkpoints, key=self._score).checkpoint

    @property
    def best_checkpoints(self) -> List[Tuple[Checkpoint, Dict[str, Any]]]:
        ranked = sorted(self._checkpoints, key=self._score, reverse=True)
        return [(t.checkpoint, t.metrics) for t in ranked]
