"""Trial bookkeeping (analog of `python/ray/tune/experiment/trial.py`).

Counterpart: ``ray_tpu/tune/trial.py``."""

from __future__ import annotations

import dataclasses
import uuid
from typing import Any, Dict, List, Optional

from ray_tpu_torch.train._checkpoint import Checkpoint

PENDING = "PENDING"
RUNNING = "RUNNING"
PAUSED = "PAUSED"          # released its actor; resumable from checkpoint
TERMINATED = "TERMINATED"
ERROR = "ERROR"


@dataclasses.dataclass
class Trial:
    config: Dict[str, Any]
    trial_id: str = dataclasses.field(
        default_factory=lambda: uuid.uuid4().hex[:8])
    status: str = PENDING
    last_result: Optional[Dict[str, Any]] = None
    metrics_history: List[Dict[str, Any]] = dataclasses.field(
        default_factory=list)
    error: Optional[str] = None
    num_failures: int = 0
    iteration: int = 0
    checkpoint_index: int = 0
    latest_checkpoint_path: Optional[str] = None
    resources: Dict[str, float] = dataclasses.field(
        default_factory=lambda: {"CPU": 1.0})

    @property
    def latest_checkpoint(self) -> Optional[Checkpoint]:
        if self.latest_checkpoint_path:
            return Checkpoint(self.latest_checkpoint_path)
        return None

    def is_finished(self) -> bool:
        return self.status in (TERMINATED, ERROR)

    def to_json(self) -> Dict[str, Any]:
        return {
            "trial_id": self.trial_id,
            "config": self.config,
            "status": self.status,
            "last_result": self.last_result,
            "metrics_history": self.metrics_history,
            "error": self.error,
            "num_failures": self.num_failures,
            "iteration": self.iteration,
            "checkpoint_index": self.checkpoint_index,
            "latest_checkpoint_path": self.latest_checkpoint_path,
            "resources": self.resources,
        }

    @classmethod
    def from_json(cls, d: Dict[str, Any]) -> "Trial":
        return cls(**d)
