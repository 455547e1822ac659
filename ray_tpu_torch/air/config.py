"""Shared run/scaling/failure/checkpoint configs.

Counterpart: ``ray_tpu/air/config.py``. Analog of the reference's
``ray.air.config`` dataclasses (`python/ray/air/config.py`:
ScalingConfig/RunConfig/FailureConfig/CheckpointConfig). The JAX package's
``use_tpu``/``tpus_per_worker`` become ``use_gpu``/``gpus_per_worker``, in
whole cards as the runtime hands them out. Its slice ``topology`` (a gang
label for a TPU pod slice) has no counterpart on a node of cards and is
left out, and so are the fields that nothing reads (``total_workers``;
``RunConfig``'s ``verbose``, ``log_to_file``, ``callbacks``).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Dict, List, Optional


@dataclasses.dataclass
class ScalingConfig:
    """How many training workers and what each one holds.

    A worker is one process; with ``use_gpu`` it is leased
    ``gpus_per_worker`` whole cards (default 1), which its process sees in
    ``CUDA_VISIBLE_DEVICES``. ``num_workers`` is the world size of the
    process group the backend assembles.
    """

    num_workers: int = 1
    use_gpu: bool = False
    #: whole cards each worker drives (None: 1 with use_gpu; 0: none
    #: reserved, the worker sees no card)
    gpus_per_worker: Optional[int] = None
    resources_per_worker: Optional[Dict[str, float]] = None
    placement_strategy: str = "PACK"
    #: what a Tune trial's own process holds (bundle 0 of its gang)
    trainer_resources: Optional[Dict[str, float]] = None

    def __post_init__(self):
        if self.num_workers < 1:
            raise ValueError("num_workers must be >= 1")
        if self.gpus_per_worker is not None and (
                self.gpus_per_worker < 0
                or self.gpus_per_worker != int(self.gpus_per_worker)):
            raise ValueError(
                "gpus_per_worker must be a whole number of cards >= 0")

    @property
    def _worker_bundle(self) -> Dict[str, float]:
        bundle: Dict[str, float] = {"CPU": 1.0}
        if self.resources_per_worker:
            bundle.update(
                {k: float(v) for k, v in self.resources_per_worker.items()}
            )
        if self.use_gpu and "GPU" not in bundle:
            per = (int(self.gpus_per_worker)
                   if self.gpus_per_worker is not None else 1)
            if per > 0:
                bundle["GPU"] = float(per)
        return bundle

    def as_placement_group_bundles(self) -> List[Dict[str, float]]:
        return [dict(self._worker_bundle) for _ in range(self.num_workers)]


@dataclasses.dataclass
class FailureConfig:
    """Retry budget for a whole run (`air/config.py` FailureConfig).

    ``max_failures``: 0 = no retries, n = retry up to n times, -1 = retry
    forever. A failure means the worker group died; recovery restarts the
    gang and resumes from the latest persisted checkpoint.
    """

    max_failures: int = 0


@dataclasses.dataclass
class CheckpointConfig:
    """Retention policy (`air/config.py` CheckpointConfig)."""

    num_to_keep: Optional[int] = None
    checkpoint_score_attribute: Optional[str] = None
    checkpoint_score_order: str = "max"

    def __post_init__(self):
        if self.num_to_keep is not None and self.num_to_keep <= 0:
            raise ValueError("num_to_keep must be positive or None")
        if self.checkpoint_score_order not in ("max", "min"):
            raise ValueError("checkpoint_score_order must be 'max' or 'min'")


@dataclasses.dataclass
class RunConfig:
    """Experiment-level settings (`air/config.py` RunConfig)."""

    name: Optional[str] = None
    storage_path: Optional[str] = None
    failure_config: Optional[FailureConfig] = None
    checkpoint_config: Optional[CheckpointConfig] = None
    #: tune stop criteria: {"metric": threshold} — a trial stops once any
    #: reported metric reaches its threshold (reference RunConfig.stop)
    stop: Optional[Dict[str, Any]] = None

    def __post_init__(self):
        if self.storage_path is None:
            self.storage_path = os.path.join(
                os.path.expanduser("~"), "ray_tpu_torch_results"
            )
        if self.failure_config is None:
            self.failure_config = FailureConfig()
        if self.checkpoint_config is None:
            self.checkpoint_config = CheckpointConfig()
