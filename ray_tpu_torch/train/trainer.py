"""Trainers.

Counterpart: ``ray_tpu/train/trainer.py``. Analog of
`ray.train.base_trainer.BaseTrainer` (`python/ray/train/base_trainer.py:567`
fit) and `ray.train.data_parallel_trainer.DataParallelTrainer`
(`python/ray/train/data_parallel_trainer.py:25`, training_loop `:428`).
fit() drives the BackendExecutor directly (no Tune trial around it); Tune
wraps a trainer as a trainable instead (``tune/tuner.py``'s
``_trainer_to_fn``: a copy of the trainer per trial, its
``train_loop_config`` merged, its storage nested under the trial's).

`TorchTrainer` takes the place of the JAX package's `JaxTrainer` (the
reference's TorchTrainer, `train/torch/torch_trainer.py`): workers form a
torch.distributed process group (``TorchConfig``), and the loop averages
its gradients over a collective group (``GradientAverager`` on the host
backend, or ``collective.allreduce_coalesced`` on an NCCL group).
"""

from __future__ import annotations

import dataclasses
import inspect
import logging
from typing import Any, Callable, Dict, List, Optional, Tuple

from ray_tpu_torch.air.config import RunConfig, ScalingConfig
from ray_tpu_torch.train._checkpoint import Checkpoint
from ray_tpu_torch.train._internal.backend_executor import (
    BackendExecutor, TrainingFinished, TrainingWorkerError)
from ray_tpu_torch.train._internal.checkpoint_manager import \
    CheckpointManager
from ray_tpu_torch.train._internal.storage import (StorageContext,
                                                   make_experiment_name)
from ray_tpu_torch.train.backend import BackendConfig, TorchConfig

logger = logging.getLogger(__name__)


@dataclasses.dataclass
class Result:
    """Analog of `ray.train.Result` (`python/ray/train/result.py`)."""

    metrics: Optional[Dict[str, Any]]
    checkpoint: Optional[Checkpoint]
    path: str
    error: Optional[Exception] = None
    config: Optional[Dict[str, Any]] = None
    metrics_history: List[Dict[str, Any]] = dataclasses.field(
        default_factory=list)
    best_checkpoints: List[Tuple[Checkpoint, Dict[str, Any]]] = (
        dataclasses.field(default_factory=list))


class BaseTrainer:
    def __init__(
        self,
        *,
        scaling_config: Optional[ScalingConfig] = None,
        run_config: Optional[RunConfig] = None,
        resume_from_checkpoint: Optional[Checkpoint] = None,
    ):
        self.scaling_config = scaling_config or ScalingConfig()
        self.run_config = run_config or RunConfig()
        self.resume_from_checkpoint = resume_from_checkpoint

    def fit(self) -> Result:
        raise NotImplementedError


class DataParallelTrainer(BaseTrainer):
    def __init__(
        self,
        train_loop_per_worker: Callable,
        *,
        train_loop_config: Optional[Dict[str, Any]] = None,
        backend_config: Optional[BackendConfig] = None,
        scaling_config: Optional[ScalingConfig] = None,
        run_config: Optional[RunConfig] = None,
        datasets: Optional[Dict[str, Any]] = None,
        resume_from_checkpoint: Optional[Checkpoint] = None,
    ):
        super().__init__(scaling_config=scaling_config,
                         run_config=run_config,
                         resume_from_checkpoint=resume_from_checkpoint)
        self._train_loop = train_loop_per_worker
        self._train_loop_config = train_loop_config
        self._backend_config = backend_config or BackendConfig()
        self.datasets = datasets or {}
        self._loop_takes_config = (
            len(inspect.signature(train_loop_per_worker).parameters) > 0)

    # ------------------------------------------------------------------ fit

    def fit(self) -> Result:
        name = self.run_config.name or make_experiment_name(
            type(self).__name__.lower())
        storage = StorageContext(self.run_config.storage_path, name)
        storage.make_dirs()
        ckpt_manager = CheckpointManager(self.run_config.checkpoint_config)
        max_failures = self.run_config.failure_config.max_failures

        latest_checkpoint = self.resume_from_checkpoint
        checkpoint_index = 0
        metrics_history: List[Dict[str, Any]] = []
        last_metrics: Optional[Dict[str, Any]] = None
        error: Optional[Exception] = None
        failures = 0

        while True:
            executor = BackendExecutor(
                backend_config=self._backend_config,
                scaling_config=self.scaling_config,
                storage=storage,
                experiment_name=name,
                trial_name=name,
            )
            try:
                executor.start()
                executor.start_training(
                    self._wrapped_loop(),
                    (self._train_loop_config or {})
                    if self._loop_takes_config else None,
                    latest_checkpoint,
                    dataset_shards_per_worker=self._shard_datasets(),
                    checkpoint_index=checkpoint_index,
                )
                while True:
                    reports = executor.get_next_results()
                    checkpoint_index += 1
                    # rank 0's metrics are the run's metrics (reference
                    # semantics: session.py rank-0 reporting)
                    last_metrics = reports[0].metrics
                    metrics_history.append(last_metrics)
                    ckpt_paths = [
                        r.checkpoint_path for r in reports
                        if r.checkpoint_path
                    ]
                    if ckpt_paths:
                        ckpt = Checkpoint(ckpt_paths[0])
                        latest_checkpoint = ckpt
                        ckpt_manager.register_checkpoint(
                            ckpt, last_metrics or {}, checkpoint_index)
            except TrainingFinished:
                error = None
                break
            except TrainingWorkerError as e:
                failures += 1
                logger.warning("worker group failure %d: %s", failures, e)
                if max_failures >= 0 and failures > max_failures:
                    error = e
                    break
                latest_checkpoint = (ckpt_manager.latest_checkpoint
                                     or latest_checkpoint)
                logger.info(
                    "restarting worker group from %s",
                    latest_checkpoint.path if latest_checkpoint else "scratch")
            finally:
                executor.shutdown()

        return Result(
            metrics=last_metrics,
            checkpoint=ckpt_manager.latest_checkpoint or latest_checkpoint,
            path=storage.trial_fs_path,
            error=error,
            metrics_history=metrics_history,
            best_checkpoints=ckpt_manager.best_checkpoints,
        )

    def _wrapped_loop(self):
        return self._train_loop

    def _shard_datasets(self) -> Optional[List[Dict[str, Any]]]:
        """Split each dataset into per-worker shards.

        A `ray_tpu_torch.data.Dataset` (anything with `.streaming_split`)
        is split once by `streaming_split(n, equal=True)`, and each worker
        reads its shard through `train.get_dataset_shard`; anything else
        is passed through whole.
        """
        if not self.datasets:
            return None
        n = self.scaling_config.num_workers
        per_worker: List[Dict[str, Any]] = [{} for _ in range(n)]
        for dsname, ds in self.datasets.items():
            if hasattr(ds, "streaming_split"):
                # equal=True: lockstep SPMD loops need identical batch counts
                # per rank or the report barrier desynchronizes (reference
                # train ingest: data_config.py uses equal=True).
                shards = ds.streaming_split(n, equal=True)
            else:
                shards = [ds] * n
            for rank in range(n):
                per_worker[rank][dsname] = shards[rank]
        return per_worker


class TorchTrainer(DataParallelTrainer):
    """Data-parallel PyTorch training over worker actors (on their cards
    with ``ScalingConfig(use_gpu=True)``)."""

    def __init__(
        self,
        train_loop_per_worker: Callable,
        *,
        torch_config: Optional[TorchConfig] = None,
        scaling_config: Optional[ScalingConfig] = None,
        **kwargs,
    ):
        scaling_config = scaling_config or ScalingConfig()
        if torch_config is None:
            torch_config = TorchConfig(
                backend="nccl" if scaling_config.use_gpu else "gloo")
        super().__init__(
            train_loop_per_worker,
            backend_config=torch_config,
            scaling_config=scaling_config,
            **kwargs,
        )
