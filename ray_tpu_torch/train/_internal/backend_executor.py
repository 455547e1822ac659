"""Drives a worker group through one training run.

Counterpart: ``ray_tpu/train/_internal/backend_executor.py``. Analog of
`ray.train._internal.backend_executor.BackendExecutor`
(`python/ray/train/_internal/backend_executor.py:124` start, `:436`
start_training): starts the gang, runs backend setup, ships the session to
every worker, then pumps reports until all ranks finish. Worker death
raises TrainingWorkerError; the trainer layer decides whether to restart
(FailureConfig).
"""

from __future__ import annotations

import logging
from typing import Any, Callable, Dict, List, Optional

import ray_tpu_torch as rt
from ray_tpu_torch.air.config import ScalingConfig
from ray_tpu_torch.train._checkpoint import Checkpoint
from ray_tpu_torch.train._internal.session import TrainingReport
from ray_tpu_torch.train._internal.storage import StorageContext
from ray_tpu_torch.train._internal.worker_group import WorkerGroup
from ray_tpu_torch.train.backend import BackendConfig

logger = logging.getLogger(__name__)


class TrainingWorkerError(RuntimeError):
    """A worker failed (actor death or user-code exception)."""


class TrainingFinished(Exception):
    """All ranks returned from the user loop."""

    def __init__(self, finals: List[Any]):
        self.finals = finals
        super().__init__("training finished")


class BackendExecutor:
    def __init__(
        self,
        backend_config: BackendConfig,
        scaling_config: ScalingConfig,
        storage: StorageContext,
        experiment_name: str,
        trial_name: str,
    ):
        self._backend_config = backend_config
        self._backend = backend_config.backend_cls()
        self._scaling = scaling_config
        self._storage = storage
        self._experiment_name = experiment_name
        self._trial_name = trial_name
        self.worker_group: Optional[WorkerGroup] = None

    def start(self) -> None:
        self.worker_group = WorkerGroup(
            num_workers=self._scaling.num_workers,
            resources_per_worker=self._scaling._worker_bundle,
            placement_strategy=self._scaling.placement_strategy,
        )
        self.worker_group.start()
        self._backend.on_start(self.worker_group, self._backend_config)

    def start_training(
        self,
        train_fn: Callable[[Optional[Dict]], Any],
        train_fn_config: Optional[Dict[str, Any]],
        checkpoint: Optional[Checkpoint],
        dataset_shards_per_worker: Optional[List[Dict[str, Any]]] = None,
        checkpoint_index: int = 0,
    ) -> None:
        assert self.worker_group is not None, "call start() first"
        self._backend.on_training_start(self.worker_group,
                                        self._backend_config)
        import functools

        refs = []
        for w in self.worker_group.workers:
            storage = StorageContext(
                self._storage.storage_path,
                self._storage.experiment_dir_name,
                self._storage.trial_dir_name,
            )
            storage.current_checkpoint_index = checkpoint_index
            storage.make_dirs()
            shards = (dataset_shards_per_worker[w.world_rank]
                      if dataset_shards_per_worker else {})
            kwargs = dict(
                train_fn=functools.partial(train_fn, train_fn_config)
                if train_fn_config is not None else train_fn,
                world_rank=w.world_rank,
                local_rank=w.local_rank,
                world_size=len(self.worker_group),
                local_world_size=w.local_world_size,
                node_rank=w.node_rank,
                storage=storage,
                experiment_name=self._experiment_name,
                trial_name=self._trial_name,
                loaded_checkpoint=checkpoint,
                dataset_shards=shards,
            )
            refs.append(w.actor.start_session.remote(kwargs))
        rt.get(refs)

    def get_next_results(self,
                         poll_interval: float = 60.0) -> List[TrainingReport]:
        """One synchronized round: one report per rank.

        Ranks are polled with a short RPC timeout; a rank whose step/ckpt
        takes longer just returns ``kind="timeout"`` and is re-polled, so a
        slow step is never misclassified as a death (only an actual actor
        death raises TrainingWorkerError). Raises TrainingFinished when
        every rank's loop returned.
        """
        assert self.worker_group is not None
        workers = self.worker_group.workers
        reports: List[Optional[TrainingReport]] = [None] * len(workers)
        pending = list(range(len(workers)))
        while pending:
            refs = [
                workers[i].actor.next_report.remote(poll_interval)
                for i in pending
            ]
            try:
                got: List[TrainingReport] = rt.get(refs)
            except Exception as e:
                raise TrainingWorkerError(
                    f"training worker died: {e}") from e
            still = []
            for i, rep in zip(pending, got):
                if rep.kind == "timeout":
                    still.append(i)
                else:
                    reports[i] = rep
                    # Fail fast: one rank erroring can leave SPMD peers
                    # blocked in a collective forever — don't wait for them.
                    if rep.kind == "error":
                        raise TrainingWorkerError(
                            f"rank {i} failed: {rep.error}")
            pending = still
        errors = [r for r in reports if r.kind == "error"]
        if errors:
            raise TrainingWorkerError(
                f"{len(errors)}/{len(reports)} ranks failed: "
                + "; ".join(r.error for r in errors[:3]))
        done = [r for r in reports if r.kind == "done"]
        if done:
            if len(done) != len(reports):
                # some ranks returned while others reported — drain mismatch
                raise TrainingWorkerError(
                    "ranks desynchronized: some finished while others "
                    "are still reporting (uneven report() counts)")
            raise TrainingFinished([r.final_return for r in reports])
        return reports

    def shutdown(self) -> None:
        if self.worker_group is None:
            return
        try:
            self._backend.on_shutdown(self.worker_group, self._backend_config)
        except Exception:
            pass
        try:
            for w in self.worker_group.workers:
                w.actor.end_session.remote()
        except Exception:
            pass
        self.worker_group.shutdown()
        self.worker_group = None
