"""Per-worker training session.

Counterpart: ``ray_tpu/train/_internal/session.py``. Analog of
`ray.train._internal.session._TrainSession`
(`python/ray/train/_internal/session.py:110`, `report :666`,
`get_checkpoint :753`): the user's ``train_loop_per_worker`` runs on a side
thread; ``report(metrics, checkpoint)`` persists the checkpoint into trial
storage (worker-side upload, like the reference's StorageContext on
workers) and blocks until the driver has consumed the report — report is
the per-iteration barrier that paces every rank together.
"""

from __future__ import annotations

import dataclasses
import logging
import queue
import threading
import traceback
from typing import Any, Callable, Dict, Optional

from ray_tpu_torch.train._checkpoint import Checkpoint
from ray_tpu_torch.train._internal.storage import StorageContext

logger = logging.getLogger(__name__)

_session_lock = threading.Lock()
_session: Optional["_TrainSession"] = None


@dataclasses.dataclass
class TrainingReport:
    kind: str  # "report" | "done" | "error" | "timeout"
    metrics: Optional[Dict[str, Any]] = None
    checkpoint_path: Optional[str] = None  # persisted (storage) path
    error: Optional[str] = None
    final_return: Any = None


class _TrainSession:
    def __init__(
        self,
        train_fn: Callable[[], Any],
        world_rank: int,
        local_rank: int,
        world_size: int,
        local_world_size: int,
        node_rank: int,
        storage: StorageContext,
        experiment_name: str,
        trial_name: str,
        loaded_checkpoint: Optional[Checkpoint] = None,
        trial_info: Optional[Dict[str, Any]] = None,
        dataset_shards: Optional[Dict[str, Any]] = None,
    ):
        self.world_rank = world_rank
        self.local_rank = local_rank
        self.world_size = world_size
        self.local_world_size = local_world_size
        self.node_rank = node_rank
        self.storage = storage
        self.experiment_name = experiment_name
        self.trial_name = trial_name
        self.loaded_checkpoint = loaded_checkpoint
        self.trial_info = trial_info or {}
        self.dataset_shards = dataset_shards or {}
        # maxsize=1: report() blocks until the driver drains the previous
        # result — backpressure doubles as the cross-rank barrier.
        self._queue: "queue.Queue[TrainingReport]" = queue.Queue(maxsize=1)
        self._train_fn = train_fn
        self._thread: Optional[threading.Thread] = None
        self._finished = threading.Event()

    # ------------------------------------------------------------- lifecycle

    def start(self) -> None:
        def _run():
            try:
                ret = self._train_fn()
                self._queue.put(TrainingReport(kind="done", final_return=ret))
            except BaseException as e:  # surfaced to the driver, then re-raised
                logger.error("train fn failed on rank %d:\n%s",
                             self.world_rank, traceback.format_exc())
                self._queue.put(
                    TrainingReport(kind="error",
                                   error=f"{type(e).__name__}: {e}"))
            finally:
                self._finished.set()

        self._thread = threading.Thread(
            target=_run, daemon=True, name=f"train_fn_rank{self.world_rank}")
        self._thread.start()

    def next_report(self, timeout: Optional[float] = None) -> TrainingReport:
        """Driver-driven: block for the next report from the user loop.

        A slow step is NOT a failure: on timeout this returns a
        ``kind="timeout"`` report so the driver can simply re-poll instead
        of misclassifying the rank as dead (an empty queue must not consume
        a FailureConfig retry).
        """
        try:
            return self._queue.get(timeout=timeout)
        except queue.Empty:
            return TrainingReport(kind="timeout")

    def finished(self) -> bool:
        return self._finished.is_set()

    # ------------------------------------------------------------- user API

    def report(self, metrics: Dict[str, Any],
               checkpoint: Optional[Checkpoint] = None) -> None:
        persisted_path = None
        if checkpoint is not None:
            persisted = self.storage.persist_current_checkpoint(checkpoint)
            persisted_path = persisted.path
            self.loaded_checkpoint = persisted
        # every rank advances its index in lockstep (report is a barrier),
        # so rank-local indices agree without coordination.
        self.storage.advance_checkpoint_index()
        self._queue.put(
            TrainingReport(kind="report", metrics=dict(metrics),
                           checkpoint_path=persisted_path))

    def get_checkpoint(self) -> Optional[Checkpoint]:
        return self.loaded_checkpoint

    def get_dataset_shard(self, name: str):
        shard = self.dataset_shards.get(name)
        if shard is None:
            raise KeyError(
                f"no dataset shard named {name!r} was passed to the trainer")
        return shard


# ------------------------------------------------------------------ context


class TrainContext:
    """`ray.train.get_context()` analog (`python/ray/train/context.py`)."""

    def _s(self) -> _TrainSession:
        s = get_session()
        if s is None:
            raise RuntimeError(
                "TrainContext is only available inside a training worker")
        return s

    def get_world_size(self) -> int:
        return self._s().world_size

    def get_world_rank(self) -> int:
        return self._s().world_rank

    def get_local_rank(self) -> int:
        return self._s().local_rank

    def get_local_world_size(self) -> int:
        return self._s().local_world_size

    def get_node_rank(self) -> int:
        return self._s().node_rank

    def get_experiment_name(self) -> str:
        return self._s().experiment_name

    def get_trial_name(self) -> str:
        return self._s().trial_name

    def get_trial_info(self) -> Dict[str, Any]:
        return dict(self._s().trial_info)

    def get_storage(self) -> StorageContext:
        return self._s().storage


def init_session(**kwargs) -> _TrainSession:
    global _session
    with _session_lock:
        if _session is not None:
            raise RuntimeError("a train session is already active")
        _session = _TrainSession(**kwargs)
        return _session


def get_session() -> Optional[_TrainSession]:
    return _session


def shutdown_session() -> None:
    global _session
    with _session_lock:
        _session = None


# ----------------------------------------------------- public free functions


def report(metrics: Dict[str, Any],
           checkpoint: Optional[Checkpoint] = None) -> None:
    s = get_session()
    if s is None:
        raise RuntimeError("train.report() called outside a training worker")
    s.report(metrics, checkpoint=checkpoint)


def get_checkpoint() -> Optional[Checkpoint]:
    s = get_session()
    if s is None:
        raise RuntimeError(
            "train.get_checkpoint() called outside a training worker")
    return s.get_checkpoint()


def get_context() -> TrainContext:
    return TrainContext()


def get_dataset_shard(name: str = "train"):
    s = get_session()
    if s is None:
        raise RuntimeError(
            "train.get_dataset_shard() called outside a training worker")
    return s.get_dataset_shard(name)
