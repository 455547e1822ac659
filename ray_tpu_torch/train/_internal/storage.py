"""Experiment/trial storage layout.

Counterpart: ``ray_tpu/train/_internal/storage.py``. Analog of
`ray.train._internal.storage.StorageContext`
(`python/ray/train/_internal/storage.py`): owns the
``storage_path/experiment_name/trial_dir`` layout and persists worker
checkpoints into it. Filesystem only for now (the nodes share one, or each
writes its own ranks' files); the persist step is a tree merge so files
from different ranks land in one checkpoint directory.
"""

from __future__ import annotations

import os
import time
from typing import Optional

from ray_tpu_torch.train._checkpoint import Checkpoint, _merge_tree


class StorageContext:
    def __init__(
        self,
        storage_path: str,
        experiment_dir_name: str,
        trial_dir_name: Optional[str] = None,
    ):
        self.storage_path = os.path.abspath(os.path.expanduser(storage_path))
        self.experiment_dir_name = experiment_dir_name
        self.trial_dir_name = trial_dir_name
        self.current_checkpoint_index = 0

    @property
    def experiment_fs_path(self) -> str:
        return os.path.join(self.storage_path, self.experiment_dir_name)

    @property
    def trial_fs_path(self) -> str:
        if self.trial_dir_name is None:
            return self.experiment_fs_path
        return os.path.join(self.experiment_fs_path, self.trial_dir_name)

    def make_dirs(self) -> None:
        os.makedirs(self.trial_fs_path, exist_ok=True)

    def checkpoint_fs_path(self, index: Optional[int] = None) -> str:
        idx = self.current_checkpoint_index if index is None else index
        return os.path.join(self.trial_fs_path, f"checkpoint_{idx:06d}")

    def persist_current_checkpoint(self, checkpoint: Checkpoint) -> Checkpoint:
        """Merge-copy a worker-local checkpoint dir into trial storage."""
        dest = self.checkpoint_fs_path()
        os.makedirs(dest, exist_ok=True)
        _merge_tree(checkpoint.path, dest)
        return Checkpoint(dest)

    def advance_checkpoint_index(self) -> None:
        self.current_checkpoint_index += 1

    def __getstate__(self):
        return dict(self.__dict__)

    def __setstate__(self, state):
        self.__dict__.update(state)


def make_experiment_name(prefix: str = "train") -> str:
    return f"{prefix}_{time.strftime('%Y-%m-%d_%H-%M-%S')}_{os.getpid()}"
