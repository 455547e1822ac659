"""Directory-backed checkpoints.

Counterpart: ``ray_tpu/train/_checkpoint.py``. Analog of
`ray.train.Checkpoint` (`python/ray/train/_checkpoint.py`): a checkpoint IS
a directory on a filesystem, nothing more. Serialization composes on top:
callers ``torch.save`` a state dict into a directory and wrap it. Metadata
rides in a sidecar JSON file.
"""

from __future__ import annotations

import contextlib
import json
import os
import shutil
import tempfile
import uuid
from typing import Any, Dict, Iterator

_METADATA_FILE = ".ray_tpu_torch_ckpt_metadata.json"


class Checkpoint:
    """A reference to a checkpoint directory."""

    def __init__(self, path: str):
        self.path = os.path.abspath(os.path.expanduser(path))

    @classmethod
    def from_directory(cls, path: str) -> "Checkpoint":
        if not os.path.isdir(path):
            raise ValueError(f"not a directory: {path}")
        return cls(path)

    def to_directory(self, path: str | None = None) -> str:
        """Materialize into ``path`` (or a temp dir) and return it."""
        dest = path or os.path.join(
            tempfile.gettempdir(), f"ckpt_{uuid.uuid4().hex[:12]}"
        )
        os.makedirs(dest, exist_ok=True)
        _merge_tree(self.path, dest)
        return dest

    @contextlib.contextmanager
    def as_directory(self) -> Iterator[str]:
        """Local-dir view. Local paths are yielded as-is (zero copy)."""
        yield self.path

    def get_metadata(self) -> Dict[str, Any]:
        meta = os.path.join(self.path, _METADATA_FILE)
        if os.path.exists(meta):
            with open(meta) as f:
                return json.load(f)
        return {}

    def set_metadata(self, metadata: Dict[str, Any]) -> None:
        with open(os.path.join(self.path, _METADATA_FILE), "w") as f:
            json.dump(metadata, f)

    def update_metadata(self, metadata: Dict[str, Any]) -> None:
        merged = self.get_metadata()
        merged.update(metadata)
        self.set_metadata(merged)

    def __repr__(self) -> str:
        return f"Checkpoint(path={self.path!r})"

    def __eq__(self, other) -> bool:
        return isinstance(other, Checkpoint) and other.path == self.path

    def __hash__(self) -> int:
        return hash(self.path)


def _merge_tree(src: str, dest: str) -> None:
    """Recursive copy that merges into an existing tree (multi-rank
    checkpoint shards land in one directory)."""
    for root, dirs, files in os.walk(src):
        rel = os.path.relpath(root, src)
        target = dest if rel == "." else os.path.join(dest, rel)
        os.makedirs(target, exist_ok=True)
        for f in files:
            shutil.copy2(os.path.join(root, f), os.path.join(target, f))
