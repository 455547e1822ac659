"""Unique identifiers for the control plane.

Analog of the reference's ID system (`src/ray/common/id.h`): every
entity in the cluster — jobs, tasks, actors, objects, nodes, workers, placement
groups — is addressed by a fixed-width binary ID with a cheap hex rendering.

Unlike the reference we keep a single Python implementation (the native runtime
stores IDs as raw bytes; no separate C++ class hierarchy is needed because IDs
never appear on a hot device path — tensors are addressed by sharding metadata,
not object IDs).

Structure is preserved where it carries meaning:
  * ``ObjectID = TaskID (16B) + return-index (4B)`` so lineage (which task
    created this object) is recoverable from the ID alone, mirroring the
    reference's ObjectID layout used by lineage reconstruction
    (`src/ray/core_worker/task_manager.h:215`).
  * ``ActorID`` embeds the JobID prefix for per-job actor enumeration.
"""

from __future__ import annotations

import os
import threading

_NIL = b""


class BaseID:
    """Fixed-size binary ID. Subclasses define SIZE."""

    SIZE = 16
    __slots__ = ("_bytes",)

    def __init__(self, id_bytes: bytes):
        if len(id_bytes) != self.SIZE:
            raise ValueError(
                f"{type(self).__name__} requires {self.SIZE} bytes, got {len(id_bytes)}"
            )
        self._bytes = id_bytes

    @classmethod
    def from_random(cls) -> "BaseID":
        return cls(os.urandom(cls.SIZE))

    @classmethod
    def from_hex(cls, hex_str: str) -> "BaseID":
        return cls(bytes.fromhex(hex_str))

    @classmethod
    def nil(cls) -> "BaseID":
        return cls(b"\x00" * cls.SIZE)

    def is_nil(self) -> bool:
        return self._bytes == b"\x00" * self.SIZE

    def binary(self) -> bytes:
        return self._bytes

    def hex(self) -> str:
        return self._bytes.hex()

    def __eq__(self, other) -> bool:
        return type(other) is type(self) and other._bytes == self._bytes

    def __hash__(self) -> int:
        return hash((type(self).__name__, self._bytes))

    def __repr__(self) -> str:
        return f"{type(self).__name__}({self.hex()})"

    def __reduce__(self):
        return (type(self), (self._bytes,))


class JobID(BaseID):
    SIZE = 4

    _counter = 0
    _lock = threading.Lock()

    @classmethod
    def from_int(cls, value: int) -> "JobID":
        return cls(value.to_bytes(cls.SIZE, "big"))

    @classmethod
    def next(cls) -> "JobID":
        with cls._lock:
            cls._counter += 1
            return cls.from_int(cls._counter)


class NodeID(BaseID):
    SIZE = 16


class WorkerID(BaseID):
    SIZE = 16


class ActorID(BaseID):
    SIZE = 16

    @classmethod
    def of(cls, job_id: JobID) -> "ActorID":
        return cls(job_id.binary() + os.urandom(cls.SIZE - JobID.SIZE))

    def job_id(self) -> JobID:
        return JobID(self._bytes[: JobID.SIZE])


class TaskID(BaseID):
    SIZE = 16

    @classmethod
    def for_actor_creation(cls, actor_id: ActorID) -> "TaskID":
        return cls(actor_id.binary())


class ObjectID(BaseID):
    """TaskID + big-endian return index. Index 0..2**32-1."""

    SIZE = TaskID.SIZE + 4

    @classmethod
    def for_task_return(cls, task_id: TaskID, index: int) -> "ObjectID":
        return cls(task_id.binary() + index.to_bytes(4, "big"))

    @classmethod
    def from_put(cls) -> "ObjectID":
        # Puts get a synthetic "task" with index 0xFFFFFFFF so they are
        # distinguishable from task returns (puts are not reconstructable).
        return cls(os.urandom(TaskID.SIZE) + b"\xff\xff\xff\xff")

    def task_id(self) -> TaskID:
        return TaskID(self._bytes[: TaskID.SIZE])

    def return_index(self) -> int:
        return int.from_bytes(self._bytes[TaskID.SIZE :], "big")

    def is_put(self) -> bool:
        return self.return_index() == 0xFFFFFFFF


class PlacementGroupID(BaseID):
    SIZE = 16


class ClusterID(BaseID):
    SIZE = 16
