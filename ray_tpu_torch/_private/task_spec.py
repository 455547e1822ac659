"""Task specifications and scheduling strategies.

Analog of the reference's ``TaskSpecification`` (`src/ray/common/
task/task_spec.h`) and the Python scheduling-strategy surface
(`python/ray/util/scheduling_strategies.py`): a TaskSpec is the unit handed
from a submitting CoreWorker to a supervisor (for the lease) and then to the
executing worker (for the run).

Args are pre-resolved at the submitter where possible: plain values travel as
packed payloads, top-level ObjectRef args travel as (id, owner) pairs that the
executing worker fetches before invoking the function — mirroring the
reference's LocalDependencyResolver + plasma-arg split
(`transport/dependency_resolver.h`, `core_worker.cc:2852`).
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Any, Dict, List, Optional, Tuple

from ray_tpu_torch._private.ids import ActorID, JobID, ObjectID, PlacementGroupID, TaskID

Address = Tuple[str, int]


class ArgKind(enum.Enum):
    VALUE = 0  # packed payload bytes
    REF = 1  # (ObjectID, owner Address) — fetched by the executor


@dataclasses.dataclass
class TaskArg:
    kind: ArgKind
    value: bytes | None = None
    object_id: ObjectID | None = None
    owner: Address | None = None


class TaskKind(enum.Enum):
    NORMAL = 0
    ACTOR_CREATION = 1
    ACTOR_TASK = 2


@dataclasses.dataclass
class SchedulingStrategy:
    """Base: DEFAULT = hybrid policy."""

    name: str = "DEFAULT"


@dataclasses.dataclass
class SpreadStrategy(SchedulingStrategy):
    name: str = "SPREAD"


@dataclasses.dataclass
class NodeAffinityStrategy(SchedulingStrategy):
    name: str = "NODE_AFFINITY"
    node_id_hex: str = ""
    soft: bool = False


@dataclasses.dataclass
class RandomStrategy(SchedulingStrategy):
    """Uniform choice over schedulable nodes (ref
    `policy/random_scheduling_policy.h`) — load-oblivious by design,
    for workloads that want decorrelated placement."""

    name: str = "RANDOM"


@dataclasses.dataclass
class PlacementGroupStrategy(SchedulingStrategy):
    name: str = "PLACEMENT_GROUP"
    pg_id_hex: str = ""
    bundle_index: int = -1  # -1 = any bundle


# Label operators (≈ the reference's label-selector grammar behind
# NodeLabelSchedulingStrategy, `bundle_label_selector`/
# `node_label_scheduling_policy`). Each constraint maps a label key to
# one of these; plain lists/strings shorthand to In.


@dataclasses.dataclass
class In:
    values: tuple

    def __init__(self, *values):
        self.values = tuple(values)

    def matches(self, v) -> bool:
        return v is not None and v in self.values


@dataclasses.dataclass
class NotIn:
    values: tuple

    def __init__(self, *values):
        self.values = tuple(values)

    def matches(self, v) -> bool:
        return v is None or v not in self.values


@dataclasses.dataclass
class Exists:
    def matches(self, v) -> bool:
        return v is not None


@dataclasses.dataclass
class DoesNotExist:
    def matches(self, v) -> bool:
        return v is None


def _norm_label_ops(constraints):
    out = {}
    for k, op in (constraints or {}).items():
        if isinstance(op, (list, tuple)):
            op = In(*op)
        elif isinstance(op, str):
            op = In(op)
        out[k] = op
    return out


@dataclasses.dataclass
class NodeLabelStrategy(SchedulingStrategy):
    """Schedule by node labels (≈ NodeLabelSchedulingStrategy /
    `node_label_scheduling_policy.h`): `hard` constraints filter the
    candidate set (infeasible if none match), `soft` ones order it —
    the heterogeneous-GPU-generations case (label cards by `gpu-gen`)
    the plain resource model can't express."""

    name: str = "NODE_LABEL"
    hard: dict = dataclasses.field(default_factory=dict)
    soft: dict = dataclasses.field(default_factory=dict)

    def __post_init__(self):
        self.hard = _norm_label_ops(self.hard)
        self.soft = _norm_label_ops(self.soft)


@dataclasses.dataclass
class TaskSpec:
    task_id: TaskID
    job_id: JobID
    kind: TaskKind
    name: str  # human-readable, for errors/observability
    function_key: str  # controller function-table key (sha256 of pickled fn)
    args: List[TaskArg]
    # -1 = streaming generator task (`num_returns="streaming"`): the task
    # yields a dynamic number of items, each reported to the owner as it
    # is produced (≈ reference ObjectRefGenerator, _raylet.pyx:273)
    num_returns: int = 1
    # None = unspecified (defaults to 1 CPU for normal tasks); {} = explicitly
    # zero-resource (schedulable anywhere, like the reference's num_cpus=0)
    resources: Optional[Dict[str, float]] = None
    strategy: SchedulingStrategy = dataclasses.field(default_factory=SchedulingStrategy)
    max_retries: int = 0
    retry_exceptions: bool = False
    owner: Optional[Address] = None
    runtime_env: Optional[Dict[str, Any]] = None
    # actor fields
    actor_id: Optional[ActorID] = None
    method_name: str = ""
    seqno: int = -1  # per-handle sequence number for ordered actor execution
    caller_id: str = ""  # identifies the submitting handle for ordering
    max_concurrency: int = 1
    max_restarts: int = 0
    max_task_retries: int = 0
    is_async_actor: bool = False
    # distributed tracing: caller's span context (util/tracing.py); the
    # executing worker opens a child span around the user function
    trace_ctx: Optional[Dict[str, str]] = None
    # streaming only: executor pauses when this many yielded items are
    # unconsumed at the owner (0 = unbounded), ≈ the reference's
    # _generator_backpressure_num_objects
    backpressure: int = 0

    @property
    def is_streaming(self) -> bool:
        return self.num_returns < 0

    def return_ids(self) -> List[ObjectID]:
        if self.is_streaming:
            # item ids are minted per yield (ObjectID.for_task_return with
            # the yield index); the owner's stream state tracks them
            return []
        return [
            ObjectID.for_task_return(self.task_id, i) for i in range(self.num_returns)
        ]

    def required_resources(self) -> Dict[str, float]:
        if self.resources is None:
            return {"CPU": 1.0}
        return {k: v for k, v in self.resources.items() if v > 0}
