"""Public scheduling-strategy surface (≈ `ray.util.scheduling_strategies`:
NodeAffinitySchedulingStrategy, NodeLabelSchedulingStrategy + the
In/NotIn/Exists/DoesNotExist label operators).

Counterpart: ``ray_tpu/util/scheduling_strategies.py``, over the port's
``_private/task_spec.py`` strategies."""

from ray_tpu_torch._private.task_spec import (  # noqa: F401
    DoesNotExist,
    Exists,
    In,
    NodeAffinityStrategy,
    NodeLabelStrategy,
    NotIn,
    PlacementGroupStrategy,
    RandomStrategy,
    SchedulingStrategy,
    SpreadStrategy,
)

# reference-compatible aliases
NodeAffinitySchedulingStrategy = NodeAffinityStrategy
NodeLabelSchedulingStrategy = NodeLabelStrategy
PlacementGroupSchedulingStrategy = PlacementGroupStrategy
