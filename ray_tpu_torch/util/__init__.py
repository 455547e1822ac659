"""Utilities of the runtime: actor pools (``ActorPool``), a distributed
FIFO queue (``queue``), the state API over the controller's tables
(``state``: nodes, actors, tasks, jobs, events, metrics, timelines, live
profiles), user metrics (``metrics``), tracing spans (``tracing``), the
collectives' group API and transports (``collective``), placement groups
(``placement_group``), the scheduling strategies
(``scheduling_strategies``) and client mode (``client``)."""

from ray_tpu_torch.util.actor_pool import ActorPool  # noqa: F401
from ray_tpu_torch.util.placement_group import (  # noqa: F401
    PlacementGroup,
    placement_group,
    placement_group_table,
    remove_placement_group,
)
