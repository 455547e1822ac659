"""Utilities of the runtime: tracing spans (``tracing``), the collectives'
group API and transports (``collective``) and placement groups
(``placement_group``). Actor pools are not ported yet."""

from ray_tpu_torch.util.placement_group import (  # noqa: F401
    PlacementGroup,
    placement_group,
    placement_group_table,
    remove_placement_group,
)
