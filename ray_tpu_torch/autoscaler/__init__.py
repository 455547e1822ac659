"""ray_tpu_torch.autoscaler — demand-driven cluster scaling.

Analog of the reference autoscaler
(`python/ray/autoscaler/_private/autoscaler.py:172` StandardAutoscaler,
`resource_demand_scheduler.py` bin-packing, `node_provider.py` plugin
interface, and the v2 instance manager and reconciler in ``v2``): node
types are host shapes, a GPU host one whose ``GPU`` count its workers are
handed cards from, and the demand signal is the pending-lease gossip
every supervisor already syncs to the controller.
"""

from ray_tpu_torch.autoscaler.autoscaler import (AutoscalerConfig,
                                                 StandardAutoscaler)
from ray_tpu_torch.autoscaler.node_provider import (LocalNodeProvider,
                                                    NodeProvider, NodeType)

__all__ = [
    "AutoscalerConfig",
    "StandardAutoscaler",
    "NodeProvider",
    "NodeType",
    "LocalNodeProvider",
]
