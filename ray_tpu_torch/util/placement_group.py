"""Placement groups: gang-reserving resource bundles across nodes.

Counterpart: ``ray_tpu/util/placement_group.py``. Analog of the reference's
placement group API (`python/ray/util/placement_group.py:145`) over the
controller's PG manager (≈ `GcsPlacementGroupManager`). Strategies: PACK,
SPREAD, STRICT_PACK, STRICT_SPREAD.

A bundle may hold ``GPU`` (whole cards): a lease taken from it is given
its cards by the node's supervisor, as any ``num_gpus`` lease is, and the
data-parallel trainer's ``WorkerGroup`` gang-places its workers this way.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional

from ray_tpu_torch._private import api
from ray_tpu_torch._private.exceptions import PlacementGroupError
from ray_tpu_torch._private.ids import PlacementGroupID

VALID_STRATEGIES = ("PACK", "SPREAD", "STRICT_PACK", "STRICT_SPREAD")


class PlacementGroup:
    def __init__(self, pg_id: PlacementGroupID, bundles: List[Dict[str, float]]):
        self.id = pg_id
        self.bundle_specs = bundles

    @property
    def bundle_count(self) -> int:
        return len(self.bundle_specs)

    def ready(self) -> "api.ObjectRef":
        """An ObjectRef that resolves when the group is placed (≈ pg.ready()).

        Non-blocking: the probe task pends while the group is PENDING (the
        lease path waits for placement) and runs once bundles reserve, so
        ``get(pg.ready(), timeout=...)`` raises GetTimeoutError for an
        unsatisfiable group instead of stalling here.
        """

        @api.remote(num_cpus=0)
        def _pg_ready_probe():
            return True

        return _pg_ready_probe.options(
            scheduling_strategy=None,
            placement_group=self,
        ).remote()

    def wait(self, timeout: float = 30) -> bool:
        """Block until placed. Long-polls the controller's PG-state KV key
        via ``kv_wait`` (one parked RPC) instead of the old 50 ms
        pg_get/sleep loop; pg_get re-checks around each wait slice so a
        missing key (e.g. a controller restart) degrades to slower polls,
        never to a wrong answer."""
        from ray_tpu_torch._private import internal_kv

        core = api._require_core()
        deadline = time.monotonic() + timeout
        while True:
            rec = core._run(
                core.clients.get(core.controller_addr).call(
                    "pg_get", {"pg_id_hex": self.id.hex()}
                )
            )
            if rec and rec["state"] == "CREATED":
                return True
            if rec and rec["state"] == "REMOVED":
                raise PlacementGroupError("placement group was removed")
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                return False
            try:
                internal_kv.kv_wait(self.id.hex(),
                                    timeout=min(remaining, 5.0), ns="pg")
            except TimeoutError:
                pass

    def __reduce__(self):
        return (PlacementGroup, (self.id, self.bundle_specs))


def placement_group(
    bundles: List[Dict[str, float]],
    strategy: str = "PACK",
    name: str = "",
    lifetime: Optional[str] = None,
) -> PlacementGroup:
    if strategy not in VALID_STRATEGIES:
        raise ValueError(f"strategy must be one of {VALID_STRATEGIES}")
    if not bundles or any(not b for b in bundles):
        raise ValueError("bundles must be non-empty resource dicts")
    core = api._require_core()
    pg_id = PlacementGroupID.from_random()
    core._run(
        core.clients.get(core.controller_addr).call(
            "pg_create",
            {
                "pg_id_hex": pg_id.hex(),
                "bundles": [dict(b) for b in bundles],
                "strategy": strategy,
                "name": name,
                "job_id_hex": core.job_id.hex(),
            },
        )
    )
    return PlacementGroup(pg_id, [dict(b) for b in bundles])


def remove_placement_group(pg: PlacementGroup) -> None:
    core = api._require_core()
    core._run(
        core.clients.get(core.controller_addr).call(
            "pg_remove", {"pg_id_hex": pg.id.hex()}
        )
    )


def placement_group_table() -> List[dict]:
    core = api._require_core()
    return core._run(core.clients.get(core.controller_addr).call("pg_list"))
