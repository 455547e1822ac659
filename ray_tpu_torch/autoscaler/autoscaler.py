"""StandardAutoscaler — the demand → node-launch reconciler.

Analog of `python/ray/autoscaler/_private/autoscaler.py:172`
(StandardAutoscaler.update) + `resource_demand_scheduler.py` (bin-packing
pending demand into node launches): each `update()`

  1. reads cluster state from the controller (`autoscaler_state` RPC:
     node views + the pending-lease demand every supervisor gossips),
  2. simulates placing the pending demand onto current capacity,
  3. bin-packs the unmet remainder into the cheapest feasible node types
     (a ``GPU`` bundle only onto a type that counts cards) and launches
     them through the NodeProvider,
  4. terminates nodes idle longer than `idle_timeout_s` (never below
     `min_workers`, never the head node).

Run it from any process that can reach the controller — typically the
head (`autoscaler.run_in_thread()`), mirroring the reference's monitor
process driving StandardAutoscaler.
"""

from __future__ import annotations

import dataclasses
import logging
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

from ray_tpu_torch.autoscaler.node_provider import NodeProvider, NodeType

logger = logging.getLogger(__name__)

Address = Tuple[str, int]


@dataclasses.dataclass
class AutoscalerConfig:
    node_types: List[NodeType] = dataclasses.field(default_factory=list)
    max_workers: int = 8          # autoscaled nodes, cluster-wide
    min_workers: int = 0
    idle_timeout_s: float = 60.0
    update_interval_s: float = 2.0
    # a launch is assumed in flight this long; suppresses double-launch
    # while the new supervisor registers
    launch_grace_s: float = 30.0


def fetch_autoscaler_state(controller_addr: Address) -> dict:
    """The controller's ``autoscaler_state``: per-node views with each
    node's pending demand and idle age."""
    import asyncio

    from ray_tpu_torch._private.rpc import RpcClient

    async def go():
        client = RpcClient(tuple(controller_addr))
        try:
            return await client.call("autoscaler_state", timeout=10)
        finally:
            await client.close()

    return asyncio.run(go())


class StandardAutoscaler:
    def __init__(self, controller_addr: Address, provider: NodeProvider,
                 config: AutoscalerConfig):
        self.controller_addr = tuple(controller_addr)
        self.provider = provider
        self.config = config
        self._launches: List[Tuple[float, str]] = []  # (ts, node_type)
        self._seen_nodes: set = set()  # provider node_names seen alive
        self._thread: Optional[threading.Thread] = None
        self._stopped = threading.Event()

    # ------------------------------------------------------------- state

    def _fetch_state(self) -> dict:
        return fetch_autoscaler_state(self.controller_addr)

    # ------------------------------------------------------------ update

    def update(self) -> Dict[str, Any]:
        """One reconcile pass; returns a summary for logging/tests."""
        state = self._fetch_state()
        alive = [n for n in state["nodes"] if n["alive"]]
        self._prune_registered_launches(alive)
        demand: List[Dict[str, float]] = []
        for n in alive:
            demand.extend(n.get("pending_demand", []))

        unmet = _unmet_after_packing(demand, alive, self._pending_types())
        to_launch = _nodes_to_launch(
            unmet, self.config.node_types,
            current=self._autoscaled_count(alive),
            max_workers=self.config.max_workers,
            existing_by_type=self._alive_counts_by_type(alive))
        for node_type, count in to_launch.items():
            nt = next(t for t in self.config.node_types
                      if t.name == node_type)
            logger.info("autoscaler launching %d x %s", count, nt.name)
            self.provider.create_node(nt, count)
            now = time.monotonic()
            self._launches.extend((now, nt.name) for _ in range(count))

        removed = self._scale_down_idle(alive, demand)
        return {"demand": len(demand), "unmet": len(unmet),
                "launched": dict(to_launch), "removed": removed}

    def _provider_types_by_name(self) -> Dict[str, str]:
        return {n.get("node_name", n["id"]): n["node_type"]
                for n in self.provider.non_terminated_nodes()}

    def _prune_registered_launches(self, alive) -> None:
        """A launch that has registered must stop counting as in-flight —
        otherwise it is double-counted (live capacity AND pending pool),
        suppressing legitimate scale-up until the grace window lapses."""
        types_by_name = self._provider_types_by_name()
        for n in alive:
            name = n.get("labels", {}).get("node_name")
            if name in types_by_name and name not in self._seen_nodes:
                self._seen_nodes.add(name)
                ntype = types_by_name[name]
                for i, (_ts, lt) in enumerate(self._launches):
                    if lt == ntype:
                        self._launches.pop(i)
                        break

    def _alive_counts_by_type(self, alive) -> Dict[str, int]:
        """Existing autoscaled nodes per type (+ in-flight launches), for
        per-type max_workers enforcement across update() calls."""
        types_by_name = self._provider_types_by_name()
        counts: Dict[str, int] = {}
        for n in alive:
            ntype = types_by_name.get(n.get("labels", {}).get("node_name"))
            if ntype is not None:
                counts[ntype] = counts.get(ntype, 0) + 1
        for _ts, ntype in self._launches:
            counts[ntype] = counts.get(ntype, 0) + 1
        return counts

    def _pending_types(self) -> List[NodeType]:
        """Launches still in their grace window count as capacity so a
        slow-to-register node isn't launched twice."""
        now = time.monotonic()
        self._launches = [
            (ts, name) for ts, name in self._launches
            if now - ts < self.config.launch_grace_s
        ]
        by_name = {t.name: t for t in self.config.node_types}
        return [by_name[name] for _, name in self._launches
                if name in by_name]

    def _autoscaled_count(self, alive) -> int:
        provider_names = {n.get("node_name", n["id"])
                          for n in self.provider.non_terminated_nodes()}
        return sum(
            1 for n in alive
            if n.get("labels", {}).get("node_name") in provider_names
        ) + len(self._launches)

    def _scale_down_idle(self, alive, demand) -> List[str]:
        if demand:
            return []  # never shrink under pending demand
        removed = []
        provider_nodes = {n.get("node_name", n["id"]): n["id"]
                          for n in self.provider.non_terminated_nodes()}
        autoscaled_alive = [
            n for n in alive
            if n.get("labels", {}).get("node_name") in provider_nodes
        ]
        keep = max(self.config.min_workers, 0)
        for n in autoscaled_alive:
            if len(autoscaled_alive) - len(removed) <= keep:
                break
            if n["idle_s"] > self.config.idle_timeout_s and \
                    dict(n["available"]) == dict(n["total"]):
                pid = provider_nodes[n["labels"]["node_name"]]
                logger.info("autoscaler terminating idle node %s", pid)
                self.provider.terminate_node(pid)
                removed.append(pid)
        return removed

    # ------------------------------------------------------------- loop

    def run_in_thread(self) -> threading.Thread:
        def loop():
            while not self._stopped.wait(self.config.update_interval_s):
                try:
                    self.update()
                except Exception:
                    logger.exception("autoscaler update failed")

        self._thread = threading.Thread(
            target=loop, name="autoscaler", daemon=True)
        self._thread.start()
        return self._thread

    def stop(self) -> None:
        self._stopped.set()


# ---------------------------------------------------------------- packing


def _unmet_after_packing(demand: List[Dict[str, float]], alive,
                         pending_types: List[NodeType]) -> List[Dict[str, float]]:
    """Simulate placing each demand bundle on current + in-flight
    capacity; return the bundles that do not fit anywhere
    (≈ get_bin_pack_residual, resource_demand_scheduler.py)."""
    pools: List[Dict[str, float]] = [dict(n["available"]) for n in alive]
    pools.extend(dict(t.resources) for t in pending_types)
    unmet: List[Dict[str, float]] = []
    for bundle in demand:
        placed = False
        for pool in pools:
            if all(pool.get(k, 0.0) >= v for k, v in bundle.items()):
                for k, v in bundle.items():
                    pool[k] = pool.get(k, 0.0) - v
                placed = True
                break
        if not placed:
            unmet.append(bundle)
    return unmet


def _nodes_to_launch(unmet: List[Dict[str, float]],
                     node_types: List[NodeType], *, current: int,
                     max_workers: int,
                     existing_by_type: Optional[Dict[str, int]] = None,
                     ) -> Dict[str, int]:
    """Bin-pack unmet bundles into the fewest new nodes, smallest
    feasible type first (utilization-based scoring simplified to
    resource-sum ordering). Per-type max_workers counts nodes that
    already exist (existing_by_type), not just this pass's launches."""
    launches: Dict[str, int] = {}
    existing_by_type = existing_by_type or {}
    budget = max(0, max_workers - current)
    if not budget:
        return launches
    ordered = sorted(node_types,
                     key=lambda t: sum(t.resources.values()))
    open_pools: List[Tuple[str, Dict[str, float]]] = []
    for bundle in unmet:
        placed = False
        for name, pool in open_pools:
            if all(pool.get(k, 0.0) >= v for k, v in bundle.items()):
                for k, v in bundle.items():
                    pool[k] = pool.get(k, 0.0) - v
                placed = True
                break
        if placed:
            continue
        for t in ordered:
            fits = all(t.resources.get(k, 0.0) >= v
                       for k, v in bundle.items())
            within = (launches.get(t.name, 0)
                      + existing_by_type.get(t.name, 0)) < t.max_workers
            if fits and within and sum(launches.values()) < budget:
                pool = dict(t.resources)
                for k, v in bundle.items():
                    pool[k] = pool.get(k, 0.0) - v
                open_pools.append((t.name, pool))
                launches[t.name] = launches.get(t.name, 0) + 1
                break
        # an unfittable bundle (no type big enough) is simply skipped —
        # it stays parked in the supervisor's infeasible queue
    return launches
