"""Cluster scheduling policies.

Analog of the reference's scheduler policy plug-ins
(`src/ray/raylet/scheduling/policy/`): hybrid (default,
`hybrid_scheduling_policy.h:50`), spread, node-affinity, and the
placement-group bundle policies (PACK / SPREAD / STRICT_PACK / STRICT_SPREAD,
`bundle_scheduling_policy.h:82-106`).

Policies are pure functions over an immutable view of node states so they run
identically in the controller (actor/PG scheduling) and in each supervisor
(task lease scheduling on its synced cluster view).
"""

from __future__ import annotations

import dataclasses
import random
from typing import Dict, List, Optional, Sequence, Tuple

from ray_tpu_torch._private.resources import ResourceSet
from ray_tpu_torch._private.task_spec import (
    NodeAffinityStrategy,
    NodeLabelStrategy,
    PlacementGroupStrategy,
    RandomStrategy,
    SchedulingStrategy,
    SpreadStrategy,
)


@dataclasses.dataclass
class NodeView:
    """A supervisor's advertised state, gossiped via the controller."""

    node_id_hex: str
    address: Tuple[str, int]
    total: ResourceSet
    available: ResourceSet
    alive: bool = True
    labels: Dict[str, str] = dataclasses.field(default_factory=dict)

    def feasible(self, demand: ResourceSet) -> bool:
        return self.alive and self.total.fits(demand)

    def schedulable_now(self, demand: ResourceSet) -> bool:
        return self.alive and self.available.fits(demand)


def pick_node(
    nodes: Sequence[NodeView],
    demand: Dict[str, float],
    strategy: SchedulingStrategy,
    local_node_hex: Optional[str] = None,
    spread_threshold: float = 0.5,
    rng: random.Random | None = None,
) -> Optional[NodeView]:
    """Pick a node for one task. Returns None if nothing is feasible."""
    rs = ResourceSet.of(demand)
    if isinstance(strategy, NodeAffinityStrategy):
        for n in nodes:
            if n.node_id_hex == strategy.node_id_hex:
                if n.schedulable_now(rs):
                    return n
                return n if (strategy.soft and n.feasible(rs)) else (
                    _hybrid(nodes, rs, local_node_hex, spread_threshold)
                    if strategy.soft
                    else None
                )
        return _hybrid(nodes, rs, local_node_hex, spread_threshold) if strategy.soft else None
    if isinstance(strategy, NodeLabelStrategy):
        # hard constraints FILTER; soft constraints ORDER (the composite
        # shape of composite_scheduling_policy.h: label policy narrows,
        # hybrid decides within the narrowed set)
        def soft_score(n: NodeView) -> int:
            return sum(op.matches(n.labels.get(k))
                       for k, op in strategy.soft.items())

        eligible = [n for n in nodes
                    if node_satisfies_labels(strategy, n.labels)]
        if not eligible:
            return None  # infeasible by labels: queue, don't misplace
        if strategy.soft:
            best = max(soft_score(n) for n in eligible)
            preferred = [n for n in eligible if soft_score(n) == best]
            chosen = _hybrid(preferred, rs, local_node_hex,
                             spread_threshold)
            if chosen is not None:
                return chosen
        return _hybrid(eligible, rs, local_node_hex, spread_threshold)
    if isinstance(strategy, RandomStrategy):
        schedulable = [n for n in nodes if n.schedulable_now(rs)]
        if not schedulable:
            schedulable = [n for n in nodes if n.feasible(rs)]
        return (rng or random).choice(schedulable) if schedulable else None
    if isinstance(strategy, SpreadStrategy):
        return _spread(nodes, rs, rng)
    # PlacementGroupStrategy demand is rewritten to bundle resources upstream.
    return _hybrid(nodes, rs, local_node_hex, spread_threshold)


def node_satisfies_labels(strategy: SchedulingStrategy,
                          labels: Dict[str, str]) -> bool:
    """True unless *strategy* carries hard label constraints the node's
    labels fail — the local-grant guard supervisors apply before leasing
    on themselves."""
    if not isinstance(strategy, NodeLabelStrategy):
        return True
    return all(op.matches(labels.get(k))
               for k, op in strategy.hard.items())


def _hybrid(
    nodes: Sequence[NodeView],
    demand: ResourceSet,
    local_node_hex: Optional[str],
    spread_threshold: float,
) -> Optional[NodeView]:
    """Reference's hybrid policy: prefer the local node while its utilization
    is below the threshold, else best-fit (lowest utilization first, then
    pack); fall back to any feasible node for queueing."""
    schedulable = [n for n in nodes if n.schedulable_now(demand)]
    if not schedulable:
        feas = [n for n in nodes if n.feasible(demand)]
        return feas[0] if feas else None
    local = next((n for n in schedulable if n.node_id_hex == local_node_hex), None)
    if local is not None:
        util = local.available.utilization(local.total)
        if util < spread_threshold:
            return local
    # score: (above_threshold, utilization) — prefer below-threshold low-util
    def score(n: NodeView):
        util = n.available.utilization(n.total)
        return (util >= spread_threshold, util, n.node_id_hex)

    return min(schedulable, key=score)


def _spread(
    nodes: Sequence[NodeView], demand: ResourceSet, rng: random.Random | None
) -> Optional[NodeView]:
    schedulable = [n for n in nodes if n.schedulable_now(demand)]
    if not schedulable:
        feas = [n for n in nodes if n.feasible(demand)]
        return (rng or random).choice(feas) if feas else None
    # least-loaded first; ties broken randomly for even spread
    min_util = min(n.available.utilization(n.total) for n in schedulable)
    best = [n for n in schedulable if n.available.utilization(n.total) <= min_util + 1e-9]
    return (rng or random).choice(best)


# ---- placement group bundle scheduling (bundle_scheduling_policy.h:82-106) ----


class PlacementError(Exception):
    pass


def place_bundles(
    nodes: Sequence[NodeView],
    bundles: List[Dict[str, float]],
    strategy: str,
) -> List[str]:
    """Assign each bundle to a node id. Raises PlacementError if infeasible.

    Strategies: PACK (prefer few nodes, soft), STRICT_PACK (all on one node),
    SPREAD (prefer distinct nodes, soft), STRICT_SPREAD (must be distinct).
    """
    demands = [ResourceSet.of(b) for b in bundles]
    avail = {n.node_id_hex: n.available.copy() for n in nodes if n.alive}
    order = sorted(avail, key=lambda h: -avail[h].utilization(
        next(n.total for n in nodes if n.node_id_hex == h)
    ))

    if strategy == "STRICT_PACK":
        for h in avail:
            trial = avail[h].copy()
            if _fits_all(trial, demands):
                return [h] * len(demands)
        raise PlacementError("STRICT_PACK: no single node fits all bundles")

    if strategy == "STRICT_SPREAD":
        if len([h for h in avail]) < len(demands):
            raise PlacementError("STRICT_SPREAD: fewer alive nodes than bundles")
        assignment = _spread_assign(avail, demands, strict=True)
        if assignment is None:
            raise PlacementError("STRICT_SPREAD: no feasible distinct assignment")
        return assignment

    if strategy == "SPREAD":
        assignment = _spread_assign(avail, demands, strict=False)
        if assignment is None:
            raise PlacementError("SPREAD: bundles do not fit on cluster")
        return assignment

    # PACK (default): fill nodes in order, most-utilized first.
    assignment = []
    for d in demands:
        placed = None
        for h in order:
            if avail[h].fits(d):
                avail[h].subtract(d)
                placed = h
                break
        if placed is None:
            raise PlacementError("PACK: bundles do not fit on cluster")
        assignment.append(placed)
    return assignment


def _fits_all(avail: ResourceSet, demands: List[ResourceSet]) -> bool:
    trial = avail.copy()
    for d in demands:
        if not trial.fits(d):
            return False
        trial.subtract(d)
    return True


def _spread_assign(
    avail: Dict[str, ResourceSet], demands: List[ResourceSet], strict: bool
) -> Optional[List[str]]:
    assignment: List[str] = []
    used: set = set()
    for d in demands:
        candidates = [h for h, a in avail.items() if a.fits(d) and h not in used]
        if not candidates and not strict:
            candidates = [h for h, a in avail.items() if a.fits(d)]
        if not candidates:
            return None
        # least-loaded among candidates: pick max remaining capacity
        h = max(candidates, key=lambda x: avail[x].get("CPU", 0.0) + avail[x].get("GPU", 0.0))
        avail[h].subtract(d)
        assignment.append(h)
        used.add(h)
    return assignment
