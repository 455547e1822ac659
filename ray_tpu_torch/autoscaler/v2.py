"""Autoscaler v2: instance manager + declarative reconciler.

Analog of the reference's autoscaler rearchitecture
(`python/ray/autoscaler/v2/autoscaler.py`,
`v2/instance_manager/instance_manager.py`,
`v2/instance_manager/reconciler.py`): instead of v1's imperative
launch-and-forget loop, every node the autoscaler touches is an
**Instance** with an explicit lifecycle

    QUEUED -> REQUESTED -> ALLOCATED -> RAY_RUNNING
                  |            |            |
                  v            v            v
        ALLOCATION_FAILED   TERMINATING -> TERMINATED

recorded with a status history, and one idempotent ``reconcile()`` pass
per tick diffs desired against observed state from BOTH sources of
truth (the cloud provider's live node list and the control plane's node
table), issuing only the deltas. Crash-restart safe: every decision is
re-derivable from (instances, provider view, cluster view) — nothing
depends on remembering a previous pass. Reuses v1's bin-packing
(`_unmet_after_packing` / `_nodes_to_launch`) for the sizing decision;
what v2 rearchitects is everything around it.
"""

from __future__ import annotations

import dataclasses
import logging
import time
import uuid
from typing import Any, Dict, List, Optional, Tuple

from ray_tpu_torch.autoscaler.autoscaler import (AutoscalerConfig,
                                                 _nodes_to_launch,
                                                 _unmet_after_packing)
from ray_tpu_torch.autoscaler.node_provider import NodeProvider

logger = logging.getLogger(__name__)

# instance lifecycle states (≈ v2/schema Instance.status values)
QUEUED = "QUEUED"
REQUESTED = "REQUESTED"
ALLOCATED = "ALLOCATED"
RAY_RUNNING = "RAY_RUNNING"
ALLOCATION_FAILED = "ALLOCATION_FAILED"
TERMINATING = "TERMINATING"
TERMINATED = "TERMINATED"

_VALID_TRANSITIONS = {
    QUEUED: {REQUESTED, TERMINATED},
    REQUESTED: {ALLOCATED, ALLOCATION_FAILED},
    ALLOCATED: {RAY_RUNNING, TERMINATING},
    RAY_RUNNING: {TERMINATING},
    ALLOCATION_FAILED: {QUEUED, TERMINATED},
    TERMINATING: {TERMINATED},
    TERMINATED: set(),
}


@dataclasses.dataclass
class Instance:
    instance_id: str
    node_type: str
    status: str = QUEUED
    provider_id: str = ""       # cloud node id once ALLOCATED
    node_id_hex: str = ""       # control-plane node id once RAY_RUNNING
    launch_request_id: str = ""
    retries: int = 0
    updated_at: float = 0.0
    history: List[Any] = dataclasses.field(default_factory=list)


class InstanceManager:
    """Versioned instance table with validated transitions
    (≈ v2/instance_manager/instance_manager.py)."""

    def __init__(self):
        self.instances: Dict[str, Instance] = {}
        self.version = 0

    def create(self, node_type: str, request_id: str) -> Instance:
        inst = Instance(instance_id=uuid.uuid4().hex[:12],
                        node_type=node_type,
                        launch_request_id=request_id,
                        updated_at=time.monotonic())
        inst.history.append((inst.updated_at, QUEUED, "created"))
        self.instances[inst.instance_id] = inst
        self.version += 1
        return inst

    def transition(self, inst: Instance, status: str, reason: str = ""):
        if status not in _VALID_TRANSITIONS[inst.status]:
            raise ValueError(
                f"invalid transition {inst.status} -> {status} "
                f"for {inst.instance_id}")
        inst.status = status
        inst.updated_at = time.monotonic()
        inst.history.append((inst.updated_at, status, reason))
        self.version += 1

    def by_status(self, *statuses: str) -> List[Instance]:
        return [i for i in self.instances.values() if i.status in statuses]

    def gc_terminated(self, keep_s: float = 600.0) -> None:
        cut = time.monotonic() - keep_s
        for iid in [i.instance_id for i in self.instances.values()
                    if i.status == TERMINATED and i.updated_at < cut]:
            del self.instances[iid]


class Reconciler:
    """One idempotent pass: observe, diff, act
    (≈ v2/instance_manager/reconciler.py Reconciler.reconcile)."""

    ALLOCATION_TIMEOUT_S = 120.0
    MAX_ALLOCATION_RETRIES = 3

    def __init__(self, config: AutoscalerConfig, provider: NodeProvider,
                 im: Optional[InstanceManager] = None,
                 idle_timeout_s: float = 60.0):
        self.config = config
        self.provider = provider
        self.im = im or InstanceManager()
        self.idle_timeout_s = idle_timeout_s
        self._idle_since: Dict[str, float] = {}
        # (node_type, expires_at) markers for timed-out allocation
        # requests that may still fill late; consumed by terminating the
        # stray node, and EXPIRED after 2x the allocation timeout so a
        # never-filled stockout can't leave a permanent kill-marker that
        # would reap a legitimate out-of-band node months later
        self._abandoned_requests: List[Tuple[str, float]] = []

    # ---- observation sync ------------------------------------------

    def _sync_provider(self) -> None:
        """Match REQUESTED/ALLOCATED instances against the provider's
        live node list; time out requests the cloud never filled."""
        live = {n["id"]: n for n in self.provider.non_terminated_nodes()}
        claimed = {i.provider_id for i in self.im.instances.values()
                   if i.provider_id}
        for inst in self.im.by_status(REQUESTED):
            # adopt an unclaimed provider node of the right type
            match = next(
                (pid for pid, n in live.items()
                 if n["node_type"] == inst.node_type
                 and pid not in claimed), None)
            if match is not None:
                inst.provider_id = match
                claimed.add(match)
                self.im.transition(inst, ALLOCATED, f"provider {match}")
            elif (time.monotonic() - inst.updated_at
                  > self.ALLOCATION_TIMEOUT_S):
                self.im.transition(inst, ALLOCATION_FAILED,
                                   "allocation timed out (stockout?)")
                # the cloud request is still outstanding: if it fills
                # AFTER the retry's request, the stray node must be
                # terminated, not silently leaked as a billable orphan
                self._abandoned_requests.append(
                    (inst.node_type, time.monotonic()
                     + max(2 * self.ALLOCATION_TIMEOUT_S, 300.0)))
        # reap late fills of abandoned requests: a live provider node no
        # instance claims, of an abandoned type, is terminated (consume
        # one marker per node so legitimate future launches still adopt)
        now = time.monotonic()
        self._abandoned_requests = [
            m for m in self._abandoned_requests if m[1] > now]
        if self._abandoned_requests:
            claimed = {i.provider_id for i in self.im.instances.values()
                       if i.provider_id}
            for pid, n in list(live.items()):
                if pid in claimed:
                    continue
                marker = next((m for m in self._abandoned_requests
                               if m[0] == n["node_type"]), None)
                if marker is not None and not any(
                        i.status == REQUESTED
                        and i.node_type == n["node_type"]
                        for i in self.im.instances.values()):
                    self._abandoned_requests.remove(marker)
                    self.provider.terminate_node(pid)
                    live.pop(pid, None)
        for inst in self.im.by_status(ALLOCATED, RAY_RUNNING):
            if inst.provider_id not in live:
                # the cloud reclaimed it under us (preemption)
                self.im.transition(inst, TERMINATING,
                                   "provider node disappeared")
                self.im.transition(inst, TERMINATED, "gone")

    def _sync_cluster(self, alive_nodes: List[dict]) -> None:
        """Match ALLOCATED instances against registered control-plane
        nodes; detect RAY_RUNNING instances whose node died."""
        by_provider = {}
        for n in alive_nodes:
            pid = n.get("labels", {}).get("provider_id", "")
            if pid:
                by_provider[pid] = n
        for inst in self.im.by_status(ALLOCATED):
            node = by_provider.get(inst.provider_id)
            if node is not None:
                inst.node_id_hex = node["node_id_hex"]
                self.im.transition(inst, RAY_RUNNING,
                                   f"node {inst.node_id_hex[:8]}")
        for inst in self.im.by_status(RAY_RUNNING):
            if inst.provider_id not in by_provider:
                self.im.transition(inst, TERMINATING, "node died")
                self.provider.terminate_node(inst.provider_id)
                self.im.transition(inst, TERMINATED, "terminated")

    # ---- actuation --------------------------------------------------

    def _retry_failed(self) -> None:
        for inst in self.im.by_status(ALLOCATION_FAILED):
            if inst.retries < self.MAX_ALLOCATION_RETRIES:
                inst.retries += 1
                self.im.transition(inst, QUEUED,
                                   f"retry {inst.retries}")
            else:
                self.im.transition(inst, TERMINATED, "retries exhausted")

    def _launch_queued(self) -> None:
        by_type: Dict[str, List[Instance]] = {}
        for inst in self.im.by_status(QUEUED):
            by_type.setdefault(inst.node_type, []).append(inst)
        for type_name, insts in by_type.items():
            nt = next(t for t in self.config.node_types
                      if t.name == type_name)
            try:
                self.provider.create_node(nt, len(insts))
            except Exception as e:
                for inst in insts:
                    self.im.transition(inst, REQUESTED, "create_node")
                    self.im.transition(inst, ALLOCATION_FAILED, str(e))
                continue
            for inst in insts:
                self.im.transition(inst, REQUESTED, "create_node")

    def _desired_new(self, alive: List[dict],
                     demand: List[Dict[str, float]]) -> Dict[str, int]:
        pending = [i for i in self.im.by_status(QUEUED, REQUESTED,
                                                ALLOCATED)]
        pending_types = []
        for i in pending:
            nt = next((t for t in self.config.node_types
                       if t.name == i.node_type), None)
            if nt is not None:
                pending_types.append(nt)
        unmet = _unmet_after_packing(demand, alive, pending_types)
        existing: Dict[str, int] = {}
        for i in self.im.by_status(REQUESTED, ALLOCATED, RAY_RUNNING):
            existing[i.node_type] = existing.get(i.node_type, 0) + 1
        current = len(pending) + len(self.im.by_status(RAY_RUNNING))
        return _nodes_to_launch(unmet, self.config.node_types,
                                current=current,
                                max_workers=self.config.max_workers,
                                existing_by_type=existing)

    def _scale_down_idle(self, alive: List[dict],
                         demand: List[Dict[str, float]]) -> List[str]:
        removed = []
        now = time.monotonic()
        busy_ok = not demand
        by_node = {i.node_id_hex: i
                   for i in self.im.by_status(RAY_RUNNING)}
        for n in alive:
            inst = by_node.get(n["node_id_hex"])
            if inst is None:
                continue
            idle = n["available"] == n["total"]
            if not (idle and busy_ok):
                self._idle_since.pop(inst.instance_id, None)
                continue
            since = self._idle_since.setdefault(inst.instance_id, now)
            if now - since >= self.idle_timeout_s:
                self.im.transition(inst, TERMINATING, "idle timeout")
                self.provider.terminate_node(inst.provider_id)
                self.im.transition(inst, TERMINATED, "terminated")
                removed.append(inst.instance_id)
        return removed

    # ---- the pass ---------------------------------------------------

    def reconcile(self, cluster_state: dict) -> Dict[str, Any]:
        alive = [n for n in cluster_state["nodes"] if n["alive"]]
        demand: List[Dict[str, float]] = []
        for n in alive:
            demand.extend(n.get("pending_demand", []))

        self._sync_provider()
        self._sync_cluster(alive)
        self._retry_failed()

        request_id = uuid.uuid4().hex[:8]
        to_launch = self._desired_new(alive, demand)
        for type_name, count in to_launch.items():
            for _ in range(count):
                self.im.create(type_name, request_id)
        self._launch_queued()
        removed = self._scale_down_idle(alive, demand)
        self.im.gc_terminated()
        return {
            "demand": len(demand),
            "launching": dict(to_launch),
            "removed": removed,
            "instances": {
                s: len(self.im.by_status(s))
                for s in (QUEUED, REQUESTED, ALLOCATED, RAY_RUNNING,
                          ALLOCATION_FAILED, TERMINATING, TERMINATED)},
            "version": self.im.version,
        }
