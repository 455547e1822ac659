"""Serve controller: the reconciling control plane.

Counterpart: ``ray_tpu/serve/_private/controller.py``, without the ASGI
route table (the HTTP proxy and ``serve.ingress`` are not ported). Analog
of `ray.serve._private.controller.ServeController`
(`python/ray/serve/_private/controller.py:86`, deploy_application `:719`)
+ `DeploymentStateManager` (`deployment_state.py:2309`) + the autoscaling
loop (`autoscaling_state.py`): a detached async actor that drives target
replica counts to spec, health-checks replicas, replaces dead ones, and
autoscales on in-flight request counts.
"""

from __future__ import annotations

import asyncio
import logging
import time
from typing import Any, Dict, List, Optional

import ray_tpu_torch as rt

logger = logging.getLogger(__name__)

CONTROLLER_NAME = "SERVE_CONTROLLER"


class _ReplicaHolder:
    """One replica plus its lifecycle state (≈ DeploymentReplica in
    deployment_state.py: STARTING until the first successful health probe,
    then RUNNING). A STARTING replica is only killed after
    INIT_TIMEOUT_S — model replicas legitimately take many seconds to
    construct (worker spawn + framework import + weight init/load), and
    probing them with the steady-state timeout would replace them forever."""

    INIT_TIMEOUT_S = 120.0
    # consecutive missed probes before a READY replica is replaced
    # (≈ the reference's health_check_failure_threshold): one missed
    # 5s probe is routine for a replica busy compiling a new batch
    # shape: killing it then turns every cold shape into an outage
    HEALTH_FAIL_THRESHOLD = 3

    def __init__(self, handle):
        self.handle = handle
        self.created_at = time.time()
        self.health_failures = 0
        self.ready = False


class _DeploymentState:
    def __init__(self, app_name: str, spec: Dict[str, Any]):
        self.app_name = app_name
        self.spec = spec
        self.replicas: List[_ReplicaHolder] = []
        self.version = 0
        self.target = spec["num_replicas"]
        self.status = "UPDATING"
        self.deleted = False
        # prefix-affinity digests: replica key -> the digest
        # its stats last reported; version bumps wake listen_for_digests
        self.digests: Dict[str, Dict[str, Any]] = {}
        self.digest_version = 0
        # serializes scale operations: delete (scale→0) racing the
        # reconcile loop (scale→target) would otherwise livelock,
        # alternately killing and recreating the same replica
        self.lock = asyncio.Lock()

    @property
    def name(self) -> str:
        return self.spec["name"]


class ServeController:
    """Async actor; all methods run on one asyncio loop (max_concurrency
    set high by the deployer) so state mutations are single-threaded."""

    def __init__(self):
        self._apps: Dict[str, Dict[str, _DeploymentState]] = {}
        self._routes: Dict[str, str] = {}  # route_prefix -> "app/ingress"
        self._shutdown = False
        self._loop_task = None
        # long-poll support (≈ python/ray/serve/_private/long_poll.py):
        # routers hold a listen_for_change call open; any replica-set
        # version bump wakes them
        self._change_event = asyncio.Event()
        # separate event for digest pushes: digests churn far faster than
        # replica sets and must not wake every replica-set listener
        self._digest_event = asyncio.Event()

    def _notify_change(self) -> None:
        self._change_event.set()
        self._change_event = asyncio.Event()

    def _notify_digest(self) -> None:
        self._digest_event.set()
        self._digest_event = asyncio.Event()

    async def _ensure_loop(self):
        if self._loop_task is None:
            self._loop_task = asyncio.ensure_future(self._reconcile_loop())

    # ------------------------------------------------------------ deploy

    async def deploy_application(self, app_name: str,
                                 deployment_specs: List[Dict[str, Any]],
                                 route_prefix: Optional[str],
                                 ingress_name: str) -> None:
        await self._ensure_loop()
        app = self._apps.setdefault(app_name, {})
        new_names = {s["name"] for s in deployment_specs}
        # remove deployments dropped from the app
        for name in list(app):
            if name not in new_names:
                app[name].deleted = True
                await self._scale_to(app[name], 0)
                del app[name]
        for spec in deployment_specs:
            if name_state := app.get(spec["name"]):
                name_state.spec = spec
                name_state.target = spec["num_replicas"]
                name_state.version += 1
                self._notify_change()
            else:
                app[spec["name"]] = _DeploymentState(app_name, spec)
        if route_prefix:
            self._routes[route_prefix] = f"{app_name}/{ingress_name}"
        await self._reconcile_once()

    async def delete_application(self, app_name: str) -> None:
        app = self._apps.pop(app_name, None)
        if app:
            for st in app.values():
                st.deleted = True
                await self._scale_to(st, 0)
        self._routes = {r: t for r, t in self._routes.items()
                        if not t.startswith(app_name + "/")}

    # --------------------------------------------------------- reconcile

    async def _reconcile_loop(self):
        while not self._shutdown:
            try:
                await self._reconcile_once()
                await self._autoscale()
                await self._collect_digests()
            except Exception:
                logger.exception("reconcile error")
            await asyncio.sleep(0.5)

    async def _collect_digests(self):
        """Pull each ready replica's prefix digest through its stats —
        the controller POLLS, replicas never push (they make zero
        control-plane RPCs in steady state); routers long-poll
        ``listen_for_digests`` and only wake on real digest churn."""
        for app in self._apps.values():
            for st in app.values():
                fresh: Dict[str, Dict[str, Any]] = {}
                for holder in st.replicas:
                    if not holder.ready:
                        continue
                    try:
                        s = await asyncio.wait_for(
                            holder.handle.stats.remote(), timeout=5)
                    except Exception:
                        continue
                    d = s.get("prefix_digest") or {}
                    if d:
                        fresh[holder.handle._actor_id.hex()] = d
                sig_old = {k: v.get("version")
                           for k, v in st.digests.items()}
                sig_new = {k: v.get("version") for k, v in fresh.items()}
                if sig_new != sig_old:
                    st.digests = fresh
                    st.digest_version += 1
                    self._notify_digest()

    async def _reconcile_once(self):
        for app in list(self._apps.values()):
            for st in list(app.values()):
                if st.deleted:
                    continue
                await self._health_sweep(st)
                await self._scale_to(st, st.target)
                ready = sum(1 for h in st.replicas if h.ready)
                st.status = "RUNNING" if ready == st.target else "UPDATING"

    @staticmethod
    def _init_expired(holder: _ReplicaHolder) -> bool:
        return time.time() - holder.created_at > holder.INIT_TIMEOUT_S

    async def _health_sweep(self, st: _DeploymentState):
        # Probe a snapshot, then REMOVE the dead under the lock. Never
        # assign the snapshot back: a concurrent scale-down could have
        # popped a replica mid-probe, and re-assigning would resurrect it.
        snapshot = list(st.replicas)
        dead = []
        for holder in snapshot:
            try:
                ok = await asyncio.wait_for(
                    holder.handle.check_health.remote(), timeout=5)
                if ok:
                    holder.health_failures = 0
                    if not holder.ready:
                        holder.ready = True
                        st.version += 1  # routers learn of the new replica
                        self._notify_change()
                elif holder.ready or self._init_expired(holder):
                    # the replica RESPONDED unhealthy: no benefit of the
                    # doubt — it told us itself
                    logger.warning(
                        "replica of %s reported unhealthy; replacing", st.name)
                    dead.append(holder)
            except Exception as e:
                from ray_tpu_torch._private.exceptions import ActorDiedError

                if holder.ready:
                    holder.health_failures += 1
                    if isinstance(e, ActorDiedError) or \
                            holder.health_failures >= \
                            holder.HEALTH_FAIL_THRESHOLD:
                        # a dead actor is replaced immediately; a slow
                        # probe needs the full consecutive-miss budget
                        logger.warning(
                            "replica of %s failed health check (%d "
                            "consecutive, %s); replacing", st.name,
                            holder.health_failures, type(e).__name__)
                        dead.append(holder)
                elif self._init_expired(holder):
                    logger.warning(
                        "replica of %s never became ready in %.0fs; replacing",
                        st.name, holder.INIT_TIMEOUT_S)
                    dead.append(holder)
                # else: still STARTING — constructor running; leave it be
        if dead:
            async with st.lock:
                before = len(st.replicas)
                st.replicas = [h for h in st.replicas if h not in dead]
                if len(st.replicas) != before:
                    st.version += 1
                    self._notify_change()
            for h in dead:
                try:
                    rt.kill(h.handle)
                except Exception:
                    pass

    async def _scale_to(self, st: _DeploymentState, n: int):
        from ray_tpu_torch.serve._private.replica import ReplicaActor

        async with st.lock:
            await self._scale_to_locked(st, n, ReplicaActor)

    async def _scale_to_locked(self, st, n, ReplicaActor):
        # Node handoff on deliberate scale-down (opt-in via
        # autoscaling_config["drain_nodes"]). Deletion/teardown (n == 0 on
        # a deleted deployment) never drains: the app is going away, the
        # cluster is not.
        drain = (bool((st.spec.get("autoscaling_config") or {})
                      .get("drain_nodes"))
                 and not st.deleted and n >= 1)
        vacated = set()
        while len(st.replicas) > n:
            holder = st.replicas.pop()
            st.version += 1
            self._notify_change()
            if drain:
                # resolve BEFORE the kill — a dead actor's record may be
                # gone from the controller table by the time we ask
                vacated.add(self._replica_node_hex(holder.handle))
            try:
                await asyncio.wait_for(
                    holder.handle.prepare_for_shutdown.remote(), timeout=15)
            except Exception:
                pass
            try:
                rt.kill(holder.handle)
            except Exception:
                pass
        if vacated:
            self._drain_vacated_nodes(vacated)
        spec = st.spec
        while len(st.replicas) < n:
            actor_opts = dict(spec.get("ray_actor_options") or {})
            actor_opts.setdefault("num_cpus", 0.1)
            handle = rt.remote(ReplicaActor).options(
                max_concurrency=spec.get("max_ongoing_requests", 8),
                **actor_opts,
            ).remote(st.app_name, st.name, spec["callable_factory"],
                     spec.get("init_args", ()), spec.get("init_kwargs", {}))
            if spec.get("user_config") is not None:
                await handle.reconfigure.remote(spec["user_config"])
            st.replicas.append(_ReplicaHolder(handle))
            st.version += 1
            self._notify_change()

    # ----------------------------------------------------- node drain

    @staticmethod
    def _replica_node_hex(handle) -> str:
        """Which node hosts this replica, per the cluster controller's
        actor table ("" if unknown)."""
        from ray_tpu_torch._private import api

        core = api._core
        if core is None:
            return ""
        for _ in range(3):  # actor_get is read-only; retries are free
            try:
                rec = core._run(core.clients.get(core.controller_addr).call(
                    "actor_get",
                    {"actor_id_hex": handle._actor_id.hex()}))
                return (rec or {}).get("node_id_hex") or ""
            except Exception:
                continue
        return ""

    def _drain_vacated_nodes(self, candidates) -> None:
        """Retire nodes vacated by a deliberate scale-down NOW, via the
        cluster controller's node_drain RPC, so their channels, pins and
        leases hand off immediately instead of waiting out the crash
        debounce (the drain reason skips recovery_grace_s on peers).
        Opt-in per deployment (autoscaling_config["drain_nodes"]) because
        a drain takes the whole node — only safe when the autoscaled
        replica pool has its nodes to itself. A node still hosting any
        replica of any app, and the controller's own node, are never
        drained."""
        from ray_tpu_torch._private import api

        core = api._core
        if core is None:
            return
        still_used = set()
        for app in self._apps.values():
            for st in app.values():
                for holder in st.replicas:
                    still_used.add(self._replica_node_hex(holder.handle))
        for hexid in sorted(candidates):
            if not hexid or hexid == core.node_id_hex or hexid in still_used:
                continue
            logger.info("draining vacated node %s after scale-down",
                        hexid[:12])
            for attempt in range(3):  # node_drain is idempotent
                try:
                    core._run(core.clients.get(core.controller_addr).call(
                        "node_drain", {"node_id_hex": hexid}))
                    break
                except Exception:
                    if attempt == 2:
                        logger.exception("node_drain failed for %s",
                                         hexid[:12])

    async def _autoscale(self):
        for app in self._apps.values():
            for st in app.values():
                cfg = st.spec.get("autoscaling_config")
                if not cfg:
                    continue
                stats = []
                for holder in st.replicas:
                    if not holder.ready:
                        continue
                    try:
                        stats.append(await asyncio.wait_for(
                            holder.handle.stats.remote(), timeout=5))
                    except Exception:
                        pass
                if not stats:
                    continue
                total_ongoing = sum(s["ongoing"] for s in stats)
                # queued-but-unscheduled work (the continuous batcher's
                # ray_tpu_serve_queue_depth signal, relayed through
                # replica stats) counts toward load: a replica with all
                # slots busy and a deep backlog reports few "ongoing"
                # requests exactly when more replicas are needed most.
                # max(), not +: a queued NON-streaming request is also
                # held open in "ongoing" for its whole await, so summing
                # would double-count the backlog
                total_queued = int(sum(s.get("queue_depth", 0)
                                       for s in stats))
                load = max(total_ongoing, total_queued)
                target_per = cfg.get("target_ongoing_requests", 2)
                desired = max(
                    cfg.get("min_replicas", 1),
                    min(cfg.get("max_replicas", 1),
                        -(-load // target_per) or
                        cfg.get("min_replicas", 1)))
                if desired != st.target:
                    logger.info(
                        "autoscale %s: %d -> %d (ongoing=%d queued=%d)",
                        st.name, st.target, desired, total_ongoing,
                        total_queued)
                    st.target = desired

    # ------------------------------------------------------------- query

    async def get_replicas(self, app_name: str, deployment_name: str):
        st = self._apps.get(app_name, {}).get(deployment_name)
        if st is None:
            return {"version": -1, "replicas": []}
        # routers only see READY replicas (reference: RUNNING state), so a
        # still-initializing model replica never receives traffic
        return {"version": st.version,
                "replicas": [h.handle for h in st.replicas if h.ready],
                "max_ongoing": st.spec.get("max_ongoing_requests", 8)}

    async def listen_for_change(self, app_name: str, deployment_name: str,
                                known_version: int,
                                timeout_s: float = 30.0):
        """Long-poll: returns the replica set as soon as its version differs
        from `known_version`, or the current (unchanged) state after
        timeout_s so the caller can re-arm. Replaces router interval
        polling (≈ LongPollHost.listen_for_change, long_poll.py)."""
        deadline = asyncio.get_running_loop().time() + timeout_s
        while True:
            st = self._apps.get(app_name, {}).get(deployment_name)
            version = st.version if st is not None else -1
            if version != known_version:
                return await self.get_replicas(app_name, deployment_name)
            remaining = deadline - asyncio.get_running_loop().time()
            if remaining <= 0:
                return await self.get_replicas(app_name, deployment_name)
            ev = self._change_event
            try:
                await asyncio.wait_for(ev.wait(), timeout=remaining)
            except asyncio.TimeoutError:
                pass

    async def get_digests(self, app_name: str, deployment_name: str):
        st = self._apps.get(app_name, {}).get(deployment_name)
        if st is None:
            return {"version": -1, "digests": {}}
        return {"version": st.digest_version, "digests": dict(st.digests)}

    async def listen_for_digests(self, app_name: str, deployment_name: str,
                                 known_version: int,
                                 timeout_s: float = 30.0):
        """Long-poll for prefix-affinity digests, mirroring
        ``listen_for_change``: returns as soon as the digest version moves
        past ``known_version`` (or unchanged state after ``timeout_s``)."""
        deadline = asyncio.get_running_loop().time() + timeout_s
        while True:
            st = self._apps.get(app_name, {}).get(deployment_name)
            version = st.digest_version if st is not None else -1
            if version != known_version:
                return await self.get_digests(app_name, deployment_name)
            remaining = deadline - asyncio.get_running_loop().time()
            if remaining <= 0:
                return await self.get_digests(app_name, deployment_name)
            ev = self._digest_event
            try:
                await asyncio.wait_for(ev.wait(), timeout=remaining)
            except asyncio.TimeoutError:
                pass

    async def get_routes(self) -> Dict[str, str]:
        return dict(self._routes)

    async def status(self) -> Dict[str, Any]:
        out = {}
        for app_name, app in self._apps.items():
            out[app_name] = {
                name: {"status": st.status, "replicas": len(st.replicas),
                       "target": st.target, "version": st.version}
                for name, st in app.items()
            }
        return out

    async def graceful_shutdown(self) -> None:
        self._shutdown = True
        for app_name in list(self._apps):
            await self.delete_application(app_name)
