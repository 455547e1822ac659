"""Per-host supervisor daemon.

Analog of the reference's raylet (`src/ray/raylet/`): one per host,
it owns the worker pool (≈ `worker_pool.cc`), grants task leases with
hybrid/spread scheduling over its synced cluster view
(≈ `NodeManager::HandleRequestWorkerLease` `node_manager.cc:1753` +
`ClusterTaskManager::QueueAndScheduleTask` `cluster_task_manager.h:70`,
including spillback), hosts the node's shared-memory object store in-process
(≈ plasma inside raylet, `object_manager/plasma/store_runner.h`), serves
chunked cross-node object transfer (≈ `PullManager`/`PushManager`), and
reserves placement-group bundles.

GPU specifics: a worker leased for a task or actor that asks for GPUs is
spawned with ``CUDA_VISIBLE_DEVICES`` set to the cards it holds
(≈ reference accelerators/nvidia_gpu.py); every other worker gets
``CUDA_VISIBLE_DEVICES=""`` and sees no card. The variable is fixed for the
life of the process, so the card ids are part of the worker pool's key and
a pooled worker is only reused for the same cards.
"""

from __future__ import annotations

import argparse
import asyncio
import dataclasses
import json
import logging
import os
import subprocess
import sys
import tempfile
import time
from collections import deque
from typing import Any, Deque, Dict, List, Optional, Set, Tuple

from ray_tpu_torch._private import channels, chaos, serialization
from ray_tpu_torch._private.config import Config
from ray_tpu_torch._private.http_util import MetricsHttpServer
from ray_tpu_torch._private.ids import NodeID, ObjectID, WorkerID
from ray_tpu_torch._private.metrics import Counter, Gauge, default_registry
from ray_tpu_torch._private.object_store import NodeObjectStore
from ray_tpu_torch._private.resources import ResourceSet, detect_node_resources
from ray_tpu_torch._private.rpc import (ClientPool, RpcServer, idempotent,
                                  replay_cached, retry_call)
from ray_tpu_torch._private.runtime_env import (RuntimeEnvManager,
                                          runtime_env_cache_key)
from ray_tpu_torch._private.scheduling import NodeView, pick_node
from ray_tpu_torch._private.task_spec import PlacementGroupStrategy, TaskSpec

logger = logging.getLogger(__name__)

_TRACE_PATH = os.environ.get("RAY_TPU_TORCH_TRACE_FILE", "")


def _trace(msg: str) -> None:
    if _TRACE_PATH:
        with open(_TRACE_PATH, "a") as f:
            f.write(f"[sup {os.getpid()} {time.monotonic():.3f}] {msg}\n")

Address = Tuple[str, int]

MAX_SPILLBACK_HOPS = 8


@dataclasses.dataclass
class WorkerHandle:
    worker_id_hex: str
    address: Address
    pid: int
    env_key: str
    proc: Optional[subprocess.Popen] = None
    idle_since: float = 0.0
    leased: bool = False
    is_actor: bool = False
    actor_id_hex: str = ""
    # CUDA_VISIBLE_DEVICES of this process (fixed at spawn), and whether
    # a lease currently holds those cards
    gpus: List[str] = dataclasses.field(default_factory=list)
    gpus_held: bool = False
    # stdout/stderr files + read offsets for log streaming to drivers
    log_paths: Tuple[str, str] = ("", "")
    log_offsets: List[int] = dataclasses.field(
        default_factory=lambda: [0, 0])
    # job that spawned this worker (log routing; pooled workers are
    # per-runtime-env so cross-job reuse is rare but possible)
    job_id_hex: str = ""


@dataclasses.dataclass
class Lease:
    lease_id: int
    worker: WorkerHandle
    resources: ResourceSet
    owner: Optional[Address]
    pg_key: Optional[Tuple[str, int]] = None  # (pg_id_hex, bundle_index)


@dataclasses.dataclass
class _QueuedLease:
    spec: TaskSpec
    future: asyncio.Future
    demand: ResourceSet
    pg_key: Optional[Tuple[str, int]]
    hops: int = 0
    no_spillback: bool = False  # controller-directed placement: never redirect


class Supervisor:
    def __init__(
        self,
        config: Config,
        controller_addr: Address,
        session_dir: str,
        host: str = "127.0.0.1",
        port: int = 0,
        resources: Optional[Dict[str, float]] = None,
        labels: Optional[Dict[str, str]] = None,
        node_name: str = "",
    ):
        self.config = config
        from ray_tpu_torch._private import flight as _flight

        _flight.set_role("supervisor")
        self.node_id = NodeID.from_random()
        self.controller_addr = controller_addr
        self.session_dir = session_dir
        self.node_name = node_name or self.node_id.hex()[:8]
        self.server = RpcServer(host, port)
        self.server.register_object(self)
        self.clients = ClientPool(
            config.rpc_connect_timeout_s, config.rpc_request_timeout_s,
            retry_base_s=config.rpc_retry_interval_ms / 1000.0,
        )
        self.total = (
            ResourceSet.of(resources)
            if resources is not None
            else detect_node_resources(
                object_store_bytes=config.object_store_memory_bytes
            )
        )
        self.available = self.total.copy()
        self.labels = labels or {}
        # structured lifecycle events (≈ src/ray/util/event.h)
        from ray_tpu_torch._private.events import EventLogger

        self.events = EventLogger(f"supervisor_{self.node_name}",
                                  session_dir)
        arena_dir = "/dev/shm" if os.path.isdir("/dev/shm") else session_dir
        self.arena_path = os.path.join(
            arena_dir, f"rtpu_torch_arena_{self.node_id.hex()[:12]}"
        )
        spill_dir = config.object_spilling_dir or os.path.join(
            session_dir, "spill", self.node_id.hex()[:12]
        )
        from ray_tpu_torch._private.external_storage import storage_from_spill_target

        self.store = NodeObjectStore(
            self.arena_path, config.object_store_memory_bytes, spill_dir,
            spill_storage=storage_from_spill_target(
                config.object_spilling_uri, spill_dir),
        )
        # ALL store access rides this one thread (see _store_op): long
        # spills/restores must not block the RPC loop, and one worker
        # keeps the (non-thread-safe) store serialized
        import concurrent.futures

        self._store_exec = concurrent.futures.ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="store")
        # worker pool
        self.workers: Dict[str, WorkerHandle] = {}
        self.idle: Dict[str, Deque[WorkerHandle]] = {}  # env_key -> idle workers
        self._spawn_waiters: Dict[str, Deque[asyncio.Future]] = {}
        # pid -> Popen of spawned-but-not-yet-registered workers; the handle
        # adopts its proc by pid at registration (concurrent spawns must not
        # cross-attribute processes — exit monitoring depends on it)
        self._spawned_procs: Dict[int, subprocess.Popen] = {}
        self.leases: Dict[int, Lease] = {}
        self._next_lease_id = 0
        self._lease_queue: Deque[_QueuedLease] = deque()
        # Leases no node in the current view can satisfy. Kept pending (the
        # reference's infeasible queue, cluster_task_manager.h) and
        # re-evaluated when the gossiped view changes — a joining node (or
        # later, an autoscaled one) rescues them via spillback redirect.
        self._infeasible_leases: List[_QueuedLease] = []
        # placement group bundles: (pg_hex, index) -> [reserved_total, bundle_available]
        self.bundles: Dict[Tuple[str, int], List[ResourceSet]] = {}
        # cluster view cache (synced from controller)
        self.cluster_view: List[NodeView] = []
        self._pulls_in_flight: Dict[ObjectID, asyncio.Future] = {}
        # compiled-graph channels hosted in this node's arena:
        # channel_id bytes -> {"oid", "offset", "size", "participants",
        # "staging"} (see rpc_channel_create). A participant's death —
        # worker exit, driver sweep, node-death view sync — closes every
        # channel it took part in, so its peers raise ChannelClosedError
        # instead of hanging on a version bump that will never come.
        self._channels: Dict[bytes, dict] = {}
        self._sync_task: Optional[asyncio.Task] = None
        self._reap_task: Optional[asyncio.Task] = None
        self._monitor_task: Optional[asyncio.Task] = None
        self._log_task: Optional[asyncio.Task] = None
        self._memory_task: Optional[asyncio.Task] = None
        self._oom_killed: Set[str] = set()
        # worker_id_hex -> supervisor-attributed death reason (OOM kills)
        self._kill_reasons: Dict[str, str] = {}
        # pid -> log paths / owning job for spawned-but-unregistered workers
        self._spawned_log_paths: Dict[int, Tuple[str, str]] = {}
        self._spawned_jobs: Dict[int, str] = {}
        # GPU assignment bookkeeping: the ids this node's workers may be
        # given in CUDA_VISIBLE_DEVICES (the supervisor's own visible ids
        # when they match the GPU count, else 0..n-1)
        n_gpus = int(self.total.get("GPU", 0))
        visible = [g.strip() for g in
                   os.environ.get("CUDA_VISIBLE_DEVICES", "").split(",")
                   if g.strip()]
        self._gpu_free: List[str] = (
            visible if len(visible) == n_gpus
            else [str(i) for i in range(n_gpus)])
        self._gpu_returned = asyncio.Event()
        # worker_failed notices in flight to the owners of dead workers'
        # leases (held until done: the loop keeps tasks only weakly)
        self._owner_notices: Set[asyncio.Task] = set()
        # runtime envs staged on this node (working_dir/py_modules/pip)
        async def _kv_get(ns: str, key: str):
            return await self.clients.get(self.controller_addr).call(
                "kv_get", {"ns": ns, "key": key}, timeout=60)

        self.runtime_envs = RuntimeEnvManager(
            session_dir, self.node_id.hex()[:12], _kv_get)
        # metrics (rendered by the per-node /metrics endpoint)
        self.metrics_server: Optional[MetricsHttpServer] = None
        self._m_leases_granted = Counter(
            "ray_tpu_leases_granted_total", "Worker leases granted")
        self._m_leases_spilled = Counter(
            "ray_tpu_leases_spilled_total", "Leases redirected to other nodes")
        self._m_workers_spawned = Counter(
            "ray_tpu_workers_spawned_total", "Worker processes spawned")
        self._m_worker_exits = Counter(
            "ray_tpu_worker_exits_total", "Worker processes exited")
        self._m_workers = Gauge("ray_tpu_workers", "Live worker processes")
        self._m_queue_depth = Gauge(
            "ray_tpu_lease_queue_depth", "Queued + infeasible leases")
        self._m_store_bytes = Gauge(
            "ray_tpu_object_store_bytes", "Object store usage by kind")
        self._m_transfer_bytes = Counter(
            "ray_tpu_object_transfer_bytes_total",
            "Object bytes pulled from remote nodes (chunked transfer)")
        self._m_transfer_chunks = Counter(
            "ray_tpu_object_transfer_chunks_total",
            "Chunk RPCs completed by the pipelined cross-node pull")
        self._m_pins_released = Counter(
            "ray_tpu_store_pins_released_total",
            "Pins force-released on behalf of dead clients")
        self._m_channels_open = Gauge(
            "ray_tpu_channels_open",
            "Compiled-graph channels currently hosted in this node's arena")
        self._m_channels_closed = Counter(
            "ray_tpu_channels_closed_total",
            "Channels closed, by cause (teardown/participant_death)")
        # node ids seen alive in the synced view; a node leaving this set
        # has its cross-node pull pins force-released (its pulls died
        # with it)
        self._alive_node_hexes: Set[str] = set()
        # first time each known node went MISSING from the synced view
        # (distinct from present-but-dead): drives the recovery-window
        # debounce in _sync_loop
        self._node_missing_since: Dict[str, float] = {}
        # nodes the controller tagged as DELIBERATELY drained
        # (rpc_node_drain): a drained node that later vanishes from the
        # view is reaped immediately — handoff, not crash, so no
        # recovery-grace debounce
        self._drained_node_hexes: Set[str] = set()
        # pin-holding clients that are neither our workers nor nodes
        # (drivers attached to this cluster): last known RPC address and
        # consecutive probe failures, for the liveness sweep that
        # reclaims a SIGKILLed driver's pins
        self._pin_client_addrs: Dict[str, Address] = {}
        self._pin_client_fails: Dict[str, int] = {}
        self._pin_sweep_task: Optional[asyncio.Task] = None
        # clients whose pins were just force/bulk-released: a straggler
        # unpin retry from them is a benign shutdown race, not the
        # protocol bug the strict unpin guards against
        self._released_clients: Dict[str, float] = {}

    # ------------------------------------------------------------- lifecycle

    async def start(self) -> Address:
        addr = await self.server.start()
        ctrl = self.clients.get(self.controller_addr)
        await ctrl.call(
            "node_register",
            {
                "node_id_hex": self.node_id.hex(),
                "address": addr,
                "total": dict(self.total),
                "available": dict(self.available),
                "labels": {**self.labels, "node_name": self.node_name},
            },
        )
        loop = asyncio.get_running_loop()
        self._sync_task = loop.create_task(self._sync_loop())
        self._reap_task = loop.create_task(self._reap_loop())
        self._monitor_task = loop.create_task(self._monitor_loop())
        self._log_task = loop.create_task(self._log_tail_loop())
        self._pin_sweep_task = loop.create_task(self._pin_sweep_loop())
        if self.config.memory_usage_threshold > 0:
            self._memory_task = loop.create_task(self._memory_monitor_loop())
        if self.config.metrics_export_port >= 0:
            try:
                self.metrics_server = MetricsHttpServer(
                    host=self.config.metrics_export_host,
                    port=self.config.metrics_export_port)
                self.metrics_server.route("/metrics", self._render_metrics)
                self.metrics_server.route(
                    "/healthz", lambda: ("text/plain", "ok"))
                await self.metrics_server.start()
            except OSError as e:
                # never fail the data-plane daemon over a scrape endpoint
                logger.warning("metrics endpoint unavailable: %s", e)
                self.metrics_server = None
        logger.info(
            "supervisor %s on %s resources=%s",
            self.node_id.hex()[:8],
            addr,
            dict(self.total),
        )
        return addr

    def _render_metrics(self):
        self._m_workers.set(len(self.workers))
        self._m_queue_depth.set(
            len(self._lease_queue) + len(self._infeasible_leases))
        for kind, value in self.store.stats().items():
            if isinstance(value, (int, float)):
                self._m_store_bytes.set(value, {"kind": kind})
        return ("text/plain; version=0.0.4",
                default_registry().render_prometheus())

    async def rpc_metrics(self, body=None) -> str:
        return self._render_metrics()[1]

    @idempotent
    async def rpc_metrics_all(self, body=None) -> list:
        """This node's full registry set: the supervisor's own exposition
        plus one per live worker (relayed over the worker's `metrics`
        RPC) — `util.state.cluster_metrics(all_nodes=True)` merges these
        with node/component labels so every data-plane metric recorded in
        worker processes is visible cluster-wide."""
        out = [("supervisor", self._render_metrics()[1])]

        async def scrape(w):
            # a mid-exit worker must not fail (or serialize) the scrape
            try:
                return (f"worker:{w.worker_id_hex[:8]}",
                        await self.clients.get(w.address).call(
                            "metrics", {}, timeout=10))
            except Exception:
                return None
        got = await asyncio.gather(
            *(scrape(w) for w in list(self.workers.values())))
        out.extend(g for g in got if g is not None)
        return out

    @idempotent
    async def rpc_flight_dump(self, body=None) -> dict:
        """Drain this node's flight recorders: the supervisor's own rings
        plus (``include_workers``, default true) one dump per live
        worker, relayed over each worker core's ``flight_dump`` RPC."""
        from ray_tpu_torch._private import flight

        dumps = [flight.drain()]
        if not body or body.get("include_workers", True):
            async def one(w):
                # concurrent relay: a wedged worker (the very thing a
                # flight dump is for) costs one 10s timeout, not 10s
                # times its position in the worker list
                try:
                    return await self.clients.get(w.address).call(
                        "flight_dump", {}, timeout=10)
                except Exception:
                    return None  # dead/mid-exit worker: dump what we can
            got = await asyncio.gather(
                *(one(w) for w in list(self.workers.values())))
            dumps.extend(g for g in got if g is not None)
        return {"dumps": dumps}

    @idempotent
    async def rpc_flight_clock(self, body=None) -> dict:
        """Clock-alignment handshake: the driver samples its own wall
        clock around this call and corrects by RTT/2, yielding this
        node's wall-clock offset for the merged timeline. Workers share
        their supervisor's host clock, so one handshake aligns the node."""
        return {"wall_ns": time.time_ns(),
                "perf_ns": time.perf_counter_ns()}

    async def rpc_metrics_port(self, body=None) -> int:
        return self.metrics_server.port if self.metrics_server else -1

    async def stop(self) -> None:
        for t in (self._sync_task, self._reap_task, self._monitor_task,
                  self._log_task, self._memory_task, self._pin_sweep_task):
            if t is not None:
                t.cancel()
        if self.metrics_server is not None:
            await self.metrics_server.stop()
        for w in self.workers.values():
            if w.proc is not None:
                try:
                    w.proc.terminate()
                except Exception:
                    pass
        self.store.shutdown()
        await self.clients.close_all()
        await self.server.stop()

    @idempotent
    async def rpc_ping(self, body=None) -> str:
        return "pong"

    @idempotent
    async def rpc_node_info(self, body=None) -> dict:
        return {
            "node_id_hex": self.node_id.hex(),
            "arena_path": self.arena_path,
            "arena_size": self.config.object_store_memory_bytes,
            "controller": self.controller_addr,
            "address": self.server.address,
            "total": dict(self.total),
        }

    # ------------------------------------------------------------- sync

    async def _sync_loop(self) -> None:
        ctrl = self.clients.get(self.controller_addr)
        while True:
            try:
                sync_resp = await ctrl.call(
                    "node_sync",
                    {
                        "node_id_hex": self.node_id.hex(),
                        "available": dict(self.available),
                        "store_stats": self.store.stats(),
                        # pending demand feeds the autoscaler's bin-packing
                        "pending_demand": [
                            dict(q.demand)
                            for q in list(self._lease_queue)
                            + self._infeasible_leases
                            if not q.future.done()
                        ],
                    },
                    timeout=5,
                )
                if isinstance(sync_resp, dict) and sync_resp.get("unknown_node"):
                    # controller restarted (recovered from snapshot, node
                    # table empty): re-register with current state — the
                    # supervisor-side half of the recovery protocol, so
                    # it gets its own span on the merged flight timeline
                    from ray_tpu_torch._private import flight

                    with flight.span("sup.reregister"):
                        await ctrl.call(
                            "node_register",
                            {
                                "node_id_hex": self.node_id.hex(),
                                "address": self.server.address,
                                "total": dict(self.total),
                                "available": dict(self.available),
                                "labels": {**self.labels,
                                           "node_name": self.node_name},
                            },
                            timeout=5,
                        )
                    logger.warning(
                        "controller restarted: node %s re-registered",
                        self.node_id.hex()[:8])
                views = await ctrl.call("node_views", timeout=5)
                self.cluster_view = [
                    NodeView(
                        node_id_hex=v["node_id_hex"],
                        address=tuple(v["address"]),
                        total=ResourceSet.of(v["total"]),
                        available=ResourceSet.of(v["available"]),
                        alive=v["alive"],
                        labels=v.get("labels", {}),
                    )
                    for v in views
                ]
                self._reevaluate_infeasible()
                self._reevaluate_queued()
                # a dead node's in-flight pulls pinned objects here under
                # "node:<hex>" — reclaim them so spill/free unblock.
                # "Dead" must be read carefully: a node PRESENT in the
                # view with alive=False died authoritatively (health
                # loop / drain) and reaps immediately; a node MISSING
                # from the view entirely is indeterminate — a freshly
                # RESTARTED controller serves an empty node table until
                # peers re-register, and reaping on that first sync used
                # to close healthy cross-node channels mid-recovery.
                # Missing nodes are debounced by the health grace window
                # before their pins/channels are swept (so a node that
                # truly never returns after a controller outage still
                # gets the dead-client sweep).
                alive_now = {v.node_id_hex for v in self.cluster_view
                             if v.alive}
                dead_now = {v.node_id_hex for v in self.cluster_view
                            if not v.alive}
                # remember the drain tag while the dead record is still
                # served: once a controller restart tombstones it out of
                # the view, "missing + was-drained" must still reap
                # immediately instead of riding the crash debounce
                self._drained_node_hexes.update(
                    v["node_id_hex"] for v in views if v.get("drained"))
                for back in alive_now - self._alive_node_hexes:
                    # a flapped node re-registered: let its pulls pin
                    # again (fresh pins; the released ones stay released).
                    # The bump starts a fresh pin-accounting incarnation
                    # BEFORE pins are re-admitted, so a still-pending
                    # release of the old incarnation cannot reclaim them
                    if f"node:{back}" in self._released_clients:
                        await self._store_op(
                            self.store.bump_client_epoch, f"node:{back}")
                        self._released_clients.pop(f"node:{back}", None)
                    self._drained_node_hexes.discard(back)
                for gone in self._node_liveness_reap(
                        alive_now, dead_now, time.monotonic()):
                    await self._release_dead_client_pins(
                        f"node:{gone}", "node")
            except Exception as e:
                logger.debug("sync failed: %s", e)
            await asyncio.sleep(0.2)

    def _node_liveness_reap(self, alive_now: Set[str], dead_now: Set[str],
                            now: float) -> Set[str]:
        """Which previously-alive nodes to sweep this sync tick.

        A node PRESENT in the view with alive=False died authoritatively
        (health loop / drain): reap immediately. A node MISSING from the
        view entirely is indeterminate — a freshly RESTARTED controller
        serves an empty node table until peers re-register, and reaping
        on that first sync closed healthy cross-node channels
        mid-recovery — so missing nodes are debounced by the health
        grace window (a node that truly never returns after a controller
        outage still gets the dead-client sweep). Updates
        ``_alive_node_hexes`` / ``_node_missing_since``."""
        grace = self.config.recovery_grace_s()
        to_reap: Set[str] = set()
        for gone in self._alive_node_hexes - alive_now:
            if gone == self.node_id.hex():
                continue
            if gone in dead_now or gone in self._drained_node_hexes:
                # authoritative death — or a DELIBERATE drain
                # (rpc_node_drain) whose record already left the view:
                # a drained node handed its channels/pins off on
                # purpose, so peers reap immediately, never debounced
                # like an indeterminate crash
                to_reap.add(gone)
                continue
            first = self._node_missing_since.setdefault(gone, now)
            if now - first > grace:
                to_reap.add(gone)
        for back in alive_now:
            self._node_missing_since.pop(back, None)
        for gone in to_reap:
            self._node_missing_since.pop(gone, None)
            self._drained_node_hexes.discard(gone)
        self._alive_node_hexes = (
            (self._alive_node_hexes | alive_now) - to_reap - dead_now)
        return to_reap

    def _try_spill(self, q: _QueuedLease, candidates: List[NodeView]) -> bool:
        """Redirect a queued lease to a remote node if policy picks one.

        Single site for the spillback decision shared by the infeasible and
        queued re-evaluation paths. Returns True if the lease was answered
        with a redirect.
        """
        if q.no_spillback or q.pg_key is not None or q.hops >= MAX_SPILLBACK_HOPS:
            return False
        chosen = pick_node(
            candidates,
            dict(q.demand),
            q.spec.strategy,
            local_node_hex=self.node_id.hex(),
            spread_threshold=self.config.scheduler_spread_threshold,
        )
        if chosen is None or chosen.node_id_hex == self.node_id.hex():
            return False
        _trace(f"spill {q.spec.name} -> {chosen.node_id_hex[:6]} hops={q.hops + 1}")
        self._m_leases_spilled.inc()
        q.future.set_result(
            {"granted": False, "retry_at": chosen.address, "hops": q.hops + 1}
        )
        return True

    def _reevaluate_infeasible(self) -> None:
        """Rescue parked leases once the view offers a feasible node."""
        if not self._infeasible_leases:
            return
        from ray_tpu_torch._private.scheduling import node_satisfies_labels

        my_labels = {**self.labels, "node_name": self.node_name}
        still: List[_QueuedLease] = []
        for q in self._infeasible_leases:
            if q.future.done():
                continue
            # local requeue needs BOTH resources and labels: a lease
            # parked for a hard label mismatch stays infeasible HERE no
            # matter how much capacity frees up — only a spill to a
            # label-satisfying node can serve it
            if self._feasible(q.demand, q.pg_key) and \
                    node_satisfies_labels(q.spec.strategy, my_labels):
                self._lease_queue.append(q)
                self._pump_lease_queue()
                continue
            if not self._try_spill(q, list(self.cluster_view)):
                still.append(q)
        self._infeasible_leases = still

    def _reevaluate_queued(self) -> None:
        """Spill queued-but-unserved leases to nodes that can run them now.

        A lease that arrived while our cluster view was stale (e.g. a burst
        right after a node joined) queues locally and would serialize behind
        running tasks. The reference re-runs its scheduling policy over the
        queued tasks on every cluster-state change and spills them
        (ClusterTaskManager::ScheduleAndDispatchTasks); we do the same on
        each 0.2s view sync: anything we cannot grant from local available
        redirects to a remote node with capacity right now.
        """
        if not self._lease_queue:
            return
        keep: Deque[_QueuedLease] = deque()
        for q in self._lease_queue:
            if q.future.done():
                continue
            if q.pg_key is not None or self._available_for(None).fits(q.demand):
                keep.append(q)  # grantable locally soon; stay put
                continue
            remote = [
                v
                for v in self.cluster_view
                if v.node_id_hex != self.node_id.hex()
                and v.schedulable_now(q.demand)
            ]
            if not (remote and self._try_spill(q, remote)):
                keep.append(q)
        self._lease_queue = keep
        self._pump_lease_queue()

    # ------------------------------------------------------------- leases

    @replay_cached
    async def rpc_request_lease(self, body) -> dict:
        """Grant a worker lease for a task, spill back, or queue.

        ≈ NodeManager::HandleRequestWorkerLease (node_manager.cc:1753).
        Replay-cached: a duplicated/retried request whose first grant's
        reply was lost must get the SAME grant back — re-executing would
        lease a second worker nobody releases.
        """
        chaos.maybe_crash("sup.request_lease")
        spec: TaskSpec = serialization.loads(body["spec"])
        no_spillback = body.get("no_spillback", False)
        hops = body.get("hops", 0)
        demand = ResourceSet.of(spec.required_resources())

        pg_key: Optional[Tuple[str, int]] = None
        if isinstance(spec.strategy, PlacementGroupStrategy):
            pg_key = (spec.strategy.pg_id_hex, spec.strategy.bundle_index)
            if pg_key not in self.bundles:
                return {"granted": False, "error": f"bundle {pg_key} not on this node"}
        elif not no_spillback and hops < MAX_SPILLBACK_HOPS:
            # Use the live local state (minus demand already queued here) in
            # place of the possibly-stale synced view of ourselves, so a burst
            # of lease requests spills over instead of piling up locally.
            view = [v for v in self.cluster_view if v.node_id_hex != self.node_id.hex()]
            view.append(self._live_self_view())
            chosen = pick_node(
                view,
                spec.required_resources(),
                spec.strategy,
                local_node_hex=self.node_id.hex(),
                spread_threshold=self.config.scheduler_spread_threshold,
            )
            _trace(
                f"lease {spec.name} hops={hops} "
                f"chosen={chosen.node_id_hex[:6] if chosen else None}"
            )
            if chosen is not None and chosen.node_id_hex != self.node_id.hex():
                return {
                    "granted": False,
                    "retry_at": chosen.address,
                    "hops": hops + 1,
                }

        from ray_tpu_torch._private.scheduling import node_satisfies_labels

        labels_ok = node_satisfies_labels(
            spec.strategy, {**self.labels, "node_name": self.node_name})
        if not self._feasible(demand, pg_key) or not labels_ok:
            # No error: park it (reference keeps an infeasible queue and
            # warns, cluster_task_manager). A node that can host it may
            # join / sync in later; until then the demand is advertised to
            # the controller for the autoscaler. A hard label mismatch is
            # infeasible HERE no matter the resources — granting locally
            # would silently violate the constraint.
            logger.warning(
                "infeasible demand %s on node %s (total=%s, labels_ok=%s) "
                "— queued until the cluster view offers a feasible node",
                dict(demand), self.node_id.hex()[:8], dict(self.total),
                labels_ok)
            fut = asyncio.get_running_loop().create_future()
            self._infeasible_leases.append(
                _QueuedLease(spec, fut, demand, pg_key, hops,
                             no_spillback=no_spillback))
            return await fut

        fut = asyncio.get_running_loop().create_future()
        self._lease_queue.append(
            _QueuedLease(spec, fut, demand, pg_key, hops,
                         no_spillback=no_spillback))
        self._pump_lease_queue()
        return await fut

    def _live_self_view(self) -> NodeView:
        """Self view net of demand already queued for leasing here."""
        avail = self.available.copy()
        for q in self._lease_queue:
            if q.pg_key is None and not q.future.done():
                for k, v in q.demand.items():
                    cur = avail.get(k, 0.0) - v
                    if cur <= 0:
                        avail.pop(k, None)
                    else:
                        avail[k] = cur
        return NodeView(
            node_id_hex=self.node_id.hex(),
            address=self.server.address,
            total=self.total,
            available=avail,
            labels={**self.labels, "node_name": self.node_name},
            alive=True,
        )

    def _feasible(self, demand: ResourceSet, pg_key) -> bool:
        if pg_key is not None:
            reserved = self.bundles.get(pg_key)
            return reserved is not None and reserved[0].fits(demand)
        return self.total.fits(demand)

    def _available_for(self, pg_key) -> ResourceSet:
        if pg_key is not None:
            return self.bundles[pg_key][1]
        return self.available

    def _pump_lease_queue(self) -> None:
        """Grant queued leases FIFO while resources allow."""
        made_progress = True
        while made_progress and self._lease_queue:
            made_progress = False
            q = self._lease_queue[0]
            if q.future.done():
                self._lease_queue.popleft()
                made_progress = True
                continue
            if q.pg_key is not None and q.pg_key not in self.bundles:
                q.future.set_result(
                    {"granted": False, "error": "placement group removed"}
                )
                self._lease_queue.popleft()
                made_progress = True
                continue
            pool = self._available_for(q.pg_key)
            if not pool.fits(q.demand):
                break  # strict FIFO to avoid starvation
            pool.subtract(q.demand)
            self._lease_queue.popleft()
            made_progress = True
            asyncio.get_running_loop().create_task(self._grant(q))

    async def _grant(self, q: _QueuedLease) -> None:
        spec = q.spec
        gpus: List[str] = []
        try:
            gpus = await self._take_gpus(int(q.demand.get("GPU", 0)))
            worker = await self._acquire_worker(spec, gpus)
        except Exception as e:
            if gpus:
                self._gpu_free.extend(gpus)
                self._gpu_returned.set()
            if q.pg_key is None or q.pg_key in self.bundles:
                self._available_for(q.pg_key).add(q.demand)
            self._pump_lease_queue()
            if not q.future.done():
                q.future.set_result({"granted": False, "error": f"worker spawn failed: {e}"})
            return
        self._next_lease_id += 1
        lease = Lease(
            lease_id=self._next_lease_id,
            worker=worker,
            resources=q.demand,
            owner=spec.owner,
            pg_key=q.pg_key,
        )
        worker.leased = True
        self._m_leases_granted.inc()
        worker.gpus_held = bool(gpus)
        self.leases[lease.lease_id] = lease
        if not q.future.done():
            q.future.set_result(
                {
                    "granted": True,
                    "lease_id": lease.lease_id,
                    "worker_id_hex": worker.worker_id_hex,
                    "worker_address": worker.address,
                    "node_id_hex": self.node_id.hex(),
                }
            )
        else:
            await self._release(lease.lease_id)

    @idempotent  # _release of a popped lease id is a no-op
    async def rpc_release_lease(self, body) -> None:
        await self._release(body["lease_id"])

    async def _release(self, lease_id: int) -> None:
        lease = self.leases.pop(lease_id, None)
        if lease is None:
            return
        if lease.pg_key is not None:
            if lease.pg_key in self.bundles:
                self.bundles[lease.pg_key][1].add(lease.resources)
        else:
            self.available.add(lease.resources)
        w = lease.worker
        _trace(f"release lease={lease_id} w={w.worker_id_hex[:8]} is_actor={w.is_actor} in_workers={w.worker_id_hex in self.workers}")
        if w.worker_id_hex in self.workers and not w.is_actor:
            w.leased = False
            w.idle_since = time.monotonic()
            self._return_gpus(w)
            self.idle.setdefault(w.env_key, deque()).append(w)
        self._pump_lease_queue()

    # ------------------------------------------------------------- worker pool

    async def _take_gpus(self, n: int) -> List[str]:
        """The card ids for a granted lease. The GPU resource comes back
        when an actor's lease is released, its card when the actor's
        process has exited: wait for that, as long as a worker may take
        to register."""
        deadline = time.monotonic() + self.config.worker_register_timeout_s
        while n > len(self._gpu_free):
            left = deadline - time.monotonic()
            if left <= 0:
                raise RuntimeError(
                    f"lease needs {n} GPU(s) but only {self._gpu_free} "
                    "are free")
            self._gpu_returned.clear()
            try:
                await asyncio.wait_for(self._gpu_returned.wait(), left)
            except asyncio.TimeoutError:
                pass
        self._gpu_free.sort(key=lambda g: (len(g), g))
        taken, self._gpu_free = self._gpu_free[:n], self._gpu_free[n:]
        return taken

    def _return_gpus(self, w: WorkerHandle) -> None:
        if w.gpus_held:
            self._gpu_free.extend(w.gpus)
            w.gpus_held = False
            self._gpu_returned.set()

    def _env_key_for(self, spec: TaskSpec, gpus: List[str]) -> str:
        key = {"gpus": ",".join(gpus),
               "env": runtime_env_cache_key(spec.runtime_env)}
        return repr(key)

    def _worker_env(self, spec: TaskSpec, gpus: List[str]) -> Dict[str, str]:
        env = dict(os.environ)
        env.update((spec.runtime_env or {}).get("env_vars", {}))
        # set before the worker starts, so nothing in it can initialize
        # CUDA on another card; "" hides every card from GPU-less workers
        env["CUDA_VISIBLE_DEVICES"] = ",".join(gpus)
        return env

    async def _acquire_worker(self, spec: TaskSpec,
                              gpus: List[str]) -> WorkerHandle:
        env_key = self._env_key_for(spec, gpus)
        pool = self.idle.setdefault(env_key, deque())
        while pool:
            w = pool.popleft()
            if w.worker_id_hex in self.workers and (w.proc is None or w.proc.poll() is None):
                return w
        return await self._spawn_worker(spec, env_key, gpus)

    async def _spawn_worker(self, spec: TaskSpec, env_key: str,
                            gpus: List[str]) -> WorkerHandle:
        from ray_tpu_torch._private.watchdog import owner_env

        env = owner_env(self._worker_env(spec, gpus))  # workers die with us
        env["RAY_TPU_TORCH_WORKER_ENV_KEY"] = env_key
        env_spec = await self.runtime_envs.setup(spec.runtime_env)
        extra_pp = env_spec.env_vars.pop("RAY_TPU_TORCH_RUNTIME_ENV_PYTHONPATH", "")
        if extra_pp:
            env["PYTHONPATH"] = (
                extra_pp + os.pathsep + env["PYTHONPATH"]
                if env.get("PYTHONPATH") else extra_pp)
        env.update(env_spec.env_vars)
        cmd = [
            env_spec.python,
            "-m",
            "ray_tpu_torch._private.workers.default_worker",
            "--supervisor",
            f"{self.server.address[0]}:{self.server.address[1]}",
            "--controller",
            f"{self.controller_addr[0]}:{self.controller_addr[1]}",
            "--node-id",
            self.node_id.hex(),
            "--arena-path",
            self.arena_path,
            "--arena-size",
            str(self.config.object_store_memory_bytes),
            "--session-dir",
            self.session_dir,
        ]
        log_dir = os.path.join(self.session_dir, "logs")
        os.makedirs(log_dir, exist_ok=True)
        wtag = f"worker-{len(self.workers)}-{os.getpid()}-{time.monotonic_ns() % 100000}"
        out = open(os.path.join(log_dir, wtag + ".out"), "ab")
        err = open(os.path.join(log_dir, wtag + ".err"), "ab")
        # workers run from the staged working_dir (imports + relative IO);
        # the venv interpreter still needs ray_tpu_torch importable — inherit
        # our package root on PYTHONPATH
        pkg_root = os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))))
        if pkg_root not in env.get("PYTHONPATH", "").split(os.pathsep):
            env["PYTHONPATH"] = (
                env["PYTHONPATH"] + os.pathsep + pkg_root
                if env.get("PYTHONPATH") else pkg_root)
        env_file = None
        if env_spec.container:
            # wrap in an engine run: host net/IPC, session dir + package
            # root + /dev/shm mounted, env forwarded explicitly
            cmd = env_spec.wrap_command(
                cmd, env, mounts=[self.session_dir, pkg_root, "/dev/shm",
                                  tempfile.gettempdir()],
                # env-file lives in the session dir: 0600, never visible
                # in ps/argv, deleted below once the engine consumed it
                env_file_dir=self.session_dir)
            env_file = env_spec.env_files.pop() if env_spec.env_files \
                else None
        try:
            proc = subprocess.Popen(cmd, env=env, stdout=out, stderr=err,
                                    cwd=env_spec.cwd)
        except Exception:
            # engine/interpreter missing: the secrets env-file must not
            # outlive the failed spawn (the registration-wait cleanup
            # below is never reached)
            if env_file is not None:
                try:
                    os.unlink(env_file)
                except OSError:
                    pass
            out.close()
            err.close()
            raise
        out.close()  # child holds its own duplicates; keeping ours leaks fds
        err.close()
        self._spawned_log_paths[proc.pid] = (out.name, err.name)
        self._m_workers_spawned.inc()
        self.events.emit("WORKER_SPAWNED",
                         f"pid {proc.pid} for {spec.name}",
                         pid=proc.pid, task_name=spec.name)
        self._spawned_procs[proc.pid] = proc
        self._spawned_jobs[proc.pid] = spec.job_id.hex() if spec.job_id else ""
        fut: asyncio.Future = asyncio.get_running_loop().create_future()
        self._spawn_waiters.setdefault(env_key, deque()).append(fut)
        try:
            handle: WorkerHandle = await asyncio.wait_for(
                fut, timeout=self.config.worker_register_timeout_s
            )
        except asyncio.TimeoutError:
            try:
                self._spawn_waiters.get(env_key, deque()).remove(fut)
            except ValueError:
                pass
            self._spawned_procs.pop(proc.pid, None)
            self._spawned_log_paths.pop(proc.pid, None)
            self._spawned_jobs.pop(proc.pid, None)
            proc.kill()
            raise RuntimeError(
                f"worker failed to register within "
                f"{self.config.worker_register_timeout_s}s (see {log_dir}/{wtag}.err)"
            )
        finally:
            # the engine parsed --env-file at launch; registration (or
            # the kill above) means it is consumed — don't leave secrets
            # on disk for the session's lifetime
            if env_file is not None:
                try:
                    os.unlink(env_file)
                except OSError:
                    pass
        handle.gpus = list(gpus)  # same env key, same cards
        _trace(f"spawned {handle.worker_id_hex[:8]} pid={handle.pid}")
        return handle

    @replay_cached  # re-execution re-pops _spawned_procs empty: the handle
    async def rpc_worker_register(self, body) -> dict:  # loses its Popen
        handle = WorkerHandle(
            worker_id_hex=body["worker_id_hex"],
            address=tuple(body["address"]),
            pid=body["pid"],
            env_key=body.get("env_key", ""),
            idle_since=time.monotonic(),
            # bind the Popen by the worker's own pid — never by spawn order
            proc=self._spawned_procs.pop(body["pid"], None),
            log_paths=self._spawned_log_paths.pop(body["pid"], ("", "")),
            job_id_hex=self._spawned_jobs.pop(body["pid"], ""),
        )
        self.workers[handle.worker_id_hex] = handle
        waiters = self._spawn_waiters.get(handle.env_key)
        if waiters:
            while waiters:
                fut = waiters.popleft()
                if not fut.done():
                    fut.set_result(handle)
                    break
        return {"node_id_hex": self.node_id.hex()}

    @idempotent  # sets the same two fields
    async def rpc_worker_set_actor(self, body) -> None:
        """Mark a worker as hosting an actor (exempt from pool reuse/reaping)."""
        w = self.workers.get(body["worker_id_hex"])
        _trace(f"set_actor {body['worker_id_hex'][:8]} found={w is not None}")
        if w is not None:
            w.is_actor = True
            w.actor_id_hex = body["actor_id_hex"]

    @idempotent  # killing a dead pid is a no-op
    async def rpc_kill_worker(self, body) -> None:
        w = self.workers.get(body["worker_id_hex"])
        if w is not None and w.proc is not None:
            try:
                w.proc.kill()
            except Exception:
                pass

    @idempotent
    async def rpc_gpu_visible_devices(self, body) -> list:
        w = self.workers.get(body["worker_id_hex"])
        return w.gpus if w else []

    @idempotent
    async def rpc_worker_profile(self, body) -> dict:
        """Relay an on-demand live profile request to one of our workers
        (ref dashboard reporter_agent.py:391; collectors in
        _private/profiling.py). Also lists workers when none named."""
        wid = body.get("worker_id_hex", "")
        if not wid:
            return {"workers": [
                {"worker_id_hex": w.worker_id_hex, "pid": w.pid,
                 "is_actor": w.is_actor, "actor_id_hex": w.actor_id_hex}
                for w in self.workers.values()]}
        w = self.workers.get(wid)
        if w is None:
            raise ValueError(f"no worker {wid} on this node")
        return await self.clients.get(w.address).call(
            "profile", {"kind": body.get("kind", "stack"),
                        "limit": body.get("limit", 20)}, timeout=30)

    async def _monitor_loop(self) -> None:
        """Detect worker process exits (≈ raylet socket-disconnect detection,
        node_manager.cc:1432). The loop must survive any handler error —
        a dead monitor means no failure detection for the whole node."""
        while True:
            await asyncio.sleep(0.2)
            for w in list(self.workers.values()):
                try:
                    if w.proc is not None and w.proc.poll() is not None:
                        await self._on_worker_exit(w)
                except Exception:
                    logger.exception("worker-exit handling failed for %s", w.worker_id_hex[:8])

    async def _release_dead_client_pins(self, client: str, what: str) -> None:
        """A pinning client died: reclaim its pins so spill/free unblock
        (a leaked pin would otherwise block spilling that object forever).

        The release is epoch-bounded to the incarnation that was current
        when THIS death was observed: closing channels below awaits peer
        RPCs, and a reusable client id ("node:<hex>") can flap back and
        re-pin (under a bumped epoch) before the release store-op runs —
        the bound keeps the late release off the new incarnation's pins."""
        dead_epoch = self.store.client_epoch(client)
        self._close_client_channels(client, cause="participant_death")
        self._mark_client_released(client)
        try:
            released = await self._store_op(
                self.store.release_client_pins, client, dead_epoch + 1)
        except Exception:
            logger.exception("pin release for dead %s %s failed", what, client)
            return
        if released:
            self._m_pins_released.inc(released)
            logger.warning("released %d pin(s) held by dead %s %s",
                           released, what, client[:16])

    def _mark_client_released(self, client: str) -> None:
        """Remember a bulk-released client for a while: its in-flight
        unpin retries are a benign race, not a double-unpin bug."""
        now = time.monotonic()
        self._released_clients[client] = now
        self._pin_client_addrs.pop(client, None)
        self._pin_client_fails.pop(client, None)
        # keep entries past the longest locate RPC budget (600s) so even
        # the most delayed straggler cannot re-pin for a released client
        for c, t in list(self._released_clients.items()):
            if now - t > 1200:
                del self._released_clients[c]

    def _log_unpin_rejects(self, client: str, errors) -> None:
        """Strict-unpin rejections are protocol bugs — unless the client
        was just bulk-released (shutdown/reclaim racing a retry)."""
        level = (logger.debug if client in self._released_clients
                 else logger.error)
        for e in errors:
            level("store_unpin rejected: %s", e)

    async def _pin_sweep_loop(self) -> None:
        """Reclaim pins of crashed DRIVERS. Workers are covered by the
        exit monitor, remote nodes by the view sync — a driver that was
        SIGKILLed while holding zero-copy views is covered by nobody, so
        probe pin-holding non-worker clients at their recorded RPC
        address and release after 3 consecutive connect failures (the
        health-check pattern the controller uses for nodes; a live but
        busy driver still accepts TCP on its IO loop)."""
        while True:
            await asyncio.sleep(5.0)
            try:
                clients = await self._store_op(self.store.pinned_clients)
                for client in clients:
                    if client in self.workers or client.startswith("node:"):
                        continue
                    addr = self._pin_client_addrs.get(client)
                    if addr is None:
                        continue  # pre-address pin (legacy/unknown): skip
                    try:
                        await self.clients.get(tuple(addr)).call(
                            "ping", timeout=3)
                        self._pin_client_fails.pop(client, None)
                    except Exception:
                        fails = self._pin_client_fails.get(client, 0) + 1
                        self._pin_client_fails[client] = fails
                        # a connection churn must not steal pins under a
                        # live view: require sustained unreachability
                        if fails >= 3:
                            self.clients.drop(tuple(addr))
                            await self._release_dead_client_pins(
                                client, "driver")
            except Exception:
                logger.exception("pin liveness sweep failed")

    async def _on_worker_exit(self, w: WorkerHandle) -> None:
        _trace(f"worker_exit {w.worker_id_hex[:8]} is_actor={w.is_actor} actor={w.actor_id_hex[:8]} code={w.proc.poll() if w.proc else None}")
        self.workers.pop(w.worker_id_hex, None)
        self._m_worker_exits.inc()
        await self._release_dead_client_pins(w.worker_id_hex, "worker")
        await self._drain_worker_logs(w)
        try:
            self.idle.get(w.env_key, deque()).remove(w)
        except ValueError:
            pass
        exitcode = w.proc.poll() if w.proc is not None else None
        reason = self._kill_reasons.pop(
            w.worker_id_hex, f"worker exited with code {exitcode}")
        self._oom_killed.discard(w.worker_id_hex)
        self.events.emit(
            "WORKER_EXITED", f"worker {w.worker_id_hex[:8]}: {reason}",
            severity="INFO" if exitcode == 0 else "WARNING",
            worker_id=w.worker_id_hex, exitcode=exitcode, reason=reason)
        # fail leases bound to this worker, give its cards back (its process
        # has exited), then tell the owners. The owner may have died with
        # the worker (an actor killed together with the actor that made
        # it, as serve.shutdown kills a replica's controller): a notice to
        # a dead address retries its connect for rpc_connect_timeout_s,
        # and neither the lease, nor the card, nor the next worker exit
        # waits for that
        leases = [l for l in self.leases.values() if l.worker is w]
        for lease in leases:
            await self._release(lease.lease_id)
        self._return_gpus(w)
        for lease in leases:
            if lease.owner is not None:
                self._notify_owner(lease.owner, {
                    "worker_id_hex": w.worker_id_hex,
                    "exitcode": exitcode,
                    "reason": reason,
                })
        if w.is_actor:
            try:
                # the controller's restart accounting depends on this
                # landing: ride out a controller restart window
                await retry_call(
                    self.clients.get(self.controller_addr),
                    "worker_died",
                    {
                        "worker_id_hex": w.worker_id_hex,
                        "actor_id_hex": w.actor_id_hex,
                        "reason": reason,
                    },
                    timeout=15, per_call_timeout=5,
                    base_interval_s=self.config.rpc_retry_interval_ms / 1000.0,
                )
            except Exception:
                pass

    def _notify_owner(self, owner, body) -> None:
        """Send a lease owner ``worker_failed`` on a task of its own."""
        async def notify():
            try:
                await self.clients.get(owner).notify("worker_failed", body)
            except Exception:
                pass  # the owner is gone too: nothing to tell

        task = asyncio.get_running_loop().create_task(notify())
        self._owner_notices.add(task)
        task.add_done_callback(self._owner_notices.discard)

    async def _log_tail_loop(self) -> None:
        """Stream worker stdout/stderr to drivers (log_to_driver): tail
        each worker's log files and publish new lines through the
        controller pubsub (channel 'worker_logs'); drivers subscribe and
        print (≈ the reference's log monitor, log_monitor.py)."""
        ctrl = self.clients.get(self.controller_addr)
        while True:
            await asyncio.sleep(0.5)
            try:
                batches, commits = self._collect_new_log_lines()
                for msg in batches:
                    await ctrl.notify(
                        "publish", {"channel": "worker_logs", "message": msg})
                # advance offsets only after the publishes went out — a
                # transient controller outage must re-send, not drop
                for w, i, off in commits:
                    w.log_offsets[i] = off
            except Exception:
                logger.debug("log tail failed", exc_info=True)

    def _collect_new_log_lines(self, workers=None, final: bool = False):
        """Returns (messages, commits); commits are (worker, stream_index,
        new_offset) the CALLER applies after the messages were delivered —
        offsets must not advance past lines that never reached a driver."""
        out: List[dict] = []
        commits: List[tuple] = []
        for w in (workers if workers is not None
                  else list(self.workers.values())):
            for i, path in enumerate(w.log_paths):
                if not path:
                    continue
                try:
                    with open(path, "rb") as f:
                        f.seek(w.log_offsets[i])
                        data = f.read(1024 * 1024)
                except OSError:
                    continue
                if not data:
                    continue
                # only consume up to the last newline so a chunk landing
                # mid-line isn't split into two fake lines (a dead
                # worker's trailing partial line IS final output)
                if not final:
                    cut = data.rfind(b"\n")
                    if cut < 0:
                        continue
                    data = data[:cut + 1]
                lines = data.decode(errors="replace").splitlines()
                if lines:
                    commits.append((w, i, w.log_offsets[i] + len(data)))
                    out.append({
                        "pid": w.pid,
                        "worker_id_hex": w.worker_id_hex,
                        "node": self.node_name,
                        "job_id_hex": w.job_id_hex,
                        "stream": "stdout" if i == 0 else "stderr",
                        "lines": lines,
                    })
        return out, commits

    async def _drain_worker_logs(self, w: WorkerHandle) -> None:
        """Publish a dead worker's remaining output — the crash traceback
        is exactly the part written after the last poll tick."""
        try:
            ctrl = self.clients.get(self.controller_addr)
            msgs, commits = self._collect_new_log_lines([w], final=True)
            for msg in msgs:
                await ctrl.notify(
                    "publish", {"channel": "worker_logs", "message": msg})
            for worker, i, off in commits:
                worker.log_offsets[i] = off
        except Exception:
            logger.debug("final log drain failed", exc_info=True)

    # ------------------------------------------------------------ OOM defense

    @staticmethod
    def _memory_usage_fraction() -> float:
        """Host memory pressure from /proc/meminfo (no psutil in daemons).
        ≈ memory_monitor.h:52's cgroup/system sampling."""
        try:
            info = {}
            with open("/proc/meminfo") as f:
                for line in f:
                    k, v = line.split(":", 1)
                    info[k] = int(v.strip().split()[0])  # kB
            total = info.get("MemTotal", 0)
            avail = info.get("MemAvailable", 0)
            if total <= 0:
                return 0.0
            return 1.0 - avail / total
        except OSError:
            return 0.0

    async def _memory_monitor_loop(self) -> None:
        interval = self.config.memory_monitor_interval_ms / 1000.0
        while True:
            await asyncio.sleep(interval)
            try:
                usage = self._memory_usage_fraction()
                if usage >= self.config.memory_usage_threshold:
                    await self._kill_for_memory(usage)
            except Exception:
                logger.exception("memory monitor failed")

    async def _kill_for_memory(self, usage: float) -> None:
        """Kill the newest leased worker (last to start loses — the
        reference's group-by-owner policy simplified to newest-task-first,
        worker_killing_policy_group_by_owner.h). The owner sees a worker
        death whose reason is attributed to the memory monitor."""
        for victim in self._oom_victim_order():
            if victim.worker_id_hex in self._oom_killed:
                continue  # already dying; give the exit monitor a tick
            killed = False
            if victim.proc is not None:
                try:
                    victim.proc.kill()
                    killed = True
                except Exception:
                    pass
            if not killed:
                continue  # unkillable handle: try the next victim
            self._oom_killed.add(victim.worker_id_hex)
            self._kill_reasons[victim.worker_id_hex] = (
                f"killed by the memory monitor: host memory usage "
                f"{usage:.1%} >= threshold "
                f"{self.config.memory_usage_threshold:.0%}")
            logger.warning(
                "memory usage %.1f%% >= %.0f%%: killed newest worker %s "
                "(pid %d) to relieve pressure",
                usage * 100, self.config.memory_usage_threshold * 100,
                victim.worker_id_hex[:8], victim.pid)
            self.events.emit(
                "WORKER_OOM_KILLED",
                f"worker {victim.worker_id_hex[:8]} killed at "
                f"{usage:.1%} host memory", severity="ERROR",
                worker_id=victim.worker_id_hex, usage=usage)
            return

    def _oom_victim_order(self) -> List[WorkerHandle]:
        """Newest-leased non-actor workers first (highest lease id), then
        actor leases; never idle-pool workers (they hold no tasks and the
        reaper handles them)."""
        task_leases = sorted(
            (l for l in self.leases.values() if not l.worker.is_actor),
            key=lambda l: -l.lease_id)
        actor_leases = sorted(
            (l for l in self.leases.values() if l.worker.is_actor),
            key=lambda l: -l.lease_id)
        return [l.worker for l in task_leases + actor_leases]

    def _pick_oom_victim(self) -> Optional[WorkerHandle]:
        order = self._oom_victim_order()
        return order[0] if order else None

    async def _reap_loop(self) -> None:
        """Kill surplus idle workers (≈ idle worker killing in worker_pool.cc)."""
        while True:
            await asyncio.sleep(1.0)
            try:
                self._reap_once(time.monotonic())
            except Exception:
                logger.exception("idle reap failed")

    def _reap_once(self, now: float) -> None:
        idle_ms = self.config.idle_worker_killing_time_ms
        for env_key, pool in self.idle.items():
            while (
                # over the soft cap: reap oldest, but give a 2s grace window
                # so a just-released worker isn't killed under a racing lease
                (
                    len(pool) > self.config.num_workers_soft_limit
                    and (now - pool[0].idle_since) > 2.0
                )
                or (
                    pool
                    and (now - pool[0].idle_since) * 1000 > idle_ms
                    and len(pool) > 1
                )
            ):
                w = pool.popleft()
                _trace(f"reap {w.worker_id_hex[:8]} is_actor={w.is_actor}")
                self.workers.pop(w.worker_id_hex, None)
                try:
                    loop = asyncio.get_running_loop()
                    loop.create_task(self._drain_worker_logs(w))
                    # a reaped worker skips _on_worker_exit (it already
                    # left self.workers) — reclaim its pins here
                    loop.create_task(self._release_dead_client_pins(
                        w.worker_id_hex, "reaped worker"))
                except RuntimeError:
                    pass
                if w.proc is not None:
                    try:
                        w.proc.terminate()
                    except Exception:
                        pass

    # ------------------------------------------------------------- placement bundles

    @idempotent  # key-guarded: re-reserving an existing bundle is a no-op
    async def rpc_reserve_bundle(self, body) -> None:
        key = (body["pg_id_hex"], body["bundle_index"])
        demand = ResourceSet.of(body["resources"])
        if key in self.bundles:
            return
        if not self.available.fits(demand):
            raise ValueError(f"insufficient resources for bundle {key}")
        self.available.subtract(demand)
        self.bundles[key] = [demand.copy(), demand.copy()]

    @idempotent  # pop-guarded
    async def rpc_release_bundle(self, body) -> None:
        key = (body["pg_id_hex"], body["bundle_index"])
        entry = self.bundles.pop(key, None)
        if entry is not None:
            self.available.add(entry[0])
        self._pump_lease_queue()

    # ------------------------------------------------------------- object store

    async def _store_op(self, fn, *args):
        """Run a store mutation on the dedicated single store thread.
        Spill/restore of a GiB-class object is a long synchronous disk
        copy — executed inline it wedges the whole supervisor loop and
        every concurrent RPC times out (scale-envelope failure mode).
        One worker thread = store ops stay mutually serialized (the
        store is not thread-safe) while the loop keeps serving."""
        return await asyncio.get_running_loop().run_in_executor(
            self._store_exec, fn, *args)

    @replay_cached  # a second create of the same id must return the SAME
    async def rpc_store_create(self, body) -> dict:  # offset, not re-allocate
        oid = ObjectID(body["object_id"])
        offset = await self._store_op(self.store.create, oid, body["size"])
        return {"offset": offset}

    @replay_cached  # double-seal rejects
    async def rpc_store_seal(self, body) -> None:
        await self._store_op(self.store.seal, ObjectID(body["object_id"]))

    @idempotent
    async def rpc_store_abort(self, body) -> None:
        await self._store_op(self.store.abort, ObjectID(body["object_id"]))

    def _note_pin_client(self, body) -> None:
        """Record a pinning client's RPC address for the liveness sweep.
        Raises for a client whose pins were already bulk-released: a
        chaos-delayed straggler locate from a dead/departed client would
        otherwise re-pin under an id nothing will ever reclaim."""
        if not body.get("pin") or not body.get("client"):
            return
        if body["client"] in self._released_clients:
            raise ValueError(
                f"pinning client {body['client'][:16]} was already "
                f"released as dead/departed")
        if body.get("client_addr"):
            self._pin_client_addrs[body["client"]] = tuple(
                body["client_addr"])

    @replay_cached  # pin=True re-execution leaks a pin count
    async def rpc_store_locate(self, body):
        self._note_pin_client(body)
        loc = await self._store_op(
            lambda: self.store.locate(ObjectID(body["object_id"]),
                                      pin=body.get("pin", False),
                                      client=body.get("client", "")))
        return None if loc is None else {"offset": loc[0], "size": loc[1]}

    @replay_cached  # pin=True re-execution leaks pin counts
    async def rpc_store_locate_batch(self, body):
        """Batched locate: ONE RPC resolves (and optionally pins) many
        objects — `ray.get([refs...])` costs O(nodes) locate round-trips
        instead of O(refs). Per-object failures (e.g. a restore that hits
        store-full) are isolated as {'error': ...} entries so one bad
        object cannot leak the pins the rest of the batch took."""
        pin = body.get("pin", False)
        client = body.get("client", "")
        self._note_pin_client(body)

        def run():
            out = []
            for raw in body["object_ids"]:
                try:
                    loc = self.store.locate(ObjectID(raw), pin=pin,
                                            client=client)
                except Exception as e:  # noqa: BLE001 — isolate per object
                    out.append({"error": f"{type(e).__name__}: {e}"})
                    continue
                out.append(None if loc is None
                           else {"offset": loc[0], "size": loc[1]})
            return out

        return await self._store_op(run)

    @replay_cached  # double-unpin would release someone else's pin
    async def rpc_store_unpin(self, body) -> bool:
        try:
            return await self._store_op(
                lambda: self.store.unpin(
                    ObjectID(body["object_id"]),
                    client=body.get("client", "")))
        except ValueError as e:
            # protocol bug (double-unpin) — except for a just-released
            # client, where a straggler retry is a benign shutdown race
            self._log_unpin_rejects(body.get("client", ""), [e])
            raise

    @idempotent  # releasing an already-empty client is a no-op
    async def rpc_store_release_client(self, body) -> int:
        """A departing client (driver/worker leaving the cluster
        gracefully) hands back every pin it still holds — its zero-copy
        views die with it, so the pins must not outlive it."""
        # a departing driver's compiled graphs die with it: close its
        # channels so participant loops exit instead of hanging
        self._close_client_channels(body.get("client", ""),
                                    cause="participant_death")
        self._mark_client_released(body.get("client", ""))
        released = await self._store_op(
            self.store.release_client_pins, body.get("client", ""))
        if released:
            logger.info("released %d pin(s) from departing client %s",
                        released, body.get("client", "")[:16])
        return released

    @replay_cached  # re-execution would double-release pins
    async def rpc_store_unpin_batch(self, body) -> int:
        """Coalesced pin releases (the GC-driven twin of
        store_locate_batch). Bad entries (double-unpin) are logged and
        counted, never allowed to strand the rest of the batch. Returns
        the number of rejected entries."""
        client = body.get("client", "")

        def run():
            errors = []
            for raw in body["entries"]:
                try:
                    self.store.unpin(ObjectID(raw), client=client)
                except ValueError as e:
                    errors.append(str(e))
            return errors

        errors = await self._store_op(run)
        self._log_unpin_rejects(client, errors)
        return len(errors)

    @idempotent
    async def rpc_store_contains(self, body) -> bool:
        return await self._store_op(
            self.store.contains, ObjectID(body["object_id"]))

    @idempotent
    async def rpc_store_free(self, body) -> None:
        def free_all():
            for raw in body["object_ids"]:
                self.store.free(ObjectID(raw))

        await self._store_op(free_all)

    @idempotent
    async def rpc_store_read_chunk(self, body) -> bytes:
        return await self._store_op(
            self.store.read_chunk, ObjectID(body["object_id"]),
            body["offset"], body["length"])

    @idempotent
    async def rpc_store_stats(self, body=None) -> dict:
        return await self._store_op(self.store.stats)

    # ------------------------------------------------- compiled-graph channels

    @replay_cached  # allocates an arena range + a pin: must mint once
    async def rpc_channel_create(self, body) -> dict:
        """Allocate one mutable channel in this node's arena (compile
        time): create + seal + pin in one store op, zero + stamp the
        header, and register the participant set for death-driven close.
        The pin belongs to ``client`` (the compiling driver)."""
        chaos.maybe_crash("sup.channel_create")
        client = body.get("client", "")
        if client in self._released_clients:
            raise ValueError(
                f"channel_create from released client {client[:16]}")
        if body.get("client_addr"):
            self._pin_client_addrs[client] = tuple(body["client_addr"])
        oid = ObjectID(body["channel_id"])
        offset = await self._store_op(
            self.store.create_channel, oid, body["size"], client)
        await self._store_op(
            channels.init_header, self.store.arena, offset,
            body["n_readers"], body.get("depth", 1))
        self._channels[oid.binary()] = {
            "oid": oid,
            "offset": offset,
            "size": body["size"],
            "participants": set(body.get("participants") or ()),
            "staging": 0,
        }
        self._m_channels_open.set(len(self._channels))
        return {"offset": offset}

    def _close_channel_entry(self, key: bytes, cause: str) -> None:
        ent = self._channels.pop(key, None)
        if ent is None:
            return
        channels.mark_closed(self.store.arena, ent["offset"])
        self._m_channels_open.set(len(self._channels))
        self._m_channels_closed.inc(labels={"cause": cause})

    def _close_client_channels(self, client: str, cause: str) -> None:
        """Close every channel ``client`` participated in (it died or
        departed): blocked peers observe the flag on their next poll tick
        and raise ChannelClosedError instead of waiting forever."""
        if not client:
            return
        for key in [k for k, ent in self._channels.items()
                    if client in ent["participants"]]:
            logger.warning(
                "closing channel %s: participant %s is gone",
                key.hex()[:12], client[:16])
            self._close_channel_entry(key, cause)

    @idempotent  # closing a closed/unknown channel is a no-op
    async def rpc_channel_close(self, body) -> None:
        self._close_channel_entry(body["channel_id"], cause="teardown")

    async def _channel_wait_writable(self, ent: dict, version: int) -> bool:
        """Park a remote push until the mirror's local readers acked the
        previous step (the writer's flow control, carried across the
        wire). Returns False when ``version`` is already committed — a
        chaos-duplicated/retried frame that must be a no-op."""
        from ray_tpu_torch._private.exceptions import ChannelClosedError

        deadline = time.monotonic() + self.config.channel_remote_timeout_s
        while True:
            closed, committed, _ = channels.read_header(
                self.store.arena, ent["offset"])
            if committed >= version:
                return False
            if closed or ent["oid"].binary() not in self._channels:
                raise ChannelClosedError(
                    f"channel {ent['oid'].hex()[:12]} closed")
            if channels.readers_ready(self.store.arena, ent["offset"],
                                      version):
                return True
            if time.monotonic() > deadline:
                raise TimeoutError(
                    f"channel {ent['oid'].hex()[:12]}: readers did not "
                    f"ack within {self.config.channel_remote_timeout_s}s")
            await asyncio.sleep(0.001)

    def _channel_entry(self, body) -> dict:
        from ray_tpu_torch._private.exceptions import ChannelClosedError

        ent = self._channels.get(body["channel_id"])
        if ent is None:
            raise ChannelClosedError(
                f"channel {body['channel_id'].hex()[:12]} closed or "
                f"unknown on this node")
        return ent

    def _check_channel_capacity(self, ent: dict, end: int) -> None:
        """Reject a push frame reaching past the slot payload area: at
        depth > 1 the slots are contiguous, so an unchecked write would
        corrupt the NEXT slot's committed (possibly unread) payload —
        silent wrong data instead of a clean error."""
        cap = channels.slot_capacity(
            ent["size"], channels.read_depth(self.store.arena,
                                             ent["offset"]))
        if end > cap:
            raise ValueError(
                f"channel push of {end} bytes exceeds the slot "
                f"capacity ({cap})")

    @idempotent  # absolute version: duplicated/retried pushes converge
    async def rpc_channel_push(self, body) -> None:
        """One-frame per-step push into a mirror channel (payload fits a
        single chunk): wait for reader acks, write payload, commit."""
        ent = self._channel_entry(body)
        self._check_channel_capacity(ent, len(body["payload"]))
        if not await self._channel_wait_writable(ent, body["version"]):
            return  # duplicate delivery of an already-committed version
        await self._store_op(
            channels.host_write_commit, self.store.arena, ent["offset"],
            ent["size"], body["payload"], body["version"])
        self._m_transfer_bytes.inc(len(body["payload"]))

    @idempotent  # same-offset same-version rewrites converge
    async def rpc_channel_write_chunk(self, body) -> None:
        """One chunk of a windowed large-payload push. The first chunk of
        a new version waits for reader acks (after that the payload area
        is the writer's until commit); chunks of an already-committed
        version are duplicate deliveries and are dropped."""
        ent = self._channel_entry(body)
        version = body["version"]
        _, committed, _ = channels.read_header(self.store.arena,
                                               ent["offset"])
        if committed >= version:
            return
        self._check_channel_capacity(
            ent, body["offset"] + len(body["data"]))
        if ent["staging"] != version:
            if not await self._channel_wait_writable(ent, version):
                return
            ent["staging"] = version
        await self._store_op(
            channels.host_write_chunk, self.store.arena, ent["offset"],
            ent["size"], version, body["offset"], body["data"])
        self._m_transfer_chunks.inc()
        self._m_transfer_bytes.inc(len(body["data"]))

    @idempotent  # version-guarded
    async def rpc_channel_commit(self, body) -> None:
        """Seal a chunked push: stamp length + version (readers wake)."""
        ent = self._channel_entry(body)
        self._check_channel_capacity(ent, body["length"])
        _, committed, _ = channels.read_header(self.store.arena,
                                               ent["offset"])
        if committed >= body["version"]:
            return
        await self._store_op(
            channels.host_commit, self.store.arena, ent["offset"],
            ent["size"], body["length"], body["version"])

    @idempotent  # contains-check + in-flight dedupe make re-pulls converge
    async def rpc_pull_object(self, body) -> dict:
        """Fetch an object from a remote node into the local store.

        ≈ PullManager (object_manager/pull_manager.cc): chunked, deduped.
        """
        oid = ObjectID(body["object_id"])
        if await self._store_op(self.store.contains, oid):
            # the object can be freed between the two store-thread hops
            # (contains/locate no longer run back-to-back on the loop);
            # a None locate falls through to the pull path cleanly
            loc = await self._store_op(self.store.locate, oid)
            if loc is not None:
                return {"offset": loc[0], "size": loc[1]}
        pending = self._pulls_in_flight.get(oid)
        if pending is not None:
            return await pending
        fut: asyncio.Future = asyncio.get_running_loop().create_future()
        self._pulls_in_flight[oid] = fut
        try:
            result = await self._do_pull(oid, tuple(body["from"]), body["size"])
            fut.set_result(result)
            return result
        except Exception as e:
            fut.set_exception(e)
            raise
        finally:
            self._pulls_in_flight.pop(oid, None)
            if not fut.done():
                fut.cancel()

    async def _do_pull(self, oid: ObjectID, source: Address, size: int) -> dict:
        """Chunked, PIPELINED transfer: a bounded window of concurrent
        chunk RPCs streams the object straight into the pre-created arena
        allocation (no whole-object pickle frame, no reassembly buffer —
        each chunk lands with one write at its own offset). Chunk reads
        are idempotent and same-offset rewrites converge, so transport
        retries under drop/dup chaos are safe."""
        offset = await self._store_op(self.store.create, oid, size)
        src = self.clients.get(source)
        chunk = self.config.object_transfer_chunk_bytes
        window = max(1, self.config.object_transfer_window)
        client = f"node:{self.node_id.hex()}"
        pinned = False
        tasks: List[asyncio.Task] = []
        try:
            # pin at the source for the duration of the chunked transfer
            pinned = (
                await src.call(
                    "store_locate",
                    {"object_id": oid.binary(), "pin": True,
                     "client": client},
                    timeout=60,
                )
                is not None
            )
            if not pinned:
                raise KeyError(f"object {oid.hex()} not at source node")

            sem = asyncio.Semaphore(window)

            async def fetch(pos: int) -> int:
                async with sem:
                    data = await src.call(
                        "store_read_chunk",
                        {"object_id": oid.binary(), "offset": pos,
                         "length": chunk},
                        timeout=600,
                    )
                    await self._store_op(self.store.arena.write,
                                         offset + pos, data)
                    self._m_transfer_chunks.inc()
                    return len(data)

            loop = asyncio.get_running_loop()
            tasks = [loop.create_task(fetch(pos))
                     for pos in range(0, size, chunk)]
            moved = sum(await asyncio.gather(*tasks))
            if moved != size:
                raise RuntimeError(f"short pull: {moved}/{size} bytes")
            self._m_transfer_bytes.inc(moved)
        except Exception:
            # in-flight chunk writes must stop BEFORE abort recycles the
            # range, or a straggler would scribble over a reallocation
            for t in tasks:
                t.cancel()
            if tasks:
                await asyncio.gather(*tasks, return_exceptions=True)
            await self._store_op(self.store.abort, oid)
            raise
        finally:
            if pinned:
                try:
                    await src.call(
                        "store_unpin",
                        {"object_id": oid.binary(), "client": client},
                        timeout=30)
                except Exception:
                    pass
        await self._store_op(self.store.seal, oid)
        return {"offset": offset, "size": size}


def main() -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--port", type=int, default=0)
    parser.add_argument("--controller", required=True)
    parser.add_argument("--session-dir", required=True)
    parser.add_argument("--address-file", default="")
    parser.add_argument("--resources", default="")  # JSON
    parser.add_argument("--node-name", default="")
    parser.add_argument("--labels", default="")  # JSON {key: value}
    args = parser.parse_args()

    logging.basicConfig(
        level=os.environ.get("RAY_TPU_TORCH_LOG_LEVEL", "INFO"),
        format="[supervisor] %(asctime)s %(levelname)s %(message)s",
    )
    from ray_tpu_torch._private.watchdog import start_owner_watchdog_from_env

    start_owner_watchdog_from_env("supervisor")
    host, port = args.controller.rsplit(":", 1)
    resources = json.loads(args.resources) if args.resources else None

    async def run():
        sup = Supervisor(
            Config.from_env(),
            (host, int(port)),
            args.session_dir,
            args.host,
            args.port,
            resources=resources,
            node_name=args.node_name,
            labels=json.loads(args.labels) if args.labels else None,
        )
        addr = await sup.start()
        if args.address_file:
            tmp = args.address_file + ".tmp"
            with open(tmp, "w") as f:
                f.write(f"{addr[0]}:{addr[1]}")
            os.replace(tmp, args.address_file)
        await asyncio.Event().wait()

    asyncio.run(run())


if __name__ == "__main__":
    main()
