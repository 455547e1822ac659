"""Cluster controller — the global control plane daemon.

Analog of the reference's GCS server (`src/ray/gcs/gcs_server/`):
one per cluster, authoritative for node membership + health
(≈ `GcsNodeManager` + `GcsHealthCheckManager` `gcs_health_check_manager.h:39`),
the actor directory and restart orchestration (≈ `GcsActorManager`
`gcs_actor_manager.cc:255,1190`), placement groups
(≈ `GcsPlacementGroupManager`), jobs, the internal KV (≈ `gcs_kv_manager.h`,
also serving as the function table), pubsub fan-out (≈ `src/ray/pubsub/`) and
the task-event sink (≈ `GcsTaskManager`) backing the state API.

Storage is in-memory (≈ `in_memory_store_client.h`); the record tables are
plain dicts behind a single asyncio loop, snapshotted to the session dir on
an interval for restart recovery — the Redis-backed `gcs_init_data.h` path's
stand-in: a restarted controller reloads actors/PGs/jobs/KV, and supervisors
re-register via the node_sync "unknown_node" handshake.
"""

from __future__ import annotations

import argparse
import asyncio
import dataclasses
import logging
import os
import time
from collections import deque
from typing import Any, Dict, List, Optional, Set, Tuple

from ray_tpu_torch._private import chaos, serialization
from ray_tpu_torch._private.config import Config
from ray_tpu_torch._private.http_util import MetricsHttpServer
from ray_tpu_torch._private.ids import ActorID, JobID, NodeID, PlacementGroupID
from ray_tpu_torch._private.kv_shards import KvShardMap
from ray_tpu_torch._private.metrics import (Counter, Gauge, Histogram,
                                      default_registry)
from ray_tpu_torch._private.resources import ResourceSet
from ray_tpu_torch._private.rpc import (ClientPool, RpcServer, current_replay_key,
                                  idempotent, replay_cached, retry_call)
from ray_tpu_torch._private.scheduling import NodeView, PlacementError, place_bundles

logger = logging.getLogger(__name__)

Address = Tuple[str, int]

# actor states (≈ rpc::ActorTableData::ActorState)
ACTOR_PENDING = "PENDING_CREATION"
ACTOR_ALIVE = "ALIVE"
ACTOR_RESTARTING = "RESTARTING"
ACTOR_DEAD = "DEAD"

PG_PENDING = "PENDING"
PG_CREATED = "CREATED"
PG_REMOVED = "REMOVED"


@dataclasses.dataclass
class NodeRecord:
    node_id_hex: str
    address: Address
    total: ResourceSet
    available: ResourceSet
    alive: bool = True
    labels: Dict[str, str] = dataclasses.field(default_factory=dict)
    last_seen: float = 0.0
    missed_health_checks: int = 0
    # why a dead node died ("drained" = deliberate rpc_node_drain
    # retirement — peers skip the crash debounce and reap immediately)
    death_reason: str = ""
    store_stats: Dict[str, float] = dataclasses.field(default_factory=dict)
    # queued-but-unserved demand gossiped by the supervisor; the
    # autoscaler bin-packs this into node launches
    pending_demand: List[Dict[str, float]] = dataclasses.field(
        default_factory=list)
    # monotonic timestamp of the last sync in which the node was busy
    # (available != total or demand pending); drives idle scale-down
    last_busy: float = 0.0

    def view(self) -> NodeView:
        return NodeView(
            node_id_hex=self.node_id_hex,
            address=self.address,
            total=self.total,
            available=self.available,
            alive=self.alive,
            labels=self.labels,
        )


@dataclasses.dataclass
class ActorRecord:
    actor_id_hex: str
    name: str
    namespace: str
    state: str
    owner: Optional[Address]
    address: Optional[Address] = None
    worker_id_hex: str = ""
    node_id_hex: str = ""
    incarnation: int = 0
    max_restarts: int = 0
    num_restarts: int = 0
    creation_spec: bytes = b""  # serialized TaskSpec for restarts
    death_cause: str = ""
    class_name: str = ""
    job_id_hex: str = ""
    detached: bool = False


@dataclasses.dataclass
class PGRecord:
    pg_id_hex: str
    bundles: List[Dict[str, float]]
    strategy: str
    state: str
    name: str = ""
    assignment: List[str] = dataclasses.field(default_factory=list)
    creator_job_hex: str = ""


@dataclasses.dataclass
class JobRecord:
    job_id_hex: str
    driver_address: Optional[Address]
    start_time: float
    end_time: float = 0.0
    alive: bool = True


class Controller:
    """Single-loop cluster controller. All state mutations happen on the
    owning asyncio loop (no locks, mirroring the reference's single-threaded
    GCS event loop)."""

    def __init__(self, config: Config, host: str = "127.0.0.1", port: int = 0,
                 snapshot_path: str = "", session_dir: str = ""):
        self.config = config
        self.snapshot_path = snapshot_path
        self.session_dir = session_dir
        from ray_tpu_torch._private import flight as _flight

        _flight.set_role("controller")
        # pluggable durable store (gcs_store.py): session-dir files by
        # default; controller_store_uri selects a remote URI backend so
        # the control plane survives head-node disk loss
        # (ref src/ray/gcs/store_client/redis_store_client.h)
        from ray_tpu_torch._private.gcs_store import control_store_for

        store_dir = ""
        if snapshot_path:
            store_dir = snapshot_path + ".d"
        elif session_dir:
            store_dir = os.path.join(session_dir, "control_state")
        if config.controller_store_uri or store_dir:
            self._store = control_store_for(
                config.controller_store_uri, store_dir)
        else:
            self._store = None
        self.job_manager = None  # created in start() (needs our address)
        self.server = RpcServer(host, port if port else config.controller_port)
        self.server.register_object(self)
        self.clients = ClientPool(
            config.rpc_connect_timeout_s, config.rpc_request_timeout_s,
            retry_base_s=config.rpc_retry_interval_ms / 1000.0,
        )
        self.nodes: Dict[str, NodeRecord] = {}
        self.actors: Dict[str, ActorRecord] = {}
        self.named_actors: Dict[Tuple[str, str], str] = {}
        self.pgs: Dict[str, PGRecord] = {}
        self.jobs: Dict[str, JobRecord] = {}
        # namespace-hash-sharded KV: each shard has its own table, lock
        # and WAL stream (kv_shards.py — first step toward out-of-process
        # control-plane shards)
        self.kv = KvShardMap(config.controller_kv_shards)
        # kv_wait long-pollers: (ns, key) -> futures resolved by the next
        # put (collective rendezvous, PG readiness — replaces client-side
        # busy-polling on the control plane)
        self._kv_waiters: Dict[Tuple[str, str], List[asyncio.Future]] = {}
        self.subscribers: Dict[str, Set[Address]] = {}
        self.task_events: deque = deque(maxlen=config.task_event_buffer_size)
        self._health_task: Optional[asyncio.Task] = None
        self._pg_retry_task: Optional[asyncio.Task] = None
        self._snapshot_task: Optional[asyncio.Task] = None
        self._state_dirty = False
        self._mutation_seq = 0
        self._wal_epoch = 0  # bumped by each snapshot compaction
        # main-stream WAL appends vs compaction; per-KV-shard appends
        # ride each shard's own lock (compaction acquires all of them)
        self._persist_lock = asyncio.Lock()
        self._next_job_int = 0
        self._started = time.time()
        # set when this incarnation recovered durable state: gates the
        # node-re-register worker reconcile (only a controller restart
        # can re-register a node that still hosts live workers)
        self._recovered = False
        # nodes the PREVIOUS incarnation knew (recovered from WAL/
        # snapshot "node" frames, NOT live records — supervisors must
        # re-register): one that never returns gets the DEAD fan-out it
        # would have received had the controller lived, so owners
        # requeue its leases instead of hanging forever
        self._ghost_nodes: Dict[str, Address] = {}
        # strong refs to fire-and-forget recovery tasks (asyncio keeps
        # only weak ones; a GC'd reconcile would silently never run)
        self._bg_tasks: Set[asyncio.Task] = set()
        # structured lifecycle events (≈ src/ray/util/event.h), queryable
        # via util.state.list_cluster_events
        from ray_tpu_torch._private.events import EventLogger

        self.events = EventLogger("controller", session_dir)
        # metrics (≈ metric_defs.h:46 definitions, served per-daemon)
        self.metrics_server: Optional[MetricsHttpServer] = None
        self.dashboard_server: Optional[MetricsHttpServer] = None
        self._m_nodes = Gauge("ray_tpu_nodes",
                              "Cluster nodes by liveness")
        self._m_actors = Gauge("ray_tpu_actors", "Actors by state")
        self._m_pgs = Gauge("ray_tpu_placement_groups",
                            "Placement groups by state")
        self._m_task_events = Counter("ray_tpu_task_events_total",
                                      "Task lifecycle events received")
        self._m_recoveries = Counter(
            "ray_tpu_controller_recoveries_total",
            "Controller restarts that recovered durable state")
        self._m_recovery_seconds = Histogram(
            "ray_tpu_controller_recovery_seconds",
            "Snapshot load + WAL replay wall time per recovery")
        self._m_kv_shard_keys = Gauge(
            "ray_tpu_kv_shard_keys",
            "Keys held per controller KV shard")

    # ----------------------------------------------------------- persistence

    _SNAPSHOT_VERSION = 1
    _NO_REPLY = object()  # sentinel: this append carries no RPC reply

    def _snapshot_state(self) -> dict:
        """The durable subset: everything a restarted controller needs to
        keep serving existing clients (≈ what the reference rebuilds from
        Redis via gcs_init_data.h). Node records are NOT persisted —
        supervisors re-register on their next sync. Task events and
        subscribers are soft state. Completed replay-cache entries ARE
        persisted: compaction sweeps the WAL frames that embedded them,
        and dropping them would reopen the exactly-once window for a
        retry straddling the next restart."""
        return {
            "version": self._SNAPSHOT_VERSION,
            "actors": self.actors,
            "named_actors": self.named_actors,
            "pgs": self.pgs,
            "jobs": self.jobs,
            # flat ns->table dict: shard-count agnostic on disk
            "kv": self.kv.merged(),
            "next_job_int": self._next_job_int,
            "replay": self.server.export_replay(),
            # ADDRESSES of every LIVE node this incarnation has known
            # (live records stay soft state): the next incarnation's
            # reconcile publishes DEAD for any that never re-register.
            # Already-dead nodes are excluded — their fan-out ran; a
            # ghost re-declare on every restart would spam duplicate
            # NODE_DEAD events and could spuriously requeue leases if a
            # later supervisor reuses the address
            "nodes_known": {
                **{h: list(a) for h, a in self._ghost_nodes.items()},
                **{r.node_id_hex: list(r.address)
                   for r in self.nodes.values() if r.alive},
            },
            # WAL frames from epochs <= this are superseded by this
            # snapshot (see gcs_store epoch keying)
            "wal_epoch": self._wal_epoch,
        }

    def _mark_dirty(self) -> None:
        self._state_dirty = True
        self._mutation_seq += 1

    async def _wal_append(self, kind: str, payload: Any, stream: str = "",
                          lock: Optional[asyncio.Lock] = None,
                          reply: Any = _NO_REPLY) -> None:
        """Durable write-ahead record BEFORE acking a registration RPC:
        once the caller sees the reply, the record survives a controller
        crash (the reference gets this from synchronous Redis writes in
        the GCS table layer). O(entry), not
        O(total-state): the interval snapshot compacts the log. The
        actual medium is pluggable (gcs_store.ControlStore: session-dir
        files or a remote URI backend, ref redis_store_client.h).

        ``stream``/``lock``: KV mutations append to their SHARD's own WAL
        stream under that shard's lock (other record kinds ride the main
        stream + ``_persist_lock``); compaction acquires every lock.

        ``reply``: when given AND this append runs inside a replay-cached
        RPC dispatch, the (client_id, msg_id) replay key and the reply
        value are folded into the SAME frame as the mutation — one
        durable write, so there is no crash window between "applied" and
        "reply cached". A retried non-idempotent RPC that straddles a
        controller restart is then answered from the recovered cache,
        never re-applied (tests/test_controller_ha.py proves it at the
        ``ctrl.actor_register`` crash point)."""
        if self._store is None:
            return
        record: Tuple = (kind, payload)
        if reply is not self._NO_REPLY:
            ckey = current_replay_key()
            if ckey is not None:
                record = (kind, payload, (ckey[0], ckey[1], ckey[2], reply))
        frame = serialization.dumps(record)
        async with (lock or self._persist_lock):
            await asyncio.get_running_loop().run_in_executor(
                None, self._store.append_wal, self._wal_epoch, frame,
                stream)

    def _replay_wal(self) -> int:
        """Apply WAL entries on top of the loaded snapshot: EVERY epoch
        at or after the snapshot's resume point (several accumulate when
        interval snapshots failed or recovery fell back to an older
        snapshot epoch), main stream first, then each KV shard stream
        (streams are listed from the store, so frames written by an
        incarnation with a different shard count still replay — routing
        is by namespace through the CURRENT map). Re-application
        overwrites in place; a torn tail — crash mid-append — ends that
        stream's replay cleanly."""
        if self._store is None:
            return 0
        from ray_tpu_torch._private import flight

        applied = 0
        with flight.span("ctrl.replay_wal"):
            epochs = sorted(e for e in self._store.list_wal_epochs()
                            if e >= self._wal_epoch)
            streams = [""] + sorted(self._store.list_wal_streams())
            for epoch in epochs:
                for stream in streams:
                    applied += self._apply_wal_frames(
                        self._store.read_wal(epoch, stream))
            if epochs:
                # resume appending in a FRESH epoch, never the newest
                # file seen: that file may end in a torn frame (crash
                # mid-append), and appending after torn bytes would make
                # every later acked frame unparseable on the next
                # recovery — a silent durability hole in the double-crash
                # case
                self._wal_epoch = epochs[-1] + 1
        return applied

    def _apply_wal_frames(self, frames) -> int:
        applied = 0
        for raw in frames:
            try:
                record = serialization.loads(raw)
            except Exception:
                break
            kind, payload = record[0], record[1]
            if kind == "actor":
                self.actors[payload.actor_id_hex] = payload
                if payload.name:
                    self.named_actors[(payload.namespace, payload.name)] = (
                        payload.actor_id_hex)
            elif kind == "actor_ready":
                actor_hex, address, worker_hex, node_hex, incarnation = \
                    payload
                rec = self.actors.get(actor_hex)
                if rec is not None and rec.state != ACTOR_DEAD:
                    rec.state = ACTOR_ALIVE
                    rec.address = tuple(address)
                    rec.worker_id_hex = worker_hex
                    rec.node_id_hex = node_hex
                    rec.incarnation = incarnation
            elif kind == "pg":
                self.pgs[payload.pg_id_hex] = payload
            elif kind == "job":
                self.jobs[payload.job_id_hex] = payload
            elif kind == "job_int":
                self._next_job_int = max(self._next_job_int, payload)
            elif kind == "kv":
                ns, key, value = payload
                self.kv.namespace(ns)[key] = value
            elif kind == "kv_del":
                ns, key = payload
                self.kv.peek(ns).pop(key, None)
            elif kind == "actor_dead":
                actor_hex, reason = payload
                rec = self.actors.get(actor_hex)
                if rec is not None:
                    rec.state = ACTOR_DEAD
                    rec.death_cause = reason
                    rec.address = None
            elif kind == "job_finish":
                job_hex, end_time = payload
                job = self.jobs.get(job_hex)
                if job is not None:
                    job.alive = False
                    job.end_time = end_time
            elif kind == "node":
                node_hex, address = payload
                self._ghost_nodes[node_hex] = tuple(address)
            elif kind == "node_dead":
                # death tombstone: its fan-out already ran; the ghost
                # reconcile must not re-declare it on every restart
                self._ghost_nodes.pop(payload, None)
            if len(record) > 2 and record[2] is not None:
                # the frame carried its RPC replay key: re-arm the
                # server's exactly-once cache for retries that straddled
                # the restart
                client_id, msg_id, method, reply = record[2]
                self.server.seed_replay(client_id, msg_id, method, reply)
            applied += 1
        return applied

    def _write_snapshot(self) -> None:
        if self._store is None:
            return
        self._store.write_snapshot(
            self._wal_epoch, serialization.dumps(self._snapshot_state()))

    def _load_snapshot(self) -> bool:
        if self._store is None:
            return False
        state = None
        for blob in self._store.load_snapshots():
            try:
                candidate = serialization.loads(blob)
            except Exception:
                logger.exception(
                    "controller snapshot unreadable; falling back to the "
                    "previous epoch")
                continue
            if candidate.get("version") != self._SNAPSHOT_VERSION:
                logger.warning(
                    "controller snapshot version mismatch; falling back "
                    "to the previous epoch")
                continue
            state = candidate
            break
        if state is None:
            return False
        self.actors = state["actors"]
        self.named_actors = state["named_actors"]
        self.pgs = state["pgs"]
        self.jobs = state["jobs"]
        self.kv.load(state.get("kv", {}))
        self._next_job_int = state["next_job_int"]
        for client_id, msg_id, payload in state.get("replay", []):
            self.server.seed_replay_payload((client_id, msg_id), payload)
        for node_hex, address in state.get("nodes_known", {}).items():
            self._ghost_nodes[node_hex] = tuple(address)
        # resume appending at the epoch AFTER the one this snapshot
        # superseded; stale lower-epoch WAL frames are simply ignored by
        # _replay_wal (which applies EVERY newer epoch, so frames
        # written after a corrupt/failed later snapshot still land).
        # No sweep here: retention is the snapshot loop's job, keyed off
        # the store's snapshot inventory — sweeping on load would drop
        # the frames an OLDER snapshot needs for the corruption fallback
        self._wal_epoch = state.get("wal_epoch", 0) + 1
        logger.info(
            "controller recovered from snapshot: %d actors, %d pgs, "
            "%d jobs, %d kv namespaces",
            len(self.actors), len(self.pgs), len(self.jobs),
            self.kv.num_namespaces())
        return True

    async def _compact_once(self) -> None:
        """One snapshot compaction. Serialize INSIDE the locks: every
        acked registration takes the main lock (KV mutations their
        shard's lock) for its WAL append, so a mutation is either
        already in the blob (its old-epoch frame is then safely
        superseded) or its append lands in the NEW epoch's file and
        replays after this snapshot. The epoch bump (not truncation)
        makes compaction crash-atomic: recovery replays only frames
        newer than the installed snapshot's recorded epoch.

        Retention keeps ONE generation of history — the previous
        snapshot plus every WAL epoch newer than it — so recovery from a
        bit-rotted newest snapshot (load_snapshots fallback) is
        lossless. The previous snapshot's epoch comes from the STORE
        INVENTORY, not superseded-1: epoch numbers jump across
        controller restarts (_replay_wal resumes in a fresh epoch), and
        arithmetic would sweep the fallback generation. With no older
        snapshot yet, nothing is swept: the full WAL is the fallback."""
        import contextlib

        async with contextlib.AsyncExitStack() as stack:
            await stack.enter_async_context(self._persist_lock)
            for shard in self.kv.shards:
                await stack.enter_async_context(shard.lock)
            blob = serialization.dumps(self._snapshot_state())
            loop = asyncio.get_running_loop()
            superseded = self._wal_epoch
            await loop.run_in_executor(
                None, self._store.write_snapshot, superseded, blob)
            self._wal_epoch += 1
            snaps = await loop.run_in_executor(
                None, self._store.list_snapshot_epochs)
            older = [e for e in snaps if e < superseded]
            if older:
                prev = older[-1]
                await loop.run_in_executor(
                    None, self._store.sweep_wals, prev)
                await loop.run_in_executor(
                    None, self._store.sweep_snapshots, prev)

    async def _snapshot_loop(self) -> None:
        interval = max(0.1, self.config.controller_snapshot_interval_ms / 1000)
        while True:
            await asyncio.sleep(interval)
            if not self._state_dirty:
                continue  # nothing changed since the last write
            self._state_dirty = False
            try:
                await self._compact_once()
            except Exception:
                self._state_dirty = True
                logger.exception("controller snapshot write failed")

    async def _reconcile_recovered(self) -> None:
        """Fail over snapshot-recovered actors/PGs whose node never came
        back: the health loop only probes registered nodes, so a host lost
        during the controller outage would otherwise stay 'ALIVE' forever."""
        await asyncio.sleep(self.config.recovery_grace_s())
        # nodes the previous incarnation knew that never re-registered:
        # publish the DEAD fan-out they would have received (address
        # included so owners can requeue in-flight leases granted there
        # — without it those tasks hang forever) and let peers' view
        # sync sweep their node:<hex> pins
        for ghost_hex, ghost_addr in list(self._ghost_nodes.items()):
            if ghost_hex in self.nodes:
                continue
            logger.warning(
                "node %s never re-registered after the controller "
                "outage; declaring it dead", ghost_hex[:8])
            self.events.emit(
                "NODE_DEAD",
                f"node {ghost_hex[:8]}: lost during controller outage",
                severity="WARNING", node_id=ghost_hex,
                reason="lost during controller outage")
            await self._publish("nodes", {"event": "DEAD",
                                          "node_id_hex": ghost_hex,
                                          "address": list(ghost_addr)})
            # tombstone like the registered-node death path: without it
            # the snapshot/WAL still lists the ghost and EVERY later
            # restart re-declares it dead (duplicate fan-out + spurious
            # lease requeue if a replacement reuses the address)
            await self._wal_append("node_dead", ghost_hex)
        if self._ghost_nodes:
            self._mark_dirty()
        self._ghost_nodes.clear()
        for actor in list(self.actors.values()):
            if actor.state in (ACTOR_ALIVE, ACTOR_PENDING, ACTOR_RESTARTING) \
                    and actor.node_id_hex \
                    and actor.node_id_hex not in self.nodes:
                logger.warning(
                    "recovered actor %s on node %s that never re-registered; "
                    "failing over", actor.actor_id_hex[:8],
                    actor.node_id_hex[:8])
                await self._on_actor_failure(
                    actor, "node lost during controller outage")
        for pg in self.pgs.values():
            if pg.state == PG_CREATED and any(
                    h not in self.nodes for h in pg.assignment):
                pg.state = PG_PENDING
                pg.assignment = []
                self._pg_kv_update(pg.pg_id_hex, None)
                await self._publish(
                    "pg:" + pg.pg_id_hex,
                    {"state": PG_PENDING, "pg_id_hex": pg.pg_id_hex})
        await self._retry_pending_pgs()

    # ------------------------------------------------------------- lifecycle

    async def start(self) -> Address:
        from ray_tpu_torch._private import flight

        t0 = time.monotonic()
        with flight.span("ctrl.recover"):
            recovered = self._load_snapshot()
            replayed = self._replay_wal()
        if replayed:
            logger.info("replayed %d WAL entries", replayed)
        recovered = recovered or replayed > 0
        addr = await self.server.start()
        loop = asyncio.get_running_loop()
        self._health_task = loop.create_task(self._health_loop())
        self._pg_retry_task = loop.create_task(self._pg_retry_loop())
        if self._store is not None:
            self._snapshot_task = loop.create_task(self._snapshot_loop())
        if recovered:
            self._recovered = True
            self._m_recoveries.inc()
            self._m_recovery_seconds.observe(time.monotonic() - t0)
            self.events.emit(
                "CONTROLLER_RECOVERED",
                f"recovered {len(self.actors)} actors, {len(self.pgs)} "
                f"pgs, {len(self.jobs)} jobs from snapshot in "
                f"{time.monotonic() - t0:.3f}s",
                severity="WARNING")
            # surviving nodes re-register within a sync period; anything
            # still on an unknown node after the grace window was lost
            # during the outage and must fail over (strong ref held:
            # the loop alone would keep only a weak one)
            task = loop.create_task(self._reconcile_recovered())
            self._bg_tasks.add(task)
            task.add_done_callback(self._bg_tasks.discard)
        from ray_tpu_torch._private.job_manager import JobManager

        self.job_manager = JobManager(
            self.session_dir, f"{addr[0]}:{addr[1]}")
        if self.config.metrics_export_port >= 0:
            try:
                # scrape port: READ-ONLY routes only — operators may open
                # it to an off-host Prometheus
                self.metrics_server = MetricsHttpServer(
                    host=self.config.metrics_export_host,
                    port=self.config.metrics_export_port)
                self.metrics_server.route("/metrics", self._render_metrics)
                self.metrics_server.route(
                    "/healthz", lambda: ("text/plain", "ok"))
                await self.metrics_server.start()
            except OSError as e:
                # a scrape-endpoint bind failure must not take down the
                # control plane (fixed port + several daemons per host)
                logger.warning("metrics endpoint unavailable: %s", e)
                self.metrics_server = None
        if self.config.dashboard_port >= 0:
            try:
                # dashboard + jobs API: executes entrypoints — its OWN
                # port, loopback-bound unless the operator opts in
                self.dashboard_server = MetricsHttpServer(
                    host=self.config.dashboard_host,
                    port=self.config.dashboard_port)
                self._register_http_api(self.dashboard_server)
                await self.dashboard_server.start()
            except OSError as e:
                logger.warning("dashboard endpoint unavailable: %s", e)
                self.dashboard_server = None
        return addr

    def _render_metrics(self):
        by_alive = {"alive": 0, "dead": 0}
        for r in self.nodes.values():
            by_alive["alive" if r.alive else "dead"] += 1
        for state, count in by_alive.items():
            self._m_nodes.set(count, {"state": state})
        # seed every known state with 0 — a label-child left unset would
        # freeze at its last nonzero value when the state empties out
        actor_states: Dict[str, int] = {
            s: 0 for s in (ACTOR_PENDING, ACTOR_ALIVE, ACTOR_RESTARTING,
                           ACTOR_DEAD)}
        for a in self.actors.values():
            actor_states[a.state] = actor_states.get(a.state, 0) + 1
        for state, count in actor_states.items():
            self._m_actors.set(count, {"state": state})
        pg_states: Dict[str, int] = {
            s: 0 for s in (PG_PENDING, PG_CREATED, PG_REMOVED)}
        for p in self.pgs.values():
            pg_states[p.state] = pg_states.get(p.state, 0) + 1
        for state, count in pg_states.items():
            self._m_pgs.set(count, {"state": state})
        for i, n in enumerate(self.kv.keys_per_shard()):
            self._m_kv_shard_keys.set(n, {"shard": str(i)})
        return ("text/plain; version=0.0.4",
                default_registry().render_prometheus())

    def _register_http_api(self, srv: MetricsHttpServer) -> None:
        """REST + dashboard-lite on the controller's HTTP port
        (≈ dashboard job REST, dashboard/modules/job/job_head.py, and a
        minimal cluster overview page in place of the React dashboard)."""
        import json as _json

        async def api_cluster():
            return await self.rpc_cluster_status()

        async def api_nodes():
            return await self.rpc_node_views()

        async def api_actors():
            recs = await self.rpc_actor_list()
            for r in recs:
                r.pop("creation_spec", None)
            return recs

        async def api_tasks():
            return await self.rpc_state_tasks({"limit": 200})

        def api_jobs_list():
            return self.job_manager.list()

        def api_jobs_submit(body: bytes):
            req = _json.loads(body or b"{}")
            if not req.get("entrypoint"):
                raise ValueError("missing 'entrypoint'")
            job_id = self.job_manager.submit(
                req["entrypoint"],
                env_vars=req.get("env_vars"),
                submission_id=req.get("submission_id"))
            return {"job_id": job_id}

        from ray_tpu_torch._private.http_util import HttpNotFound

        def api_job_detail(tail: str):
            parts = tail.strip("/").split("/")
            job_id = parts[0]
            if self.job_manager.status(job_id) is None:
                raise HttpNotFound(f"no such job {job_id}")
            if len(parts) > 1 and parts[1] == "logs":
                return ("text/plain", self.job_manager.logs(job_id))
            return self.job_manager.status(job_id)

        async def api_job_action(body: bytes, tail: str):
            parts = tail.strip("/").split("/")
            if self.job_manager.status(parts[0]) is None:
                raise HttpNotFound(f"no such job {parts[0]}")
            if len(parts) > 1 and parts[1] == "stop":
                # stop() waits on the process: keep it off the event loop
                stopped = await asyncio.get_running_loop().run_in_executor(
                    None, self.job_manager.stop, parts[0])
                return {"stopped": stopped}
            raise ValueError(f"unknown action {tail!r}")

        async def api_events():
            return await self.rpc_events_list({"limit": 100})

        async def api_task_summary():
            tasks = await self.rpc_state_tasks({"limit": 5000})
            summary: Dict[str, Dict[str, int]] = {}
            for t in tasks:
                row = summary.setdefault(t.get("name", "?"), {})
                st = t.get("state", "?")
                row[st] = row.get(st, 0) + 1
            return [{"name": n, **states} for n, states in summary.items()]

        async def api_workers():
            alive = [r for r in self.nodes.values() if r.alive]

            async def one(rec):
                try:
                    r = await self.clients.get(rec.address).call(
                        "worker_profile", {}, timeout=5)
                    return [dict(w, node_id_hex=rec.node_id_hex)
                            for w in r["workers"]]
                except Exception:
                    return []

            # concurrent fan-out: one unreachable node costs one probe
            # timeout for the whole response, not 5s x nodes serially
            groups = await asyncio.gather(*(one(r) for r in alive))
            return [w for grp in groups for w in grp]

        srv.route("/api/cluster", api_cluster)
        srv.route("/api/nodes", api_nodes)
        srv.route("/api/actors", api_actors)
        srv.route("/api/tasks", api_tasks)
        srv.route("/api/task_summary", api_task_summary)
        srv.route("/api/events", api_events)
        srv.route("/api/workers", api_workers)
        srv.route("/api/jobs", api_jobs_list)
        srv.route("/api/jobs", api_jobs_submit, method="POST")
        srv.route("/api/jobs/*", api_job_detail)
        srv.route("/api/jobs/*", api_job_action, method="POST")
        srv.route("/dashboard", lambda: ("text/html", _DASHBOARD_HTML))

    async def rpc_metrics(self, body=None) -> str:
        return self._render_metrics()[1]

    async def rpc_flight_dump(self, body=None) -> dict:
        """Drain the controller's flight-recorder rings (the control
        plane's own spans land on the merged cluster timeline too)."""
        from ray_tpu_torch._private import flight

        return flight.drain()

    # job submission RPCs (the CLI may come through RPC instead of HTTP)

    @replay_cached
    async def rpc_job_submit(self, body) -> dict:
        # spawns a process: a retried submission must get the first job_id
        # back, not a second entrypoint run
        return {"job_id": self.job_manager.submit(
            body["entrypoint"], env_vars=body.get("env_vars"),
            submission_id=body.get("submission_id"))}

    @idempotent
    async def rpc_job_status(self, body):
        return self.job_manager.status(body["job_id"])

    @idempotent
    async def rpc_job_logs(self, body) -> str:
        return self.job_manager.logs(body["job_id"])

    @idempotent
    async def rpc_job_stop(self, body) -> bool:
        # blocking process wait — never on the control-plane loop
        return await asyncio.get_running_loop().run_in_executor(
            None, self.job_manager.stop, body["job_id"])

    @idempotent
    async def rpc_job_submissions(self, body=None) -> list:
        return self.job_manager.list()

    async def rpc_metrics_port(self, body=None) -> int:
        return self.metrics_server.port if self.metrics_server else -1

    async def rpc_dashboard_port(self, body=None) -> int:
        return self.dashboard_server.port if self.dashboard_server else -1

    async def _pg_retry_loop(self) -> None:
        """Pending placement groups retry as resources free up
        (≈ GcsPlacementGroupManager's pending queue ticking)."""
        while True:
            await asyncio.sleep(0.5)
            try:
                await self._retry_pending_pgs()
            except Exception:
                logger.exception("pg retry failed")

    async def stop(self) -> None:
        for t in (self._health_task, self._pg_retry_task,
                  self._snapshot_task):
            if t is not None:
                t.cancel()
        try:
            self._write_snapshot()
        except Exception:
            pass
        if self.metrics_server is not None:
            await self.metrics_server.stop()
        if self.dashboard_server is not None:
            await self.dashboard_server.stop()
        await self.clients.close_all()
        await self.server.stop()

    # ------------------------------------------------------------- nodes

    @idempotent  # overwrite-by-node-id; the 0.2s sync refreshes any staleness
    async def rpc_node_register(self, body) -> dict:
        rec = NodeRecord(
            node_id_hex=body["node_id_hex"],
            address=tuple(body["address"]),
            total=ResourceSet.of(body["total"]),
            available=ResourceSet.of(body["available"]),
            labels=body.get("labels", {}),
            last_seen=time.monotonic(),
            last_busy=time.monotonic(),
        )
        self.nodes[rec.node_id_hex] = rec
        self._ghost_nodes.pop(rec.node_id_hex, None)
        logger.info("node %s registered at %s", rec.node_id_hex[:8], rec.address)
        # node RECORDS are soft state (supervisors re-register), but the
        # node's EXISTENCE is WAL'd: a node that dies during a controller
        # outage would otherwise be forgotten by the next incarnation,
        # which then never publishes the DEAD fan-out owners requeue
        # their in-flight leases on — they'd hang forever (a lost
        # lease resurfacing across the restart boundary)
        await self._wal_append("node",
                               (rec.node_id_hex, list(rec.address)))
        self.events.emit("NODE_REGISTERED",
                         f"node {rec.node_id_hex[:8]} joined",
                         node_id=rec.node_id_hex)
        await self._publish("nodes", {"event": "ALIVE", "node_id_hex": rec.node_id_hex})
        await self._retry_pending_pgs()
        if self._recovered:
            # a node RE-registering with a recovered controller still
            # hosts its worker pool: reconcile our recovered actor table
            # against its live reality (deaths during the outage may
            # never have landed — the supervisor's worker_died retry
            # budget is finite). Held in _bg_tasks: the loop keeps only
            # a weak reference, and a GC'd task would silently skip the
            # failover this reconcile exists for.
            task = asyncio.get_running_loop().create_task(
                self._reconcile_node_workers(rec))
            self._bg_tasks.add(task)
            task.add_done_callback(self._bg_tasks.discard)
        return {"num_nodes": len(self.nodes)}

    async def _reconcile_node_workers(self, rec: NodeRecord) -> None:
        """Fail over recovered-ALIVE actors whose worker no longer exists
        on their (re-registered) node. The normal path — the supervisor's
        ``worker_died`` — retries only ~15s; a longer controller outage
        would otherwise leave the actor ALIVE forever with every caller
        hanging on a dead address."""
        # (actor, worker) PAIRS are fixed BEFORE the profile RPC: an
        # actor whose ALIVE transition — or restart onto a fresh worker —
        # lands while the (up to 10s) call is in flight must not be
        # judged against the stale list; only an actor still on the SAME
        # worker the snapshot predates can be declared lost by it
        candidates = [(a, a.worker_id_hex) for a in self.actors.values()
                      if a.node_id_hex == rec.node_id_hex
                      and a.state == ACTOR_ALIVE and a.worker_id_hex]
        try:
            reply = await self.clients.get(rec.address).call(
                "worker_profile", {}, timeout=10)
        except Exception:
            return  # health loop / next sync covers a flapping node
        alive_workers = {w["worker_id_hex"] for w in reply.get("workers", [])}
        for actor, worker_hex in candidates:
            if (actor.state == ACTOR_ALIVE
                    and actor.worker_id_hex == worker_hex
                    and worker_hex not in alive_workers):
                logger.warning(
                    "recovered actor %s: worker %s gone during the "
                    "controller outage; failing over",
                    actor.actor_id_hex[:8], actor.worker_id_hex[:8])
                await self._on_actor_failure(
                    actor, "worker lost during controller outage")

    @idempotent  # latest-write-wins gossip
    async def rpc_node_sync(self, body):
        """Resource gossip from supervisors (≈ ray_syncer)."""
        rec = self.nodes.get(body["node_id_hex"])
        if rec is None:
            # a restarted controller has no node table: tell the
            # supervisor to re-register (recovery handshake)
            return {"unknown_node": True}
        rec.available = ResourceSet.of(body["available"])
        if "total" in body:
            rec.total = ResourceSet.of(body["total"])
        rec.store_stats = body.get("store_stats", {})
        rec.pending_demand = body.get("pending_demand", [])
        rec.last_seen = time.monotonic()
        rec.missed_health_checks = 0
        if rec.pending_demand or dict(rec.available) != dict(rec.total):
            rec.last_busy = time.monotonic()

    @idempotent
    async def rpc_node_views(self, body=None) -> list:
        return [
            {
                "node_id_hex": r.node_id_hex,
                "address": r.address,
                "total": dict(r.total),
                "available": dict(r.available),
                "alive": r.alive,
                "labels": r.labels,
                "drained": (not r.alive) and r.death_reason == "drained",
            }
            for r in self.nodes.values()
        ]

    @idempotent  # _mark_node_dead is a no-op on an already-dead node
    async def rpc_node_drain(self, body) -> None:
        await self._mark_node_dead(body["node_id_hex"], "drained")

    async def _health_loop(self) -> None:
        from ray_tpu_torch._private.rpc import RpcClient

        period = self.config.health_check_period_ms / 1000.0
        timeout = self.config.health_check_timeout_ms / 1000.0
        while True:
            await asyncio.sleep(period)
            for rec in list(self.nodes.values()):
                if not rec.alive:
                    continue
                # Passive freshness first: a recent sync counts as healthy.
                if time.monotonic() - rec.last_seen < period:
                    continue
                # Dedicated short-lived probe: a dead supervisor must fail
                # fast (ECONNREFUSED), not ride pooled-client reconnect
                # backoff (≈ GcsHealthCheckManager's per-check gRPC deadline).
                probe = RpcClient(rec.address, connect_timeout_s=min(1.0, timeout))
                try:
                    await probe.call("ping", timeout=timeout)
                    rec.last_seen = time.monotonic()
                    rec.missed_health_checks = 0
                except Exception:
                    rec.missed_health_checks += 1
                    if (
                        rec.missed_health_checks
                        >= self.config.health_check_failure_threshold
                    ):
                        await self._mark_node_dead(rec.node_id_hex, "health check failed")
                finally:
                    await probe.close()

    async def _mark_node_dead(self, node_hex: str, reason: str) -> None:
        rec = self.nodes.get(node_hex)
        if rec is None or not rec.alive:
            return
        rec.alive = False
        rec.death_reason = reason
        logger.warning("node %s dead: %s", node_hex[:8], reason)
        self._ghost_nodes.pop(node_hex, None)
        self.events.emit("NODE_DEAD", f"node {node_hex[:8]}: {reason}",
                         severity="WARNING", node_id=node_hex,
                         reason=reason)
        # address included so owners can match their leases' supervisor
        # addresses and requeue in-flight tasks that died with the node
        # (core_worker._on_node_dead — a dead supervisor can't send the
        # worker_failed notifications itself)
        await self._publish("nodes", {"event": "DEAD",
                                      "node_id_hex": node_hex,
                                      "address": list(rec.address),
                                      # drain vs crash travels with the
                                      # fan-out: a deliberate retirement
                                      # is a handoff, not an outage
                                      "reason": reason,
                                      "drained": reason == "drained"})
        # tombstone the WAL "node" frame AFTER the fan-out went out: the
        # next incarnation's ghost reconcile must not re-declare a
        # handled death on every restart, but a crash BEFORE the publish
        # must re-run it (duplicate fan-out is idempotent; a lost one
        # hangs owners)
        await self._wal_append("node_dead", node_hex)
        # fail over actors that lived there
        for actor in list(self.actors.values()):
            if actor.node_id_hex == node_hex and actor.state in (
                ACTOR_ALIVE,
                ACTOR_PENDING,
                ACTOR_RESTARTING,
            ):
                await self._on_actor_failure(actor, f"node {node_hex[:8]} died")
        # placement groups with bundles there go back to pending
        for pg in self.pgs.values():
            if pg.state == PG_CREATED and node_hex in pg.assignment:
                pg.state = PG_PENDING
                pg.assignment = []
                self._pg_kv_update(pg.pg_id_hex, None)
                await self._publish(
                    "pg:" + pg.pg_id_hex, {"state": PG_PENDING, "pg_id_hex": pg.pg_id_hex}
                )
        await self._retry_pending_pgs()

    # ------------------------------------------------------------- KV / functions

    def _kv_notify(self, ns: str, key: str, value) -> None:
        """Resolve kv_wait long-pollers parked on (ns, key)."""
        waiters = self._kv_waiters.pop((ns, key), None)
        if not waiters:
            return
        for fut in waiters:
            if not fut.done():
                fut.set_result(value)

    @replay_cached  # overwrite=False must answer a retry like the original
    async def rpc_kv_put(self, body) -> bool:
        value = body["value"]
        size = serialization.payload_nbytes(value)
        if size > self.config.kv_max_value_bytes:
            # the KV is a metadata plane: a tensor-sized value would creep
            # toward MAX_FRAME and stall every control RPC behind one
            # pickled socket — fail loudly with a pointer at the data plane
            raise ValueError(
                f"kv_put value for {body['key']!r} is {size} bytes, above "
                f"the control-plane cap of {self.config.kv_max_value_bytes} "
                f"(RAY_TPU_TORCH_KV_MAX_VALUE_BYTES). Move tensor-sized payloads "
                f"through the object store (ray_tpu_torch.put) or the collective "
                f"data plane (ray_tpu_torch.util.collective), not the controller "
                f"KV.")
        ns_name = body.get("ns", "")
        shard = self.kv.shard_for(ns_name)
        ns = shard.data.setdefault(ns_name, {})
        overwrite = body.get("overwrite", True)
        if not overwrite and body["key"] in ns:
            return False
        ns[body["key"]] = value
        self._mark_dirty()
        # KV writes back named-actor rendezvous, collective groups, and
        # runtime-env manifests — registrations in spirit: durable before
        # the ack, O(entry) via the SHARD's own WAL stream. The reply
        # (True) rides the same frame: a retried overwrite=False claim
        # straddling a controller restart is answered from the recovered
        # replay cache instead of being re-judged against its own write
        # (the serve-weights first-replica-wins pattern depends on it)
        await self._wal_append("kv", (ns_name, body["key"], value),
                               stream=shard.stream, lock=shard.lock,
                               reply=True)
        self._kv_notify(ns_name, body["key"], value)
        return True

    @idempotent
    async def rpc_kv_get(self, body):
        return self.kv.peek(body.get("ns", "")).get(body["key"])

    @idempotent  # pure read with a deadline; retries just re-park
    async def rpc_kv_wait(self, body) -> dict:
        """Long-poll for a key: return immediately when present, else park
        until the next kv_put on it (or the timeout). One RPC replaces a
        client-side sleep-and-repoll loop — the rendezvous latency floor,
        and far fewer control-plane round trips. A put that landed in the
        WAL before a controller kill resolves the RE-ISSUED wait (the
        client re-arms on reconnect, internal_kv.kv_wait) immediately
        from the recovered KV — this found-fast path IS the server-side
        half of the re-arm protocol."""
        ns = body.get("ns", "")
        key = body["key"]
        held = self.kv.peek(ns)
        if key in held:
            return {"found": True, "value": held[key]}
        timeout = min(float(body.get("timeout", 30.0)), 30.0)
        fut: asyncio.Future = asyncio.get_running_loop().create_future()
        self._kv_waiters.setdefault((ns, key), []).append(fut)
        try:
            value = await asyncio.wait_for(fut, timeout)
            return {"found": True, "value": value}
        except asyncio.TimeoutError:
            return {"found": False, "value": None}
        finally:
            waiters = self._kv_waiters.get((ns, key))
            if waiters is not None:
                if fut in waiters:
                    waiters.remove(fut)
                if not waiters:
                    self._kv_waiters.pop((ns, key), None)

    @replay_cached  # retry after a lost reply must still report existed=True
    async def rpc_kv_del(self, body) -> bool:
        self._mark_dirty()
        ns_name = body.get("ns", "")
        shard = self.kv.shard_for(ns_name)
        existed = shard.data.get(ns_name, {}).pop(
            body["key"], None) is not None
        if existed:
            # tombstone BEFORE the ack: without it, a crash after an
            # acked delete replays the earlier "kv" registration frame
            # and resurrects the key; the reply
            # rides the frame so a restart-straddling retry still
            # reports existed=True
            await self._wal_append("kv_del", (ns_name, body["key"]),
                                   stream=shard.stream, lock=shard.lock,
                                   reply=True)
        return existed

    @idempotent
    async def rpc_kv_exists(self, body) -> bool:
        return body["key"] in self.kv.peek(body.get("ns", ""))

    @idempotent
    async def rpc_kv_keys(self, body) -> list:
        prefix = body.get("prefix", "")
        return [k for k in self.kv.peek(body.get("ns", ""))
                if k.startswith(prefix)]

    # ------------------------------------------------------------- actors

    @replay_cached  # a retry would trip the name-conflict check on ITSELF
    async def rpc_actor_register(self, body) -> dict:
        """Register + schedule an actor creation.

        ≈ GcsActorManager::HandleRegisterActor + GcsActorScheduler::Schedule
        (gcs_actor_manager.cc:255, gcs_actor_scheduler.cc:49). The controller
        picks the node; the owner then leases from that supervisor and pushes
        the creation task (creation results flow to the owner like any task).
        """
        hexid = body["actor_id_hex"]
        name = body.get("name", "")
        namespace = body.get("namespace", "default")
        if hexid in self.actors:
            # Re-delivery of OUR OWN registration (actor ids are random
            # per registration, so only a retry can collide): recovery
            # re-derivation for the narrowest crash window where the
            # durable replay entry is absent. Without this, the retry
            # trips the name-conflict check below on ITSELF.
            return {"ok": True}
        if name:
            existing_hex = self.named_actors.get((namespace, name))
            if existing_hex is not None:
                existing = self.actors.get(existing_hex)
                if existing is not None and existing.state != ACTOR_DEAD:
                    raise ValueError(
                        f"actor name {name!r} already taken in namespace {namespace!r}"
                    )
        rec = ActorRecord(
            actor_id_hex=hexid,
            name=name,
            namespace=namespace,
            state=ACTOR_PENDING,
            owner=tuple(body["owner"]) if body.get("owner") else None,
            max_restarts=body.get("max_restarts", 0),
            creation_spec=body.get("creation_spec", b""),
            class_name=body.get("class_name", ""),
            job_id_hex=body.get("job_id_hex", ""),
            detached=body.get("detached", False),
        )
        self.actors[hexid] = rec
        if name:
            self.named_actors[(namespace, name)] = hexid
        self._mark_dirty()
        # ack implies durability; the reply rides the SAME frame so a
        # retry straddling a controller restart replays from the cache
        await self._wal_append("actor", rec, reply={"ok": True})
        chaos.maybe_crash("ctrl.actor_register")  # after WAL, before ack
        self.events.emit("ACTOR_REGISTERED",
                         f"actor {hexid[:8]} ({rec.class_name})",
                         actor_id=hexid, class_name=rec.class_name,
                         name=name, namespace=namespace)
        return {"ok": True}

    @replay_cached  # re-execution would double-increment the incarnation,
    async def rpc_actor_ready(self, body) -> None:  # resetting handle seqnos
        """Worker reports successful actor construction."""
        rec = self.actors.get(body["actor_id_hex"])
        if rec is None:
            return
        rec.state = ACTOR_ALIVE
        rec.address = tuple(body["address"])
        rec.worker_id_hex = body.get("worker_id_hex", "")
        rec.node_id_hex = body.get("node_id_hex", "")
        rec.incarnation += 1
        self._mark_dirty()
        # the ALIVE transition used to be interval-snapshot soft state: a
        # controller kill inside the window left a recovered record
        # PENDING forever (no node_id_hex -> reconcile skipped it) while
        # the actor ran. Durable before the ack, like every transition a
        # peer acts on; the frame's replay key stops a restart-straddling
        # retry from double-incrementing the incarnation (handle seqno
        # reset semantics ride it).
        await self._wal_append(
            "actor_ready",
            (rec.actor_id_hex, list(rec.address), rec.worker_id_hex,
             rec.node_id_hex, rec.incarnation),
            reply=None)
        await self._publish(
            "actor:" + rec.actor_id_hex,
            {
                "state": ACTOR_ALIVE,
                "address": rec.address,
                "incarnation": rec.incarnation,
            },
        )

    @replay_cached  # terminal transition + death fan-out must run once
    async def rpc_actor_creation_failed(self, body) -> None:
        rec = self.actors.get(body["actor_id_hex"])
        if rec is None:
            return
        await self._kill_actor(rec, reason=body.get("reason", "creation failed"), restart=False)

    @idempotent
    async def rpc_actor_get(self, body):
        rec = self.actors.get(body["actor_id_hex"])
        return dataclasses.asdict(rec) if rec else None

    @idempotent
    async def rpc_actor_by_name(self, body):
        hexid = self.named_actors.get((body.get("namespace", "default"), body["name"]))
        if hexid is None:
            return None
        rec = self.actors.get(hexid)
        return dataclasses.asdict(rec) if rec else None

    @idempotent
    async def rpc_actor_list(self, body=None) -> list:
        return [dataclasses.asdict(r) for r in self.actors.values()]

    @replay_cached  # restart=True re-execution would burn a second restart
    async def rpc_actor_kill(self, body) -> None:
        rec = self.actors.get(body["actor_id_hex"])
        if rec is None:
            return
        no_restart = body.get("no_restart", True)
        # kill the live worker process via its supervisor
        node = self.nodes.get(rec.node_id_hex)
        if rec.state == ACTOR_ALIVE and node is not None and node.alive:
            try:
                await self.clients.get(node.address).call(
                    "kill_worker", {"worker_id_hex": rec.worker_id_hex}, timeout=5
                )
            except Exception:
                pass
        await self._kill_actor(
            rec, reason="killed via ray_tpu_torch.kill", restart=not no_restart
        )

    @replay_cached  # duplicate would double _on_actor_failure: two restart
    async def rpc_worker_died(self, body) -> None:  # loops, num_restarts += 2
        """Supervisor reports a worker process exit."""
        actor_hex = body.get("actor_id_hex", "")
        if actor_hex and actor_hex in self.actors:
            rec = self.actors[actor_hex]
            if rec.state in (ACTOR_ALIVE, ACTOR_PENDING):
                await self._on_actor_failure(
                    rec, body.get("reason", "worker process died")
                )

    async def _on_actor_failure(self, rec: ActorRecord, reason: str) -> None:
        if rec.num_restarts < rec.max_restarts or rec.max_restarts == -1:
            rec.num_restarts += 1
            rec.state = ACTOR_RESTARTING
            rec.address = None
            self._mark_dirty()
            await self._publish(
                "actor:" + rec.actor_id_hex,
                {"state": ACTOR_RESTARTING, "num_restarts": rec.num_restarts},
            )
            asyncio.get_running_loop().create_task(self._restart_actor(rec))
        else:
            await self._kill_actor(rec, reason, restart=False)

    async def _kill_actor(self, rec: ActorRecord, reason: str, restart: bool) -> None:
        if restart and (rec.num_restarts < rec.max_restarts or rec.max_restarts == -1):
            await self._on_actor_failure(rec, reason)
            return
        owner_addr = rec.address
        rec.state = ACTOR_DEAD
        rec.death_cause = reason
        rec.address = None
        self._mark_dirty()
        # tombstone: a crash between the kill and the next snapshot must
        # not replay the registration frame and resurrect the actor —
        # named_actors would rebind to a dead record.
        # When a replay-cached RPC (actor_kill/worker_died/creation_failed)
        # drove us here, its replay key rides the tombstone so the death
        # fan-out can never run twice across a controller restart.
        await self._wal_append("actor_dead", (rec.actor_id_hex, reason),
                               reply=None)
        self.events.emit("ACTOR_DEAD",
                         f"actor {rec.actor_id_hex[:8]}: {reason}",
                         severity="WARNING", actor_id=rec.actor_id_hex,
                         class_name=rec.class_name, reason=reason)
        await self._publish(
            "actor:" + rec.actor_id_hex, {"state": ACTOR_DEAD, "reason": reason}
        )
        # ownership fate-sharing (reference: non-detached actors die with
        # their owner): actors CREATED BY the dead actor's process must
        # not outlive it holding resources
        if owner_addr is not None:
            for child in list(self.actors.values()):
                if (child.owner == owner_addr
                        and not child.detached
                        and child.state != ACTOR_DEAD):
                    node = self.nodes.get(child.node_id_hex)
                    if child.state == ACTOR_ALIVE and node is not None \
                            and node.alive:
                        try:
                            await self.clients.get(node.address).call(
                                "kill_worker",
                                {"worker_id_hex": child.worker_id_hex},
                                timeout=5)
                        except Exception:
                            pass
                    await self._kill_actor(
                        child, f"owner actor {rec.actor_id_hex[:8]} died",
                        restart=False)

    async def _restart_actor(self, rec: ActorRecord) -> None:
        """Re-run the creation task on a fresh worker (≈ gcs_actor_manager.cc:1190)."""
        from ray_tpu_torch._private.scheduling import pick_node
        from ray_tpu_torch._private.task_spec import TaskSpec  # noqa: F401 — deserialized below

        try:
            spec = serialization.loads(rec.creation_spec)
        except Exception as e:
            await self._kill_actor(rec, f"cannot restart: bad creation spec ({e})", False)
            return
        delay = 0.1
        while rec.state == ACTOR_RESTARTING:
            views = [r.view() for r in self.nodes.values() if r.alive]
            node = pick_node(views, spec.required_resources(), spec.strategy)
            if node is not None:
                try:
                    grant = await self.clients.get(node.address).call(
                        "request_lease",
                        {"spec": serialization.dumps(spec), "no_spillback": True},
                        timeout=self.config.worker_lease_timeout_s,
                    )
                    if grant.get("granted"):
                        base = self.config.rpc_retry_interval_ms / 1000.0
                        # mark the worker as actor-hosting BEFORE it can run
                        # (its death must reach us for restart accounting)
                        await retry_call(
                            self.clients.get(node.address),
                            "worker_set_actor",
                            {
                                "worker_id_hex": grant["worker_id_hex"],
                                "actor_id_hex": rec.actor_id_hex,
                            },
                            timeout=15, per_call_timeout=5,
                            base_interval_s=base,
                        )
                        await retry_call(
                            self.clients.get(tuple(grant["worker_address"])),
                            "push_task",
                            {"spec": serialization.dumps(spec)},
                            timeout=30, per_call_timeout=10,
                            base_interval_s=base,
                        )
                        return  # worker reports actor_ready on success
                except Exception as e:
                    logger.warning(
                        "actor %s restart attempt failed: %s", rec.actor_id_hex[:8], e
                    )
            await asyncio.sleep(delay)
            delay = min(delay * 2, 5.0)

    # ------------------------------------------------------------- placement groups

    @replay_cached  # re-execution re-places a created group from scratch
    async def rpc_pg_create(self, body) -> dict:
        existing = self.pgs.get(body["pg_id_hex"])
        if existing is not None:
            # re-delivery of our own registration (ids are random per
            # create) after a controller restart dropped the in-memory
            # replay entry: answer with current state, never re-place —
            # re-reserving bundles for a CREATED group would double-count
            # its resources on every assigned node
            return {"state": existing.state,
                    "assignment": existing.assignment}
        pg = PGRecord(
            pg_id_hex=body["pg_id_hex"],
            bundles=body["bundles"],
            strategy=body.get("strategy", "PACK"),
            state=PG_PENDING,
            name=body.get("name", ""),
            creator_job_hex=body.get("job_id_hex", ""),
        )
        self.pgs[pg.pg_id_hex] = pg
        self._mark_dirty()
        await self._wal_append("pg", pg)  # ack implies durability
        self.events.emit("PLACEMENT_GROUP_CREATED",
                         f"pg {pg.pg_id_hex[:8]} ({len(pg.bundles)} bundles)",
                         pg_id=pg.pg_id_hex, strategy=pg.strategy)
        await self._try_place_pg(pg)
        return {"state": pg.state, "assignment": pg.assignment}

    def _pg_kv_update(self, pg_id_hex: str, state: Optional[str]) -> None:
        """Mirror a PG's terminal-ish state into the KV ns 'pg' so
        PlacementGroup.wait() can long-poll it via kv_wait instead of
        hammering pg_get on a 50 ms sleep loop. ``None`` clears the key
        (reversion to PENDING on node death). REMOVED notifies parked
        waiters and then reaps the key — it is terminal, wait() re-checks
        pg_get on every wake anyway, and keeping it would grow the KV by
        one entry per PG ever removed."""
        ns = self.kv.namespace("pg")
        if state is None:
            ns.pop(pg_id_hex, None)
        elif state == PG_REMOVED:
            self._kv_notify("pg", pg_id_hex, state)
            ns.pop(pg_id_hex, None)
        else:
            ns[pg_id_hex] = state
            self._kv_notify("pg", pg_id_hex, state)

    async def _try_place_pg(self, pg: PGRecord) -> None:
        views = [r.view() for r in self.nodes.values() if r.alive]
        try:
            assignment = place_bundles(views, pg.bundles, pg.strategy)
        except PlacementError:
            return  # stays pending
        # Reserve each bundle on its node; roll back on partial failure.
        reserved: List[Tuple[str, int]] = []
        ok = True
        for index, node_hex in enumerate(assignment):
            rec = self.nodes[node_hex]
            try:
                await self.clients.get(rec.address).call(
                    "reserve_bundle",
                    {
                        "pg_id_hex": pg.pg_id_hex,
                        "bundle_index": index,
                        "resources": pg.bundles[index],
                    },
                    timeout=10,
                )
                reserved.append((node_hex, index))
            except Exception as e:
                logger.warning("bundle reserve failed on %s: %s", node_hex[:8], e)
                ok = False
                break
        if not ok:
            for node_hex, index in reserved:
                try:
                    await self.clients.get(self.nodes[node_hex].address).call(
                        "release_bundle",
                        {"pg_id_hex": pg.pg_id_hex, "bundle_index": index},
                        timeout=10,
                    )
                except Exception:
                    pass
            return
        pg.assignment = assignment
        pg.state = PG_CREATED
        self._pg_kv_update(pg.pg_id_hex, PG_CREATED)
        self._mark_dirty()
        await self._publish(
            "pg:" + pg.pg_id_hex,
            {"state": PG_CREATED, "assignment": assignment, "pg_id_hex": pg.pg_id_hex},
        )

    async def _retry_pending_pgs(self) -> None:
        for pg in self.pgs.values():
            if pg.state == PG_PENDING:
                await self._try_place_pg(pg)

    @idempotent
    async def rpc_pg_get(self, body):
        pg = self.pgs.get(body["pg_id_hex"])
        return dataclasses.asdict(pg) if pg else None

    @idempotent
    async def rpc_pg_list(self, body=None) -> list:
        return [dataclasses.asdict(p) for p in self.pgs.values()]

    @idempotent  # guarded by the REMOVED state check below
    async def rpc_pg_remove(self, body) -> None:
        pg = self.pgs.get(body["pg_id_hex"])
        if pg is None or pg.state == PG_REMOVED:
            return
        for index, node_hex in enumerate(pg.assignment):
            rec = self.nodes.get(node_hex)
            if rec is None or not rec.alive:
                continue
            try:
                await self.clients.get(rec.address).call(
                    "release_bundle",
                    {"pg_id_hex": pg.pg_id_hex, "bundle_index": index},
                    timeout=10,
                )
            except Exception:
                pass
        pg.state = PG_REMOVED
        pg.assignment = []
        self._pg_kv_update(pg.pg_id_hex, PG_REMOVED)
        self._mark_dirty()
        await self._publish("pg:" + pg.pg_id_hex, {"state": PG_REMOVED})

    # ------------------------------------------------------------- jobs

    @replay_cached  # a retried mint must get the ORIGINAL number back
    async def rpc_job_new(self, body=None) -> int:
        """Issue a cluster-unique job number (drivers must not mint their own:
        two drivers on one cluster would both claim job 1)."""
        # capture before awaiting: concurrent callers each get their own
        # value (the await suspends; reading the counter afterwards would
        # hand both callers the same id)
        self._next_job_int += 1
        issued = self._next_job_int
        self._mark_dirty()
        # never reissue on crash; the reply rides the frame so a retry
        # straddling a restart gets the ORIGINAL number from the cache
        await self._wal_append("job_int", issued, reply=issued)
        return issued

    @replay_cached  # keeps start_time stable and the WAL free of dup frames
    async def rpc_job_register(self, body) -> None:
        if body["job_id_hex"] in self.jobs:
            return  # restart-straddling re-delivery: keep start_time
        self.jobs[body["job_id_hex"]] = JobRecord(
            job_id_hex=body["job_id_hex"],
            driver_address=tuple(body["driver_address"]) if body.get("driver_address") else None,
            start_time=time.time(),
        )
        self._mark_dirty()
        await self._wal_append("job", self.jobs[body["job_id_hex"]],
                               reply=None)
        self.events.emit("JOB_STARTED", f"job {body['job_id_hex'][:8]}",
                         job_id=body["job_id_hex"])

    @idempotent  # alive=False converges; the extra WAL tombstone is harmless
    async def rpc_job_finish(self, body) -> None:
        job = self.jobs.get(body["job_id_hex"])
        if job:
            job.alive = False
            job.end_time = time.time()
            self._mark_dirty()
            # tombstone: keep a finished job finished across a crash that
            # would otherwise replay its registration frame
            await self._wal_append("job_finish",
                                   (job.job_id_hex, job.end_time))
            self.events.emit("JOB_FINISHED",
                             f"job {body['job_id_hex'][:8]}",
                             job_id=body["job_id_hex"])

    @idempotent
    async def rpc_job_list(self, body=None) -> list:
        return [dataclasses.asdict(j) for j in self.jobs.values()]

    # ------------------------------------------------------------- pubsub

    async def rpc_events_list(self, body=None) -> list:
        """Session-wide structured events, merged across every daemon's
        JSONL file (≈ dashboard/modules/event list API)."""
        from ray_tpu_torch._private.events import read_events

        body = body or {}
        if not self.session_dir:
            return []
        return read_events(
            self.session_dir,
            limit=body.get("limit", 1000),
            event_type=body.get("event_type"),
            source_type=body.get("source_type"),
            severity=body.get("severity"))

    @idempotent  # set add
    async def rpc_subscribe(self, body) -> None:
        self.subscribers.setdefault(body["channel"], set()).add(tuple(body["address"]))

    @idempotent  # set discard
    async def rpc_unsubscribe(self, body) -> None:
        self.subscribers.get(body["channel"], set()).discard(tuple(body["address"]))

    @idempotent  # subscribers tolerate duplicate fan-out messages
    async def rpc_publish(self, body) -> None:
        await self._publish(body["channel"], body["message"])

    async def _publish(self, channel: str, message: Any) -> None:
        # snapshot: subscribe RPCs may mutate the set while we await notifies
        subs = list(self.subscribers.get(channel, set()))
        if not subs:
            return

        async def one(addr: Address) -> Optional[Address]:
            try:
                # bounded + concurrent: a dead subscriber costs the publish
                # 2s ONCE (then it's pruned), never a serial 10s connect
                # window per address — node-death fan-out must stay prompt
                await asyncio.wait_for(
                    self.clients.get(addr).notify(
                        "on_publish",
                        {"channel": channel, "message": message}),
                    timeout=2.0)
                return None
            except Exception:
                return addr

        for addr in await asyncio.gather(*(one(a) for a in subs)):
            if addr is not None:
                self.subscribers[channel].discard(addr)

    # ------------------------------------------------------------- observability

    async def rpc_task_events(self, body) -> None:
        for ev in body["events"]:
            self.task_events.append(ev)
        self._m_task_events.inc(len(body["events"]))

    @idempotent
    async def rpc_state_tasks(self, body=None) -> list:
        limit = (body or {}).get("limit", 1000)
        return list(self.task_events)[-limit:]

    @idempotent
    async def rpc_cluster_status(self, body=None) -> dict:
        total = ResourceSet()
        avail = ResourceSet()
        for r in self.nodes.values():
            if r.alive:
                total.add(r.total)
                avail.add(r.available)
        return {
            "nodes_alive": sum(1 for r in self.nodes.values() if r.alive),
            "nodes_dead": sum(1 for r in self.nodes.values() if not r.alive),
            "total_resources": dict(total),
            "available_resources": dict(avail),
            "num_actors": len(self.actors),
            "num_pgs": len(self.pgs),
            "uptime_s": time.time() - self._started,
        }

    @idempotent
    async def rpc_ping(self, body=None) -> str:
        return "pong"

    @idempotent  # pure placement decision: a redirect, never a grant
    async def rpc_request_lease(self, body) -> dict:
        """Controller-mediated lease PLACEMENT — the spillover/entry path
        only, never the steady state. A supervisor-less driver (client
        mode) or an exhausted spillback chain asks the controller to pick
        a node from its authoritative table; the answer is always a
        ``retry_at`` redirect to that node's supervisor, which grants from
        its own pool. Leases therefore stay node state the controller
        never has to recover, and the common case — owner on a node with
        capacity — leases node-locally without touching this handler
        (counter-proven via ray_tpu_rpc_server_requests_total in
        tests/test_controller_ha.py)."""
        from ray_tpu_torch._private.scheduling import pick_node
        from ray_tpu_torch._private.task_spec import TaskSpec  # noqa: F401

        spec = serialization.loads(body["spec"])
        views = [r.view() for r in self.nodes.values() if r.alive]
        if not views:
            return {"granted": False, "error": "no alive nodes"}
        node = pick_node(
            views, spec.required_resources(), spec.strategy,
            spread_threshold=self.config.scheduler_spread_threshold)
        if node is None:
            # nothing fits NOW: hand it to a supervisor anyway — it parks
            # the lease as infeasible and advertises the demand to the
            # autoscaler (a flat rejection here would lose that signal)
            node = views[0]
        return {"granted": False, "retry_at": node.address,
                "hops": int(body.get("hops", 0))}

    @idempotent
    async def rpc_autoscaler_state(self, body=None) -> dict:
        """Cluster state consumed by StandardAutoscaler.update():
        per-node views + pending demand + idle ages
        (≈ LoadMetrics fed by GCS resource reports,
        python/ray/autoscaler/_private/load_metrics.py)."""
        now = time.monotonic()
        return {
            "nodes": [
                {
                    "node_id_hex": r.node_id_hex,
                    "total": dict(r.total),
                    "available": dict(r.available),
                    "alive": r.alive,
                    "labels": r.labels,
                    "pending_demand": r.pending_demand,
                    "idle_s": (now - r.last_busy) if r.alive else 0.0,
                }
                for r in self.nodes.values()
            ],
        }


_DASHBOARD_HTML = """<!doctype html>
<html><head><title>ray_tpu_torch dashboard</title><style>
body{font-family:monospace;margin:2em;background:#111;color:#ddd}
h1{color:#7fd} h2{color:#9cf;margin-top:1.2em} table{border-collapse:collapse}
td,th{border:1px solid #444;padding:4px 10px;text-align:left}
.ok{color:#7f7}.bad{color:#f77} pre{background:#000;padding:8px}
</style></head><body>
<h1>ray_tpu_torch</h1>
<div id=cluster></div><h2>Nodes</h2><div id=nodes></div>
<h2>Actors</h2><div id=actors></div><h2>Jobs</h2><div id=jobs></div>
<h2>Workers</h2><div id=workers></div>
<h2>Task summary</h2><div id=tasksum></div>
<h2>Events</h2><div id=events></div>
<script>
function esc(s){return String(s).replace(/&/g,'&amp;').replace(/</g,'&lt;')
 .replace(/>/g,'&gt;').replace(/"/g,'&quot;');}
function table(rows, cols){if(!rows.length)return '<i>none</i>';
 let h='<table><tr>'+cols.map(c=>'<th>'+esc(c)+'</th>').join('')+'</tr>';
 for(const r of rows){h+='<tr>'+cols.map(c=>'<td>'+
  esc(JSON.stringify(r[c]??''))+'</td>').join('')+'</tr>';}return h+'</table>';}
async function refresh(){
 const c=await (await fetch('/api/cluster')).json();
 document.getElementById('cluster').innerHTML='<pre>'+
  JSON.stringify(c,null,1)+'</pre>';
 const n=await (await fetch('/api/nodes')).json();
 document.getElementById('nodes').innerHTML=
  table(n,['node_id_hex','alive','total','available']);
 const a=await (await fetch('/api/actors')).json();
 document.getElementById('actors').innerHTML=
  table(a,['actor_id_hex','class_name','state','name']);
 const j=await (await fetch('/api/jobs')).json();
 document.getElementById('jobs').innerHTML=
  table(j,['job_id','status','entrypoint']);
 const w=await (await fetch('/api/workers')).json();
 document.getElementById('workers').innerHTML=
  table(w,['node_id_hex','worker_id_hex','pid','is_actor',
           'actor_id_hex']);
 const ts=await (await fetch('/api/task_summary')).json();
 const cols=new Set(['name']);
 for(const r of ts)Object.keys(r).forEach(k=>cols.add(k));
 document.getElementById('tasksum').innerHTML=table(ts,[...cols]);
 const ev=await (await fetch('/api/events')).json();
 document.getElementById('events').innerHTML=
  table(ev.slice(-40).reverse(),
        ['severity','source_type','event_type','message']);
}
refresh();setInterval(refresh,2000);
</script></body></html>"""


def main() -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--port", type=int, default=0)
    parser.add_argument("--session-dir", default="")
    parser.add_argument("--address-file", default="")
    parser.add_argument("--snapshot-path", default="")
    args = parser.parse_args()

    logging.basicConfig(
        level=os.environ.get("RAY_TPU_TORCH_LOG_LEVEL", "INFO"),
        format="[controller] %(asctime)s %(levelname)s %(message)s",
    )
    from ray_tpu_torch._private.watchdog import start_owner_watchdog_from_env

    start_owner_watchdog_from_env("controller")

    async def run():
        snapshot = args.snapshot_path
        if not snapshot and args.session_dir:
            snapshot = os.path.join(args.session_dir, "controller_state.bin")
        controller = Controller(Config.from_env(), args.host, args.port,
                                snapshot_path=snapshot,
                                session_dir=args.session_dir)
        addr = await controller.start()
        if args.address_file:
            tmp = args.address_file + ".tmp"
            with open(tmp, "w") as f:
                f.write(f"{addr[0]}:{addr[1]}")
            os.replace(tmp, args.address_file)
        logger.info("controller listening on %s:%s", *addr)
        await asyncio.Event().wait()

    asyncio.run(run())


if __name__ == "__main__":
    main()
