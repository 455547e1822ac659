"""Per-process core runtime.

Analog of the reference's CoreWorker
(`src/ray/core_worker/core_worker.h:292`): linked into the driver and every
worker process. Owns:

  * task submission with lease pipelining (≈ `CoreWorkerDirectTaskSubmitter`
    `transport/direct_task_transport.cc:24,197,353`: leases are cached per
    resource shape and up to ``max_tasks_in_flight_per_worker`` tasks ride one
    leased worker),
  * object ownership: returned/put objects are owned by this process; small
    values live in the in-process store, large ones in the node's shared
    arena; remote readers resolve through the owner
    (≈ `TaskManager` + in-process memory store),
  * reference counting + free (≈ `ReferenceCounter` `reference_count.h:61`),
  * task retries on worker crash (≈ task retries, `task_manager.cc`),
  * the direct actor transport with per-handle sequence numbers
    (≈ `direct_actor_task_submitter.h`, callee ordering in the worker).

All internal state lives on a background asyncio loop thread; public methods
are thread-safe bridges (the executing user code runs on a separate thread in
workers, mirroring the reference's task-execution/IO thread split).
"""

from __future__ import annotations

import asyncio
import dataclasses
import hashlib
import logging
import os
import random
import threading
import time
import weakref
from collections import OrderedDict, deque
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from ray_tpu_torch._private import device_objects, serialization
from ray_tpu_torch._private.metrics import Counter, Gauge
from ray_tpu_torch._private.config import Config
from ray_tpu_torch._private.exceptions import (
    ActorDiedError,
    GetTimeoutError,
    ObjectLostError,
    TaskError,
    WorkerCrashedError,
)
from ray_tpu_torch._private.ids import ActorID, JobID, ObjectID, TaskID, WorkerID
from ray_tpu_torch._private.object_store import ArenaFile, InProcessStore
from ray_tpu_torch._private.rpc import (
    ClientPool,
    RpcClient,
    RpcConnectionError,
    RpcServer,
    RpcTimeoutError,
    RemoteError,
    idempotent,
    replay_cached,
    retry_call,
)
from ray_tpu_torch._private.task_spec import (
    ArgKind,
    PlacementGroupStrategy,
    SchedulingStrategy,
    TaskArg,
    TaskKind,
    TaskSpec,
)

logger = logging.getLogger(__name__)

Address = Tuple[str, int]

# ---- object data-plane metrics (per process; rendered by each daemon's
# /metrics endpoint and read directly by counter-based tests) ----
_m_reads = Counter(
    "ray_tpu_object_reads_total",
    "Object payload reads by mode (zero_copy = views over the arena mmap, "
    "copy = bytes copied out of the store)")
_m_read_bytes = Counter(
    "ray_tpu_object_read_bytes_total",
    "Payload bytes served on get, by mode")
_m_put_bytes = Counter(
    "ray_tpu_object_put_bytes_total",
    "Payload bytes written on put/task-return, by path (arena/inline)")
_m_pins = Gauge(
    "ray_tpu_object_pins_outstanding",
    "Arena pins this process holds (released when the last zero-copy "
    "view is garbage-collected)")
_m_locate_rpcs = Counter(
    "ray_tpu_store_locate_rpcs_total",
    "locate RPCs issued to node stores (a batch counts once)")


class _PinGuard:
    """Owns ONE supervisor-side pin across N zero-copy buffer views.

    Each out-of-band buffer handed to pickle gets a finalizer that calls
    dec(); once every view is gone AND arm() has confirmed construction
    finished, the release callback fires exactly once. Finalizers run on
    whatever thread drops the last reference, so the count is
    lock-protected and the callback must be thread-safe."""

    __slots__ = ("_release", "_count", "_armed", "_released", "_lock")

    def __init__(self, release: Callable[[], None]):
        self._release = release
        self._count = 0
        self._armed = False
        self._released = False
        self._lock = threading.Lock()

    def inc(self) -> None:
        with self._lock:
            self._count += 1

    def dec(self) -> None:
        self._maybe_release(dec=True)

    def arm(self) -> None:
        """Construction done: release immediately if nothing kept a view
        (pure in-band payloads), else wait for the finalizers."""
        self._maybe_release(arm=True)

    def _maybe_release(self, dec: bool = False, arm: bool = False) -> None:
        with self._lock:
            if dec:
                self._count -= 1
            if arm:
                self._armed = True
            fire = self._armed and self._count <= 0 and not self._released
            if fire:
                self._released = True
        if fire:
            self._release()


class _LocateBatcher:
    """Coalesces concurrent pinned-locate requests to this node's store
    into ``store_locate_batch`` RPCs: a ``ray.get([refs...])`` burst costs
    O(nodes) locate round-trips, not O(refs) (the shape that failed the
    reference's 1k-refs microbench). Runs on the owning IO loop."""

    MAX_BATCH = 512

    def __init__(self, core: "CoreWorker"):
        self._core = core
        self._queue: List[Tuple[ObjectID, asyncio.Future]] = []
        self._flushing = False

    async def locate(self, oid: ObjectID) -> Optional[Tuple[int, int]]:
        """Pinned locate of one object; returns (offset, size) or None.
        The pin belongs to the caller from the moment a non-None result is
        set — cancellation windows hand it back (see except branch)."""
        fut = asyncio.get_running_loop().create_future()
        self._queue.append((oid, fut))
        if not self._flushing:
            self._flushing = True
            asyncio.get_running_loop().create_task(self._flush())
        try:
            return await fut
        except asyncio.CancelledError:
            # the RPC completed with a pin but our waiter was cancelled
            # before consuming it: give the pin back
            if (fut.done() and not fut.cancelled()
                    and fut.exception() is None
                    and fut.result() is not None):
                self._core._schedule_unpin(oid)
            raise

    async def _flush(self) -> None:
        try:
            while self._queue:
                # one tick so the whole submitting burst enqueues first
                await asyncio.sleep(0)
                batch = self._queue[: self.MAX_BATCH]
                del self._queue[: len(batch)]
                body = {
                    "object_ids": [o.binary() for o, _ in batch],
                    "pin": True,
                    "client": self._core._store_client_id,
                    # lets the supervisor's liveness sweep reclaim our
                    # pins if this process is killed without cleanup
                    "client_addr": self._core.address,
                }
                _m_locate_rpcs.inc()
                try:
                    # 600s: a batch may restore several spilled objects
                    res = await self._core.clients.get(
                        self._core.supervisor_addr).call(
                            "store_locate_batch", body, timeout=600)
                except Exception as e:  # noqa: BLE001 — fan the error out
                    # Deliberately NO speculative unpin here even though
                    # the handler may have executed with only the reply
                    # lost: pins are per-client COUNTS, so a blind
                    # decrement could steal the pin a retry just took and
                    # recycle the range under a live view. A possibly
                    # leaked pin is bounded (reclaimed on client death /
                    # graceful departure); a stolen pin is corruption.
                    for _, fut in batch:
                        if not fut.done():
                            fut.set_exception(e)
                    continue
                for (oid, fut), item in zip(batch, res):
                    err = item.get("error") if isinstance(item, dict) else None
                    pinned = item is not None and err is None
                    if pinned:
                        _m_pins.inc()
                    if fut.done():  # waiter cancelled while we were out
                        if pinned:
                            self._core._schedule_unpin(oid)
                        continue
                    if err is not None:
                        fut.set_exception(ObjectLostError(oid.hex(), err))
                    elif item is None:
                        fut.set_result(None)
                    else:
                        fut.set_result((item["offset"], item["size"]))
        finally:
            self._flushing = False

_TRACE_PATH = os.environ.get("RAY_TPU_TORCH_TRACE_FILE", "")


def _trace(msg: str) -> None:
    if _TRACE_PATH:
        with open(_TRACE_PATH, "a") as f:
            f.write(f"[{os.getpid()} {time.monotonic():.3f}] {msg}\n")

# object entry states at the owner
PENDING = "PENDING"
INLINE = "INLINE"  # packed bytes in the in-process store
SHARED = "SHARED"  # in a node arena; location recorded
DEVICE = "DEVICE"  # CUDA tensor or DTensor shards parked in registries
FAILED = "FAILED"


@dataclasses.dataclass
class ObjectEntry:
    object_id: ObjectID
    state: str = PENDING
    size: int = 0
    location: Optional[Address] = None  # supervisor address holding the data
    error: Optional[Exception] = None
    event: Optional[asyncio.Event] = None
    local_refs: int = 0
    borrows: int = 0
    task_pins: int = 0  # pinned as in-flight task args
    # DEVICE entries: serialized DeviceArrayMeta; for task returns the
    # holder is the EXECUTOR worker (location = its worker address, the
    # the tensor stays there), for puts the owner itself (location None)
    device_meta: Optional[bytes] = None
    # a sharded (DTensor) put's holders: worker address per flat mesh
    # coordinate (the meta names each shard's coordinate)
    holders: Optional[List[Address]] = None


@dataclasses.dataclass
class _Lease:
    lease_id: int
    worker_id_hex: str
    worker_addr: Address
    supervisor_addr: Address
    in_flight: int = 0
    shape_key: str = ""
    broken: bool = False


@dataclasses.dataclass
class _PendingTask:
    spec: TaskSpec
    retries_left: int = 0
    lease: Optional[_Lease] = None
    # connection-refused pushes requeued without burning retries_left
    # (bounded — see _on_push_failure)
    free_requeues: int = 0


class _StreamEnd(Exception):
    """Internal end-of-stream marker (StopIteration cannot cross
    coroutine boundaries, PEP 479)."""


class _StreamState:
    """Owner-side state of one streaming generator task
    (≈ the reference's task-manager stream bookkeeping behind
    ObjectRefGenerator, `_raylet.pyx:273` / item reporting
    `core_worker.cc:3260`). Items land here as the executor yields them;
    consumers block on `event` for the next item, total count, or error."""

    __slots__ = ("items", "total", "error", "event", "consumed",
                 "consumed_event", "finished")

    def __init__(self):
        self.items: List[ObjectID] = []  # yield order; entries in .objects
        self.total: Optional[int] = None  # item count once exhausted
        self.error: Optional[Exception] = None
        self.event = asyncio.Event()
        self.consumed = 0  # high-water mark acked to the executor
        self.consumed_event = asyncio.Event()  # backpressure long-poll
        self.finished = False


class ActorHandleState:
    """Client-side state for one actor handle lineage (shared across copies)."""

    def __init__(self, actor_id: ActorID, caller_id: str):
        self.actor_id = actor_id
        self.caller_id = caller_id
        self.seqno = 0
        self.address: Optional[Address] = None
        self.incarnation = -1
        self.dead = False
        self.death_reason = ""
        # push batching: queued submissions drained by one flusher task
        # (seqnos are pre-assigned; the executor's reorder buffer owns
        # execution order, so batching only coalesces RPC frames)
        self.outbox: deque = deque()
        self.flusher = None


class CoreWorker:
    def __init__(
        self,
        config: Config,
        controller_addr: Address,
        supervisor_addr: Optional[Address],
        job_id: JobID,
        role: str = "driver",
        worker_id: Optional[WorkerID] = None,
    ):
        self.config = config
        self.controller_addr = controller_addr
        self.supervisor_addr = supervisor_addr
        self.job_id = job_id
        self.role = role
        from ray_tpu_torch._private import flight as _flight

        _flight.set_role(role)  # merged-timeline rows group by role
        self.worker_id = worker_id or WorkerID.from_random()
        self.node_id_hex = ""
        self.arena: Optional[ArenaFile] = None
        self.actor_id: Optional[ActorID] = None  # set when this process hosts an actor

        self.in_process = InProcessStore()
        self.objects: Dict[ObjectID, ObjectEntry] = {}
        # identity under which this process pins arena objects; the
        # supervisor releases a dead worker's pins by this id
        self._store_client_id = self.worker_id.hex()
        self._locate_batcher: Optional[_LocateBatcher] = None
        # pending pin releases (filled by view finalizers from any thread,
        # drained as store_unpin_batch frames by one flusher on the loop)
        self._unpin_queue: deque = deque()
        self._unpin_flushing = False
        # CUDA tensors put through the object layer stay on the card, owned here
        # (device_objects.py — the compiled-DAG/channels answer)
        self.device_objects = device_objects.DeviceObjectRegistry()
        self._fn_cache: Dict[str, Any] = {}
        self._fn_registered: set = set()
        self._leases: Dict[str, List[_Lease]] = {}
        self._lease_requests_in_flight: Dict[str, int] = {}
        self._task_queues: Dict[str, deque] = {}
        self._inflight_tasks: Dict[TaskID, _PendingTask] = {}
        self._actor_states: Dict[str, ActorHandleState] = {}
        # per-actor FIFO locks ordering seqno assignment (see
        # _async_submit_actor_task)
        self._actor_submit_locks: Dict[str, asyncio.Lock] = {}
        self._actor_events: Dict[str, asyncio.Event] = {}
        self._pub_handlers: Dict[str, List[Callable]] = {}
        # every channel this process subscribed on the controller: the
        # controller's subscriber sets are soft state, so a reconnect to
        # a (possibly restarted) controller re-issues the whole set —
        # actor-death/node-death fan-out must survive a controller kill
        self._subscribed_channels: set = set()
        # (node_id_hex, supervisor_addr) callbacks run on node-death
        # fan-out BEFORE lease requeue — e.g. the collective transport
        # poisons ring waits on peers of the dead node
        self.node_death_hooks: List[Callable] = []
        self._task_events: deque = deque()
        # lineage: specs of finished tasks whose returns live in node arenas,
        # kept (bounded by lineage_max_bytes) so a lost SHARED object can be
        # reconstructed by re-executing its creating task
        # (≈ ObjectRecoveryManager, object_recovery_manager.h:90 + the
        # lineage accounting in task_manager.h:215)
        self._lineage: "OrderedDict[TaskID, Tuple[TaskSpec, int]]" = OrderedDict()
        self._lineage_bytes = 0
        # streaming generator tasks: task_id -> owner-side stream state
        self._streams: Dict[TaskID, _StreamState] = {}
        # dedupe of retried completion reports (bounded LRU)
        self._seen_reports: "OrderedDict[bytes, bool]" = OrderedDict()

        self.loop = asyncio.new_event_loop()
        self._loop_thread = threading.Thread(
            target=self._run_loop, name="ray_tpu_torch-io", daemon=True
        )
        self.server = RpcServer("127.0.0.1", 0)
        self.server.register_object(self)
        self.clients: Optional[ClientPool] = None
        self.address: Optional[Address] = None
        self._shutdown = False

    # ------------------------------------------------------------- lifecycle

    def _run_loop(self):
        asyncio.set_event_loop(self.loop)
        self.loop.run_forever()

    def start(self) -> None:
        self._loop_thread.start()
        self.address = self._run(self._async_start())

    async def _async_start(self) -> Address:
        self.clients = ClientPool(
            self.config.rpc_connect_timeout_s,
            self.config.rpc_request_timeout_s,
            retry_base_s=self.config.rpc_retry_interval_ms / 1000.0,
        )
        addr = await self.server.start()
        self.address = addr
        if self.supervisor_addr is not None:
            info = await self.clients.get(self.supervisor_addr).call("node_info")
            self.node_id_hex = info["node_id_hex"]
            self.arena = ArenaFile(info["arena_path"], info["arena_size"])
        # a re-established controller connection may be a RESTARTED
        # controller whose subscriber sets are empty: re-subscribe
        # event-driven (no polling; a mere TCP blip re-adds set entries)
        self.clients.get(self.controller_addr).add_reconnect_hook(
            self._resubscribe_channels)
        # node-death fan-out: a killed supervisor cannot send worker_failed
        # for its workers, so owners learn about lost leases from the
        # controller's "nodes" channel instead (see _on_node_dead)
        try:
            await self._subscribe_channel("nodes")
        except Exception:
            logger.debug("nodes-channel subscribe failed", exc_info=True)
        return addr

    async def _controller_call(self, method: str, body=None,
                               timeout: Optional[float] = None):
        """Controller round trip that rides out a kill + restart window.

        Task-critical paths (actor-alive refresh, PG readiness polls)
        used to issue bare calls: a controller outage surfaced as a
        connection error that FAILED the task, even though the data
        plane and the actor were healthy. retry_call shares one
        (client_id, msg_id) across attempts, so this is exactly-once
        safe for every handler class."""
        return await retry_call(
            self.clients.get(self.controller_addr), method, body,
            timeout=(timeout if timeout is not None
                     else self.config.controller_reconnect_budget_s),
            per_call_timeout=5,
            base_interval_s=self.config.rpc_retry_interval_ms / 1000.0,
        )

    async def _subscribe_channel(self, channel: str) -> None:
        self._subscribed_channels.add(channel)
        # reconnect-budgeted (subscribe is @idempotent): an actor
        # creation whose register ack just straddled a controller kill
        # must not fail on the follow-up channel subscribe
        await self._controller_call(
            "subscribe", {"channel": channel, "address": self.address})

    async def _resubscribe_channels(self) -> None:
        """RpcClient reconnect hook: re-arm every subscription on the
        (possibly restarted) controller so pubsub fan-out — actor death,
        node death, worker logs — keeps reaching this process after a
        controller kill + restart. "nodes" goes FIRST (node-death
        fan-out is the subscription whose loss strands owners) and the
        rest re-arm concurrently, so a process with many live actor
        channels does not serialize the critical one behind them."""
        async def one(channel: str) -> None:
            try:
                await self.clients.get(self.controller_addr).call(
                    "subscribe",
                    {"channel": channel, "address": self.address},
                    timeout=10)
            except Exception:
                logger.debug("re-subscribe of %r failed", channel,
                             exc_info=True)

        channels = list(self._subscribed_channels)
        if "nodes" in channels:
            channels.remove("nodes")
            await one("nodes")
        if channels:
            await asyncio.gather(*(one(c) for c in channels))

    def shutdown(self) -> None:
        if self._shutdown:
            return
        self._shutdown = True
        try:
            self._run(self._async_shutdown(), timeout=5)
        except Exception:
            pass
        self.loop.call_soon_threadsafe(self.loop.stop)
        self._loop_thread.join(timeout=2)

    async def _async_shutdown(self):
        try:
            # leave the nodes channel so dead processes don't pile up as
            # publish targets (pruning is best-effort and costs a timeout)
            await asyncio.wait_for(
                self.clients.get(self.controller_addr).notify(
                    "unsubscribe",
                    {"channel": "nodes", "address": self.address}),
                timeout=1.0)
        except Exception:
            pass
        if self.supervisor_addr is not None:
            # hand back every pin this client still holds (live zero-copy
            # views die with the process; queued unpins were dropped when
            # _shutdown flipped) — without this, a driver leaving a
            # long-lived cluster would strand its pins until the
            # supervisor restarts. Let an in-flight unpin batch land
            # first so the wholesale release never races it into
            # double-unpin errors.
            deadline = time.monotonic() + 1.0
            while self._unpin_flushing and time.monotonic() < deadline:
                await asyncio.sleep(0.01)
            try:
                await self.clients.get(self.supervisor_addr).call(
                    "store_release_client",
                    {"client": self._store_client_id}, timeout=2)
            except Exception:
                pass
        for shape, leases in self._leases.items():
            for lease in leases:
                try:
                    await self.clients.get(lease.supervisor_addr).call(
                        "release_lease", {"lease_id": lease.lease_id}, timeout=2
                    )
                except Exception:
                    pass
        if self.clients:
            await self.clients.close_all()
        await self.server.stop()
        if self.arena is not None:
            self.arena.close()
        # drain stragglers (lease-linger timers, client read loops,
        # liveness bonds): loop.stop() on a loop with pending tasks spews
        # "Task was destroyed but it is pending!" — the lifecycle
        # sloppiness that shows in the log
        current = asyncio.current_task()
        pending = [t for t in asyncio.all_tasks() if t is not current]
        for t in pending:
            t.cancel()
        if pending:
            await asyncio.gather(*pending, return_exceptions=True)

    def _run(self, coro, timeout: Optional[float] = None):
        """Run a coroutine on the IO loop from any user thread."""
        fut = asyncio.run_coroutine_threadsafe(coro, self.loop)
        return fut.result(timeout)

    def _run_nowait(self, coro) -> None:
        """Fire a coroutine onto the IO loop WITHOUT blocking the caller.

        Submission latency is the core throughput ceiling: a blocking
        round trip per `.remote()` costs two thread hops (~8ms measured)
        and serializes bursts. Ordering stays safe: any later `get`/`wait`
        on the returned refs also enters the loop via
        run_coroutine_threadsafe, whose ready-queue is FIFO, so the
        submission coroutine runs first."""
        fut = asyncio.run_coroutine_threadsafe(coro, self.loop)

        def _surface(f):
            try:
                exc = f.exception()
            except asyncio.CancelledError:
                return
            if exc is not None:
                logger.error("async submission failed: %r", exc)

        fut.add_done_callback(_surface)

    # ------------------------------------------------------------- functions

    def _register_function(self, key: str, blob: bytes) -> None:
        if key in self._fn_registered:
            return
        # reconnect-budgeted: a first-submission racing a controller
        # restart must not fail the task over the function-table write
        self._run(
            self._controller_call(
                "kv_put",
                {"ns": "fn", "key": key, "value": blob, "overwrite": False}
            )
        )
        self._fn_registered.add(key)

    def get_function(self, key: str):
        """Fetch + cache a function/class blob from the controller fn table."""
        fn = self._fn_cache.get(key)
        if fn is None:
            blob = self._run(
                self._controller_call("kv_get", {"ns": "fn", "key": key})
            )
            if blob is None:
                raise KeyError(f"function {key} not in function table")
            fn = serialization.loads(blob)
            self._fn_cache[key] = fn
        return fn

    # ------------------------------------------------------------- submission

    def build_args(self, args: Sequence[Any], kwargs: Dict[str, Any]) -> List[TaskArg]:
        """Top-level ObjectRefs become REF args (resolved by the executor);
        everything else packs into one VALUE payload."""
        from ray_tpu_torch._private.api import ObjectRef

        out: List[TaskArg] = []
        plain_args: List[Any] = []
        for a in args:
            if isinstance(a, ObjectRef):
                out.append(
                    TaskArg(ArgKind.REF, object_id=a._object_id, owner=a._owner_addr)
                )
                plain_args.append(_RefPlaceholder(len(out) - 1))
            else:
                plain_args.append(a)
        out.insert(
            0, TaskArg(ArgKind.VALUE, value=serialization.pack((plain_args, kwargs)))
        )
        return out

    def submit_task(
        self,
        function: Any,
        args: Sequence[Any],
        kwargs: Dict[str, Any],
        *,
        name: str,
        num_returns: int = 1,
        resources: Optional[Dict[str, float]] = None,
        strategy: Optional[SchedulingStrategy] = None,
        max_retries: int = -1,
        retry_exceptions: bool = False,
        runtime_env: Optional[Dict[str, Any]] = None,
        function_key: Optional[str] = None,
        function_blob: Optional[bytes] = None,
        backpressure: int = 0,
    ):
        """Returns the task's return ObjectIDs — or, for a streaming task
        (num_returns=-1), its TaskID (the handle the ObjectRefGenerator
        consumes the stream through)."""
        if function_key is None:
            function_blob = serialization.dumps(function)
            function_key = hashlib.sha256(function_blob).hexdigest()
        if function_blob is not None:
            self._register_function(function_key, function_blob)
        spec = TaskSpec(
            task_id=TaskID.from_random(),
            job_id=self.job_id,
            kind=TaskKind.NORMAL,
            name=name,
            function_key=function_key,
            args=self.build_args(args, kwargs),
            num_returns=num_returns,
            resources=None if resources is None else dict(resources),
            strategy=strategy or SchedulingStrategy(),
            max_retries=self.config.task_max_retries if max_retries < 0 else max_retries,
            retry_exceptions=retry_exceptions,
            owner=self.address,
            runtime_env=runtime_env,
            backpressure=backpressure,
        )
        from ray_tpu_torch.util import tracing

        spec.trace_ctx = tracing.context_for_submission()
        if spec.is_streaming:
            self._streams[spec.task_id] = _StreamState()
        return_ids = spec.return_ids()
        self._run_nowait(self._guarded_submit(
            spec, self._async_submit(spec), (tuple(args), kwargs)))
        return spec.task_id if spec.is_streaming else return_ids

    async def _guarded_submit(self, spec: TaskSpec, coro,
                              arg_holders=None) -> None:
        """Submission runs detached from the caller (`_run_nowait`), so a
        failure must fail the task's return refs — the caller already holds
        them, and a swallowed exception would turn get() into a hang.

        `arg_holders` keeps the caller's ObjectRef arguments alive until
        the submission coroutine has pinned them (`_pin_arg_refs` runs
        before its first await): without it, a caller that drops its last
        reference right after `.remote()` races the deferred pin and the
        owner frees the object first ("owner does not know this object")."""
        try:
            await coro
        except Exception as e:  # noqa: BLE001 — surfaces via the refs
            logger.error("submission of %s failed: %r", spec.name, e)
            for oid in spec.return_ids():
                self._ensure_entry(oid)
            self._fail_task(spec, RuntimeError(
                f"task submission failed: {e!r}"))
            self._inflight_tasks.pop(spec.task_id, None)
        finally:
            del arg_holders

    async def _async_submit(self, spec: TaskSpec) -> None:
        for oid in spec.return_ids():
            self._ensure_entry(oid)
        self._pin_arg_refs(spec)
        self._record_event(spec, "SUBMITTED")
        pending = _PendingTask(spec, retries_left=spec.max_retries)
        self._inflight_tasks[spec.task_id] = pending
        shape = self._shape_key(spec)
        self._task_queues.setdefault(shape, deque()).append(pending)
        await self._pump_shape(shape, spec)

    def _shape_key(self, spec: TaskSpec) -> str:
        from ray_tpu_torch._private.runtime_env import runtime_env_cache_key

        # the FULL runtime-env identity must partition leases: a cached
        # lease on a plain worker must never serve a task that needs a
        # staged working_dir / venv
        return repr(
            (
                sorted(spec.required_resources().items()),
                spec.strategy,
                runtime_env_cache_key(spec.runtime_env),
            )
        )

    async def _pump_shape(self, shape: str, proto_spec: TaskSpec) -> None:
        """Dispatch queued tasks onto leased workers; request leases as needed."""
        queue = self._task_queues.get(shape)
        if not queue:
            return
        leases = self._leases.setdefault(shape, [])
        cap = max(1, self.config.max_tasks_in_flight_per_worker)
        # Least-loaded dispatch: spread tasks across granted leases; only
        # stack (pipeline) onto a busy lease when no more leases are coming.
        per_lease: Dict[int, Tuple[_Lease, List[_PendingTask]]] = {}
        while queue:
            candidates = [
                l for l in leases if not l.broken and l.in_flight < cap
            ]
            if not candidates:
                break
            lease = min(candidates, key=lambda l: l.in_flight)
            if lease.in_flight >= 1 and self._lease_requests_in_flight.get(shape, 0) > 0:
                break  # prefer waiting for a fresh worker over serializing
            task = queue.popleft()
            lease.in_flight += 1
            task.lease = lease
            per_lease.setdefault(id(lease), (lease, []))[1].append(task)
        for lease, tasks in per_lease.values():
            # one push RPC per lease per pump: bursts of pipelined tasks
            # coalesce into push_task_batch frames exactly like actor
            # calls do (per-frame socket cost dominated the tasks_async
            # microbenchmark the same way it did actor calls)
            asyncio.get_running_loop().create_task(
                self._push_many(tasks, lease))
        # One lease per queued task (for cluster-wide parallelism), bounded;
        # excess tasks ride pipelining slots on granted leases as they free
        # (≈ direct_task_transport lease amortization + per-task leases).
        have = self._lease_requests_in_flight.get(shape, 0)
        want = len(queue) - have
        for _ in range(max(0, min(want, 8 - have))):
            self._lease_requests_in_flight[shape] = (
                self._lease_requests_in_flight.get(shape, 0) + 1
            )
            asyncio.get_running_loop().create_task(
                self._request_lease(shape, proto_spec)
            )

    async def _lease_with_retry(self, spec: TaskSpec) -> dict:
        """request_lease following spillback redirects and re-targeting on
        supervisor connection loss (≈ RequestNewWorkerIfNeeded,
        direct_task_transport.cc:353,513). An ungranted lease is always safe
        to retry on another node — wait out failure detection and re-resolve.
        Returns the grant dict with '_supervisor_addr' set to the granting
        supervisor."""
        target = await self._lease_target(spec)
        hops = 0
        conn_failures = 0
        base = self.config.rpc_retry_interval_ms / 1000.0
        while True:
            try:
                grant = await self.clients.get(target).call(
                    "request_lease",
                    {"spec": serialization.dumps(spec), "hops": hops},
                    timeout=self.config.worker_lease_timeout_s + 3600,
                )
            except RpcConnectionError:
                # each target change restarts the transport-level retry, so
                # back off across failures (exponential + jitter) instead of
                # hammering a churning cluster at a fixed interval
                conn_failures += 1
                if conn_failures > 30:
                    raise
                delay = min(base * (2 ** min(conn_failures - 1, 6)), 5.0)
                await asyncio.sleep(delay * (0.5 + random.random()))
                target = await self._alive_lease_target(spec, exclude=target)
                hops = 0
                continue
            if grant.get("granted"):
                grant["_supervisor_addr"] = target
                return grant
            if grant.get("retry_at"):
                target = tuple(grant["retry_at"])
                hops = grant.get("hops", hops + 1)
                continue
            raise RuntimeError(grant.get("error", "lease rejected"))

    async def _request_lease(self, shape: str, spec: TaskSpec) -> None:
        """Lease a worker for one task of this shape and register it for
        pipelined dispatch."""
        try:
            grant = await self._lease_with_retry(spec)
            lease = _Lease(
                lease_id=grant["lease_id"],
                worker_id_hex=grant["worker_id_hex"],
                worker_addr=tuple(grant["worker_address"]),
                supervisor_addr=grant["_supervisor_addr"],
                shape_key=shape,
            )
            self._leases.setdefault(shape, []).append(lease)
        except Exception as e:
            # fail one queued task of this shape (others will retry leasing)
            queue = self._task_queues.get(shape)
            if queue:
                task = queue.popleft()
                self._fail_task(task.spec, RuntimeError(f"scheduling failed: {e}"))
                self._inflight_tasks.pop(task.spec.task_id, None)
            return
        finally:
            self._lease_requests_in_flight[shape] = max(
                0, self._lease_requests_in_flight.get(shape, 1) - 1
            )
        await self._pump_shape(shape, spec)
        # a lease that arrived after the queue drained must not leak
        if lease.in_flight == 0 and not self._task_queues.get(shape):
            asyncio.get_running_loop().create_task(self._maybe_release(lease))

    async def _alive_lease_target(
        self, spec: TaskSpec, exclude: Optional[Address] = None
    ) -> Address:
        """Re-resolve a lease target after a supervisor connection failure:
        prefer the usual target if the controller still lists it alive,
        else any alive node that isn't the one that just failed."""
        usual = await self._lease_target(spec)
        if isinstance(spec.strategy, PlacementGroupStrategy):
            # Only the node holding the bundle can grant this lease; an
            # arbitrary alive node would reject it terminally. _lease_target
            # already waits out re-placement of the group.
            return usual
        views = await self._controller_call("node_views")
        alive = {tuple(v["address"]) for v in views if v["alive"]}
        if usual in alive and usual != tuple(exclude or ()):
            return usual
        for addr in alive:
            if addr != tuple(exclude or ()):
                return addr
        return usual  # nothing better known; retry the usual target

    async def _lease_target(self, spec: TaskSpec) -> Address:
        if isinstance(spec.strategy, PlacementGroupStrategy):
            # A task on a PENDING group waits for placement rather than
            # failing (reference semantics: tasks queue on the pg and run
            # once bundles reserve). REMOVED is terminal.
            delay = 0.05
            while True:
                pg = await self._controller_call(
                    "pg_get", {"pg_id_hex": spec.strategy.pg_id_hex}
                )
                if pg is None or pg["state"] == "REMOVED":
                    raise RuntimeError("placement group removed")
                if pg["state"] == "CREATED":
                    break
                await asyncio.sleep(delay)
                delay = min(delay * 2, 0.2)
            index = spec.strategy.bundle_index
            if index < 0:
                index = 0
                spec.strategy.bundle_index = 0
            node_hex = pg["assignment"][index]
            views = await self._controller_call("node_views")
            for v in views:
                if v["node_id_hex"] == node_hex:
                    return tuple(v["address"])
            raise RuntimeError("placement group node not found")
        if self.supervisor_addr is not None:
            # the common case: lease node-locally from the owner's own
            # supervisor — the controller is NOT on the per-task path
            # (counter-proven in tests/test_controller_ha.py)
            return self.supervisor_addr
        # supervisor-less driver (client mode): the controller places the
        # first hop from its authoritative node table (its request_lease
        # always answers with a retry_at redirect; the GRANT still
        # happens at that node's supervisor, so leases stay node state)
        return self.controller_addr

    async def _push(self, task: _PendingTask, lease: _Lease) -> None:
        spec = task.spec
        try:
            # push_task acks at enqueue time — execution runs unbounded,
            # but a worker that cannot even ack is wedged, not busy
            await self.clients.get(lease.worker_addr).call(
                "push_task", {"spec": serialization.dumps(spec)},
                timeout=self.config.task_push_timeout_s
            )
            self._record_event(spec, "PUSHED")
        except (RpcConnectionError, RpcTimeoutError, RemoteError) as e:
            await self._on_push_failure(task, lease, e)

    async def _push_many(self, tasks: List[_PendingTask],
                         lease: _Lease) -> None:
        """Push a burst destined for one lease as one push_task_batch
        frame; singletons and batch-delivery failures fall back to the
        per-task path (the executor dedupes by task id, so re-pushing
        after an ambiguous batch failure is safe)."""
        if len(tasks) == 1:
            await self._push(tasks[0], lease)
            return
        try:
            await self.clients.get(lease.worker_addr).call(
                "push_task_batch",
                {"specs": [serialization.dumps(t.spec) for t in tasks]},
                timeout=self.config.task_push_timeout_s)
            for t in tasks:
                self._record_event(t.spec, "PUSHED")
        except (RpcConnectionError, RpcTimeoutError, RemoteError):
            for t in tasks:
                if t.spec.task_id in self._inflight_tasks:
                    await self._push(t, lease)

    async def _on_push_failure(self, task: _PendingTask, lease: _Lease, err) -> None:
        # The lease's worker is suspect: no new task is dispatched to it.
        # While other tasks are in flight on it the lease stays bound at
        # its supervisor, so that if the worker dies the supervisor still
        # tells us (worker_failed) and they are retried; the last of them
        # to report releases it (_release_if_drained). Releasing it here
        # orphaned them: a task pushed on the lease just before another
        # push's reply was lost never reported, and nothing retried it.
        lease.broken = True
        live = (task.spec.task_id in self._inflight_tasks
                and task.lease is lease)
        if live:
            lease.in_flight -= 1
            task.lease = None
        if lease.in_flight <= 0:
            await self._drop_lease(lease)
        if not live:
            # done already, or requeued onto another lease by a death
            # notice that overtook this failure
            return
        # A connection-refused push means the worker is GONE (the transport
        # already exhausted its transparent reconnect): the task never
        # reached an executor, so requeueing is free — it must not burn a
        # task retry (node-death cleanup can lag push failures by a health
        # period, and fast-failing pushes would otherwise drain max_retries
        # against a node everyone but the health checker knows is dead).
        # Redelivery stays safe either way: executors dedupe by task id.
        # Timeouts/handler errors keep burning retries — the push may have
        # landed on a wedged-but-alive worker. Free requeues are BOUNDED so
        # a pathological always-refusing endpoint still terminates (after
        # the cap, connection failures burn retries like everything else),
        # and each one backs off briefly instead of hot-looping the
        # requeue -> re-lease cycle.
        free_requeue = (isinstance(err, RpcConnectionError)
                        and task.free_requeues < 20)
        if free_requeue or task.retries_left != 0:
            if free_requeue:
                task.free_requeues += 1
                await asyncio.sleep(
                    min(0.02 * task.free_requeues, 0.5))
            else:
                task.retries_left -= 1
            shape = self._shape_key(task.spec)
            self._task_queues.setdefault(shape, deque()).append(task)
            await self._pump_shape(shape, task.spec)
        else:
            self._fail_task(task.spec, WorkerCrashedError(str(err)))
            self._inflight_tasks.pop(task.spec.task_id, None)

    async def _drop_lease(self, lease: _Lease) -> None:
        leases = self._leases.get(lease.shape_key, [])
        if lease in leases:
            leases.remove(lease)
        try:
            await self.clients.get(lease.supervisor_addr).call(
                "release_lease", {"lease_id": lease.lease_id}, timeout=5
            )
        except Exception:
            pass

    # ------------------------------------------------------------- owner RPCs

    @idempotent  # each report dedupes app-level by report_id
    async def rpc_task_done_batch(self, body) -> None:
        """Coalesced completion reports (executor-side reply batching —
        the mirror of push_task_batch on the submit side). Each report is
        isolated: one malformed body (e.g. an error payload whose class
        only unpickles worker-side) must not strand the other N-1
        callers in get()."""
        for done in body["dones"]:
            try:
                await self.rpc_task_done(done)
            except Exception:
                logger.exception("task_done in batch failed (task %s)",
                                 done.get("task_id", b"").hex()[:12])

    @idempotent  # dedupes app-level by report_id (bounded LRU below)
    async def rpc_task_done(self, body) -> None:
        _trace(f"task_done received {body.get('task_id', b'').hex()[:12]} err={body.get('error') is not None}")
        rid = body.get("report_id")
        if rid is not None:
            # executor-side reply batching retries ambiguous deliveries;
            # a report that already landed (reply lost) must be a no-op —
            # reprocessing a retryable error would double-requeue the task
            if rid in self._seen_reports:
                return
            self._seen_reports[rid] = True
            while len(self._seen_reports) > 10_000:
                self._seen_reports.popitem(last=False)
        """Executor reports task completion to the owner
        (return values inline if small, else arena locations)."""
        task_id = TaskID(body["task_id"])
        task = self._inflight_tasks.get(task_id)
        spec = task.spec if task else None
        if body.get("error") is not None:
            err = serialization.loads(body["error"])
            retryable = body.get("retryable", False)
            if (
                task is not None
                and retryable
                and task.retries_left != 0
            ):
                task.retries_left -= 1
                await self._requeue(task)
                return
            if spec is not None:
                self._fail_task(spec, err)
        else:
            any_shared = False
            for oid_raw, kind, payload in body["results"]:
                oid = ObjectID(oid_raw)
                entry = self._ensure_entry(oid)
                if kind == "inline":
                    self.in_process.put(oid, payload)
                    entry.state = INLINE
                    entry.size = len(payload)
                elif kind == "device":
                    # CUDA tensor return: it stays with the executor
                    # worker; only layout metadata lands here. Lossable
                    # like SHARED, so lineage applies.
                    entry.state = DEVICE
                    entry.size = payload["size"]
                    entry.location = tuple(payload["worker_addr"])
                    entry.device_meta = payload["meta"]
                    any_shared = True
                else:  # shared
                    entry.state = SHARED
                    entry.size = payload["size"]
                    entry.location = tuple(payload["node_addr"])
                    any_shared = True
                self._wake(entry)
            if "stream_count" in body:
                # streaming task exhausted: seal the stream at this count
                stream = self._streams.get(task_id)
                if stream is not None:
                    stream.total = body["stream_count"]
                    stream.finished = True
                    stream.event.set()
                    if stream.consumed >= (1 << 31):
                        # reconstruction replay (no live consumer): done
                        self._drop_sentinel_stream(task_id)
                any_shared = any_shared or body.get("stream_any_shared", False)
            if spec is not None:
                self._record_event(spec, "FINISHED", body.get("worker_pid"),
                                   body.get("run_start"))
                if any_shared:
                    self._record_lineage(spec)
        if task is not None:
            self._inflight_tasks.pop(task_id, None)
            self._unpin_arg_refs(spec)
            lease = task.lease
            if lease is not None:
                lease.in_flight -= 1
                await self._pump_shape(lease.shape_key, spec)
                self._release_if_drained(lease)

    # ----------------------------------------------------------- streaming

    @idempotent  # replayed indices refresh the same entry in place
    async def rpc_stream_item(self, body) -> dict:
        """Executor reports one yielded item of a streaming generator task
        (≈ ReportGeneratorItemReturns, core_worker.cc:3260). The item
        becomes an owned object immediately — ownership rests with the
        caller from the moment of the report, which is the worker→owner
        transfer the reference does for dynamically created returns.
        Returns the consumption watermark (executor-side backpressure)."""
        task_id = TaskID(body["task_id"])
        stream = self._streams.get(task_id)
        if stream is None:
            # consumer released the stream (lineage reconstruction always
            # recreates state first, so None really means released): do
            # NOT store the item — nothing would ever free it
            return {"consumed": 0, "stop": True}
        if stream.finished and stream.error is not None:
            return {"consumed": stream.consumed, "stop": True}
        index = body["index"]
        oid = ObjectID(body["object_id"])
        entry = self._ensure_entry(oid)
        if body["kind"] == "inline":
            self.in_process.put(oid, body["payload"])
            entry.state = INLINE
            entry.size = len(body["payload"])
        else:
            entry.state = SHARED
            entry.size = body["payload"]["size"]
            entry.location = tuple(body["payload"]["node_addr"])
        self._wake(entry)
        if index == len(stream.items):
            stream.items.append(oid)
        elif index > len(stream.items):
            # executor reports strictly in order; a gap means a protocol
            # bug — fail loudly rather than hand out wrong items, and
            # stop the producer
            stream.error = RuntimeError(
                f"stream item gap: got index {index}, "
                f"have {len(stream.items)}")
            stream.finished = True
            stream.event.set()
            return {"consumed": stream.consumed, "stop": True}
        # index < len(items): re-execution replay after a worker death —
        # same deterministic id, entry refreshed above
        stream.event.set()
        return {"consumed": stream.consumed, "stop": False}

    @idempotent
    async def rpc_stream_state(self, body) -> dict:
        """Backpressure wait: block (bounded) until the consumer has
        advanced to `wait_for` items, so a paused producer holds ONE
        long-poll RPC instead of hammering the owner's IO loop."""
        stream = self._streams.get(TaskID(body["task_id"]))
        if stream is None:
            return {"consumed": 0, "stop": True}
        wait_for = body.get("wait_for", 0)
        deadline = time.monotonic() + min(
            float(body.get("timeout", 5.0)), 30.0)
        while (stream.consumed < wait_for
               and time.monotonic() < deadline):
            stream.consumed_event.clear()
            try:
                await asyncio.wait_for(
                    stream.consumed_event.wait(),
                    max(0.0, deadline - time.monotonic()))
            except asyncio.TimeoutError:
                break
            if self._streams.get(TaskID(body["task_id"])) is not stream:
                return {"consumed": stream.consumed, "stop": True}
        return {"consumed": stream.consumed, "stop": False}

    async def _async_stream_next(self, task_id: TaskID, index: int,
                                 deadline: Optional[float]):
        # _StreamEnd (not StopIteration): PEP 479 turns a StopIteration
        # escaping a coroutine into RuntimeError
        stream = self._streams.get(task_id)
        if stream is None:
            raise _StreamEnd  # released
        while True:
            if index < len(stream.items):
                if index + 1 > stream.consumed:
                    stream.consumed = index + 1
                    stream.consumed_event.set()  # wake backpressure waiters
                return stream.items[index]
            if stream.error is not None:
                raise stream.error
            if stream.total is not None and index >= stream.total:
                raise _StreamEnd
            stream.event.clear()
            timeout = None
            if deadline is not None:
                timeout = deadline - time.monotonic()
                if timeout <= 0:
                    raise TimeoutError(
                        f"stream item {index} not ready in time")
            try:
                await asyncio.wait_for(stream.event.wait(), timeout)
            except asyncio.TimeoutError:
                raise TimeoutError(
                    f"stream item {index} not ready in time") from None

    def stream_next(self, task_id: TaskID, index: int,
                    timeout: Optional[float] = None) -> ObjectID:
        """Blocking fetch of the index-th item's ObjectID; raises
        StopIteration at end-of-stream, the task's error after its last
        yielded item, or TimeoutError."""
        deadline = None if timeout is None else time.monotonic() + timeout
        try:
            return self._run(
                self._async_stream_next(task_id, index, deadline))
        except _StreamEnd:
            raise StopIteration from None

    def stream_released(self, task_id: TaskID) -> None:
        """Consumer dropped the generator: free unconsumed items and the
        stream state (ref accounting: consumed items live on through the
        ObjectRefs handed to the user; unconsumed ones die here)."""
        self._run_nowait(self._async_stream_release(task_id))

    async def _async_stream_release(self, task_id: TaskID) -> None:
        stream = self._streams.pop(task_id, None)
        if stream is None:
            return
        stream.consumed_event.set()  # unblock any backpressure long-poll
        for oid in stream.items[stream.consumed:]:
            entry = self.objects.get(oid)
            if entry is not None:
                self._maybe_free(entry)

    def _drop_sentinel_stream(self, task_id: TaskID) -> None:
        """Tear down a reconstruction-replay stream (consumed=1<<31
        sentinel, no live consumer). Every replayed item was re-stored by
        rpc_stream_item as an owned entry; sweep them through refcounted
        _maybe_free so ref-less replicas are released while the object
        that triggered the reconstruction (held by a waiter/borrower)
        survives — otherwise each reconstruction leaks the rest of the
        stream's items."""
        stream = self._streams.pop(task_id, None)
        if stream is None:
            return
        for oid in stream.items:
            entry = self.objects.get(oid)
            if entry is not None:
                self._maybe_free(entry)

    # ------------------------------------------------------------- lineage

    def _record_lineage(self, spec: TaskSpec) -> None:
        """Retain the spec of a finished task with SHARED returns so the
        returns can be reconstructed if their node dies. Only stateless
        NORMAL tasks are re-executable (actor tasks escalate to actor
        restart / checkpoint restore), and max_retries=0 is the user's
        opt-out: a task with side effects must never silently re-run."""
        if (
            spec.kind != TaskKind.NORMAL
            or spec.max_retries == 0
            or self.config.lineage_max_bytes <= 0
        ):
            return
        size = 256 + sum(
            len(a.value) if a.value is not None else 64 for a in spec.args
        )
        prev = self._lineage.pop(spec.task_id, None)
        if prev is not None:
            self._lineage_bytes -= prev[1]
        else:
            # hold this spec's by-reference args while it sits in lineage:
            # reconstruction re-executes the task, which needs them resolvable
            self._pin_arg_refs(spec)
        self._lineage[spec.task_id] = (spec, size)
        self._lineage_bytes += size
        while self._lineage_bytes > self.config.lineage_max_bytes and len(self._lineage) > 1:
            _, (evicted, sz) = self._lineage.popitem(last=False)
            self._lineage_bytes -= sz
            self._unpin_arg_refs(evicted)

    def _try_reconstruct(self, oid: ObjectID) -> bool:
        """Owner-side object recovery: re-execute the creating task of a
        lost SHARED object (≈ ObjectRecoveryManager::RecoverObject). Returns
        False when the lineage was never recorded, evicted past
        lineage_max_bytes, or the object was a put (not reconstructable)."""
        if oid.is_put():
            return False
        task_id = oid.task_id()
        if task_id in self._inflight_tasks:
            return True  # reconstruction already running
        rec = self._lineage.get(task_id)
        if rec is None:
            return False
        spec, _ = rec
        _trace(f"reconstruct {spec.name} for {oid.hex()[:12]}")
        reset_ids = spec.return_ids()
        if spec.is_streaming:
            # the lost item is the one to resurrect; recreate stream state
            # (consumer may have released it) with an unbounded consumed
            # watermark so the replay is never backpressured or stopped
            reset_ids = [oid]
            if spec.task_id not in self._streams:
                stream = _StreamState()
                stream.consumed = 1 << 31
                self._streams[spec.task_id] = stream
        for rid in reset_ids:
            entry = self._ensure_entry(rid)
            entry.state = PENDING
            entry.error = None
            if entry.event is not None:
                entry.event.clear()
        self._pin_arg_refs(spec)
        self._record_event(spec, "RECONSTRUCTING")
        pending = _PendingTask(spec, retries_left=max(1, spec.max_retries))
        self._inflight_tasks[spec.task_id] = pending
        shape = self._shape_key(spec)
        self._task_queues.setdefault(shape, deque()).append(pending)
        asyncio.get_running_loop().create_task(self._pump_shape(shape, spec))
        return True

    @idempotent  # _try_reconstruct no-ops while a reconstruction runs
    async def rpc_object_lost(self, body) -> bool:
        """A borrower failed to read one of our SHARED objects (its node is
        gone). Kick off reconstruction; the borrower keeps polling
        get_object and sees PENDING until the re-execution lands."""
        return self._try_reconstruct(ObjectID(body["object_id"]))

    def _release_if_drained(self, lease: _Lease) -> None:
        """Release a lease with no task in flight once nothing is queued
        for its shape (after a linger for reuse), and a broken one at
        once: nothing is dispatched to it again."""
        if lease.in_flight != 0:
            return
        if lease.broken:
            if lease in self._leases.get(lease.shape_key, ()):
                asyncio.get_running_loop().create_task(
                    self._drop_lease(lease))
        elif not self._task_queues.get(lease.shape_key):
            asyncio.get_running_loop().create_task(
                self._maybe_release(lease))

    async def _maybe_release(self, lease: _Lease) -> None:
        await asyncio.sleep(1.0)  # linger for reuse
        if lease.in_flight == 0 and not self._task_queues.get(lease.shape_key):
            await self._drop_lease(lease)

    async def _requeue(self, task: _PendingTask) -> None:
        lease = task.lease
        if lease is not None:
            lease.in_flight -= 1
            if lease.broken:
                self._release_if_drained(lease)
        task.lease = None
        shape = self._shape_key(task.spec)
        self._record_event(task.spec, "RETRY")
        self._task_queues.setdefault(shape, deque()).append(task)
        await self._pump_shape(shape, task.spec)

    async def _fail_lease_tasks(self, lease: "_Lease", reason: str) -> None:
        """A lease's worker is gone: drop the lease and retry (or fail) every
        task in flight on it — shared by supervisor worker_failed
        notifications and controller node-death fan-out."""
        lease.broken = True
        leases = self._leases.get(lease.shape_key, [])
        if lease in leases:
            leases.remove(lease)
        for task in list(self._inflight_tasks.values()):
            if task.lease is lease:
                if task.retries_left != 0:
                    task.retries_left -= 1
                    await self._requeue(task)
                else:
                    self._fail_task(task.spec, WorkerCrashedError(reason))
                    self._inflight_tasks.pop(task.spec.task_id, None)

    @idempotent  # the first execution removes the lease it matches on
    async def rpc_worker_failed(self, body) -> None:
        """Supervisor notifies: a worker leased to us died."""
        dead_hex = body["worker_id_hex"]
        for shape, leases in self._leases.items():
            for lease in list(leases):
                if lease.worker_id_hex == dead_hex:
                    await self._fail_lease_tasks(
                        lease,
                        body.get("reason")
                        or f"worker {dead_hex[:8]} died "
                           f"(exit {body.get('exitcode')})")

    async def _on_node_dead(self, supervisor_addr: Address,
                            node_id_hex: str = "") -> None:
        """Controller declared a node dead: every lease granted by that
        node's supervisor is gone, and its supervisor can no longer send
        worker_failed for them — requeue their in-flight tasks here (the
        gap the double-fault chaos test exposed: tasks running on a killed
        node used to hang their owners forever)."""
        addr = tuple(supervisor_addr)
        # fail-fast fan-out to subsystems blocked on peers of that node
        # (collective ring waits poison instead of burning their timeout)
        for hook in list(self.node_death_hooks):
            try:
                hook(node_id_hex, addr)
            except Exception:
                logger.exception("node-death hook failed")
        for shape, leases in self._leases.items():
            for lease in list(leases):
                if tuple(lease.supervisor_addr) == addr:
                    await self._fail_lease_tasks(
                        lease, f"node {addr} died with tasks in flight")

    @staticmethod
    def _entry_status(entry: Optional[ObjectEntry]) -> str:
        """Single source of truth for the wire status of an owned object
        (used by both get_object and the batched object_states)."""
        if entry is None:
            return "unknown"
        return {PENDING: "pending", FAILED: "error", DEVICE: "device",
                INLINE: "value"}.get(entry.state, "location")

    @idempotent
    async def rpc_get_object(self, body):
        """Remote reader resolves one of our owned objects. With
        ``wait_ms`` the owner parks the request until the object is ready
        (long-poll) instead of making the reader back off-and-repoll —
        the reader sees the value one RPC after it lands, which is the
        latency floor for ref-arg chains (DAG stages, borrowed gets)."""
        oid = ObjectID(body["object_id"])
        entry = self.objects.get(oid)
        wait_ms = body.get("wait_ms", 0)
        if (wait_ms and entry is not None and entry.state == PENDING
                and entry.event is not None):
            deadline = time.monotonic() + wait_ms / 1000.0
            while (entry.state == PENDING
                   and time.monotonic() < deadline):
                entry.event.clear()
                try:
                    await asyncio.wait_for(
                        entry.event.wait(),
                        max(0.001, deadline - time.monotonic()))
                except asyncio.TimeoutError:
                    break
        status = self._entry_status(entry)
        if status == "error":
            return {"status": status,
                    "error": serialization.dumps(entry.error)}
        if status == "value":
            return {"status": status, "value": self.in_process.get(oid)}
        if status == "location":
            return {"status": status, "size": entry.size,
                    "node_addr": entry.location}
        if status == "device":
            meta_blob = entry.device_meta
            if meta_blob is None:
                # holder None -> the data is in THIS process's registry
                meta = self.device_objects.meta(oid)
                if meta is None:
                    # registry entry is gone (freed or racing a drop):
                    # report it as a lost device — distinct from
                    # "unknown" (never owned, terminal) — so the
                    # caller's object_lost/reconstruction loop engages;
                    # the old dumps(None) reply crashed readers on
                    # meta.shards instead
                    return {"status": "device_lost"}
                meta_blob = serialization.dumps(meta)
            return {"status": status,
                    "meta": meta_blob,
                    "holders": entry.holders or [entry.location]}
        return {"status": status}

    @idempotent
    async def rpc_device_read(self, body) -> bytes:
        """One bounded chunk of a device object's shard, staged host-side
        by the owner (device->host conversion cached across chunks)."""
        oid = ObjectID(body["object_id"])
        index_key = tuple(tuple(p) for p in body["index"])
        loop = asyncio.get_running_loop()
        # the device->host staging copy can be many MB: keep it off the
        # event loop
        return await loop.run_in_executor(
            None, self.device_objects.read, oid, index_key,
            body["offset"], body["length"])

    @idempotent  # drop of an absent id is a no-op
    async def rpc_device_free(self, body) -> None:
        """Owner GC reached zero refs for a device return we hold."""
        self.device_objects.drop(ObjectID(body["object_id"]))

    @idempotent
    async def rpc_object_states(self, body) -> List[str]:
        """Batched status probe for wait(): one RPC covers many refs."""
        return [self._entry_status(self.objects.get(ObjectID(raw)))
                for raw in body["object_ids"]]

    @replay_cached  # a duplicated increment would leak the object
    async def rpc_add_borrow(self, body) -> None:
        entry = self.objects.get(ObjectID(body["object_id"]))
        if entry is not None:
            entry.borrows += 1

    @replay_cached  # a duplicated decrement could free a live borrow
    async def rpc_release_borrow(self, body) -> None:
        entry = self.objects.get(ObjectID(body["object_id"]))
        if entry is not None:
            entry.borrows = max(0, entry.borrows - 1)
            self._maybe_free(entry)

    @idempotent  # pubsub is at-least-once; handlers tolerate repeats
    async def rpc_on_publish(self, body) -> None:
        channel = body["channel"]
        message = body["message"]
        if channel.startswith("actor:"):
            self._on_actor_update(channel[len("actor:") :], message)
        elif channel == "nodes" and isinstance(message, dict) \
                and message.get("event") == "DEAD" and message.get("address"):
            await self._on_node_dead(tuple(message["address"]),
                                     message.get("node_id_hex", ""))
        # snapshot: unsubscribe() (e.g. a compiled-graph teardown on a
        # user thread) may mutate the list mid-delivery; list.remove
        # during iteration would silently skip another handler
        for handler in list(self._pub_handlers.get(channel, [])):
            try:
                handler(message)
            except Exception:
                logger.exception("pubsub handler failed for %s", channel)

    @idempotent
    async def rpc_ping(self, body=None) -> str:
        return "pong"

    @idempotent
    async def rpc_flight_dump(self, body=None) -> dict:
        """Out-of-band drain of this process's flight-recorder rings
        (_private/flight.py): the in-band hot-loop spans leave the
        process ONLY through this pull path, never as steady-state RPCs."""
        from ray_tpu_torch._private import flight

        return flight.drain()

    @idempotent
    async def rpc_metrics(self, body=None) -> str:
        """This process's Prometheus exposition — the cluster-wide scrape
        (`util.state.cluster_metrics(all_nodes=True)`) reaches worker and
        driver registries through it."""
        from ray_tpu_torch._private.metrics import default_registry

        return default_registry().render_prometheus()

    def subscribe(self, channel: str, handler: Callable) -> None:
        self._pub_handlers.setdefault(channel, []).append(handler)
        self._run(self._subscribe_channel(channel))

    def unsubscribe(self, channel: str, handler: Callable) -> None:
        """Drop a handler registered via subscribe(). Local-only: the
        controller-side subscription stays (it is one set entry shared
        with this worker's own actor/node tracking, which must keep
        receiving the channel's publishes)."""
        handlers = self._pub_handlers.get(channel, [])
        if handler in handlers:
            handlers.remove(handler)
        if not handlers:
            self._pub_handlers.pop(channel, None)

    # ------------------------------------------------------------- objects

    def _ensure_entry(self, oid: ObjectID) -> ObjectEntry:
        entry = self.objects.get(oid)
        if entry is None:
            entry = ObjectEntry(oid, event=asyncio.Event())
            self.objects[oid] = entry
        return entry

    def _wake(self, entry: ObjectEntry) -> None:
        if entry.event is not None:
            entry.event.set()

    def _fail_task(self, spec: TaskSpec, err: Exception) -> None:
        self._record_event(spec, "FAILED")
        for oid in spec.return_ids():
            entry = self._ensure_entry(oid)
            entry.state = FAILED
            entry.error = err
            self._wake(entry)
        if spec.is_streaming:
            stream = self._streams.get(spec.task_id)
            if stream is not None and stream.consumed >= (1 << 31):
                # failed reconstruction replay: no live consumer exists
                # to release the sentinel state — drop it here or it
                # leaks per failed reconstruction
                self._drop_sentinel_stream(spec.task_id)
            elif stream is not None and not stream.finished:
                # items yielded before the failure stay consumable; the
                # error surfaces after the last of them (reference
                # generator semantics)
                stream.error = err
                stream.finished = True
                stream.event.set()
        self._unpin_arg_refs(spec)

    def _pin_arg_refs(self, spec: TaskSpec) -> None:
        for arg in spec.args:
            if arg.kind == ArgKind.REF:
                entry = self.objects.get(arg.object_id)
                if entry is not None:
                    entry.task_pins += 1

    def _unpin_arg_refs(self, spec: Optional[TaskSpec]) -> None:
        if spec is None:
            return
        for arg in spec.args:
            if arg.kind == ArgKind.REF:
                entry = self.objects.get(arg.object_id)
                if entry is not None:
                    entry.task_pins = max(0, entry.task_pins - 1)
                    self._maybe_free(entry)

    def put(self, value: Any) -> Tuple[ObjectID, Address]:
        if device_objects.is_sharded(value):
            return self._put_sharded(value)
        oid = ObjectID.from_put()
        if device_objects.is_device_array(value):
            # no host round-trip: a snapshot stays here on the card (the
            # caller may write its tensor in place afterwards); only
            # layout metadata ever crosses the wire (device_objects.py)
            self._run(self._async_store_device(
                oid, device_objects.snapshot(value)))
            return oid, self.address
        meta, buffers, total = serialization.packed_size(value)
        if (total <= self.config.max_direct_call_object_size
                or self.supervisor_addr is None or self.arena is None):
            entry = self._run(self._async_store_owned(
                oid, serialization.pack_parts(meta, buffers)))
        else:
            # arena path: write the parts piecewise straight into the
            # mmap — one memcpy per payload buffer instead of join+copy
            # (halves host traffic for GiB-class numpy/torch payloads)
            entry = self._run(
                self._async_store_parts(oid, meta, buffers, total))
        return oid, self.address

    async def arena_write_parts(self, oid: ObjectID, meta: bytes,
                                buffers, total: int) -> None:
        """THE create->write->seal sequence for serialized parts (shared
        by owner-side put and executor-side returns): 600s RPC budgets
        because a GiB-class create can queue behind another object's
        spill on the store thread, and the (possibly multi-GB) memcpy
        runs on an executor so it never stalls the event loop."""
        sup = self.clients.get(self.supervisor_addr)
        r = await sup.call("store_create",
                           {"object_id": oid.binary(), "size": total},
                           timeout=600)
        await asyncio.get_running_loop().run_in_executor(
            None, serialization.write_packed,
            self.arena.view(r["offset"], total), meta, buffers)
        await sup.call("store_seal", {"object_id": oid.binary()},
                       timeout=600)
        _m_put_bytes.inc(total, labels={"path": "arena"})

    async def _async_store_parts(self, oid: ObjectID, meta: bytes,
                                 buffers, total: int) -> ObjectEntry:
        entry = self._ensure_entry(oid)
        await self.arena_write_parts(oid, meta, buffers, total)
        entry.state = SHARED
        entry.size = total
        entry.location = self.supervisor_addr
        self._wake(entry)
        return entry

    async def _async_store_device(self, oid: ObjectID, arr: Any) -> None:
        entry = self._ensure_entry(oid)
        meta = self.device_objects.put(oid, arr)
        entry.state = DEVICE
        entry.size = meta.nbytes
        self._wake(entry)

    def _put_sharded(self, dt) -> Tuple[ObjectID, Address]:
        """A collective put of a DTensor: every rank of its mesh calls it.
        The coordinate-0 rank owns the object and makes its id, which it
        broadcasts over the mesh's group; each rank parks a snapshot of its
        own local shard in its own registry under that id, then one
        all_gather_object tells every rank each rank's worker address (so
        no rank returns before every shard is in place). Each rank returns
        a ref to the same object; the owner counts the other ranks as
        borrowers from the start, and each of their refs releases one."""
        import torch.distributed as dist

        mesh = dt.device_mesh
        ranks = [int(r) for r in mesh.mesh.flatten().tolist()]
        group = device_objects.mesh_group(mesh)
        me = dist.get_rank()
        owner_rank = ranks[0]
        snap = device_objects.snapshot(dt)
        box = [None]
        if me == owner_rank:
            oid = ObjectID.from_put()
            box = [oid.binary()]
            self._run(self._async_begin_sharded(oid, len(ranks) - 1))
        if len(ranks) > 1:
            dist.broadcast_object_list(box, src=owner_rank, group=group)
        oid = ObjectID(box[0])
        self.device_objects.put(oid, snap)
        gathered = [None] * len(ranks)
        if len(ranks) > 1:
            dist.all_gather_object(gathered, (me, tuple(self.address)),
                                   group=group)
        else:
            gathered = [(me, tuple(self.address))]
        by_rank = dict(gathered)
        holders = [by_rank[r] for r in ranks]
        if me == owner_rank:
            self._run(self._async_seal_sharded(
                oid, device_objects.extract_meta(dt), holders))
        return oid, holders[0]

    async def _async_begin_sharded(self, oid: ObjectID, borrowers: int):
        entry = self._ensure_entry(oid)
        entry.borrows += borrowers

    async def _async_seal_sharded(self, oid: ObjectID, meta,
                                  holders: List[Address]) -> None:
        entry = self._ensure_entry(oid)
        entry.state = DEVICE
        entry.size = meta.nbytes
        entry.device_meta = serialization.dumps(meta)
        entry.holders = holders
        self._wake(entry)

    async def _async_store_owned(self, oid: ObjectID, packed: bytes) -> ObjectEntry:
        entry = self._ensure_entry(oid)
        if len(packed) <= self.config.max_direct_call_object_size or (
            self.supervisor_addr is None
        ):
            self.in_process.put(oid, packed)
            entry.state = INLINE
            entry.size = len(packed)
            _m_put_bytes.inc(len(packed), labels={"path": "inline"})
        else:
            sup = self.clients.get(self.supervisor_addr)
            # 600s: creating a GiB-class object can sit behind another
            # object's multi-GB spill on the store thread
            r = await sup.call("store_create",
                               {"object_id": oid.binary(),
                                "size": len(packed)}, timeout=600)
            loop = asyncio.get_running_loop()
            # multi-GB memcpy into the arena: keep it off the event loop
            await loop.run_in_executor(
                None, self.arena.write, r["offset"], packed)
            await sup.call("store_seal", {"object_id": oid.binary()},
                           timeout=600)
            _m_put_bytes.inc(len(packed), labels={"path": "arena"})
            entry.state = SHARED
            entry.size = len(packed)
            entry.location = self.supervisor_addr
        self._wake(entry)
        return entry

    def get(self, refs: Sequence["ObjectRefLike"], timeout: Optional[float] = None) -> List[Any]:
        return self._run(
            self._async_get_many(refs, timeout),
            timeout=None if timeout is None else timeout + 10,
        )

    async def _async_get_many(self, refs, timeout) -> List[Any]:
        deadline = None if timeout is None else time.monotonic() + timeout
        return list(
            await asyncio.gather(
                *(self._async_get_one(r._object_id, r._owner_addr, deadline) for r in refs)
            )
        )

    async def _async_get_one(self, oid: ObjectID, owner: Address, deadline) -> Any:
        if tuple(owner) == tuple(self.address):
            return await self._get_owned(oid, deadline)
        local = self.device_objects.get(oid)
        if local is not None:
            # a holder's own get (a rank of a sharded put, or the worker
            # that returned the tensor): a private copy of what it holds,
            # no host traffic and no collective
            return device_objects.snapshot(local)
        return await self._get_remote(oid, owner, deadline)

    async def _get_owned(self, oid: ObjectID, deadline) -> Any:
        entry = self._ensure_entry(oid)
        lost_attempts = 0
        while True:
            while entry.state == PENDING:
                entry.event.clear()
                try:
                    await asyncio.wait_for(
                        entry.event.wait(),
                        None if deadline is None else max(0.01, deadline - time.monotonic()),
                    )
                except asyncio.TimeoutError:
                    raise GetTimeoutError(f"get timed out for {oid.hex()[:16]}")
            if entry.state == FAILED:
                raise entry.error
            if entry.state == INLINE:
                return serialization.unpack(self.in_process.get(oid))
            if entry.state == DEVICE:
                local = self.device_objects.get(oid)
                if local is not None:
                    # owner side: a private copy on the card, so a write
                    # to the result leaves the object intact
                    return device_objects.snapshot(local)
            try:
                if entry.state == DEVICE:
                    # task-return device object: the tensor lives with the
                    # executor worker; stream it from there
                    return await self._fetch_device(
                        oid, entry.holders or [entry.location],
                        serialization.loads(entry.device_meta))
                return await self._read_shared(oid, entry.size, entry.location)
            except (ObjectLostError, RpcConnectionError, RpcTimeoutError, RemoteError) as e:
                # The node holding the data is gone: reconstruct by
                # re-executing the creating task from lineage, then loop
                # (entry is PENDING again until the re-execution lands).
                lost_attempts += 1
                if lost_attempts > 3 or not self._try_reconstruct(oid):
                    raise ObjectLostError(
                        oid.hex(),
                        f"object lost and not reconstructable "
                        f"(lineage evicted, a put, or {lost_attempts} failed "
                        f"reconstruction attempts): {e}",
                    ) from e

    async def _get_remote(self, oid: ObjectID, owner: Address, deadline) -> Any:
        delay = 0.005  # only for transient-retry paths; readiness rides
        lost_attempts = 0  # the owner-side long-poll, not a backoff loop
        while True:
            # clamp the long-poll to the caller's remaining deadline: a
            # get(timeout=0.05) must not sit parked at the owner for a
            # full second before noticing it timed out
            wait_ms = 1000
            if deadline is not None:
                wait_ms = max(1, min(1000, int(
                    (deadline - time.monotonic()) * 1000)))
            try:
                r = await self.clients.get(owner).call(
                    "get_object", {"object_id": oid.binary(),
                                   "wait_ms": wait_ms}
                )
            except RpcConnectionError:
                raise ObjectLostError(oid.hex(), "owner process is gone")
            status = r["status"]
            if status == "value":
                return serialization.unpack(r["value"])
            if status == "device":
                holders = [tuple(h) if h else tuple(owner)
                           for h in r["holders"]]
                try:
                    return await self._fetch_device(
                        oid, holders, serialization.loads(r["meta"]))
                except ObjectLostError as e:
                    # holder worker died: ask the owner to reconstruct
                    # from lineage, then keep polling (same stance as
                    # the SHARED location branch below)
                    lost_attempts += 1
                    if lost_attempts > 3:
                        raise
                    try:
                        recoverable = await self.clients.get(owner).call(
                            "object_lost", {"object_id": oid.binary()})
                    except Exception:
                        await asyncio.sleep(0.1)
                        continue
                    if not recoverable:
                        raise ObjectLostError(
                            oid.hex(),
                            f"device object lost, not reconstructable: {e}"
                        ) from e
                    await asyncio.sleep(0.05)
                    continue
            if status == "location":
                try:
                    return await self._read_shared(oid, r["size"], tuple(r["node_addr"]))
                except (ObjectLostError, RpcConnectionError, RpcTimeoutError, RemoteError) as e:
                    # data node died: ask the owner to reconstruct, then keep
                    # polling (owner reports PENDING while re-executing)
                    lost_attempts += 1
                    if lost_attempts > 3:
                        raise ObjectLostError(
                            oid.hex(), f"object lost; reconstruction failed: {e}"
                        ) from e
                    try:
                        recoverable = await self.clients.get(owner).call(
                            "object_lost", {"object_id": oid.binary()}
                        )
                    except Exception:
                        # transient owner hiccup must not fail closed — the
                        # owner may well be able to reconstruct; retry
                        await asyncio.sleep(0.1)
                        continue
                    if not recoverable:
                        raise ObjectLostError(
                            oid.hex(), f"object lost and not reconstructable: {e}"
                        ) from e
                    await asyncio.sleep(0.05)
                    continue
            if status == "error":
                raise serialization.loads(r["error"])
            if status == "device_lost":
                # the owner's device registry entry vanished (freed or
                # racing a drop): same stance as a dead holder — ask the
                # owner to reconstruct from lineage, then keep polling
                lost_attempts += 1
                if lost_attempts > 3:
                    raise ObjectLostError(
                        oid.hex(), "device object registry entry lost; "
                        "reconstruction failed")
                try:
                    recoverable = await self.clients.get(owner).call(
                        "object_lost", {"object_id": oid.binary()})
                except Exception:
                    await asyncio.sleep(0.1)
                    continue
                if not recoverable:
                    raise ObjectLostError(
                        oid.hex(),
                        "device object lost and not reconstructable")
                await asyncio.sleep(0.05)
                continue
            if status == "unknown":
                raise ObjectLostError(oid.hex(), "owner does not know this object")
            if deadline is not None and time.monotonic() > deadline:
                raise GetTimeoutError(f"get timed out for {oid.hex()[:16]}")
            # still pending: the long-poll round expired — go straight
            # back in (no extra client-side backoff on top of it)
            await asyncio.sleep(delay)

    async def _fetch_device(self, oid: ObjectID, holders: List[Address],
                            meta) -> Any:
        """Materialize a remote device object locally: stream each shard
        this process needs (``device_objects.needed_shards``) from its
        holder (``holders[meta.holder_of(i)]``) as host staging buffers in
        bounded chunks (next chunk prefetched while the current one is
        appended — the wire stays busy), then assemble it, with the
        sender's logical sharding where this process has an equivalent
        mesh (device_objects.assemble). Holder loss surfaces as
        ObjectLostError so the callers' reconstruction loops engage."""
        chunk = self.config.object_transfer_chunk_bytes
        shard_data = {}
        pending = nxt = None
        try:
            for i in device_objects.needed_shards(meta):
                index_key, nbytes = meta.shards[i]
                index_key = tuple(tuple(p) for p in index_key)
                client = self.clients.get(tuple(holders[meta.holder_of(i)]))
                parts = []
                pos = 0
                pending = None
                if nbytes == 0:  # zero-size shard: nothing on the wire
                    shard_data[index_key] = b""
                    continue
                while pos < nbytes or pending is not None:
                    if pending is None:
                        pending = asyncio.ensure_future(client.call(
                            "device_read",
                            {"object_id": oid.binary(), "index": index_key,
                             "offset": pos, "length": chunk}, timeout=600))
                        pos += chunk
                    nxt = None
                    if pos < nbytes:  # prefetch the next chunk now
                        nxt = asyncio.ensure_future(client.call(
                            "device_read",
                            {"object_id": oid.binary(), "index": index_key,
                             "offset": pos, "length": chunk}, timeout=600))
                        pos += chunk
                    parts.append(await pending)
                    pending = nxt
                    nxt = None
                shard_data[index_key] = b"".join(parts)
        except (RpcConnectionError, RpcTimeoutError, RemoteError) as e:
            raise ObjectLostError(
                oid.hex(), f"device object holder unreachable: {e}") from e
        finally:
            for fut in (pending, nxt):
                if fut is not None and not fut.done():
                    fut.cancel()
        loop = asyncio.get_running_loop()
        return await loop.run_in_executor(
            None, device_objects.assemble, meta, shard_data)

    def _schedule_unpin(self, oid: ObjectID) -> None:
        """Release one of our pins on the local store, from any thread
        (zero-copy view finalizers fire wherever GC drops the last
        reference). Releases coalesce into ``store_unpin_batch`` calls —
        a burst of view GCs costs one RPC, and an unpin never sits on the
        critical path ahead of the next get's locate. A ``call`` (not
        notify) so a transport blip cannot silently leak the pin; the
        replay cache dedupes its retries."""
        if self._shutdown or self.supervisor_addr is None:
            return
        self._unpin_queue.append(oid.binary())
        _m_pins.dec()
        try:
            self.loop.call_soon_threadsafe(self._kick_unpin_flusher)
        except RuntimeError:
            pass  # loop already closed (interpreter shutdown)

    def _kick_unpin_flusher(self) -> None:
        if self._unpin_flushing or not self._unpin_queue:
            return
        self._unpin_flushing = True
        asyncio.get_running_loop().create_task(self._flush_unpins())

    async def _flush_unpins(self) -> None:
        try:
            while self._unpin_queue:
                batch = []
                while self._unpin_queue and len(batch) < 512:
                    batch.append(self._unpin_queue.popleft())
                try:
                    # retry_call: every attempt shares ONE (client_id,
                    # msg_id) replay-cache key, so a retry after a lost
                    # reply can NEVER re-execute the unpins (a double
                    # release would recycle an arena range under a live
                    # view elsewhere)
                    await retry_call(
                        self.clients.get(self.supervisor_addr),
                        "store_unpin_batch",
                        {"entries": batch,
                         "client": self._store_client_id},
                        timeout=120, per_call_timeout=30,
                        base_interval_s=(
                            self.config.rpc_retry_interval_ms / 1000.0))
                except Exception:
                    logger.warning(
                        "dropping %d unpin(s): supervisor unreachable; "
                        "the pins fall to the supervisor's dead-client "
                        "reclamation (or die with it)", len(batch))
        finally:
            self._unpin_flushing = False

    def _unpack_pinned_sync(self, oid: ObjectID, offset: int, size: int) -> Any:
        """Deserialize an arena object ZERO-COPY: out-of-band payload
        buffers become read-only numpy views over this process's own
        arena mmap — no copy-out — and the pin taken by the locate is
        released by a finalizer when the LAST view is garbage-collected
        (mutation of a returned array raises: the arena is shared,
        immutable storage). Pure in-band payloads (no buffers) release
        the pin immediately after unpickling — pickle copies in-band
        data, so nothing references the arena ("copy-on-read" for
        non-buffer payloads)."""
        guard = _PinGuard(lambda: self._schedule_unpin(oid))
        try:
            view = self.arena.view(offset, size).toreadonly()
            try:
                import numpy as np
            except ImportError:
                np = None
            if np is None:
                # no numpy in this process: copy out, release immediately
                data = bytes(view)
                _m_reads.inc(labels={"mode": "copy"})
                _m_read_bytes.inc(size, labels={"mode": "copy"})
                return serialization.unpack(data)

            def factory(sub: memoryview):
                base = np.frombuffer(sub, dtype=np.uint8)
                guard.inc()
                weakref.finalize(base, guard.dec)
                return base

            obj, n_buf = serialization.unpack_zero_copy(view, factory)
        finally:
            # exactly-once: the guard owns the pin on every exit — it
            # fires now if no view survived (error, or none was created),
            # else when the last finalizer runs
            guard.arm()
        # an in-band-only payload (no out-of-band buffers) was COPIED by
        # pickle while parsing — label it honestly
        mode = "zero_copy" if n_buf > 0 else "copy"
        _m_reads.inc(labels={"mode": mode})
        _m_read_bytes.inc(size, labels={"mode": mode})
        return obj

    async def _read_shared(self, oid: ObjectID, size: int, node_addr: Address) -> Any:
        sup = self.clients.get(self.supervisor_addr or node_addr)
        if self.supervisor_addr is not None and tuple(node_addr) != tuple(self.supervisor_addr):
            # remote object: the local supervisor pulls it into our node's
            # arena first (chunked, pipelined — supervisor._do_pull), then
            # the local zero-copy path below serves it
            await sup.call(
                "pull_object",
                {"object_id": oid.binary(), "from": node_addr, "size": size},
                timeout=600,
            )
        if self.arena is not None and self.supervisor_addr is not None:
            # pin-backed zero-copy read: one (batched) locate pins the
            # range; deserialization views the mmap directly and the pin
            # lives until the last view is GC'd (finalizer in
            # _unpack_pinned_sync)
            if self._locate_batcher is None:
                self._locate_batcher = _LocateBatcher(self)
            loc = await self._locate_batcher.locate(oid)
            if loc is None:
                raise ObjectLostError(oid.hex(), "not in local store")
            offset, lsize = loc
            # only a big IN-BAND portion makes unpacking heavy (pickle
            # copies it); out-of-band buffers are O(1) views — a 1 GiB
            # numpy payload unpacks in microseconds and must not pay a
            # thread hop
            try:
                heavy = serialization.inband_size(
                    self.arena.view(offset, lsize)) > 4 * 1024 * 1024
            except Exception:
                self._schedule_unpin(oid)  # corrupt header: hand it back
                raise
            if heavy:
                # shield: if this get is cancelled mid-await, the unpack
                # still runs, the guard still takes the pin, and the
                # unreferenced result releases it via the finalizers —
                # an unshielded cancel-before-start would strand the pin
                return await asyncio.shield(
                    asyncio.get_running_loop().run_in_executor(
                        None, self._unpack_pinned_sync, oid, offset,
                        lsize))
            return self._unpack_pinned_sync(oid, offset, lsize)
        # no local arena (e.g. detached utility process): pin at the remote
        # store and stream chunks — the copy path
        pinned = False
        try:
            loc = await sup.call(
                "store_locate",
                {"object_id": oid.binary(), "pin": True,
                 "client": self._store_client_id,
                 "client_addr": self.address},
                timeout=600)
            if loc is None:
                raise ObjectLostError(oid.hex(), "not in local store")
            pinned = True
            _m_pins.inc()
            pos = 0
            chunks = []
            while pos < size:
                c = await sup.call(
                    "store_read_chunk",
                    {
                        "object_id": oid.binary(),
                        "offset": pos,
                        "length": self.config.object_transfer_chunk_bytes,
                    },
                )
                chunks.append(c)
                pos += len(c)
            data = b"".join(chunks)
        finally:
            if pinned:
                _m_pins.dec()
                try:
                    await sup.call(
                        "store_unpin",
                        {"object_id": oid.binary(),
                         "client": self._store_client_id},
                        timeout=60)
                except Exception:
                    logger.debug("remote unpin of %s failed",
                                 oid.hex()[:12], exc_info=True)
        _m_reads.inc(labels={"mode": "copy"})
        _m_read_bytes.inc(size, labels={"mode": "copy"})
        return serialization.unpack(data)

    def wait(
        self, refs, num_returns: int = 1, timeout: Optional[float] = None
    ) -> Tuple[list, list]:
        return self._run(self._async_wait(refs, num_returns, timeout))

    async def _async_wait(self, refs, num_returns, timeout):
        """Local refs resolve by dict lookup; remote refs poll their owner
        with ONE batched object_states RPC per owner per tick, with
        exponential backoff — not O(refs) RPCs every 10ms (the shape that
        failed the reference's 1k-refs microbench, ray_perf.py:93)."""
        deadline = None if timeout is None else time.monotonic() + timeout
        delay = 0.005

        done, not_done = [], list(refs)
        while True:
            still = []
            # local: no RPC at all
            remote_by_owner: Dict[Tuple, List] = {}
            for r in not_done:
                if tuple(r._owner_addr) == tuple(self.address):
                    e = self.objects.get(r._object_id)
                    if e is not None and e.state != PENDING:
                        done.append(r)
                    else:
                        still.append(r)
                else:
                    remote_by_owner.setdefault(
                        tuple(r._owner_addr), []).append(r)
            for owner, group in remote_by_owner.items():
                try:
                    states = await self.clients.get(owner).call(
                        "object_states",
                        {"object_ids": [r._object_id.binary()
                                        for r in group]})
                except Exception:
                    done.extend(group)  # owner gone → resolves to error at get
                    continue
                for r, st in zip(group, states):
                    if st in ("value", "location", "device", "error"):
                        done.append(r)
                    else:
                        still.append(r)
            not_done = still
            if len(done) >= num_returns or not not_done:
                return done, not_done
            if deadline is not None and time.monotonic() > deadline:
                return done, not_done
            await asyncio.sleep(delay)
            delay = min(delay * 2, 0.1)

    # ---- ref counting ----

    def add_local_ref(self, oid: ObjectID, owner: Address) -> None:
        if self.address is not None and tuple(owner) == tuple(self.address):
            entry = self._ensure_entry(oid)
            entry.local_refs += 1

    def remove_local_ref(self, oid: ObjectID, owner: Address) -> None:
        if self._shutdown or self.address is None:
            return
        if tuple(owner) == tuple(self.address):
            def dec():
                entry = self.objects.get(oid)
                if entry is not None:
                    entry.local_refs = max(0, entry.local_refs - 1)
                    self._maybe_free(entry)

            try:
                self.loop.call_soon_threadsafe(dec)
            except RuntimeError:
                pass
        else:
            async def notify():
                try:
                    await self.clients.get(owner).notify(
                        "release_borrow", {"object_id": oid.binary()}
                    )
                except Exception:
                    pass

            try:
                asyncio.run_coroutine_threadsafe(notify(), self.loop)
            except RuntimeError:
                pass

    def _maybe_free(self, entry: ObjectEntry) -> None:
        if (
            entry.local_refs <= 0
            and entry.borrows <= 0
            and entry.task_pins <= 0
            and entry.state in (INLINE, SHARED, DEVICE, FAILED)
        ):
            oid = entry.object_id
            self.objects.pop(oid, None)
            self.in_process.free(oid)
            if entry.state == DEVICE:
                # owner GC: dropping the registry reference frees the
                # device memory; every other holder (the executor worker
                # of a return, the other ranks of a sharded put) is told
                # to release its own
                self.device_objects.drop(oid)
                others = {tuple(h) for h in (entry.holders
                                             or [entry.location])
                          if h is not None
                          and tuple(h) != tuple(self.address)}

                async def free_device(holder):
                    try:
                        await self.clients.get(holder).notify(
                            "device_free", {"object_id": oid.binary()})
                    except Exception:
                        pass

                for holder in others:
                    asyncio.get_running_loop().create_task(
                        free_device(holder))
            if entry.state == SHARED and entry.location is not None:
                async def free_remote():
                    try:
                        await self.clients.get(entry.location).notify(
                            "store_free", {"object_ids": [oid.binary()]}
                        )
                    except Exception:
                        pass

                asyncio.get_running_loop().create_task(free_remote())

    # ------------------------------------------------------------- actors

    def create_actor(
        self,
        cls: Any,
        args,
        kwargs,
        *,
        name: str = "",
        namespace: str = "default",
        resources: Optional[Dict[str, float]] = None,
        strategy: Optional[SchedulingStrategy] = None,
        max_restarts: int = 0,
        max_task_retries: int = 0,
        max_concurrency: int = 1,
        is_async: bool = False,
        runtime_env: Optional[Dict[str, Any]] = None,
        detached: bool = False,
        class_name: str = "",
    ) -> Tuple[ActorID, TaskID]:
        actor_id = ActorID.of(self.job_id)
        blob = serialization.dumps(cls)
        key = hashlib.sha256(blob).hexdigest()
        self._register_function(key, blob)
        spec = TaskSpec(
            task_id=TaskID.for_actor_creation(actor_id),
            job_id=self.job_id,
            kind=TaskKind.ACTOR_CREATION,
            name=f"{class_name}.__init__",
            function_key=key,
            args=self.build_args(args, kwargs),
            num_returns=1,
            resources={"CPU": 1.0} if resources is None else dict(resources),
            strategy=strategy or SchedulingStrategy(),
            owner=self.address,
            runtime_env=runtime_env,
            actor_id=actor_id,
            max_restarts=max_restarts,
            max_task_retries=max_task_retries,
            max_concurrency=max_concurrency,
            is_async_actor=is_async,
        )
        self._run(self._async_create_actor(spec, name, namespace, detached, class_name))
        return actor_id, spec.task_id

    async def _async_create_actor(
        self, spec: TaskSpec, name: str, namespace: str, detached: bool, class_name: str
    ) -> None:
        hexid = spec.actor_id.hex()
        # reconnect-budgeted: one (client_id, msg_id) across attempts, so
        # the registration rides out a controller kill + restart window —
        # the controller's WAL-embedded replay entry answers the resend
        # from cache instead of double-applying (or name-conflicting on
        # itself)
        await self._controller_call(
            "actor_register",
            {
                "actor_id_hex": hexid,
                "name": name,
                "namespace": namespace,
                "owner": self.address,
                "max_restarts": spec.max_restarts,
                "creation_spec": serialization.dumps(spec),
                "class_name": class_name,
                "job_id_hex": self.job_id.hex(),
                "detached": detached,
            },
        )
        state = ActorHandleState(spec.actor_id, caller_id=os.urandom(8).hex())
        self._actor_states[hexid] = state
        await self._subscribe_channel("actor:" + hexid)
        for oid in spec.return_ids():
            self._ensure_entry(oid)
        # hold the by-reference arguments until __init__ has resolved them
        # (the creation's report or its failure unpins them, as a task's):
        # a caller's temporary ref, as in Cls.remote(put(x)), would
        # otherwise be freed before the worker reads it
        self._pin_arg_refs(spec)
        pending = _PendingTask(spec, retries_left=0)
        self._inflight_tasks[spec.task_id] = pending
        asyncio.get_running_loop().create_task(self._create_actor_flow(spec, pending))

    async def _create_actor_flow(self, spec: TaskSpec, pending: _PendingTask) -> None:
        try:
            grant = await self._lease_with_retry(spec)
            target = grant["_supervisor_addr"]
            base = self.config.rpc_retry_interval_ms / 1000.0
            await retry_call(
                self.clients.get(target),
                "worker_set_actor",
                {
                    "worker_id_hex": grant["worker_id_hex"],
                    "actor_id_hex": spec.actor_id.hex(),
                },
                timeout=15, per_call_timeout=5, base_interval_s=base,
            )
            await self.clients.get(tuple(grant["worker_address"])).call(
                "push_task", {"spec": serialization.dumps(spec)}, timeout=3600
            )
        except Exception as e:
            self._fail_task(spec, ActorDiedError(spec.actor_id.hex(), f"creation failed: {e}"))
            self._inflight_tasks.pop(spec.task_id, None)
            try:
                await self.clients.get(self.controller_addr).call(
                    "actor_creation_failed",
                    {"actor_id_hex": spec.actor_id.hex(), "reason": str(e)},
                )
            except Exception:
                pass

    def _on_actor_update(self, actor_hex: str, message: dict) -> None:
        _trace(f"actor_update {actor_hex[:8]} {message}")
        state = self._actor_states.get(actor_hex)
        if state is None:
            return
        new_state = message.get("state")
        if new_state == "ALIVE":
            state.address = tuple(message["address"])
            inc = message.get("incarnation", 0)
            if state.incarnation == -1:
                # first sighting: adopt the incarnation, keep our seqno stream
                state.incarnation = inc
            elif inc != state.incarnation:
                # actor restarted on a fresh worker (executor ordering state
                # reset there), so the handle's sequence stream restarts too
                state.incarnation = inc
                state.seqno = 0
            state.dead = False
        elif new_state == "RESTARTING":
            state.address = None
            self._fail_inflight_actor_tasks(actor_hex, restarting=True)
        elif new_state == "DEAD":
            state.dead = True
            state.death_reason = message.get("reason", "")
            state.address = None
            # terminal: drop the channel from the reconnect re-subscribe
            # set, or a long-lived driver accretes one entry per actor
            # EVER created and replays them all after every controller
            # restart
            self._subscribed_channels.discard("actor:" + actor_hex)
            self._fail_inflight_actor_tasks(actor_hex, restarting=False)
        ev = self._actor_events.get(actor_hex)
        if ev is not None:
            ev.set()

    def _fail_inflight_actor_tasks(self, actor_hex: str, restarting: bool) -> None:
        """Tasks pushed to a now-dead incarnation will never complete: fail
        them, or resubmit when max_task_retries allows (actor.py:75-129
        semantics)."""
        state = self._actor_states.get(actor_hex)
        for task in list(self._inflight_tasks.values()):
            spec = task.spec
            if (
                spec.kind != TaskKind.ACTOR_TASK
                or spec.actor_id is None
                or spec.actor_id.hex() != actor_hex
            ):
                continue
            self._inflight_tasks.pop(spec.task_id, None)
            if restarting and task.retries_left != 0 and state is not None:
                task.retries_left -= 1
                self._inflight_tasks[spec.task_id] = task
                asyncio.get_running_loop().create_task(
                    self._actor_resubmit(task, state)
                )
            else:
                reason = (
                    "actor restarting; task lost (set max_task_retries to retry)"
                    if restarting
                    else (state.death_reason if state else "actor died")
                )
                self._fail_task(spec, ActorDiedError(actor_hex, reason))

    async def _actor_resubmit(self, task: _PendingTask, state: ActorHandleState) -> None:
        await self._await_actor_alive(state, time.monotonic() + 600)
        task.spec.seqno = state.seqno
        state.seqno += 1
        await self._actor_push(task, state)

    async def actor_state(self, actor_id: ActorID) -> ActorHandleState:
        hexid = actor_id.hex()
        state = self._actor_states.get(hexid)
        if state is None:
            state = ActorHandleState(actor_id, caller_id=os.urandom(8).hex())
            self._actor_states[hexid] = state
            await self._subscribe_channel("actor:" + hexid)
        return state

    def submit_actor_task(
        self,
        actor_id: ActorID,
        method_name: str,
        args,
        kwargs,
        *,
        num_returns: int = 1,
        max_task_retries: int = 0,
        backpressure: int = 0,
    ):
        spec = TaskSpec(
            task_id=TaskID.from_random(),
            job_id=self.job_id,
            kind=TaskKind.ACTOR_TASK,
            name=method_name,
            function_key="",
            args=self.build_args(args, kwargs),
            num_returns=num_returns,
            owner=self.address,
            actor_id=actor_id,
            method_name=method_name,
            max_retries=max_task_retries,
            backpressure=backpressure,
        )
        from ray_tpu_torch.util import tracing

        spec.trace_ctx = tracing.context_for_submission()
        if spec.is_streaming:
            self._streams[spec.task_id] = _StreamState()
        return_ids = spec.return_ids()
        self._run_nowait(self._guarded_submit(
            spec, self._async_submit_actor_task(spec),
            (tuple(args), kwargs)))
        return spec.task_id if spec.is_streaming else return_ids

    async def _async_submit_actor_task(self, spec: TaskSpec) -> None:
        _trace(f"submit_actor_task {spec.name} seq? actor={spec.actor_id.hex()[:8]}")
        for oid in spec.return_ids():
            self._ensure_entry(oid)
        self._pin_arg_refs(spec)
        # seqno assignment must follow submission order even though the
        # first actor_state() call suspends (controller subscribe RPC):
        # asyncio.Lock is FIFO-fair, and submission coroutines start in
        # .remote() order, so the lock hands out seqnos in that order.
        lock = self._actor_submit_locks.get(spec.actor_id.hex())
        if lock is None:
            lock = self._actor_submit_locks[spec.actor_id.hex()] = (
                asyncio.Lock())
        async with lock:
            state = await self.actor_state(spec.actor_id)
            spec.seqno = state.seqno
            state.seqno += 1
        pending = _PendingTask(spec, retries_left=spec.max_retries)
        self._inflight_tasks[spec.task_id] = pending
        state.outbox.append(pending)
        if state.flusher is None:
            state.flusher = asyncio.get_running_loop().create_task(
                self._actor_flush(state))

    async def _actor_flush(self, state: ActorHandleState) -> None:
        """Drain the actor's outbox, coalescing bursts into one
        `push_task_batch` frame per RPC (per-frame socket cost dominated
        the actor-call microbenchmark). Slow cases — actor not yet alive,
        dead, restarting, batch push failure — fall back to the per-task
        `_actor_push` machinery; the executor dedupes by task id, so an
        ambiguous batch failure is safe to re-push item by item."""
        async def push_or_fail(pending: _PendingTask) -> None:
            # a task already failed/completed elsewhere (actor-death
            # fan-out, cancellation) must not be re-pushed — _fail_task
            # twice would double-unpin its argument refs
            if pending.spec.task_id not in self._inflight_tasks:
                return
            try:
                await self._actor_push(pending, state)
            except Exception as e:  # noqa: BLE001 — surfaces via the refs
                logger.error("actor push of %s failed: %r",
                             pending.spec.name, e)
                if pending.spec.task_id in self._inflight_tasks:
                    self._fail_task(pending.spec, RuntimeError(
                        f"actor push failed: {e!r}"))
                    self._inflight_tasks.pop(pending.spec.task_id, None)

        try:
            while state.outbox:
                if state.dead or state.address is None:
                    await push_or_fail(state.outbox.popleft())
                    continue
                addr = state.address
                batch = []
                while state.outbox and len(batch) < 64:
                    p = state.outbox.popleft()
                    # same guard as push_or_fail: tasks already failed by
                    # actor-death fan-out must not reach the restarted
                    # actor (double execution + stale seqnos)
                    if p.spec.task_id in self._inflight_tasks:
                        batch.append(p)
                if not batch:
                    continue
                if len(batch) == 1:
                    await push_or_fail(batch[0])
                    continue
                for p in batch:
                    p.spec.caller_id = state.caller_id
                blobs = [serialization.dumps(p.spec) for p in batch]
                try:
                    await self.clients.get(addr).call(
                        "push_task_batch", {"specs": blobs},
                        timeout=self.config.task_push_timeout_s)
                    _trace(f"actor_push batched {len(batch)} to {addr}")
                except Exception:  # noqa: BLE001 — incl. transport resets
                    # ambiguous delivery: re-push item by item (the
                    # executor dedupes by task id)
                    for p in batch:
                        await push_or_fail(p)
        except Exception:  # noqa: BLE001 — never die unobserved
            logger.exception("actor flusher crashed; outbox of %s retried "
                             "on next submission", state.actor_id.hex()[:8])
        finally:
            state.flusher = None

    async def _actor_push(self, pending: _PendingTask, state: ActorHandleState) -> None:
        spec = pending.spec
        _trace(f"actor_push start {spec.name} seqno={spec.seqno} addr={state.address} dead={state.dead}")
        deadline = time.monotonic() + 600
        while True:
            if state.dead:
                self._fail_task(
                    spec, ActorDiedError(state.actor_id.hex(), state.death_reason)
                )
                self._inflight_tasks.pop(spec.task_id, None)
                return
            addr = state.address
            if addr is None:
                await self._await_actor_alive(state, deadline)
                continue
            try:
                spec.caller_id = state.caller_id  # type: ignore[attr-defined]
                await self.clients.get(addr).call(
                    "push_task", {"spec": serialization.dumps(spec)},
                    timeout=self.config.task_push_timeout_s
                )
                _trace(f"actor_push pushed {spec.name} seqno={spec.seqno} to {addr}")
                return
            except (RpcConnectionError, RpcTimeoutError, RemoteError) as push_err:
                _trace(f"actor_push error {spec.name}: {push_err!r}")
                # actor may be restarting; refresh state from the
                # controller — riding out a controller restart window
                # (a transient controller outage must not fail the task)
                rec = await self._controller_call(
                    "actor_get", {"actor_id_hex": spec.actor_id.hex()}
                )
                if rec is None or rec["state"] == "DEAD":
                    state.dead = True
                    state.death_reason = (rec or {}).get("death_cause", "unknown")
                    continue
                if rec["state"] == "ALIVE" and tuple(rec["address"]) != addr:
                    self._on_actor_update(
                        spec.actor_id.hex(),
                        {
                            "state": "ALIVE",
                            "address": rec["address"],
                            "incarnation": rec["incarnation"],
                        },
                    )
                    if pending.retries_left == 0:
                        self._fail_task(
                            spec,
                            ActorDiedError(
                                spec.actor_id.hex(), "actor restarted; task lost"
                            ),
                        )
                        self._inflight_tasks.pop(spec.task_id, None)
                        return
                    pending.retries_left -= 1
                    spec.seqno = state.seqno
                    state.seqno += 1
                    continue
                state.address = None
                if time.monotonic() > deadline:
                    self._fail_task(
                        spec, ActorDiedError(spec.actor_id.hex(), "unreachable")
                    )
                    self._inflight_tasks.pop(spec.task_id, None)
                    return

    async def _await_actor_alive(self, state: ActorHandleState, deadline) -> None:
        hexid = state.actor_id.hex()
        ev = self._actor_events.get(hexid)
        if ev is None:
            ev = asyncio.Event()
            self._actor_events[hexid] = ev
        ev.clear()
        # double-check via controller in case we missed the publish
        # (retry-budgeted: must survive a controller restart window)
        rec = await self._controller_call(
            "actor_get", {"actor_id_hex": hexid}
        )
        if rec is not None:
            if rec["state"] == "ALIVE" and rec.get("address"):
                self._on_actor_update(
                    hexid,
                    {
                        "state": "ALIVE",
                        "address": rec["address"],
                        "incarnation": rec["incarnation"],
                    },
                )
                return
            if rec["state"] == "DEAD":
                self._on_actor_update(hexid, {"state": "DEAD", "reason": rec["death_cause"]})
                return
        try:
            await asyncio.wait_for(ev.wait(), timeout=max(0.5, deadline - time.monotonic()))
        except asyncio.TimeoutError:
            pass

    def kill_actor(self, actor_id: ActorID, no_restart: bool = True) -> None:
        self._run(
            self.clients.get(self.controller_addr).call(
                "actor_kill",
                {"actor_id_hex": actor_id.hex(), "no_restart": no_restart},
            )
        )

    # ------------------------------------------------------------- events

    def _record_event(self, spec: TaskSpec, state: str,
                      worker_pid: Optional[int] = None,
                      run_start: Optional[float] = None) -> None:
        event = {
            "task_id": spec.task_id.hex(),
            "name": spec.name,
            "state": state,
            "ts": time.time(),
            "job_id": spec.job_id.hex(),
            "kind": spec.kind.name,
            "node": self.node_id_hex,
        }
        if worker_pid is not None:
            event["worker_pid"] = worker_pid  # the process that ran it
        if run_start is not None:
            event["run_start"] = run_start  # its wall clock when it began
        self._task_events.append(event)
        if len(self._task_events) >= 100:
            events = list(self._task_events)
            self._task_events.clear()
            asyncio.get_running_loop().create_task(self._flush_events(events))

    def flush_task_events(self) -> None:
        """Send the task events this owner holds back (it ships them in
        batches of 100) now, and wait for the controller to take them."""
        async def flush():
            # on the core's loop, where the events are recorded
            events = list(self._task_events)
            self._task_events.clear()
            if events:
                await self.clients.get(self.controller_addr).call(
                    "task_events", {"events": events})

        if self._task_events:
            self._run(flush())

    async def _flush_events(self, events) -> None:
        try:
            await self.clients.get(self.controller_addr).notify(
                "task_events", {"events": events}
            )
        except Exception:
            pass


class _RefPlaceholder:
    """Marks where a top-level ObjectRef argument goes in the unpacked args."""

    __slots__ = ("index",)

    def __init__(self, index: int):
        self.index = index
