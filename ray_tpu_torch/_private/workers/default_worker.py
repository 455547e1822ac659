"""Worker process main + task executor.

Analog of the reference's worker entrypoint
(`python/ray/_private/workers/default_worker.py`) plus the executor half of
CoreWorker (`CoreWorker::ExecuteTask` `core_worker.cc:2852`, scheduling queues
`transport/actor_scheduling_queue.h`): a worker registers with its
supervisor, then serves ``push_task`` RPCs.

Execution model:
  * normal tasks: FIFO on a single executor thread;
  * actor tasks: per-caller-handle sequence numbers enforce submission order
    when ``max_concurrency == 1`` (≈ ActorSchedulingQueue); threaded actors
    (`max_concurrency > 1`) run on a thread pool in arrival order
    (≈ out_of_order_actor_scheduling_queue.h + concurrency groups);
  * async actors: methods that are coroutines run on a dedicated asyncio loop
    with a ``max_concurrency`` semaphore (≈ fiber.h's fibers).

GPU specifics: the supervisor spawns the worker with ``CUDA_VISIBLE_DEVICES``
already set to the cards its lease holds ("" for a worker that asked for
none), so torch initializes only those cards when user code first touches
CUDA. Before the first GPU task runs, the worker checks that assignment
against the supervisor's (``_maybe_setup_gpu``).
"""

from __future__ import annotations

import argparse
import asyncio
import inspect
import logging
import os
import threading
import time
import traceback
from collections import OrderedDict, deque
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, Optional

from ray_tpu_torch._private import serialization
from ray_tpu_torch._private.config import Config
from ray_tpu_torch._private.core_worker import CoreWorker, _RefPlaceholder
from ray_tpu_torch._private.exceptions import TaskError
from ray_tpu_torch._private.ids import JobID, ObjectID, TaskID, WorkerID
from ray_tpu_torch._private.task_spec import ArgKind, TaskKind, TaskSpec

logger = logging.getLogger(__name__)


class Executor:
    """Executes task specs pushed to this worker."""

    def __init__(self, core: CoreWorker):
        self.core = core
        self.actor_instance: Any = None
        self.actor_spec: Optional[TaskSpec] = None
        self._pool = ThreadPoolExecutor(max_workers=1, thread_name_prefix="exec")
        self._async_loop: Optional[asyncio.AbstractEventLoop] = None
        self._async_sem: Optional[asyncio.Semaphore] = None
        # per-caller ordering state for sync actors
        self._expected_seq: Dict[str, int] = {}
        self._waiting: Dict[str, Dict[int, TaskSpec]] = {}
        self._cancelled: set = set()
        # push dedupe: the owner's push RPC may time out AFTER delivery
        # and retry elsewhere/again — a task id must execute at most once
        # here (bounded LRU)
        self._seen_pushes: "OrderedDict[TaskID, bool]" = OrderedDict()
        # streaming: last consumption watermark the owner told us, per task
        self._stream_consumed: Dict[TaskID, int] = {}
        # completion-report outbox (batched reply path, see _send_done);
        # appended from executor threads, drained on the IO loop (deque
        # append/popleft are thread-safe)
        self._done_outbox: deque = deque()
        self._done_flushing = False
        # wall-clock start of each task running here, until its report
        self._run_start: Dict[TaskID, float] = {}
        self._gpu_env_checked = False
        self._lock = threading.Lock()

    # -- entry from the IO loop (RPC handler) --

    async def push_task(self, body) -> str:
        spec: TaskSpec = serialization.loads(body["spec"])
        if spec.task_id in self._seen_pushes:
            return "ok"  # duplicate delivery (timed-out push retried)
        self._seen_pushes[spec.task_id] = True
        while len(self._seen_pushes) > 10_000:
            self._seen_pushes.popitem(last=False)
        if spec.kind == TaskKind.ACTOR_CREATION and spec.max_concurrency > 1:
            # threaded actor: widen the execution pool before __init__ runs
            self._pool = ThreadPoolExecutor(
                max_workers=spec.max_concurrency, thread_name_prefix="exec"
            )
        if spec.kind == TaskKind.ACTOR_TASK and self.actor_spec is not None:
            if self.actor_spec.max_concurrency <= 1 and not self.actor_spec.is_async_actor:
                self._enqueue_ordered(spec)
                return "ok"
        if (
            spec.kind == TaskKind.ACTOR_TASK
            and self.actor_spec is not None
            and self.actor_spec.is_async_actor
        ):
            from ray_tpu_torch._private.channels import CHANNEL_LOOP_METHOD

            if spec.method_name == CHANNEL_LOOP_METHOD:
                # the compiled-graph run loop is synchronous and
                # long-lived: parking it on the async actor's event loop
                # would starve every concurrent method and health ping —
                # run it on the thread pool like a sync task
                self._pool.submit(self._execute_guarded, spec)
                return "ok"
            self._submit_async(spec)
            return "ok"
        self._pool.submit(self._execute_guarded, spec)
        return "ok"

    async def push_task_batch(self, body) -> str:
        """Coalesced delivery: one frame, many specs (owner-side outbox
        batching). Each spec takes the exact same path as a single push —
        ordering still comes from seqnos, dedupe from task ids."""
        for blob in body["specs"]:
            await self.push_task({"spec": blob})
        return "ok"

    async def cancel(self, body) -> bool:
        self._cancelled.add(TaskID(body["task_id"]))
        return True

    def _enqueue_ordered(self, spec: TaskSpec) -> None:
        caller = getattr(spec, "caller_id", "") or "_"
        with self._lock:
            waiting = self._waiting.setdefault(caller, {})
            waiting[spec.seqno] = spec
            expected = self._expected_seq.get(caller, 0)
            while expected in waiting:
                ready = waiting.pop(expected)
                expected += 1
                self._pool.submit(self._execute_guarded, ready)
            self._expected_seq[caller] = expected

    def _submit_async(self, spec: TaskSpec) -> None:
        if self._async_loop is None:
            self._async_loop = asyncio.new_event_loop()
            t = threading.Thread(
                target=self._async_loop.run_forever, name="actor-async", daemon=True
            )
            t.start()
            conc = self.actor_spec.max_concurrency if self.actor_spec else 1
            self._async_sem = asyncio.Semaphore(max(1, conc))

        async def run():
            async with self._async_sem:
                await self._execute_async(spec)

        asyncio.run_coroutine_threadsafe(run(), self._async_loop)

    # -- execution --

    def _execute_guarded(self, spec: TaskSpec) -> None:
        try:
            self._execute(spec)
        except BaseException:
            logger.exception("executor crashed on %s", spec.name)

    def _resolve_args(self, spec: TaskSpec):
        value_arg = spec.args[0]
        plain_args, kwargs = serialization.unpack(value_arg.value)
        ref_args = spec.args[1:]
        if ref_args:
            from ray_tpu_torch._private.api import ObjectRef

            refs = [
                ObjectRef(a.object_id, tuple(a.owner), skip_ref_counting=True)
                for a in ref_args
            ]
            values = self.core.get(refs)
            # placeholder.index is the 0-based REF-arg order from build_args
            plain_args = [
                values[a.index] if isinstance(a, _RefPlaceholder) else a
                for a in plain_args
            ]
        return plain_args, kwargs

    def _maybe_setup_gpu(self, spec: TaskSpec) -> None:
        """Before the first GPU task: the cards the supervisor assigned
        this worker must be the ones its CUDA_VISIBLE_DEVICES names. The
        variable is fixed at spawn (CUDA reads it once), so a mismatch —
        a pooled worker handed other cards — fails the task instead of
        running it on a card another lease holds."""
        if self._gpu_env_checked or spec.required_resources().get("GPU", 0) <= 0:
            return
        gpus = self.core._run(
            self.core.clients.get(self.core.supervisor_addr).call(
                "gpu_visible_devices",
                {"worker_id_hex": self.core.worker_id.hex()}))
        have = os.environ.get("CUDA_VISIBLE_DEVICES")
        if have != ",".join(gpus):
            raise RuntimeError(
                f"worker sees CUDA_VISIBLE_DEVICES={have!r} but holds GPUs "
                f"{gpus}")
        self._gpu_env_checked = True

    def _get_callable(self, spec: TaskSpec):
        if spec.kind == TaskKind.ACTOR_TASK:
            if self.actor_instance is None:
                raise RuntimeError("actor task before actor creation")
            from ray_tpu_torch._private import channels

            if spec.method_name == channels.CHANNEL_LOOP_METHOD:
                # compiled-graph execution: the "method" IS the per-actor
                # run loop (read input channels -> run stage methods ->
                # write output channels); it occupies this slot until the
                # graph is torn down or a participant dies
                import functools

                return functools.partial(
                    channels.run_actor_loop, self.core,
                    self.actor_instance)
            return getattr(self.actor_instance, spec.method_name)
        return self.core.get_function(spec.function_key)

    def _execute(self, spec: TaskSpec) -> None:
        from ray_tpu_torch._private import chaos

        chaos.maybe_crash("worker.execute")
        self._run_start[spec.task_id] = time.time()
        if spec.task_id in self._cancelled:
            from ray_tpu_torch._private.exceptions import TaskCancelledError

            self._report_error(spec, TaskCancelledError(spec.name), retryable=False)
            return
        try:
            self._maybe_setup_gpu(spec)
            args, kwargs = self._resolve_args(spec)
            fn = self._get_callable(spec)
            if spec.kind == TaskKind.ACTOR_CREATION:
                cls = fn
                self.actor_instance = cls(*args, **kwargs)
                self.actor_spec = spec
                self.core.actor_id = spec.actor_id
                self.core._run(self._notify_actor_ready(spec))
                self._report_results(spec, [None])
                return
            with self._task_span(spec):
                result = fn(*args, **kwargs)
                # inspect.iscoroutine, NOT asyncio.iscoroutine: on 3.10
                # the latter also matches plain generators (legacy
                # @asyncio.coroutine support), sending every sync
                # streaming task into run_until_complete -> "Task got
                # bad yield"
                if inspect.iscoroutine(result):
                    # sync path hit an async def: run it to completion here
                    # (loop closed afterwards — each leaks an epoll fd +
                    # self-pipe otherwise, EMFILE on long-lived workers)
                    _loop = asyncio.new_event_loop()
                    try:
                        result = _loop.run_until_complete(result)
                    finally:
                        _loop.close()
                if spec.is_streaming:
                    self._run_generator(spec, result)
                    return
            results = self._split_returns(spec, result)
            self._report_results(spec, results)
        except Exception as e:  # noqa: BLE001 — user exception crosses to owner
            err = TaskError.from_exception(spec.name, e)
            retryable = spec.retry_exceptions
            if spec.kind == TaskKind.ACTOR_CREATION:
                self.core._run(self._notify_creation_failed(spec, err))
                retryable = False
            self._report_error(spec, err, retryable)

    async def _execute_async(self, spec: TaskSpec) -> None:
        self._run_start[spec.task_id] = time.time()
        try:
            args, kwargs = await asyncio.get_running_loop().run_in_executor(
                None, self._resolve_args, spec
            )
            fn = self._get_callable(spec)
            with self._task_span(spec):
                result = fn(*args, **kwargs)
                # inspect (strict), not asyncio: see _execute — a plain
                # generator must reach the streaming path, not `await`
                if inspect.iscoroutine(result):
                    result = await result
                if spec.is_streaming:
                    await self._run_async_generator(spec, result)
                    return
            results = self._split_returns(spec, result)
            self._report_results(spec, results)
        except Exception as e:  # noqa: BLE001
            self._report_error(spec, TaskError.from_exception(spec.name, e), False)

    @staticmethod
    def _task_span(spec: TaskSpec):
        """Child span continuing the caller's propagated trace context
        (no-op nullcontext for untraced tasks)."""
        import contextlib

        if not spec.trace_ctx:
            return contextlib.nullcontext()
        from ray_tpu_torch.util import tracing

        kind = "actor" if spec.actor_id is not None else "task"
        return tracing.remote_span(f"{kind}::{spec.name}", spec.trace_ctx)

    def _split_returns(self, spec: TaskSpec, result) -> list:
        if spec.num_returns == 1:
            return [result]
        if not isinstance(result, (tuple, list)) or len(result) != spec.num_returns:
            raise ValueError(
                f"task {spec.name} declared num_returns={spec.num_returns} but "
                f"returned {type(result).__name__}"
            )
        return list(result)

    # -- streaming generator tasks (num_returns="streaming") --

    def _run_generator(self, spec: TaskSpec, gen) -> None:
        """Drive a sync generator, reporting each yielded item to the
        owner as it is produced (≈ executor-side item reporting,
        core_worker.cc:3260). Item ids are deterministic
        (task_id + yield index) so a retried execution after a worker
        death replays onto the same ids."""
        if hasattr(gen, "__anext__"):
            # async generator reached the sync executor (e.g. a task
            # function defined async): drive it on a private loop
            _loop = asyncio.new_event_loop()
            try:
                _loop.run_until_complete(
                    self._run_async_generator(spec, gen))
            finally:
                _loop.close()
            return
        if not hasattr(gen, "__next__"):
            raise TypeError(
                f"task {spec.name} declared num_returns='streaming' but "
                f"returned {type(gen).__name__}, not a generator")
        from ray_tpu_torch._private.exceptions import TaskCancelledError

        index = 0
        any_shared = False
        try:
            for item in gen:
                if spec.task_id in self._cancelled:
                    self._report_error(
                        spec, TaskCancelledError(spec.name), retryable=False)
                    return
                any_shared |= self._report_stream_item(spec, index, item)
                index += 1
                self._stream_backpressure(spec, index)
        except Exception as e:  # noqa: BLE001 — user generator raised
            self._report_error(spec, TaskError.from_exception(spec.name, e),
                               spec.retry_exceptions)
            return
        finally:
            self._stream_cleanup(spec)
        self._send_done(spec, {
            "task_id": spec.task_id.binary(), "results": [],
            "stream_count": index, "stream_any_shared": any_shared})

    def _stream_cleanup(self, spec: TaskSpec) -> None:
        """Per-stream executor state must not outlive the stream — a
        long-lived replica serves millions of them (the adjacent
        _seen_pushes cache is bounded for the same reason)."""
        self._stream_consumed.pop(spec.task_id, None)
        self._cancelled.discard(spec.task_id)

    async def _run_async_generator(self, spec: TaskSpec, agen) -> None:
        """Async-actor variant: drive an async generator on the actor's
        event loop (items interleave with other concurrent methods)."""
        if not hasattr(agen, "__anext__"):
            # plain generator from an async actor: drive it OFF the actor
            # loop — per-item report RPCs and backpressure sleeps would
            # otherwise stall every concurrent method and health ping
            await asyncio.get_running_loop().run_in_executor(
                None, self._run_generator, spec, agen)
            return
        from ray_tpu_torch._private.exceptions import TaskCancelledError

        index = 0
        any_shared = False
        loop = asyncio.get_running_loop()
        try:
            async for item in agen:
                if spec.task_id in self._cancelled:
                    self._report_error(
                        spec, TaskCancelledError(spec.name), retryable=False)
                    return
                any_shared |= await loop.run_in_executor(
                    None, self._report_stream_item, spec, index, item)
                index += 1
                await loop.run_in_executor(
                    None, self._stream_backpressure, spec, index)
        except Exception as e:  # noqa: BLE001
            self._report_error(spec, TaskError.from_exception(spec.name, e),
                               spec.retry_exceptions)
            return
        finally:
            self._stream_cleanup(spec)
        self._send_done(spec, {
            "task_id": spec.task_id.binary(), "results": [],
            "stream_count": index, "stream_any_shared": any_shared})

    def _report_stream_item(self, spec: TaskSpec, index: int, item) -> bool:
        """Ship one yielded item to the owner; returns True if it went to
        the shared arena (size-routed exactly like normal returns)."""
        oid = ObjectID.for_task_return(spec.task_id, index)
        packed = serialization.pack(item)
        body = {"task_id": spec.task_id.binary(), "index": index,
                "object_id": oid.binary()}
        shared = len(packed) > self.core.config.max_direct_call_object_size
        if shared:
            self.core._run(self._store_shared(oid, packed))
            body["kind"] = "shared"
            body["payload"] = {"size": len(packed),
                               "node_addr": self.core.supervisor_addr}
        else:
            body["kind"] = "inline"
            body["payload"] = packed
        reply = self.core._run(
            self.core.clients.get(tuple(spec.owner)).call("stream_item", body))
        self._stream_consumed[spec.task_id] = reply.get("consumed", 0)
        if reply.get("stop"):
            self._cancelled.add(spec.task_id)  # consumer released the stream
        return shared

    def _stream_backpressure(self, spec: TaskSpec, produced: int) -> None:
        """Pause when the owner's consumer lags more than the configured
        window (spec.backpressure, 0 = unbounded) — ≈ the reference's
        _generator_backpressure_num_objects."""
        if spec.backpressure <= 0:
            return
        while (produced - self._stream_consumed.get(spec.task_id, 0)
               >= spec.backpressure
               and spec.task_id not in self._cancelled):
            # owner-side long-poll: ONE rpc blocks until the consumer
            # reaches the watermark (or 5s passes) instead of hammering
            # the owner's IO loop with 20ms polls
            wait_for = produced - spec.backpressure + 1
            try:
                reply = self.core._run(
                    self.core.clients.get(tuple(spec.owner)).call(
                        "stream_state",
                        {"task_id": spec.task_id.binary(),
                         "wait_for": wait_for, "timeout": 5.0},
                        timeout=30.0))
            except Exception:
                return  # owner gone: stop pausing, let the report fail
            self._stream_consumed[spec.task_id] = reply.get("consumed", 0)
            if reply.get("stop"):
                self._cancelled.add(spec.task_id)
                return

    # -- result reporting (owner is the submitter) --

    def _report_results(self, spec: TaskSpec, values: list) -> None:
        from ray_tpu_torch._private import device_objects

        results = []
        for oid, value in zip(spec.return_ids(), values):
            sharded = device_objects.is_sharded(value)
            if sharded and value.device_mesh.mesh.numel() != 1:
                # a larger mesh's other shards are other processes'
                # returns: no one process can return the whole object
                raise ValueError(
                    f"{spec.name} returned a DTensor on a mesh of "
                    f"{value.device_mesh.mesh.numel()} ranks: a task can "
                    f"return only a one-rank mesh's; have every rank call "
                    f"ray_tpu_torch.put(dtensor) and return the ref")
            if sharded or (device_objects.is_device_array(value)
                           and value.nbytes >
                           self.core.config.max_direct_call_object_size):
                # A DTensor on a one-rank mesh (whatever its size: its
                # layout has no host form), or a large CUDA tensor
                # return: keep a snapshot on its device
                # (this worker is the holder; the function may still hold
                # and write the tensor it returned), report layout
                # metadata only — no host pickle. The owner frees it via device_free at zero
                # refs; if this worker dies first, lineage re-executes
                # the task. Small arrays stay on the inline path: the
                # host copy is negligible and the value can never be
                # lost with the worker.
                meta = self.core.device_objects.put(
                    oid, device_objects.snapshot(value))
                results.append((oid.binary(), "device", {
                    "size": meta.nbytes,
                    "worker_addr": self.core.address,
                    "meta": serialization.dumps(meta)}))
                continue
            smeta, buffers, total = serialization.packed_size(value)
            if total <= self.core.config.max_direct_call_object_size:
                results.append((oid.binary(), "inline",
                                serialization.pack_parts(smeta, buffers)))
            else:
                # piecewise into the arena (no join copy — same path as
                # owner-side put; matters for GiB numpy returns)
                self.core._run(
                    self._store_shared_parts(oid, smeta, buffers, total))
                results.append(
                    (
                        oid.binary(),
                        "shared",
                        {"size": total,
                         "node_addr": self.core.supervisor_addr},
                    )
                )
        self._send_done(spec, {"task_id": spec.task_id.binary(), "results": results})

    async def _store_shared(self, oid: ObjectID, packed: bytes) -> None:
        sup = self.core.clients.get(self.core.supervisor_addr)
        # 600s: a GiB-class create can queue behind another object's
        # spill on the supervisor's store thread
        r = await sup.call("store_create", {"object_id": oid.binary(),
                                            "size": len(packed)},
                           timeout=600)
        self.core.arena.write(r["offset"], packed)
        await sup.call("store_seal", {"object_id": oid.binary()},
                       timeout=600)

    async def _store_shared_parts(self, oid: ObjectID, meta: bytes,
                                  buffers, total: int) -> None:
        """Piecewise arena write of a serialized return — the shared
        create->write->seal helper (no owner bookkeeping: the SUBMITTER
        owns returns; this process only lands the bytes)."""
        await self.core.arena_write_parts(oid, meta, buffers, total)

    def _report_error(self, spec: TaskSpec, err: Exception, retryable: bool) -> None:
        self._send_done(
            spec,
            {
                "task_id": spec.task_id.binary(),
                "error": serialization.dumps(err),
                "retryable": retryable,
            },
        )

    def _send_done(self, spec: TaskSpec, body: dict) -> None:
        """Queue the completion report and return immediately.

        Replies are coalesced: the executor thread never blocks on the
        report roundtrip (it picks up the next task right away), and the
        flusher on the IO loop drains whatever accumulated while the
        previous frame was in flight into ONE `task_done_batch` RPC per
        owner — the reply-side twin of the owner's push_task_batch
        (`ray microbenchmark`'s actor-call envelope needs both sides
        batched; reference: the reply batching inside the C++ direct
        actor transport, `direct_task_transport`)."""
        # report_id makes redelivery safe: a retried report whose first
        # delivery actually landed (reply lost to a transport blip) must
        # not be processed twice — a duplicated retryable-error body would
        # double-requeue the task at the owner
        body["report_id"] = os.urandom(8)
        body["worker_pid"] = os.getpid()  # the owner's task events name it
        run_start = self._run_start.pop(spec.task_id, None)
        if run_start is not None:
            body["run_start"] = run_start  # the timeline's span begins here
        self._done_outbox.append((tuple(spec.owner), body, 0))
        self.core._run_nowait(self._flush_done())

    async def _flush_done(self) -> None:
        if self._done_flushing:
            return  # one flusher; it will drain what we just queued
        self._done_flushing = True
        try:
            while self._done_outbox:
                by_owner: Dict[tuple, list] = {}
                count = 0
                while self._done_outbox and count < 256:
                    addr, body, attempts = self._done_outbox.popleft()
                    by_owner.setdefault(addr, []).append((body, attempts))
                    count += 1
                # per-owner sends run CONCURRENTLY: one dead owner's RPC
                # timeout must not head-of-line block reports to healthy
                # owners sitting behind it in the outbox
                await asyncio.gather(
                    *(self._send_done_batch(addr, entries)
                      for addr, entries in by_owner.items()))
        finally:
            self._done_flushing = False

    async def _send_done_batch(self, addr: tuple, entries: list) -> None:
        bodies = [b for b, _ in entries]
        try:
            if len(bodies) == 1:
                await self.core.clients.get(addr).call(
                    "task_done", bodies[0])
            else:
                await self.core.clients.get(addr).call(
                    "task_done_batch", {"dones": bodies})
        except Exception:
            # a transient blip must not strand N callers in get():
            # requeue with bounded retries (a dead owner gives up after
            # 3 — its worker-failed handling covers the rest). Backoff
            # rides call_later so the drain loop never sleeps inline.
            retry = [(addr, b, a + 1) for b, a in entries if a + 1 < 3]
            dropped = len(entries) - len(retry)
            if dropped:
                logger.warning(
                    "dropping %d task_done report(s) to %s after 3 "
                    "attempts", dropped, addr)
            if retry:
                def requeue():
                    self._done_outbox.extend(retry)
                    self.core._run_nowait(self._flush_done())

                asyncio.get_running_loop().call_later(0.1, requeue)

    async def _notify_actor_ready(self, spec: TaskSpec) -> None:
        # reconnect-budgeted: the actor CONSTRUCTED — a controller kill +
        # restart window must not fail the creation over the lost ALIVE
        # report. _controller_call shares one (client_id, msg_id) across
        # attempts, and the handler's WAL frame carries that replay key,
        # so a resend that straddles the restart can never
        # double-increment the incarnation (handle seqno reset semantics
        # ride it).
        await self.core._controller_call(
            "actor_ready",
            {
                "actor_id_hex": spec.actor_id.hex(),
                "address": self.core.address,
                "worker_id_hex": self.core.worker_id.hex(),
                "node_id_hex": self.core.node_id_hex,
            },
        )

    async def _notify_creation_failed(self, spec: TaskSpec, err) -> None:
        try:
            await self.core.clients.get(self.core.controller_addr).call(
                "actor_creation_failed",
                {"actor_id_hex": spec.actor_id.hex(), "reason": str(err)[:500]},
            )
        except Exception:
            pass


def _watch_supervisor_liveness(supervisor_pid: int) -> None:
    """Die with the supervisor (≈ raylet-disconnect suicide,
    node_manager.cc:1432 / core_worker exiting on raylet socket close).

    The supervisor is our direct parent; when it dies we are reparented
    (PPID changes). An orphaned worker must not keep serving tasks — the
    cluster has already declared this node dead, and answering actor calls
    from beyond the grave breaks node-death semantics.
    """
    import time as _time

    while True:
        if os.getppid() != supervisor_pid:
            logger.warning("supervisor %d is gone; exiting", supervisor_pid)
            os._exit(1)
        _time.sleep(0.25)


async def _liveness_bond(supervisor_addr) -> None:
    """Hold an open socket to the supervisor; exit the moment it closes.

    The PPID watch above is the backstop, but polling loses the race
    against an in-flight task push — the reference's bond is a *socket*
    (raylet <-> worker), where the kernel delivers EOF the instant the
    raylet dies. Same here: a dedicated idle connection to the
    supervisor's RPC server; EOF or error means the supervisor is gone.
    """
    import asyncio as _asyncio

    # Transient connect errors (accept pressure during a worker burst) must
    # not kill a healthy worker — retry the initial connect; only a
    # post-connect EOF, or persistent refusal, means the supervisor is gone.
    for _ in range(40):
        try:
            reader, _writer = await _asyncio.open_connection(
                supervisor_addr[0], supervisor_addr[1]
            )
            break
        except Exception:
            await _asyncio.sleep(0.25)
    else:
        logger.warning("cannot reach supervisor; exiting")
        os._exit(1)
    try:
        await reader.read()  # returns only at EOF
    except Exception:
        pass
    logger.warning("supervisor connection closed; exiting")
    os._exit(1)


def main() -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--supervisor", required=True)
    parser.add_argument("--controller", required=True)
    parser.add_argument("--node-id", required=True)
    parser.add_argument("--arena-path", required=True)
    parser.add_argument("--arena-size", type=int, required=True)
    parser.add_argument("--session-dir", default="")
    args = parser.parse_args()
    if args.session_dir:
        # span files, debug dumps etc. land next to the session's logs.
        # The CLI arg is authoritative: a stale env inherited from an
        # earlier session in the same shell must not win.
        os.environ["RAY_TPU_TORCH_SESSION_DIR"] = args.session_dir

    logging.basicConfig(
        level=os.environ.get("RAY_TPU_TORCH_LOG_LEVEL", "INFO"),
        format="[worker %(process)d] %(asctime)s %(levelname)s %(message)s",
    )

    def parse_addr(s):
        host, port = s.rsplit(":", 1)
        return (host, int(port))

    threading.Thread(
        target=_watch_supervisor_liveness,
        args=(os.getppid(),),
        name="supervisor-liveness",
        daemon=True,
    ).start()
    # belt over the ppid watch: the supervisor stamps RAY_TPU_TORCH_OWNER_PID
    # into our env (supervisor.py _spawn_worker); the env watchdog adds
    # the pid-reuse start-time guard the ppid check lacks
    from ray_tpu_torch._private.watchdog import start_owner_watchdog_from_env

    start_owner_watchdog_from_env("worker")

    config = Config.from_env()
    core = CoreWorker(
        config,
        parse_addr(args.controller),
        parse_addr(args.supervisor),
        JobID.from_int(0),
        role="worker",
    )
    core.start()

    executor = Executor(core)
    # replay-cached at the RPC layer (retried delivery replays the ack) on
    # top of the executor's own _seen_pushes task-id dedupe, which covers
    # re-pushes that arrive as NEW requests (owner-level retry paths)
    core.server.register("push_task", executor.push_task, replay_cached=True)
    core.server.register("push_task_batch", executor.push_task_batch,
                         replay_cached=True)
    core.server.register("cancel", executor.cancel)

    async def profile(body):
        """Live in-process profiling (stacks / memory / device memory);
        ref dashboard reporter_agent.py:391 py-spy attach."""
        from ray_tpu_torch._private import profiling

        return profiling.collect(body.get("kind", "stack"),
                                 body.get("limit", 20))

    core.server.register("profile", profile)

    # p2p collective transport (util/collective/ring.py): register the
    # chunked-frame handler before this worker's address is published
    # anywhere, so no ring segment can ever arrive unroutable
    from ray_tpu_torch.util.collective import ring as _collective_ring

    _collective_ring.ensure_registered(core)

    # a worker leased a card runs torch work: it imports torch before it
    # registers, off the path of its first task (on the task thread,
    # against the IO loop, the same import takes longer); a worker with
    # no card never imports it unless a task does
    if os.environ.get("CUDA_VISIBLE_DEVICES"):
        import torch  # noqa: F401

    # make the worker-side public API work inside tasks
    from ray_tpu_torch._private import api

    api._connect_existing(core)

    ok = core._run(
        core.clients.get(parse_addr(args.supervisor)).call(
            "worker_register",
            {
                "worker_id_hex": core.worker_id.hex(),
                "address": core.address,
                "pid": os.getpid(),
                "env_key": os.environ.get("RAY_TPU_TORCH_WORKER_ENV_KEY", ""),
            },
        )
    )
    async def _start_bond():
        return asyncio.get_running_loop().create_task(
            _liveness_bond(parse_addr(args.supervisor)))

    # the loop holds tasks weakly, and the bond's stream reader is held
    # only by the task's frame: keep the task here, for the life of the
    # process, or the collector destroys the pending bond
    bond = asyncio.run_coroutine_threadsafe(_start_bond(), core.loop).result()
    # SIGTERM (supervisor shutdown/kill): drain the IO loop before dying
    # so asyncio never reports destroyed-pending tasks into the log tail
    # the driver is still reading
    import signal as _signal

    def _graceful_exit(_sig, _frm):
        try:
            core.shutdown()
        except Exception:
            pass
        # 143 = SIGTERM convention: the supervisor's exit handling and
        # the WORKER_EXITED event must still see a signal-terminated
        # worker, not a clean exit
        os._exit(143)

    _signal.signal(_signal.SIGTERM, _graceful_exit)
    logger.info("worker %s registered, serving", core.worker_id.hex()[:8])
    threading.Event().wait()  # serve forever; supervisor kills us


if __name__ == "__main__":
    main()
