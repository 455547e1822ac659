"""Async overlapped collectives: work handles + the per-group runner.

Counterpart: ``ray_tpu/util/collective/async_work.py``. The synchronous
coalesced path serializes three stages that have no data dependency across
buckets: copy the gradients to the host, reduce them over the shm/ring
transport, and hand the results back. This module pipelines them:

  * ``allreduce_coalesced_async(...) -> CollectiveWork`` returns
    immediately; the caller's thread goes straight back to launching
    device work while the group's runner moves the gradients.
  * The runner is TWO persistent daemon threads per group. The *mover*
    copies one BUCKET at a time to the host (CUDA leaves: one ``cat`` on
    the card and one copy into pinned staging per bucket, on the mover's
    own stream, never one copy per leaf); the *reducer* runs the transport
    rounds. A bounded handoff queue between them means bucket i's reduce
    streams while bucket i+1's gradients are still leaving the card.
  * The mover waits, on its stream, for a CUDA event that ``submit``
    records on the caller's current stream: the backward that wrote the
    gradients may still be running when ``begin`` returns, and the mover
    must not read them before it is done.
  * Buckets go in REVERSE flatten order: backprop produces the last
    layers' gradients first.
  * Staging buffers come from a persistent pool keyed by (dtype, size)
    (pinned host memory when a card is visible): a steady-state training
    step allocates nothing, and a MEAN is pre-scaled into the staging
    buffer so no post-reduce divide pass exists.
  * ``on_bucket(indices, arrays)`` (optional) fires on the reducer thread
    the moment each bucket's reduce lands. The sync fallback fires it
    once per bucket on the caller's thread; a callback exception poisons
    the group like any mid-round failure.

Results are host arrays (numpy), or the caller's ``out=`` buffers; with
tensor inputs and no ``out=``, ``wait()`` turns them back into tensors of
the inputs' dtypes on the inputs' devices.

Failure semantics match the synchronous path: ANY exception escaping a
round poisons the group, the failing handle gets the real error, and every
queued handle fails with a clean ``CollectiveError``, never a hang.
``destroy()`` with work in flight fails all pending handles first, then
tears down the transport, which also unblocks a reducer parked mid-round.
"""

from __future__ import annotations

import logging
import queue
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from ray_tpu_torch._private import flight
from ray_tpu_torch.util.collective import _metrics
from ray_tpu_torch.util.collective.types import (CollectiveError, ReduceOp,
                                                 host_dtype, is_tensor,
                                                 numel, prescale_factor)

logger = logging.getLogger(__name__)

_STOP = object()

# flight-recorder span ids: one span per mover/reducer bucket round shows
# the overlap (or lack of it) the aggregate histograms can only average
_F_MOVE = flight.intern("col.mover_bucket")
_F_REDUCE = flight.intern("col.reduce_bucket")
_F_WAIT = flight.intern("col.wait")


# ----------------------------------------------------------------- handles


class CollectiveWork:
    """Handle for one in-flight ``allreduce_coalesced_async`` call."""

    def __init__(self, group_name: str,
                 post: Optional[Callable[[List[Any]], List[Any]]] = None):
        self._group_name = group_name
        self._event = threading.Event()
        self._result: Optional[List[Any]] = None
        self._exc: Optional[BaseException] = None
        # runs on the waiting thread: host results -> the inputs' tensors
        self._post = post

    #: False only on handles returned by the synchronous fallback
    overlapped = True

    def done(self) -> bool:
        """True once the result (or the failure) is available."""
        return self._event.is_set()

    def wait(self, timeout_ms: Optional[int] = None) -> List[Any]:
        """Block for the reduced arrays (input order). Raises the round's
        error if the work failed. The blocked span is recorded in
        ``ray_tpu_collective_wait_seconds``."""
        t0 = time.perf_counter()
        t0f = flight.now()
        ok = self._event.wait(
            None if timeout_ms is None else timeout_ms / 1000.0)
        flight.span_since(_F_WAIT, t0f)
        _metrics.wait_seconds.observe(time.perf_counter() - t0)
        if not ok:
            raise TimeoutError(
                f"collective group {self._group_name!r}: async work not "
                f"done within {timeout_ms} ms")
        if self._exc is not None:
            raise self._exc
        if self._post is not None:
            return self._post(self._result)  # type: ignore[arg-type]
        return self._result  # type: ignore[return-value]

    def exception(self) -> Optional[BaseException]:
        """The failure, if the work is done and failed (None otherwise)."""
        return self._exc if self._event.is_set() else None

    # -- runner side (first finish/fail wins; late poison fan-out is a no-op)

    def _finish(self, result: List[Any]) -> None:
        if not self._event.is_set():
            self._result = result
            self._event.set()

    def _fail(self, exc: BaseException) -> None:
        if not self._event.is_set():
            self._exc = exc
            self._event.set()


class _CompletedWork(CollectiveWork):
    """Synchronous-fallback handle: already done at construction."""

    overlapped = False

    def __init__(self, group_name: str, result: List[Any]):
        super().__init__(group_name)
        self._finish(result)


# ------------------------------------------------------------ staging pool


def _pinned_ok() -> bool:
    import sys

    torch = sys.modules.get("torch")
    return torch is not None and torch.cuda.is_available()


class StagingPool:
    """Persistent flat staging buffers keyed by (dtype, elements): after
    one warmup step every ``acquire`` is a pool hit. With a card visible
    the buffers are pinned host memory (numpy views of pinned tensors), so
    the mover's device-to-host copies run at the link's rate."""

    def __init__(self):
        self._free: Dict[Tuple[str, int], List[np.ndarray]] = {}
        self._lock = threading.Lock()
        self._closed = False

    def acquire(self, dtype: np.dtype, nelems: int) -> np.ndarray:
        key = (np.dtype(dtype).str, int(nelems))
        with self._lock:
            bufs = self._free.get(key)
            if bufs:
                return bufs.pop()
        if _pinned_ok():
            import torch

            # the array's base keeps the pinned tensor alive
            buf = torch.from_numpy(np.empty(0, np.dtype(dtype))).new_empty(
                int(nelems), pin_memory=True).numpy()
        else:
            buf = np.empty(nelems, np.dtype(dtype))
        _metrics.staging_allocs_total.inc()
        _metrics.staging_bytes.inc(buf.nbytes)
        return buf

    def release(self, buf: np.ndarray) -> None:
        with self._lock:
            if self._closed:
                # a buffer in flight when drain() ran: drop it and settle
                # its share of the gauge
                _metrics.staging_bytes.dec(buf.nbytes)
                return
            self._free.setdefault((buf.dtype.str, buf.size), []).append(buf)

    def drain(self) -> None:
        """Drop every pooled buffer (group destroy); buffers still in
        flight settle through ``release`` above."""
        with self._lock:
            self._closed = True
            freed = sum(b.nbytes for bufs in self._free.values()
                        for b in bufs)
            self._free.clear()
        if freed:
            _metrics.staging_bytes.dec(freed)


# ---------------------------------------------------------- bucket layout


def bucket_layout(arrs: Sequence[Any], bucket_bytes: int,
                  dtype_of: Callable[[Any], Any] = host_dtype
                  ) -> List[List[int]]:
    """Greedy adjacent same-dtype buckets bounded by ``bucket_bytes``, by
    ``dtype_of`` each leaf (the host dtypes; a group that reduces on the
    card passes the tensors' own). Only dtypes and sizes are read, never
    the bytes, so device tensors cost nothing here."""
    buckets: List[List[int]] = []
    cur: List[int] = []
    cur_sz = 0
    cur_dt = None
    for i, a in enumerate(arrs):
        dt = dtype_of(a)
        nbytes = numel(a) * dt.itemsize
        if cur and (dt != cur_dt or cur_sz + nbytes > bucket_bytes):
            buckets.append(cur)
            cur = []
            cur_sz = 0
        cur.append(i)
        cur_dt = dt
        cur_sz += nbytes
    if cur:
        buckets.append(cur)
    return buckets


def validate_on_bucket(on_bucket) -> None:
    """Fail a bad ``on_bucket=`` LOUDLY on the caller's thread: inside the
    runner a non-callable would poison the whole group on the first
    bucket."""
    if on_bucket is None or callable(on_bucket):
        return
    raise TypeError(
        f"on_bucket must be a callable (indices, arrays) -> None, got "
        f"{type(on_bucket).__name__}: {on_bucket!r}")


def fire_on_bucket(leaves: Sequence[Any], bucket_bytes: int,
                   results: Sequence[Any], on_bucket) -> None:
    """Replay the runner's per-bucket callback contract over already-
    reduced ``results``: same-dtype buckets laid out from the INPUT leaves,
    fired in the runner's reverse-flatten order, each leaf exactly once.
    Every synchronous fallback (BaseGroup, the world-1 GradientAverager)
    replays it."""
    for bucket in reversed(bucket_layout(leaves, bucket_bytes)):
        on_bucket(list(bucket), [results[i] for i in bucket])


def host_out(out: Optional[Sequence[Any]]) -> Optional[List[np.ndarray]]:
    """``out=`` buffers as numpy arrays: numpy arrays as they are, CPU
    tensors as views of their memory."""
    if out is None:
        return None
    views = []
    for o in out:
        if is_tensor(o):
            if o.device.type != "cpu":
                raise ValueError("collective out= tensors must be on the CPU")
            o = o.numpy()
        views.append(o)
    return views


def validate_out(leaves: Sequence[Any], op: ReduceOp,
                 out: Optional[Sequence[np.ndarray]],
                 world_size: int) -> None:
    """Fail bad ``out=`` combinations LOUDLY on the caller's thread: the
    buffers must have the inputs' shapes and host dtypes (float32 for a
    bfloat16 tensor)."""
    if out is None:
        return
    if len(out) != len(leaves):
        raise ValueError(
            f"out has {len(out)} arrays for {len(leaves)} tensors")
    if op is ReduceOp.MEAN and any(
            prescale_factor(op, host_dtype(a), world_size) is None
            for a in leaves):
        raise ValueError(
            "op='mean' over integer tensors widens to float: it cannot "
            "land in integer out= buffers; drop out= or cast the inputs")
    for i, (a, o) in enumerate(zip(leaves, out)):
        if tuple(o.shape) != tuple(a.shape) or \
                np.dtype(o.dtype) != host_dtype(a):
            raise ValueError(
                f"out[{i}] is {np.dtype(o.dtype)}{tuple(o.shape)} but "
                f"tensor {i} is {host_dtype(a)}{tuple(a.shape)}: out= "
                f"buffers must match the inputs' shapes and host dtypes")


def pack_bucket(leaves: List[Any], staging: np.ndarray,
                scale: Optional[float], stream=None, ready=None) -> None:
    """Copy a bucket's leaves into the flat ``staging`` vector, scaled by
    ``scale`` when given. CUDA leaves: one ``cat`` on the card into the
    staging dtype and ONE device-to-host copy, on ``stream`` (after it
    waits for the ``ready`` event); CPU tensors: one ``cat`` into the
    staging memory; numpy leaves: one copy each."""
    if any(is_tensor(x) for x in leaves):
        import torch

        target = torch.from_numpy(staging)
        flats = [x.detach().reshape(-1) for x in leaves]
        if flats[0].is_cuda:
            with torch.cuda.stream(stream):
                if ready is not None:
                    stream.wait_event(ready)
                dev = torch.cat([f.to(target.dtype) for f in flats]) \
                    if len(flats) > 1 else flats[0].to(target.dtype)
                target.copy_(dev, non_blocking=True)
                stream.synchronize()
                del dev
        else:
            torch.cat([f.to(target.dtype) for f in flats], out=target)
        if scale is not None:
            np.multiply(staging, scale, out=staging)
        return
    off = 0
    for a in leaves:
        flat = np.ascontiguousarray(a).reshape(-1)
        seg = staging[off:off + flat.size]
        if scale is None:
            seg[...] = flat
        else:
            np.multiply(flat, scale, out=seg)
        off += flat.size


def tensor_results(tensors: Sequence[Any]):
    """The ``post`` of a handle whose inputs were tensors and that has no
    ``out=``: host results back as tensors like the inputs."""
    from ray_tpu_torch.util.collective.types import from_host

    likes = list(tensors)

    def post(results):
        return [from_host(r, like) for r, like in zip(results, likes)]

    return post


# ----------------------------------------------------------------- runner


class _Submission:
    __slots__ = ("work", "leaves", "op", "timeout_ms", "bucket_bytes",
                 "out", "results", "remaining", "on_bucket", "ready")

    def __init__(self, work: CollectiveWork, leaves: List[Any],
                 op: ReduceOp, timeout_ms: int, bucket_bytes: int,
                 out: Optional[Sequence[np.ndarray]],
                 on_bucket=None, ready=None):
        self.work = work
        self.leaves = leaves
        self.op = op
        self.timeout_ms = timeout_ms
        self.bucket_bytes = bucket_bytes
        self.out = out
        self.on_bucket = on_bucket  # per-bucket completion callback
        self.ready = ready  # CUDA event on the caller's stream at submit
        self.results: List[Optional[np.ndarray]] = [None] * len(leaves)
        self.remaining = 0  # buckets still to reduce (set by the mover)


class _BucketTask:
    __slots__ = ("sub", "staging", "meta", "scale")

    def __init__(self, sub: _Submission, staging: np.ndarray,
                 meta: List[Tuple[int, tuple, int]], scale: Optional[float]):
        self.sub = sub
        self.staging = staging
        self.meta = meta  # (leaf index, shape, elements) per packed leaf
        self.scale = scale  # non-None: MEAN pre-scaled into the pack copy


class AsyncRunner:
    """Per-group two-stage pipeline executing async collective work.

    Submissions run strictly in submission order and buckets within a
    submission in reverse flatten order: every rank's transport sees the
    identical op sequence as long as ranks submit in the same order."""

    def __init__(self, group):
        self._group = group  # HostGroup
        try:
            from ray_tpu_torch._private.api import _require_core

            depth = max(1, int(
                _require_core().config.collective_overlap_depth))
        except Exception:
            depth = 2
        self.pool = StagingPool()
        self._subq: "queue.Queue" = queue.Queue()
        self._bucketq: "queue.Queue" = queue.Queue(maxsize=depth)
        self._lock = threading.Lock()
        self._idle = threading.Condition(self._lock)
        self._pending: List[_Submission] = []
        self._dead: Optional[str] = None
        self._streams: Dict[Any, Any] = {}  # card -> the mover's stream
        name = group.group_name
        self._mover = threading.Thread(
            target=self._mover_loop, daemon=True, name=f"col-mover-{name}")
        self._reducer = threading.Thread(
            target=self._reducer_loop, daemon=True,
            name=f"col-reduce-{name}")
        self._mover.start()
        self._reducer.start()

    # ------------------------------------------------------------- public

    def submit(self, tensors: Sequence[Any], op: ReduceOp, timeout_ms: int,
               bucket_bytes: int,
               out: Optional[Sequence[Any]],
               on_bucket=None) -> CollectiveWork:
        validate_on_bucket(on_bucket)
        leaves = [t if is_tensor(t) or isinstance(t, np.ndarray)
                  else np.asarray(t) for t in tensors]
        out_np = host_out(out)
        post = tensor_results(leaves) if out is None and any(
            is_tensor(t) for t in leaves) else None
        work = CollectiveWork(self._group._public_name, post=post)
        if not leaves:
            work._finish([])
            return work
        validate_out(leaves, op, out_np, self._group.world_size)
        ready = None
        cuda = [t for t in leaves if is_tensor(t) and t.is_cuda]
        if cuda:
            import torch

            # the caller's stream may still be writing these gradients
            ready = torch.cuda.Event()
            ready.record(torch.cuda.current_stream(cuda[0].device))
        sub = _Submission(work, leaves, op, timeout_ms, bucket_bytes, out_np,
                          on_bucket=on_bucket, ready=ready)
        if out is not None:
            sub.results = list(out)  # the caller's own objects come back
        with self._lock:
            if self._dead is not None:
                raise CollectiveError(
                    f"collective group {self._group._public_name!r} is "
                    f"poisoned by an earlier failure ({self._dead}); "
                    f"destroy and re-create the group")
            self._pending.append(sub)
        self._subq.put(sub)
        return work

    def flush(self, timeout_s: float) -> None:
        """Block until no async work is in flight (sync ops interleave
        AFTER the queue drains, so the transport op order stays identical
        on every rank). A poisoned runner returns immediately."""
        deadline = time.monotonic() + timeout_s
        with self._idle:
            while self._pending and self._dead is None:
                left = deadline - time.monotonic()
                if left <= 0:
                    raise TimeoutError(
                        f"collective group {self._group._public_name!r}: "
                        f"sync collective blocked {timeout_s:.1f}s behind "
                        f"unfinished async work")
                self._idle.wait(min(left, 0.5))

    def shutdown(self, reason: str = "group destroyed") -> None:
        """Fail every unfinished handle NOW and stop the threads. The
        caller destroys the transport right after, which unblocks a
        reducer parked mid-round."""
        self._fail_pending(CollectiveError(
            f"collective group {self._group._public_name!r}: {reason} "
            f"with collective work in flight"), mark_dead=reason)
        self._subq.put(_STOP)
        self.pool.drain()

    # ----------------------------------------------------------- internals

    def _fail_pending(self, exc: BaseException, mark_dead: str) -> None:
        with self._lock:
            if self._dead is None:
                self._dead = mark_dead
            pending, self._pending = self._pending, []
            self._idle.notify_all()
        for sub in pending:
            sub.work._fail(exc)

    def _poison(self, exc: BaseException) -> None:
        """A round failed: poison the GROUP (transport state may be out of
        step with peers) and fail every handle."""
        detail = f"{type(exc).__name__}: {exc}"
        self._group._poisoned = detail
        self._fail_pending(
            exc if isinstance(exc, (CollectiveError, TimeoutError))
            else CollectiveError(detail),
            mark_dead=detail)

    def _finish_bucket(self, sub: _Submission) -> None:
        sub.remaining -= 1
        if sub.remaining == 0:
            with self._lock:
                if sub in self._pending:
                    self._pending.remove(sub)
                self._idle.notify_all()
            sub.work._finish(sub.results)

    def _stream_for(self, leaf):
        if not (is_tensor(leaf) and leaf.is_cuda):
            return None
        import torch

        stream = self._streams.get(leaf.device)
        if stream is None:
            stream = self._streams[leaf.device] = torch.cuda.Stream(
                leaf.device)
        return stream

    def _mover_loop(self) -> None:
        while True:
            sub = self._subq.get()
            if sub is _STOP:
                self._bucketq.put(_STOP)
                return
            if self._dead is not None:
                continue  # already failed by poison/shutdown fan-out
            try:
                buckets = bucket_layout(sub.leaves, sub.bucket_bytes)
                sub.remaining = len(buckets)
                for bucket in reversed(buckets):
                    if self._dead is not None:
                        break
                    t0 = flight.now()
                    leaves = [sub.leaves[i] for i in bucket]
                    dtype = host_dtype(leaves[0])
                    total = sum(numel(a) for a in leaves)
                    scale = prescale_factor(
                        sub.op, dtype, self._group.world_size)
                    staging = self.pool.acquire(dtype, total)
                    pack_bucket(leaves, staging, scale,
                                stream=self._stream_for(leaves[0]),
                                ready=sub.ready)
                    meta = [(i, tuple(a.shape), numel(a))
                            for i, a in zip(bucket, leaves)]
                    self._bucketq.put(
                        _BucketTask(sub, staging, meta, scale))
                    # includes the handoff-queue wait: a full queue IS
                    # the mover stalling behind the reducer
                    flight.span_since(_F_MOVE, t0)
            except BaseException as e:  # noqa: BLE001 — fail loud + clean
                logger.debug("collective mover failed", exc_info=True)
                self._poison(e)

    def _reducer_loop(self) -> None:
        while True:
            task = self._bucketq.get()
            if task is _STOP:
                return
            if self._dead is not None:
                self.pool.release(task.staging)
                continue  # drain mode: unblock the mover, drop the work
            sub = task.sub
            try:
                t0 = flight.now()
                impl = self._group._impl_for(sub.timeout_ms)
                # MEAN was either pre-scaled into the pack (float dtypes)
                # or falls back to SUM + one divide at unpack
                op = ReduceOp.SUM if sub.op is ReduceOp.MEAN else sub.op
                red = np.asarray(impl.allreduce(
                    task.staging, op, sub.timeout_ms, out=task.staging))
                _metrics.overlap_rounds_total.inc(
                    labels=_metrics.labels(impl.algo))
                if sub.op is ReduceOp.MEAN and task.scale is None:
                    red = red / self._group.world_size  # integer mean
                off = 0
                for i, shape, size in task.meta:
                    seg = red[off:off + size]
                    if sub.out is not None:
                        np.copyto(sub.out[i], seg.reshape(shape))
                    else:
                        sub.results[i] = seg.reshape(shape).copy()
                    off += size
                if sub.on_bucket is not None:
                    # ON THIS THREAD, before the staging release: a raise
                    # falls to the handler below, which poisons the group
                    sub.on_bucket(
                        [i for i, _, _ in task.meta],
                        [sub.results[i] for i, _, _ in task.meta])
                self.pool.release(task.staging)
                flight.span_since(_F_REDUCE, t0)
                self._finish_bucket(sub)
            except BaseException as e:  # noqa: BLE001 — fail loud + clean
                logger.debug("collective reducer failed", exc_info=True)
                self.pool.release(task.staging)
                self._poison(e)
