"""Data iterators — the consumption boundary, including device ingest.

Analog of `ray.data.DataIterator` (`python/ray/data/iterator.py`) and the
stream-split iterator behind `streaming_split`
(`python/ray/data/_internal/iterator/stream_split_iterator.py`). The
card's path is `iter_device_batches`: numpy batches are staged in pinned
host memory and copied to the card on a stream of their own, `prefetch`
batches AHEAD of the consumer, so the host→HBM copy of batch k+1 overlaps
the step computing on batch k — the framework-level replacement for
plasma zero-copy into device memory.
"""

from __future__ import annotations

import queue
import threading
from collections import deque
from typing import Any, Dict, Iterator, List, Optional

import numpy as np

import ray_tpu_torch as rt
from ray_tpu_torch.data.block import Block, batches_from_blocks, block_rows


class DataIterator:
    """Abstract: subclasses provide _block_iter()."""

    def _block_iter(self) -> Iterator[Block]:
        raise NotImplementedError

    def _block_iter_windowed(self, window: int) -> Iterator[Block]:
        """Block stream with up to ``window`` fetches bound ahead.
        Subclasses that resolve refs override this to keep a window of
        gets in flight; the base just streams (prefetching then happens
        only at the batch level)."""
        return self._block_iter()

    def iter_batches(
        self,
        *,
        batch_size: Optional[int] = 256,
        batch_format: str = "numpy",
        drop_last: bool = False,
        prefetch_batches: int = 1,
        local_shuffle_buffer_size: Optional[int] = None,
        local_shuffle_seed: Optional[int] = None,
    ) -> Iterator[Any]:
        # prefetch overlaps at BOTH levels: block fetches are bound
        # ahead with a window (the consumer no longer eats a store
        # round-trip at every block boundary) and finished batches queue
        # through a background fill thread so a computing consumer finds
        # the next one ready
        if prefetch_batches and prefetch_batches > 0:
            blocks = self._block_iter_windowed(
                max(2, int(prefetch_batches)))
        else:
            blocks = self._block_iter()
        if local_shuffle_buffer_size:
            blocks = _shuffle_blocks(blocks, local_shuffle_buffer_size,
                                     local_shuffle_seed)
        batches = batches_from_blocks(blocks, batch_size, batch_format,
                                      drop_last)
        if prefetch_batches and prefetch_batches > 0:
            batches = _prefetch(batches, prefetch_batches)
        return batches

    def iter_rows(self) -> Iterator[Dict[str, Any]]:
        for block in self._block_iter():
            yield from block_rows(block)

    def iter_torch_batches(self, *, batch_size: Optional[int] = 256,
                           dtypes=None, device: str = "cpu",
                           **kw) -> Iterator[Dict[str, Any]]:
        import torch

        for batch in self.iter_batches(batch_size=batch_size,
                                       batch_format="numpy", **kw):
            yield {
                k: torch.as_tensor(
                    v, dtype=(dtypes.get(k) if isinstance(dtypes, dict)
                              else dtypes), device=device)
                for k, v in batch.items()
            }

    def iter_device_batches(
        self,
        *,
        batch_size: Optional[int] = 256,
        device=None,
        dtypes=None,
        prefetch: int = 2,
        **kw,
    ) -> "DeviceBatches":
        """Numpy batches → tensors on the card, `prefetch` batches ahead.

        ``device=None`` is the current CUDA device; with no CUDA it
        raises (it never falls back to the CPU). ``device`` may also be a
        dict column→device (a column it leaves out goes to the default).
        ``dtypes`` (one dtype, or a dict column→dtype) converts on the
        device; by default a column keeps its numpy dtype (int32 tokens
        stay int32). Each column is staged in pinned host memory and
        copied with ``non_blocking=True`` on the iterator's own copy
        stream, so the copy of batch k+prefetch overlaps the step on
        batch k; see `DeviceBatches`.
        """
        host = self.iter_batches(batch_size=batch_size,
                                 batch_format="numpy",
                                 prefetch_batches=0, **kw)
        return DeviceBatches(host, device=device, dtypes=dtypes,
                             prefetch=prefetch)

    def materialize(self):
        from ray_tpu_torch.data.dataset import _input_dataset

        return _input_dataset(list(self._block_iter())).materialize()


def _column_dtype(dtypes, key):
    return dtypes.get(key) if isinstance(dtypes, dict) else dtypes


class DeviceBatches:
    """Iterator of dicts of tensors on their devices (`iter_device_batches`).

    On a CUDA device each column goes through a ring of reused pinned
    host buffers (``prefetch + 1`` per column): the numpy batch is copied
    into a buffer, the buffer to the card with ``non_blocking=True`` on
    this iterator's copy stream, and an event is recorded after the copy.
    A buffer is reused only after the event of the copy that last read it
    has completed, so no copy reads a buffer that is being refilled.
    Before a batch is yielded the consumer's current stream waits on its
    event, and each tensor gets ``record_stream`` for that stream (the
    allocator then keeps its memory until the consumer's work on it is
    done). A column bound for the CPU is copied out of the host batch
    (which may be a read-only arena view).

    ``staging`` holds the pinned buffers (column → ring); ``copy_ms()``
    gives the CUDA copies' times and bytes from their events.
    """

    def __init__(self, host: Iterator[Dict[str, Any]], *, device=None,
                 dtypes=None, prefetch: int = 2):
        import torch

        if prefetch < 0:
            raise ValueError(f"prefetch={prefetch} must be >= 0")
        self._torch = torch
        self._host = host
        self._dtypes = dtypes
        self._prefetch = int(prefetch)
        self._default = device if not isinstance(device, dict) else None
        self._per_column = device if isinstance(device, dict) else {}
        self.staging: Dict[str, List[Any]] = {}
        self._slot_events: Dict[str, List[Any]] = {}
        self._streams: Dict[Any, Any] = {}
        # (start event, end event, bytes) of the latest CUDA column copies
        self._copies: "deque" = deque(maxlen=1024)
        self._n = 0

    def _device(self, key: str):
        torch = self._torch
        dev = self._per_column.get(key, self._default)
        if dev is None:
            if not torch.cuda.is_available():
                raise RuntimeError(
                    "iter_device_batches: no CUDA device, and no device= "
                    "was given (pass device='cpu' for host tensors)")
            return torch.device("cuda", torch.cuda.current_device())
        dev = torch.device(dev)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        return dev

    def _staged(self, key: str, arr: np.ndarray):
        """The ring slot for this batch's column, filled with ``arr``."""
        torch = self._torch
        ring = self.staging.setdefault(key, [None] * (self._prefetch + 1))
        events = self._slot_events.setdefault(key, [None] * len(ring))
        i = self._n % len(ring)
        if events[i] is not None:
            events[i].synchronize()  # the copy that last read this slot
            events[i] = None
        buf = ring[i]
        if buf is None or buf.numel() < arr.nbytes:
            buf = ring[i] = torch.empty(max(arr.nbytes, 1),
                                        dtype=torch.uint8, pin_memory=True)
        host = buf.numpy()[:arr.nbytes].view(arr.dtype).reshape(arr.shape)
        np.copyto(host, arr, casting="no")
        src = torch.from_numpy(host)
        return src, events, i

    def _batch(self, batch: Dict[str, Any]):
        torch = self._torch
        out, waits = {}, []
        for key, value in batch.items():
            arr = np.ascontiguousarray(value)
            dev = self._device(key)
            dtype = _column_dtype(self._dtypes, key)
            if dev.type != "cuda":
                out[key] = torch.tensor(arr, dtype=dtype, device=dev)
                continue
            src, events, i = self._staged(key, arr)
            stream = self._streams.get(dev)
            if stream is None:
                stream = self._streams[dev] = torch.cuda.Stream(device=dev)
            start = torch.cuda.Event(enable_timing=True)
            done = torch.cuda.Event(enable_timing=True)
            with torch.cuda.stream(stream):
                start.record(stream)
                t = src.to(dev, non_blocking=True)
                if dtype is not None:
                    t = t.to(dtype)
                done.record(stream)
            events[i] = done
            self._copies.append((start, done, arr.nbytes))
            out[key] = t
            waits.append((dev, t, done))
        self._n += 1
        return out, waits

    def __iter__(self) -> Iterator[Dict[str, Any]]:
        window: List[Any] = []
        for batch in self._host:
            window.append(self._batch(batch))
            if len(window) > self._prefetch:
                yield self._ready(window.pop(0))
        while window:
            yield self._ready(window.pop(0))

    def _ready(self, item):
        out, waits = item
        for dev, t, done in waits:
            consumer = self._torch.cuda.current_stream(dev)
            consumer.wait_event(done)
            t.record_stream(consumer)
        return out

    def copy_ms(self) -> List[Any]:
        """(ms, bytes) of the latest CUDA column copies (up to 1024), from
        their events."""
        for _, done, _ in self._copies:
            done.synchronize()
        return [(start.elapsed_time(done), n)
                for start, done, n in self._copies]


def _prefetch(it: Iterator[Any], depth: int) -> Iterator[Any]:
    q: "queue.Queue" = queue.Queue(maxsize=depth)
    _SENTINEL = object()
    err: List[BaseException] = []
    stop = threading.Event()

    def _put(x) -> bool:
        # bounded put that notices consumer abandonment — otherwise an
        # early-exiting consumer (take_batch, break in a train loop) leaks
        # this thread plus the upstream generator's in-flight window
        while not stop.is_set():
            try:
                q.put(x, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def fill():
        try:
            for x in it:
                if not _put(x):
                    return
        except BaseException as e:
            err.append(e)
        finally:
            _put(_SENTINEL)

    t = threading.Thread(target=fill, daemon=True)
    t.start()
    try:
        while True:
            x = q.get()
            if x is _SENTINEL:
                if err:
                    raise err[0]
                return
            yield x
    finally:
        stop.set()


def _shuffle_blocks(blocks: Iterator[Block], buffer_rows: int,
                    seed: Optional[int]) -> Iterator[Block]:
    """Windowed local shuffle (reference: local_shuffle_buffer_size)."""
    from ray_tpu_torch.data.block import concat_blocks, slice_block

    rng = np.random.default_rng(seed)
    buf: List[Block] = []
    rows = 0
    for b in blocks:
        buf.append(b)
        rows += b.num_rows
        if rows >= buffer_rows:
            merged = concat_blocks(buf)
            merged = merged.take(rng.permutation(merged.num_rows))
            emit = slice_block(merged, 0, merged.num_rows // 2)
            keep = slice_block(merged, merged.num_rows // 2, merged.num_rows)
            yield emit
            buf, rows = [keep], keep.num_rows
    if buf:
        merged = concat_blocks(buf)
        if merged.num_rows:
            yield merged.take(rng.permutation(merged.num_rows))


class _BlockStreamIterator(DataIterator):
    """Iterates a Dataset's own streaming execution (driver-side)."""

    def __init__(self, ds):
        self._ds = ds

    def _block_iter(self) -> Iterator[Block]:
        for ref, _meta in self._ds._stream():
            yield rt.get(ref)

    def _block_iter_windowed(self, window: int) -> Iterator[Block]:
        """Bound-ahead block resolution: pull up to ``window`` refs from
        the task stream (which also drives task submission ahead) and
        resolve them in ONE batched get — the batched-locate path
        (one store_locate_batch RPC per node per window instead of a
        locate round-trip per block). The per-block boundary stall the
        synchronous pull paid collapses into one amortized wait per
        window, hidden by the batch-level fill thread."""

        pend: deque = deque()
        for ref, _meta in self._ds._stream():
            pend.append(ref)
            if len(pend) >= window:
                for b in rt.get(list(pend)):
                    yield b
                pend.clear()
        if pend:
            yield from rt.get(list(pend))


class _SplitCoordinator:
    """Actor: runs ONE streaming execution, hands blocks to n consumers
    first-come-first-served (reference: SplitCoordinator in
    `stream_split_iterator.py`)."""

    def __init__(self, ops, concurrency, n: int = 1, equal: bool = False):
        from ray_tpu_torch.data._internal.executor import execute_plan

        self._ops = ops
        self._concurrency = concurrency
        # generation = which pass over the dataset the current stream
        # serves; consumers name the pass they want, and a restart happens
        # only when EVERY rank has moved past the drained generation (so a
        # late-starting rank's first pass still reads the original stream).
        self._generation = 1
        self._rank_epochs: Dict[int, int] = {}
        self._gen = execute_plan(ops, concurrency)
        self._done = False
        self._equal = equal
        self._n = n
        # equal mode: blocks are dealt round-robin by arrival index so every
        # consumer sees the same block count (±1) — lockstep SPMD loops with
        # per-batch collectives need matching iteration counts.
        self._buffers: Dict[int, List[Any]] = {i: [] for i in range(n)}
        # Handed-out refs are pinned here (as (ref, generation)) until
        # the consumer acks having read the block — returning a ref from
        # an actor method drops the actor's local reference, and without
        # the pin the owner could GC the block before the consumer's get
        # lands. The generation tag lets requeue() drop a stale return.
        self._pinned = {}
        # Blocks a consumer handed back unread (a prefetch lookahead
        # abandoned on early exit): served to the next requester before
        # the stream is pulled, so sibling ranks' epoch stays complete.
        # Cleared on epoch restart — the fresh execution re-reads every
        # block, so serving a stale one would duplicate its rows.
        self._returned: List[Any] = []
        self._deal_idx = 0  # arrival index for equal-mode round-robin
        self._next_token = 0

    def next_block_ref(self, rank: int = 0, epoch: int = 1):
        # Re-iterable shards (reference: StreamSplitDataIterator re-executes
        # per epoch): restart the execution for epoch e only once the
        # current stream is drained and all n ranks have asked for >= e.
        self._rank_epochs[rank % self._n] = epoch
        if (epoch > self._generation and self._done
                and not any(self._buffers.values())
                and len(self._rank_epochs) == self._n
                and all(e >= epoch for e in self._rank_epochs.values())):
            from ray_tpu_torch.data._internal.executor import execute_plan

            self._generation = epoch
            self._gen = execute_plan(self._ops, self._concurrency)
            self._done = False
            # stranded returns belong to the superseded pass (every rank
            # moved on, nobody will drain them) and the fresh execution
            # re-produces those blocks — keeping them would either hang
            # the restart or duplicate their rows into this epoch
            self._returned.clear()
        if epoch > self._generation:
            # stream for this epoch not open yet (other ranks still on the
            # previous pass) — caller polls again
            return "PENDING"
        ref = None
        if self._returned:
            ref = self._returned.pop(0)
        elif self._equal:
            buf = self._buffers[rank % self._n]
            while not buf and not self._done:
                try:
                    r, _meta = next(self._gen)
                    self._buffers[self._deal_idx % self._n].append(r)
                    self._deal_idx += 1
                except StopIteration:
                    self._done = True
            if buf:
                ref = buf.pop(0)
        else:
            if not self._done:
                try:
                    ref, _meta = next(self._gen)
                except StopIteration:
                    self._done = True
        if ref is None:
            return None
        token = self._next_token
        self._next_token += 1
        self._pinned[token] = (ref, self._generation)
        return token, ref

    def release(self, token: int) -> None:
        self._pinned.pop(token, None)

    def requeue(self, token: int) -> None:
        """Hand an UNREAD block back (an abandoned prefetch lookahead):
        it goes to the front of the stream for the next requester —
        release() would silently drop its rows from the epoch. A return
        landing after the stream restarted for a newer epoch is DROPPED:
        the new execution re-reads that block, so serving the stale one
        would duplicate its rows."""
        entry = self._pinned.pop(token, None)
        if entry is not None and entry[1] == self._generation:
            self._returned.append(entry[0])


class _ExchangeSplitIterator(DataIterator):
    """One rank of a streaming-split over the all-to-all exchange
    (`data/_internal/exchange.py`): this iterator reads its own
    consumer's output channel — deterministic partition-assigned
    splits (rank c gets exactly the rows
    ``exchange_assignments(...) == c``, exact vs the task baseline at
    the same seed), where the coordinator-fed split is
    first-come-first-served. Each ``iter_batches``/``_block_iter`` call
    consumes the NEXT epoch of the shared executor (built with
    ``epochs=``); ``close()`` tears the whole mesh down for every rank
    (the executor is shared)."""

    def __init__(self, executor, rank: int):
        self._ex = executor
        self._rank = rank

    @property
    def executor(self):
        return self._ex

    def _block_iter(self) -> Iterator[Block]:
        from ray_tpu_torch.data.block import batch_to_block

        for b in self._ex.rank_epoch(self._rank):
            yield batch_to_block(b)

    def stats(self) -> List[dict]:
        return self._ex.rank_epoch_stats(self._rank)

    def close(self) -> None:
        self._ex.shutdown()


class _StreamSplitIterator(DataIterator):
    def __init__(self, coordinator, rank: int):
        self._coord = coordinator
        self._rank = rank
        self._epoch = 0

    def _block_iter(self) -> Iterator[Block]:
        import time as _time

        self._epoch += 1
        epoch = self._epoch
        while True:
            out = rt.get(
                self._coord.next_block_ref.remote(self._rank, epoch))
            if out is None:
                return
            if out == "PENDING":
                _time.sleep(0.02)
                continue
            token, ref = out
            block = rt.get(ref)
            self._coord.release.remote(token)  # fire-and-forget unpin
            yield block

    def _block_iter_windowed(self, window: int) -> Iterator[Block]:
        """One-ahead pipelining of the coordinator round-trip: the NEXT
        block assignment is requested before the current block is
        fetched, so the two serial RPCs the synchronous pull paid per
        block (assignment + get) overlap with the consumer. Assignment
        order is unchanged — this rank just holds one extra block, which
        is drained (and its pin released) if the consumer stops early."""
        import time as _time

        self._epoch += 1
        epoch = self._epoch
        fut = self._coord.next_block_ref.remote(self._rank, epoch)
        try:
            while True:
                out = rt.get(fut)
                fut = None
                if out is None:
                    return
                if out == "PENDING":
                    _time.sleep(0.02)
                    fut = self._coord.next_block_ref.remote(
                        self._rank, epoch)
                    continue
                token, ref = out
                fut = self._coord.next_block_ref.remote(self._rank, epoch)
                block = rt.get(ref)
                self._coord.release.remote(token)  # fire-and-forget unpin
                yield block
        finally:
            if fut is not None:
                # drain the lookahead so an early-exiting consumer never
                # strands its assigned block: requeue hands the UNREAD
                # block back to the coordinator for a sibling rank
                # (release would silently shrink the shared epoch)
                try:
                    out = rt.get(fut, timeout=30)
                    if isinstance(out, tuple):
                        self._coord.requeue.remote(out[0])
                except Exception:
                    pass
