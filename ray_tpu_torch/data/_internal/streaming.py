"""Streaming data plane: compiled ingest pipelines over channels.

The task-based executor (`executor.py`) moves every block through
task-by-task object-store hops: per block, a task submission RPC, a store
put, a locate + get round trip — a control/data-plane cost that scales
with the block count and stalls a fast consumer at every boundary. This
module rebuilds ingest the way `train.PipelineTrainer` rebuilt training:
a fixed stage graph of long-lived actors connected by depth-k slot-ring
channels (`_private/channels.py`'s seqlock protocol), planned once at
build time, streaming thereafter with ZERO steady-state control-plane
RPCs per stage and per consumer (counter-proven via the
``ray_tpu_rpc_client_calls_total`` deltas each epoch report carries).

Topology::

    R shard readers --> R transform actors --> 1 batcher --> consumer
        (lazy read tasks)   (fused map chain)    (shuffle+batch)

* every edge is one channel placed on the READER's node: same-node hops
  are zero-copy arena seqlock ops, cross-node hops are chunked mirror
  pushes (the object transfer's bounded window);
* channel depth = the prefetch bound: a stage can run at most ``depth``
  blocks/batches ahead of its consumer — writer backpressure IS the
  prefetch limit (``RAY_TPU_TORCH_DATA_STREAM_DEPTH``);
* the batcher re-chunks blocks into FIXED-SHAPE batches (optionally
  through a seeded windowed shuffle buffer) and commits them into the
  consumer channel; ``Dataset.stream_batches`` / ``iter_batches(
  streaming=True)`` is one channel read per batch.

Epoch semantics: the shard (read-task) order is re-seeded per epoch —
``epoch_order(T, seed, epoch)`` — and every participant derives it
locally, so an epoch boundary costs zero control messages. Reader r
executes ``order[r::R]`` in order and the batcher interleaves its
upstreams round-robin, which reconstructs the global order EXACTLY; the
windowed shuffle + fixed-shape batching then run through the SAME code
(`epoch_batch_stream`) the task-based baseline uses, so a streaming
epoch is batch-for-batch, bit-for-bit identical to the task loader's at
the same seed — shuffled or not. ``task_epoch_batches`` IS that
baseline (real remote read/transform tasks through the object store —
the ``algo="kv"`` idiom: a measured comparison target, never a silent
fallback; streaming build failures raise).

Failure semantics follow the house pattern: teardown or ANY
participant's death closes every channel (supervisor participant
registry + driver-side actor-state subscription), blocked peers raise
``ChannelClosedError`` instead of hanging, pins return to baseline, and
a partially-consumed epoch surfaces a clean error — never a silently
truncated epoch.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import threading
import time
from typing import Any, Callable, Dict, Iterator, List, Optional, Sequence

import numpy as np

from ray_tpu_torch._private import channels as _channels
from ray_tpu_torch._private import chaos, flight, serialization
from ray_tpu_torch._private.exceptions import ChannelClosedError
from ray_tpu_torch._private.metrics import Counter, Gauge

logger = logging.getLogger(__name__)

# flight-recorder span ids for the ingest hot loop (per-thread ring
# records — no locks, no RPCs, so the zero-RPC proofs hold recorder-on)
_F_READ = flight.intern("data.read")
_F_TRANSFORM = flight.intern("data.transform")
_F_BATCH = flight.intern("data.batch")
_F_STALL = flight.intern("data.stall")

_m_blocks = Counter(
    "ray_tpu_data_blocks_read_total",
    "Streaming data plane: blocks produced by shard readers")
_m_batches = Counter(
    "ray_tpu_data_batches_out_total",
    "Streaming data plane: fixed-shape batches committed by the batcher")
_m_stall = Counter(
    "ray_tpu_data_stall_seconds_total",
    "Streaming data plane: seconds the consumer spent blocked waiting "
    "for the next batch (input-bound time, measured not estimated)")
_m_depth = Gauge(
    "ray_tpu_data_stream_depth",
    "Slot-ring depth (prefetch bound) of the most recently built live "
    "streaming pipeline; 0 when none is live in this process")

# live-executor accounting behind the gauge: last build wins while any
# pipeline lives, and the gauge drops to 0 when the last one tears down
_live_lock = threading.Lock()
_live_executors = 0


def _require_positive(name: str, value, kind=int):
    """Explicit zeros (and negatives) RAISE instead of falling through a
    falsy-``or`` chain to a default: depth=0 never means the default."""
    if value is None:
        raise ValueError(f"{name} must be set")
    v = kind(value)
    if v <= 0:
        raise ValueError(
            f"{name} must be a positive {kind.__name__}, got {value!r} "
            f"(explicit zeros are rejected, never silently replaced "
            f"with a default)")
    return v


def _env_stream_depth(config) -> int:
    """Stream depth from config, rejecting an explicit env zero loudly
    (``Config.from_env`` would otherwise hand the 0 straight through and
    ``channel_create`` would reject it with a far less useful error)."""
    raw = os.environ.get("RAY_TPU_TORCH_DATA_STREAM_DEPTH")
    if raw is not None and int(raw) <= 0:
        raise ValueError(
            f"RAY_TPU_TORCH_DATA_STREAM_DEPTH={raw!r}: explicit zeros are "
            f"rejected (unset the var for the default)")
    return _require_positive("data_stream_depth", config.data_stream_depth)


def _default_shuffle(config) -> Optional[int]:
    """Default shuffle-buffer rows from ``Config.data_shuffle_buffer``
    (so programmatic ``_system_config`` overrides work like every other
    knob): 0 -> None (no shuffle, the field default), positive -> that
    many rows — but an EXPLICIT ``RAY_TPU_TORCH_DATA_SHUFFLE_BUFFER=0`` env
    raises rather than silently meaning "off"."""
    raw = os.environ.get("RAY_TPU_TORCH_DATA_SHUFFLE_BUFFER")
    if raw is not None and int(raw) <= 0:
        raise ValueError(
            f"RAY_TPU_TORCH_DATA_SHUFFLE_BUFFER={raw!r}: explicit zeros are "
            f"rejected (unset the var to disable the shuffle)")
    rows = int(config.data_shuffle_buffer)
    if rows < 0:
        raise ValueError(
            f"data_shuffle_buffer must be >= 0, got {rows}")
    return rows or None


def quiesce_driver_rpcs(timeout_s: float = 5.0) -> None:
    """Drain the driver's background housekeeping traffic before a
    zero-RPC assertion window: zero-copy views from earlier task-path
    work release their pins via GC finalizers -> batched unpin RPCs, and
    the owner ships its task events in batches of 100, so a batch that
    late completions of earlier work fill would ship inside the window.
    Either would otherwise trickle into the consumer's process-wide
    rpc-counter delta and read as steady-state traffic."""
    import gc

    from ray_tpu_torch._private import api

    core = api._require_core()
    gc.collect()
    core.flush_task_events()
    deadline = time.monotonic() + timeout_s
    while (core._unpin_queue or core._unpin_flushing) \
            and time.monotonic() < deadline:
        time.sleep(0.02)


# ------------------------------------------------------- epoch determinism


def epoch_order(num_shards: int, seed: Optional[int],
                epoch: int) -> np.ndarray:
    """The shard (read-task) order of one epoch: a permutation re-seeded
    per (seed, epoch), derived locally by every stage — an epoch boundary
    needs no control message. ``seed=None`` keeps the plan order every
    epoch (the task executor's order)."""
    if seed is None:
        return np.arange(num_shards)
    rng = np.random.default_rng([int(seed) & 0x7FFFFFFF, 0x5EED, int(epoch)])
    return rng.permutation(num_shards)


def shuffle_rng(seed: Optional[int], epoch: int,
                rank: int = 0) -> np.random.Generator:
    """The windowed-shuffle RNG of one epoch — shared by the batcher
    stage and the task-based baseline so shuffled epochs stay
    batch-for-batch identical. An explicit seed is REQUIRED: silently
    substituting a fixed seed would make every "unseeded" run's shuffle
    bit-identical across restarts (worse than no shuffle entropy), and
    substituting fresh entropy would break the streaming/task parity
    contract.

    ``rank``: the exchange's per-consumer stream index — each consumer
    rank draws an independent rng stream. rank 0 keeps the original key
    (single-batcher sequences are unchanged)."""
    if seed is None:
        raise ValueError(
            "the windowed shuffle buffer needs an explicit seed "
            "(pass seed=/local_shuffle_seed=; the shuffle is derived "
            "per-epoch from (seed, epoch))")
    key = [int(seed) & 0x7FFFFFFF, 0xBA7C, int(epoch)]
    if rank:
        key.append(int(rank))
    return np.random.default_rng(key)


# --------------------------------------------- numpy-batch stream plumbing


def _np_rows(batch: Dict[str, np.ndarray]) -> int:
    for v in batch.values():
        return len(v)
    return 0


def _np_concat(batches: List[Dict[str, np.ndarray]]) -> Dict[str, np.ndarray]:
    if len(batches) == 1:
        return batches[0]
    keys = batches[0].keys()
    return {k: np.concatenate([b[k] for b in batches]) for k in keys}


def _np_slice(batch: Dict[str, np.ndarray], lo: int,
              hi: int) -> Dict[str, np.ndarray]:
    return {k: v[lo:hi] for k, v in batch.items()}


def _np_take(batch: Dict[str, np.ndarray], idx) -> Dict[str, np.ndarray]:
    return {k: v[idx] for k, v in batch.items()}


def _shuffle_np_stream(blocks: Iterator[Dict[str, np.ndarray]],
                       buffer_rows: int,
                       rng: np.random.Generator
                       ) -> Iterator[Dict[str, np.ndarray]]:
    """Windowed shuffle over numpy-dict blocks — the `_shuffle_blocks`
    schedule (fill to buffer_rows, permute, emit half, keep half) with
    the SAME rng draw sequence on both the streaming batcher and the
    task baseline."""
    buf: List[Dict[str, np.ndarray]] = []
    rows = 0
    for b in blocks:
        buf.append(b)
        rows += _np_rows(b)
        if rows >= buffer_rows:
            merged = _np_take(_np_concat(buf), rng.permutation(rows))
            half = rows // 2
            yield _np_slice(merged, 0, half)
            buf, rows = [_np_slice(merged, half, rows)], rows - half
    if buf:
        merged = _np_concat(buf)
        n = _np_rows(merged)
        if n:
            yield _np_take(merged, rng.permutation(n))


def epoch_batch_stream(blocks: Iterator[Dict[str, np.ndarray]], *,
                       batch_size: int,
                       shuffle_buffer: Optional[int] = None,
                       rng: Optional[np.random.Generator] = None,
                       drop_last: bool = False
                       ) -> Iterator[Dict[str, np.ndarray]]:
    """Numpy-dict blocks -> fixed-shape ``batch_size``-row batches,
    optionally through the windowed shuffle. The ONE implementation both
    the streaming batcher stage and the task-based baseline run, so
    exact batch parity holds by construction."""
    if shuffle_buffer:
        if rng is None:
            raise ValueError("shuffle_buffer needs a seeded rng")
        blocks = _shuffle_np_stream(blocks, int(shuffle_buffer), rng)
    carry: List[Dict[str, np.ndarray]] = []
    rows = 0
    for b in blocks:
        n = _np_rows(b)
        if n == 0:
            continue
        carry.append(b)
        rows += n
        while rows >= batch_size:
            merged = _np_concat(carry)
            yield _np_slice(merged, 0, batch_size)
            carry = [_np_slice(merged, batch_size, rows)]
            rows -= batch_size
    if rows > 0 and not drop_last:
        yield _np_concat(carry)


def _copy_batch(batch):
    """Deep-copy ndarray leaves out of the shared arena so the channel
    can be acked while the value lives on (the pipeline loop's rule)."""
    if isinstance(batch, np.ndarray):
        return np.array(batch)
    if isinstance(batch, dict):
        return {k: _copy_batch(v) for k, v in batch.items()}
    if isinstance(batch, (list, tuple)):
        return type(batch)(_copy_batch(v) for v in batch)
    return batch


# -------------------------------------------------------- plan validation


def split_streamable_plan(ops):
    """(read_tasks, fused_transform_or_None) of a streamable plan.

    Streaming executes read -> map chains (the ingest shape); plans that
    need a barrier or pre-materialized refs raise with a pointer at the
    task-based executor — never a silent fallback."""
    from ray_tpu_torch.data._internal import logical as L

    if not ops:
        raise ValueError("empty plan")
    src = ops[0]
    if not isinstance(src, L.Read):
        raise ValueError(
            f"streaming execution needs a lazy Read source "
            f"(ray_tpu_torch.data.range / read_parquet / ...), got "
            f"{type(src).__name__}; materialized datasets run on the "
            f"task-based executor (iter_batches without streaming=True)")
    transforms = []
    for op in ops[1:]:
        if isinstance(op, L.OneToOne):
            transforms.append(op.transform)
        else:
            raise ValueError(
                f"streaming execution supports read->map chains only; "
                f"{type(op).__name__} is a barrier/stateful op — use the "
                f"task-based executor (iter_batches without "
                f"streaming=True)")
    tasks = list(src.read_tasks)
    if not tasks:
        raise ValueError("streaming execution needs >= 1 read task")
    fused = L.fuse_transforms(transforms) if transforms else None
    return tasks, fused


# --------------------------------------------------- task-based baseline


def task_epoch_batches(ops, *, batch_size: int, epoch: int = 1,
                       seed: Optional[int] = 0,
                       shuffle_buffer: Optional[int] = None,
                       drop_last: bool = False,
                       concurrency: int = 8
                       ) -> Iterator[Dict[str, np.ndarray]]:
    """One epoch through the TASK-BASED loader at the streaming plane's
    exact epoch semantics: the epoch's shard order re-applied to the
    read tasks, real remote read+transform tasks through the object
    store (the windowed task executor), then the SAME shuffle+batch
    stream. This is the measured baseline of the
    ``data_stream_speedup`` probe and the parity reference of the
    streaming tests/chaos soak — same seed => same batches, exactly."""
    import ray_tpu_torch as rt
    from ray_tpu_torch.data._internal import logical as L
    from ray_tpu_torch.data._internal.executor import execute_plan
    from ray_tpu_torch.data.block import block_to_batch

    tasks, fused = split_streamable_plan(ops)
    order = epoch_order(len(tasks), seed, epoch)
    plan: List[Any] = [L.Read(read_tasks=[tasks[int(i)] for i in order],
                              datasource_name="epoch")]
    if fused is not None:
        plan.append(L.OneToOne(fused, label="epoch_map"))

    def np_blocks():
        for ref, _meta in execute_plan(plan, concurrency):
            nb = block_to_batch(rt.get(ref), "numpy")
            if _np_rows(nb):
                yield nb

    rng = shuffle_rng(seed, epoch) if shuffle_buffer else None
    yield from epoch_batch_stream(
        np_blocks(), batch_size=batch_size, shuffle_buffer=shuffle_buffer,
        rng=rng, drop_last=drop_last)


# ------------------------------------------------------------------ plans


@dataclasses.dataclass
class _ReaderPlan:
    out_spec: _channels.ChannelSpec
    rank: int
    num_readers: int
    num_tasks: int
    seed: Optional[int]
    epochs: int
    send_numpy: bool  # no transform stage: convert blocks reader-side


@dataclasses.dataclass
class _TransformPlan:
    in_spec: _channels.ChannelSpec
    out_spec: _channels.ChannelSpec
    epochs: int


@dataclasses.dataclass
class _BatcherPlan:
    in_specs: List[_channels.ChannelSpec]
    out_spec: _channels.ChannelSpec
    num_tasks: int
    seed: Optional[int]
    epochs: int
    batch_size: int
    shuffle_buffer: Optional[int]
    drop_last: bool


# ------------------------------------------------------- stage actor loops


class _StreamReaderImpl:
    """Shard-reader actor: owns the full read-task list (assignments are
    re-derived per epoch from the seeded order) and streams its shard's
    blocks into one channel — the object store never sees a block."""

    def __init__(self, tasks):
        self._tasks = list(tasks)

    def ping(self) -> str:
        return "ok"

    def probe_sizes(self, transform, batch_size: int,
                    sample: int = 3) -> dict:
        """Packed payload sizes off a few sample tasks so the driver can
        size fixed-shape channels at build — an undersized buffer then
        can only be a loud build/step error, never silent corruption."""
        from ray_tpu_torch.data.block import block_to_batch

        T = len(self._tasks)
        idx = sorted({0, T // 2, T - 1})[:max(1, int(sample))]
        block_b = np_b = row_b = 1
        for i in idx:
            block = self._tasks[i]()
            out = transform(block) if transform is not None else block
            nb = block_to_batch(out, "numpy")
            block_b = max(block_b, len(serialization.pack({"b": block})))
            np_payload = len(serialization.pack({"b": nb}))
            np_b = max(np_b, np_payload)
            row_b = max(row_b, np_payload // max(1, out.num_rows))
        return {"block_bytes": block_b, "np_bytes": np_b,
                "row_bytes": row_b}

    def run_loop(self, plan: _ReaderPlan) -> dict:
        from ray_tpu_torch._private import api, rpc
        from ray_tpu_torch.data.block import block_to_batch

        core = api._core
        if core is None:
            raise RuntimeError("stream reader loop outside a worker")
        open_local, local, release_pins = _channels.open_local_factory(core)
        remote_specs: List[_channels.ChannelSpec] = []
        try:
            out = _channels.VersionedWriter(core, plan.out_spec, open_local)
            if not out.is_local:
                remote_specs.append(plan.out_spec)
        except BaseException:
            release_pins()
            raise

        def close_everything() -> None:
            _channels.close_channels_nowait(
                core, local.values(), remote_specs)

        n = 0  # messages committed (version 2n)
        total = 0
        prev_rpc = rpc._m_client_calls.total()
        try:
            for epoch in range(1, plan.epochs + 1):
                order = epoch_order(plan.num_tasks, plan.seed, epoch)
                mine = order[plan.rank::plan.num_readers]
                blocks = 0
                for t in mine:
                    chaos.maybe_crash("worker.data_stream")
                    t0 = flight.now()
                    block = self._tasks[int(t)]()
                    flight.span_since(_F_READ, t0)
                    payload = serialization.pack(
                        {"b": (block_to_batch(block, "numpy")
                               if plan.send_numpy else block)})
                    n += 1
                    out.write(payload, 2 * n)
                    _m_blocks.inc()
                    blocks += 1
                total += blocks
                now = rpc._m_client_calls.total()
                n += 1
                out.write(serialization.pack({
                    "eof": epoch,
                    "stats": [{"role": "reader", "rank": plan.rank,
                               "epoch": epoch, "blocks": blocks,
                               "rpc_calls": now - prev_rpc}],
                }), 2 * n)
                prev_rpc = now
            return {"blocks": total, "epochs": plan.epochs}
        except ChannelClosedError:
            # teardown (or a peer's death) closed the channels mid-epoch;
            # re-fan the close so every peer unwinds
            try:
                close_everything()
            except Exception:
                logger.exception("reader close-on-exit failed")
            return {"blocks": total, "closed": True}
        except BaseException:
            try:
                close_everything()
            except Exception:
                logger.exception("reader close-on-error failed")
            raise
        finally:
            release_pins()


class _StreamTransformImpl:
    """Transform actor: applies the plan's fused map chain block by
    block (zero-copy views in, one packed write out — inputs acked only
    after the output is committed)."""

    def __init__(self, transform):
        self._transform = transform

    def ping(self) -> str:
        return "ok"

    def run_loop(self, plan: _TransformPlan) -> dict:
        from ray_tpu_torch._private import api, rpc
        from ray_tpu_torch.data.block import block_to_batch

        core = api._core
        if core is None:
            raise RuntimeError("stream transform loop outside a worker")
        open_local, local, release_pins = _channels.open_local_factory(core)
        remote_specs: List[_channels.ChannelSpec] = []
        try:
            in_ch = open_local(plan.in_spec)
            out = _channels.VersionedWriter(core, plan.out_spec, open_local)
            if not out.is_local:
                remote_specs.append(plan.out_spec)
        except BaseException:
            release_pins()
            raise

        def close_everything() -> None:
            _channels.close_channels_nowait(
                core, local.values(), remote_specs)

        n = 0
        blocks = 0
        prev_rpc = rpc._m_client_calls.total()
        epochs_done = 0
        try:
            while True:
                n += 1
                view = in_ch.read(2 * n)
                msg = serialization.unpack(view)
                if "eof" in msg:
                    # eof payloads are in-band (ints/strs) — safe to use
                    # after the ack below
                    epoch = msg["eof"]
                    stats = list(msg["stats"])
                    del msg, view
                    in_ch.ack(0, 2 * n)
                    now = rpc._m_client_calls.total()
                    stats.append({"role": "transform", "epoch": epoch,
                                  "blocks": blocks,
                                  "rpc_calls": now - prev_rpc})
                    prev_rpc = now
                    out.write(serialization.pack(
                        {"eof": epoch, "stats": stats}), 2 * n)
                    blocks = 0
                    epochs_done += 1
                    if epoch >= plan.epochs:
                        return {"epochs": epochs_done}
                    continue
                t0 = flight.now()
                result = self._transform(msg["b"])
                payload = serialization.pack(
                    {"b": block_to_batch(result, "numpy")})
                flight.span_since(_F_TRANSFORM, t0)
                del result, msg, view
                out.write(payload, 2 * n)
                in_ch.ack(0, 2 * n)
                blocks += 1
        except ChannelClosedError:
            try:
                close_everything()
            except Exception:
                logger.exception("transform close-on-exit failed")
            return {"epochs": epochs_done, "closed": True}
        except BaseException:
            try:
                close_everything()
            except Exception:
                logger.exception("transform close-on-error failed")
            raise
        finally:
            release_pins()


class _StreamBatcherImpl:
    """Batcher actor: interleaves its upstreams round-robin (which
    reconstructs the epoch's global shard order exactly), runs the
    shared windowed-shuffle + fixed-shape batch stream, and commits one
    batch per channel write to the consumer."""

    def ping(self) -> str:
        return "ok"

    def run_loop(self, plan: _BatcherPlan) -> dict:
        from ray_tpu_torch._private import api, rpc

        core = api._core
        if core is None:
            raise RuntimeError("stream batcher loop outside a worker")
        open_local, local, release_pins = _channels.open_local_factory(core)
        remote_specs: List[_channels.ChannelSpec] = []
        try:
            in_chs = [open_local(s) for s in plan.in_specs]
            out = _channels.VersionedWriter(core, plan.out_spec, open_local)
            if not out.is_local:
                remote_specs.append(plan.out_spec)
        except BaseException:
            release_pins()
            raise

        def close_everything() -> None:
            _channels.close_channels_nowait(
                core, local.values(), remote_specs)

        R = len(in_chs)
        reads = [0] * R  # per-upstream message count
        m = 0  # downstream messages committed
        total_batches = 0
        prev_rpc = rpc._m_client_calls.total()
        try:
            for epoch in range(1, plan.epochs + 1):
                stage_stats: List[dict] = []
                blocks_in = 0

                def np_blocks():
                    nonlocal blocks_in
                    # block i of the global order came from reader i % R:
                    # round-robin reads reconstruct the order exactly
                    for i in range(plan.num_tasks):
                        chaos.maybe_crash("worker.data_stream")
                        r = i % R
                        reads[r] += 1
                        view = in_chs[r].read(2 * reads[r])
                        msg = serialization.unpack(view)
                        b = _copy_batch(msg["b"])  # one memcpy, then ack
                        del msg, view
                        in_chs[r].ack(0, 2 * reads[r])
                        blocks_in += 1
                        if _np_rows(b):
                            yield b
                    for r in range(R):
                        reads[r] += 1
                        view = in_chs[r].read(2 * reads[r])
                        msg = serialization.unpack(bytes(view))
                        del view
                        in_chs[r].ack(0, 2 * reads[r])
                        stage_stats.extend(msg["stats"])

                rng = (shuffle_rng(plan.seed, epoch)
                       if plan.shuffle_buffer else None)
                batches = 0
                for batch in epoch_batch_stream(
                        np_blocks(), batch_size=plan.batch_size,
                        shuffle_buffer=plan.shuffle_buffer, rng=rng,
                        drop_last=plan.drop_last):
                    t0 = flight.now()
                    m += 1
                    out.write(serialization.pack({"b": batch}), 2 * m)
                    flight.span_since(_F_BATCH, t0)
                    _m_batches.inc()
                    batches += 1
                total_batches += batches
                now = rpc._m_client_calls.total()
                stage_stats.append({"role": "batcher", "epoch": epoch,
                                    "blocks": blocks_in,
                                    "batches": batches,
                                    "rpc_calls": now - prev_rpc})
                prev_rpc = now
                m += 1
                out.write(serialization.pack({
                    "eof": epoch, "batches": batches,
                    "stats": stage_stats}), 2 * m)
            return {"batches": total_batches, "epochs": plan.epochs}
        except ChannelClosedError:
            try:
                close_everything()
            except Exception:
                logger.exception("batcher close-on-exit failed")
            return {"batches": total_batches, "closed": True}
        except BaseException:
            try:
                close_everything()
            except Exception:
                logger.exception("batcher close-on-error failed")
            raise
        finally:
            release_pins()


_reader_cls = _transform_cls = _batcher_cls = None


def _actor_classes():
    global _reader_cls, _transform_cls, _batcher_cls
    if _reader_cls is None:
        import ray_tpu_torch as rt

        _reader_cls = rt.remote(_StreamReaderImpl)
        _transform_cls = rt.remote(_StreamTransformImpl)
        _batcher_cls = rt.remote(_StreamBatcherImpl)
    return _reader_cls, _transform_cls, _batcher_cls


# --------------------------------------------------------------- executor


class StreamingExecutor:
    """Compiled streaming ingest pipeline (module docstring has the
    design)::

        ex = StreamingExecutor(ds._ops, batch_size=256, epochs=3, seed=0)
        for batch in ex.batches():   # numpy dicts, fixed shape
            ...
        ex.shutdown()                # (batches() exhaustion also shuts down)

    ``feed(step)`` hands each batch to a trainer step callable as
    read-only arena views (acked after the step returns) — the
    Data-feeds-Train composition without an extra copy.
    """

    def __init__(self, ops, *, batch_size: int, epochs: int = 1,
                 seed: Optional[int] = 0,
                 shuffle_buffer: Optional[int] = None,
                 num_readers: Optional[int] = None,
                 depth: Optional[int] = None,
                 drop_last: bool = False,
                 buffer_bytes: Optional[int] = None,
                 batch_buffer_bytes: Optional[int] = None,
                 reader_options: Optional[Sequence[dict]] = None,
                 transform_options: Optional[Sequence[dict]] = None,
                 batcher_options: Optional[dict] = None,
                 name: str = "data_stream"):
        import ray_tpu_torch as rt
        from ray_tpu_torch._private import api

        core = api._require_core()
        self._core = core
        if core.arena is None:
            raise RuntimeError(
                "streaming ingest needs a driver attached to a node arena")
        self._batch_size = _require_positive("batch_size", batch_size)
        self._epochs = _require_positive("epochs", epochs)
        self._seed = seed
        if shuffle_buffer is None:
            shuffle_buffer = _default_shuffle(core.config)
        elif int(shuffle_buffer) <= 0:
            raise ValueError(
                f"shuffle_buffer must be positive (got {shuffle_buffer!r}); "
                f"pass None to disable the windowed shuffle")
        self._shuffle = int(shuffle_buffer) if shuffle_buffer else None
        if self._shuffle and seed is None:
            # fail at build on the driver, not inside the batcher actor
            shuffle_rng(seed, 1)
        self._depth = (_require_positive("depth", depth)
                       if depth is not None
                       else _env_stream_depth(core.config))
        self._drop_last = bool(drop_last)
        self._tasks, self._transform = split_streamable_plan(ops)
        T = len(self._tasks)
        R = (min(4, T) if num_readers is None
             else _require_positive("num_readers", num_readers))
        self._R = R = min(R, T)
        self._T = T

        self._dead = False
        self._torn = False
        self._teardown_lock = threading.Lock()
        self._all_specs: List[_channels.ChannelSpec] = []
        self._local_channels: Dict[bytes, _channels.LocalChannel] = {}
        self._loop_refs: List[Any] = []
        self._actor_info: Dict[str, dict] = {}
        self._readers: List[Any] = []
        self._transforms: List[Any] = []
        self._batcher = None
        self._m = 0  # consumer messages read
        self._epoch_stats: List[dict] = []
        self._exhausted = False
        self._consuming = False

        reader_cls, transform_cls, batcher_cls = _actor_classes()

        def options_for(cls, opts, i=None):
            if isinstance(opts, dict):
                o = dict(opts)
            else:
                o = dict(opts[i]) if opts and i is not None \
                    and i < len(opts) and opts[i] else {}
            o.setdefault("num_cpus", 0.5)
            return cls.options(**o)

        # any mid-build failure unwinds through shutdown() — it kills
        # whatever was already created (ActorHandles have no GC-kill)
        try:
            self._readers = [
                options_for(reader_cls, reader_options, r).remote(
                    self._tasks)
                for r in range(R)]
            if self._transform is not None:
                self._transforms = [
                    options_for(transform_cls, transform_options, r).remote(
                        self._transform)
                    for r in range(R)]
            self._batcher = options_for(
                batcher_cls, batcher_options or {}).remote()
            rt.get([a.ping.remote() for a in self._stage_actors()],
                        timeout=180)
            sizes = rt.get(self._readers[0].probe_sizes.remote(
                self._transform, self._batch_size), timeout=180)
            # generous slack: block sizes vary across tasks and the probe
            # samples a few — an overflow is a loud write error, and
            # buffer_bytes= overrides when the operator knows better
            self._block_buffer = int(
                buffer_bytes
                or max(sizes["block_bytes"], sizes["np_bytes"]) * 3 // 2
                + 64 * 1024)
            self._batch_buffer = int(
                batch_buffer_bytes
                or sizes["row_bytes"] * self._batch_size * 3 // 2
                + 64 * 1024)
            self._build_channels()
        except BaseException:
            try:
                self.shutdown()
            except Exception:
                logger.debug("streaming build unwind failed", exc_info=True)
            raise
        global _live_executors
        with _live_lock:
            _live_executors += 1
            _m_depth.set(self._depth)
        self._gauge_live = True

    def _stage_actors(self):
        actors = list(self._readers) + list(self._transforms)
        if self._batcher is not None:
            actors.append(self._batcher)
        return actors

    # -- properties the microbenchmark fallback guards key on

    @property
    def is_channel_backed(self) -> bool:
        return bool(self._all_specs) and not self._dead

    @property
    def channel_depth(self) -> int:
        return self._depth

    @property
    def num_readers(self) -> int:
        return self._R

    @property
    def epoch_stats(self) -> List[dict]:
        """Per-epoch reports: batches, consumer stall seconds/fraction,
        the consumer's control-RPC delta, and every stage's in-band
        report (incl. per-epoch ``rpc_calls`` — the zero-RPC proof)."""
        return list(self._epoch_stats)

    # -- build

    def _create_channel(self, node_addr, participants, *,
                        buffer: int) -> _channels.ChannelSpec:
        core = self._core
        spec = _channels.create_channel(
            core, node_addr, buffer, self._depth, 1, participants)
        self._all_specs.append(spec)
        if tuple(node_addr) == tuple(core.supervisor_addr):
            self._local_channels[spec.key()] = _channels.LocalChannel(
                core.arena, spec)
        return spec

    def _build_channels(self) -> None:
        core = self._core
        driver_node = tuple(core.supervisor_addr)
        ctrl = core.clients.get(core.controller_addr)
        views = core._run(ctrl.call("node_views"))
        for a in self._stage_actors():
            hexid = a._actor_id.hex()
            self._actor_info[hexid] = _channels.resolve_actor_placement(
                core, a._actor_id, views)

        # stages are serially dependent through the batcher, so no
        # subset can make progress alone: ANY participant's death closes
        # every channel of the pipeline
        participants = {core._store_client_id}
        for info in self._actor_info.values():
            participants.add(info["worker_id_hex"])
            participants.add(f"node:{info['node_id_hex']}")

        def node_of(actor):
            return self._actor_info[actor._actor_id.hex()]["node_addr"]

        has_t = bool(self._transforms)
        mid_consumers = self._transforms if has_t else [self._batcher] * \
            self._R
        # every channel lives on its READER's node: same-node writers hit
        # the seqlock directly, cross-node writers push chunked mirrors
        reader_out = [self._create_channel(
            node_of(mid_consumers[r]), participants,
            buffer=self._block_buffer) for r in range(self._R)]
        if has_t:
            transform_out = [self._create_channel(
                node_of(self._batcher), participants,
                buffer=self._block_buffer) for _ in range(self._R)]
            batcher_in = transform_out
        else:
            batcher_in = reader_out
        self._out_spec = self._create_channel(
            driver_node, participants, buffer=self._batch_buffer)
        self._out_ch = self._local_channels[self._out_spec.key()]

        for hexid in self._actor_info:
            core.subscribe("actor:" + hexid, self._on_actor_update)

        for r, actor in enumerate(self._readers):
            self._loop_refs.append(actor.run_loop.remote(_ReaderPlan(
                out_spec=reader_out[r], rank=r, num_readers=self._R,
                num_tasks=self._T, seed=self._seed, epochs=self._epochs,
                send_numpy=not has_t)))
        if has_t:
            for r, actor in enumerate(self._transforms):
                self._loop_refs.append(actor.run_loop.remote(
                    _TransformPlan(in_spec=reader_out[r],
                                   out_spec=transform_out[r],
                                   epochs=self._epochs)))
        self._loop_refs.append(self._batcher.run_loop.remote(_BatcherPlan(
            in_specs=batcher_in, out_spec=self._out_spec,
            num_tasks=self._T, seed=self._seed, epochs=self._epochs,
            batch_size=self._batch_size, shuffle_buffer=self._shuffle,
            drop_last=self._drop_last)))

    # -- failure fan-out (the pipeline trainer's shape)

    def _on_actor_update(self, message) -> None:
        if self._dead or not isinstance(message, dict):
            return
        if message.get("state") in ("DEAD", "RESTARTING"):
            self._close_for_failure()

    def _close_for_failure(self) -> None:
        self._dead = True
        _channels.close_channels_nowait(
            self._core, self._local_channels.values(), self._all_specs)

    def _surface_failure(self, closed: ChannelClosedError):
        self._close_for_failure()
        _channels.surface_loop_failure(self._core, self._loop_refs, closed)

    # -- consumption

    def batches(self, copy: bool = True) -> Iterator[Dict[str, np.ndarray]]:
        """The consumer stream: one channel read per fixed-shape batch.

        ``copy=False`` yields READ-ONLY views over the driver's arena
        mmap (zero-copy); each view is valid until the next ``next()``
        — the ack that frees the batcher's slot is deferred until the
        consumer asks for more, which is what ``feed`` relies on to
        hand batches to a trainer without a copy. A mid-epoch
        participant death raises the loop's real error (never a
        silently truncated epoch)."""
        if self._dead:
            raise ChannelClosedError("streaming executor was torn down")
        if self._exhausted:
            raise RuntimeError(
                "streaming executor already consumed; build a new one "
                "(epochs are fixed at build time)")
        if self._consuming:
            # two live iterators would interleave reads of the one
            # consumer channel through the shared message counter —
            # each seeing a disjoint subset of batches, silently
            raise RuntimeError(
                "another batches() iterator is already consuming this "
                "executor")
        self._consuming = True
        try:
            yield from self._batches(copy)
        finally:
            self._consuming = False

    def _batches(self, copy: bool) -> Iterator[Dict[str, np.ndarray]]:
        from ray_tpu_torch._private import rpc

        epoch_t0 = None
        stall_s = 0.0
        batches = 0
        prev_rpc = rpc._m_client_calls.total()
        while True:
            v = 2 * (self._m + 1)
            t0 = time.perf_counter()
            try:
                view = self._out_ch.read(v)
            except ChannelClosedError as e:
                self._surface_failure(e)
            wait = time.perf_counter() - t0
            self._m += 1
            if epoch_t0 is None:
                # the wait for an epoch's first batch spans pipeline
                # spin-up and the driver's think-time — start the epoch
                # clock here; later waits are genuine input stalls
                epoch_t0 = time.perf_counter()
            else:
                stall_s += wait
                _m_stall.inc(wait)
                flight.instant(_F_STALL, int(wait * 1e6))
            msg = serialization.unpack(view)
            if "eof" in msg:
                epoch = msg["eof"]
                stats = list(msg["stats"])
                del msg, view
                self._out_ch.ack(0, v)
                now = rpc._m_client_calls.total()
                wall = max(time.perf_counter() - epoch_t0, 1e-9)
                self._epoch_stats.append({
                    "epoch": epoch, "batches": batches,
                    "stall_s": stall_s,
                    "stall_fraction": min(1.0, stall_s / wall),
                    "consumer_rpc_calls": now - prev_rpc,
                    "stage_reports": stats,
                })
                prev_rpc = now
                epoch_t0, stall_s, batches = None, 0.0, 0
                if epoch >= self._epochs:
                    self._exhausted = True
                    return
                continue
            batches += 1
            if copy:
                b = _copy_batch(msg["b"])
                del msg, view
                self._out_ch.ack(0, v)
                yield b
            else:
                try:
                    yield msg["b"]
                finally:
                    del msg, view
                    self._out_ch.ack(0, v)

    def feed(self, step: Callable[[Dict[str, np.ndarray]], Any]
             ) -> Iterator[Any]:
        """Hand every batch straight to a trainer step (e.g.
        ``PipelineTrainer.step`` or a Sebulba learner update) as
        read-only arena views — the batch never leaves the arena; the
        channel slot is acked after the step returns. Yields each
        step's result."""
        for batch in self.batches(copy=False):
            yield step(batch)

    # -- teardown

    def shutdown(self, kill_actors: bool = True,
                 timeout: float = 30) -> Dict[str, Any]:
        """Close every channel, drain the stage loops, release the pins,
        (optionally) kill the stage actors. Idempotent."""
        self._dead = True
        with self._teardown_lock:
            if self._torn:
                return {}
            self._torn = True
        if getattr(self, "_gauge_live", False):
            global _live_executors
            with _live_lock:
                _live_executors -= 1
                if _live_executors <= 0:
                    _m_depth.set(0)
        core = self._core
        for ch in self._local_channels.values():
            try:
                ch.close()
            except Exception:
                pass
        for hexid in self._actor_info:
            try:
                core.unsubscribe("actor:" + hexid, self._on_actor_update)
            except Exception:
                pass
        _channels.close_specs(core, self._all_specs)
        stats: Dict[str, Any] = {"loops": []}
        for ref in self._loop_refs:
            try:
                stats["loops"].append(core.get([ref], timeout=timeout)[0])
            except Exception:
                stats["loops"].append(None)
        _channels.free_and_unpin_specs(core, self._all_specs)
        if kill_actors:
            import ray_tpu_torch as rt

            for a in self._stage_actors():
                try:
                    rt.kill(a)
                except Exception:
                    pass
        return stats

    def __del__(self):
        try:
            self.shutdown()
        except Exception:
            pass


class StreamingBatches:
    """The iterator `Dataset.stream_batches` returns: owns a
    StreamingExecutor, yields its batches, and shuts it down on
    exhaustion or early close (a `break` releases the actors/pins)."""

    def __init__(self, ops, **kw):
        self.executor = StreamingExecutor(ops, **kw)

    @property
    def epoch_stats(self) -> List[dict]:
        return self.executor.epoch_stats

    def __iter__(self):
        try:
            yield from self.executor.batches()
        finally:
            self.executor.shutdown()
