"""Streaming all-to-all exchange: shuffle/repartition as channel stages.

`Dataset.random_shuffle` / `repartition` lower to barrier `AllToAll`
ops in the task executor: every input block materializes in the object
store, a split task fans each block into n parts, and a concat task per
output partition gathers them — the whole epoch's data sits still while
the barrier turns over. This module rebuilds those ops the way
`streaming.py` rebuilt read->map ingest: a fixed R x C mesh of
long-lived actors connected by depth-k slot-ring channels
(`_private/channels.py`), planned once at build time, streaming bucket
frames thereafter with ZERO steady-state control-plane RPCs per
producer and per consumer (counter-proven via the
``ray_tpu_rpc_client_calls_total`` deltas every epoch report carries).

Topology::

    R producers ----(R x C bucket-frame channels)----> C consumers
      (shard read      every producer holds ONE open      (merge ->
       + fused map      channel PER CONSUMER, placed       shuffle ->
       + partition)     on the CONSUMER's node)            batch)
                                                             |
                                              C consumer->driver channels
                                              (merged round-robin, or one
                                               per streaming_split rank /
                                               PipelineTrainer dp rank)

* every channel lives on its READER's node: same-node edges are
  zero-copy arena seqlock ops, cross-node edges are chunked mirror
  pushes (the collective ring's chunked framing applied to data);
* channel depth = the backpressure bound: a producer can run at most
  ``depth`` bucket frames ahead of each consumer
  (``RAY_TPU_TORCH_DATA_EXCHANGE_DEPTH``);
* a block's per-consumer bucket larger than
  ``RAY_TPU_TORCH_DATA_EXCHANGE_BUCKET_ROWS`` streams as several frames, so
  one fat block never needs a channel slot sized to hold it whole;
* an EMPTY bucket still sends one (zero-row) frame — the merge order
  stays deterministic and a consumer can prove it missed nothing.

Determinism (the parity contract): the epoch's shard order is
``epoch_order(T, seed, epoch)`` — producer r executes global positions
``p % R == r`` in order. For position p the row->consumer assignment is
``exchange_assignments(kind, C, rows, part_seed, epoch, p)`` — the
epoch FOLDED INTO the partition hash, so shuffles re-deal every epoch
with zero control messages. Consumer c reads its R input channels in
global-position order (position p's bucket comes from producer p % R),
which reconstructs the global bucket order EXACTLY, then runs the SAME
seeded-shuffle/batch stream (`epoch_batch_stream`) the task-based
baseline runs. ``task_exchange_batches`` IS that baseline: the same
partition function run as a real two-phase task shuffle through the
object store (one split task per block, ``num_returns=C``) — the
``algo="kv"`` idiom: a measured comparison target, never a silent
fallback. Same seed => same batches, exactly, on every consumer rank
and on the merged driver stream.

Failure semantics follow the house pattern: the participants set spans
the driver, every producer, every consumer and their nodes, so ANY
participant's death closes EVERY channel of the mesh; blocked peers
raise ``ChannelClosedError`` instead of hanging, stage loops re-fan the
close, pins return to baseline, and a partially-consumed epoch surfaces
a clean error — never a silently truncated shuffle.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import threading
import time
from typing import Any, Callable, Dict, Iterator, List, Optional, Sequence

import numpy as np

import ray_tpu_torch as rt
from ray_tpu_torch._private import channels as _channels
from ray_tpu_torch._private import chaos, flight, serialization
from ray_tpu_torch._private.exceptions import ChannelClosedError
from ray_tpu_torch._private.metrics import Counter, Gauge
from ray_tpu_torch.data._internal.streaming import (_copy_batch, _np_concat,
                                              _np_rows, _np_slice, _np_take,
                                              _require_positive, epoch_order,
                                              epoch_batch_stream,
                                              shuffle_rng,
                                              split_streamable_plan)

logger = logging.getLogger(__name__)

# exchange kinds a streaming plan can compile onto (the other AllToAll
# kinds — sort, groupby — stay task-executor barriers)
EXCHANGE_KINDS = ("shuffle", "repartition")

# flight-recorder span ids for the mesh hot loops (per-thread ring
# records — no locks, no RPCs, so the zero-RPC proofs hold recorder-on)
_F_SEND = flight.intern("data.exchange_send")
_F_MERGE = flight.intern("data.exchange_merge")
_F_STALL = flight.intern("data.exchange_stall")

_m_ex_rows = Counter(
    "ray_tpu_data_exchange_rows_total",
    "Streaming exchange: rows streamed per producer->consumer edge "
    "(label edge=\"r->c\")")
_m_ex_bytes = Counter(
    "ray_tpu_data_exchange_bytes_total",
    "Streaming exchange: packed bucket-frame bytes per edge")
_m_ex_buckets = Counter(
    "ray_tpu_data_exchange_buckets_total",
    "Streaming exchange: bucket frames committed per edge (>= one per "
    "(block, consumer) pair — empty buckets still send one frame)")
_m_ex_skew = Gauge(
    "ray_tpu_data_exchange_consumer_skew",
    "max/mean rows per consumer of the most recently completed exchange "
    "epoch (1.0 = perfectly balanced; driver-observed)")


# ------------------------------------------------------------------- knobs


def _env_exchange_depth(config) -> int:
    """Exchange channel depth from config, rejecting an explicit env
    zero loudly (the falsy-zero lesson: 0 never silently means
    a default — unset the var for that)."""
    raw = os.environ.get("RAY_TPU_TORCH_DATA_EXCHANGE_DEPTH")
    if raw is not None and int(raw) <= 0:
        raise ValueError(
            f"RAY_TPU_TORCH_DATA_EXCHANGE_DEPTH={raw!r}: explicit zeros are "
            f"rejected (unset the var for the default)")
    return _require_positive("data_exchange_depth",
                             config.data_exchange_depth)


def _env_bucket_rows(config) -> int:
    """Max rows per bucket frame, rejecting an explicit env zero."""
    raw = os.environ.get("RAY_TPU_TORCH_DATA_EXCHANGE_BUCKET_ROWS")
    if raw is not None and int(raw) <= 0:
        raise ValueError(
            f"RAY_TPU_TORCH_DATA_EXCHANGE_BUCKET_ROWS={raw!r}: explicit zeros "
            f"are rejected (unset the var for the default)")
    return _require_positive("data_exchange_bucket_rows",
                             config.data_exchange_bucket_rows)


# ------------------------------------------------- deterministic semantics


def partition_rng(seed: int, epoch: int, pos: int) -> np.random.Generator:
    """The row->consumer assignment RNG of one (epoch, global block
    position): epoch and position are FOLDED INTO the key, so every
    participant derives the same deal locally and epochs re-shuffle for
    free. Shared by the producer stage and the task-based baseline."""
    if seed is None:
        raise ValueError("exchange shuffle partitioning needs an "
                         "explicit seed")
    return np.random.default_rng(
        [int(seed) & 0x7FFFFFFF, 0xA77A, int(epoch), int(pos)])


def exchange_assignments(kind: str, num_consumers: int, num_rows: int,
                         seed: Optional[int], epoch: int,
                         pos: int) -> np.ndarray:
    """Row -> consumer assignment of one block: THE partition function,
    run by streaming producers on numpy rows and by the task baseline's
    split tasks on arrow rows — one implementation, parity by
    construction.

    shuffle: seeded uniform deal, re-keyed per (seed, epoch, position).
    repartition: position-offset round-robin deal — balanced to +-1 row
    per consumer per block and locally derivable (no global row offsets,
    which a streaming producer cannot know)."""
    C = int(num_consumers)
    if C <= 1:
        return np.zeros(num_rows, dtype=np.int64)
    if kind == "shuffle":
        return partition_rng(seed, epoch, pos).integers(
            0, C, size=num_rows)
    if kind == "repartition":
        return (np.arange(num_rows, dtype=np.int64) + pos) % C
    raise ValueError(f"unknown exchange kind {kind!r}")


def consumer_shuffle_params(kind: str, shuffle_buffer: Optional[int],
                            batch_size: Optional[int],
                            partition_seed: Optional[int],
                            order_seed: Optional[int]):
    """(buffer_rows, rng_seed) of the consumer-side windowed shuffle —
    shared by the consumer stage and the task baseline.

    kind == "shuffle": the exchange IS the shuffle, but rows inside one
    consumer would otherwise keep deterministic block order, so each
    consumer re-shuffles its own stream through the windowed buffer
    (default: 4 batches) seeded from the shuffle op's seed (per-rank rng
    stream). kind == "repartition": no implicit shuffle — an explicit
    ``shuffle_buffer`` rides the stream seed, exactly like
    ``Dataset.stream_batches``."""
    if kind == "shuffle":
        if batch_size is None:
            # split/block mode: buckets pass through un-batched; only an
            # explicit buffer re-shuffles within the rank stream
            if shuffle_buffer:
                return int(shuffle_buffer), partition_seed
            return None, None
        return int(shuffle_buffer or 4 * batch_size), partition_seed
    if shuffle_buffer:
        return int(shuffle_buffer), order_seed
    return None, None


def exchange_incompatible_reason(ops) -> Optional[str]:
    """None when the plan compiles onto the streaming exchange, else a
    human-readable reason — the string every fallback seam must SURFACE
    (log or raise), never swallow."""
    from ray_tpu_torch.data._internal import logical as L

    if not ops:
        return "empty plan"
    a2a = [op for op in ops if isinstance(op, L.AllToAll)]
    if not a2a:
        return "no shuffle/repartition op to exchange"
    if not isinstance(ops[-1], L.AllToAll):
        return (f"ops after the {a2a[-1].kind} barrier "
                f"({type(ops[-1]).__name__}) — the exchange must be the "
                f"terminal stage")
    if len(a2a) > 1:
        return "more than one all-to-all op (chained barriers)"
    op = ops[-1]
    if op.kind not in EXCHANGE_KINDS:
        return (f"AllToAll kind {op.kind!r} is a true barrier (only "
                f"{'/'.join(EXCHANGE_KINDS)} stream)")
    if op.kind == "shuffle" and op.args.get("seed") is None:
        return ("unseeded random_shuffle() — the streaming exchange "
                "derives every epoch's deal from the seed; pass "
                "random_shuffle(seed=...)")
    try:
        split_streamable_plan(ops[:-1])
    except ValueError as e:
        return str(e)
    return None


def split_exchange_plan(ops):
    """(read_tasks, fused_transform_or_None, kind, kind_args) of an
    exchange-compatible plan: Read -> OneToOne* -> AllToAll(shuffle |
    repartition). Raises with the incompatibility reason otherwise —
    never a silent fallback."""
    reason = exchange_incompatible_reason(ops)
    if reason is not None:
        raise ValueError(
            f"plan does not compile onto the streaming exchange: "
            f"{reason}; run it on the task-based executor "
            f"(iter_batches without streaming=True)")
    tasks, fused = split_streamable_plan(ops[:-1])
    op = ops[-1]
    return tasks, fused, op.kind, dict(op.args)


# --------------------------------------------------- task-based baseline


def _split_exchange(block, kind, n, seed, epoch, pos) -> List[Any]:
    """Phase-1 split task of the barrier baseline: one block -> n bucket
    blocks via the SAME assignment function the streaming producers run."""
    import pyarrow as pa

    assign = exchange_assignments(kind, n, block.num_rows, seed, epoch, pos)
    return [block.filter(pa.array(assign == c)) for c in range(n)]


_split_exchange_r = rt.remote(_split_exchange)


def _round_robin(iters: List[Iterator]) -> Iterator:
    """Deterministic interleave: one item per live stream per sweep,
    dropping a stream at the point it exhausts — the exact merge order
    the driver's merged ``batches()`` runs over consumer channels."""
    live = list(iters)
    while live:
        for it in list(live):
            try:
                yield next(it)
            except StopIteration:
                live.remove(it)


def task_exchange_batches(ops, *, batch_size: Optional[int],
                          num_consumers: int,
                          consumer_rank: Optional[int] = None,
                          epoch: int = 1, seed: Optional[int] = 0,
                          shuffle_buffer: Optional[int] = None,
                          drop_last: bool = False,
                          concurrency: int = 8
                          ) -> Iterator[Dict[str, np.ndarray]]:
    """One epoch through the TASK-BASED barrier AllToAll at the
    exchange's exact semantics: the epoch's shard order re-applied to
    the read tasks, real remote read+transform tasks through the object
    store, a BARRIER (every block materialized), one split task per
    block (``num_returns=C``), then per-consumer bucket gathers in
    global order through the SAME shuffle+batch stream. This is the
    measured baseline of the ``data_shuffle_streaming_vs_barrier``
    probe and the parity reference of the exchange tests/chaos soak —
    same seed => same batches, exactly.

    ``consumer_rank=None`` yields the driver-merged round-robin stream
    (what ``ExchangeExecutor.batches()`` produces); a rank yields that
    consumer's own stream (what ``streaming_split``/``feed(rank=)``
    consume)."""
    from ray_tpu_torch.data._internal import logical as L
    from ray_tpu_torch.data._internal.executor import execute_plan
    from ray_tpu_torch.data.block import block_to_batch

    tasks, fused, kind, args = split_exchange_plan(ops)
    C = _require_positive("num_consumers", num_consumers)
    part_seed = args.get("seed") if kind == "shuffle" else None
    order = epoch_order(len(tasks), seed, epoch)
    plan: List[Any] = [L.Read(read_tasks=[tasks[int(i)] for i in order],
                              datasource_name="exchange_epoch")]
    if fused is not None:
        plan.append(L.OneToOne(fused, label="exchange_map"))
    # the barrier: every block materializes before any bucket is read
    pairs = list(execute_plan(plan, concurrency))
    parts: List[List[Any]] = []
    for p, (ref, _meta) in enumerate(pairs):
        if C == 1:
            parts.append([ref])
        else:
            r = _split_exchange_r.options(num_returns=C).remote(
                ref, kind, C, part_seed, epoch, p)
            parts.append(list(r))

    def consumer_stream(c: int) -> Iterator[Dict[str, np.ndarray]]:
        def np_buckets():
            for p in range(len(pairs)):
                nb = block_to_batch(rt.get(parts[p][c]), "numpy")
                if _np_rows(nb):
                    yield nb

        buf, sseed = consumer_shuffle_params(
            kind, shuffle_buffer, batch_size, part_seed, seed)
        rng = shuffle_rng(sseed, epoch, rank=c) if buf else None
        if batch_size is None:
            blocks = np_buckets()
            if buf:
                from ray_tpu_torch.data._internal.streaming import \
                    _shuffle_np_stream

                blocks = _shuffle_np_stream(blocks, buf, rng)
            return blocks
        return epoch_batch_stream(
            np_buckets(), batch_size=batch_size, shuffle_buffer=buf,
            rng=rng, drop_last=drop_last)

    if consumer_rank is not None:
        yield from consumer_stream(int(consumer_rank))
        return
    yield from _round_robin([consumer_stream(c) for c in range(C)])


# ------------------------------------------------------------------ plans


@dataclasses.dataclass
class _ProducerPlan:
    out_specs: List[_channels.ChannelSpec]  # one per consumer, c-indexed
    rank: int
    num_producers: int
    num_consumers: int
    num_tasks: int
    order_seed: Optional[int]
    kind: str
    partition_seed: Optional[int]
    epochs: int
    bucket_rows: int


@dataclasses.dataclass
class _ConsumerPlan:
    in_specs: List[_channels.ChannelSpec]  # one per producer, r-indexed
    out_spec: _channels.ChannelSpec
    rank: int
    num_producers: int
    num_consumers: int
    num_tasks: int
    order_seed: Optional[int]
    kind: str
    partition_seed: Optional[int]
    epochs: int
    batch_size: Optional[int]  # None: split mode — buckets pass through
    shuffle_buffer: Optional[int]
    drop_last: bool


# ------------------------------------------------------- stage actor loops


class _ExchangeProducerImpl:
    """Producer actor: executes its share of the epoch's read order
    (``p % R == rank``), applies the fused map chain, partitions each
    block's rows into per-consumer buckets with the shared assignment
    function, and streams bucket frames into its C open channels — the
    object store never sees a row."""

    def __init__(self, tasks, transform):
        self._tasks = list(tasks)
        self._transform = transform

    def ping(self) -> str:
        return "ok"

    def probe_sizes(self, sample: int = 3) -> dict:
        """Packed payload sizes off a few sample tasks so the driver can
        size the mesh's channels at build — an undersized buffer then
        can only be a loud build/write error, never silent corruption."""
        from ray_tpu_torch.data.block import block_to_batch

        T = len(self._tasks)
        idx = sorted({0, T // 2, T - 1})[:max(1, int(sample))]
        np_b = row_b = 1
        for i in idx:
            block = self._tasks[i]()
            out = (self._transform(block) if self._transform is not None
                   else block)
            nb = block_to_batch(out, "numpy")
            payload = len(serialization.pack(
                {"p": 0, "last": True, "b": nb}))
            np_b = max(np_b, payload)
            row_b = max(row_b, payload // max(1, out.num_rows))
        return {"np_bytes": np_b, "row_bytes": row_b}

    def run_loop(self, plan: _ProducerPlan) -> dict:
        from ray_tpu_torch._private import api, rpc
        from ray_tpu_torch.data.block import block_to_batch

        core = api._core
        if core is None:
            raise RuntimeError("exchange producer loop outside a worker")
        open_local, local, release_pins = _channels.open_local_factory(core)
        remote_specs: List[_channels.ChannelSpec] = []
        outs: List[_channels.VersionedWriter] = []
        try:
            for spec in plan.out_specs:
                w = _channels.VersionedWriter(core, spec, open_local)
                if not w.is_local:
                    remote_specs.append(spec)
                outs.append(w)
        except BaseException:
            release_pins()
            raise

        def close_everything() -> None:
            _channels.close_channels_nowait(
                core, local.values(), remote_specs)

        R, C = plan.num_producers, plan.num_consumers
        sent = [0] * C  # per-edge messages committed (version 2n)
        edge = [f"{plan.rank}->{c}" for c in range(C)]
        total_rows = 0
        prev_rpc = rpc._m_client_calls.total()

        def send(c: int, payload) -> None:
            sent[c] += 1
            outs[c].write(payload, 2 * sent[c])

        try:
            for epoch in range(1, plan.epochs + 1):
                order = epoch_order(plan.num_tasks, plan.order_seed, epoch)
                blocks = 0
                rows = 0
                for p in range(plan.rank, plan.num_tasks, R):
                    chaos.maybe_crash("worker.data_exchange")
                    block = self._tasks[int(order[p])]()
                    out = (self._transform(block)
                           if self._transform is not None else block)
                    nb = block_to_batch(out, "numpy")
                    del block, out
                    n = _np_rows(nb)
                    assign = exchange_assignments(
                        plan.kind, C, n, plan.partition_seed, epoch, p)
                    for c in range(C):
                        t0 = flight.now()
                        idx = np.flatnonzero(assign == c)
                        bucket = _np_take(nb, idx)
                        bn = len(idx)
                        # >= one frame per (block, consumer) — an empty
                        # bucket still sends its zero-row frame so the
                        # consumer's deterministic merge can't stall on
                        # a bucket that will never come
                        lo = 0
                        while True:
                            hi = min(lo + plan.bucket_rows, bn)
                            payload = serialization.pack(
                                {"p": p, "last": hi >= bn,
                                 "b": _np_slice(bucket, lo, hi)})
                            send(c, payload)
                            _m_ex_buckets.inc(labels={"edge": edge[c]})
                            _m_ex_bytes.inc(len(payload),
                                            labels={"edge": edge[c]})
                            lo = hi
                            if lo >= bn:
                                break
                        _m_ex_rows.inc(bn, labels={"edge": edge[c]})
                        flight.span_since(_F_SEND, t0)
                    rows += n
                    blocks += 1
                total_rows += rows
                now = rpc._m_client_calls.total()
                stats = {"role": "producer", "rank": plan.rank,
                         "epoch": epoch, "blocks": blocks, "rows": rows,
                         "rpc_calls": now - prev_rpc}
                prev_rpc = now
                for c in range(C):
                    # producer stats ride consumer 0's eof only, so the
                    # driver sees each producer's report exactly once
                    send(c, serialization.pack(
                        {"eof": epoch,
                         "stats": [stats] if c == 0 else []}))
            return {"rows": total_rows, "epochs": plan.epochs}
        except ChannelClosedError:
            # teardown (or a peer's death) closed the mesh mid-epoch;
            # re-fan the close so every peer unwinds
            try:
                close_everything()
            except Exception:
                logger.exception("producer close-on-exit failed")
            return {"rows": total_rows, "closed": True}
        except BaseException:
            try:
                close_everything()
            except Exception:
                logger.exception("producer close-on-error failed")
            raise
        finally:
            release_pins()


class _ExchangeConsumerImpl:
    """Consumer actor: reads its R input channels in global-position
    order (position p's frames come from producer ``p % R`` — the
    deterministic merge), re-assembles multi-frame buckets, runs the
    shared windowed-shuffle + fixed-shape batch stream, and commits one
    batch per write into its driver-side output channel."""

    def ping(self) -> str:
        return "ok"

    def run_loop(self, plan: _ConsumerPlan) -> dict:
        from ray_tpu_torch._private import api, rpc

        core = api._core
        if core is None:
            raise RuntimeError("exchange consumer loop outside a worker")
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

        R = plan.num_producers
        reads = [0] * R  # per-upstream message count
        m = 0  # downstream messages committed
        total_batches = 0
        prev_rpc = rpc._m_client_calls.total()
        try:
            for epoch in range(1, plan.epochs + 1):
                stage_stats: List[dict] = []
                rows_in = 0

                def np_buckets():
                    nonlocal rows_in
                    for p in range(plan.num_tasks):
                        chaos.maybe_crash("worker.data_exchange")
                        r = p % R
                        frames: List[Dict[str, np.ndarray]] = []
                        while True:
                            reads[r] += 1
                            view = in_chs[r].read(2 * reads[r])
                            msg = serialization.unpack(view)
                            if msg["p"] != p:
                                raise RuntimeError(
                                    f"exchange merge desync: consumer "
                                    f"{plan.rank} expected position {p} "
                                    f"from producer {r}, got {msg['p']}")
                            b = _copy_batch(msg["b"])  # memcpy, then ack
                            last = msg["last"]
                            del msg, view
                            in_chs[r].ack(0, 2 * reads[r])
                            if _np_rows(b):
                                frames.append(b)
                            if last:
                                break
                        if frames:
                            t0 = flight.now()
                            merged = _np_concat(frames)
                            flight.span_since(_F_MERGE, t0)
                            rows_in += _np_rows(merged)
                            # one block per (position, consumer) bucket,
                            # frames re-joined — the SAME block stream
                            # the baseline's split tasks produce, so the
                            # windowed shuffle fills at identical points
                            yield merged
                    for r in range(R):
                        reads[r] += 1
                        view = in_chs[r].read(2 * reads[r])
                        msg = serialization.unpack(bytes(view))
                        del view
                        in_chs[r].ack(0, 2 * reads[r])
                        if msg.get("eof") != epoch:
                            raise RuntimeError(
                                f"exchange epoch desync: consumer "
                                f"{plan.rank} expected eof {epoch} from "
                                f"producer {r}, got {msg!r}")
                        stage_stats.extend(msg.get("stats", []))

                buf, sseed = consumer_shuffle_params(
                    plan.kind, plan.shuffle_buffer, plan.batch_size,
                    plan.partition_seed, plan.order_seed)
                rng = (shuffle_rng(sseed, epoch, rank=plan.rank)
                       if buf else None)
                if plan.batch_size is None:
                    stream: Iterator = np_buckets()
                    if buf:
                        from ray_tpu_torch.data._internal.streaming import \
                            _shuffle_np_stream

                        stream = _shuffle_np_stream(stream, buf, rng)
                else:
                    stream = epoch_batch_stream(
                        np_buckets(), batch_size=plan.batch_size,
                        shuffle_buffer=buf, rng=rng,
                        drop_last=plan.drop_last)
                batches = 0
                for batch in stream:
                    m += 1
                    out.write(serialization.pack({"b": batch}), 2 * m)
                    batches += 1
                total_batches += batches
                now = rpc._m_client_calls.total()
                stage_stats.append({"role": "consumer", "rank": plan.rank,
                                    "epoch": epoch, "rows": rows_in,
                                    "batches": batches,
                                    "rpc_calls": now - prev_rpc})
                prev_rpc = now
                m += 1
                out.write(serialization.pack(
                    {"eof": epoch, "batches": batches, "rows": rows_in,
                     "stats": stage_stats}), 2 * m)
            return {"batches": total_batches, "epochs": plan.epochs}
        except ChannelClosedError:
            try:
                close_everything()
            except Exception:
                logger.exception("consumer close-on-exit failed")
            return {"batches": total_batches, "closed": True}
        except BaseException:
            try:
                close_everything()
            except Exception:
                logger.exception("consumer close-on-error failed")
            raise
        finally:
            release_pins()


_producer_cls = _consumer_cls = None


def _actor_classes():
    global _producer_cls, _consumer_cls
    if _producer_cls is None:
        _producer_cls = rt.remote(_ExchangeProducerImpl)
        _consumer_cls = rt.remote(_ExchangeConsumerImpl)
    return _producer_cls, _consumer_cls


# --------------------------------------------------------------- executor


class ExchangeExecutor:
    """Compiled R x C streaming exchange (module docstring has the
    design)::

        ex = ExchangeExecutor(ds._ops, batch_size=256, epochs=2, seed=0,
                              num_consumers=2)
        for batch in ex.batches():        # merged round-robin stream
            ...
        ex.shutdown()

    Per-rank consumption (streaming_split ranks, PipelineTrainer dp
    ranks) reads ONE consumer's output channel::

        for batch in ex.rank_batches(rank):  ...
        for out in ex.feed(step, rank=r):    ...  # read-only arena views
    """

    def __init__(self, ops, *, batch_size: Optional[int], epochs: int = 1,
                 seed: Optional[int] = 0,
                 num_producers: Optional[int] = None,
                 num_consumers: Optional[int] = None,
                 shuffle_buffer: Optional[int] = None,
                 depth: Optional[int] = None,
                 bucket_rows: Optional[int] = None,
                 drop_last: bool = False,
                 buffer_bytes: Optional[int] = None,
                 batch_buffer_bytes: Optional[int] = None,
                 producer_options: Optional[Sequence[dict]] = None,
                 consumer_options: Optional[Sequence[dict]] = None,
                 locality_hints: Optional[Sequence] = None,
                 name: str = "data_exchange"):
        from ray_tpu_torch._private import api

        core = api._require_core()
        self._core = core
        if core.arena is None:
            raise RuntimeError(
                "the streaming exchange needs a driver attached to a "
                "node arena")
        if batch_size is not None:
            batch_size = _require_positive("batch_size", batch_size)
        self._batch_size = batch_size
        self._epochs = _require_positive("epochs", epochs)
        self._seed = seed
        if shuffle_buffer is not None and int(shuffle_buffer) <= 0:
            raise ValueError(
                f"shuffle_buffer must be positive (got {shuffle_buffer!r});"
                f" pass None for the kind's default")
        self._shuffle = int(shuffle_buffer) if shuffle_buffer else None
        self._depth = (_require_positive("depth", depth)
                       if depth is not None
                       else _env_exchange_depth(core.config))
        self._bucket_rows = (_require_positive("bucket_rows", bucket_rows)
                             if bucket_rows is not None
                             else _env_bucket_rows(core.config))
        self._drop_last = bool(drop_last)
        self._tasks, self._transform, self._kind, self._kind_args = \
            split_exchange_plan(ops)
        self._part_seed = (self._kind_args.get("seed")
                           if self._kind == "shuffle" else None)
        T = len(self._tasks)
        self._T = T
        R = (min(4, T) if num_producers is None
             else _require_positive("num_producers", num_producers))
        self._R = R = min(R, T)
        if num_consumers is None:
            num_consumers = self._kind_args.get("num_blocks") \
                if self._kind == "repartition" else None
        C = (2 if num_consumers is None
             else _require_positive("num_consumers", num_consumers))
        if self._kind == "repartition":
            nb = self._kind_args.get("num_blocks")
            if nb and num_consumers is not None and int(nb) != C:
                raise ValueError(
                    f"repartition(num_blocks={nb}) conflicts with "
                    f"num_consumers={C}; drop one of them")
        self._C = C
        if locality_hints is not None and len(locality_hints) != C:
            raise ValueError(
                f"locality_hints must name one node per consumer "
                f"({C}), got {len(locality_hints)}")

        self._dead = False
        self._torn = False
        self._teardown_lock = threading.Lock()
        self._all_specs: List[_channels.ChannelSpec] = []
        self._local_channels: Dict[bytes, _channels.LocalChannel] = {}
        self._loop_refs: List[Any] = []
        self._actor_info: Dict[str, dict] = {}
        self._producers: List[Any] = []
        self._consumers: List[Any] = []
        self._m = [0] * C  # per-consumer messages the driver has read
        self._epoch_stats: List[dict] = []
        self._rank_epoch_stats: List[List[dict]] = [[] for _ in range(C)]
        self._rank_epoch_done = [0] * C
        self._mode: Optional[str] = None  # "merged" | "ranks"
        self._consuming = [False] * C
        self._exhausted = False

        producer_cls, consumer_cls = _actor_classes()

        # deterministic mesh placement: producers and consumers round-
        # robin across live nodes (soft affinity — a full node falls
        # back to the scheduler and resolve_actor_placement records the
        # miss); explicit options/locality_hints override per actor
        plan_nodes = None
        try:
            views = core._run(core.clients.get(
                core.controller_addr).call("node_views"))
            plan_nodes = _channels.plan_mesh_placement(
                views, num_producers=R, num_consumers=C)
        except Exception:
            logger.debug("mesh placement planning failed; leaving actor "
                         "placement to the scheduler", exc_info=True)

        def options_for(cls, opts, i, planned, hint=None):
            from ray_tpu_torch.util.scheduling_strategies import \
                NodeAffinitySchedulingStrategy

            o = dict(opts[i]) if opts and i < len(opts) and opts[i] else {}
            if not o and hint is not None:
                # locality hint = the node_id_hex the consumer's data
                # should land on (soft: a full node falls back to the
                # scheduler and resolve_actor_placement records the miss)
                o["scheduling_strategy"] = NodeAffinitySchedulingStrategy(
                    node_id_hex=str(hint), soft=True)
            elif not o and planned is not None:
                o["scheduling_strategy"] = NodeAffinitySchedulingStrategy(
                    node_id_hex=planned[i], soft=True)
            o.setdefault("num_cpus", 0.5)
            return cls.options(**o)

        def expected(opts, i, planned, hint=None):
            # the node an affinity-scheduled actor SHOULD land on, so
            # resolve_actor_placement can record a soft-scheduling miss
            if opts and i < len(opts) and opts[i]:
                return None
            if hint is not None:
                return str(hint)
            return planned[i] if planned is not None else None

        p_nodes = plan_nodes[0] if plan_nodes else None
        c_nodes = plan_nodes[1] if plan_nodes else None
        self._expect_nodes = (
            [expected(producer_options, r, p_nodes) for r in range(R)]
            + [expected(consumer_options, c, c_nodes,
                        hint=(locality_hints[c] if locality_hints
                              else None)) for c in range(C)])

        # any mid-build failure unwinds through shutdown() — it kills
        # whatever was already created (ActorHandles have no GC-kill)
        try:
            self._producers = [
                options_for(producer_cls, producer_options, r,
                            p_nodes).remote(self._tasks, self._transform)
                for r in range(R)]
            self._consumers = [
                options_for(consumer_cls, consumer_options, c, c_nodes,
                            hint=(locality_hints[c]
                                  if locality_hints else None)).remote()
                for c in range(C)]
            rt.get([a.ping.remote() for a in self._stage_actors()],
                        timeout=180)
            sizes = rt.get(self._producers[0].probe_sizes.remote(),
                                timeout=180)
            # generous slack: frame size is bounded by min(whole block,
            # bucket_rows rows) + framing; an overflow is a loud write
            # error, and buffer_bytes= overrides when the operator knows
            # better
            frame_cap = min(
                sizes["np_bytes"],
                sizes["row_bytes"] * self._bucket_rows + 4096)
            self._frame_buffer = int(
                buffer_bytes or frame_cap * 3 // 2 + 64 * 1024)
            out_rows = self._batch_size if self._batch_size else \
                max(1, -(-T // max(1, R)))  # split mode: <= one block's rows
            self._batch_buffer = int(
                batch_buffer_bytes
                or max(sizes["row_bytes"] * out_rows, sizes["np_bytes"])
                * 3 // 2 + 64 * 1024)
            self._build_channels()
        except BaseException:
            try:
                self.shutdown()
            except Exception:
                logger.debug("exchange build unwind failed", exc_info=True)
            raise

    def _stage_actors(self):
        return list(self._producers) + list(self._consumers)

    # -- properties the probe fallback guards key on

    @property
    def is_channel_backed(self) -> bool:
        return bool(self._all_specs) and not self._dead

    @property
    def channel_depth(self) -> int:
        return self._depth

    @property
    def num_producers(self) -> int:
        return self._R

    @property
    def num_consumers(self) -> int:
        return self._C

    @property
    def epoch_stats(self) -> List[dict]:
        """Merged-mode per-epoch reports: batches, consumer stall
        seconds/fraction, the driver's control-RPC delta, per-consumer
        row counts + skew, and every stage's in-band report (incl.
        per-epoch ``rpc_calls`` — the zero-RPC proof)."""
        return list(self._epoch_stats)

    def rank_epoch_stats(self, rank: int) -> List[dict]:
        """Per-epoch reports of one consumer rank's stream."""
        return list(self._rank_epoch_stats[rank])

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
        for a, exp in zip(self._stage_actors(), self._expect_nodes):
            hexid = a._actor_id.hex()
            self._actor_info[hexid] = _channels.resolve_actor_placement(
                core, a._actor_id, views, expect_node_id_hex=exp)

        # the mesh is one dataflow: every consumer needs every producer
        # and the driver needs every consumer, so no subset can make
        # progress alone — ANY participant's death closes every channel
        participants = {core._store_client_id}
        for info in self._actor_info.values():
            participants.add(info["worker_id_hex"])
            participants.add(f"node:{info['node_id_hex']}")

        def node_of(actor):
            return self._actor_info[actor._actor_id.hex()]["node_addr"]

        # R x C bucket-frame channels, each on its CONSUMER's (reader's)
        # node: same-node producers hit the seqlock directly, cross-node
        # producers push chunked mirror frames
        self._mesh_specs = [
            [self._create_channel(node_of(self._consumers[c]),
                                  participants, buffer=self._frame_buffer)
             for c in range(self._C)]
            for _r in range(self._R)]
        # C consumer->driver output channels on the driver's node
        self._out_specs = [
            self._create_channel(driver_node, participants,
                                 buffer=self._batch_buffer)
            for _c in range(self._C)]
        self._out_chs = [self._local_channels[s.key()]
                         for s in self._out_specs]

        for hexid in self._actor_info:
            core.subscribe("actor:" + hexid, self._on_actor_update)

        for r, actor in enumerate(self._producers):
            self._loop_refs.append(actor.run_loop.remote(_ProducerPlan(
                out_specs=[self._mesh_specs[r][c] for c in range(self._C)],
                rank=r, num_producers=self._R, num_consumers=self._C,
                num_tasks=self._T, order_seed=self._seed, kind=self._kind,
                partition_seed=self._part_seed, epochs=self._epochs,
                bucket_rows=self._bucket_rows)))
        for c, actor in enumerate(self._consumers):
            self._loop_refs.append(actor.run_loop.remote(_ConsumerPlan(
                in_specs=[self._mesh_specs[r][c] for r in range(self._R)],
                out_spec=self._out_specs[c], rank=c,
                num_producers=self._R, num_consumers=self._C,
                num_tasks=self._T, order_seed=self._seed, kind=self._kind,
                partition_seed=self._part_seed, epochs=self._epochs,
                batch_size=self._batch_size, shuffle_buffer=self._shuffle,
                drop_last=self._drop_last)))

    # -- failure fan-out (the streaming executor's shape)

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

    def _read_msg(self, c: int):
        """One message off consumer c's output channel (blocking);
        returns (version, view)."""
        v = 2 * (self._m[c] + 1)
        try:
            view = self._out_chs[c].read(v)
        except ChannelClosedError as e:
            self._surface_failure(e)
        self._m[c] += 1
        return v, view

    def _claim_mode(self, mode: str) -> None:
        if self._dead:
            raise ChannelClosedError("exchange executor was torn down")
        if self._mode is not None and self._mode != mode:
            # merged and per-rank consumption share the same C channels
            # and message counters — mixing them would silently split
            # each consumer's stream between two readers
            raise RuntimeError(
                f"exchange already consumed in {self._mode!r} mode; "
                f"build a new executor for {mode!r} consumption")
        self._mode = mode

    def batches(self, copy: bool = True) -> Iterator[Dict[str, np.ndarray]]:
        """The driver-merged stream: round-robin over the C consumer
        channels (one batch per live consumer per sweep, a consumer
        dropping out of the cycle at its epoch eof) — the deterministic
        interleave ``task_exchange_batches(consumer_rank=None)``
        reproduces. ``copy=False`` yields READ-ONLY arena views, acked
        when the iterator advances."""
        self._claim_mode("merged")
        if self._exhausted:
            raise RuntimeError(
                "exchange executor already consumed; build a new one "
                "(epochs are fixed at build time)")
        if any(self._consuming):
            raise RuntimeError(
                "another batches() iterator is already consuming this "
                "executor")
        self._consuming = [True] * self._C
        try:
            yield from self._merged(copy)
        finally:
            self._consuming = [False] * self._C

    def _merged(self, copy: bool) -> Iterator[Dict[str, np.ndarray]]:
        from ray_tpu_torch._private import rpc

        prev_rpc = rpc._m_client_calls.total()
        for epoch in range(1, self._epochs + 1):
            live = list(range(self._C))
            stage_reports: List[dict] = []
            rows_per_consumer = [0] * self._C
            batches = 0
            stall_s = 0.0
            epoch_t0 = None
            while live:
                for c in list(live):
                    t0 = time.perf_counter()
                    v, view = self._read_msg(c)
                    wait = time.perf_counter() - t0
                    if epoch_t0 is None:
                        # the first batch's wait spans mesh spin-up and
                        # driver think-time — start the epoch clock here
                        epoch_t0 = time.perf_counter()
                    else:
                        stall_s += wait
                        flight.instant(_F_STALL, int(wait * 1e6))
                    msg = serialization.unpack(view)
                    if "eof" in msg:
                        stage_reports.extend(msg["stats"])
                        rows_per_consumer[c] = msg.get("rows", 0)
                        del msg, view
                        self._out_chs[c].ack(0, v)
                        live.remove(c)
                        continue
                    batches += 1
                    if copy:
                        b = _copy_batch(msg["b"])
                        del msg, view
                        self._out_chs[c].ack(0, v)
                        yield b
                    else:
                        try:
                            yield msg["b"]
                        finally:
                            del msg, view
                            self._out_chs[c].ack(0, v)
            now = rpc._m_client_calls.total()
            wall = max(time.perf_counter() - (epoch_t0 or
                                              time.perf_counter()), 1e-9)
            mean_rows = max(sum(rows_per_consumer) / self._C, 1e-9)
            skew = max(rows_per_consumer) / mean_rows
            _m_ex_skew.set(skew)
            self._epoch_stats.append({
                "epoch": epoch, "batches": batches,
                "stall_s": stall_s,
                "stall_fraction": min(1.0, stall_s / wall),
                "consumer_rpc_calls": now - prev_rpc,
                "rows_per_consumer": rows_per_consumer,
                "skew": skew,
                "stage_reports": stage_reports,
            })
            prev_rpc = now
        self._exhausted = True

    def rank_epoch(self, rank: int, epoch: Optional[int] = None,
                   copy: bool = True) -> Iterator[Dict[str, np.ndarray]]:
        """ONE epoch of one consumer rank's stream (the streaming_split
        per-rank iterator's unit): reads that rank's output channel up
        to its epoch eof. Epochs must be consumed in order."""
        self._claim_mode("ranks")
        c = int(rank)
        expected = self._rank_epoch_done[c] + 1
        if epoch is None:
            epoch = expected
        if epoch != expected:
            raise RuntimeError(
                f"exchange rank {c} epochs are consumed in order: "
                f"expected epoch {expected}, got {epoch} "
                f"(built with epochs={self._epochs})")
        if epoch > self._epochs:
            raise RuntimeError(
                f"exchange rank {c} exhausted its {self._epochs} "
                f"epoch(s); build with epochs=")
        if self._consuming[c]:
            raise RuntimeError(
                f"another iterator is already consuming exchange "
                f"rank {c}")
        self._consuming[c] = True
        try:
            yield from self._rank_epoch(c, epoch, copy)
        finally:
            self._consuming[c] = False

    def _rank_epoch(self, c: int, epoch: int,
                    copy: bool) -> Iterator[Dict[str, np.ndarray]]:
        from ray_tpu_torch._private import rpc

        prev_rpc = rpc._m_client_calls.total()
        batches = 0
        stall_s = 0.0
        epoch_t0 = None
        while True:
            t0 = time.perf_counter()
            v, view = self._read_msg(c)
            wait = time.perf_counter() - t0
            if epoch_t0 is None:
                epoch_t0 = time.perf_counter()
            else:
                stall_s += wait
                flight.instant(_F_STALL, int(wait * 1e6))
            msg = serialization.unpack(view)
            if "eof" in msg:
                stats = list(msg["stats"])
                rows = msg.get("rows", 0)
                del msg, view
                self._out_chs[c].ack(0, v)
                now = rpc._m_client_calls.total()
                wall = max(time.perf_counter() - epoch_t0, 1e-9)
                self._rank_epoch_stats[c].append({
                    "epoch": epoch, "batches": batches, "rows": rows,
                    "stall_s": stall_s,
                    "stall_fraction": min(1.0, stall_s / wall),
                    "consumer_rpc_calls": now - prev_rpc,
                    "stage_reports": stats,
                })
                self._rank_epoch_done[c] = epoch
                return
            batches += 1
            if copy:
                b = _copy_batch(msg["b"])
                del msg, view
                self._out_chs[c].ack(0, v)
                yield b
            else:
                try:
                    yield msg["b"]
                finally:
                    del msg, view
                    self._out_chs[c].ack(0, v)

    def rank_batches(self, rank: int,
                     copy: bool = True) -> Iterator[Dict[str, np.ndarray]]:
        """Every epoch of one consumer rank's stream, back to back —
        what a PipelineTrainer dp rank consumes."""
        for epoch in range(1, self._epochs + 1):
            yield from self.rank_epoch(rank, epoch, copy)

    def feed(self, step: Callable[[Dict[str, np.ndarray]], Any], *,
             rank: Optional[int] = None) -> Iterator[Any]:
        """Hand every batch straight to a trainer step as read-only
        arena views — the batch never leaves the arena; the channel slot
        is acked after the step returns. ``rank=r`` feeds one dp rank
        from ITS OWN consumer's output (each rank of a dp trainer runs
        its own feed); ``rank=None`` feeds the merged stream. Yields
        each step's result."""
        src = (self.batches(copy=False) if rank is None
               else self.rank_batches(rank, copy=False))
        for batch in src:
            yield step(batch)

    # -- teardown

    def shutdown(self, kill_actors: bool = True,
                 timeout: float = 30) -> Dict[str, Any]:
        """Close every channel of the mesh, drain the stage loops,
        release the pins, (optionally) kill the stage actors.
        Idempotent."""
        self._dead = True
        with self._teardown_lock:
            if self._torn:
                return {}
            self._torn = True
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


class ExchangeBatches:
    """The iterator `Dataset.stream_batches` returns for exchange plans:
    owns an ExchangeExecutor, yields its merged batches, and shuts it
    down on exhaustion or early close (a `break` releases the
    actors/pins)."""

    def __init__(self, ops, **kw):
        self.executor = ExchangeExecutor(ops, **kw)

    @property
    def epoch_stats(self) -> List[dict]:
        return self.executor.epoch_stats

    def __iter__(self):
        try:
            yield from self.executor.batches()
        finally:
            self.executor.shutdown()
