"""Streaming plan executor.

Analog of the reference's `python/ray/data/_internal/execution/
streaming_executor.py:48` + `operators/task_pool_map_operator.py`, reshaped
around this runtime's dataflow: map stages submit block tasks with a
bounded in-flight window and *yield refs downstream without waiting* — the
object layer's task-arg resolution does the waiting, so the whole pipeline
stays dataflow-driven and backpressure comes from generator laziness (the
consumer pulls; each stage holds at most `concurrency` pending tasks).

All-to-all ops (repartition / random_shuffle / sort / groupby) are
barriers implemented as two-phase distributed shuffles: phase 1 splits each
input block into n parts (one task per block, num_returns=n), phase 2
builds each output partition from its parts (one task per output) — the
reference's push-based shuffle (`_internal/planner/exchange/`).
"""

from __future__ import annotations

import itertools
import logging
from collections import deque
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple

import numpy as np

import ray_tpu_torch as rt
from ray_tpu_torch.data._internal.logical import (ActorPoolMap, AllToAll, InputData,
                                            Limit, LogicalOp, OneToOne, Read,
                                            Union, Zip, fuse_transforms)
from ray_tpu_torch.data.block import (Block, block_meta, concat_blocks, slice_block)

logger = logging.getLogger(__name__)

DEFAULT_CONCURRENCY = 8
# memory-aware backpressure: a stage narrows its in-flight window when
# observed block sizes would put more than this many bytes in flight
# (≈ the reference's resource-budget backpressure, streaming_executor.py:48)
DEFAULT_MAX_BYTES_IN_FLIGHT = 256 * 1024 * 1024

# ---------------------------------------------------------------- task fns


def _run_read(task) -> Tuple[Block, Dict]:
    b = task()
    return b, block_meta(b)


def _run_transform(transform, block) -> Tuple[Block, Dict]:
    out = transform(block)
    return out, block_meta(out)


def _run_slice(block, start, end) -> Tuple[Block, Dict]:
    out = slice_block(block, start, end)
    return out, block_meta(out)


def _slice_concat(spec, *blocks) -> Tuple[Block, Dict]:
    """spec: list of (block_index, start, end) into `blocks`."""
    out = concat_blocks([slice_block(blocks[j], s, e) for j, s, e in spec])
    return out, block_meta(out)


def _split_random(block, n, seed) -> List[Block]:
    rng = np.random.default_rng(seed)
    assignment = rng.integers(0, n, size=block.num_rows)
    import pyarrow as pa

    return [block.filter(pa.array(assignment == i)) for i in range(n)]


def _split_by_bounds(block, key, bounds, descending) -> List[Block]:
    import pyarrow as pa

    col = block.column(key).to_numpy(zero_copy_only=False)
    part = np.searchsorted(np.asarray(bounds), col, side="right")
    n = len(bounds) + 1
    if descending:
        part = (n - 1) - part
    return [block.filter(pa.array(part == i)) for i in range(n)]


def _stable_hash(v) -> int:
    """Process-independent hash: builtin hash() is salted per process for
    str/bytes, which would scatter one key across partitions when blocks
    are split by different workers."""
    import zlib

    return zlib.crc32(repr(v).encode())


def _split_by_hash(block, key, n) -> List[Block]:
    import pyarrow as pa

    col = block.column(key).to_pylist()
    part = np.fromiter((_stable_hash(v) % n for v in col), dtype=np.int64,
                       count=len(col))
    return [block.filter(pa.array(part == i)) for i in range(n)]


def _concat_shuffled(seed, *parts) -> Tuple[Block, Dict]:
    out = concat_blocks(list(parts))
    if out.num_rows:
        rng = np.random.default_rng(seed)
        out = out.take(rng.permutation(out.num_rows))
    return out, block_meta(out)


def _concat_sorted(key, descending, *parts) -> Tuple[Block, Dict]:
    out = concat_blocks(list(parts))
    if out.num_rows:
        out = out.sort_by([(key, "descending" if descending else "ascending")])
    return out, block_meta(out)


def _concat_grouped(agg_fn, *parts) -> Tuple[Block, Dict]:
    from ray_tpu_torch.data.block import batch_to_block, block_to_batch

    merged = concat_blocks(list(parts))
    if merged.num_rows == 0:
        return merged, block_meta(merged)
    out = batch_to_block(agg_fn(block_to_batch(merged, "pandas")))
    return out, block_meta(out)


def _sample_column(block, key, k=64) -> list:
    col = block.column(key).to_numpy(zero_copy_only=False)
    if len(col) == 0:
        return []
    idx = np.linspace(0, len(col) - 1, min(k, len(col))).astype(int)
    return list(col[idx])


def _zip_blocks(left, right) -> Tuple[Block, Dict]:
    import pyarrow as pa

    assert left.num_rows == right.num_rows
    cols = {name: left.column(name) for name in left.column_names}
    for name in right.column_names:
        out_name = name if name not in cols else name + "_1"
        cols[out_name] = right.column(name)
    out = pa.table(cols)
    return out, block_meta(out)


_read_r = rt.remote(_run_read)
_xform_r = rt.remote(_run_transform)
_slice_r = rt.remote(_run_slice)
_slice_concat_r = rt.remote(_slice_concat)
_split_random_r = rt.remote(_split_random)
_split_bounds_r = rt.remote(_split_by_bounds)
_split_hash_r = rt.remote(_split_by_hash)
_concat_shuffled_r = rt.remote(_concat_shuffled)
_concat_sorted_r = rt.remote(_concat_sorted)
_concat_grouped_r = rt.remote(_concat_grouped)
_sample_r = rt.remote(_sample_column)
_zip_r = rt.remote(_zip_blocks)

RefMeta = Tuple[Any, Any]  # (block ref, meta dict-or-ref)


def resolve_meta(meta) -> Dict[str, Any]:
    return meta if isinstance(meta, dict) else rt.get(meta)


# ------------------------------------------------------------------ stages


def _windowed(submit: Callable[[Any], RefMeta], upstream: Iterator,
              concurrency: int,
              max_bytes: int = DEFAULT_MAX_BYTES_IN_FLIGHT) -> Iterator[RefMeta]:
    """Bounded in-flight submission window with byte-aware backpressure:
    the effective window shrinks below `concurrency` when the running
    average block size implies more than `max_bytes` in flight."""
    window: deque = deque()
    bytes_seen = 0
    blocks_seen = 0

    def pop() -> RefMeta:
        nonlocal bytes_seen, blocks_seen
        ref, meta = window.popleft()
        m = resolve_meta(meta)
        bytes_seen += m.get("size_bytes", 0) or 0
        blocks_seen += 1
        return ref, m

    for item in upstream:
        effective = concurrency
        if blocks_seen:
            avg = max(1.0, bytes_seen / blocks_seen)
            effective = max(1, min(concurrency, int(max_bytes / avg)))
        while len(window) >= effective:
            yield pop()
        window.append(submit(item))
    while window:
        yield pop()


class ReadStage:
    def __init__(self, read_tasks, concurrency):
        self.read_tasks = read_tasks
        self.concurrency = concurrency

    def run(self, _upstream) -> Iterator[RefMeta]:
        def submit(task):
            r = _read_r.options(num_returns=2).remote(task)
            return (r[0], r[1])

        return _windowed(submit, iter(self.read_tasks), self.concurrency)


class MapStage:
    def __init__(self, transform, concurrency, num_cpus: float = None):
        self.transform = transform
        self.concurrency = concurrency
        self.num_cpus = num_cpus

    def run(self, upstream) -> Iterator[RefMeta]:
        opts = {"num_returns": 2}
        if self.num_cpus is not None:
            opts["num_cpus"] = self.num_cpus

        def submit(pair):
            r = _xform_r.options(**opts).remote(self.transform, pair[0])
            return (r[0], r[1])

        return _windowed(submit, upstream, self.concurrency)


class _MapWorker:
    """Actor body for stateful batch UDFs: constructs the callable once,
    then maps blocks through it (≈ _MapWorker in
    actor_pool_map_operator.py)."""

    def __init__(self, fn_cls, ctor_args, ctor_kwargs, batch_size,
                 batch_format, fn_args, fn_kwargs):
        from ray_tpu_torch.data._internal.logical import make_map_batches_transform

        self._fn = fn_cls(*ctor_args, **(ctor_kwargs or {}))
        self._transform = make_map_batches_transform(
            self._fn, batch_size, batch_format, fn_args, fn_kwargs)

    def apply(self, block):
        out = self._transform(block)
        return out, block_meta(out)


class ActorPoolMapStage:
    """Streams blocks through a fixed pool of stateful map actors with a
    bounded per-actor in-flight window; output order == input order."""

    def __init__(self, op: ActorPoolMap):
        self.op = op

    def run(self, upstream) -> Iterator[RefMeta]:
        op = self.op
        worker_cls = rt.remote(_MapWorker)
        pool = [
            worker_cls.options(num_cpus=op.num_cpus).remote(
                op.fn_cls, op.fn_constructor_args, op.fn_constructor_kwargs,
                op.batch_size, op.batch_format, op.fn_args, op.fn_kwargs)
            for _ in range(op.pool_size)
        ]
        inflight = [0] * len(pool)
        window: deque = deque()  # (ref, meta_ref, actor_idx)
        cap = op.pool_size * op.max_tasks_in_flight_per_actor

        def pop() -> RefMeta:
            ref, meta, idx = window.popleft()
            m = resolve_meta(meta)  # blocks until that actor finished it
            inflight[idx] -= 1
            return ref, m

        try:
            for ref, _meta in upstream:
                while len(window) >= cap:
                    yield pop()
                idx = min(range(len(pool)), key=lambda i: inflight[i])
                r = pool[idx].apply.options(num_returns=2).remote(ref)
                inflight[idx] += 1
                window.append((r[0], r[1], idx))
            while window:
                yield pop()
        finally:
            for a in pool:
                try:
                    rt.kill(a)
                except Exception:
                    pass


class LimitStage:
    def __init__(self, n):
        self.n = n

    def run(self, upstream) -> Iterator[RefMeta]:
        remaining = self.n
        if remaining <= 0:
            return
        for ref, meta in upstream:
            m = resolve_meta(meta)
            rows = m["num_rows"]
            if rows <= remaining:
                remaining -= rows
                yield ref, m
            else:
                r = _slice_r.options(num_returns=2).remote(ref, 0, remaining)
                yield r[0], r[1]
                remaining = 0
            # stop before pulling (and thereby submitting) another block
            if remaining <= 0:
                break


class AllToAllStage:
    def __init__(self, kind: str, args: Dict[str, Any], concurrency: int):
        self.kind = kind
        self.args = args
        self.concurrency = concurrency

    def run(self, upstream) -> Iterator[RefMeta]:
        if self.kind in ("shuffle", "repartition"):
            # surfaced, never silent: this is the materializing slow
            # path — seeded shuffle/repartition plans stream through the
            # channel exchange via iter_batches(streaming=True) /
            # streaming_split instead of stalling at this barrier
            logger.info(
                "AllToAll %r running as a task-executor BARRIER "
                "(every upstream block materializes in the object "
                "store); the streaming exchange "
                "(data/_internal/exchange.py) runs it as channel "
                "stages", self.kind)
        pairs = list(upstream)  # barrier: consume the whole upstream
        refs = [p[0] for p in pairs]
        metas = [resolve_meta(p[1]) for p in pairs]
        yield from getattr(self, "_" + self.kind)(refs, metas)

    def _out_count(self, refs) -> int:
        n = self.args.get("num_blocks")
        return max(1, n if n else len(refs))

    def _repartition(self, refs, metas) -> Iterator[RefMeta]:
        n = self._out_count(refs)
        rows = [m["num_rows"] for m in metas]
        total = sum(rows)
        # global row offsets of each output partition
        cuts = [round(i * total / n) for i in range(n + 1)]
        starts = np.cumsum([0] + rows)
        for i in range(n):
            lo, hi = cuts[i], cuts[i + 1]
            spec, needed = [], []
            for j, m in enumerate(metas):
                b0, b1 = starts[j], starts[j + 1]
                s, e = max(lo, b0), min(hi, b1)
                if s < e:
                    spec.append((len(needed), int(s - b0), int(e - b0)))
                    needed.append(refs[j])
            r = _slice_concat_r.options(num_returns=2).remote(spec, *needed)
            yield r[0], r[1]

    def _shuffle(self, refs, metas) -> Iterator[RefMeta]:
        n = self._out_count(refs)
        seed = self.args.get("seed")
        base = seed if seed is not None else np.random.randint(0, 2**31)
        parts = [
            _split_random_r.options(num_returns=n).remote(ref, n, base + i)
            if n > 1 else [ref]
            for i, ref in enumerate(refs)
        ]
        for j in range(n):
            mine = [parts[i][j] for i in range(len(refs))]
            r = _concat_shuffled_r.options(num_returns=2).remote(
                base + 7919 + j, *mine)
            yield r[0], r[1]

    def _sort(self, refs, metas) -> Iterator[RefMeta]:
        key = self.args["key"]
        descending = self.args.get("descending", False)
        n = self._out_count(refs)
        if n > 1:
            samples = sorted(
                itertools.chain.from_iterable(
                    rt.get([_sample_r.remote(r, key) for r in refs])))
            if samples:
                q = np.linspace(0, len(samples) - 1, n + 1).astype(int)[1:-1]
                bounds = [samples[i] for i in q]
            else:
                bounds = []
            if not bounds:
                n, bounds = 1, []
        else:
            bounds = []
        if n == 1:
            r = _concat_sorted_r.options(num_returns=2).remote(
                key, descending, *refs)
            yield r[0], r[1]
            return
        parts = [
            _split_bounds_r.options(num_returns=len(bounds) + 1).remote(
                ref, key, bounds, descending)
            for ref in refs
        ]
        for j in range(len(bounds) + 1):
            mine = [parts[i][j] for i in range(len(refs))]
            r = _concat_sorted_r.options(num_returns=2).remote(
                key, descending, *mine)
            yield r[0], r[1]

    def _groupby(self, refs, metas) -> Iterator[RefMeta]:
        key = self.args["key"]
        agg_fn = self.args["agg_fn"]
        n = min(self._out_count(refs), max(1, len(refs)))
        if n == 1:
            parts = [[r] for r in refs]
        else:
            parts = [
                _split_hash_r.options(num_returns=n).remote(ref, key, n)
                for ref in refs
            ]
        for j in range(n):
            mine = [parts[i][j] if n > 1 else parts[i][0]
                    for i in range(len(refs))]
            r = _concat_grouped_r.options(num_returns=2).remote(agg_fn, *mine)
            yield r[0], r[1]


class ZipStage:
    def __init__(self, other_ops: List[LogicalOp], concurrency: int):
        self.other_ops = other_ops
        self.concurrency = concurrency

    def run(self, upstream) -> Iterator[RefMeta]:
        left = list(upstream)
        right = list(execute_plan(self.other_ops, self.concurrency))
        l_metas = [resolve_meta(m) for _, m in left]
        r_metas = [resolve_meta(m) for _, m in right]
        if sum(m["num_rows"] for m in l_metas) != sum(
                m["num_rows"] for m in r_metas):
            raise ValueError("zip: datasets have different row counts")
        # align right side to left's block row layout
        r_refs = [r for r, _ in right]
        r_rows = [m["num_rows"] for m in r_metas]
        r_starts = np.cumsum([0] + r_rows)
        offset = 0
        for (l_ref, l_meta), lm in zip(left, l_metas):
            lo, hi = offset, offset + lm["num_rows"]
            spec, needed = [], []
            for j in range(len(r_refs)):
                b0, b1 = r_starts[j], r_starts[j + 1]
                s, e = max(lo, b0), min(hi, b1)
                if s < e:
                    spec.append((len(needed), int(s - b0), int(e - b0)))
                    needed.append(r_refs[j])
            aligned = _slice_concat_r.options(num_returns=2).remote(
                spec, *needed)
            r = _zip_r.options(num_returns=2).remote(l_ref, aligned[0])
            yield r[0], r[1]
            offset = hi


# --------------------------------------------------------------- pipeline


def execute_plan(ops: List[LogicalOp],
                 concurrency: int = DEFAULT_CONCURRENCY) -> Iterator[RefMeta]:
    """Compile the logical chain into stages and return the output stream.

    The stream is built op by op so stages that follow a Union apply to the
    combined stream, not just the left branch. Everything stays lazy: no
    task is submitted until the returned iterator is pulled.
    """
    if not ops:
        return iter(())
    source = ops[0]
    if isinstance(source, InputData):
        stream: Iterator[RefMeta] = iter(list(zip(source.block_refs,
                                                  source.metas)))
    elif isinstance(source, Read):
        stream = ReadStage(source.read_tasks, concurrency).run(None)
    else:
        raise TypeError(f"plan must start with a source, got {source!r}")

    pending_transforms: List[Any] = []

    def flush(s: Iterator[RefMeta]) -> Iterator[RefMeta]:
        if pending_transforms:
            s = MapStage(fuse_transforms(list(pending_transforms)),
                         concurrency).run(s)
            pending_transforms.clear()
        return s

    for op in ops[1:]:
        if isinstance(op, OneToOne) and op.concurrency is None \
                and op.num_cpus is None:
            pending_transforms.append(op.transform)
        elif isinstance(op, OneToOne):
            # explicit per-op concurrency/resources: own stage, not fused
            stream = MapStage(op.transform, op.concurrency or concurrency,
                              num_cpus=op.num_cpus).run(flush(stream))
        elif isinstance(op, ActorPoolMap):
            stream = ActorPoolMapStage(op).run(flush(stream))
        elif isinstance(op, Limit):
            stream = LimitStage(op.n).run(flush(stream))
        elif isinstance(op, AllToAll):
            stream = AllToAllStage(op.kind, op.args, concurrency).run(
                flush(stream))
        elif isinstance(op, Zip):
            stream = ZipStage(op.other, concurrency).run(flush(stream))
        elif isinstance(op, Union):
            stream = itertools.chain(
                flush(stream),
                *[execute_plan(t, concurrency) for t in op.others])
        else:
            raise TypeError(f"unexpected logical op {op!r}")
    return flush(stream)
