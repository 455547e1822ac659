"""The Dataset API.

Analog of `ray.data.Dataset` (`python/ray/data/dataset.py:137`;
map_batches `:371`, iter_batches `:3641`, materialize `:4521`): a lazy
logical plan over distributed Arrow blocks, executed by the streaming
executor on the task layer. The card's angle: `iter_batches` composes
with `DataIterator.iter_device_batches` (a pinned prefetch: each batch is
staged in pinned host memory and copied on a stream of its own, batches
ahead of the step) so ingest overlaps with device compute — the
plasma-zero-copy role is played by host Arrow blocks + async copies to
the card (SURVEY §5 backend note).
"""

from __future__ import annotations

import builtins
import logging
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple, Union as TUnion

import numpy as np

import dataclasses

import ray_tpu_torch as rt
from ray_tpu_torch.data._internal import logical as L
from ray_tpu_torch.data._internal.executor import (DEFAULT_CONCURRENCY,
                                             execute_plan, resolve_meta)
from ray_tpu_torch.data.block import (Block, batch_to_block, block_meta,
                                block_rows, block_to_batch, even_cuts)
from ray_tpu_torch.data.iterator import DataIterator, _BlockStreamIterator

logger = logging.getLogger(__name__)


@dataclasses.dataclass
class ActorPoolStrategy:
    """Stateful-UDF compute strategy (≈ ray.data.ActorPoolStrategy):
    class UDFs run on a FIXED pool of long-lived actors sized `size`,
    falling back to `max_size` then `min_size` (accepted for API parity;
    this pool does not autoscale between min and max)."""

    size: Optional[int] = None
    min_size: Optional[int] = None
    max_size: Optional[int] = None

    @property
    def pool_size(self) -> Optional[int]:
        """None when the strategy doesn't specify a size — map_batches
        then falls through to its `concurrency` argument."""
        if self.size or self.max_size or self.min_size:
            return int(self.size or self.max_size or self.min_size)
        return None


class Dataset:
    def __init__(self, ops: List[L.LogicalOp],
                 concurrency: int = DEFAULT_CONCURRENCY):
        self._ops = ops
        self._concurrency = concurrency

    # ------------------------------------------------------------ plumbing

    def _with(self, op: L.LogicalOp) -> "Dataset":
        return Dataset(self._ops + [op], self._concurrency)

    def _stream(self):
        return execute_plan(self._ops, self._concurrency)

    def iter_internal_ref_bundles(self):
        """Public-ish escape hatch (reference: Dataset.iter_internal_ref_bundles)."""
        return self._stream()

    # ---------------------------------------------------------- transforms

    def map_batches(
        self,
        fn: Callable,
        *,
        batch_size: Optional[int] = None,
        batch_format: str = "numpy",
        fn_args: Tuple = (),
        fn_kwargs: Optional[Dict] = None,
        compute: Optional["ActorPoolStrategy"] = None,
        concurrency: Optional[int] = None,
        num_cpus: Optional[float] = None,
        fn_constructor_args: Tuple = (),
        fn_constructor_kwargs: Optional[Dict] = None,
    ) -> "Dataset":
        """Map a UDF over batches.

        A class UDF (or compute=ActorPoolStrategy) runs on a pool of
        long-lived actors — the constructor runs once per actor, the
        stateful instance maps every batch (model-inference pattern).
        `concurrency` bounds in-flight tasks for function UDFs, or sets
        the pool size for class UDFs.
        """
        import inspect

        is_class_udf = inspect.isclass(fn)
        if compute is not None and not isinstance(compute, ActorPoolStrategy):
            raise TypeError(
                f"compute must be ActorPoolStrategy, got {compute!r}")
        if is_class_udf or compute is not None:
            if not is_class_udf:
                raise TypeError(
                    "compute=ActorPoolStrategy requires a class UDF")
            size = (compute.pool_size if compute is not None else None) \
                or concurrency or 2
            return self._with(L.ActorPoolMap(
                fn_cls=fn,
                fn_constructor_args=tuple(fn_constructor_args),
                fn_constructor_kwargs=dict(fn_constructor_kwargs or {}),
                batch_size=batch_size,
                batch_format=batch_format,
                fn_args=tuple(fn_args),
                fn_kwargs=dict(fn_kwargs or {}),
                pool_size=int(size),
                num_cpus=float(num_cpus if num_cpus is not None else 1.0),
                label=getattr(fn, "__name__", "actor_map")))
        if fn_constructor_args or fn_constructor_kwargs:
            raise TypeError(
                "fn_constructor_args/kwargs only apply to class UDFs")
        return self._with(L.OneToOne(
            L.make_map_batches_transform(fn, batch_size, batch_format,
                                         fn_args, fn_kwargs),
            label=getattr(fn, "__name__", "map_batches"),
            concurrency=concurrency,
            num_cpus=num_cpus))

    def map(self, fn: Callable) -> "Dataset":
        return self._with(L.OneToOne(L.make_map_rows_transform(fn),
                                     label="map"))

    def flat_map(self, fn: Callable) -> "Dataset":
        return self._with(L.OneToOne(L.make_flat_map_transform(fn),
                                     label="flat_map"))

    def filter(self, fn: Callable) -> "Dataset":
        return self._with(L.OneToOne(L.make_filter_transform(fn),
                                     label="filter"))

    def add_column(self, name: str, fn: Callable) -> "Dataset":
        return self._with(L.OneToOne(L.make_add_column_transform(name, fn),
                                     label=f"add_column({name})"))

    def drop_columns(self, cols: List[str]) -> "Dataset":
        return self.map_batches(
            lambda b: b.drop_columns(cols), batch_format="pyarrow")

    def select_columns(self, cols: List[str]) -> "Dataset":
        return self.map_batches(
            lambda b: b.select(cols), batch_format="pyarrow")

    def rename_columns(self, mapping: Dict[str, str]) -> "Dataset":
        def rename(b):
            return b.rename_columns(
                [mapping.get(c, c) for c in b.column_names])

        return self.map_batches(rename, batch_format="pyarrow")

    def limit(self, n: int) -> "Dataset":
        return self._with(L.Limit(n))

    def repartition(self, num_blocks: int) -> "Dataset":
        return self._with(L.AllToAll("repartition",
                                     {"num_blocks": num_blocks}))

    def random_shuffle(self, *, seed: Optional[int] = None) -> "Dataset":
        return self._with(L.AllToAll("shuffle", {"seed": seed}))

    def sort(self, key: str, descending: bool = False) -> "Dataset":
        return self._with(L.AllToAll(
            "sort", {"key": key, "descending": descending}))

    def groupby(self, key: str) -> "GroupedData":
        return GroupedData(self, key)

    def union(self, *others: "Dataset") -> "Dataset":
        return self._with(L.Union(others=[o._ops for o in others]))

    def zip(self, other: "Dataset") -> "Dataset":
        return self._with(L.Zip(other=other._ops))

    # --------------------------------------------------------- consumption

    def iter_blocks(self) -> Iterator[Block]:
        for ref, _meta in self._stream():
            yield rt.get(ref)

    def iter_batches(self, *, batch_size: Optional[int] = 256,
                     batch_format: str = "numpy", drop_last: bool = False,
                     prefetch_batches: int = 1,
                     local_shuffle_buffer_size: Optional[int] = None,
                     local_shuffle_seed: Optional[int] = None,
                     streaming: bool = False):
        """Iterate fixed-size batches.

        ``streaming=True`` routes a read->map plan through the compiled
        streaming pipeline (`stream_batches`) instead of the task-based
        executor: shard readers -> transform actors -> batcher over
        slot-ring channels, ``prefetch_batches`` becoming the channel
        depth (the backpressure bound). Streaming yields numpy batches
        only and its windowed shuffle runs inside the batcher stage
        (same knobs, its own seeded stream) — plans that need barriers
        or materialized refs raise rather than silently falling back.
        """
        if streaming:
            if batch_format != "numpy":
                raise ValueError(
                    "streaming=True yields numpy batches only "
                    f"(got batch_format={batch_format!r})")
            return self.stream_batches(
                batch_size=batch_size,
                drop_last=drop_last,
                # the task path's default (1) means "default depth" here,
                # not a depth-1 ring; explicit zeros still raise inside
                prefetch_batches=prefetch_batches,
                shuffle_buffer=local_shuffle_buffer_size,
                seed=local_shuffle_seed)
        return self.iterator().iter_batches(
            batch_size=batch_size, batch_format=batch_format,
            drop_last=drop_last, prefetch_batches=prefetch_batches,
            local_shuffle_buffer_size=local_shuffle_buffer_size,
            local_shuffle_seed=local_shuffle_seed)

    def stream_batches(self, *, batch_size: Optional[int] = 256,
                       epochs: int = 1, seed: Optional[int] = 0,
                       shuffle_buffer: Optional[int] = None,
                       num_readers: Optional[int] = None,
                       prefetch_batches: Optional[int] = None,
                       depth: Optional[int] = None,
                       drop_last: bool = False, **kw):
        """Consume this dataset through the compiled streaming pipeline
        (`data/_internal/streaming.py`): shard readers -> transform
        actors -> a fixed-shape batcher over depth-k channels, zero
        steady-state control-plane RPCs per stage. Yields numpy-dict
        batches for ``epochs`` passes, the shard order re-seeded per
        epoch; the iterator's ``.epoch_stats`` carries per-epoch stall
        and RPC accounting and ``.executor`` exposes ``feed()`` for
        handing batches to a trainer without a copy.

        A plan ending in a seeded ``random_shuffle()`` or
        ``repartition()`` compiles onto the streaming ALL-TO-ALL
        exchange (`data/_internal/exchange.py`): R producers partition
        rows into per-consumer bucket frames over an R x C channel mesh
        instead of a task-executor barrier. An all-to-all plan the
        exchange can't run (unseeded shuffle, sort/groupby, chained
        barriers) RAISES with the reason — the barrier path stays
        available via iter_batches without streaming=True, never as a
        silent fallback."""
        from ray_tpu_torch.data._internal import logical as _L
        from ray_tpu_torch.data._internal.exchange import (
            ExchangeBatches, exchange_incompatible_reason)
        from ray_tpu_torch.data._internal.streaming import StreamingBatches

        if depth is None and prefetch_batches is not None \
                and prefetch_batches != 1:
            # depth= is the precise knob (any ring depth, including 1);
            # prefetch_batches rides along from iter_batches, whose
            # task-path default of 1 means "default depth" here. An
            # explicit 0 on either raises inside (the falsy-zero lesson)
            depth = prefetch_batches
        if any(isinstance(op, _L.AllToAll) for op in self._ops):
            reason = exchange_incompatible_reason(self._ops)
            if reason is not None:
                raise ValueError(
                    f"streaming execution of this all-to-all plan is "
                    f"not supported: {reason}; run it on the "
                    f"task-based executor (iter_batches without "
                    f"streaming=True)")
            return ExchangeBatches(
                self._ops, batch_size=batch_size, epochs=epochs,
                seed=seed, shuffle_buffer=shuffle_buffer,
                num_producers=num_readers, depth=depth,
                drop_last=drop_last, **kw)
        return StreamingBatches(
            self._ops, batch_size=batch_size, epochs=epochs, seed=seed,
            shuffle_buffer=shuffle_buffer, num_readers=num_readers,
            depth=depth, drop_last=drop_last, **kw)

    def iter_rows(self) -> Iterator[Dict[str, Any]]:
        for block in self.iter_blocks():
            yield from block_rows(block)

    def iterator(self) -> DataIterator:
        return _BlockStreamIterator(self)

    def iter_torch_batches(self, **kw):
        return self.iterator().iter_torch_batches(**kw)

    def iter_device_batches(self, **kw):
        return self.iterator().iter_device_batches(**kw)

    def take(self, n: int = 20) -> List[Dict[str, Any]]:
        out: List[Dict[str, Any]] = []
        for row in self.limit(n).iter_rows():
            out.append(row)
            if len(out) >= n:
                break
        return out

    def take_all(self) -> List[Dict[str, Any]]:
        return list(self.iter_rows())

    def take_batch(self, batch_size: int = 20,
                   batch_format: str = "numpy") -> Any:
        for batch in self.limit(batch_size).iter_batches(
                batch_size=batch_size, batch_format=batch_format):
            return batch
        raise ValueError("dataset is empty")

    def count(self) -> int:
        return sum(resolve_meta(m)["num_rows"] for _, m in self._stream())

    def schema(self):
        for ref, _ in self._stream():
            return rt.get(ref).schema
        return None

    def columns(self) -> List[str]:
        s = self.schema()
        return list(s.names) if s is not None else []

    def size_bytes(self) -> int:
        return sum(resolve_meta(m)["size_bytes"] for _, m in self._stream())

    def num_blocks(self) -> int:
        return sum(1 for _ in self._stream())

    def stats(self) -> str:
        n, rows, size = 0, 0, 0
        for _, m in self._stream():
            m = resolve_meta(m)
            n += 1
            rows += m["num_rows"]
            size += m["size_bytes"]
        return (f"Dataset: {n} blocks, {rows} rows, {size} bytes; "
                f"plan={[type(o).__name__ for o in self._ops]}")

    # aggregates
    def sum(self, col: str):
        return self._agg(col, np.sum)

    def min(self, col: str):
        return self._agg(col, np.min)

    def max(self, col: str):
        return self._agg(col, np.max)

    def mean(self, col: str):
        total, count = 0.0, 0
        for b in self.iter_blocks():
            if b.num_rows:
                a = b.column(col).to_numpy(zero_copy_only=False)
                total += float(a.sum())
                count += len(a)
        return total / count if count else float("nan")

    def _agg(self, col: str, fn):
        vals = [fn(b.column(col).to_numpy(zero_copy_only=False))
                for b in self.iter_blocks() if b.num_rows]
        return fn(np.array(vals)).item() if vals else None

    # ------------------------------------------------------ materialization

    def materialize(self) -> "MaterializedDataset":
        refs, metas = [], []
        for ref, m in self._stream():
            refs.append(ref)
            metas.append(resolve_meta(m))
        return MaterializedDataset(
            [L.InputData(block_refs=refs, metas=metas)], self._concurrency)

    def split(self, n: int) -> List["MaterializedDataset"]:
        """Materialize and split into n contiguous sub-datasets
        (reference: Dataset.split)."""
        mat = self.materialize()
        src: L.InputData = mat._ops[0]
        cuts = even_cuts(len(src.block_refs), n)
        # pad so exactly n datasets come back (gang consumers index by rank)
        while len(cuts) - 1 < n:
            cuts.append(cuts[-1])
        return [
            MaterializedDataset(
                [L.InputData(block_refs=src.block_refs[cuts[i]:cuts[i + 1]],
                             metas=src.metas[cuts[i]:cuts[i + 1]])],
                self._concurrency)
            for i in builtins.range(n)
        ]

    def streaming_split(self, n: int, *, equal: bool = False,
                        locality_hints=None, epochs: int = 1,
                        seed: Optional[int] = 0) -> List[DataIterator]:
        """n iterators fed by one shared streaming execution
        (reference: Dataset.streaming_split / _StreamSplitDataIterator).

        A plan ending in a seeded ``random_shuffle()``/``repartition()``
        compiles onto the streaming all-to-all exchange: n consumer
        stages each own one output channel and every iterator reads its
        own rank's stream — deterministic partition-assigned splits
        (exact vs the task baseline at the same seed), with
        ``locality_hints`` (node_id_hex per rank) steering each
        consumer onto the node its reader lives on. Other plans are fed
        first-come-first-served by a coordinator actor (faster
        consumers do more work — the dynamic-balancing path); an
        all-to-all plan the exchange can't run (unseeded shuffle,
        sort/groupby) falls back to the coordinator WITH a logged
        reason, never silently."""
        from ray_tpu_torch.data._internal.exchange import (
            ExchangeExecutor, exchange_incompatible_reason)
        from ray_tpu_torch.data.iterator import (_ExchangeSplitIterator,
                                           _SplitCoordinator,
                                           _StreamSplitIterator)

        if any(isinstance(op, L.AllToAll) for op in self._ops):
            reason = exchange_incompatible_reason(self._ops)
            if reason is None:
                ex = ExchangeExecutor(
                    self._ops, batch_size=None, epochs=epochs, seed=seed,
                    num_consumers=n, locality_hints=locality_hints)
                return [_ExchangeSplitIterator(ex, rank=i)
                        for i in builtins.range(n)]
            logger.warning(
                "streaming_split falling back to the coordinator-fed "
                "task executor (all-to-all runs as a BARRIER): %s",
                reason)
        coord = rt.remote(_SplitCoordinator).options(
            num_cpus=0.1).remote(self._ops, self._concurrency, n, equal)
        return [_StreamSplitIterator(coord, rank=i) for i in builtins.range(n)]

    # ------------------------------------------------------------- writes

    def write_parquet(self, path: str) -> List[str]:
        return self._write(path, "parquet")

    def write_csv(self, path: str) -> List[str]:
        return self._write(path, "csv")

    def write_json(self, path: str) -> List[str]:
        return self._write(path, "json")

    def write_tfrecords(self, path: str) -> List[str]:
        return self._write(path, "tfrecords")

    def _write(self, path: str, fmt: str) -> List[str]:
        from ray_tpu_torch.data.datasource import write_block

        w = rt.remote(write_block)
        refs = [w.remote(ref, path, i, fmt)
                for i, (ref, _m) in enumerate(self._stream())]
        return rt.get(refs)

    # ------------------------------------------------------------- interop

    def to_pandas(self, limit: Optional[int] = None):
        import pandas as pd

        ds = self.limit(limit) if limit else self
        frames = [b.to_pandas() for b in ds.iter_blocks()]
        if not frames:
            return pd.DataFrame()
        return pd.concat(frames, ignore_index=True)

    def to_arrow_refs(self) -> List[Any]:
        return [ref for ref, _ in self._stream()]

    def __repr__(self) -> str:
        return (f"Dataset(ops={[type(o).__name__ for o in self._ops]})")


class MaterializedDataset(Dataset):
    pass


# ------------------------------------------------------------- groupby


class GroupedData:
    """Analog of `ray.data.grouped_data.GroupedData`."""

    def __init__(self, ds: Dataset, key: str):
        self._ds = ds
        self._key = key

    def _agg(self, agg_fn) -> Dataset:
        return self._ds._with(L.AllToAll(
            "groupby", {"key": self._key, "agg_fn": agg_fn}))

    def count(self) -> Dataset:
        key = self._key

        def fn(df):
            out = df.groupby(key, sort=True).size().reset_index(name="count()")
            return out

        return self._agg(fn)

    def sum(self, col: str) -> Dataset:
        return self._named_agg(col, "sum")

    def mean(self, col: str) -> Dataset:
        return self._named_agg(col, "mean")

    def min(self, col: str) -> Dataset:
        return self._named_agg(col, "min")

    def max(self, col: str) -> Dataset:
        return self._named_agg(col, "max")

    def std(self, col: str) -> Dataset:
        return self._named_agg(col, "std")

    def _named_agg(self, col: str, how: str) -> Dataset:
        key = self._key

        def fn(df):
            out = (df.groupby(key, sort=True)[col].agg(how)
                   .reset_index(name=f"{how}({col})"))
            return out

        return self._agg(fn)

    def map_groups(self, fn: Callable, *,
                   batch_format: str = "pandas") -> Dataset:
        key = self._key

        def apply(df):
            import pandas as pd

            outs = []
            for _, g in df.groupby(key, sort=True):
                if batch_format == "numpy":
                    res = fn({c: g[c].to_numpy() for c in g.columns})
                    outs.append(block_to_batch(batch_to_block(res), "pandas"))
                else:
                    outs.append(fn(g))
            return pd.concat(outs, ignore_index=True)

        return self._agg(apply)


# --------------------------------------------------------------- sources


def _input_dataset(blocks: List[Block], concurrency=DEFAULT_CONCURRENCY,
                   target_rows_per_block: Optional[int] = None) -> Dataset:
    refs, metas = [], []
    for b in blocks:
        refs.append(rt.put(b))
        metas.append(block_meta(b))
    return Dataset([L.InputData(block_refs=refs, metas=metas)], concurrency)


def _chunk(n_items: int, parallelism: int) -> List[Tuple[int, int]]:
    cuts = even_cuts(n_items, parallelism)
    return [(cuts[i], cuts[i + 1]) for i in builtins.range(len(cuts) - 1)
            if cuts[i] < cuts[i + 1]]


def from_items(items: List[Any], *, parallelism: int = 16) -> Dataset:
    if items and not isinstance(items[0], dict):
        items = [{"item": x} for x in items]
    blocks = [batch_to_block(items[lo:hi])
              for lo, hi in _chunk(len(items), parallelism)] or [
                  batch_to_block([])]
    return _input_dataset(blocks)


def range(n: int, *, parallelism: int = 16) -> Dataset:
    from ray_tpu_torch.data.datasource import range_tasks

    return Dataset([L.Read(read_tasks=range_tasks(n, parallelism),
                           datasource_name="range")])


def range_tensor(n: int, *, shape: Tuple[int, ...] = (1,),
                 parallelism: int = 16) -> Dataset:
    from ray_tpu_torch.data.datasource import range_tensor_tasks

    return Dataset([L.Read(read_tasks=range_tensor_tasks(n, shape,
                                                         parallelism),
                           datasource_name="range_tensor")])


def from_pandas(dfs) -> Dataset:
    import pandas as pd

    if isinstance(dfs, pd.DataFrame):
        dfs = [dfs]
    return _input_dataset([batch_to_block(df) for df in dfs])


def from_arrow(tables) -> Dataset:
    import pyarrow as pa

    if isinstance(tables, pa.Table):
        tables = [tables]
    return _input_dataset(list(tables))


def from_numpy(arrays, column: str = "data") -> Dataset:
    if isinstance(arrays, np.ndarray):
        arrays = [arrays]
    return _input_dataset([batch_to_block({column: a}) for a in arrays])


def read_parquet(paths, *, columns=None, **_kw) -> Dataset:
    from ray_tpu_torch.data.datasource import parquet_tasks

    return Dataset([L.Read(read_tasks=parquet_tasks(paths, columns),
                           datasource_name="parquet")])


def read_csv(paths, **_kw) -> Dataset:
    from ray_tpu_torch.data.datasource import csv_tasks

    return Dataset([L.Read(read_tasks=csv_tasks(paths),
                           datasource_name="csv")])


def read_json(paths, **_kw) -> Dataset:
    from ray_tpu_torch.data.datasource import json_tasks

    return Dataset([L.Read(read_tasks=json_tasks(paths),
                           datasource_name="json")])


def read_numpy(paths, **_kw) -> Dataset:
    from ray_tpu_torch.data.datasource import numpy_tasks

    return Dataset([L.Read(read_tasks=numpy_tasks(paths),
                           datasource_name="numpy")])


def read_binary_files(paths, **_kw) -> Dataset:
    from ray_tpu_torch.data.datasource import binary_tasks

    return Dataset([L.Read(read_tasks=binary_tasks(paths),
                           datasource_name="binary")])


def read_tfrecords(paths, **_kw) -> Dataset:
    """TFRecord files of tf.train.Example protos (pure-python parser —
    no tensorflow/protobuf dependency). ≈ `ray.data.read_tfrecords`."""
    from ray_tpu_torch.data.datasource import tfrecord_tasks

    return Dataset([L.Read(read_tasks=tfrecord_tasks(paths),
                           datasource_name="tfrecords")])


def read_images(paths, *, size=None, mode=None, **_kw) -> Dataset:
    """Image files -> {"image": [H,W,C], "path"} rows (PIL decode).
    ≈ `ray.data.read_images`."""
    from ray_tpu_torch.data.datasource import image_tasks

    return Dataset([L.Read(read_tasks=image_tasks(paths, size, mode),
                           datasource_name="images")])


def read_webdataset(paths, **_kw) -> Dataset:
    """WebDataset tar shards: one row per sample key, one column per member
    extension. ≈ `ray.data.read_webdataset`."""
    from ray_tpu_torch.data.datasource import webdataset_tasks

    return Dataset([L.Read(read_tasks=webdataset_tasks(paths),
                           datasource_name="webdataset")])


def read_sql(sql: str, connection_factory, *, partition_column=None,
             lower_bound=None, upper_bound=None, parallelism: int = 1,
             **_kw) -> Dataset:
    """DBAPI-2 query -> dataset. ≈ `ray.data.read_sql`. With
    `partition_column` + bounds the read fans out into `parallelism`
    range-partitioned queries (warehouse parallel-read recipe)."""
    from ray_tpu_torch.data.datasource import sql_tasks

    return Dataset([L.Read(
        read_tasks=sql_tasks(sql, connection_factory,
                             partition_column=partition_column,
                             lower_bound=lower_bound,
                             upper_bound=upper_bound,
                             parallelism=parallelism),
        datasource_name="sql")])


def read_orc(paths, **_kw) -> Dataset:
    """ORC files -> dataset (≈ `ray.data.read_orc`, pyarrow-native)."""
    from ray_tpu_torch.data.datasource import orc_tasks

    return Dataset([L.Read(read_tasks=orc_tasks(paths),
                           datasource_name="orc")])


def read_mongo(uri: str, database: str, collection: str, *,
               pipeline=None, parallelism: int = 4, client_factory=None,
               **_kw) -> Dataset:
    """MongoDB collection -> dataset (≈ `ray.data.read_mongo`): _id
    range partitions, one cursor task each."""
    from ray_tpu_torch.data.datasource import mongo_tasks

    return Dataset([L.Read(
        read_tasks=mongo_tasks(uri, database, collection,
                               pipeline=pipeline, parallelism=parallelism,
                               client_factory=client_factory),
        datasource_name="mongo")])


def from_huggingface(hf_dataset, *, parallelism: int = 8) -> Dataset:
    """HuggingFace datasets.Dataset -> dataset (≈
    `ray.data.from_huggingface`): zero-copy via the underlying arrow
    table, split into `parallelism` blocks."""
    table = hf_dataset.data.table if hasattr(hf_dataset, "data") else None
    if table is None:
        raise TypeError("from_huggingface expects a datasets.Dataset "
                        "(arrow-backed)")
    n = max(1, table.num_rows)
    per = max(1, -(-n // parallelism))

    def make(lo, hi):
        return lambda: table.slice(lo, hi - lo)

    import builtins

    # this module shadows `range` with the ray.data.range constructor
    tasks = [make(lo, min(lo + per, n))
             for lo in builtins.range(0, n, per)]
    return Dataset([L.Read(read_tasks=tasks,
                           datasource_name="huggingface")])


def read_bigquery(project_id: str, *, dataset: str = None, query: str = None,
                  parallelism: int = 4, client_factory=None,
                  **_kw) -> Dataset:
    """Cloud-warehouse read (≈ `ray.data.read_bigquery`,
    `python/ray/data/datasource/bigquery_datasource.py`): a query's
    destination table (or a named table) read with one task per
    row-range stream. `client_factory` injects the client (production
    default: google.cloud.bigquery.Client, gated on the library)."""
    from ray_tpu_torch.data.datasource import bigquery_tasks

    return Dataset([L.Read(
        read_tasks=bigquery_tasks(project_id, dataset=dataset, query=query,
                                  parallelism=parallelism,
                                  client_factory=client_factory),
        datasource_name="bigquery")])
