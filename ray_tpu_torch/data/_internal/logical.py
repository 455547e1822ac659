"""Logical plan operators + the fusion optimizer.

Analog of the reference's `python/ray/data/_internal/logical/` (operators,
rules, optimizers.py): a Dataset holds a linear chain of logical ops; before
execution, consecutive one-to-one ops (map/filter/flat_map/map_batches) are
fused into single block transforms (the reference's OperatorFusionRule) so
one task applies the whole chain to a block. All-to-all ops (repartition,
shuffle, sort, groupby) are pipeline barriers.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Tuple

from ray_tpu_torch.data.block import (Block, batch_to_block, batches_from_blocks,
                                block_to_batch, concat_blocks)

# A BlockTransform maps one input block to one output block.
BlockTransform = Callable[[Block], Block]


class LogicalOp:
    name = "op"


@dataclasses.dataclass
class InputData(LogicalOp):
    """Pre-existing blocks (refs) — from_items/from_pandas/materialized."""

    block_refs: List[Any]
    metas: List[Dict[str, Any]]
    name = "InputData"


@dataclasses.dataclass
class Read(LogicalOp):
    """Lazy read: a list of zero-arg callables each producing one block."""

    read_tasks: List[Callable[[], Block]]
    datasource_name: str = "read"
    name = "Read"


@dataclasses.dataclass
class OneToOne(LogicalOp):
    """A fusible row/batch transform."""

    transform: BlockTransform
    label: str = "map"
    # per-op overrides; ops with any override don't fuse (their window /
    # resource request must be their own)
    concurrency: "int | None" = None
    num_cpus: "float | None" = None
    name = "OneToOne"


@dataclasses.dataclass
class ActorPoolMap(LogicalOp):
    """A stateful batch transform on a pool of long-lived actors
    (≈ actor_pool_map_operator.py): the UDF is a class constructed once
    per actor; blocks stream through the pool. Never fused."""

    fn_cls: Any
    fn_constructor_args: tuple = ()
    fn_constructor_kwargs: dict = dataclasses.field(default_factory=dict)
    batch_size: "int | None" = None
    batch_format: str = "numpy"
    fn_args: tuple = ()
    fn_kwargs: dict = dataclasses.field(default_factory=dict)
    pool_size: int = 2
    max_tasks_in_flight_per_actor: int = 2
    num_cpus: float = 1.0
    label: str = "actor_map"
    name = "ActorPoolMap"


@dataclasses.dataclass
class Limit(LogicalOp):
    n: int = 0
    name = "Limit"


@dataclasses.dataclass
class AllToAll(LogicalOp):
    """Barrier op; `kind` in {repartition, shuffle, sort, groupby}."""

    kind: str
    args: Dict[str, Any] = dataclasses.field(default_factory=dict)
    name = "AllToAll"


@dataclasses.dataclass
class Union(LogicalOp):
    others: List[List[LogicalOp]] = dataclasses.field(default_factory=list)
    name = "Union"


@dataclasses.dataclass
class Zip(LogicalOp):
    other: List[LogicalOp] = dataclasses.field(default_factory=list)
    name = "Zip"


# ------------------------------------------------------------- transforms


def make_map_batches_transform(
    fn: Callable,
    batch_size: Optional[int],
    batch_format: str,
    fn_args: Tuple = (),
    fn_kwargs: Optional[Dict] = None,
) -> BlockTransform:
    fn_kwargs = fn_kwargs or {}

    def transform(block: Block) -> Block:
        outs = []
        for batch in batches_from_blocks([block], batch_size, batch_format):
            out = fn(batch, *fn_args, **fn_kwargs)
            outs.append(batch_to_block(out))
        return concat_blocks(outs)

    return transform


def make_map_rows_transform(fn: Callable) -> BlockTransform:
    def transform(block: Block) -> Block:
        rows = [fn(row) for row in block.to_pylist()]
        # empty input: keep an empty block rather than letting the list
        # fallback invent an 'item' schema
        return batch_to_block(rows) if rows else block.slice(0, 0)

    return transform


def make_flat_map_transform(fn: Callable) -> BlockTransform:
    def transform(block: Block) -> Block:
        rows = []
        for row in block.to_pylist():
            rows.extend(fn(row))
        return batch_to_block(rows) if rows else block.slice(0, 0)

    return transform


def make_filter_transform(fn: Callable) -> BlockTransform:
    def transform(block: Block) -> Block:
        import numpy as np
        import pyarrow as pa

        mask = np.fromiter((bool(fn(r)) for r in block.to_pylist()),
                           dtype=bool, count=block.num_rows)
        return block.filter(pa.array(mask))

    return transform


def make_add_column_transform(name: str, fn: Callable) -> BlockTransform:
    def transform(block: Block) -> Block:
        batch = block_to_batch(block, "pandas")
        batch[name] = fn(batch)
        return batch_to_block(batch)

    return transform


def fuse_transforms(ts: List[BlockTransform]) -> BlockTransform:
    if len(ts) == 1:
        return ts[0]

    def fused(block: Block) -> Block:
        for t in ts:
            block = t(block)
        return block

    return fused
