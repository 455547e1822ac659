"""Blocks — the unit of distributed data.

Analog of the reference's `python/ray/data/block.py` +
`_internal/arrow_block.py`: a block is one pyarrow.Table living in the
object store; metadata (row count, byte size) travels as a second, inlined
task return so planners never fetch payloads to learn sizes. Batches
convert between arrow / pandas / numpy-dict at the boundary only.
"""

from __future__ import annotations

from typing import Any, Dict, Iterable, Iterator, List, Optional

import numpy as np
import pyarrow as pa

Block = pa.Table


def even_cuts(n: int, parts: int) -> List[int]:
    """parts+1 cut points splitting n items as evenly as possible."""
    parts = max(1, min(parts, n or 1))
    return [round(i * n / parts) for i in range(parts + 1)]


def block_meta(block: Block) -> Dict[str, Any]:
    return {"num_rows": block.num_rows, "size_bytes": block.nbytes}


def batch_to_block(batch: Any) -> Block:
    """Accepts pyarrow.Table, pandas.DataFrame, dict of arrays/lists, or a
    list of row-dicts."""
    if isinstance(batch, pa.Table):
        return batch
    try:
        import pandas as pd

        if isinstance(batch, pd.DataFrame):
            return pa.Table.from_pandas(batch, preserve_index=False)
    except ImportError:
        pass
    if isinstance(batch, dict):
        cols = {}
        for k, v in batch.items():
            v = np.asarray(v) if not isinstance(v, np.ndarray) else v
            if v.ndim > 1:
                cols[k] = _tensor_column(v)
            else:
                cols[k] = pa.array(v)
        return pa.table(cols)
    if isinstance(batch, list):
        if batch and isinstance(batch[0], dict):
            keys = batch[0].keys()
            return batch_to_block({k: [r[k] for r in batch] for k in keys})
        return pa.table({"item": pa.array(batch)})
    raise TypeError(f"cannot convert {type(batch).__name__} to a block")


def _is_list(typ) -> bool:
    return pa.types.is_list(typ) or pa.types.is_large_list(typ)


def _tensor_column(v: np.ndarray) -> pa.Array:
    """A tensor column as nested arrow lists of the array's own element
    type, built from its flat values (int32 stays int32, float32 stays
    float32). Other element kinds, empty arrays and arrays past int32 list
    offsets go through ``tolist()`` (arrow infers nesting from nested
    lists, not from an array of ndarrays)."""
    if v.dtype.kind not in "biuf" or v.size == 0 or v.size >= 2 ** 31:
        return pa.array(v.tolist())
    arr = pa.array(np.ascontiguousarray(v).reshape(-1))
    for dim in reversed(v.shape[1:]):
        rows = len(arr) // dim
        offsets = np.arange(rows + 1, dtype=np.int32) * dim
        arr = pa.ListArray.from_arrays(pa.array(offsets), arr)
    return arr


def _uniform_lists_to_numpy(col: pa.ChunkedArray) -> Optional[np.ndarray]:
    """A list column whose lists are all of one length at every level and
    hold numbers without nulls, as one writable ndarray of the element
    type; None for anything else."""
    arr = col.combine_chunks()
    shape = [len(arr)]
    while _is_list(arr.type):
        if arr.null_count or len(arr) == 0:
            return None
        offsets = np.asarray(arr.offsets)
        lens = np.diff(offsets)
        if (lens != lens[0]).any():
            return None
        shape.append(int(lens[0]))
        arr = arr.values.slice(int(offsets[0]),
                               int(offsets[-1] - offsets[0]))
    if arr.null_count or not (pa.types.is_integer(arr.type)
                              or pa.types.is_floating(arr.type)
                              or pa.types.is_boolean(arr.type)):
        return None
    out = arr.to_numpy(zero_copy_only=False).reshape(shape)
    # writable, as the nested-list path gives it (a UDF may write to it)
    return out if out.flags.writeable else out.copy()


def _column_to_numpy(col: pa.ChunkedArray) -> np.ndarray:
    if _is_list(col.type):
        out = _uniform_lists_to_numpy(col)
        if out is not None:
            return out
        pylist = col.to_pylist()
        try:
            return np.asarray(pylist)
        except ValueError:  # ragged
            return np.asarray(pylist, dtype=object)
    try:
        return col.to_numpy(zero_copy_only=False)
    except (pa.ArrowInvalid, pa.ArrowNotImplementedError):
        return np.asarray(col.to_pylist(), dtype=object)


def block_to_batch(block: Block, batch_format: str = "numpy") -> Any:
    if batch_format in ("pyarrow", "arrow"):
        return block
    if batch_format == "pandas":
        return block.to_pandas()
    if batch_format in ("numpy", "default"):
        return {name: _column_to_numpy(block.column(name))
                for name in block.column_names}
    raise ValueError(f"unknown batch_format {batch_format!r}")


def block_rows(block: Block) -> Iterator[Dict[str, Any]]:
    for row in block.to_pylist():
        yield row


def slice_block(block: Block, start: int, end: int) -> Block:
    return block.slice(start, end - start)


def concat_blocks(blocks: List[Block]) -> Block:
    blocks = [b for b in blocks if b is not None and b.num_rows > 0]
    if not blocks:
        return pa.table({})
    if len(blocks) == 1:
        return blocks[0]
    return pa.concat_tables(blocks, promote_options="permissive")


def batches_from_blocks(
    blocks: Iterable[Block],
    batch_size: Optional[int],
    batch_format: str = "numpy",
    drop_last: bool = False,
) -> Iterator[Any]:
    """Re-chunk a block stream into fixed-size batches (the reference's
    `_internal/block_batching/`)."""
    if batch_size is None:
        for b in blocks:
            if b.num_rows > 0:
                yield block_to_batch(b, batch_format)
        return
    carry: List[Block] = []
    carry_rows = 0
    for b in blocks:
        carry.append(b)
        carry_rows += b.num_rows
        while carry_rows >= batch_size:
            merged = concat_blocks(carry)
            yield block_to_batch(slice_block(merged, 0, batch_size),
                                 batch_format)
            merged = slice_block(merged, batch_size, merged.num_rows)
            carry = [merged]
            carry_rows = merged.num_rows
    if carry_rows > 0 and not drop_last:
        merged = concat_blocks(carry)
        if merged.num_rows:
            yield block_to_batch(merged, batch_format)
