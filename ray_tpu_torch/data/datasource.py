"""Read tasks and write functions for the built-in formats.

Analog of the reference's `python/ray/data/datasource/` (parquet, csv,
json, numpy, range, binary sources and the corresponding datasinks). A
read task is a zero-arg callable returning one Block, executed remotely by
the streaming executor's ReadStage.
"""

from __future__ import annotations

import glob
import os
from typing import Callable, List, Optional

import numpy as np
import pyarrow as pa

from ray_tpu_torch.data.block import Block, batch_to_block, even_cuts


def _expand_paths(paths, suffix: Optional[str] = None) -> List[str]:
    if isinstance(paths, str):
        paths = [paths]
    files: List[str] = []
    for p in paths:
        p = os.path.expanduser(p)
        if os.path.isdir(p):
            pattern = os.path.join(p, "**", f"*{suffix or ''}")
            files.extend(f for f in glob.glob(pattern, recursive=True)
                         if os.path.isfile(f))
        elif any(ch in p for ch in "*?["):
            files.extend(f for f in glob.glob(p) if os.path.isfile(f))
        elif os.path.isfile(p):
            files.append(p)
        else:
            raise FileNotFoundError(p)
    if not files:
        raise FileNotFoundError(f"no files matched {paths!r}")
    return sorted(files)


# ------------------------------------------------------------- read tasks


def range_tasks(n: int, parallelism: int) -> List[Callable[[], Block]]:
    cuts = even_cuts(n, parallelism)

    def make(lo: int, hi: int):
        return lambda: pa.table({"id": np.arange(lo, hi, dtype=np.int64)})

    return [make(cuts[i], cuts[i + 1]) for i in range(len(cuts) - 1)]


def range_tensor_tasks(n: int, shape, parallelism: int):
    cuts = even_cuts(n, parallelism)

    def make(lo: int, hi: int):
        def task():
            count = hi - lo
            base = np.arange(lo, hi, dtype=np.int64).reshape(
                (count,) + (1,) * len(shape))
            data = np.broadcast_to(base, (count,) + tuple(shape)).copy()
            return batch_to_block({"data": data})

        return task

    return [make(cuts[i], cuts[i + 1]) for i in range(len(cuts) - 1)]


def parquet_tasks(paths, columns=None) -> List[Callable[[], Block]]:
    files = _expand_paths(paths, ".parquet")

    def make(f):
        def task():
            import pyarrow.parquet as pq

            return pq.read_table(f, columns=columns)

        return task

    return [make(f) for f in files]


def csv_tasks(paths) -> List[Callable[[], Block]]:
    files = _expand_paths(paths, ".csv")

    def make(f):
        def task():
            import pyarrow.csv as pacsv

            return pacsv.read_csv(f)

        return task

    return [make(f) for f in files]


def json_tasks(paths) -> List[Callable[[], Block]]:
    files = _expand_paths(paths)

    def make(f):
        def task():
            import pyarrow.json as pajson

            return pajson.read_json(f)

        return task

    return [make(f) for f in files]


def numpy_tasks(paths) -> List[Callable[[], Block]]:
    files = _expand_paths(paths, ".npy")

    def make(f):
        def task():
            return batch_to_block({"data": np.load(f)})

        return task

    return [make(f) for f in files]


def binary_tasks(paths) -> List[Callable[[], Block]]:
    files = _expand_paths(paths)

    def make(f):
        def task():
            with open(f, "rb") as fh:
                payload = fh.read()
            return pa.table({"path": [f], "bytes": pa.array([payload],
                                                            pa.binary())})

        return task

    return [make(f) for f in files]


# ------------------------------------------------------------ write tasks


def write_block(block: Block, path: str, index: int, fmt: str) -> str:
    os.makedirs(path, exist_ok=True)
    f = os.path.join(path, f"{index:06d}.{fmt}")
    if fmt == "parquet":
        import pyarrow.parquet as pq

        pq.write_table(block, f)
    elif fmt == "csv":
        import pyarrow.csv as pacsv

        pacsv.write_csv(block, f)
    elif fmt == "json":
        block.to_pandas().to_json(f, orient="records", lines=True)
    elif fmt == "tfrecords":
        return write_tfrecords_block(block, path, index)
    else:
        raise ValueError(f"unknown write format {fmt}")
    return f


# ------------------------------------------------- tfrecord (pure python)
# Wire format (tensorflow/core/lib/io/record_writer.cc):
#   [u64 length][u32 masked_crc32c(length)][data][u32 masked_crc32c(data)]
# Payloads are tf.train.Example protos; a minimal protobuf wire parser below
# decodes bytes_list/float_list/int64_list features without the protobuf
# runtime (the environment does not pin tensorflow).

def _masked_crc(data: bytes) -> int:
    # native slice-by-8 CRC32C when the toolchain is present (MB-scale
    # payload checksums are the write path's hot loop), python otherwise
    from ray_tpu_torch._native.codec import masked_crc32c

    return masked_crc32c(data)


def _read_varint(buf: bytes, pos: int):
    # shared primitive (native codec's python fallback) — one copy
    from ray_tpu_torch._native.codec import _py_read_varint

    return _py_read_varint(buf, pos)


def _parse_proto_fields(buf: bytes):
    """Yield (field_number, wire_type, value) over a proto message."""
    pos = 0
    while pos < len(buf):
        tag, pos = _read_varint(buf, pos)
        field, wire = tag >> 3, tag & 7
        if wire == 0:          # varint
            val, pos = _read_varint(buf, pos)
        elif wire == 1:        # 64-bit
            val, pos = buf[pos:pos + 8], pos + 8
        elif wire == 2:        # length-delimited
            n, pos = _read_varint(buf, pos)
            val, pos = buf[pos:pos + n], pos + n
        elif wire == 5:        # 32-bit
            val, pos = buf[pos:pos + 4], pos + 4
        else:
            raise ValueError(f"unsupported proto wire type {wire}")
        yield field, wire, val


def _to_int64(x: int) -> int:
    return x - (1 << 64) if x >= 1 << 63 else x


def _parse_example(buf: bytes):
    """tf.train.Example -> {name: list}. Example{features=1} ->
    Features{feature=1 map<string,Feature>} -> Feature{bytes_list=1,
    float_list=2, int64_list=3}, each a packed/repeated list field 1."""
    import struct as _struct

    out = {}
    for f, _, features in _parse_proto_fields(buf):
        if f != 1:
            continue
        for ff, _, entry in _parse_proto_fields(features):
            if ff != 1:
                continue
            name, feature = None, b""
            for ef, _, v in _parse_proto_fields(entry):
                if ef == 1:
                    name = v.decode()
                elif ef == 2:
                    feature = v
            if name is None:
                continue
            values: List = []
            for tf_, _, lst in _parse_proto_fields(feature):
                for lf, lw, lv in _parse_proto_fields(lst):
                    if lf != 1:
                        continue
                    if tf_ == 1:                  # bytes_list
                        values.append(lv)
                    elif tf_ == 2:                # float_list
                        if lw == 2:               # packed
                            values.extend(_struct.unpack(
                                f"<{len(lv) // 4}f", lv))
                        else:
                            values.append(_struct.unpack("<f", lv)[0])
                    elif tf_ == 3:                # int64_list
                        if lw == 2:
                            from ray_tpu_torch._native.codec import varint_decode

                            values.extend(varint_decode(lv))
                        else:
                            values.append(_to_int64(lv))
            out[name] = values
    return out


def iter_tfrecords(path: str):
    """Yield raw record payloads from one TFRecord file (CRCs skipped on
    read, verified lengths only)."""
    import struct as _struct

    with open(path, "rb") as f:
        while True:
            header = f.read(12)
            if len(header) < 12:
                return
            (length,), _crc = _struct.unpack("<Q", header[:8]), header[8:]
            data = f.read(length)
            f.read(4)  # data crc
            if len(data) < length:
                return
            yield data


def tfrecord_tasks(paths) -> List[Callable[[], Block]]:
    files = _expand_paths(paths)

    def make(f):
        def task():
            rows = []
            for payload in iter_tfrecords(f):
                ex = _parse_example(payload)
                row = {}
                for k, vals in ex.items():
                    row[k] = vals[0] if len(vals) == 1 else vals
                rows.append(row)
            if not rows:
                return pa.table({})
            keys = sorted({k for r in rows for k in r})
            return batch_to_block({k: [r.get(k) for r in rows]
                                   for k in keys})

        return task

    return [make(f) for f in files]


def _encode_varint(x: int) -> bytes:
    from ray_tpu_torch._native.codec import _py_encode_varint

    return _py_encode_varint(x)


def _encode_field(field: int, wire: int, payload: bytes) -> bytes:
    return _encode_varint((field << 3) | wire) + payload


def _encode_example(row: Dict[str, Any]) -> bytes:
    """Encode one row-dict as a tf.train.Example proto."""
    import struct as _struct

    entries = b""
    for name, value in row.items():
        if value is None:
            continue  # sparse row: missing feature, matches reader semantics
        vals = value if isinstance(value, (list, tuple, np.ndarray)) else [
            value]
        if len(vals) and isinstance(vals[0], (bytes, str)):
            items = b"".join(
                _encode_field(1, 2, _encode_varint(len(v)) + v)
                for v in ((x.encode() if isinstance(x, str) else x)
                          for x in vals))
            feature = _encode_field(1, 2, _encode_varint(len(items)) + items)
        elif len(vals) and isinstance(vals[0], (float, np.floating)):
            packed = _struct.pack(f"<{len(vals)}f", *[float(v)
                                                      for v in vals])
            lst = _encode_field(1, 2, _encode_varint(len(packed)) + packed)
            feature = _encode_field(2, 2, _encode_varint(len(lst)) + lst)
        else:
            from ray_tpu_torch._native.codec import varint_encode

            packed = varint_encode([int(v) for v in vals])
            lst = _encode_field(1, 2, _encode_varint(len(packed)) + packed)
            feature = _encode_field(3, 2, _encode_varint(len(lst)) + lst)
        entry = (_encode_field(1, 2, _encode_varint(len(name.encode()))
                               + name.encode())
                 + _encode_field(2, 2, _encode_varint(len(feature))
                                 + feature))
        entries += _encode_field(1, 2, _encode_varint(len(entry)) + entry)
    return _encode_field(1, 2, _encode_varint(len(entries)) + entries)


def write_tfrecords_block(block: Block, path: str, index: int) -> str:
    import struct as _struct

    os.makedirs(path, exist_ok=True)
    f = os.path.join(path, f"{index:06d}.tfrecords")
    rows = block.to_pylist()
    with open(f, "wb") as fh:
        for row in rows:
            payload = _encode_example(row)
            header = _struct.pack("<Q", len(payload))
            fh.write(header)
            fh.write(_struct.pack("<I", _masked_crc(header)))
            fh.write(payload)
            fh.write(_struct.pack("<I", _masked_crc(payload)))
    return f


# ------------------------------------------------------------------ images


def image_tasks(paths, size=None, mode: Optional[str] = None
                ) -> List[Callable[[], Block]]:
    """One block per file; columns: image ([H,W,C] nested list), path.
    `size=(h, w)` resizes (required when mixing image sizes into one
    batch); `mode` forces a PIL conversion (e.g. "RGB", "L")."""
    exts = (".png", ".jpg", ".jpeg", ".bmp", ".gif", ".webp")
    files = [f for f in _expand_paths(paths)
             if f.lower().endswith(exts)]
    if not files:
        raise FileNotFoundError(f"no image files in {paths!r}")

    def make(f):
        def task():
            from PIL import Image

            img = Image.open(f)
            if mode:
                img = img.convert(mode)
            if size is not None:
                img = img.resize((size[1], size[0]))
            arr = np.asarray(img)
            return batch_to_block({"image": arr[None], "path": [f]})

        return task

    return [make(f) for f in files]


# ------------------------------------------------------------- webdataset


def webdataset_tasks(paths) -> List[Callable[[], Block]]:
    """WebDataset-style tar shards: members grouped by basename stem form
    one sample; columns are the extensions ("jpg" decoded to arrays, "txt"/
    "cls" to str/int, "json" parsed, anything else raw bytes)."""
    files = _expand_paths(paths, ".tar")

    def _decode(ext: str, payload: bytes):
        if ext in ("jpg", "jpeg", "png", "bmp", "webp"):
            import io as _io

            from PIL import Image

            return np.asarray(Image.open(_io.BytesIO(payload)))
        if ext in ("txt", "text"):
            return payload.decode()
        if ext == "cls":
            return int(payload.decode().strip())
        if ext == "json":
            import json as _json

            return _json.loads(payload.decode())
        return payload

    def make(f):
        def task():
            import tarfile

            samples: Dict[str, Dict[str, Any]] = {}
            order: List[str] = []
            with tarfile.open(f) as tar:
                for m in tar.getmembers():
                    if not m.isfile():
                        continue
                    base = os.path.basename(m.name)
                    stem, _, ext = base.partition(".")
                    if stem not in samples:
                        samples[stem] = {"__key__": stem}
                        order.append(stem)
                    payload = tar.extractfile(m).read()
                    samples[stem][ext.lower()] = _decode(
                        ext.lower(), payload)
            rows = [samples[k] for k in order]
            keys = sorted({k for r in rows for k in r})
            return batch_to_block({k: [r.get(k) for r in rows]
                                   for k in keys})

        return task

    return [make(f) for f in files]


# ------------------------------------------------------------------- sql


def _cursor_block(conn, sql: str) -> Block:
    try:
        cur = conn.cursor()
        # no params argument: passing one (even empty) makes
        # format/pyformat drivers (psycopg2, MySQLdb) interpret every
        # '%' in the SQL as a placeholder
        cur.execute(sql)
        names = [d[0] for d in cur.description]
        rows = cur.fetchall()
    finally:
        conn.close()
    if not rows:
        return pa.table({n: [] for n in names})
    cols = {n: [r[i] for r in rows] for i, n in enumerate(names)}
    return batch_to_block(cols)


def sql_tasks(sql: str, connection_factory: Callable[[], Any],
              partition_column: Optional[str] = None,
              lower_bound=None, upper_bound=None,
              parallelism: int = 1) -> List[Callable[[], Block]]:
    """DBAPI-2 source (reference `read_sql`). One task runs the whole
    query; with `partition_column` + NUMERIC bounds the read fans out
    into `parallelism` range-partitioned queries (Spark-JDBC recipe:
    bounds set the STRIDES only — the first partition is unbounded
    below and also takes NULLs, the last unbounded above, so no row is
    ever filtered out by the bounds). Literal numeric bounds are
    inlined because DBAPI paramstyles differ per driver.
    `connection_factory` must be picklable
    (e.g. `lambda: sqlite3.connect(path)`)."""
    if partition_column is None or parallelism <= 1:
        return [lambda: _cursor_block(connection_factory(), sql)]
    if lower_bound is None or upper_bound is None:
        raise ValueError(
            "partitioned read_sql needs lower_bound and upper_bound for "
            "the partition column")
    lo_b, hi_b = float(lower_bound), float(upper_bound)  # numeric only
    span = (hi_b - lo_b) / parallelism
    col = partition_column
    tasks: List[Callable[[], Block]] = []
    for i in range(parallelism):
        if i == 0 and i == parallelism - 1:
            where = "1=1"
        elif i == 0:
            where = f"({col} < {lo_b + span} OR {col} IS NULL)"
        elif i == parallelism - 1:
            where = f"{col} >= {lo_b + i * span}"
        else:
            where = (f"{col} >= {lo_b + i * span} AND "
                     f"{col} < {lo_b + (i + 1) * span}")

        def make(where=where):
            part_sql = f"SELECT * FROM ({sql}) __rt_sub WHERE {where}"
            return lambda: _cursor_block(connection_factory(), part_sql)

        tasks.append(make())
    return tasks


def orc_tasks(paths) -> List[Callable[[], Block]]:
    """ORC files via pyarrow.orc (reference `read_orc`): one task per
    file."""
    files = _expand_paths(paths, ".orc")

    def make(f):
        def task():
            from pyarrow import orc

            return orc.read_table(f)

        return task

    return [make(f) for f in files]


def mongo_tasks(uri: str, database: str, collection: str,
                pipeline: Optional[list] = None, parallelism: int = 4,
                client_factory: Optional[Callable[[], Any]] = None
                ) -> List[Callable[[], Block]]:
    """MongoDB source (ref
    `python/ray/data/datasource/mongo_datasource.py`): the collection is
    range-partitioned on `_id` into `parallelism` cursor reads, each an
    independent task. `client_factory` is the injection seam (production
    default: pymongo.MongoClient, gated on the library)."""
    if client_factory is None:
        def client_factory():  # noqa: F811 — production default
            try:
                import pymongo
            except ImportError as e:
                raise ImportError(
                    "read_mongo requires pymongo (not installed in this "
                    "image); pass client_factory= for a custom client"
                ) from e
            return pymongo.MongoClient(uri)

    # compute the stride ONCE at dataset construction and bake it into
    # every task: tasks executing at different times would otherwise
    # derive different strides from a drifting estimate and silently
    # drop/duplicate the rows between the two page grids. The estimate
    # only sets page BOUNDARIES — the last partition is unbounded, so a
    # stale count skews balance, never correctness.
    n = client_factory()[database][collection].estimated_document_count()
    per = max(1, -(-n // parallelism))  # ceil

    # skip/limit paging is only deterministic over a total order. Sorting
    # the collection scan on `_id` BEFORE the user pipeline gives every
    # task the same order through order-preserving stages ($match,
    # $project, $unwind, ...). Stages below DESTROY that order ($group
    # emits groups in unspecified per-run order; a user $sort rarely
    # totals), so the page grid must be re-sorted AFTER the pipeline —
    # which needs `_id` in the output ($group always emits one; raise if
    # a later stage provably drops it rather than silently drop/duplicate
    # the rows between adjacent partitions' pages).
    _ORDER_DESTROYING = {"$group", "$sort", "$sample", "$bucket",
                         "$bucketAuto", "$sortByCount", "$facet",
                         "$unionWith"}

    def _stage_name(stage) -> str:
        return next(iter(stage)) if isinstance(stage, dict) and stage else ""

    def _drops_id(stage) -> bool:
        name = _stage_name(stage)
        if not name:
            return False
        body = stage[name]
        if name == "$project" and isinstance(body, dict):
            return body.get("_id") in (0, False)
        if name == "$unset":
            fields = body if isinstance(body, list) else [body]
            return "_id" in fields
        return name in ("$replaceRoot", "$replaceWith")

    user_stages = list(pipeline or [])
    needs_resort = any(
        _stage_name(s) in _ORDER_DESTROYING for s in user_stages)
    if needs_resort and any(_drops_id(s) for s in user_stages):
        raise ValueError(
            "read_mongo: the pipeline reorders documents (e.g. $group/"
            "$sort) and then drops `_id`, so parallel skip/limit paging "
            "has no deterministic order to page over; keep `_id` in the "
            "output or read with parallelism=1")

    def part_task(index: int):
        def task():
            client = client_factory()
            coll = client[database][collection]
            start = index * per
            stages = ([{"$sort": {"_id": 1}}]
                      + user_stages
                      + ([{"$sort": {"_id": 1}}] if needs_resort else [])
                      + [{"$skip": start}])
            if index < parallelism - 1:
                stages.append({"$limit": per})
            rows = list(coll.aggregate(stages))
            for r in rows:
                r.pop("_id", None)  # ObjectIds aren't arrow-serializable
            if not rows:
                return pa.table({})
            keys = sorted({k for r in rows for k in r})  # union schema
            cols = {k: [r.get(k) for r in rows] for k in keys}
            return batch_to_block(cols)

        return task

    return [part_task(i) for i in range(parallelism)]


def bigquery_tasks(project_id: str, dataset: Optional[str] = None,
                   query: Optional[str] = None, parallelism: int = 4,
                   client_factory: Optional[Callable[[], Any]] = None
                   ) -> List[Callable[[], Block]]:
    """Cloud-warehouse source (ref
    `python/ray/data/datasource/bigquery_datasource.py`): `query` runs a
    BigQuery job whose destination table is then read page-parallel;
    bare `dataset` ("ds.table") reads the table directly. One read task
    per row-range stream, mirroring the reference's BigQuery Storage
    read sessions.

    `client_factory` is the injection seam (tests drive the exact call
    surface with a fake; production defaults to
    `google.cloud.bigquery.Client`, gated on the library)."""
    if (dataset is None) == (query is None):
        raise ValueError("read_bigquery needs exactly one of "
                         "dataset='ds.table' or query=...")

    if client_factory is None:
        def client_factory():  # noqa: F811 — production default
            try:
                from google.cloud import bigquery
            except ImportError as e:
                raise ImportError(
                    "read_bigquery requires google-cloud-bigquery (not "
                    "installed in this image); pass client_factory= to "
                    "use a custom client") from e
            return bigquery.Client(project=project_id)

    # the query job runs ONCE at dataset construction (one job, one
    # quota hit) and every stream task reads the SAME destination
    # table — per-task execution would run N jobs and, for
    # non-deterministic queries, page over N different result sets
    # (duplicated + missing rows). num_rows is resolved here too so
    # every task pages over one fixed grid.
    setup = client_factory()
    if query is not None:
        job = setup.query(query)
        job.result()  # wait; the anonymous destination holds the rows
        table = job.destination
    else:
        table = dataset
    n_rows = setup.get_table(table).num_rows
    per = max(1, -(-n_rows // parallelism))  # ceil

    def stream_task(index: int):
        def task():
            client = client_factory()
            start = index * per
            if start >= n_rows and index > 0:
                return pa.table({})
            rows = client.list_rows(table, start_index=start,
                                    max_results=per)
            arrow = rows.to_arrow()
            return arrow if arrow.num_rows or index == 0 else pa.table({})

        return task

    return [stream_task(i) for i in range(parallelism)]
