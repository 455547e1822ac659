"""The port's datasources: TFRecord round-trip (pure-python wire format),
images (PIL), webdataset tar shards, and DBAPI SQL — the twins of
``tests/test_datasources.py`` (the reference's
`python/ray/data/tests/test_{tfrecords,image,webdataset,sql}.py` shape) —
plus TFRecord files written by the port byte for byte equal to the JAX
package's for the same rows (a format the code fixes; parquet and the
others depend on the pyarrow version, so they are compared by rows)."""

import os
import sqlite3
import sys
import tarfile

import cloudpickle
import numpy as np
import pytest

import ray_tpu_torch as rt
from tests.test_torch_runtime_cluster import (
    retire_leftover_jax_runtime, retire_leftover_jax_runtime_for_later_files)

os.environ.setdefault("RAY_TPU_TORCH_LOG_LEVEL", "WARNING")
# the UDFs ship by value: a worker never imports this module (and with
# it JAX)
cloudpickle.register_pickle_by_value(sys.modules[__name__])


def _tfrecord_rows():
    """Rows of every feature kind the writer encodes: int64 (negative
    and large too), float, bytes, and int and float vectors."""
    rng = np.random.default_rng(3)
    return [{"idx": i, "big": int(rng.integers(-2 ** 62, 2 ** 62)),
             "score": float(i) / 3.0, "name": f"row{i}".encode(),
             "tokens": rng.integers(0, 50257, 16).astype(np.int32),
             "emb": rng.standard_normal(4).astype(np.float32)}
            for i in range(25)]


def _tfrecord_dataset(data_mod):
    from_items = data_mod.from_items
    return from_items(_tfrecord_rows(), parallelism=2)


@pytest.fixture(scope="module", autouse=True)
def _no_leftover_jax_runtime():
    yield
    retire_leftover_jax_runtime_for_later_files()


@pytest.fixture(scope="module")
def jax_tfrecords(tmp_path_factory):
    """The rows written by the JAX package's ``write_tfrecords``: the
    files' bytes, on a JAX cluster shut down before the port's starts."""
    import ray_tpu
    from ray_tpu import data as jdata

    retire_leftover_jax_runtime()
    out = tmp_path_factory.mktemp("jax_tfr")
    ray_tpu.init(num_cpus=4, object_store_memory=64 * 1024 * 1024)
    try:
        files = _tfrecord_dataset(jdata).write_tfrecords(str(out))
    finally:
        ray_tpu.shutdown()
    return [open(f, "rb").read() for f in sorted(files)]


@pytest.fixture(scope="module")
def ray_init(jax_tfrecords):
    """A started single-node port cluster (module-scoped for speed),
    after the JAX references are taken."""
    retire_leftover_jax_runtime()
    info = rt.init(num_cpus=32, num_gpus=0,
                   object_store_memory=256 * 1024 * 1024)
    yield info
    rt.shutdown()


class TestTFRecords:
    def test_roundtrip(self, ray_init, tmp_path):
        from ray_tpu_torch import data

        ds = data.from_items([
            {"idx": i, "score": float(i) / 3.0, "name": f"row{i}".encode()}
            for i in range(20)])
        out = str(tmp_path / "tfr")
        files = ds.write_tfrecords(out)
        assert files and all(f.endswith(".tfrecords") for f in files)

        back = data.read_tfrecords(out)
        rows = sorted(back.take_all(), key=lambda r: r["idx"])
        assert len(rows) == 20
        assert rows[3]["idx"] == 3
        assert abs(rows[3]["score"] - 1.0) < 1e-6
        assert rows[3]["name"] == b"row3"

    def test_wire_format_crc_present(self, ray_init, tmp_path):
        """Each record is framed [len u64][crc u32][data][crc u32]."""
        import struct

        from ray_tpu_torch import data
        from ray_tpu_torch.data.datasource import _masked_crc

        ds = data.from_items([{"a": 1}])
        f = ds.write_tfrecords(str(tmp_path / "one"))[0]
        raw = open(f, "rb").read()
        (length,) = struct.unpack("<Q", raw[:8])
        (len_crc,) = struct.unpack("<I", raw[8:12])
        assert len_crc == _masked_crc(raw[:8])
        payload = raw[12:12 + length]
        (data_crc,) = struct.unpack("<I", raw[12 + length:16 + length])
        assert data_crc == _masked_crc(payload)

    def test_vector_features(self, ray_init, tmp_path):
        from ray_tpu_torch import data

        ds = data.from_items([{"vec": [1.5, 2.5, 3.5], "ids": [7, 8]}])
        out = str(tmp_path / "vec")
        ds.write_tfrecords(out)
        row = data.read_tfrecords(out).take_all()[0]
        np.testing.assert_allclose(row["vec"], [1.5, 2.5, 3.5], atol=1e-6)
        assert list(row["ids"]) == [7, 8]


class TestImages:
    def _make_images(self, tmp_path, n=3, size=(16, 12)):
        from PIL import Image

        paths = []
        for i in range(n):
            arr = np.full((size[0], size[1], 3), i * 20, np.uint8)
            p = str(tmp_path / f"img_{i}.png")
            Image.fromarray(arr).save(p)
            paths.append(p)
        return paths

    def test_read_images(self, ray_init, tmp_path):
        from ray_tpu_torch import data

        self._make_images(tmp_path)
        ds = data.read_images(str(tmp_path))
        rows = ds.take_all()
        assert len(rows) == 3
        img = np.asarray(rows[0]["image"])
        assert img.shape == (16, 12, 3)

    def test_resize_and_mode(self, ray_init, tmp_path):
        from ray_tpu_torch import data

        self._make_images(tmp_path)
        ds = data.read_images(str(tmp_path), size=(8, 8), mode="L")
        img = np.asarray(ds.take_all()[0]["image"])
        assert img.shape == (8, 8)


class TestWebDataset:
    def test_tar_samples(self, ray_init, tmp_path):
        import io
        import json

        from PIL import Image

        from ray_tpu_torch import data

        tar_path = str(tmp_path / "shard-000.tar")
        with tarfile.open(tar_path, "w") as tar:
            for i in range(4):
                img = Image.fromarray(
                    np.full((8, 8, 3), i, np.uint8))
                buf = io.BytesIO()
                img.save(buf, format="PNG")

                def add(name, payload):
                    info = tarfile.TarInfo(name)
                    info.size = len(payload)
                    tar.addfile(info, io.BytesIO(payload))

                add(f"sample{i}.png", buf.getvalue())
                add(f"sample{i}.cls", str(i % 2).encode())
                add(f"sample{i}.json",
                    json.dumps({"meta": i}).encode())

        ds = data.read_webdataset(tar_path)
        rows = sorted(ds.take_all(), key=lambda r: r["__key__"])
        assert len(rows) == 4
        assert rows[1]["__key__"] == "sample1"
        assert rows[1]["cls"] == 1
        assert rows[1]["json"]["meta"] == 1
        assert np.asarray(rows[1]["png"]).shape == (8, 8, 3)


class TestSQL:
    def test_read_sql_sqlite(self, ray_init, tmp_path):
        from ray_tpu_torch import data

        db = str(tmp_path / "t.db")
        conn = sqlite3.connect(db)
        conn.execute("CREATE TABLE users (id INTEGER, name TEXT, score REAL)")
        conn.executemany("INSERT INTO users VALUES (?, ?, ?)",
                         [(i, f"u{i}", i * 1.5) for i in range(10)])
        conn.commit()
        conn.close()

        ds = data.read_sql("SELECT * FROM users WHERE id >= 4",
                           lambda: sqlite3.connect(db))
        rows = sorted(ds.take_all(), key=lambda r: r["id"])
        assert len(rows) == 6
        assert rows[0] == {"id": 4, "name": "u4", "score": 6.0}

    def test_aggregate_query(self, ray_init, tmp_path):
        from ray_tpu_torch import data

        db = str(tmp_path / "agg.db")
        conn = sqlite3.connect(db)
        conn.execute("CREATE TABLE pts (grp TEXT, v REAL)")
        conn.executemany("INSERT INTO pts VALUES (?, ?)",
                         [("a", 1.0), ("a", 3.0), ("b", 10.0)])
        conn.commit()
        conn.close()
        ds = data.read_sql(
            "SELECT grp, AVG(v) AS mean_v FROM pts GROUP BY grp",
            lambda: sqlite3.connect(db))
        rows = {r["grp"]: r["mean_v"] for r in ds.take_all()}
        assert rows == {"a": 2.0, "b": 10.0}


def test_negative_int_roundtrip(ray_init, tmp_path):
    """Negative int64 features must round-trip (proto two's-complement
    varints), not hang the writer or decode as huge positives."""
    from ray_tpu_torch import data

    ds = data.from_items([{"a": -1, "b": -123456789}])
    out = str(tmp_path / "neg")
    ds.write_tfrecords(out)
    row = data.read_tfrecords(out).take_all()[0]
    assert row["a"] == -1
    assert row["b"] == -123456789


class _FakeMongo:
    """Minimal pymongo stand-in: canned docs, records every aggregate()
    stage list, honors $skip/$limit so tasks produce real blocks."""

    def __init__(self, docs, calls):
        self._docs = docs
        self.calls = calls

    def __getitem__(self, _name):
        return self

    def estimated_document_count(self):
        return len(self._docs)

    def aggregate(self, stages):
        self.calls.append(stages)
        rows = [dict(d) for d in self._docs]
        for st in stages:
            if "$skip" in st:
                rows = rows[st["$skip"]:]
            elif "$limit" in st:
                rows = rows[:st["$limit"]]
        return rows


class TestMongoPaging:
    def _tasks_and_calls(self, pipeline, parallelism=2):
        from ray_tpu_torch.data.datasource import mongo_tasks

        calls = []
        docs = [{"_id": i, "v": i} for i in range(6)]
        tasks = mongo_tasks("mongodb://x", "db", "c", pipeline=pipeline,
                            parallelism=parallelism,
                            client_factory=lambda: _FakeMongo(docs, calls))
        return tasks, calls

    def test_order_preserving_pipeline_presorts_only(self):
        """$match keeps the scan order: the page grid is the single
        pre-pipeline $sort on _id — no redundant post-sort."""
        tasks, calls = self._tasks_and_calls([{"$match": {"v": {"$gte": 0}}}])
        blocks = [t() for t in tasks]
        assert sum(b.num_rows for b in blocks) == 6
        for stages in calls:
            assert stages[0] == {"$sort": {"_id": 1}}
            assert stages[1] == {"$match": {"v": {"$gte": 0}}}
            # exactly one $sort: the user pipeline preserves it
            assert sum(1 for s in stages if "$sort" in s) == 1

    def test_group_pipeline_resorted_after(self):
        """$group emits groups in unspecified per-run order, so the page
        grid must be re-established by a post-pipeline $sort on the _id
        every $group emits."""
        group = {"$group": {"_id": "$v", "n": {"$sum": 1}}}
        tasks, calls = self._tasks_and_calls([group])
        [t() for t in tasks]
        for stages in calls:
            gi = stages.index(group)
            assert stages[gi + 1] == {"$sort": {"_id": 1}}, (
                "skip/limit paged over $group's unspecified order")

    def test_group_then_dropping_id_raises(self):
        """Reordering pipeline + no _id in the output = nothing
        deterministic to page over; refuse instead of silently
        dropping/duplicating rows between partitions."""
        with pytest.raises(ValueError, match="_id"):
            self._tasks_and_calls([
                {"$group": {"_id": "$v", "n": {"$sum": 1}}},
                {"$project": {"_id": 0, "n": 1}}])


class TestAgainstJax:
    def test_tfrecord_files_match_jax_byte_for_byte(self, ray_init,
                                                    jax_tfrecords, tmp_path):
        from ray_tpu_torch import data

        files = _tfrecord_dataset(data).write_tfrecords(str(tmp_path))
        got = [open(f, "rb").read() for f in sorted(files)]
        assert len(got) == len(jax_tfrecords) == 2
        assert got == jax_tfrecords

    def test_tfrecord_block_writer_matches_jax(self, tmp_path):
        """The block writer alone, on one arrow table, without a cluster."""
        from ray_tpu.data import datasource as jsource
        from ray_tpu.data.block import batch_to_block as jblock

        from ray_tpu_torch.data import datasource
        from ray_tpu_torch.data.block import batch_to_block

        rows = _tfrecord_rows()
        cols = {k: np.array([r[k] for r in rows]) for k in rows[0]}
        a = datasource.write_tfrecords_block(batch_to_block(cols),
                                             str(tmp_path / "port"), 0)
        b = jsource.write_tfrecords_block(jblock(cols),
                                          str(tmp_path / "jax"), 0)
        assert open(a, "rb").read() == open(b, "rb").read()

    def test_parquet_rows_match_jax(self, tmp_path):
        """Parquet through both packages' block writers, compared by rows
        read back (the bytes carry the pyarrow version)."""
        import pyarrow.parquet as pq

        from ray_tpu.data import datasource as jsource
        from ray_tpu.data.block import batch_to_block as jblock

        from ray_tpu_torch.data import datasource
        from ray_tpu_torch.data.block import batch_to_block

        cols = {"i": np.arange(10), "f": np.linspace(0, 1, 10),
                "s": np.array([f"s{i}" for i in range(10)])}
        a = datasource.write_block(batch_to_block(cols),
                                   str(tmp_path / "port"), 0, "parquet")
        b = jsource.write_block(jblock(cols), str(tmp_path / "jax"), 0,
                                "parquet")
        assert pq.read_table(a).to_pylist() == pq.read_table(b).to_pylist()
