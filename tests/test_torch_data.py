"""``ray_tpu_torch.data``: sources, transforms, fusion pipeline, shuffles,
groupby, iterators, split/streaming_split, writes — the twins of
``tests/test_data.py`` (mirroring the reference's `python/ray/data/tests/`
coverage shape), plus the same seeded pipelines run through the JAX
package first (on a JAX cluster that is shut down before the port's
starts), giving the same rows in the same order; the device iterator;
tensor columns that keep their dtype; and ``TorchTrainer``'s dataset
shards."""

import json
import os
import sys

import cloudpickle
import numpy as np
import pytest

import ray_tpu_torch as rt
from ray_tpu_torch import data as rd
from tests.test_torch_runtime_cluster import (
    retire_leftover_jax_runtime, retire_leftover_jax_runtime_for_later_files)

builtins_range = range

os.environ.setdefault("RAY_TPU_TORCH_LOG_LEVEL", "WARNING")
# the UDFs ship by value: a worker never imports this module (and with
# it JAX)
cloudpickle.register_pickle_by_value(sys.modules[__name__])


def _sq(b):
    return {"sq": b["id"] ** 2}


def _features(b):
    ids = b["id"]
    return {"id": ids, "x": ids.astype(np.float32) * 0.5,
            "v": np.stack([ids, ids + 1, ids + 2], axis=1)}


_ITEMS = [{"k": (i * 7) % 5, "v": float(i % 13) / 4, "n": i}
          for i in range(60)]


def _seeded_pipelines(rdm) -> dict:
    """The same seeded pipelines through a data module (the port's or
    JAX's): rows and values as plain Python and numpy."""
    def base():
        return rdm.from_items(_ITEMS, parallelism=4)

    return {
        "random_shuffle": rdm.range(200, parallelism=5)
        .random_shuffle(seed=3).take_all(),
        "map_then_shuffle": rdm.range(64, parallelism=4).map_batches(_sq)
        .random_shuffle(seed=9).take_all(),
        "shuffled_batches": [b["id"].tolist() for b in rdm.range(
            30, parallelism=3).random_shuffle(seed=5).iter_batches(
            batch_size=7, prefetch_batches=0)],
        "sort": base().sort("k").take_all(),
        "sort_descending": base().sort("v", descending=True).take_all(),
        "groupby": [base().groupby("k").count().take_all(),
                    base().groupby("k").sum("v").take_all(),
                    base().groupby("k").mean("v").take_all(),
                    base().groupby("k").min("n").take_all(),
                    base().groupby("k").max("n").take_all(),
                    base().groupby("k").std("v").take_all()],
        "repartition": [b["id"].tolist() for b in rdm.range(
            50, parallelism=3).repartition(4).iter_batches(
            batch_size=None, prefetch_batches=0)],
        "split": [p.take_all() for p in
                  rdm.range(100, parallelism=4).split(3)],
        "zip": rdm.range(20, parallelism=2).zip(
            rdm.range(20, parallelism=4).map_batches(_sq)).take_all(),
        "aggregates": [base().sum("v"), base().min("n"), base().max("n"),
                       base().mean("v"), base().count()],
    }


@pytest.fixture(scope="module", autouse=True)
def _no_leftover_jax_runtime():
    yield
    retire_leftover_jax_runtime_for_later_files()


@pytest.fixture(scope="module")
def jax_ref():
    """The seeded pipelines and ``iter_jax_batches`` through the JAX
    package, on a JAX cluster shut down before the port's starts."""
    import ray_tpu
    from ray_tpu import data as jrd

    retire_leftover_jax_runtime()
    ray_tpu.init(num_cpus=8, object_store_memory=128 * 1024 * 1024)
    try:
        out = _seeded_pipelines(jrd)
        out["iter_jax_batches"] = [
            {k: np.asarray(v) for k, v in b.items()}
            for b in jrd.range(32, parallelism=4).map_batches(_features)
            .iterator().iter_jax_batches(batch_size=8)]
    finally:
        ray_tpu.shutdown()
    return out


@pytest.fixture(scope="module")
def ray_init(jax_ref):
    """A started single-node port cluster (module-scoped for speed),
    after the JAX references are taken."""
    retire_leftover_jax_runtime()
    info = rt.init(num_cpus=32, num_gpus=0,
                   object_store_memory=256 * 1024 * 1024)
    yield info
    rt.shutdown()


class TestSources:
    def test_range(self, ray_init):
        ds = rd.range(100, parallelism=4)
        assert ds.count() == 100
        assert ds.take(3) == [{"id": 0}, {"id": 1}, {"id": 2}]

    def test_from_items(self, ray_init):
        ds = rd.from_items([{"a": i, "b": str(i)} for i in range(10)])
        assert ds.count() == 10
        assert ds.take(1) == [{"a": 0, "b": "0"}]

    def test_from_items_scalars(self, ray_init):
        ds = rd.from_items([1, 2, 3])
        assert ds.take_all() == [{"item": 1}, {"item": 2}, {"item": 3}]

    def test_from_pandas_numpy_arrow(self, ray_init):
        import pandas as pd
        import pyarrow as pa

        df = pd.DataFrame({"x": [1, 2, 3]})
        assert rd.from_pandas(df).count() == 3
        assert rd.from_numpy(np.ones((4, 2))).count() == 4
        assert rd.from_arrow(pa.table({"x": [1]})).count() == 1

    def test_range_tensor(self, ray_init):
        ds = rd.range_tensor(8, shape=(2, 2), parallelism=2)
        batch = ds.take_batch(8)
        assert batch["data"].shape == (8, 2, 2)

    def test_parquet_roundtrip(self, ray_init, tmp_path):
        ds = rd.range(50, parallelism=2)
        files = ds.write_parquet(str(tmp_path / "pq"))
        assert len(files) == 2
        back = rd.read_parquet(str(tmp_path / "pq"))
        assert back.count() == 50
        assert sorted(r["id"] for r in back.take_all()) == list(range(50))

    def test_csv_json_roundtrip(self, ray_init, tmp_path):
        ds = rd.from_items([{"a": i, "b": f"s{i}"} for i in range(10)])
        ds.write_csv(str(tmp_path / "csv"))
        assert rd.read_csv(str(tmp_path / "csv")).count() == 10
        ds.write_json(str(tmp_path / "js"))
        assert rd.read_json(str(tmp_path / "js")).count() == 10


class TestTransforms:
    def test_map_batches_numpy(self, ray_init):
        ds = rd.range(10).map_batches(lambda b: {"x": b["id"] * 2})
        assert sorted(r["x"] for r in ds.take_all()) == list(range(0, 20, 2))

    def test_map_batches_pandas(self, ray_init):
        def f(df):
            df["y"] = df["id"] + 1
            return df

        ds = rd.range(5).map_batches(f, batch_format="pandas")
        assert sorted(r["y"] for r in ds.take_all()) == [1, 2, 3, 4, 5]

    def test_map_row(self, ray_init):
        ds = rd.range(5).map(lambda r: {"v": r["id"] ** 2})
        assert sorted(r["v"] for r in ds.take_all()) == [0, 1, 4, 9, 16]

    def test_filter_flatmap(self, ray_init):
        ds = rd.range(10).filter(lambda r: r["id"] % 2 == 0)
        assert ds.count() == 5
        ds2 = rd.range(3).flat_map(lambda r: [{"v": r["id"]}, {"v": -r["id"]}])
        assert ds2.count() == 6

    def test_fusion_chain(self, ray_init):
        """map→filter→map fuses into one stage; results still correct."""
        ds = (rd.range(20, parallelism=2)
              .map(lambda r: {"id": r["id"] + 1})
              .filter(lambda r: r["id"] % 2 == 0)
              .map_batches(lambda b: {"id": b["id"] * 10}))
        assert sorted(r["id"] for r in ds.take_all()) == list(
            range(20, 201, 20))

    def test_add_select_drop_rename(self, ray_init):
        ds = rd.range(5).add_column("b", lambda df: df["id"] * 2)
        assert set(ds.columns()) == {"id", "b"}
        assert ds.select_columns(["b"]).columns() == ["b"]
        assert ds.drop_columns(["b"]).columns() == ["id"]
        assert ds.rename_columns({"id": "key"}).columns() == ["key", "b"]

    def test_limit_streaming(self, ray_init):
        ds = rd.range(1000, parallelism=10).limit(25)
        assert ds.count() == 25

    def test_union_then_map(self, ray_init):
        a, b = rd.range(5), rd.range(5)
        ds = a.union(b).map(lambda r: {"v": r["id"]})
        assert ds.count() == 10

    def test_zip(self, ray_init):
        a = rd.range(10, parallelism=2)
        b = rd.range(10, parallelism=3).map(lambda r: {"sq": r["id"] ** 2})
        out = a.zip(b).take_all()
        assert all(r["sq"] == r["id"] ** 2 for r in out)


class TestAllToAll:
    def test_repartition(self, ray_init):
        ds = rd.range(100, parallelism=7).repartition(3)
        assert ds.num_blocks() == 3
        assert ds.count() == 100

    def test_random_shuffle(self, ray_init):
        ds = rd.range(100, parallelism=4).random_shuffle(seed=7)
        vals = [r["id"] for r in ds.take_all()]
        assert sorted(vals) == list(range(100))
        assert vals != list(range(100))

    def test_shuffle_deterministic(self, ray_init):
        v1 = [r["id"] for r in
              rd.range(50, parallelism=3).random_shuffle(seed=3).take_all()]
        v2 = [r["id"] for r in
              rd.range(50, parallelism=3).random_shuffle(seed=3).take_all()]
        assert v1 == v2

    def test_sort(self, ray_init):
        ds = rd.range(100, parallelism=4).random_shuffle(seed=1).sort("id")
        assert [r["id"] for r in ds.take_all()] == list(range(100))

    def test_sort_descending(self, ray_init):
        ds = rd.range(20, parallelism=3).sort("id", descending=True)
        assert [r["id"] for r in ds.take_all()] == list(range(19, -1, -1))

    def test_groupby_count_sum_mean(self, ray_init):
        ds = rd.from_items([{"k": i % 3, "v": i} for i in range(12)],
                           parallelism=4)
        counts = {r["k"]: r["count()"]
                  for r in ds.groupby("k").count().take_all()}
        assert counts == {0: 4, 1: 4, 2: 4}
        sums = {r["k"]: r["sum(v)"]
                for r in ds.groupby("k").sum("v").take_all()}
        assert sums == {0: 0 + 3 + 6 + 9, 1: 1 + 4 + 7 + 10, 2: 2 + 5 + 8 + 11}

    def test_map_groups(self, ray_init):
        ds = rd.from_items([{"k": i % 2, "v": float(i)} for i in range(8)])
        out = ds.groupby("k").map_groups(
            lambda df: df.assign(v=df["v"] - df["v"].mean())).take_all()
        assert len(out) == 8
        assert abs(sum(r["v"] for r in out)) < 1e-9


class TestAggregates:
    def test_global_aggs(self, ray_init):
        ds = rd.range(10)
        assert ds.sum("id") == 45
        assert ds.min("id") == 0
        assert ds.max("id") == 9
        assert ds.mean("id") == pytest.approx(4.5)


class TestIterators:
    def test_iter_batches_sizes(self, ray_init):
        ds = rd.range(100, parallelism=7)
        sizes = [len(b["id"]) for b in ds.iter_batches(batch_size=32)]
        assert sum(sizes) == 100
        assert all(s == 32 for s in sizes[:-1])

    def test_iter_batches_drop_last(self, ray_init):
        ds = rd.range(100, parallelism=3)
        sizes = [len(b["id"]) for b in
                 ds.iter_batches(batch_size=32, drop_last=True)]
        assert sizes == [32, 32, 32]

    def test_batch_formats(self, ray_init):
        import pandas as pd
        import pyarrow as pa

        ds = rd.range(10)
        assert isinstance(ds.take_batch(5, batch_format="pandas"),
                          pd.DataFrame)
        assert isinstance(ds.take_batch(5, batch_format="pyarrow"), pa.Table)
        assert isinstance(ds.take_batch(5, batch_format="numpy")["id"],
                          np.ndarray)

    def test_local_shuffle(self, ray_init):
        ds = rd.range(100, parallelism=2)
        vals = []
        for b in ds.iter_batches(batch_size=50, local_shuffle_buffer_size=64,
                                 local_shuffle_seed=5):
            vals.extend(b["id"].tolist())
        assert sorted(vals) == list(range(100))
        assert vals != list(range(100))

    def test_iter_torch_batches(self, ray_init):
        import torch

        ds = rd.range(10)
        for b in ds.iter_torch_batches(batch_size=None):
            assert isinstance(b["id"], torch.Tensor)

    def test_iter_device_batches(self, ray_init):
        """The port's counterpart of ``iter_jax_batches``: tensors on the
        device asked for (the CPU here), ``prefetch`` batches ahead."""
        import torch

        ds = rd.range(16)
        total = 0
        for b in ds.iterator().iter_device_batches(batch_size=8,
                                                   device="cpu"):
            assert isinstance(b["id"], torch.Tensor)
            assert b["id"].device.type == "cpu"
            total += int(b["id"].sum())
        assert total == sum(range(16))


class TestSplits:
    def test_split(self, ray_init):
        parts = rd.range(100, parallelism=4).split(2)
        assert sum(p.count() for p in parts) == 100

    def test_split_pads_to_n(self, ray_init):
        parts = rd.range(100, parallelism=2).split(4)
        assert len(parts) == 4
        assert sum(p.count() for p in parts) == 100

    def test_streaming_split_multi_epoch(self, ray_init):
        shards = rd.range(20, parallelism=4).streaming_split(1)
        for _epoch in range(2):
            seen = []
            for b in shards[0].iter_batches(batch_size=None,
                                            prefetch_batches=0):
                seen.extend(b["id"].tolist())
            assert sorted(seen) == list(range(20))

    def test_streaming_split(self, ray_init):
        shards = rd.range(100, parallelism=10).streaming_split(2)
        seen = []
        for sh in shards:
            for b in sh.iter_batches(batch_size=None, prefetch_batches=0):
                seen.extend(b["id"].tolist())
        assert sorted(seen) == list(range(100))

    def test_streaming_split_equal(self, ray_init):
        shards = rd.range(100, parallelism=10).streaming_split(2, equal=True)
        counts, seen = [], []
        for sh in shards:
            blocks = list(sh.iter_batches(batch_size=None,
                                          prefetch_batches=0))
            counts.append(len(blocks))
            for b in blocks:
                seen.extend(b["id"].tolist())
        assert sorted(seen) == list(range(100))
        assert counts == [5, 5]  # equal block counts per consumer

    def test_streaming_split_in_train(self, ray_init, tmp_path):
        """Dataset shards flow into train workers via get_dataset_shard."""
        from ray_tpu_torch import train
        from ray_tpu_torch.train import (DataParallelTrainer, RunConfig,
                                   ScalingConfig)

        def loop():
            it = train.get_dataset_shard("train")
            total = 0
            for b in it.iter_batches(batch_size=None, prefetch_batches=0):
                total += int(b["id"].sum())
            train.report({"total": total})

        t = DataParallelTrainer(
            loop,
            scaling_config=ScalingConfig(num_workers=2),
            run_config=RunConfig(storage_path=str(tmp_path)),
            datasets={"train": rd.range(40, parallelism=4)},
        )
        res = t.fit()
        assert res.error is None


class TestMaterialize:
    def test_materialize_reuse(self, ray_init):
        ds = rd.range(20).map(lambda r: {"v": r["id"]}).materialize()
        assert ds.count() == 20
        assert ds.count() == 20  # second pass reuses blocks
        assert ds.size_bytes() > 0

    def test_schema_stats(self, ray_init):
        ds = rd.range(5)
        assert ds.schema().names == ["id"]
        assert "blocks" in ds.stats()


class TestActorPoolCompute:
    """Stateful class UDFs on an actor pool
    (≈ actor_pool_map_operator.py) + strict map_batches kwargs."""

    def test_class_udf_runs_on_actor_pool(self, ray_init):
        from ray_tpu_torch.data import ActorPoolStrategy

        class AddModelBias:
            def __init__(self, bias):
                import os

                self.bias = bias
                self.pid = os.getpid()

            def __call__(self, batch):
                batch["id"] = batch["id"] + self.bias
                batch["worker_pid"] = np.full_like(batch["id"], self.pid)
                return batch

        ds = rt.data.range(64, parallelism=8).map_batches(
            AddModelBias,
            fn_constructor_args=(1000,),
            compute=ActorPoolStrategy(size=2),
            num_cpus=0.5,
        )
        rows = ds.take_all()
        assert sorted(r["id"] for r in rows) == list(
            builtins_range(1000, 1064))
        # the work actually spread over a pool of persistent workers
        pids = {r["worker_pid"] for r in rows}
        assert 1 <= len(pids) <= 2

    def test_class_udf_concurrency_sets_pool_size(self, ray_init):
        class Echo:
            def __call__(self, batch):
                return batch

        ds = rt.data.range(16, parallelism=4).map_batches(
            Echo, concurrency=2)
        assert ds.count() == 16

    def test_function_udf_with_concurrency(self, ray_init):
        ds = rt.data.range(32, parallelism=8).map_batches(
            lambda b: {"id": b["id"] * 2}, concurrency=2)
        assert sorted(r["id"] for r in ds.take_all()) == [
            i * 2 for i in builtins_range(32)]

    def test_unknown_kwargs_rejected(self, ray_init):
        with pytest.raises(TypeError):
            rt.data.range(4).map_batches(
                lambda b: b, nonsense_option=True)

    def test_constructor_args_require_class(self, ray_init):
        with pytest.raises(TypeError, match="class UDF"):
            rt.data.range(4).map_batches(
                lambda b: b, fn_constructor_args=(1,))

    def test_actor_strategy_requires_class(self, ray_init):
        from ray_tpu_torch.data import ActorPoolStrategy

        with pytest.raises(TypeError, match="class UDF"):
            rt.data.range(4).map_batches(
                lambda b: b, compute=ActorPoolStrategy(size=2))


class TestPrefetchOverlap:
    """iter_batches(prefetch_batches=N) genuinely overlaps: block
    fetches are bound ahead with a batched-get window (the
    batched-locate path) instead of a synchronous per-block pull, and
    the stream-split iterator pipelines its coordinator round-trip."""

    def test_windowed_prefetch_batches_the_gets(self, ray_init):
        from ray_tpu_torch._private import rpc

        # blocks above the inline threshold, so every ref resolves
        # through the store: the serial pull pays a locate round-trip
        # per block, the windowed path one batched locate per window
        arrays = [np.full(32_768, i, np.float64) for i in range(8)]
        d = rd.from_numpy(arrays)
        list(d.iter_batches(batch_size=None, prefetch_batches=0))  # warm

        t0 = rpc._m_client_calls.total()
        serial = list(d.iter_batches(batch_size=None, prefetch_batches=0))
        d_serial = rpc._m_client_calls.total() - t0
        t0 = rpc._m_client_calls.total()
        windowed = list(d.iter_batches(batch_size=None,
                                       prefetch_batches=4))
        d_windowed = rpc._m_client_calls.total() - t0
        assert len(serial) == len(windowed) == 8
        for s, w in zip(serial, windowed):
            assert np.array_equal(s["data"], w["data"])
        assert d_windowed < d_serial, (d_windowed, d_serial)

    def test_slow_consumer_finds_next_batch_ready(self, ray_init):
        """The regression the fix exists for: a consumer slower than
        the (overlapped) producers must never stall at a block
        boundary — the next batch is already queued."""
        import time

        def slow(b):
            time.sleep(0.05)
            return b

        d = rd.range(160, parallelism=8).map_batches(slow, concurrency=8)
        it = iter(d.iter_batches(batch_size=None, prefetch_batches=4))
        next(it)  # pipeline spin-up absorbed here
        waits = []
        while True:
            t0 = time.perf_counter()
            try:
                next(it)
            except StopIteration:
                break
            waits.append(time.perf_counter() - t0)
            time.sleep(0.1)  # consumer "compute", slower than producers
        # unoverlapped production of the remaining 7 blocks would stall
        # the consumer ~7 x 0.05s; overlap hides (nearly) all of it. A
        # fraction-of-serial bound, not a per-batch wall-clock cliff —
        # tier-1 runs on a single loaded CPU (scheduling jitter)
        assert waits and sum(waits) < 0.5 * len(waits) * 0.05, waits

    def test_streaming_split_pipelined_exact(self, ray_init):
        shards = rd.range(100, parallelism=10).streaming_split(2)
        seen = []
        for sh in shards:
            for b in sh.iter_batches(batch_size=None, prefetch_batches=2):
                seen.extend(b["id"].tolist())
        assert sorted(seen) == list(range(100))

    def test_streaming_split_abandoned_lookahead_requeued(self, ray_init):
        """A rank that exits early hands its in-flight lookahead block
        BACK to the coordinator — sibling ranks' shared epoch must not
        silently lose those rows."""
        import time

        shards = rd.range(60, parallelism=6).streaming_split(2)
        it0 = shards[0]._block_iter_windowed(2)
        b0 = next(it0)  # rank 0 consumed ONE block; lookahead in flight
        it0.close()  # abandon: the lookahead is requeued, not dropped
        time.sleep(0.3)  # let the fire-and-forget requeue land
        rows1 = []
        for b in shards[1].iter_batches(batch_size=None,
                                        prefetch_batches=0):
            rows1.extend(b["id"].tolist())
        assert b0.num_rows + len(rows1) == 60

    def test_streaming_split_pipelined_multi_epoch(self, ray_init):
        shards = rd.range(20, parallelism=4).streaming_split(1)
        for _epoch in range(2):
            got = []
            for b in shards[0].iter_batches(batch_size=None,
                                            prefetch_batches=2):
                got.extend(b["id"].tolist())
            assert sorted(got) == list(range(20))


def test_iter_torch_batches(ray_init):
    """Torch interop (≈ iter_torch_batches): numpy batches become torch
    tensors with optional per-column dtypes."""
    import torch

    from ray_tpu_torch import data

    ds = data.range(100).map_batches(
        lambda b: {"x": b["id"], "y": b["id"] * 2.0})
    total = 0
    for batch in ds.iter_torch_batches(batch_size=32,
                                       dtypes={"y": torch.float64}):
        assert isinstance(batch["x"], torch.Tensor)
        assert batch["y"].dtype == torch.float64
        total += int(batch["x"].sum())
    assert total == sum(range(100))


# ------------------------------------------------------------ JAX twins


class TestAgainstJax:
    @pytest.mark.parametrize("name", [
        "random_shuffle", "map_then_shuffle", "shuffled_batches", "sort",
        "sort_descending", "groupby", "repartition", "split", "zip",
        "aggregates"])
    def test_seeded_pipeline_matches_jax(self, ray_init, jax_ref, name):
        """The same seeded pipeline gives the same rows, in the same
        order, in the port as in the JAX package."""
        got = _seeded_pipelines(rd)[name]
        assert got == jax_ref[name]

    def test_device_batches_match_torch_and_jax_batches(self, ray_init,
                                                        jax_ref):
        """``iter_device_batches(device="cpu")`` gives the values
        ``iter_torch_batches`` gives and JAX's ``iter_jax_batches`` gave
        (JAX keeps 32-bit dtypes; the port keeps numpy's)."""
        import torch

        ds = rd.range(32, parallelism=4).map_batches(_features)
        dev = list(ds.iter_device_batches(batch_size=8, device="cpu"))
        tb = list(ds.iter_torch_batches(batch_size=8))
        assert len(dev) == len(tb) == len(jax_ref["iter_jax_batches"]) == 4
        for d, t, j in zip(dev, tb, jax_ref["iter_jax_batches"]):
            assert set(d) == set(t) == set(j) == {"id", "x", "v"}
            for k in d:
                assert d[k].dtype == t[k].dtype
                assert torch.equal(d[k], t[k])
                assert np.array_equal(d[k].numpy(), j[k])
        assert dev[0]["v"].shape == (8, 3)
        assert dev[0]["x"].dtype == torch.float32

    def test_device_batches_dtypes_devices_and_prefetch(self, ray_init):
        import torch

        ds = rd.range(20, parallelism=3)
        for prefetch in (0, 1, 3):
            out = list(ds.iter_device_batches(
                batch_size=6, device={"id": "cpu"}, prefetch=prefetch,
                dtypes={"id": torch.float64}))
            assert [b["id"].tolist() for b in out] == [
                [float(i) for i in builtins_range(lo, min(lo + 6, 20))]
                for lo in builtins_range(0, 20, 6)]
            assert all(b["id"].dtype == torch.float64 for b in out)
        with pytest.raises(ValueError, match="prefetch"):
            ds.iter_device_batches(batch_size=6, device="cpu", prefetch=-1)

    def test_device_batches_without_cuda_raise(self, ray_init, monkeypatch):
        """No CUDA and no ``device=``: it raises, never a CPU tensor."""
        import torch

        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            next(iter(rd.range(4).iter_device_batches(batch_size=2)))
        # a column the device dict leaves out goes to the default device
        with pytest.raises(RuntimeError, match="no CUDA device"):
            next(iter(rd.range(4).map_batches(_sq).iter_device_batches(
                batch_size=2, device={"id": "cpu"})))

    def test_read_only_views_are_copied_for_the_cpu(self, ray_init):
        """A read-only numpy view (an arena batch) becomes a tensor of
        its own: no warning about a non-writable array."""
        import warnings

        from ray_tpu_torch.data.iterator import DeviceBatches

        view = np.arange(6, dtype=np.int32)
        view.setflags(write=False)
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            (out,) = list(DeviceBatches(iter([{"t": view}]), device="cpu"))
        out["t"] += 1
        assert view.tolist() == list(builtins_range(6))


class TestTensorColumns:
    @pytest.mark.parametrize("dtype", ["int32", "int64", "float32",
                                       "float64", "bool", "uint8"])
    def test_tensor_columns_keep_their_dtype(self, dtype):
        """A tensor column comes back in its own dtype, sliced and
        concatenated too. The JAX package's copy widens int32 and float32
        (nested Python lists): the port's keeps the values it widens."""
        from ray_tpu.data import block as jblock

        from ray_tpu_torch.data import block

        v = (np.arange(60) % 7).astype(dtype).reshape(5, 3, 4)
        b = block.batch_to_block({"t": v})
        out = block.block_to_batch(b)["t"]
        assert out.dtype == v.dtype and np.array_equal(out, v)
        assert out.flags.writeable
        both = block.concat_blocks([b, block.batch_to_block({"t": v})])
        part = block.block_to_batch(block.slice_block(both, 3, 8))["t"]
        assert part.dtype == v.dtype
        assert np.array_equal(part, np.concatenate([v, v])[3:8])
        jax_out = jblock.block_to_batch(jblock.batch_to_block({"t": v}))["t"]
        assert np.array_equal(out, jax_out)

    def test_ragged_and_empty_columns_as_in_jax(self):
        import pyarrow as pa

        from ray_tpu.data import block as jblock

        from ray_tpu_torch.data import block

        for table in (pa.table({"t": pa.array([[1, 2], [3]])}),
                      pa.table({"t": pa.array([[1, None], [3, 4]])})):
            got = block.block_to_batch(table)["t"]
            want = jblock.block_to_batch(table)["t"]
            assert got.dtype == want.dtype and got.tolist() == want.tolist()
        for v in (np.ones((3, 0), np.float32), np.zeros((0, 3), np.int64)):
            got = block.block_to_batch(block.batch_to_block({"t": v}))["t"]
            want = jblock.block_to_batch(jblock.batch_to_block({"t": v}))["t"]
            assert got.dtype == want.dtype and got.shape == want.shape

    def test_int32_tokens_reach_the_iterator_as_int32(self, ray_init):
        import torch

        ds = rd.range(16, parallelism=2).map_batches(
            lambda b: {"tokens": np.stack([b["id"]] * 4, 1).astype(
                np.int32)})
        out = list(ds.iter_device_batches(batch_size=8, device="cpu"))
        assert [b["tokens"].dtype for b in out] == [torch.int32] * 2


def _shard_ids_loop(config):
    from ray_tpu_torch import train

    ctx = train.get_context()
    ids = []
    for b in train.get_dataset_shard("train").iter_device_batches(
            batch_size=5, device="cpu"):
        ids.extend(int(x) for x in b["id"])
    with open(os.path.join(config["out"],
                           f"{ctx.get_world_rank()}.json"), "w") as f:
        json.dump(ids, f)
    train.report({"rows": len(ids)})


def test_torch_trainer_shards_every_row_once(ray_init, tmp_path):
    """``TorchTrainer(datasets=...)`` over gloo with 2 CPU workers splits
    the dataset once with ``streaming_split(2, equal=True)``: each rank
    reads its shard through ``get_dataset_shard``, and every row reaches
    exactly one rank, the two ranks the same number of rows."""
    from ray_tpu_torch.train import (RunConfig, ScalingConfig, TorchConfig,
                                     TorchTrainer)

    out = tmp_path / "ids"
    out.mkdir()
    res = TorchTrainer(
        _shard_ids_loop, train_loop_config={"out": str(out)},
        scaling_config=ScalingConfig(num_workers=2),
        torch_config=TorchConfig(backend="gloo"),
        run_config=RunConfig(storage_path=str(tmp_path / "runs")),
        datasets={"train": rd.range(40, parallelism=8)}).fit()
    assert res.error is None
    ranks = [json.loads((out / f"{r}.json").read_text()) for r in (0, 1)]
    assert sorted(ranks[0] + ranks[1]) == list(builtins_range(40))
    assert len(ranks[0]) == len(ranks[1]) == 20
