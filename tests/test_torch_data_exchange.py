"""Streaming all-to-all exchange (`data/_internal/exchange.py`):
shuffle/repartition as channel stages. Exact batch parity with the
task-based barrier baseline across epochs (the epoch folded into the
partition hash), per-rank streaming_split parity, unseeded-shuffle and
falsy-zero knob rejection, empty buckets and ragged final blocks, zero
steady-state control-plane RPCs counter-asserted on every producer,
consumer AND the driver, pins back to baseline, and a clean error on a
mid-shuffle stage kill."""

import os
import sys

import cloudpickle
import numpy as np
import pytest

import ray_tpu_torch as rt
from ray_tpu_torch import data as rd
from ray_tpu_torch._private.exceptions import (ActorDiedError,
                                               ChannelClosedError, TaskError)
from ray_tpu_torch.data._internal import exchange as dx
from ray_tpu_torch.data._internal import streaming as ds
from tests.test_torch_runtime_cluster import (
    retire_leftover_jax_runtime, retire_leftover_jax_runtime_for_later_files)

os.environ.setdefault("RAY_TPU_TORCH_LOG_LEVEL", "WARNING")
# the UDFs ship by value: a worker never imports this module (and with
# it JAX)
cloudpickle.register_pickle_by_value(sys.modules[__name__])

# (kind, consumers, rank, epoch, batch_size, drop_last) of the task
# baselines held against JAX's
TASK_CASES = [("shuffle", 2, None, 1, 16, False),
              ("shuffle", 2, 0, 2, 16, False),
              ("shuffle", 3, 2, 1, 8, True),
              ("repartition", 3, 1, 1, 16, False),
              ("repartition", 2, None, 2, None, False)]


def _exchange_data(rdm, kind):
    d = rdm.range(150, parallelism=7).map_batches(_double)
    return d.random_shuffle(seed=11) if kind == "shuffle" else \
        d.repartition(3)


@pytest.fixture(scope="module", autouse=True)
def _no_leftover_jax_runtime():
    yield
    retire_leftover_jax_runtime_for_later_files()


@pytest.fixture(scope="module")
def jax_ref():
    """JAX's task exchange baselines, on a JAX cluster shut down before
    the port's starts."""
    import ray_tpu
    from ray_tpu import data as jrd
    from ray_tpu.data._internal import exchange as jdx

    retire_leftover_jax_runtime()
    ray_tpu.init(num_cpus=8, object_store_memory=128 * 1024 * 1024)
    try:
        return {case: [{k: np.array(v) for k, v in b.items()}
                       for b in jdx.task_exchange_batches(
                           _exchange_data(jrd, case[0])._ops,
                           batch_size=case[4], num_consumers=case[1],
                           consumer_rank=case[2], epoch=case[3], seed=5,
                           drop_last=case[5])]
                for case in TASK_CASES}
    finally:
        ray_tpu.shutdown()


@pytest.fixture(scope="module")
def ray_init(jax_ref):
    """A started single-node port cluster (module-scoped for speed),
    after the JAX references are taken."""
    retire_leftover_jax_runtime()
    info = rt.init(num_cpus=32, num_gpus=0,
                   object_store_memory=256 * 1024 * 1024)
    yield info
    rt.shutdown()


def _double(b):
    return {"id": b["id"] * 2}


def _assert_batches_equal(expected, actual):
    assert len(expected) == len(actual), (len(expected), len(actual))
    for e, a in zip(expected, actual):
        assert set(e) == set(a)
        for k in e:
            assert np.array_equal(e[k], a[k]), k


def _collect_epochs(ex):
    epochs = [[] for _ in range(ex._epochs)]
    for b in ex.batches():
        epochs[len(ex.epoch_stats)].append(b)
    return epochs


def _store_pins():
    from ray_tpu_torch._private import api

    core = api._core
    stats = core._run(core.clients.get(core.supervisor_addr).call(
        "store_stats", timeout=60))
    return stats["pins_total"]


class TestExchangeParity:
    def test_shuffle_parity_two_epochs(self, ray_init):
        """The acceptance bar: a shuffled epoch through the R x C mesh
        is batch-for-batch exact vs the task-based AllToAll barrier at
        the same seed, and the epoch folded into the partition hash
        re-deals rows every epoch with no control messages."""
        d = rd.range(200, parallelism=8).map_batches(_double) \
            .random_shuffle(seed=11)
        ex = dx.ExchangeExecutor(d._ops, batch_size=32, epochs=2, seed=7,
                                 num_producers=3, num_consumers=2)
        assert ex.is_channel_backed and ex.channel_depth > 1
        assert ex.num_producers == 3 and ex.num_consumers == 2
        try:
            got = _collect_epochs(ex)
            for epoch, act in enumerate(got, start=1):
                exp = list(dx.task_exchange_batches(
                    d._ops, batch_size=32, num_consumers=2,
                    epoch=epoch, seed=7))
                _assert_batches_equal(exp, act)
            # same multiset of rows each epoch, different deal/stream
            flat = [np.concatenate([b["id"] for b in ep]) for ep in got]
            assert sorted(flat[0].tolist()) == sorted(flat[1].tolist())
            assert flat[0].tolist() != flat[1].tolist()
            # the shuffle actually shuffled within the merged stream
            assert flat[0].tolist() != sorted(flat[0].tolist())
        finally:
            ex.shutdown()

    def test_repartition_split_parity_per_rank(self, ray_init):
        """streaming_split(n) over repartition(n): every rank's stream
        is exactly its consumer's task-baseline stream, rows balanced,
        nothing lost."""
        d = rd.range(123, parallelism=7).repartition(3)
        its = d.streaming_split(3, epochs=1, seed=5)
        from ray_tpu_torch.data.iterator import _ExchangeSplitIterator

        assert all(isinstance(it, _ExchangeSplitIterator) for it in its)
        assert its[0].executor.is_channel_backed
        try:
            counts = []
            for rank, it in enumerate(its):
                ids = [b["id"] for b in it.iter_batches(
                    batch_size=16, prefetch_batches=0)]
                ids = np.concatenate(ids)
                exp = np.concatenate([e["id"] for e in
                                      dx.task_exchange_batches(
                                          d._ops, batch_size=16,
                                          num_consumers=3,
                                          consumer_rank=rank,
                                          epoch=1, seed=5)])
                assert np.array_equal(ids, exp), rank
                counts.append(len(ids))
            assert sum(counts) == 123
            assert max(counts) - min(counts) <= 7  # +-1 row per block
        finally:
            its[0].close()

    def test_multi_frame_buckets_and_ragged_blocks(self, ray_init):
        """bucket_rows smaller than the per-bucket row count forces
        multi-frame buckets; a row count that doesn't divide the
        parallelism leaves ragged final blocks — both exact."""
        d = rd.range(101, parallelism=7).random_shuffle(seed=4)
        ex = dx.ExchangeExecutor(d._ops, batch_size=16, epochs=1, seed=9,
                                 num_producers=2, num_consumers=2,
                                 bucket_rows=3)
        try:
            act = _collect_epochs(ex)[0]
            exp = list(dx.task_exchange_batches(
                d._ops, batch_size=16, num_consumers=2, epoch=1, seed=9))
            _assert_batches_equal(exp, act)
            assert sum(len(b["id"]) for b in act) == 101
        finally:
            ex.shutdown()

    def test_empty_buckets(self, ray_init):
        """One-row blocks dealt to 4 consumers: most (block, consumer)
        buckets are EMPTY. The zero-row frames keep the deterministic
        merge aligned and every row still lands exactly once."""
        d = rd.range(6, parallelism=6).random_shuffle(seed=21)
        ex = dx.ExchangeExecutor(d._ops, batch_size=2, epochs=1, seed=1,
                                 num_producers=3, num_consumers=4)
        try:
            act = _collect_epochs(ex)[0]
            exp = list(dx.task_exchange_batches(
                d._ops, batch_size=2, num_consumers=4, epoch=1, seed=1))
            _assert_batches_equal(exp, act)
            ids = np.concatenate([b["id"] for b in act])
            assert sorted(ids.tolist()) == list(range(6))
        finally:
            ex.shutdown()

    def test_feed_rank_own_stream(self, ray_init):
        """feed(step, rank=r) hands rank r exactly ITS consumer's
        batches (the PipelineTrainer dp-rank composition) as arena
        views, acked after the step."""
        d = rd.range(96, parallelism=6).random_shuffle(seed=3)
        ex = dx.ExchangeExecutor(d._ops, batch_size=8, epochs=1, seed=2,
                                 num_producers=2, num_consumers=2)
        try:
            seen = list(ex.feed(lambda b: int(b["id"].sum()), rank=1))
            exp = [int(b["id"].sum()) for b in dx.task_exchange_batches(
                d._ops, batch_size=8, num_consumers=2, consumer_rank=1,
                epoch=1, seed=2)]
            assert seen == exp
        finally:
            ex.shutdown()


class TestExchangeGuards:
    def test_unseeded_shuffle_rejected(self, ray_init):
        d = rd.range(20, parallelism=2).random_shuffle()
        with pytest.raises(ValueError, match="unseeded"):
            d.stream_batches(batch_size=4)
        with pytest.raises(ValueError, match="unseeded"):
            dx.ExchangeExecutor(d._ops, batch_size=4)
        # the baseline enforces the same contract (shared plan split)
        with pytest.raises(ValueError, match="unseeded"):
            list(dx.task_exchange_batches(d._ops, batch_size=4,
                                          num_consumers=2))

    def test_incompatible_plans_surface_reasons(self, ray_init):
        sort_ops = rd.range(10, parallelism=2).sort("id")._ops
        reason = dx.exchange_incompatible_reason(sort_ops)
        assert reason is not None and "barrier" in reason
        plain = rd.range(10, parallelism=2)._ops
        assert "no shuffle" in dx.exchange_incompatible_reason(plain)
        after = rd.range(10, parallelism=2).random_shuffle(seed=1) \
            .map_batches(_double)._ops
        assert "terminal" in dx.exchange_incompatible_reason(after)

    def test_knob_explicit_zero_rejected(self, ray_init, monkeypatch):
        d = rd.range(20, parallelism=2).random_shuffle(seed=1)
        monkeypatch.setenv("RAY_TPU_TORCH_DATA_EXCHANGE_DEPTH", "0")
        with pytest.raises(ValueError, match="EXCHANGE_DEPTH"):
            dx.ExchangeExecutor(d._ops, batch_size=4)
        monkeypatch.delenv("RAY_TPU_TORCH_DATA_EXCHANGE_DEPTH")
        monkeypatch.setenv("RAY_TPU_TORCH_DATA_EXCHANGE_BUCKET_ROWS", "0")
        with pytest.raises(ValueError, match="BUCKET_ROWS"):
            dx.ExchangeExecutor(d._ops, batch_size=4)

    def test_mode_and_reuse_guards(self, ray_init):
        d = rd.range(40, parallelism=4).random_shuffle(seed=1)
        ex = dx.ExchangeExecutor(d._ops, batch_size=8, epochs=1, seed=0,
                                 num_consumers=2)
        try:
            it = ex.batches()
            next(it)
            # merged and per-rank reads share the C output channels —
            # mixing them is rejected loudly, not silently interleaved
            with pytest.raises(RuntimeError, match="merged"):
                next(ex.rank_epoch(0))
            with pytest.raises(RuntimeError, match="already consuming"):
                next(ex.batches())
            for _ in it:
                pass
            with pytest.raises(RuntimeError, match="already consumed"):
                next(ex.batches())
        finally:
            ex.shutdown()


class TestExchangeSteadyState:
    def test_zero_rpc_warm_epoch(self, ray_init):
        """The acceptance bar: a warm exchange epoch issues ZERO
        control-plane RPCs on every producer, every consumer, and the
        driver — counter-asserted via the in-band per-epoch deltas."""
        ds.quiesce_driver_rpcs()
        d = rd.range(240, parallelism=8).map_batches(_double) \
            .random_shuffle(seed=13)
        ex = dx.ExchangeExecutor(d._ops, batch_size=48, epochs=3, seed=5,
                                 num_producers=2, num_consumers=2)
        try:
            assert ex.is_channel_backed and ex.channel_depth > 1
            for _ in ex.batches():
                pass
            stats = ex.epoch_stats
            assert len(stats) == 3
            for st in stats[1:]:  # epochs >= 2 are warm by construction
                assert st["consumer_rpc_calls"] == 0, st
                reports = st["stage_reports"]
                # every stage reported: R producers + C consumers
                assert sorted(r["role"] for r in reports) == \
                    ["consumer", "consumer", "producer", "producer"]
                for rep in reports:
                    assert rep["rpc_calls"] == 0, rep
            # skew accounting present and sane on a uniform deal
            for st in stats:
                assert sum(st["rows_per_consumer"]) == 240
                assert 1.0 <= st["skew"] < 2.0
        finally:
            ex.shutdown()

    def test_pins_released_after_shutdown(self, ray_init):
        pins_before = _store_pins()
        d = rd.range(64, parallelism=4).random_shuffle(seed=2)
        ex = dx.ExchangeExecutor(d._ops, batch_size=16, epochs=1, seed=0,
                                 num_consumers=2)
        try:
            for _ in ex.batches():
                pass
        finally:
            ex.shutdown()
        import time

        deadline = time.monotonic() + 30
        while _store_pins() > pins_before and time.monotonic() < deadline:
            time.sleep(0.1)
        assert _store_pins() <= pins_before
        with pytest.raises(ChannelClosedError):
            next(ex.batches())

    def test_mid_shuffle_producer_kill_is_clean(self, ray_init):
        """Killing a producer mid-epoch closes the whole mesh: the
        consumer raises the loop's real error (never StopIteration /
        a silently truncated epoch)."""
        d = rd.range(1200, parallelism=8).random_shuffle(seed=6)
        ex = dx.ExchangeExecutor(d._ops, batch_size=8, epochs=50, seed=1,
                                 num_producers=2, num_consumers=2,
                                 depth=2)
        try:
            it = ex.batches()
            next(it)
            rt.kill(ex._producers[0])
            with pytest.raises(
                    (ChannelClosedError, ActorDiedError, TaskError)):
                for _ in it:
                    pass
        finally:
            ex.shutdown()


# ------------------------------------------------------------ JAX twins


class TestAgainstJax:
    """The partition function bit for bit against JAX's, and the task
    baselines per rank and merged."""

    @pytest.mark.parametrize("seed", [0, 11, 2 ** 36 + 1])
    def test_partition_rng_matches_jax(self, seed):
        from ray_tpu.data._internal import exchange as jdx

        for epoch in (1, 3):
            for pos in (0, 1, 17):
                a = dx.partition_rng(seed, epoch, pos).integers(0, 2 ** 62,
                                                                32)
                b = jdx.partition_rng(seed, epoch, pos).integers(0, 2 ** 62,
                                                                 32)
                assert np.array_equal(a, b)
        with pytest.raises(ValueError, match="explicit seed"):
            dx.partition_rng(None, 1, 0)

    @pytest.mark.parametrize("kind", ["shuffle", "repartition"])
    def test_exchange_assignments_match_jax(self, kind):
        from ray_tpu.data._internal import exchange as jdx

        for consumers in (1, 2, 5):
            for rows in (0, 1, 37):
                for pos in (0, 4):
                    a = dx.exchange_assignments(kind, consumers, rows, 9, 2,
                                                pos)
                    b = jdx.exchange_assignments(kind, consumers, rows, 9,
                                                 2, pos)
                    assert a.dtype == b.dtype and np.array_equal(a, b)

    @pytest.mark.parametrize("case", TASK_CASES, ids=str)
    def test_task_exchange_batches_match_jax(self, ray_init, jax_ref, case):
        kind, consumers, rank, epoch, batch_size, drop_last = case
        got = list(dx.task_exchange_batches(
            _exchange_data(rd, kind)._ops, batch_size=batch_size,
            num_consumers=consumers, consumer_rank=rank, epoch=epoch,
            seed=5, drop_last=drop_last))
        assert got
        _assert_batches_equal(jax_ref[case], got)
