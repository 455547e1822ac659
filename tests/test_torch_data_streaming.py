"""Streaming data plane (`data/_internal/streaming.py`): channel-backed
read->map->batch pipelines. Exact batch parity with the task-based
loader (shuffled and not), zero steady-state control-plane RPCs
counter-asserted per stage AND per consumer, pins back to baseline,
clean failure on a mid-epoch reader kill, knob zero-rejection, and the
feed() adapter into PipelineTrainer."""

import functools
import os
import sys
import time

import cloudpickle
import numpy as np
import pytest

import ray_tpu_torch as rt
from ray_tpu_torch import data as rd
from ray_tpu_torch._private.exceptions import ChannelClosedError
from ray_tpu_torch.data._internal import streaming as ds
from tests.test_torch_runtime_cluster import (
    retire_leftover_jax_runtime, retire_leftover_jax_runtime_for_later_files)

os.environ.setdefault("RAY_TPU_TORCH_LOG_LEVEL", "WARNING")
# the UDFs ship by value: a worker never imports this module (and with
# it JAX)
cloudpickle.register_pickle_by_value(sys.modules[__name__])

# the feed-driven training case: bench.py's CPU shape of gpt2_small
FEED_B, FEED_S, FEED_BLOCKS, FEED_EPOCHS, FEED_VOCAB = 4, 128, 3, 2, 1024
# (seed, epoch, shuffle_buffer) of the task baselines held against JAX's
TASK_CASES = [(7, 1, None), (7, 2, None), (3, 1, 16), (3, 2, 16)]


def _feed_tokens_batch(vocab, seq, b):
    """bench.py's streaming-feed transform, without its delay: ids -> a
    [rows, seq] int32 token block seeded by the block's first id."""
    ids = np.asarray(b["id"])
    rng = np.random.default_rng(1234 + int(ids[0]))
    return {"tokens": rng.integers(0, vocab, (len(ids), seq))
            .astype(np.int32)}


def _feed_data(rdm):
    return rdm.range(FEED_BLOCKS * FEED_B, parallelism=FEED_BLOCKS) \
        .map_batches(functools.partial(_feed_tokens_batch, FEED_VOCAB,
                                       FEED_S))


def _task_data(rdm):
    return rdm.range(120, parallelism=6).map_batches(_double)


def _jax_model():
    import jax.numpy as jnp

    from ray_tpu.models import presets as jpresets

    return jpresets.gpt2_small(num_layers=2, embed_dim=128, num_heads=4,
                               vocab_size=FEED_VOCAB, dtype=jnp.float32,
                               scan_layers=False)


def _feed_ocfg(training_mod):
    return training_mod.OptimizerConfig(warmup_steps=10, decay_steps=1000)


@pytest.fixture(scope="module", autouse=True)
def _no_leftover_jax_runtime():
    yield
    retire_leftover_jax_runtime_for_later_files()


@pytest.fixture(scope="module")
def jax_ref():
    """JAX's task baselines and JAX's train step fed by JAX's
    ``StreamingExecutor.feed`` (bench.py's ``data_regime_main`` at its CPU
    shape), on a JAX cluster shut down before the port's starts."""
    import jax
    import jax.numpy as jnp

    import ray_tpu
    from ray_tpu import data as jrd
    from ray_tpu.data._internal import streaming as jds
    from ray_tpu.models import training as jtraining

    retire_leftover_jax_runtime()
    ray_tpu.init(num_cpus=8, object_store_memory=128 * 1024 * 1024)
    try:
        ops = _task_data(jrd)._ops
        out = {"task": {case: [
            {k: np.array(v) for k, v in b.items()}
            for b in jds.task_epoch_batches(
                ops, batch_size=16, epoch=case[1], seed=case[0],
                shuffle_buffer=case[2])] for case in TASK_CASES}}
        jcfg = _jax_model()
        jstate, jtx = jtraining.init_train_state(
            jcfg, _feed_ocfg(jtraining), jax.random.PRNGKey(0))
        out["init_state"] = jax.tree.map(np.asarray, jstate)
        jstep = jtraining.make_train_step(jcfg, jtx, donate=False,
                                          log_grad_norm=False)
        box, losses, seen = [jstate], [], []

        def train_step(b):
            seen.append(np.array(b["tokens"]))
            box[0], m = jstep(box[0], {"tokens": jnp.asarray(b["tokens"])})
            losses.append(float(m["loss"]))

        ex = jds.StreamingExecutor(_feed_data(jrd)._ops, batch_size=FEED_B,
                                   epochs=FEED_EPOCHS, seed=0,
                                   num_readers=1)
        try:
            for _ in ex.feed(train_step):
                pass
        finally:
            ex.shutdown()
        out["feed_losses"], out["feed_batches"] = losses, seen
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


def _double(b):
    return {"id": b["id"] * 2}


def _assert_batches_equal(expected, actual):
    assert len(expected) == len(actual), (len(expected), len(actual))
    for e, a in zip(expected, actual):
        assert set(e) == set(a)
        for k in e:
            assert np.array_equal(e[k], a[k]), k


def _collect_epochs(ex):
    """Consume an executor fully, split batches by epoch boundary."""
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


class TestStreamingParity:
    def test_parity_multi_epoch_unshuffled(self, ray_init):
        d = rd.range(200, parallelism=8).map_batches(_double)
        ex = ds.StreamingExecutor(d._ops, batch_size=32, epochs=2, seed=7,
                                  num_readers=3)
        assert ex.is_channel_backed and ex.channel_depth > 1
        try:
            got = _collect_epochs(ex)
            for epoch, act in enumerate(got, start=1):
                exp = list(ds.task_epoch_batches(
                    d._ops, batch_size=32, epoch=epoch, seed=7))
                _assert_batches_equal(exp, act)
            # the shard order re-seeds per epoch: same multiset of rows,
            # different stream order
            flat = [np.concatenate([b["id"] for b in ep]) for ep in got]
            assert sorted(flat[0].tolist()) == sorted(flat[1].tolist())
            assert flat[0].tolist() != flat[1].tolist()
        finally:
            ex.shutdown()

    def test_parity_shuffled(self, ray_init):
        d = rd.range(150, parallelism=6).map_batches(_double)
        ex = ds.StreamingExecutor(d._ops, batch_size=25, epochs=2, seed=3,
                                  shuffle_buffer=60, num_readers=2)
        try:
            got = _collect_epochs(ex)
            for epoch, act in enumerate(got, start=1):
                exp = list(ds.task_epoch_batches(
                    d._ops, batch_size=25, epoch=epoch, seed=3,
                    shuffle_buffer=60))
                _assert_batches_equal(exp, act)
            # the windowed shuffle actually shuffled (not just shards)
            ids = np.concatenate([b["id"] for b in got[0]])
            assert ids.tolist() != sorted(ids.tolist())
        finally:
            ex.shutdown()

    def test_no_transform_chain_fixed_shapes(self, ray_init):
        """A bare read plan streams reader -> batcher (no transform
        stage), still matches the task loader, and drop_last keeps
        every batch at the fixed shape."""
        d = rd.range(100, parallelism=5)
        ex = ds.StreamingExecutor(d._ops, batch_size=32, epochs=1, seed=1,
                                  drop_last=True, num_readers=2)
        try:
            assert len(ex._transforms) == 0
            act = _collect_epochs(ex)[0]
            assert [len(b["id"]) for b in act] == [32, 32, 32]
            exp = list(ds.task_epoch_batches(d._ops, batch_size=32,
                                             epoch=1, seed=1,
                                             drop_last=True))
            _assert_batches_equal(exp, act)
        finally:
            ex.shutdown()


class TestStreamingSteadyState:
    def test_zero_rpc_warm_epoch(self, ray_init):
        """The acceptance bar: a warm epoch issues ZERO control-plane
        RPCs on every stage and on the consumer — counter-asserted via
        the in-band per-epoch deltas."""
        # earlier task-path work in this module session left GC'd
        # zero-copy views whose batched unpin RPCs would trickle into
        # the consumer's process-wide delta — drain them first
        ds.quiesce_driver_rpcs()
        d = rd.range(240, parallelism=8).map_batches(_double)
        ex = ds.StreamingExecutor(d._ops, batch_size=48, epochs=3, seed=5,
                                  num_readers=2)
        try:
            it = ex.batches()
            next(it)
            # a second live iterator would silently interleave channel
            # reads with the first — rejected loudly instead
            with pytest.raises(RuntimeError, match="already consuming"):
                next(ex.batches())
            for _ in it:
                pass
            stats = ex.epoch_stats
            assert len(stats) == 3
            for st in stats[1:]:  # epochs >= 2 are warm by construction
                assert st["consumer_rpc_calls"] == 0, st
                for rep in st["stage_reports"]:
                    assert rep["rpc_calls"] == 0, rep
            # stage accounting is coherent: 8 blocks, 5 batches per epoch
            for st in stats:
                assert st["batches"] == 5
                batcher = [r for r in st["stage_reports"]
                           if r["role"] == "batcher"]
                assert batcher and batcher[0]["blocks"] == 8
        finally:
            ex.shutdown()

    def test_pins_released_and_post_shutdown_raises(self, ray_init):
        pins_before = _store_pins()
        d = rd.range(64, parallelism=4)
        ex = ds.StreamingExecutor(d._ops, batch_size=16, epochs=1,
                                  num_readers=2)
        assert _store_pins() > pins_before  # channels really pinned
        list(ex.batches())
        ex.shutdown()
        import time

        deadline = time.monotonic() + 20
        while time.monotonic() < deadline and _store_pins() != pins_before:
            time.sleep(0.2)
        assert _store_pins() == pins_before
        with pytest.raises((ChannelClosedError, RuntimeError)):
            next(iter(ex.batches()))

    def test_early_break_releases(self, ray_init):
        """A consumer that stops mid-epoch (break) still unwinds pins —
        StreamingBatches shuts the executor down on close."""
        pins_before = _store_pins()
        it = rd.range(400, parallelism=8).stream_batches(
            batch_size=10, epochs=5, seed=0)
        for i, _b in enumerate(it):
            if i >= 3:
                break
        import time

        deadline = time.monotonic() + 20
        while time.monotonic() < deadline and _store_pins() != pins_before:
            time.sleep(0.2)
        assert _store_pins() == pins_before

    def test_reader_kill_mid_epoch_raises_clean(self, ray_init):
        """Partial-epoch consumption surfaces a clean error (channel
        close fan-out from the participant death), never a silently
        truncated epoch; pins return to baseline."""
        from ray_tpu_torch._private.exceptions import ActorDiedError, TaskError

        pins_before = _store_pins()
        d = rd.range(4000, parallelism=40)
        ex = ds.StreamingExecutor(d._ops, batch_size=10, epochs=3, seed=0,
                                  num_readers=2, depth=2)
        try:
            it = ex.batches()
            for _ in range(3):
                next(it)
            rt.kill(ex._readers[0])
            with pytest.raises((ChannelClosedError, ActorDiedError,
                                TaskError)):
                for _ in it:
                    pass
        finally:
            ex.shutdown()
        import time

        deadline = time.monotonic() + 20
        while time.monotonic() < deadline and _store_pins() != pins_before:
            time.sleep(0.2)
        assert _store_pins() == pins_before


class TestStreamingSurface:
    def test_iter_batches_streaming(self, ray_init):
        d = rd.range(96, parallelism=4).map_batches(_double)
        act = list(d.iter_batches(batch_size=24, streaming=True,
                                  local_shuffle_seed=2))
        exp = list(ds.task_epoch_batches(d._ops, batch_size=24, epoch=1,
                                         seed=2))
        _assert_batches_equal(exp, act)

    def test_iter_batches_streaming_rejects_formats(self, ray_init):
        with pytest.raises(ValueError, match="numpy"):
            rd.range(8).iter_batches(streaming=True,
                                     batch_format="pandas")

    def test_unsupported_plans_raise(self, ray_init):
        with pytest.raises(ValueError, match="Read source"):
            rd.from_items([{"a": 1}]).stream_batches(batch_size=1)
        # all-to-all plans now compile onto the streaming exchange —
        # the UNSEEDED shuffle is what still (loudly) refuses to stream
        with pytest.raises(ValueError, match="unseeded"):
            rd.range(10).random_shuffle().stream_batches(batch_size=2)
        with pytest.raises(ValueError, match="read->map"):
            rd.range(10).limit(5).stream_batches(batch_size=2)

    def test_knob_zero_rejection(self, ray_init, monkeypatch):
        d = rd.range(16, parallelism=2)
        with pytest.raises(ValueError, match="depth"):
            ds.StreamingExecutor(d._ops, batch_size=4, depth=0)
        with pytest.raises(ValueError, match="shuffle_buffer"):
            ds.StreamingExecutor(d._ops, batch_size=4, shuffle_buffer=0)
        with pytest.raises(ValueError, match="batch_size"):
            ds.StreamingExecutor(d._ops, batch_size=0)
        with pytest.raises(ValueError, match="num_readers"):
            ds.StreamingExecutor(d._ops, batch_size=4, num_readers=0)
        monkeypatch.setenv("RAY_TPU_TORCH_DATA_STREAM_DEPTH", "0")
        with pytest.raises(ValueError, match="RAY_TPU_TORCH_DATA_STREAM_DEPTH"):
            ds.StreamingExecutor(d._ops, batch_size=4)
        monkeypatch.delenv("RAY_TPU_TORCH_DATA_STREAM_DEPTH")
        monkeypatch.setenv("RAY_TPU_TORCH_DATA_SHUFFLE_BUFFER", "0")
        with pytest.raises(ValueError,
                           match="RAY_TPU_TORCH_DATA_SHUFFLE_BUFFER"):
            ds.StreamingExecutor(d._ops, batch_size=4)
        monkeypatch.delenv("RAY_TPU_TORCH_DATA_SHUFFLE_BUFFER")
        # an unseeded shuffle must raise, not silently pin to seed 0
        # (identical "random" order every run) or break parity
        with pytest.raises(ValueError, match="explicit seed"):
            ds.StreamingExecutor(d._ops, batch_size=4, shuffle_buffer=8,
                                 seed=None)
        with pytest.raises(ValueError, match="explicit seed"):
            list(ds.task_epoch_batches(d._ops, batch_size=4, seed=None,
                                       shuffle_buffer=8))

    def test_stream_batches_depth_kwarg(self, ray_init):
        """depth= reaches the executor through the Dataset surface (it
        used to collide with the computed prefetch mapping)."""
        it = rd.range(16, parallelism=2).stream_batches(
            batch_size=8, depth=2, num_readers=1)
        assert it.executor.channel_depth == 2
        assert sum(len(b["id"]) for b in it) == 16


class TestEpochStreamUnits:
    """Pure-function units of the shared shuffle+batch stream."""

    def test_epoch_order_deterministic_and_reseeded(self):
        a = ds.epoch_order(10, 3, 1)
        assert a.tolist() == ds.epoch_order(10, 3, 1).tolist()
        assert a.tolist() != ds.epoch_order(10, 3, 2).tolist()
        assert sorted(a.tolist()) == list(range(10))
        assert ds.epoch_order(5, None, 9).tolist() == [0, 1, 2, 3, 4]

    def test_batch_stream_carry(self):
        blocks = [{"x": np.arange(7)}, {"x": np.arange(7, 10)},
                  {"x": np.array([], np.int64)}, {"x": np.arange(10, 13)}]
        out = list(ds.epoch_batch_stream(iter(blocks), batch_size=5))
        assert [len(b["x"]) for b in out] == [5, 5, 3]
        assert np.concatenate([b["x"] for b in out]).tolist() == \
            list(range(13))
        out = list(ds.epoch_batch_stream(iter(blocks), batch_size=5,
                                         drop_last=True))
        assert [len(b["x"]) for b in out] == [5, 5]

    def test_shuffle_stream_is_seed_deterministic(self):
        blocks = [{"x": np.arange(i * 10, (i + 1) * 10)} for i in range(6)]

        def run():
            return list(ds.epoch_batch_stream(
                iter(blocks), batch_size=12, shuffle_buffer=25,
                rng=ds.shuffle_rng(4, 1)))

        a, b = run(), run()
        _assert_batches_equal(a, b)
        flat = np.concatenate([x["x"] for x in a])
        assert sorted(flat.tolist()) == list(range(60))
        assert flat.tolist() != list(range(60))


@pytest.mark.slow
def test_data_stream_speedup_full(ray_init):
    """Full-size acceptance probe (the microbenchmark's smoke variant
    rides tier-1): streaming sustains >= 2x the task loader's batch
    rate, and at a consumer demand rate where the task loader's stall
    fraction exceeds 0.2 the stream's is ~0."""
    import time

    d = rd.range(64 * 80, parallelism=64).map_batches(_double)
    bs = 80
    epoch_batches = 64 * 80 // bs

    def task_epoch():
        return sum(1 for _ in ds.task_epoch_batches(
            d._ops, batch_size=bs, epoch=1, seed=0))

    task_epoch()  # warm
    t0 = time.perf_counter()
    n = 0
    while time.perf_counter() - t0 < 4.0:
        n += task_epoch()
    task_rate = n / (time.perf_counter() - t0)

    ex = ds.StreamingExecutor(d._ops, batch_size=bs, epochs=100_000,
                              seed=0, num_readers=2)
    assert ex.is_channel_backed and ex.channel_depth > 1
    try:
        it = ex.batches()
        while len(ex.epoch_stats) < 1:
            next(it)
        t0 = time.perf_counter()
        n = 0
        while time.perf_counter() - t0 < 4.0:
            next(it)
            n += 1
        stream_rate = n / (time.perf_counter() - t0)
        assert stream_rate >= 2.0 * task_rate, (stream_rate, task_rate)

        t_c = 1.0 / (1.5 * task_rate)

        def stall_fraction(next_batch) -> float:
            next_batch()
            stall = 0.0
            t_start = time.perf_counter()
            for _ in range(2 * epoch_batches):
                t1 = time.perf_counter()
                next_batch()
                stall += time.perf_counter() - t1
                time.sleep(t_c)
            return stall / max(time.perf_counter() - t_start, 1e-9)

        def task_stream():
            while True:
                yield from ds.task_epoch_batches(
                    d._ops, batch_size=bs, epoch=1, seed=0)

        t_it = task_stream()
        task_stall = stall_fraction(lambda: next(t_it))
        stream_stall = stall_fraction(lambda: next(it))
        assert task_stall > 0.2, task_stall
        assert stream_stall < 0.05, stream_stall
    finally:
        ex.shutdown()


# -------------------------------------------------------- feed adapters


def _probe_stage_init():
    import torch

    return {"w": torch.ones((1,), dtype=torch.float32)}


def _probe_stage_fwd(params, x):
    import torch

    return torch.as_tensor(x).to(torch.float32) * params["w"][0]


def _probe_stage_loss(params, x, labels):
    import torch

    return torch.mean(x * params["w"][0])


# the stages run on the host: a stage asks for a card by default
_CPU2 = [{"num_gpus": 0}] * 2


def _tokens_col(b):
    ids = b["id"].astype(np.int32)
    return {"tokens": np.stack([ids % 13, (ids + 1) % 13], axis=1)}


class TestFeed:
    def test_feed_zero_copy_views(self, ray_init):
        """feed() hands READ-ONLY arena views to the step callable —
        values identical to the task loader, no copy-out."""
        d = rd.range(80, parallelism=4).map_batches(_double)
        ex = ds.StreamingExecutor(d._ops, batch_size=20, epochs=1, seed=9,
                                  num_readers=2)
        seen = []

        def step(batch):
            arr = batch["id"]
            assert isinstance(arr, np.ndarray)
            assert not arr.flags.writeable  # a view over the arena
            seen.append(np.array(arr))
            return len(arr)

        try:
            assert list(ex.feed(step)) == [20, 20, 20, 20]
            exp = list(ds.task_epoch_batches(d._ops, batch_size=20,
                                             epoch=1, seed=9))
            _assert_batches_equal(exp, [{"id": a} for a in seen])
        finally:
            ex.shutdown()

    def test_feed_pipeline_trainer(self, ray_init):
        """Data-feeds-Train: stream fixed-shape token batches straight
        into PipelineTrainer.step; losses match the same trainer math
        fed by the task-based loader (same seed => same batches)."""
        from ray_tpu_torch.train import PipelineTrainer

        stages = [
            {"init": _probe_stage_init, "fwd": _probe_stage_fwd},
            {"init": _probe_stage_init, "loss": _probe_stage_loss},
        ]
        d = rd.range(128, parallelism=4).map_batches(_tokens_col)

        # tasks mode: identical stage math, no channel build — just the
        # loss reference, not the substrate under test
        ref_trainer = PipelineTrainer(stages, num_microbatches=4,
                                      optimizer=("sgd", 0.05),
                                      mode="tasks", stage_options=_CPU2)
        try:
            ref_losses = [
                ref_trainer.step(b)["loss"]
                for b in ds.task_epoch_batches(d._ops, batch_size=32,
                                               epoch=1, seed=11)]
        finally:
            ref_trainer.shutdown()

        trainer = PipelineTrainer(stages, num_microbatches=4,
                                  optimizer=("sgd", 0.05),
                                  buffer_bytes=1 << 16, stage_options=_CPU2)
        ex = ds.StreamingExecutor(d._ops, batch_size=32, epochs=1,
                                  seed=11, num_readers=2)
        try:
            losses = [out["loss"] for out in ex.feed(trainer.step)]
        finally:
            ex.shutdown()
            trainer.shutdown()
        assert len(losses) == 4
        np.testing.assert_allclose(losses, ref_losses, atol=1e-6)


# ------------------------------------------------------------ JAX twins


class TestAgainstJax:
    """The pure functions of the epoch stream bit for bit against JAX's,
    the task baselines, and the feed-driven training path end to end."""

    @pytest.mark.parametrize("seed", [0, 3, 2 ** 40 + 5, None])
    def test_epoch_order_matches_jax(self, seed):
        from ray_tpu.data._internal import streaming as jds

        for shards in (1, 5, 24):
            for epoch in (1, 2, 3):
                assert np.array_equal(ds.epoch_order(shards, seed, epoch),
                                      jds.epoch_order(shards, seed, epoch))

    @pytest.mark.parametrize("rank", [0, 1, 3])
    def test_shuffle_rng_matches_jax(self, rank):
        from ray_tpu.data._internal import streaming as jds

        for seed in (0, 11, 2 ** 33):
            for epoch in (1, 4):
                a = ds.shuffle_rng(seed, epoch, rank).integers(0, 2 ** 62, 64)
                b = jds.shuffle_rng(seed, epoch, rank).integers(0, 2 ** 62,
                                                                64)
                assert np.array_equal(a, b)
        with pytest.raises(ValueError, match="explicit seed"):
            ds.shuffle_rng(None, 1)

    @pytest.mark.parametrize("shuffle_buffer,drop_last", [
        (None, False), (None, True), (25, False), (7, True)])
    def test_epoch_batch_stream_matches_jax(self, shuffle_buffer, drop_last):
        from ray_tpu.data._internal import streaming as jds

        rng = np.random.default_rng(5)
        sizes = [7, 0, 13, 1, 30, 4, 9]
        starts = np.cumsum([0] + sizes)
        blocks = [{"x": np.arange(s, s + n),
                   "t": rng.integers(0, 9, (n, 3)).astype(np.int32)}
                  for s, n in zip(starts, sizes)]

        def run(mod):
            return list(mod.epoch_batch_stream(
                iter(blocks), batch_size=6, shuffle_buffer=shuffle_buffer,
                rng=None if shuffle_buffer is None else mod.shuffle_rng(8, 2),
                drop_last=drop_last))

        got, want = run(ds), run(jds)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert set(g) == set(w)
            for k in g:
                assert g[k].dtype == w[k].dtype
                assert np.array_equal(g[k], w[k])

    @pytest.mark.parametrize("case", TASK_CASES, ids=str)
    def test_task_epoch_batches_match_jax(self, ray_init, jax_ref, case):
        seed, epoch, buf = case
        got = list(ds.task_epoch_batches(
            _task_data(rd)._ops, batch_size=16, epoch=epoch, seed=seed,
            shuffle_buffer=buf))
        _assert_batches_equal(jax_ref["task"][case], got)

    def test_feed_driven_training_matches_jax(self, ray_init, jax_ref):
        """bench.py's data path at its CPU shape: the port's train step fed
        by the port's ``StreamingExecutor.feed`` over 2 epochs gives the
        losses JAX's train step fed by JAX's gave (from the same initial
        state), on the same batches. Tolerance: test_torch_train.py's
        five-step losses, rtol 1e-5."""
        import torch

        from ray_tpu_torch._private import convert
        from ray_tpu_torch.models import presets, training

        cfg = presets.gpt2_small(num_layers=2, embed_dim=128, num_heads=4,
                                 vocab_size=FEED_VOCAB, dtype=torch.float32)
        state = convert.train_state_from_jax(jax_ref["init_state"],
                                             device="cpu")
        step = training.make_train_step(
            cfg, training.make_optimizer(_feed_ocfg(training)),
            log_grad_norm=False)
        box, losses, seen = [state], [], []

        def train_step(b):
            host = np.array(b["tokens"])  # out of the arena first
            seen.append(host)
            box[0], m = step(box[0], {"tokens": torch.from_numpy(host)})
            losses.append(float(m["loss"]))

        ex = ds.StreamingExecutor(_feed_data(rd)._ops, batch_size=FEED_B,
                                  epochs=FEED_EPOCHS, seed=0, num_readers=1)
        try:
            for _ in ex.feed(train_step):
                pass
        finally:
            ex.shutdown()
        assert len(losses) == FEED_BLOCKS * FEED_EPOCHS
        for a, b in zip(seen, jax_ref["feed_batches"]):
            assert a.dtype == np.int32 and np.array_equal(a, b)
        np.testing.assert_allclose(losses, jax_ref["feed_losses"],
                                   rtol=1e-5)

    def test_step_must_copy_its_view_before_returning(self, ray_init):
        """``feed`` acks a batch's slot when the step returns. A step that
        keeps the read-only view and returns (as one that only enqueues
        work on the card would) later reads a slot the batcher has
        refilled; a step that copies before it returns keeps its batch."""
        d = rd.range(96, parallelism=12).map_batches(_double)
        base = [b["id"] for b in ds.task_epoch_batches(
            d._ops, batch_size=8, epoch=1, seed=4)]
        stale = {}
        for copying in (True, False):
            ex = ds.StreamingExecutor(d._ops, batch_size=8, epochs=1,
                                      seed=4, num_readers=1, depth=2)
            held = []

            def step(b):
                view = b["id"]
                assert not view.flags.writeable
                held.append(np.array(view) if copying else view)
                return len(held)

            try:
                for n in ex.feed(step):
                    if n == 8:
                        break
                # what each batch a step kept reads now, before teardown
                now = [np.array(h) for h in held]
            finally:
                ex.shutdown()
            stale[copying] = [i for i, h in enumerate(now)
                              if not np.array_equal(h, base[i])]
        assert stale[True] == []
        assert 0 in stale[False], stale
