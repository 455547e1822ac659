"""The port's MPMD pipeline trainer (``ray_tpu_torch.train.
PipelineTrainer``) on a CPU cluster of the port's runtime, every stage
actor given ``num_gpus=0`` and one OpenMP thread.

The twins of ``tests/test_train_pipeline.py``'s ``TestPipelineParity``,
``TestPipelineContracts``, ``TestInterleavedVirtualStages``,
``TestFusedFlush`` and the trainer half of ``TestVirtualStageValidation``,
and of ``tests/test_pipeline_tp.py``'s trainer validation; a tp2 x S2
trainer; the card gate of a stage. The oracle is JAX's single-process
reference (``_jax_local_losses``: per-microbatch ``value_and_grad`` of
JAX's ``loss_fn``, the grads averaged over the same microbatch split,
``optax.sgd``) on the port's own seed-0 weights converted by
``_private/convert.py``: losses to ``atol=1e-5`` every step (float32; the
two frameworks' matmul sums run in another order). JAX's own tp2 cluster
runs are no oracle (on the CPU its shm group refuses their reduces: "buffer
size must be a multiple of element size"); the tp2 trainer is held
against JAX's fused model instead. Contracts: zero control-plane
RPCs per stage rank in a steady flush (counter deltas in each report),
slot-ring channels at depth > 1, every pin returned at teardown, a stage
death or a stage exception surfacing as an error (never a hang or a wrong
loss). ``slow`` marks only what JAX marks slow.
"""

import os
import time

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import ray_tpu_torch as rt
from ray_tpu.models import transformer as jtransformer
from ray_tpu_torch._private import convert
from ray_tpu_torch._private.exceptions import (ActorDiedError,
                                               ChannelClosedError)
from ray_tpu_torch.models import presets, transformer
from ray_tpu_torch.train import PipelineTrainer
from tests.test_torch_pipeline_math import _batch, _jax_cfg, _tiny_cfg

os.environ.setdefault("RAY_TPU_TORCH_LOG_LEVEL", "WARNING")

ATOL = 1e-5


# each stage actor on the CPU with one OpenMP thread: the models here are
# tiny, and a process per stage with a thread per core oversubscribes
# the host (about 20x slower steps)
CPU_STAGE = {"num_gpus": 0,
             "runtime_env": {"env_vars": {"OMP_NUM_THREADS": "1"}}}


def _cpu(S: int):
    return [CPU_STAGE] * S


def _trainer(cfg, S, **kw):
    kw.setdefault("optimizer", ("sgd", 0.05))
    V = kw.get("virtual_stages")
    tp = kw.get("tensor_parallel")
    return PipelineTrainer(
        presets.pipeline_stage_defs(cfg, S, seed=0, virtual_stages=V,
                                    tensor_parallel=tp),
        stage_options=_cpu(S), **kw)


def _jax_local_losses(cfg, jcfg, batch, num_microbatches, steps, lr=0.05):
    """JAX's single-process reference on the port's seed-0 weights:
    per-microbatch value_and_grad, grads averaged over the SAME
    microbatch split, optax SGD."""
    params = jax.tree.map(jnp.asarray, convert.to_jax(
        transformer.init_params(cfg, 0, "cpu", cfg.param_dtype),
        stacked=jcfg.scan_layers))
    opt = optax.sgd(lr)
    ost = opt.init(params)

    def mb_loss(p, toks):
        loss, _ = jtransformer.loss_fn(jcfg, p, {"tokens": toks})
        return loss

    gfn = jax.jit(jax.value_and_grad(mb_loss))
    mb = batch.shape[0] // num_microbatches
    out = []
    for _ in range(steps):
        acc, losses = None, []
        for m in range(num_microbatches):
            loss, g = gfn(params, batch[m * mb:(m + 1) * mb])
            losses.append(float(loss))
            acc = g if acc is None else jax.tree.map(
                lambda a, b: a + b, acc, g)
        grads = jax.tree.map(lambda g: g / num_microbatches, acc)
        upd, ost = opt.update(grads, ost, params)
        params = optax.apply_updates(params, upd)
        out.append(float(np.mean(losses)))
    return out


def _ref(num_layers, batch, M, steps, family="llama", **kw):
    return _jax_local_losses(_tiny_cfg(num_layers, family, **kw),
                             _jax_cfg(num_layers, family, **kw), batch, M,
                             steps)


def _store_pins(core):
    stats = core._run(core.clients.get(core.supervisor_addr).call(
        "store_stats"))
    return stats["pins_total"]


def _wait_pins(core, want, timeout=15):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline and _store_pins(core) != want:
        time.sleep(0.2)
    return _store_pins(core)


@pytest.fixture(scope="module")
def cluster():
    # one fake card id, so the card gate can be asked for (the CPU stages
    # take num_gpus=0)
    rt.init(num_cpus=16, num_gpus=1, object_store_memory=256 * 1024 * 1024)
    yield
    rt.shutdown()


class TestPipelineParity:
    def test_two_stage_matches_local_training(self, cluster):
        """S=2 1F1B pipeline vs JAX's fused single-process model: same
        weights, same microbatch split, same SGD, every step; training
        makes progress."""
        batch = _batch()
        ref = _ref(2, batch, 4, 3)
        trainer = _trainer(_tiny_cfg(), 2, num_microbatches=4)
        try:
            assert trainer.is_channel_backed
            assert trainer.channel_depth > 1
            got = [trainer.step(batch)["loss"] for _ in range(3)]
        finally:
            trainer.shutdown()
        assert np.allclose(got, ref, atol=ATOL), (got, ref)
        assert got[-1] < got[0], "no training progress on a fixed batch"

    def test_task_per_stage_baseline_matches(self, cluster):
        """mode='tasks': the same stage math through actor calls and the
        object store, on the gpt2 family (learned positions, gelu)."""
        batch = _batch()
        ref = _ref(2, batch, 2, 2, family="gpt2")
        trainer = _trainer(_tiny_cfg(2, "gpt2"), 2, num_microbatches=2,
                           mode="tasks")
        try:
            assert not trainer.is_channel_backed
            assert trainer.channel_depth == 0
            got = [trainer.step(batch)["loss"] for _ in range(2)]
        finally:
            trainer.shutdown()
        assert np.allclose(got, ref, atol=ATOL), (got, ref)

    @pytest.mark.slow
    def test_dp2_replicas_match_local(self, cluster):
        batch = _batch()
        ref = _ref(2, batch, 2, 2)
        trainer = _trainer(_tiny_cfg(), 2, num_microbatches=2, dp=2)
        try:
            both = np.concatenate([batch, batch])
            got = [trainer.step(both)["loss"] for _ in range(2)]
        finally:
            trainer.shutdown()
        assert np.allclose(got, ref, atol=ATOL), (got, ref)

    def test_a_stage_that_asks_for_a_card_and_sees_none_raises(self,
                                                               cluster):
        """The default (and ``num_gpus=1``) places a stage on a card; on a
        worker that sees none the stage raises, never carries on on the
        CPU: the stage runtime itself, and the trainer whose second stage
        takes the default options (its actor's init fails)."""
        from ray_tpu_torch.train._internal import pipeline as pl

        defs = presets.pipeline_stage_defs(_tiny_cfg(), 2)
        with pytest.raises(RuntimeError, match="asked for a card"):
            pl._StageRuntime([pl._as_stage_spec(defs[0])], 0, 2, 1, 2,
                             ("sgd", 0.05), 1, 0, "gate", device="cuda")
        with pytest.raises(ActorDiedError,
                           match="_PipelineStageActorImpl.__init__"):
            PipelineTrainer(defs, num_microbatches=2,
                            stage_options=[{"num_gpus": 0}, {}])


class TestPipelineContracts:
    @pytest.mark.perf
    def test_steady_flush_is_zero_control_rpcs_per_stage(self, cluster):
        from ray_tpu_torch._private.rpc import _m_client_calls

        batch = _batch()
        trainer = _trainer(_tiny_cfg(num_layers=3), 3, num_microbatches=4)
        try:
            trainer.step(batch)  # warm: pins taken
            driver_before = _m_client_calls.total()
            out = None
            for _ in range(3):
                out = trainer.step(batch)
                for rep in out["reports"]:
                    assert rep["rpc_calls"] == 0, rep
                    assert rep["device"] == "cpu"
            assert _m_client_calls.total() == driver_before
            for rep in out["reports"]:
                m = rep["metrics"]
                assert m["microbatches_total"] == 4 * 4  # 4 flushes x M
                assert m["flushes_total"] == 4
                assert m["stage_seconds_count"] >= 4
                assert 0.0 <= rep["bubble_fraction"] <= 1.0
        finally:
            trainer.shutdown()

    def test_teardown_releases_pins_and_channels(self, cluster):
        import gc

        from ray_tpu_torch._private import api

        core = api._core
        gc.collect()
        time.sleep(0.3)
        pins_before = _store_pins(core)
        trainer = _trainer(_tiny_cfg(), 2, num_microbatches=2)
        trainer.step(_batch())
        assert _store_pins(core) > pins_before  # channels are pinned
        trainer.shutdown()
        assert _wait_pins(core, pins_before) == pins_before, \
            "pipeline leaked pins"
        with pytest.raises(ChannelClosedError):
            trainer.step(_batch())

    def test_stage_death_surfaces_cleanly(self, cluster):
        trainer = _trainer(_tiny_cfg(), 2, num_microbatches=2)
        batch = _batch()
        trainer.step(batch)
        rt.kill(trainer._actors[0][1][0])
        with pytest.raises((ChannelClosedError, ActorDiedError)):
            deadline = time.monotonic() + 30
            while time.monotonic() < deadline:
                trainer.step(batch)
        trainer.shutdown()

    def test_stage_exception_propagates_instead_of_hanging(self, cluster):
        """Activations exceed the per-slot channel buffer, so stage 0's
        write raises mid-flush with its actor alive: the close still
        fans out and the driver's report read raises."""
        trainer = _trainer(_tiny_cfg(), 2, num_microbatches=2,
                           buffer_bytes=1024)
        t0 = time.monotonic()
        try:
            with pytest.raises(Exception, match="exceeds|closed|dead"):
                trainer.step(_batch())
            assert time.monotonic() - t0 < 60, "step hung on stage error"
        finally:
            trainer.shutdown()

    def test_batch_not_divisible_raises(self, cluster):
        trainer = _trainer(_tiny_cfg(), 2, num_microbatches=3)
        try:
            with pytest.raises(ValueError, match="divisible"):
                trainer.step(_batch(n=8))
            with pytest.raises(ValueError, match="extra keys"):
                trainer.step({"tokens": _batch(n=6), "mask": None})
        finally:
            trainer.shutdown()


class TestInterleavedVirtualStages:
    def test_v2_interleaved_matches_local_training(self, cluster):
        batch = _batch()
        ref = _ref(4, batch, 4, 3)
        trainer = _trainer(_tiny_cfg(num_layers=4), 2, num_microbatches=4,
                           virtual_stages=2)
        try:
            assert trainer.is_channel_backed
            assert trainer.channel_depth > 1
            assert trainer.virtual_stages == 2
            assert trainer.num_stages == 2
            got = []
            for _ in range(3):
                out = trainer.step(batch)
                got.append(out["loss"])
                for rep in out["reports"]:
                    assert rep["virtual_stages"] == 2
        finally:
            trainer.shutdown()
        assert np.allclose(got, ref, atol=ATOL), (got, ref)
        assert got[-1] < got[0], "no training progress on a fixed batch"

    def test_v1_bit_parity_with_default_schedule(self, cluster):
        batch = _batch()

        def run(**kw):
            t = _trainer(_tiny_cfg(), 2, num_microbatches=2, **kw)
            try:
                assert t.virtual_stages == 1
                return [t.step(batch)["loss"] for _ in range(2)]
            finally:
                t.shutdown()

        assert run(virtual_stages=1) == run()

    @pytest.mark.perf
    def test_zero_rpcs_and_metrics_under_interleaving(self, cluster):
        from ray_tpu_torch._private.rpc import _m_client_calls

        batch = _batch()
        trainer = _trainer(_tiny_cfg(num_layers=4), 2, num_microbatches=4,
                           virtual_stages=2)
        try:
            trainer.step(batch)
            driver_before = _m_client_calls.total()
            out = None
            for _ in range(2):
                out = trainer.step(batch)
                for rep in out["reports"]:
                    assert rep["rpc_calls"] == 0, rep
            assert _m_client_calls.total() == driver_before
            for rep in out["reports"]:
                m = rep["metrics"]
                assert m["microbatches_total"] == 3 * 4 * 2
                assert m["flushes_total"] == 3
                assert 0.0 <= rep["bubble_fraction"] <= 1.0
                assert rep["fused_bucket_applies"] == 0  # dp=1: no reduce
        finally:
            trainer.shutdown()

    def test_teardown_and_stage_death_at_v2(self, cluster):
        import gc

        from ray_tpu_torch._private import api

        core = api._core
        gc.collect()
        time.sleep(0.3)
        pins_before = _store_pins(core)
        batch = _batch()
        trainer = _trainer(_tiny_cfg(num_layers=4), 2, num_microbatches=2,
                           virtual_stages=2)
        trainer.step(batch)
        assert _store_pins(core) > pins_before
        trainer.shutdown()
        assert _wait_pins(core, pins_before) == pins_before, \
            "interleaved pipeline leaked pins"
        with pytest.raises(ChannelClosedError):
            trainer.step(batch)

        trainer = _trainer(_tiny_cfg(num_layers=4), 2, num_microbatches=2,
                           virtual_stages=2)
        trainer.step(batch)
        rt.kill(trainer._actors[0][1][0])
        with pytest.raises((ChannelClosedError, ActorDiedError)):
            deadline = time.monotonic() + 30
            while time.monotonic() < deadline:
                trainer.step(batch)
        trainer.shutdown()

    @pytest.mark.slow
    def test_dp2_v2_interleaved_matches_local(self, cluster):
        batch = _batch()
        ref = _ref(4, batch, 2, 2)
        trainer = _trainer(_tiny_cfg(num_layers=4), 2, num_microbatches=2,
                           dp=2, virtual_stages=2)
        try:
            both = np.concatenate([batch, batch])
            got = [trainer.step(both)["loss"] for _ in range(2)]
        finally:
            trainer.shutdown()
        assert np.allclose(got, ref, atol=ATOL), (got, ref)


class TestFusedFlush:
    def test_fused_reduce_apply_unit(self, cluster):
        """The fused in-bucket machinery in the driver process: a
        dp-flagged stage runtime over a WORLD-1 group (a mean over one
        rank is the identity) gives the plain SGD update, applied per
        bucket; the buckets cover every leaf once."""
        from ray_tpu_torch.train._internal import pipeline as pl
        from ray_tpu_torch.util import collective as col

        defs = presets.pipeline_stage_defs(_tiny_cfg(), 2, seed=0)
        col.init_collective_group(1, 0, backend="host",
                                  group_name="fused_unit")
        try:
            rtm = pl._StageRuntime(
                [pl._as_stage_spec(defs[0])], 0, 2, 1, 2, ("sgd", 0.05),
                dp=2, dp_rank=0, group_name="fused_unit", fused_flush=True,
                flush_bucket_bytes=2048)
            rtm._group_ready = True  # ride the world-1 group directly
            ck = rtm.chunks[0]
            params0 = [p.detach().clone() for p in ck.leaves]
            ck.acc = [torch.ones_like(p) for p in ck.leaves]
            stats = rtm.flush()
            assert stats["fused_bucket_applies"] > 1
            assert rtm._fused_applies == stats["fused_bucket_applies"]
            for p0, p in zip(params0, ck.leaves):
                want = p0 + torch.ones_like(p0) / rtm.M * -0.05
                torch.testing.assert_close(p.detach(), want, atol=1e-7,
                                           rtol=0)
        finally:
            col.destroy_collective_group("fused_unit")

    @pytest.mark.slow
    def test_fused_matches_unfused_dp2(self, cluster):
        batch = _batch()
        ref = _ref(2, batch, 2, 2)
        both = np.concatenate([batch, batch])

        def run(fused):
            t = _trainer(_tiny_cfg(), 2, num_microbatches=2, dp=2,
                         fused_flush=fused, flush_bucket_bytes=4096)
            losses, applies = [], []
            try:
                for _ in range(2):
                    out = t.step(both)
                    losses.append(out["loss"])
                    applies.extend(r["fused_bucket_applies"]
                                   for r in out["reports"])
            finally:
                t.shutdown()
            return losses, applies

        fused_losses, fused_applies = run(True)
        unfused_losses, unfused_applies = run(False)
        assert np.allclose(fused_losses, ref, atol=ATOL)
        assert np.allclose(unfused_losses, ref, atol=ATOL)
        assert all(a > 1 for a in fused_applies), fused_applies
        assert all(a == 0 for a in unfused_applies), unfused_applies


class TestTensorParallelTrainer:
    def test_tp2_pipeline_matches_jax_fused(self, cluster):
        """tp=2 x S=2 (four stage actors, swiglu, so chunk 0 tail-splits
        and overlaps its last reduce) against JAX's fused model: losses
        every step, the tp groups engaged, zero control-plane RPCs in
        the steady flushes."""
        cfg = presets.llama_debug(num_layers=2, vocab_size=128,
                                  max_seq_len=32, embed_dim=32, num_heads=4,
                                  num_kv_heads=2, mlp_dim=64)
        from ray_tpu.models import presets as jpresets

        jcfg = jpresets.llama_debug(num_layers=2, vocab_size=128,
                                    max_seq_len=32, embed_dim=32,
                                    num_heads=4, num_kv_heads=2, mlp_dim=64)
        batch = _batch()
        ref = _jax_local_losses(cfg, jcfg, batch, 4, 3)
        trainer = PipelineTrainer(
            presets.pipeline_stage_defs(cfg, 2, seed=0, tensor_parallel=2),
            num_microbatches=4, tensor_parallel=2, optimizer=("sgd", 0.05),
            stage_options=_cpu(2))
        try:
            assert trainer.tensor_parallel == 2
            outs = [trainer.step(batch) for _ in range(3)]
        finally:
            trainer.shutdown()
        got = [o["loss"] for o in outs]
        assert np.allclose(got, ref, atol=ATOL), (got, ref)
        for out in outs[1:]:
            assert len(out["reports"]) == 2 * 2
            for rep in out["reports"]:
                assert rep["tp"] == 2 and rep["tp_reduce_calls"] > 0, rep
                assert rep["rpc_calls"] == 0, rep

    def test_trainer_rejects_zero_env_zero_and_mismatch(self, cluster):
        from ray_tpu_torch._private import api

        cfg = presets.llama_debug(num_layers=2, vocab_size=128,
                                  max_seq_len=32, embed_dim=32, num_heads=4,
                                  num_kv_heads=2, mlp_dim=64)
        defs_tp1 = presets.pipeline_stage_defs(cfg, 2, seed=0)
        defs_tp2 = presets.pipeline_stage_defs(cfg, 2, seed=0,
                                               tensor_parallel=2)
        with pytest.raises(ValueError, match="tensor_parallel"):
            PipelineTrainer(defs_tp2, num_microbatches=2,
                            tensor_parallel=0)
        core = api._require_core()
        old = core.config.pipeline_tp
        core.config.pipeline_tp = 0
        try:
            with pytest.raises(ValueError,
                               match="RAY_TPU_TORCH_PIPELINE_TP"):
                PipelineTrainer(defs_tp2, num_microbatches=2)
        finally:
            core.config.pipeline_tp = old
        with pytest.raises(ValueError, match="pipeline_stage_defs"):
            PipelineTrainer(defs_tp1, num_microbatches=2,
                            tensor_parallel=2)
        with pytest.raises(ValueError, match="tasks"):
            PipelineTrainer(defs_tp2, num_microbatches=2,
                            tensor_parallel=2, mode="tasks")
        with pytest.raises(ValueError, match="elastic"):
            PipelineTrainer(defs_tp2, num_microbatches=2, dp=2,
                            tensor_parallel=2, elastic=True)

    @pytest.mark.slow
    def test_tp2_dp2_v2_matches_jax_fused(self, cluster):
        cfg = presets.llama_debug(num_layers=4, vocab_size=128,
                                  max_seq_len=32, embed_dim=32, num_heads=4,
                                  num_kv_heads=2, mlp_dim=64)
        from ray_tpu.models import presets as jpresets

        jcfg = jpresets.llama_debug(num_layers=4, vocab_size=128,
                                    max_seq_len=32, embed_dim=32,
                                    num_heads=4, num_kv_heads=2, mlp_dim=64)
        batch = _batch()
        ref = _jax_local_losses(cfg, jcfg, batch, 4, 3)
        trainer = PipelineTrainer(
            presets.pipeline_stage_defs(cfg, 2, seed=0, virtual_stages=2,
                                        tensor_parallel=2),
            num_microbatches=4, dp=2, virtual_stages=2, tensor_parallel=2,
            optimizer=("sgd", 0.05), buffer_bytes=1024 * 1024,
            stage_options=_cpu(2))
        try:
            outs = [trainer.step(np.concatenate([batch, batch]))
                    for _ in range(3)]
        finally:
            trainer.shutdown()
        got = [o["loss"] for o in outs]
        assert np.allclose(got, ref, atol=ATOL), (got, ref)
        for out in outs[1:]:
            assert len(out["reports"]) == 2 * 2 * 2
            for rep in out["reports"]:
                assert rep["rpc_calls"] == 0, rep


class TestVirtualStageValidation:
    def test_trainer_rejects_zero_and_mismatch(self, cluster):
        from ray_tpu_torch._private import api

        defs3 = presets.pipeline_stage_defs(_tiny_cfg(num_layers=3), 3,
                                            seed=0)
        with pytest.raises(ValueError, match="virtual_stages"):
            PipelineTrainer(defs3, num_microbatches=2, virtual_stages=0)
        with pytest.raises(ValueError, match="divide"):
            PipelineTrainer(defs3, num_microbatches=2, virtual_stages=2)
        with pytest.raises(ValueError, match="flush_bucket_bytes"):
            PipelineTrainer(defs3, num_microbatches=2,
                            flush_bucket_bytes=0)
        core = api._require_core()
        old = core.config.pipeline_virtual_stages
        core.config.pipeline_virtual_stages = 0
        try:
            with pytest.raises(
                    ValueError,
                    match="RAY_TPU_TORCH_PIPELINE_VIRTUAL_STAGES"):
                PipelineTrainer(defs3, num_microbatches=2)
        finally:
            core.config.pipeline_virtual_stages = old
