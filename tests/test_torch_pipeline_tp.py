"""Tensor parallelism in the port's pipeline math on the CPU: the twins of
``tests/test_pipeline_tp.py``'s partition, emulated-parity, reduce-ops,
schedule and validation classes, and the port against JAX.

  * Sharding is EXACT: ``partition_pipeline_params(...,
    tensor_parallel=2)`` and ``reassemble_pipeline_params`` are bit-exact
    inverses, every ``_stage_init_tp`` shard equals slicing the port's
    CPU ``init_params``, and JAX's tp partition of the converted tree is
    the port's through ``convert.shards_from_jax``, bit for bit (blocks
    per layer and scan-stacked).
  * The Megatron pair is the fused math: tp=2 stage math, the two ranks
    on threads with the barrier reducer (``emulate_tp``; the port has no
    ``psum_tp_ops``, see ``util/collective/tp.py``), gives the fused
    model's loss and the reassembled grads to 1e-5 (float32; the partial
    sums add in another order than one matmul), the replicated leaves'
    grads the same bits on both ranks; and JAX's fused loss and grads on
    the converted weights to atol 2e-5 / rtol 1e-4
    (``tests/test_torch_train.py``'s loss_fn tolerance). SwiGLU (the
    tail-split chunk) and gelu (no tail: gelu's replicated ``b_out``).
  * The threaded reduce ops match the closed form of a toy loss.
  * ``_simulate_tp_schedule``: per-chunk op counts, ascending
    microbatches, replay, depth-2 feasibility, and the same order as
    JAX's for every (S, V, M, depth, stage) tried.
  * Validation: an explicit 0 (argument or ``RAY_TPU_TORCH_PIPELINE_TP``)
    and infeasible widths raise naming the config field.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models import presets as jpresets
from ray_tpu.models import transformer as jtransformer
from ray_tpu.train._internal.pipeline import \
    _simulate_tp_schedule as jax_schedule
from ray_tpu_torch._private import config as cfgmod
from ray_tpu_torch._private import convert
from ray_tpu_torch.models import presets, transformer
from ray_tpu_torch.train._internal.pipeline import _simulate_tp_schedule
from ray_tpu_torch.util.collective.tp import emulate_tp
from tests.test_torch_pipeline_math import (LOSS_TOL, _assert_trees_close,
                                            _assert_trees_equal, _batch,
                                            _flat, _jax_params, _params)

TP = 2
TP_CFG = dict(vocab_size=128, max_seq_len=32, embed_dim=32, num_heads=4)


def _tp_cfg(num_layers=2, family="llama", jax_side=False, **kw):
    """llama_debug (swiglu) or a tiny GPT-2 (gelu) with head/kv/ffn counts
    divisible by tp=2."""
    p = jpresets if jax_side else presets
    if family == "gpt2":
        return p.gpt2_small(num_layers=num_layers, tie_embeddings=False,
                            dtype=jnp.float32 if jax_side else torch.float32,
                            **TP_CFG, **kw)
    return p.llama_debug(num_layers=num_layers, num_kv_heads=2, mlp_dim=64,
                         **TP_CFG, **kw)


class TestTpPartition:
    @pytest.mark.parametrize("family", ["llama", "gpt2"])
    def test_partition_reassemble_bit_exact(self, family):
        cfg = _tp_cfg(family=family)
        params = _params(cfg)
        shards = presets.partition_pipeline_params(cfg, params, 2,
                                                   tensor_parallel=TP)
        for chunk in shards:
            assert isinstance(chunk, list) and len(chunk) == TP
        back = presets.reassemble_pipeline_params(cfg, shards, 2,
                                                  tensor_parallel=TP)
        _assert_trees_equal(params, back)

    def test_tp1_partition_shape_unchanged(self):
        cfg = _tp_cfg()
        params = _params(cfg)
        shards = presets.partition_pipeline_params(cfg, params, 2)
        assert all(isinstance(s, dict) for s in shards)
        _assert_trees_equal(params, presets.reassemble_pipeline_params(
            cfg, shards, 2))

    def test_stage_init_tp_matches_partitioned_init(self):
        cfg = _tp_cfg()
        shards = presets.partition_pipeline_params(
            cfg, _params(cfg), 2, tensor_parallel=TP)
        for c in range(2):
            for t in range(TP):
                got = presets._stage_init_tp(cfg, 0, 2, c, TP, tp_rank=t)
                _assert_trees_equal(shards[c][t], got, ctx=(c, t))

    def test_stage_defs_carry_tp_and_tail(self):
        defs = presets.pipeline_stage_defs(_tp_cfg(), 2, seed=0,
                                           tensor_parallel=TP)
        assert all(d["tp"] == TP for d in defs)
        assert defs[0]["tp_tail"] is True
        assert defs[-1]["tp_tail"] is False
        gelu = presets.pipeline_stage_defs(_tp_cfg(family="gpt2"), 2,
                                           tensor_parallel=TP)
        assert gelu[0]["tp_tail"] is False

    @pytest.mark.parametrize("scan", [True, False])
    def test_jax_tp_partition_is_the_ports(self, scan):
        cfg = _tp_cfg()
        jcfg = _tp_cfg(jax_side=True, scan_layers=scan)
        params = _params(cfg, seed=4)
        mine = presets.partition_pipeline_params(cfg, params, 2,
                                                 tensor_parallel=TP)
        jshards = jpresets.partition_pipeline_params(
            jcfg, convert.to_jax(params, stacked=scan), 2,
            tensor_parallel=TP)
        got = convert.shards_from_jax(jax.tree.map(np.asarray, jshards))
        for c in range(2):
            for t in range(TP):
                _assert_trees_close(mine[c][t], got[c][t], ctx=(c, t),
                                    atol=0, rtol=0)
        spec = transformer.tp_block_shard_spec(cfg)
        assert spec == jtransformer.tp_block_shard_spec(jcfg)


def _tp_rank(cfg, defs, tokens, rank, ops):
    """One tp rank: its shards, the chunks in order (a tail chunk's
    ``u + g(mp)`` completed in line), the loss and the param grads."""
    shards = [transformer.map_params(
        lambda _p, t: t.requires_grad_(True), d["init"](tp_rank=rank))
        for d in defs]
    x = torch.from_numpy(tokens)
    for d, p in zip(defs[:-1], shards[:-1]):
        out = d["fwd"](p, x, tp_ops=ops)
        x = out[0] + ops.g(out[1]) if d["tp_tail"] else out
    loss = defs[-1]["loss"](shards[-1], x, torch.from_numpy(tokens),
                            tp_ops=ops)
    leaves = [transformer._leaves(s) for s in shards]
    grads = iter(torch.autograd.grad(loss, [t for ls in leaves
                                            for t in ls]))
    return loss.detach(), [transformer.map_params(
        lambda _p, _t: next(grads), s) for s in shards]


class TestTpEmulatedParity:
    @pytest.mark.parametrize("family", ["llama", "gpt2"])
    def test_tp2_stage_math_matches_fused(self, family):
        """Per-rank losses and the reassembled grads against the fused
        model (the port's to 1e-5, JAX's on converted weights to the
        loss_fn tolerance); replicated leaves' grads bit-equal across the
        ranks."""
        cfg = _tp_cfg(family=family)
        jcfg = _tp_cfg(family=family, jax_side=True)
        tokens = _batch(4, 16)
        params = _params(cfg)
        leaves = [t.requires_grad_(True) for t in transformer._leaves(params)]
        fused, _ = transformer.loss_fn(cfg, params,
                                       {"tokens": torch.from_numpy(tokens)})
        fgrads = iter(torch.autograd.grad(fused, leaves))
        fused = fused.detach()
        fused_grads = transformer.map_params(lambda _p, _t: next(fgrads),
                                             params)
        defs = presets.pipeline_stage_defs(cfg, 2, seed=0,
                                           tensor_parallel=TP)
        ranks = emulate_tp(TP, lambda r, ops: _tp_rank(cfg, defs, tokens,
                                                       r, ops))
        for r, (loss, _) in enumerate(ranks):
            np.testing.assert_allclose(float(loss), float(fused), atol=1e-5,
                                       err_msg=f"rank {r}")
        got = presets.reassemble_pipeline_params(
            cfg, [[ranks[t][1][c] for t in range(TP)] for c in range(2)], 2,
            tensor_parallel=TP)
        _assert_trees_close(fused_grads, got, atol=1e-5, rtol=0)
        spec = transformer.tp_block_shard_spec(cfg)
        for c in range(2):
            a, b = _flat(ranks[0][1][c]), _flat(ranks[1][1][c])
            for k in a:
                group, name = k.split(".")[-2:]
                if name not in spec.get(group, {}):
                    assert torch.equal(a[k], b[k]), (c, k)
        # against JAX's fused model on the same weights
        jp = _jax_params(params, jcfg)
        (jloss, _), jgrads = jax.value_and_grad(
            lambda p: jtransformer.loss_fn(jcfg, p, {"tokens": tokens}),
            has_aux=True)(jp)
        np.testing.assert_allclose(float(ranks[0][0]), float(jloss),
                                   **LOSS_TOL)
        _assert_trees_close(convert.from_jax(jax.tree.map(np.asarray,
                                                          jgrads)),
                            got, **LOSS_TOL)


class TestTpReduceOps:
    def test_threaded_ops_match_closed_form(self):
        """g partial-sums forward / passes backward, f passes forward /
        allreduces backward: against the closed-form grads of a toy loss
        on two threads. A desynced reduce sequence would break the
        barrier instead of passing."""
        def run(rank, ops):
            w = torch.tensor(rank + 1.0, requires_grad=True)
            x = torch.arange(4, dtype=torch.float32, requires_grad=True)
            y = ops.g(w * x)
            loss = (y * y).sum() + ops.f(x).sum()
            gw, gx = torch.autograd.grad(loss, (w, x))
            return float(loss), gw.numpy(), gx.numpy()

        x = np.arange(4, dtype=np.float32)
        ref_loss = float(np.sum(9 * x * x) + np.sum(x))
        for r, (loss, gw, gx) in enumerate(emulate_tp(TP, run)):
            assert np.allclose(loss, ref_loss), (r, loss, ref_loss)
            assert np.allclose(gw, 6 * np.sum(x * x)), (r, gw)
            assert np.allclose(gx, 6 * (r + 1) * x + TP), (r, gx)

    def test_bfloat16_reduces_in_float32_and_keeps_dtype(self):
        def run(rank, ops):
            a = torch.full((3,), 1.0 + rank / 256, dtype=torch.bfloat16)
            return ops.g(a)

        outs = emulate_tp(TP, run)
        want = (torch.full((3,), 1.0, dtype=torch.bfloat16).float()
                + torch.full((3,), 1 + 1 / 256,
                             dtype=torch.bfloat16).float()).bfloat16()
        for o in outs:
            assert o.dtype == torch.bfloat16 and torch.equal(o, want)

    def test_a_rank_error_surfaces(self):
        def run(rank, ops):
            if rank == 1:
                raise ValueError("rank 1 fails")
            return ops.g(torch.ones(2))

        with pytest.raises(ValueError, match="rank 1 fails"):
            emulate_tp(TP, run, timeout=20)


class TestTpSchedule:
    @pytest.mark.parametrize("shape", [(2, 1, 4), (2, 2, 8), (3, 2, 4),
                                       (4, 1, 16), (4, 3, 8)])
    def test_counts_and_order(self, shape):
        S, V, M = shape
        C = S * V
        for s in range(S):
            order = _simulate_tp_schedule(S, V, M, depth=4, stage=s)
            by = {}
            for kind, v, m in order:
                by.setdefault((kind, v), []).append(m)
            for i, c in enumerate(range(s, C, S)):
                assert by[("fwd", i)] == list(range(M)), (s, c)
                if c == C - 1:
                    assert ("bwd", i) not in by  # loss fwd is fused
                else:
                    assert by[("bwd", i)] == list(range(M)), (s, c)

    def test_pure_function_replay(self):
        a = _simulate_tp_schedule(3, 2, 8, depth=4, stage=1)
        assert a == _simulate_tp_schedule(3, 2, 8, depth=4, stage=1)

    def test_depth2_high_m_feasible(self):
        for s in range(4):
            assert len(_simulate_tp_schedule(4, 2, 16, depth=2, stage=s))

    @pytest.mark.parametrize("S,V,M,depth", [(2, 1, 4, 3), (2, 2, 8, 5),
                                             (3, 2, 4, 2), (4, 3, 8, 4),
                                             (4, 2, 16, 2)])
    def test_same_order_as_jax(self, S, V, M, depth):
        for s in range(S):
            assert _simulate_tp_schedule(S, V, M, depth, s) == \
                jax_schedule(S, V, M, depth, s)


class TestTpValidation:
    def test_stage_defs_reject_zero_and_env_zero(self):
        cfg = _tp_cfg()
        with pytest.raises(ValueError, match="tensor_parallel"):
            presets.pipeline_stage_defs(cfg, 2, tensor_parallel=0)
        old = cfgmod._global_config
        zero = cfgmod.Config()
        zero.pipeline_tp = 0
        cfgmod.set_global_config(zero)
        try:
            with pytest.raises(ValueError,
                               match="RAY_TPU_TORCH_PIPELINE_TP"):
                presets.pipeline_stage_defs(cfg, 2)
        finally:
            cfgmod.set_global_config(old)

    def test_indivisible_rejections_carry_counts(self):
        cfg = _tp_cfg()  # heads=4, kv=2, mlp=64
        with pytest.raises(ValueError, match=r"cfg\.num_heads=4"):
            presets.pipeline_stage_defs(cfg, 2, tensor_parallel=8)
        with pytest.raises(ValueError, match=r"cfg\.num_kv_heads=2"):
            presets.pipeline_stage_defs(cfg, 2, tensor_parallel=4)
        odd = presets.llama_debug(
            num_layers=2, vocab_size=128, max_seq_len=32, embed_dim=32,
            num_heads=4, num_kv_heads=4, mlp_dim=66)
        with pytest.raises(ValueError, match=r"cfg\.mlp_dim=66"):
            presets.pipeline_stage_defs(odd, 2, tensor_parallel=4)

    def test_tie_embeddings_and_moe_name_the_field(self):
        tied = _tp_cfg(tie_embeddings=True)
        with pytest.raises(ValueError, match="tie_embeddings"):
            presets.pipeline_stage_defs(tied, 2, tensor_parallel=2)
        with pytest.raises(ValueError, match="moe"):
            presets.pipeline_stage_defs(presets.moe_debug(), 2,
                                        tensor_parallel=2)
        with pytest.raises(ValueError, match="moe"):
            transformer.tp_block_shard_spec(presets.moe_debug())
