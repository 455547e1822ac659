"""The port's pipeline stage math on the CPU (``ray_tpu_torch.models.
presets``' pipeline part), against itself and against the JAX package.

  * The twins of ``tests/test_train_pipeline.py``'s ``TestStagePartition``
    and the CPU half of ``TestVirtualStageValidation``: uniform splits
    (and the same splits as JAX's), the rejections with their field-naming
    messages (an explicit 0 from the argument or the
    ``RAY_TPU_TORCH_PIPELINE_VIRTUAL_STAGES`` knob raises), and the
    chunks composed in pipeline order equal to the fused model's
    ``loss_fn`` BIT FOR BIT at V=1 and V=2 (the same blocks, the same
    order of operations), the shards covering the tree.
  * ``_stage_init`` equal to slicing the port's own
    ``init_params(cfg, seed, device="cpu", param_dtype=cfg.param_dtype)``,
    bit for bit, and ``partition_pipeline_params`` / ``reassemble`` as
    exact inverses.
  * The port against JAX with one set of weights (the port's, converted
    by ``_private/convert.py``): JAX's ``partition_pipeline_params`` gives
    the port's shards through ``convert.shards_from_jax`` bit for bit,
    and each stage function (``_stage_fwd`` of the first and of a middle
    chunk, ``_stage_loss``), value and grads for its params and its input,
    matches JAX's to ``tests/test_torch_train.py``'s loss_fn tolerance:
    atol 2e-5, rtol 1e-4, float32 (the matmuls' sums run in another order
    in XLA and in PyTorch). Two model families: llama_debug (RMSNorm,
    RoPE, SwiGLU, GQA) and a tiny GPT-2 (LayerNorm, learned positions,
    gelu), both untied.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models import presets as jpresets
from ray_tpu_torch._private import config as cfgmod
from ray_tpu_torch._private import convert
from ray_tpu_torch.models import presets, transformer

LOSS_TOL = dict(atol=2e-5, rtol=1e-4)

LLAMA = dict(vocab_size=128, max_seq_len=32, embed_dim=32, num_heads=2,
             num_kv_heads=1, mlp_dim=64)
GPT2 = dict(vocab_size=128, max_seq_len=32, embed_dim=32, num_heads=4,
            tie_embeddings=False)


def _tiny_cfg(num_layers=2, family="llama", **kw):
    """The twin of the JAX tests' ``_tiny_cfg`` in the port (``family``
    "gpt2" is the tiny GPT-2)."""
    if family == "gpt2":
        return presets.gpt2_small(num_layers=num_layers, dtype=torch.float32,
                                  **GPT2, **kw)
    return presets.llama_debug(num_layers=num_layers, **LLAMA, **kw)


def _jax_cfg(num_layers=2, family="llama", **kw):
    if family == "gpt2":
        return jpresets.gpt2_small(num_layers=num_layers, dtype=jnp.float32,
                                   **GPT2, **kw)
    return jpresets.llama_debug(num_layers=num_layers, **LLAMA, **kw)


def _batch(n=8, seq=16, seed=0, vocab=128):
    rng = np.random.default_rng(seed)
    return rng.integers(0, vocab, (n, seq)).astype(np.int32)


def _params(cfg, seed=0):
    return transformer.init_params(cfg, seed, "cpu", cfg.param_dtype)


def _flat(tree) -> dict:
    out = {}
    transformer.map_params(lambda p, t: out.__setitem__(p, t), tree)
    return out


def _assert_trees_equal(want, got, ctx=""):
    w, g = _flat(want), _flat(got)
    assert list(w) == list(g), (ctx, list(w), list(g))
    for k in w:
        assert w[k].dtype == g[k].dtype and torch.equal(w[k], g[k]), (ctx, k)


def _assert_trees_close(want, got, ctx="", **tol):
    w, g = _flat(want), _flat(got)
    assert sorted(w) == sorted(g), (ctx, sorted(w), sorted(g))
    for k in w:
        np.testing.assert_allclose(g[k].detach().numpy(),
                                   w[k].detach().numpy(), **tol,
                                   err_msg=f"{ctx} {k}")


def _jax_params(params, jcfg):
    return jax.tree.map(jnp.asarray,
                        convert.to_jax(params, stacked=jcfg.scan_layers))


def _requires_grad(tree):
    return transformer.map_params(
        lambda _p, t: t.detach().clone().requires_grad_(True), tree)


# ------------------------------------------------------------- partition


class TestStagePartition:
    def test_splits_are_uniform_and_cover(self):
        splits = presets.pipeline_splits(13, 4)
        assert splits[0][0] == 0 and splits[-1][1] == 13
        sizes = [hi - lo for lo, hi in splits]
        assert sum(sizes) == 13
        assert max(sizes) - min(sizes) <= 1
        for (_, a), (b, _) in zip(splits, splits[1:]):
            assert a == b
        with pytest.raises(ValueError, match="stages"):
            presets.pipeline_splits(3, 1)
        with pytest.raises(ValueError, match="split"):
            presets.pipeline_splits(2, 3)

    @pytest.mark.parametrize("layers,stages", [(13, 4), (12, 2), (4, 4),
                                               (7, 3), (32, 6)])
    def test_splits_equal_jax(self, layers, stages):
        assert presets.pipeline_splits(layers, stages) == \
            jpresets.pipeline_splits(layers, stages)

    def test_partition_rejects_tied_embeddings_and_moe(self):
        tied = presets.llama_debug(num_layers=2, tie_embeddings=True)
        with pytest.raises(ValueError, match="tie_embeddings"):
            presets.pipeline_stage_defs(tied, 2)
        moe = presets.moe_debug()
        with pytest.raises(ValueError, match="moe"):
            presets.pipeline_stage_defs(moe, 2)

    @pytest.mark.parametrize("family", ["llama", "gpt2"])
    @pytest.mark.parametrize("V", [1, 2])
    def test_chunk_composition_matches_fused_model(self, V, family):
        """Composing the S*V chunk fns in pipeline order gives the fused
        ``loss_fn`` bit for bit, the shards cover the full tree, and
        ``partition_pipeline_params`` slices the same chunk layout."""
        cfg = _tiny_cfg(num_layers=4, family=family)
        defs = presets.pipeline_stage_defs(cfg, 2, virtual_stages=V, seed=0)
        assert len(defs) == 2 * V
        shards = [d["init"]() for d in defs]
        tokens = torch.from_numpy(_batch(4, 16))
        x = tokens
        for d, p in zip(defs[:-1], shards[:-1]):
            x = d["fwd"](p, x)
        loss = defs[-1]["loss"](shards[-1], x, tokens)
        full = _params(cfg)
        ref, _ = transformer.loss_fn(cfg, full, {"tokens": tokens})
        assert loss.dtype == ref.dtype and torch.equal(loss, ref), (
            float(loss), float(ref))
        assert sum(transformer.count_params(s) for s in shards) == \
            transformer.count_params(full)
        sliced = presets.partition_pipeline_params(cfg, full, 2,
                                                   virtual_stages=V)
        assert len(sliced) == 2 * V
        for c, (init_shard, slice_shard) in enumerate(zip(shards, sliced)):
            _assert_trees_equal(slice_shard, init_shard, ctx=c)

    def test_stage_init_matches_slicing(self):
        """``_stage_init`` of every chunk equals the slice of the port's
        CPU ``init_params`` at S=3 (a middle chunk has no embedding and
        no head), and the reassembled tree is the full tree."""
        cfg = _tiny_cfg(num_layers=5, family="gpt2")
        full = _params(cfg, seed=7)
        shards = [presets._stage_init(cfg, 7, 3, c) for c in range(3)]
        assert set(shards[1]) == {"blocks"}
        assert list(shards[0]) == ["blocks", "embed", "pos_embed"]
        assert list(shards[2]) == ["blocks", "final_norm", "lm_head"]
        for c, s in enumerate(presets.partition_pipeline_params(cfg, full,
                                                                3)):
            _assert_trees_equal(s, shards[c], ctx=c)
        _assert_trees_equal(full, presets.reassemble_pipeline_params(
            cfg, shards, 3))


class TestValidation:
    def test_stage_defs_rejects_zero_and_env_zero(self):
        cfg = _tiny_cfg(num_layers=4)
        with pytest.raises(ValueError, match="virtual_stages"):
            presets.pipeline_stage_defs(cfg, 2, virtual_stages=0)
        old = cfgmod._global_config
        zero = cfgmod.Config()
        zero.pipeline_virtual_stages = 0
        cfgmod.set_global_config(zero)
        try:
            with pytest.raises(
                    ValueError,
                    match="RAY_TPU_TORCH_PIPELINE_VIRTUAL_STAGES"):
                presets.pipeline_stage_defs(cfg, 2)
        finally:
            cfgmod.set_global_config(old)

    def test_env_knobs_reach_the_config(self, monkeypatch):
        monkeypatch.setenv("RAY_TPU_TORCH_PIPELINE_VIRTUAL_STAGES", "2")
        monkeypatch.setenv("RAY_TPU_TORCH_PIPELINE_TP", "4")
        monkeypatch.setenv("RAY_TPU_TORCH_CHANNEL_DEPTH", "3")
        cfg = cfgmod.Config.from_env()
        assert (cfg.pipeline_virtual_stages, cfg.pipeline_tp,
                cfg.channel_depth) == (2, 4, 3)
        assert cfgmod.Config().channel_buffer_bytes == 4 * 1024 ** 2

    def test_v_exceeds_blocks_per_stage_actionable(self):
        cfg = _tiny_cfg(num_layers=2)
        with pytest.raises(ValueError) as ei:
            presets.pipeline_stage_defs(cfg, 2, virtual_stages=2)
        msg = str(ei.value)
        assert "blocks-per-stage" in msg
        assert "num_layers=2" in msg
        assert "virtual_stages <= 1" in msg

    def test_partition_errors_name_config_fields(self):
        tied = presets.llama_debug(num_layers=2, tie_embeddings=True)
        with pytest.raises(ValueError) as ei:
            presets.pipeline_stage_defs(tied, 2)
        assert "cfg.tie_embeddings=True" in str(ei.value)
        assert "tie_embeddings=False" in str(ei.value)
        moe = presets.moe_debug()
        with pytest.raises(ValueError) as ei:
            presets.pipeline_stage_defs(moe, 2)
        assert "cfg.mlp='moe'" in str(ei.value)
        assert "gelu" in str(ei.value)


# ------------------------------------------------------------ against JAX


@pytest.mark.parametrize("family", ["llama", "gpt2"])
@pytest.mark.parametrize("V", [1, 2])
def test_jax_partition_is_the_ports_through_convert(V, family):
    """JAX's ``partition_pipeline_params`` of the converted tree (scan-
    stacked and per-layer) comes back through ``shards_from_jax`` as the
    port's shards, bit for bit, and ``shards_to_jax`` inverts it."""
    cfg = _tiny_cfg(4, family)
    full = _params(cfg, seed=3)
    mine = presets.partition_pipeline_params(cfg, full, 2, virtual_stages=V)
    for scan in (True, False):
        jcfg = _jax_cfg(4, family, scan_layers=scan)
        jshards = jpresets.partition_pipeline_params(
            jcfg, convert.to_jax(full, stacked=scan), 2, virtual_stages=V)
        got = convert.shards_from_jax(jax.tree.map(np.asarray, jshards))
        for c, (a, b) in enumerate(zip(mine, got)):
            _assert_trees_close(a, b, ctx=(scan, c), atol=0, rtol=0)
        back = convert.shards_to_jax(mine, stacked=scan)
        for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(
                jax.tree.map(np.asarray, jshards))):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("family", ["llama", "gpt2"])
def test_stage_functions_match_jax(family):
    """Each stage function of an S=3 split (chunk 0's embedding + blocks,
    the middle chunk's blocks, the last chunk's blocks + head + loss) on
    converted weights: values and the vjp for params and input against
    JAX's."""
    cfg, jcfg = _tiny_cfg(6, family), _jax_cfg(6, family)
    full = _params(cfg, seed=5)
    shards = presets.partition_pipeline_params(cfg, full, 3)
    jshards = jpresets.partition_pipeline_params(
        jcfg, _jax_params(full, jcfg), 3)
    tokens = _batch(2, 16, seed=1)
    splits = presets.pipeline_splits(cfg.num_layers, 3)
    rng = np.random.default_rng(2)
    x_t = torch.from_numpy(tokens)
    x_j = x_j_tok = jnp.asarray(tokens)
    for c, (lo, hi) in enumerate(splits):
        p_t = _requires_grad(shards[c])
        first, last = c == 0, c == 2
        xin_t = x_t if first else x_t.detach().clone().requires_grad_(True)
        if last:
            out_t = presets._stage_loss(cfg, lo, hi, p_t, xin_t,
                                        torch.from_numpy(tokens))

            def jfn(p, x, lo=lo, hi=hi):
                return jpresets._stage_loss(jcfg, lo, hi, p, x, x_j_tok)
        else:
            out_t = presets._stage_fwd(cfg, lo, hi, first, p_t, xin_t)

            def jfn(p, x, lo=lo, hi=hi, first=first):
                return jpresets._stage_fwd(jcfg, lo, hi, first, p, x)
        out_j, vjp = jax.vjp(jfn, jshards[c], x_j)
        np.testing.assert_allclose(out_t.detach().numpy(),
                                   np.asarray(out_j), **LOSS_TOL,
                                   err_msg=f"chunk {c} value")
        cot = rng.standard_normal(out_t.shape).astype(np.float32)
        gp_j, gx_j = vjp(jnp.asarray(cot))
        inputs = transformer._leaves(p_t) + ([] if first else [xin_t])
        grads = torch.autograd.grad(out_t, inputs, torch.from_numpy(cot))
        n = len(transformer._leaves(p_t))
        got = transformer.map_params(
            lambda _p, t, it=iter(grads[:n]): next(it), p_t)
        _assert_trees_close(convert.from_jax(jax.tree.map(np.asarray,
                                                          gp_j)),
                            got, ctx=f"chunk {c} param grads", **LOSS_TOL)
        if not first:
            np.testing.assert_allclose(grads[-1].numpy(), np.asarray(gx_j),
                                       **LOSS_TOL,
                                       err_msg=f"chunk {c} input grad")
        x_t = out_t.detach()
        x_j = out_j
