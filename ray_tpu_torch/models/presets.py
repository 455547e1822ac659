"""Named model configs, and the pipeline stage partition and stage math of
``train.PipelineTrainer`` (counterpart: ``ray_tpu/models/presets.py``).
Sizes match the public architectures; compute is bf16 except in the debug
presets, which run in float32."""

from __future__ import annotations

import functools

import numpy as np
import torch

from ray_tpu_torch.models.transformer import TransformerConfig


def gpt2_small(**overrides) -> TransformerConfig:
    """GPT-2 124M: learned positions, LayerNorm, gelu MLP, tied embeddings."""
    kw = dict(
        vocab_size=50257, num_layers=12, embed_dim=768, num_heads=12,
        max_seq_len=1024, norm="layernorm", pos="learned", mlp="gelu",
        tie_embeddings=True, norm_eps=1e-5,
    )
    kw.update(overrides)
    return TransformerConfig(**kw)


def gpt2_medium(**overrides) -> TransformerConfig:
    kw = dict(
        vocab_size=50257, num_layers=24, embed_dim=1024, num_heads=16,
        max_seq_len=1024, norm="layernorm", pos="learned", mlp="gelu",
        tie_embeddings=True, norm_eps=1e-5,
    )
    kw.update(overrides)
    return TransformerConfig(**kw)


def gpt_1b(**overrides) -> TransformerConfig:
    """~0.9B-param LLaMA-style config (RMSNorm, RoPE, SwiGLU, tied
    embeddings)."""
    kw = dict(
        vocab_size=32000, num_layers=16, embed_dim=2048, num_heads=16,
        num_kv_heads=8, mlp_dim=5632, max_seq_len=2048, norm="rmsnorm",
        pos="rope", mlp="swiglu", rope_theta=10000.0, tie_embeddings=True,
        norm_eps=1e-5,
    )
    kw.update(overrides)
    return TransformerConfig(**kw)


def llama3_8b(**overrides) -> TransformerConfig:
    """Llama-3-8B: RoPE(theta=500k), RMSNorm, SwiGLU, GQA 32/8, vocab 128256."""
    kw = dict(
        vocab_size=128256, num_layers=32, embed_dim=4096, num_heads=32,
        num_kv_heads=8, mlp_dim=14336, max_seq_len=8192, norm="rmsnorm",
        pos="rope", mlp="swiglu", rope_theta=500000.0, tie_embeddings=False,
        norm_eps=1e-5,
    )
    kw.update(overrides)
    return TransformerConfig(**kw)


def llama_debug(**overrides) -> TransformerConfig:
    """Tiny LLaMA-shaped config for tests."""
    kw = dict(
        vocab_size=256, num_layers=2, embed_dim=64, num_heads=4,
        num_kv_heads=2, mlp_dim=128, max_seq_len=128, norm="rmsnorm",
        pos="rope", mlp="swiglu", tie_embeddings=False,
        dtype=torch.float32,
    )
    kw.update(overrides)
    return TransformerConfig(**kw)


def moe_debug(**overrides) -> TransformerConfig:
    """Tiny MoE config (SwiGLU experts, top-2 routing)."""
    kw = dict(
        vocab_size=256, num_layers=2, embed_dim=64, num_heads=4,
        num_kv_heads=2, mlp="moe", mlp_dim=128, moe_num_experts=4,
        moe_top_k=2, max_seq_len=128, norm="rmsnorm", pos="rope",
        tie_embeddings=False, dtype=torch.float32,
    )
    kw.update(overrides)
    return TransformerConfig(**kw)


# ---------------------------------------------------------------------------
# pipeline stage partition (the shards of train.PipelineTrainer)
#
# Counterpart: ``ray_tpu/models/presets.py:85-643``. Splits a transformer's
# blocks into S uniform stages: stage 0 owns the embedding (+ learned
# positions), the last stage owns the final norm + lm_head + loss, and the
# blocks spread as evenly as possible (the remainder lands on the EARLIEST
# stages). With ``virtual_stages=V`` > 1 the split is into S*V
# NON-CONTIGUOUS chunks for the interleaved 1F1B schedule: stage s owns
# chunks s, s+S, s+2S, ... A chunk shard is a dict: ``"blocks"`` (a list
# of per-layer dicts, as in the port's params), then ``"embed"`` /
# ``"pos_embed"`` on chunk 0 and ``"final_norm"`` / ``"lm_head"`` on the
# last. Every callable here is a module-level function under
# functools.partial, so stage specs pickle into the stage actors.


def pipeline_splits(num_layers: int, num_stages: int):
    """[(lo, hi)) block ranges for S uniform stages."""
    if num_stages < 2:
        raise ValueError("a pipeline needs >= 2 stages")
    if num_layers < num_stages:
        raise ValueError(
            f"cannot split {num_layers} blocks into {num_stages} stages")
    base, rem = divmod(num_layers, num_stages)
    splits, lo = [], 0
    for s in range(num_stages):
        hi = lo + base + (1 if s < rem else 0)
        splits.append((lo, hi))
        lo = hi
    return splits


def _check_pipeline_cfg(cfg) -> None:
    # name the offending CONFIG FIELD and the fix: these raise from deep
    # inside trainer/stage-def builds
    if cfg.tie_embeddings:
        raise ValueError(
            "pipeline_stage_defs: cfg.tie_embeddings=True is unsupported "
            "— the embedding table lives on stage 0 and the lm_head on "
            "the last stage, so a tied table's gradient would need "
            "summing across both ends every flush. Build the config with "
            "tie_embeddings=False (e.g. "
            "presets.gpt2_small(tie_embeddings=False))")
    if cfg.mlp == "moe":
        raise ValueError(
            "pipeline_stage_defs: cfg.mlp='moe' is unsupported — the "
            "router's load-balancing aux loss would need summing across "
            "stages every microbatch. Use a dense mlp ('gelu'/'swiglu'), "
            "or train MoE configs in one process")


def _resolve_virtual_stages(virtual_stages, num_stages: int,
                            num_layers: int) -> int:
    """Validate + default the interleaved-1F1B chunk multiplier.
    ``None`` takes the ``RAY_TPU_TORCH_PIPELINE_VIRTUAL_STAGES`` knob
    (default 1); an explicit 0 (argument or env) RAISES instead of
    silently meaning 1, and V beyond blocks-per-stage raises with the
    actionable count."""
    if virtual_stages is None:
        from ray_tpu_torch._private.config import global_config

        virtual_stages = global_config().pipeline_virtual_stages
        source = "RAY_TPU_TORCH_PIPELINE_VIRTUAL_STAGES"
    else:
        source = "virtual_stages"
    v = int(virtual_stages)
    if v < 1:
        raise ValueError(
            f"{source}={virtual_stages} is invalid: virtual_stages must "
            f"be >= 1 (1 = the plain one-chunk-per-stage 1F1B schedule; "
            f"0 does not mean 'default')")
    per_stage = num_layers // num_stages
    if per_stage < 1:
        raise ValueError(
            f"cannot split cfg.num_layers={num_layers} blocks into "
            f"num_stages={num_stages} stages: every stage needs at "
            f"least one block")
    if v > per_stage:
        raise ValueError(
            f"virtual_stages={v} exceeds blocks-per-stage: "
            f"cfg.num_layers={num_layers} over num_stages={num_stages} "
            f"gives {per_stage} block(s) per stage, and every virtual "
            f"chunk needs at least one block — use virtual_stages <= "
            f"{per_stage} (or a deeper config)")
    return v


def _check_tp_cfg(cfg, tp: int) -> None:
    """tensor_parallel feasibility: every rejection names the offending
    CONFIG FIELD and the actionable count."""
    if cfg.tie_embeddings:
        raise ValueError(
            "tensor_parallel>1: cfg.tie_embeddings=True is unsupported — "
            "the tied table would need a cross-stage AND cross-tp-rank "
            "gradient sum every flush. Build the config with "
            "tie_embeddings=False")
    if cfg.mlp == "moe":
        raise ValueError(
            "tensor_parallel>1: cfg.mlp='moe' is unsupported — experts "
            "shard over the expert axis, not tensor columns. Use a dense "
            "mlp (cfg.mlp='swiglu'/'gelu')")
    if cfg.num_heads % tp:
        raise ValueError(
            f"tensor_parallel={tp} does not divide cfg.num_heads="
            f"{cfg.num_heads}: attention shards whole query heads, so "
            f"each rank needs num_heads/tp = {cfg.num_heads}/{tp} to be "
            f"an integer — use a tp that divides {cfg.num_heads}")
    if cfg.kv_heads % tp:
        raise ValueError(
            f"tensor_parallel={tp} does not divide cfg.num_kv_heads="
            f"{cfg.kv_heads}: GQA shards whole kv heads alongside their "
            f"query groups, so each rank needs num_kv_heads/tp = "
            f"{cfg.kv_heads}/{tp} to be an integer — use a tp that "
            f"divides {cfg.kv_heads}")
    if cfg.hidden_dim % tp:
        raise ValueError(
            f"tensor_parallel={tp} does not divide the ffn width "
            f"cfg.mlp_dim={cfg.hidden_dim}: the ffn-up/ffn-down pair "
            f"shards whole columns, so each rank needs mlp_dim/tp = "
            f"{cfg.hidden_dim}/{tp} to be an integer — use a tp that "
            f"divides {cfg.hidden_dim}")


def _resolve_tensor_parallel(tensor_parallel, cfg) -> int:
    """Validate + default the tensor-parallel width. ``None`` takes the
    ``RAY_TPU_TORCH_PIPELINE_TP`` knob (default 1); an explicit 0
    (argument or env) RAISES instead of silently meaning 1, and an
    infeasible tp raises naming the config field."""
    if tensor_parallel is None:
        from ray_tpu_torch._private.config import global_config

        tensor_parallel = global_config().pipeline_tp
        source = "RAY_TPU_TORCH_PIPELINE_TP"
    else:
        source = "tensor_parallel"
    t = int(tensor_parallel)
    if t < 1:
        raise ValueError(
            f"{source}={tensor_parallel} is invalid: tensor_parallel "
            f"must be >= 1 (1 = unsharded stages; 0 does not mean "
            f"'default')")
    if t > 1:
        _check_tp_cfg(cfg, t)
    return t


def _chunk_shard(blocks, first_part=None, last_part=None):
    """A chunk shard in its key order: blocks, then the first chunk's
    embeddings, then the last chunk's final norm and lm_head."""
    shard = {"blocks": blocks}
    for part in (first_part, last_part):
        if part:
            shard.update(part)
    return shard


def partition_pipeline_params(cfg, params, num_stages: int,
                              virtual_stages: int = 1,
                              tensor_parallel: int = 1):
    """Slice a full ``init_params()`` tree into per-CHUNK shards, in
    pipeline order: ``num_stages * virtual_stages`` of them (the shards
    share the tree's tensors). With ``tensor_parallel=tp`` > 1 each entry
    is instead a LIST of tp per-rank shards: blocks Megatron column/row-
    cut (``transformer.shard_block_params``), embed / pos / final_norm /
    lm_head replicated. ``reassemble_pipeline_params`` is the bit-exact
    inverse."""
    from ray_tpu_torch.models.transformer import shard_block_params

    _check_pipeline_cfg(cfg)
    tp = int(tensor_parallel)
    if tp > 1:
        _check_tp_cfg(cfg, tp)
    chunks = num_stages * int(virtual_stages)
    shards = []
    for c, (lo, hi) in enumerate(pipeline_splits(cfg.num_layers, chunks)):
        first = last = None
        if c == 0:
            first = {"embed": params["embed"]}
            if cfg.pos == "learned":
                first["pos_embed"] = params["pos_embed"]
        if c == chunks - 1:
            last = {"final_norm": params["final_norm"],
                    "lm_head": params["lm_head"]}
        blocks = list(params["blocks"][lo:hi])
        if tp > 1:
            shards.append([_chunk_shard(
                [shard_block_params(cfg, b, tp, t) for b in blocks],
                first, last) for t in range(tp)])
        else:
            shards.append(_chunk_shard(blocks, first, last))
    return shards


def reassemble_pipeline_params(cfg, shards, num_stages: int,
                               virtual_stages: int = 1,
                               tensor_parallel: int = 1):
    """Bit-exact inverse of ``partition_pipeline_params``: glue per-chunk
    (and, with tp > 1, per-tp-rank) shards back into a full
    ``init_params()``-shaped tree, the parity oracle for comparing an
    assembled pipeline (e.g. ``PipelineTrainer.fetch_params``) with the
    fused single-process model."""
    from ray_tpu_torch.models.transformer import merge_tp_block_params

    chunks = num_stages * int(virtual_stages)
    tp = int(tensor_parallel)
    merged = []
    for c in range(chunks):
        sh = shards[c]
        if tp > 1:
            base = dict(sh[0])
            base["blocks"] = [
                merge_tp_block_params(cfg, [s["blocks"][i] for s in sh])
                for i in range(len(sh[0]["blocks"]))]
            sh = base
        merged.append(sh)
    params = {"embed": merged[0]["embed"],
              "final_norm": merged[-1]["final_norm"]}
    if cfg.pos == "learned":
        params["pos_embed"] = merged[0]["pos_embed"]
    params["lm_head"] = merged[-1]["lm_head"]
    params["blocks"] = [b for m in merged for b in m["blocks"]]
    return params


def _stage_init(cfg, seed: int, num_chunks: int, chunk: int):
    """Chunk shard init on the CPU, bit-identical to slicing
    ``init_params(cfg, seed, device="cpu", param_dtype=cfg.param_dtype)``
    WITHOUT holding the full model: the draws run in ``init_params``'s
    order on one CPU generator, and those of other chunks are drawn and
    let go at once. A CPU generator and a CUDA one give different
    numbers, so a stage on the card moves its shard there afterwards and
    a stage on the CPU and one on the card stay halves of one model.
    ``num_chunks`` counts the whole pipeline's chunks (num_stages *
    virtual_stages)."""
    from ray_tpu_torch.models.transformer import _draw_params

    _check_pipeline_cfg(cfg)
    lo, hi = pipeline_splits(cfg.num_layers, num_chunks)[chunk]
    g = _draw_params(cfg, seed, "cpu", cfg.param_dtype, range(lo, hi),
                     chunk == 0, chunk == num_chunks - 1)
    return _chunk_shard(
        g["blocks"],
        {k: g[k] for k in ("embed", "pos_embed") if k in g},
        {k: g[k] for k in ("final_norm", "lm_head") if k in g})


def _stage_init_tp(cfg, seed: int, num_chunks: int, chunk: int, tp: int,
                   tp_rank: int = 0):
    """tp rank's shard of one chunk: ``_stage_init``'s draws, each block
    Megatron-cut after init, bit-identical to slicing
    ``partition_pipeline_params(init_params(...), ...,
    tensor_parallel=tp)``. Replicated groups (embed, pos, final norm,
    lm_head) are built whole on every rank."""
    from ray_tpu_torch.models.transformer import shard_block_params

    _check_pipeline_cfg(cfg)
    _check_tp_cfg(cfg, tp)
    shard = _stage_init(cfg, seed, num_chunks, chunk)
    shard["blocks"] = [shard_block_params(cfg, b, tp, tp_rank)
                       for b in shard["blocks"]]
    return shard


def _rope(cfg, device):
    from ray_tpu_torch.models.transformer import _rope_tables

    if cfg.pos == "learned":
        return None
    return _rope_tables(cfg.head_dim, cfg.max_seq_len, cfg.rope_theta,
                        torch.device(device))


def _apply_blocks(cfg, blocks, h, n_local: int):
    """Run one stage's block slice with ``transformer.forward``'s block
    and remat policy, so a split pipeline matches the fused model."""
    from ray_tpu_torch.models.transformer import _block_fn

    block = _block_fn(cfg)
    rope = _rope(cfg, h.device)
    for i in range(n_local):
        h, _ = block(cfg, blocks[i], h, rope, None)
    return h


def _as_tokens(x, device) -> torch.Tensor:
    """Token ids (a tensor, or a numpy array that may be read-only) as an
    int64 tensor on ``device``."""
    if not isinstance(x, torch.Tensor):
        x = torch.from_numpy(np.array(x))
    return x.to(device=device, dtype=torch.long)


def _embed(cfg, params, x):
    from ray_tpu_torch.models.transformer import _w

    x = _as_tokens(x, params["embed"]["table"].device)
    h = _w(cfg, params["embed"]["table"])[x]
    if cfg.pos == "learned":
        h = h + _w(cfg, params["pos_embed"]["table"])[
            torch.arange(x.shape[1], device=h.device)]
    return h


def _stage_fwd(cfg, lo: int, hi: int, first: bool, params, x):
    """Non-last stage forward: tokens -> hidden (stage 0) or
    hidden -> hidden."""
    h = _embed(cfg, params, x) if first else x.to(cfg.dtype)
    return _apply_blocks(cfg, params["blocks"], h, hi - lo)


def _head_loss(cfg, params, h, tokens):
    """Final norm -> causal-LM loss, ``transformer.loss_fn``'s math."""
    from ray_tpu_torch.models.transformer import _norm, _w
    from ray_tpu_torch.ops.losses import (fused_softmax_cross_entropy,
                                          softmax_cross_entropy)

    h = _norm(cfg, params["final_norm"], h)
    targets = _as_tokens(tokens, h.device)[:, 1:]
    if cfg.fused_ce:
        loss, _ = fused_softmax_cross_entropy(
            h[:, :-1], params["lm_head"]["kernel"], targets, None,
            chunk=cfg.ce_chunk, compute_dtype=cfg.dtype,
            transpose_table=True)
    else:
        logits = h @ _w(cfg, params["lm_head"]["kernel"])
        loss, _ = softmax_cross_entropy(logits[:, :-1], targets, None)
    return loss


def _stage_loss(cfg, lo: int, hi: int, params, x, tokens):
    """Last stage: hidden -> blocks -> final norm -> causal-LM loss
    (the math of ``transformer.loss_fn`` on the fused model)."""
    h = _apply_blocks(cfg, params["blocks"], x.to(cfg.dtype), hi - lo)
    return _head_loss(cfg, params, h, tokens)


def _tp_apply_blocks(cfg, blocks, h, n_local: int, tp_ops,
                     split_tail: bool):
    """Run one stage's tp-sharded block slice, as ``_apply_blocks`` does,
    with the (g, f) reduce pair threaded through each block.
    ``split_tail``: the LAST block returns its (residual carry, mlp
    partial) pair instead of the reduced output, so the trainer can
    issue the final partial-sum reduce asynchronously."""
    from ray_tpu_torch.models.transformer import (_block_fn, _spmd_block,
                                                  _tp_block_tail)

    g, f = tp_ops
    rope = _rope(cfg, h.device)
    one_block = _block_fn(cfg, functools.partial(
        _spmd_block, g=g, f=f, attn_tp=True, mlp_tp=True))
    n_chain = n_local - 1 if split_tail else n_local
    for i in range(n_chain):
        h = one_block(cfg, blocks[i], h, rope, None)[0]
    if split_tail:
        return _block_fn(cfg, _tp_block_tail)(
            cfg, blocks[n_local - 1], h, rope, g, f)
    return h


def _stage_fwd_tp(cfg, lo: int, hi: int, first: bool, tail: bool, params,
                  x, *, tp_ops):
    """tp-sharded non-last-chunk forward. With ``tail`` the return value
    is the last block's (u, mlp_partial) pair: the chunk output is
    ``u + allreduce(mlp_partial)``, completed by the trainer."""
    h = _embed(cfg, params, x) if first else x.to(cfg.dtype)
    return _tp_apply_blocks(cfg, params["blocks"], h, hi - lo, tp_ops,
                            split_tail=tail)


def _stage_loss_tp(cfg, lo: int, hi: int, params, x, tokens, *, tp_ops):
    """tp-sharded last chunk: every reduced quantity is the full sum, so
    the loss (and its gradient) is the same on every tp rank. The final
    norm / lm_head are replicated; never tail-split."""
    h = _tp_apply_blocks(cfg, params["blocks"], x.to(cfg.dtype), hi - lo,
                         tp_ops, split_tail=False)
    return _head_loss(cfg, params, h, tokens)


def pipeline_stage_defs(cfg, num_stages: int, *, virtual_stages=None,
                        seed: int = 0, tensor_parallel=None):
    """Partition ``cfg`` into pipeline chunk specs for
    ``ray_tpu_torch.train.PipelineTrainer``: uniform block split, the
    embedding on the first chunk, final norm + lm_head + loss on the
    last. With ``virtual_stages=V`` (None = the
    ``RAY_TPU_TORCH_PIPELINE_VIRTUAL_STAGES`` knob, default 1) the list
    holds ``num_stages * V`` chunk specs in pipeline order; pass the SAME
    V to the trainer, which hands chunk c to stage actor
    ``c % num_stages``. Each spec is a dict of picklable callables
    ({"init", "fwd"} / {"init", "loss"}); init runs ON the stage actor
    and returns the chunk's CPU tensors, those of
    ``init_params(cfg, seed, device="cpu", param_dtype=cfg.param_dtype)``.

    With ``tensor_parallel=tp`` (None = the ``RAY_TPU_TORCH_PIPELINE_TP``
    knob, default 1) each chunk is Megatron column/row-sharded over tp
    ranks: init grows a ``tp_rank`` kwarg, fwd/loss grow a ``tp_ops``
    kwarg (the (g, f) pair of ``ray_tpu_torch.util.collective.tp``), and
    the spec carries ``tp``/``tp_tail``. Pass the SAME tp to
    ``PipelineTrainer(tensor_parallel=...)``."""
    import functools

    from ray_tpu_torch.models.transformer import tp_tail_supported

    _check_pipeline_cfg(cfg)
    v = _resolve_virtual_stages(virtual_stages, num_stages,
                                cfg.num_layers)
    t = _resolve_tensor_parallel(tensor_parallel, cfg)
    chunks = num_stages * v
    defs = []
    for c, (lo, hi) in enumerate(pipeline_splits(cfg.num_layers, chunks)):
        if t == 1:
            d = {"init": functools.partial(_stage_init, cfg, seed, chunks,
                                           c)}
            if c == chunks - 1:
                d["loss"] = functools.partial(_stage_loss, cfg, lo, hi)
            else:
                d["fwd"] = functools.partial(_stage_fwd, cfg, lo, hi,
                                             c == 0)
        else:
            d = {"init": functools.partial(_stage_init_tp, cfg, seed,
                                           chunks, c, t), "tp": t}
            if c == chunks - 1:
                d["loss"] = functools.partial(_stage_loss_tp, cfg, lo, hi)
                d["tp_tail"] = False
            else:
                tail = tp_tail_supported(cfg)
                d["fwd"] = functools.partial(_stage_fwd_tp, cfg, lo, hi,
                                             c == 0, tail)
                d["tp_tail"] = tail
        defs.append(d)
    return defs
