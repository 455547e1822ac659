"""Named model configs (counterpart: ``ray_tpu/models/presets.py``, the
configs only). Sizes match the public architectures; compute is bf16 except
in the debug presets, which run in float32."""

from __future__ import annotations

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
    """Tiny MoE config (SwiGLU experts, top-2 routing). Its MoE layer comes
    with the training slice: building its params raises until then."""
    kw = dict(
        vocab_size=256, num_layers=2, embed_dim=64, num_heads=4,
        num_kv_heads=2, mlp="moe", mlp_dim=128, moe_num_experts=4,
        moe_top_k=2, max_seq_len=128, norm="rmsnorm", pos="rope",
        tie_embeddings=False, dtype=torch.float32,
    )
    kw.update(overrides)
    return TransformerConfig(**kw)
