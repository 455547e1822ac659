"""Decoder-only transformer family (GPT-2 and LLaMA variants) in PyTorch.

Counterpart: ``ray_tpu/models/transformer.py``. Parameters keep the JAX
package's layouts (``wq [d, h, hd]``, ``wo [h, hd, d]``, ``w_gate [d, f]``,
...), so weights converted from a JAX ``init_params`` load unchanged (see
``ray_tpu_torch/_private/convert.py``). Blocks are a list of per-layer
dicts.

Dtypes: the JAX package keeps params in ``cfg.param_dtype`` (float32) and
casts each matmul weight, embedding and bias to ``cfg.dtype`` at every use.
``forward`` (training) does the same, so autograd returns float32 grads. The
serving programs read params that ``place_params`` cast once to ``cfg.dtype``,
which gives the same numbers; the casts in the shared layer pieces are then
no-ops. Norm scales and biases are read in float32 either way.

``forward`` runs without caches (training) or, with ``kv_caches``, over
contiguous per-layer KV caches (the contiguous serving programs); the paged
serving programs are in ``models/decode.py``. ``mlp="moe"`` runs the
mixture-of-experts layer of ``ops/moe.py``; its routing loss comes back as
``aux`` and ``loss_fn`` adds it.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from ray_tpu_torch._private.device import resolve_device
from ray_tpu_torch.ops.attention import attention
from ray_tpu_torch.ops.losses import (fused_softmax_cross_entropy,
                                      softmax_cross_entropy)
from ray_tpu_torch.ops.moe import init_moe_params, moe_layer
from ray_tpu_torch.ops.norms import layer_norm, rms_norm
from ray_tpu_torch.ops.rotary import apply_rotary, rope_frequencies


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    vocab_size: int = 32000
    num_layers: int = 12
    embed_dim: int = 768
    num_heads: int = 12
    num_kv_heads: Optional[int] = None        # None => MHA
    mlp_dim: Optional[int] = None             # None => 4x (gelu) / 8/3x (swiglu)
    # MoE (mlp='moe'): SwiGLU experts, top-k routing
    moe_num_experts: int = 0
    moe_top_k: int = 2
    moe_capacity_factor: float = 1.25
    moe_aux_weight: float = 0.01
    max_seq_len: int = 2048
    norm: str = "rmsnorm"                     # 'rmsnorm' | 'layernorm'
    pos: str = "rope"                         # 'rope' | 'learned'
    mlp: str = "swiglu"                       # 'swiglu' | 'gelu' | 'moe'
    rope_theta: float = 10000.0
    tie_embeddings: bool = True
    norm_eps: float = 1e-5
    dtype: torch.dtype = torch.bfloat16       # activation/compute dtype
    param_dtype: torch.dtype = torch.float32  # training params and grads
    remat: bool = True                        # checkpoint each block
    # 'full': recompute the whole block in backward; 'dots': keep the
    # matmul outputs, recompute the rest
    remat_policy: str = "full"
    attn_impl: str = "auto"                   # 'auto'|'flash'|'reference'
    # fold the vocab projection into the CE loss, chunked (ops/losses.py)
    fused_ce: bool = True
    ce_chunk: int = 2048

    @property
    def kv_heads(self) -> int:
        return self.num_kv_heads or self.num_heads

    @property
    def head_dim(self) -> int:
        return self.embed_dim // self.num_heads

    @property
    def hidden_dim(self) -> int:
        if self.mlp_dim:
            return self.mlp_dim
        if self.mlp in ("swiglu", "moe"):
            # LLaMA convention: 2/3 * 4d rounded to a multiple of 256
            h = int(8 * self.embed_dim / 3)
            return 256 * ((h + 255) // 256)
        return 4 * self.embed_dim


# ---------------------------------------------------------------------------
# params


def _is_norm_param(path: str) -> bool:
    return path.split(".")[-2] in ("ln1", "ln2", "final_norm")


def place_params(cfg: TransformerConfig, params: Dict[str, Any],
                 device: torch.device) -> Dict[str, Any]:
    """Params on ``device``: norm scales/biases in float32, every other
    tensor (matmul weights, embeddings, MLP biases) in ``cfg.dtype``."""
    def place(path: str, t: torch.Tensor) -> torch.Tensor:
        dtype = torch.float32 if _is_norm_param(path) else cfg.dtype
        return t.to(device=device, dtype=dtype)

    return map_params(place, params)


def map_params(fn, params, path: str = ""):
    """``fn(path, tensor)`` over a params tree of dicts and lists; ``path``
    is dotted (``blocks.0.attn.wq``)."""
    if isinstance(params, dict):
        return {k: map_params(fn, v, f"{path}.{k}" if path else k)
                for k, v in params.items()}
    if isinstance(params, list):
        return [map_params(fn, v, f"{path}.{i}")
                for i, v in enumerate(params)]
    return fn(path, params)


def _norm_params(cfg: TransformerConfig, dim: int, device, dtype):
    p = {"scale": torch.ones(dim, device=device, dtype=dtype)}
    if cfg.norm != "rmsnorm":
        p["bias"] = torch.zeros(dim, device=device, dtype=dtype)
    return p


def init_params(cfg: TransformerConfig, seed: int = 0,
                device: Optional[torch.device | str] = None,
                param_dtype: Optional[torch.dtype] = None
                ) -> Dict[str, Any]:
    """Random params with the JAX package's distributions (normal 0.02;
    0.02/sqrt(2L) for the output projections), drawn from a
    ``torch.Generator`` on ``device`` (the card unless ``"cpu"`` is asked
    for) seeded with ``seed``. Each tensor is drawn in float32 and cast at
    once. With ``param_dtype`` every leaf is in that dtype (training keeps
    ``cfg.param_dtype``); without it they are placed as ``place_params``
    does, so a full-size served model never holds a float32 copy."""
    if cfg.mlp == "moe" and cfg.moe_num_experts < 2:
        raise ValueError("mlp='moe' needs moe_num_experts >= 2")
    device = resolve_device(device)
    weight_dtype = param_dtype or cfg.dtype
    norm_dtype = param_dtype or torch.float32
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    d, h, kvh, hd, f = (cfg.embed_dim, cfg.num_heads, cfg.kv_heads,
                        cfg.head_dim, cfg.hidden_dim)
    out_std = 0.02 / math.sqrt(2 * cfg.num_layers)

    def normal(shape, std=0.02):
        t = torch.randn(shape, generator=gen, device=device,
                        dtype=torch.float32)
        return t.mul_(std).to(weight_dtype)

    def zeros(shape):
        return torch.zeros(shape, device=device, dtype=weight_dtype)

    params: Dict[str, Any] = {
        "embed": {"table": normal((cfg.vocab_size, d))},
        "final_norm": _norm_params(cfg, d, device, norm_dtype),
    }
    if cfg.pos == "learned":
        params["pos_embed"] = {"table": normal((cfg.max_seq_len, d))}
    if not cfg.tie_embeddings:
        params["lm_head"] = {"kernel": normal((d, cfg.vocab_size))}
    blocks = []
    for _ in range(cfg.num_layers):
        b = {"attn": {"wq": normal((d, h, hd)), "wk": normal((d, kvh, hd)),
                      "wv": normal((d, kvh, hd)),
                      "wo": normal((h, hd, d), out_std)},
             "ln1": _norm_params(cfg, d, device, norm_dtype),
             "ln2": _norm_params(cfg, d, device, norm_dtype)}
        if cfg.mlp == "moe":
            b["mlp"] = init_moe_params(gen, d, f, cfg.moe_num_experts,
                                       dtype=weight_dtype)
        elif cfg.mlp == "swiglu":
            b["mlp"] = {"w_gate": normal((d, f)), "w_up": normal((d, f)),
                        "w_down": normal((f, d), out_std)}
        else:
            b["mlp"] = {"w_in": normal((d, f)), "b_in": zeros((f,)),
                        "w_out": normal((f, d), out_std),
                        "b_out": zeros((d,))}
        blocks.append(b)
    params["blocks"] = blocks
    return params


def count_params(params) -> int:
    return sum(t.numel() for t in _leaves(params))


def _leaves(params):
    out = []
    map_params(lambda _p, t: out.append(t), params)
    return out


# ---------------------------------------------------------------------------
# layer pieces (forward and the paged programs in models/decode.py)


def _norm(cfg: TransformerConfig, p, x):
    if cfg.norm == "rmsnorm":
        return rms_norm(x, p["scale"], cfg.norm_eps)
    return layer_norm(x, p["scale"], p["bias"], cfg.norm_eps)


def _w(cfg: TransformerConfig, t: torch.Tensor) -> torch.Tensor:
    """A weight in the compute dtype (a no-op for placed params)."""
    return t.to(cfg.dtype)


def _mlp(cfg: TransformerConfig, p, x):
    """[B, S, d] -> (y [B, S, d] in ``cfg.dtype``, aux): aux is the MoE
    routing loss, 0.0 for the dense MLPs."""
    if cfg.mlp == "moe":
        return moe_layer(p, x, num_experts=cfg.moe_num_experts,
                         top_k=cfg.moe_top_k,
                         capacity_factor=cfg.moe_capacity_factor,
                         dtype=cfg.dtype)
    if cfg.mlp == "swiglu":
        gate = x @ _w(cfg, p["w_gate"])
        up = x @ _w(cfg, p["w_up"])
        return (F.silu(gate) * up) @ _w(cfg, p["w_down"]), 0.0
    hid = F.gelu(x @ _w(cfg, p["w_in"]) + _w(cfg, p["b_in"]),
                 approximate="tanh")
    return hid @ _w(cfg, p["w_out"]) + _w(cfg, p["b_out"]), 0.0


def _head(cfg: TransformerConfig, params, x):
    """Final norm + vocab projection: [..., d] -> [..., vocab]."""
    return _project(cfg, params, _norm(cfg, params["final_norm"], x))


def _project(cfg: TransformerConfig, params, x):
    if cfg.tie_embeddings:
        return x @ _w(cfg, params["embed"]["table"]).T
    return x @ _w(cfg, params["lm_head"]["kernel"])


# ---------------------------------------------------------------------------
# forward (training, or over contiguous KV caches)

Rope = Optional[Tuple[torch.Tensor, torch.Tensor]]


@functools.lru_cache(maxsize=8)
def _rope_tables(head_dim: int, max_len: int, theta: float,
                 device: torch.device):
    # built on the CPU, then moved, so the CPU and the card read one table
    return tuple(t.to(device) for t in rope_frequencies(head_dim, max_len,
                                                        theta))


def _attn(cfg: TransformerConfig, p, x, rope: Rope, positions,
          kv_cache=None):
    B, S, d = x.shape
    H, Hkv, hd = cfg.num_heads, cfg.kv_heads, cfg.head_dim
    q = (x @ _w(cfg, p["wq"]).reshape(d, H * hd)).view(B, S, H, hd)
    k = (x @ _w(cfg, p["wk"]).reshape(d, Hkv * hd)).view(B, S, Hkv, hd)
    v = (x @ _w(cfg, p["wv"]).reshape(d, Hkv * hd)).view(B, S, Hkv, hd)
    if rope is not None:
        cos, sin = rope
        q = apply_rotary(q, cos, sin, positions)
        k = apply_rotary(k, cos, sin, positions)
    if kv_cache is not None:
        # decode: write into the cache first, then attend over the whole
        # fixed buffer under the cache's mask
        bias = kv_cache.mask_bias(S)
        k_all, v_all = kv_cache.update(k, v)
        o = attention(q, k_all, v_all, causal=False, impl="reference",
                      bias=bias)
    else:
        o = attention(q, k, v, causal=True, impl=cfg.attn_impl)
    return o.reshape(B, S, H * hd) @ _w(cfg, p["wo"]).reshape(H * hd, d)


def _block(cfg: TransformerConfig, p, x, rope: Rope, positions,
           kv_cache=None):
    """One block: (x, aux), aux the MoE routing loss (0.0 otherwise)."""
    x = x + _attn(cfg, p["attn"], _norm(cfg, p["ln1"], x), rope, positions,
                  kv_cache)
    m, aux = _mlp(cfg, p["mlp"], _norm(cfg, p["ln2"], x))
    return x + m, aux


_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
         torch.ops.aten.addmm.default)


def _save_dots(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in _DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _block_fn(cfg: TransformerConfig):
    """The block under the config's remat policy. 'full' keeps only the
    block's inputs and runs the block again in backward (the flash forward
    kernel with it); 'dots' keeps the matmul outputs as well."""
    if not cfg.remat:
        return _block
    if cfg.remat_policy == "full":
        return functools.partial(checkpoint, _block, use_reentrant=False)
    if cfg.remat_policy == "dots":
        return functools.partial(
            checkpoint, _block, use_reentrant=False,
            context_fn=functools.partial(create_selective_checkpoint_contexts,
                                         _save_dots))
    raise ValueError(f"unknown remat_policy {cfg.remat_policy!r}; expected "
                     "one of ['dots', 'full']")


def forward(cfg: TransformerConfig, params, tokens: torch.Tensor, *,
            positions: Optional[torch.Tensor] = None, kv_caches=None,
            return_hidden: bool = False, return_aux: bool = False):
    """tokens [B, S] int -> logits [B, S, vocab] in ``cfg.dtype``.

    kv_caches: per-layer contiguous caches (``models/decode.py``
    ``LayerKVCache``); each layer writes its new k/v into its cache, in
    place, then attends over the cache's whole buffer (JAX returns the
    updated caches beside the logits). No remat on this path.
    return_hidden: skip the vocab projection and return (the hidden states
    after the final norm [B, S, d], aux) for the fused-CE loss. return_aux:
    return (logits, aux). aux is the MoE routing loss summed over the
    layers (0.0 without MoE)."""
    tokens = tokens.long()
    x = _w(cfg, params["embed"]["table"])[tokens]
    rope = None
    if cfg.pos == "learned":
        pos = (positions if positions is not None
               else torch.arange(tokens.shape[1], device=tokens.device))
        x = x + _w(cfg, params["pos_embed"]["table"])[pos]
    else:
        rope = _rope_tables(cfg.head_dim, cfg.max_seq_len, cfg.rope_theta,
                            x.device)
    aux_total = 0.0
    if kv_caches is not None:
        for p, c in zip(params["blocks"], kv_caches):
            x, aux = _block(cfg, p, x, rope, positions, c)
            aux_total = aux_total + aux
    else:
        block = _block_fn(cfg)
        for p in params["blocks"]:
            x, aux = block(cfg, p, x, rope, positions)
            aux_total = aux_total + aux
    x = _norm(cfg, params["final_norm"], x)
    if return_hidden:
        return x, aux_total
    logits = _project(cfg, params, x)
    return (logits, aux_total) if return_aux else logits


def loss_fn(cfg: TransformerConfig, params, batch, *,
            positions: Optional[torch.Tensor] = None):
    """Causal-LM loss. batch: {'tokens': [B, S], optional 'mask': [B, S]}.
    Targets are the tokens shifted left; the last position is dropped.
    With MoE the routing loss times ``moe_aux_weight`` is added. Returns
    (loss, {'loss' (the cross-entropy alone), 'tokens', and with MoE
    'moe_aux'})."""
    tokens = batch["tokens"]
    targets = tokens[:, 1:]
    mask = batch.get("mask")
    if mask is not None:
        mask = mask[:, 1:]
    if cfg.fused_ce:
        hidden, aux = forward(cfg, params, tokens, positions=positions,
                              return_hidden=True)
        if cfg.tie_embeddings:
            table, transpose = params["embed"]["table"], False
        else:
            table, transpose = params["lm_head"]["kernel"], True
        loss, n = fused_softmax_cross_entropy(
            hidden[:, :-1], table, targets, mask, chunk=cfg.ce_chunk,
            compute_dtype=cfg.dtype, transpose_table=transpose)
    else:
        logits, aux = forward(cfg, params, tokens, positions=positions,
                              return_aux=True)
        loss, n = softmax_cross_entropy(logits[:, :-1], targets, mask)
    metrics = {"loss": loss, "tokens": n}
    if cfg.mlp == "moe":
        loss = loss + cfg.moe_aux_weight * aux
        metrics["moe_aux"] = aux
    return loss, metrics
