"""Decoder-only transformer family (GPT-2 and LLaMA variants) in PyTorch.

Counterpart: ``ray_tpu/models/transformer.py``. Parameters keep the JAX
package's layouts (``wq [d, h, hd]``, ``wo [h, hd, d]``, ``w_gate [d, f]``,
...), so weights converted from a JAX ``init_params`` load unchanged (see
``ray_tpu_torch/_private/convert.py``). Blocks are a list of per-layer
dicts.

Dtypes: the JAX package keeps float32 params and casts each matmul weight,
embedding and bias to ``cfg.dtype`` at every use. The port casts them once,
when the params are placed on their device, which gives the same numbers.
Norm scales and biases stay float32, as the norms read them in float32.

This slice serves: the layer math lives in ``models/decode.py``'s paged
forward. ``forward`` without caches comes with the training slice, and so
does ``mlp="moe"``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F

from ray_tpu_torch.ops.norms import layer_norm, rms_norm

_MOE_LATER = ("mlp='moe' is not ported yet: mixture-of-experts layers come "
              "with the port's training slice")


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    vocab_size: int = 32000
    num_layers: int = 12
    embed_dim: int = 768
    num_heads: int = 12
    num_kv_heads: Optional[int] = None        # None => MHA
    mlp_dim: Optional[int] = None             # None => 4x (gelu) / 8/3x (swiglu)
    moe_num_experts: int = 0
    moe_top_k: int = 2
    max_seq_len: int = 2048
    norm: str = "rmsnorm"                     # 'rmsnorm' | 'layernorm'
    pos: str = "rope"                         # 'rope' | 'learned'
    mlp: str = "swiglu"                       # 'swiglu' | 'gelu' | 'moe'
    rope_theta: float = 10000.0
    tie_embeddings: bool = True
    norm_eps: float = 1e-5
    dtype: torch.dtype = torch.bfloat16       # activation/compute dtype

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


def _norm_params(cfg: TransformerConfig, dim: int, device):
    p = {"scale": torch.ones(dim, device=device)}
    if cfg.norm != "rmsnorm":
        p["bias"] = torch.zeros(dim, device=device)
    return p


def init_params(cfg: TransformerConfig, seed: int = 0,
                device: torch.device | str = "cpu") -> Dict[str, Any]:
    """Random params with the JAX package's distributions (normal 0.02;
    0.02/sqrt(2L) for the output projections), drawn from a
    ``torch.Generator`` on ``device`` seeded with ``seed``, and placed as
    ``place_params`` does. Each tensor is drawn in float32 and cast at
    once, so a full-size model never holds a float32 copy."""
    if cfg.mlp == "moe":
        raise NotImplementedError(_MOE_LATER)
    device = torch.device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    d, h, kvh, hd, f = (cfg.embed_dim, cfg.num_heads, cfg.kv_heads,
                        cfg.head_dim, cfg.hidden_dim)
    out_std = 0.02 / math.sqrt(2 * cfg.num_layers)

    def normal(shape, std=0.02):
        t = torch.randn(shape, generator=gen, device=device,
                        dtype=torch.float32)
        return t.mul_(std).to(cfg.dtype)

    def zeros(shape):
        return torch.zeros(shape, device=device, dtype=cfg.dtype)

    params: Dict[str, Any] = {
        "embed": {"table": normal((cfg.vocab_size, d))},
        "final_norm": _norm_params(cfg, d, device),
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
             "ln1": _norm_params(cfg, d, device),
             "ln2": _norm_params(cfg, d, device)}
        if cfg.mlp == "swiglu":
            b["mlp"] = {"w_gate": normal((d, f)), "w_up": normal((d, f)),
                        "w_down": normal((f, d), out_std)}
        else:
            b["mlp"] = {"w_in": normal((d, f)), "b_in": zeros((f,)),
                        "w_out": normal((f, d), out_std),
                        "b_out": zeros((d,))}
        blocks.append(b)
    params["blocks"] = blocks
    return params


# ---------------------------------------------------------------------------
# layer pieces (the paged forward in models/decode.py strings them together)


def _norm(cfg: TransformerConfig, p, x):
    if cfg.norm == "rmsnorm":
        return rms_norm(x, p["scale"], cfg.norm_eps)
    return layer_norm(x, p["scale"], p["bias"], cfg.norm_eps)


def _mlp(cfg: TransformerConfig, p, x):
    """[..., d] -> [..., d] in ``cfg.dtype``."""
    if cfg.mlp == "moe":
        raise NotImplementedError(_MOE_LATER)
    if cfg.mlp == "swiglu":
        gate = x @ p["w_gate"]
        up = x @ p["w_up"]
        return (F.silu(gate) * up) @ p["w_down"]
    hid = F.gelu(x @ p["w_in"] + p["b_in"], approximate="tanh")
    return hid @ p["w_out"] + p["b_out"]


def _head(cfg: TransformerConfig, params, x):
    """Final norm + vocab projection: [..., d] -> [..., vocab]."""
    x = _norm(cfg, params["final_norm"], x)
    if cfg.tie_embeddings:
        return x @ params["embed"]["table"].T
    return x @ params["lm_head"]["kernel"]
