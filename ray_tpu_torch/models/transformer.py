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

``logical_axes`` names each param's axes for the sharding rules of
``parallel/sharding.py``; the mesh train step (``models/training.py``)
runs ``forward`` on each rank's local shards with ``_spmd_block``, the
tensor-parallel block over the mesh's ``tp`` axis. With ``attn_impl="ring"``
and an ``sp_axis``, attention is ring attention over that mesh axis and
``positions`` are the shard's global positions; without ``sp_axis``,
``"ring"`` means ``"auto"``.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from ray_tpu_torch._private.device import resolve_device
from ray_tpu_torch.ops.attention import attention
from ray_tpu_torch.ops.losses import (fused_softmax_cross_entropy,
                                      softmax_cross_entropy)
from ray_tpu_torch.ops.moe import init_moe_params, moe_layer, moe_logical_axes
from ray_tpu_torch.ops.norms import layer_norm, rms_norm
from ray_tpu_torch.ops.ring_attention import ring_attention_local
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
    attn_impl: str = "auto"                   # 'auto'|'flash'|'reference'|'ring'
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
    tensor (matmul weights, embeddings, MLP biases) in ``cfg.dtype``. On
    the CPU every tensor is a copy: the given tree may alias memory the
    caller does not own (a shared-weights arena view), and the placed
    params must neither write into it nor keep it alive."""
    copy = torch.device(device).type == "cpu"

    def place(path: str, t: torch.Tensor) -> torch.Tensor:
        dtype = torch.float32 if _is_norm_param(path) else cfg.dtype
        return t.to(device=device, dtype=dtype, copy=copy)

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
                param_dtype: Optional[torch.dtype] = None,
                place: Optional[Callable] = None) -> Dict[str, Any]:
    """Random params with the JAX package's distributions (normal 0.02;
    0.02/sqrt(2L) for the output projections), drawn from a
    ``torch.Generator`` on ``device`` (the card unless ``"cpu"`` is asked
    for) seeded with ``seed``. Each tensor is drawn in float32 and cast at
    once. With ``param_dtype`` every leaf is in that dtype (training keeps
    ``cfg.param_dtype``); without it they are placed as ``place_params``
    does, so a full-size served model never holds a float32 copy.
    ``place(path, tensor)``, if given, places each leaf as it is drawn,
    before the next one is (``training.init_train_state`` keeps each
    rank's shard of it), so the whole tree is never held."""
    groups = _draw_params(cfg, seed, device, param_dtype,
                          range(cfg.num_layers), True, True, place)
    params: Dict[str, Any] = {"embed": groups["embed"],
                              "final_norm": groups["final_norm"]}
    for key in ("pos_embed", "lm_head"):
        if key in groups:
            params[key] = groups[key]
    params["blocks"] = groups["blocks"]
    return params


def _draw_params(cfg: TransformerConfig, seed: int, device, param_dtype,
                 layers: range, first: bool, last: bool,
                 place: Optional[Callable] = None) -> Dict[str, Any]:
    """``init_params``'s draws in its order (embed, pos_embed, lm_head,
    then block by block), keeping only the blocks in ``layers`` and, with
    ``first``, the embeddings, with ``last`` the final norm and the
    lm_head. A dropped tensor is drawn all the same and let go at once,
    so the kept ones are bit for bit those of ``init_params`` and the
    whole model is never held (a pipeline stage's chunk init)."""
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
    place = place or (lambda _path, t: t)

    def normal(path, shape, std=0.02, keep=True):
        t = torch.randn(shape, generator=gen, device=device,
                        dtype=torch.float32)
        return place(path, t.mul_(std).to(weight_dtype)) if keep else None

    def zeros(path, shape):
        return place(path, torch.zeros(shape, device=device,
                                       dtype=weight_dtype))

    def norm(path):
        return {k: place(f"{path}.{k}", t) for k, t in
                _norm_params(cfg, d, device, norm_dtype).items()}

    out: Dict[str, Any] = {}
    table = normal("embed.table", (cfg.vocab_size, d), keep=first)
    if first:
        out["embed"] = {"table": table}
    if cfg.pos == "learned":
        table = normal("pos_embed.table", (cfg.max_seq_len, d), keep=first)
        if first:
            out["pos_embed"] = {"table": table}
    if not cfg.tie_embeddings:
        kernel = normal("lm_head.kernel", (d, cfg.vocab_size), keep=last)
        if last:
            out["lm_head"] = {"kernel": kernel}
    if last:
        out["final_norm"] = norm("final_norm")
    blocks = []
    for i in range(min(cfg.num_layers, layers.stop)):
        keep = i in layers
        at = f"blocks.{len(blocks)}"
        attn = {"wq": normal(f"{at}.attn.wq", (d, h, hd), keep=keep),
                "wk": normal(f"{at}.attn.wk", (d, kvh, hd), keep=keep),
                "wv": normal(f"{at}.attn.wv", (d, kvh, hd), keep=keep),
                "wo": normal(f"{at}.attn.wo", (h, hd, d), out_std,
                             keep=keep)}
        if cfg.mlp == "moe":
            mlp = init_moe_params(
                gen, d, f, cfg.moe_num_experts, dtype=weight_dtype,
                place=lambda name, t: place(f"{at}.mlp.{name}", t)
                if keep else t)
        elif cfg.mlp == "swiglu":
            mlp = {"w_gate": normal(f"{at}.mlp.w_gate", (d, f), keep=keep),
                   "w_up": normal(f"{at}.mlp.w_up", (d, f), keep=keep),
                   "w_down": normal(f"{at}.mlp.w_down", (f, d), out_std,
                                    keep=keep)}
        elif keep:
            mlp = {"w_in": normal(f"{at}.mlp.w_in", (d, f)),
                   "b_in": zeros(f"{at}.mlp.b_in", (f,)),
                   "w_out": normal(f"{at}.mlp.w_out", (f, d), out_std),
                   "b_out": zeros(f"{at}.mlp.b_out", (d,))}
        else:  # the dropped layer's draws, in order
            normal(None, (d, f), keep=False)
            normal(None, (f, d), out_std, keep=False)
        if keep:
            blocks.append({"attn": attn, "ln1": norm(f"{at}.ln1"),
                           "ln2": norm(f"{at}.ln2"), "mlp": mlp})
    out["blocks"] = blocks
    return out


def logical_axes(cfg: TransformerConfig) -> Dict[str, Any]:
    """Tree (the params' structure) of logical-axis tuples. The JAX
    package's entries less their leading ``"layers"``: the port's blocks
    are a list of per-layer dicts, not stacked leaves."""
    def norm_axes():
        if cfg.norm == "rmsnorm":
            return {"scale": ("embed_notp",)}
        return {"scale": ("embed_notp",), "bias": ("embed_notp",)}

    def block():
        b = {
            "attn": {
                "wq": ("embed", "heads", "head_dim"),
                "wk": ("embed", "kv", "head_dim"),
                "wv": ("embed", "kv", "head_dim"),
                "wo": ("heads", "head_dim", "embed"),
            },
            "ln1": norm_axes(),
            "ln2": norm_axes(),
        }
        if cfg.mlp == "moe":
            b["mlp"] = moe_logical_axes()
        elif cfg.mlp == "swiglu":
            b["mlp"] = {"w_gate": ("embed", "mlp"),
                        "w_up": ("embed", "mlp"),
                        "w_down": ("mlp", "embed")}
        else:
            b["mlp"] = {"w_in": ("embed", "mlp"),
                        "b_in": ("mlp",),
                        "w_out": ("mlp", "embed"),
                        "b_out": ("embed_notp",)}
        return b

    axes: Dict[str, Any] = {
        "embed": {"table": ("vocab", "embed")},
        "final_norm": norm_axes(),
        "blocks": [block() for _ in range(cfg.num_layers)],
    }
    if cfg.pos == "learned":
        axes["pos_embed"] = {"table": (None, "embed")}
    if not cfg.tie_embeddings:
        axes["lm_head"] = {"kernel": ("embed", "vocab")}
    return axes


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


def _mlp(cfg: TransformerConfig, p, x, mesh=None):
    """[B, S, d] -> (y [B, S, d] in ``cfg.dtype``, aux): aux is the MoE
    routing loss, 0.0 for the dense MLPs. ``mesh``: the mesh whose axes
    split the MoE layer's tokens and experts (``moe_layer``'s
    ``ep_mesh``)."""
    if cfg.mlp == "moe":
        return moe_layer(p, x, num_experts=cfg.moe_num_experts,
                         top_k=cfg.moe_top_k,
                         capacity_factor=cfg.moe_capacity_factor,
                         dtype=cfg.dtype, ep_mesh=mesh)
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
          kv_cache=None, sp_axis=None, mesh=None):
    """The head counts are the weights' own: a tensor-parallel rank's
    shard holds its local heads (``_tp_attn_partial``). With
    ``attn_impl="ring"`` and ``sp_axis``, x is this rank's sequence shard
    and attention runs over the ring of that axis of ``mesh``."""
    B, S, d = x.shape
    H, Hkv, hd = p["wq"].shape[1], p["wk"].shape[1], cfg.head_dim
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
    elif cfg.attn_impl == "ring" and sp_axis is not None:
        o = ring_attention_local(q, k, v, sp_axis, mesh=mesh, causal=True)
    else:
        o = attention(q, k, v, causal=True, impl=cfg.attn_impl
                      if cfg.attn_impl != "ring" else "auto")
    return o.reshape(B, S, H * hd) @ _w(cfg, p["wo"]).reshape(H * hd, d)


def _block(cfg: TransformerConfig, p, x, rope: Rope, positions,
           kv_cache=None, sp_axis=None, mesh=None):
    """One block: (x, aux), aux the MoE routing loss (0.0 otherwise)."""
    x = x + _attn(cfg, p["attn"], _norm(cfg, p["ln1"], x), rope, positions,
                  kv_cache, sp_axis, mesh)
    m, aux = _mlp(cfg, p["mlp"], _norm(cfg, p["ln2"], x), mesh)
    return x + m, aux


_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
         torch.ops.aten.addmm.default)


def _save_dots(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in _DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _block_fn(cfg: TransformerConfig, block=None):
    """The block (``_block`` unless another is given, e.g. a
    tensor-parallel one) under the config's remat policy. 'full' keeps
    only the block's inputs and runs the block again in backward (the
    flash forward kernel with it); 'dots' keeps the matmul outputs as
    well."""
    block = block or _block
    if not cfg.remat:
        return block
    if cfg.remat_policy == "full":
        return functools.partial(checkpoint, block, use_reentrant=False)
    if cfg.remat_policy == "dots":
        return functools.partial(
            checkpoint, block, use_reentrant=False,
            context_fn=functools.partial(create_selective_checkpoint_contexts,
                                         _save_dots))
    raise ValueError(f"unknown remat_policy {cfg.remat_policy!r}; expected "
                     "one of ['dots', 'full']")


def forward(cfg: TransformerConfig, params, tokens: torch.Tensor, *,
            positions: Optional[torch.Tensor] = None, kv_caches=None,
            return_hidden: bool = False, return_aux: bool = False,
            sp_axis: Optional[str] = None, mesh=None, block=None):
    """tokens [B, S] int -> logits [B, S, vocab] in ``cfg.dtype``.

    kv_caches: per-layer contiguous caches (``models/decode.py``
    ``LayerKVCache``); each layer writes its new k/v into its cache, in
    place, then attends over the cache's whole buffer (JAX returns the
    updated caches beside the logits). No remat on this path.
    return_hidden: skip the vocab projection and return (the hidden states
    after the final norm [B, S, d], aux) for the fused-CE loss. return_aux:
    return (logits, aux). aux is the MoE routing loss summed over the
    layers (0.0 without MoE).

    sp_axis: the axis of ``mesh`` the sequence is split over (ring
    attention; ``positions`` then the shard's global positions). mesh: the
    ``DeviceMesh`` of the SPMD ops (ring attention, the MoE layer's token
    and expert split), passed to each block as an argument: a block that
    remat runs again in backward, on autograd's thread, sees the same
    mesh. block: the per-layer block (``_block`` unless given; the mesh
    train step gives its own over ``_spmd_block``), run under the
    config's remat policy."""
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
        block = _block_fn(cfg, block)
        for p in params["blocks"]:
            x, aux = block(cfg, p, x, rope, positions, None, sp_axis, mesh)
            aux_total = aux_total + aux
    x = _norm(cfg, params["final_norm"], x)
    if return_hidden:
        return x, aux_total
    logits = _project(cfg, params, x)
    return (logits, aux_total) if return_aux else logits


# ---------------------------------------------------------------------------
# tensor parallelism (Megatron column/row sharding, arXiv:1909.09756)
#
# Each block is cut over tp ranks: QKV / ffn-up are COLUMN-parallel (output
# features sharded: heads for attention, ffn columns for the mlp) and the
# attention proj / ffn-down are ROW-parallel (input features sharded), so a
# rank's block forward needs exactly one partial-sum allreduce per sublayer:
# the conjugate (g, f) operator pair of ``util/collective/tp.py``. Norms,
# post-reduce biases, embeddings and the lm_head stay replicated and get
# exact replicated grads through f's backward reduce.


def tp_block_shard_spec(cfg: TransformerConfig) -> Dict[str, Dict[str, int]]:
    """path -> shard axis for ONE block's sharded leaves (the port's
    blocks are per-layer dicts; a JAX scan-stacked block adds 1 to every
    axis). Column-parallel leaves shard their output-feature axis,
    row-parallel leaves their input-feature axis; leaves absent from the
    spec (norms, gelu's post-reduce b_out) are replicated."""
    spec: Dict[str, Dict[str, int]] = {
        "attn": {"wq": 1, "wk": 1, "wv": 1,   # (d, heads, hd): heads
                 "wo": 0},                     # (heads, hd, d): heads
    }
    if cfg.mlp == "swiglu":
        spec["mlp"] = {"w_gate": 1, "w_up": 1,  # (d, f): ffn columns
                       "w_down": 0}             # (f, d): ffn columns
    elif cfg.mlp == "gelu":
        spec["mlp"] = {"w_in": 1, "b_in": 0,    # column-parallel (+ its bias)
                       "w_out": 0}              # row-parallel (b_out: no)
    else:
        raise ValueError(
            "tensor parallelism does not support cfg.mlp='moe': experts "
            "are already expert-parallel; shard with moe_num_experts "
            "instead, or set cfg.mlp to 'swiglu'/'gelu'")
    return spec


def _tp_map_block(cfg, block, fn, stacked: bool):
    """fn(leaf, shard_axis_or_None) over one block's leaves."""
    spec = tp_block_shard_spec(cfg)
    off = 1 if stacked else 0
    return {group: {name: fn(leaf, spec.get(group, {})[name] + off
                             if name in spec.get(group, {}) else None)
                    for name, leaf in leaves.items()}
            for group, leaves in block.items()}


def shard_block_params(cfg: TransformerConfig, block, tp: int, tp_rank: int,
                       *, stacked: bool = False):
    """Rank ``tp_rank``'s shard of one block's params: each sharded leaf a
    contiguous copy of its slice, replicated leaves passed through as they
    are. ``stacked``: the block carries a leading layers axis."""
    def cut(leaf, axis):
        if axis is None:
            return leaf
        k = leaf.shape[axis] // tp
        return leaf.narrow(axis, tp_rank * k, k).clone()

    return _tp_map_block(cfg, block, cut, stacked)


def merge_tp_block_params(cfg: TransformerConfig, shards, *,
                          stacked: bool = False):
    """Bit-exact inverse of ``shard_block_params``: the rank shards
    concatenated back into the fused block (replicated leaves taken from
    rank 0)."""
    spec = tp_block_shard_spec(cfg)
    off = 1 if stacked else 0
    out: Dict[str, Any] = {}
    for group in shards[0]:
        gspec = spec.get(group, {})
        out[group] = {
            name: (torch.cat([s[group][name] for s in shards],
                             dim=gspec[name] + off)
                   if name in gspec else shards[0][group][name])
            for name in shards[0][group]}
    return out


def _tp_attn_partial(cfg, p, x, rope: Rope, positions=None):
    """Attention over this rank's local heads; returns the PARTIAL output
    projection (the sum over the local heads only: g completes it). On a
    CUDA tensor the attention is the flash kernels (K1 forward, K2/K3
    backward)."""
    return _attn(cfg, p, x, rope, positions)


def _tp_mlp_partial(cfg, p, x):
    """The MLP over this rank's local ffn columns; returns the PARTIAL
    down projection (gelu's replicated b_out is added after g, in
    ``_tp_mlp_finish``)."""
    if cfg.mlp == "swiglu":
        return _mlp(cfg, p, x)[0]
    hid = F.gelu(x @ _w(cfg, p["w_in"]) + _w(cfg, p["b_in"]),
                 approximate="tanh")
    return hid @ _w(cfg, p["w_out"])


def _tp_mlp_finish(cfg, p, reduced):
    """Post-reduce epilogue: the replicated bias (gelu) rides on the FULL
    sum, so each rank adds it exactly once."""
    if cfg.mlp == "gelu":
        return reduced + _w(cfg, p["b_out"])
    return reduced


def _tp_block_tail(cfg, p, x, rope: Rope, g, f):
    """Last block of a forward chunk, tail-split: returns (u,
    mlp_partial), the full output being u + allreduce(mlp_partial). The
    pipeline trainer issues that last reduce asynchronously and overlaps
    it with the next microbatch's compute. Valid only without a
    post-reduce epilogue (swiglu: ``tp_tail_supported``)."""
    a = g(_tp_attn_partial(cfg, p["attn"], f(_norm(cfg, p["ln1"], x)),
                           rope))
    u = x + a
    mp = _tp_mlp_partial(cfg, p["mlp"], f(_norm(cfg, p["ln2"], u)))
    return u, mp


def _spmd_block(cfg: TransformerConfig, p, x, rope: Rope, positions,
                kv_cache=None, sp_axis=None, mesh=None, *, g=None, f=None,
                attn_tp: bool = False, mlp_tp: bool = False):
    """``_block`` on one rank's local shards: with ``attn_tp`` the
    attention runs over this rank's heads, with ``mlp_tp`` the dense MLP
    over its ffn columns (Megatron). f on the norm output (the
    column-parallel input) makes the replicated params' and the residual's
    cotangents exact; g on the row-parallel partial sum completes the
    sublayer's activation. A sublayer without its flag runs whole (its
    weights gathered over ``tp``). The mesh train step runs it over the
    ``tp`` dim's all-reduce, the pipeline trainer over a host reducer."""
    h = _norm(cfg, p["ln1"], x)
    if attn_tp:
        a = g(_attn(cfg, p["attn"], f(h), rope, positions, None, sp_axis,
                    mesh))
    else:
        a = _attn(cfg, p["attn"], h, rope, positions, None, sp_axis, mesh)
    x = x + a
    h = _norm(cfg, p["ln2"], x)
    if mlp_tp:
        m = _tp_mlp_finish(cfg, p["mlp"],
                           g(_tp_mlp_partial(cfg, p["mlp"], f(h))))
        return x + m, 0.0
    m, aux = _mlp(cfg, p["mlp"], h, mesh)
    return x + m, aux


def tp_tail_supported(cfg: TransformerConfig) -> bool:
    """Whether forward chunks may tail-split their last block (the partial
    sum must BE the block's residual delta: no post-reduce bias)."""
    return cfg.mlp == "swiglu"


def loss_fn(cfg: TransformerConfig, params, batch, *,
            positions: Optional[torch.Tensor] = None,
            sp_axis: Optional[str] = None, mesh=None, block=None):
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
                              return_hidden=True, sp_axis=sp_axis,
                              mesh=mesh, block=block)
        if cfg.tie_embeddings:
            table, transpose = params["embed"]["table"], False
        else:
            table, transpose = params["lm_head"]["kernel"], True
        loss, n = fused_softmax_cross_entropy(
            hidden[:, :-1], table, targets, mask, chunk=cfg.ce_chunk,
            compute_dtype=cfg.dtype, transpose_table=transpose)
    else:
        logits, aux = forward(cfg, params, tokens, positions=positions,
                              return_aux=True, sp_axis=sp_axis, mesh=mesh,
                              block=block)
        loss, n = softmax_cross_entropy(logits[:, :-1], targets, mask)
    metrics = {"loss": loss, "tokens": n}
    if cfg.mlp == "moe":
        loss = loss + cfg.moe_aux_weight * aux
        metrics["moe_aux"] = aux
    return loss, metrics
