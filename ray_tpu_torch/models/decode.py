"""Paged KV arena and the two in-place serving programs: chunked prefill into
one slot, and one decode step over every slot.

Counterpart: the in-place lane of ``ray_tpu/models/decode.py``
(``PagedKVCache``, ``init_paged_caches``, ``paged_reset_slot``,
``_paged_forward_inplace``, ``paged_prefill_into_slot``,
``paged_decode_step``). KV storage is a pool of fixed-size pages per layer,
``[num_pages, page_tokens, Hkv, D]``; a slot owns a page table of physical
page ids instead of a contiguous range. Each layer writes the new tokens'
k/v straight into their pages (write before attend) and attends through the
page table with ``ops.paged_attention``.

Page 0 is the garbage page: read-table entries a slot has not allocated
point at it (their positions are past the slot's cursor, so the mask zeroes
them exactly), and write-table entries for shared or unallocated pages
redirect there, so a slot never writes a page it does not own. The
scheduler (``serve/_private/continuous.py``) keeps the tables on the host.

JAX donated the pools to its compiled programs; here the pools and the slot
cursors are updated in place, and the programs return only logits.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import torch

from ray_tpu_torch._private.device import resolve_device
from ray_tpu_torch.models.transformer import (TransformerConfig, _head,
                                              _mlp, _norm)
from ray_tpu_torch.ops.paged_attention import paged_attention
from ray_tpu_torch.ops.rotary import apply_rotary

Rope = Optional[Tuple[torch.Tensor, torch.Tensor]]


@dataclasses.dataclass
class PagedKVCache:
    """One layer's page pool. k/v: [num_pages, page_tokens, Hkv, D];
    lengths: [slots] int32, the per-slot write cursors in logical tokens.
    Every layer holds the same ``lengths`` tensor: the cursors are one
    buffer updated in place, once per program call."""

    k: torch.Tensor
    v: torch.Tensor
    lengths: torch.Tensor


def init_paged_caches(cfg: TransformerConfig, slots: int, num_pages: int,
                      page_tokens: int, pages_per_slot: int,
                      device: Optional[torch.device | str] = None
                      ) -> List[PagedKVCache]:
    """Zeroed pools in ``cfg.dtype``, one per layer, sharing one cursor
    tensor, on ``device`` (the card unless ``"cpu"`` is asked for)."""
    if page_tokens < 1:
        raise ValueError(f"page_tokens must be >= 1, got {page_tokens}")
    if num_pages < 2:
        # page 0 is the reserved garbage page; an arena with no
        # allocatable page cannot hold any sequence
        raise ValueError(f"num_pages must be >= 2, got {num_pages}")
    if pages_per_slot * page_tokens > cfg.max_seq_len:
        # the position tables are sized cfg.max_seq_len; a longer logical
        # view would read clamped positions and decode silently wrong
        raise ValueError(
            f"pages_per_slot * page_tokens ({pages_per_slot * page_tokens}) "
            f"exceeds cfg.max_seq_len ({cfg.max_seq_len})")
    device = resolve_device(device)
    shape = (num_pages, page_tokens, cfg.kv_heads, cfg.head_dim)
    lengths = torch.zeros(slots, dtype=torch.int32, device=device)
    return [PagedKVCache(k=torch.zeros(shape, dtype=cfg.dtype, device=device),
                         v=torch.zeros(shape, dtype=cfg.dtype, device=device),
                         lengths=lengths)
            for _ in range(cfg.num_layers)]


def paged_reset_slot(caches: List[PagedKVCache], slot: int,
                     length: int = 0) -> None:
    """Point a slot's cursor at ``length`` (0 for a cold admit; the cached
    prefix length for a prefix-cache hit). No scrub: every position a new
    sequence attends to is written by it first."""
    caches[0].lengths[slot] = length


def _paged_forward_inplace(cfg: TransformerConfig, params, tokens, positions,
                           lengths, read_tables, write_tables,
                           caches: List[PagedKVCache], rope: Rope
                           ) -> torch.Tensor:
    """One K-token window over S slots; returns the last block's output
    [S, K, d] (the callers apply the head to the rows they need).

    tokens/positions: [S, K]; lengths: [S] attention cursors;
    read_tables/write_tables: [S, P] int32. Each layer (1) writes the
    window's k/v into its pages through the write table, in place, and
    (2) attends through the read table. Layer math mirrors
    ``ray_tpu.models.transformer._block``."""
    S, K = tokens.shape
    T = caches[0].k.shape[1]
    P = read_tables.shape[1]
    H, Hkv, hd, d = cfg.num_heads, cfg.kv_heads, cfg.head_dim, cfg.embed_dim
    pos = positions.long().clamp(0, cfg.max_seq_len - 1)  # as XLA's gather
    x = params["embed"]["table"][tokens.long()]
    if cfg.pos == "learned":
        x = x + params["pos_embed"]["table"][pos]
    pages = write_tables.long().gather(
        1, torch.clamp(positions.long() // T, 0, P - 1))
    offs = positions.long() % T
    for p, c in zip(params["blocks"], caches):
        h = _norm(cfg, p["ln1"], x)
        ap = p["attn"]
        q = (h @ ap["wq"].reshape(d, H * hd)).view(S, K, H, hd)
        k = (h @ ap["wk"].reshape(d, Hkv * hd)).view(S, K, Hkv, hd)
        v = (h @ ap["wv"].reshape(d, Hkv * hd)).view(S, K, Hkv, hd)
        if rope is not None:
            cos, sin = rope
            q = apply_rotary(q, cos, sin, pos)
            k = apply_rotary(k, cos, sin, pos)
        # write before attend. Pad positions and inactive slots may write
        # page 0 (or not-yet-attended offsets of owned pages) more than
        # once; whichever write lands, nothing attends to it.
        c.k[pages, offs] = k.to(c.k.dtype)
        c.v[pages, offs] = v.to(c.v.dtype)
        o = paged_attention(q, c.k, c.v, read_tables, lengths)
        x = x + o.reshape(S, K, H * hd) @ ap["wo"].reshape(H * hd, d)
        x = x + _mlp(cfg, p["mlp"], _norm(cfg, p["ln2"], x))
    return x


def paged_prefill_into_slot(cfg: TransformerConfig, params, tokens,
                            real_len: int, slot: int, read_row, write_row,
                            caches: List[PagedKVCache], rope: Rope
                            ) -> torch.Tensor:
    """One prefill chunk into ONE slot. tokens: [1, C], zero-padded past
    ``real_len``; read_row/write_row: [P] int32 (shared prefix-cache pages
    appear in read_row but redirect to the garbage page in write_row).
    The chunk attends from the slot's cursor BEFORE the chunk; the cursor
    then advances by ``real_len``. Returns the logits [vocab] at the last
    real token.

    Caller contract (scheduler-enforced): every page covering the real
    tokens is allocated and owned; cursor + C fits the logical view."""
    lengths = caches[0].lengths[slot:slot + 1]
    positions = lengths[:, None] + torch.arange(
        tokens.shape[1], dtype=torch.int32, device=tokens.device)[None]
    x = _paged_forward_inplace(cfg, params, tokens, positions, lengths,
                               read_row[None], write_row[None], caches, rope)
    logits = _head(cfg, params, x[0, real_len - 1])
    caches[0].lengths[slot] += real_len
    return logits


def paged_decode_step(cfg: TransformerConfig, params, tokens, active,
                      read_tables, write_tables,
                      caches: List[PagedKVCache], rope: Rope
                      ) -> torch.Tensor:
    """One decode step over the whole arena. tokens/active: [slots] int32;
    read_tables/write_tables: [slots, P] int32. Inactive slots run on
    garbage: their logits are not read, their cursors do not advance, and
    their write lands where the slot's next real write goes first.
    Returns logits [slots, vocab]."""
    lengths = caches[0].lengths
    x = _paged_forward_inplace(cfg, params, tokens[:, None],
                               lengths[:, None], lengths, read_tables,
                               write_tables, caches, rope)
    logits = _head(cfg, params, x[:, 0])
    lengths += active
    return logits
