"""Serving programs: the contiguous KV caches, the slot arena, and the paged
KV arena with its in-place programs (chunked prefill into one slot, one
decode step over every slot, and the speculative verify window).

Counterpart: ``ray_tpu/models/decode.py``.

* Contiguous caches (``LayerKVCache``, ``init_caches``, ``prefill``,
  ``decode_step``, ``sample_token``, ``generate``): one fixed buffer per
  layer, ``[B, max_len, Hkv, D]``, run through ``transformer.forward``
  with ``kv_caches``, whose attention is plain PyTorch.
* The slot arena (``SlotKVCache``, ``init_slot_caches``, ``reset_slot``,
  ``prefill_into_slot``, ``slot_decode_step``): the same buffers with one
  sequence per row and a cursor per slot; the speculative drafter's arena.
* The paged arena (``PagedKVCache``, ``init_paged_caches``,
  ``paged_reset_slot``, ``paged_prefill_into_slot``, ``paged_decode_step``,
  ``paged_verify_step``, ``paged_rewind_slots``): KV storage is a pool of
  fixed-size pages per layer, ``[num_pages, page_tokens, Hkv, D]``; a slot
  owns a page table of physical page ids instead of a contiguous range.
  The paged programs take an attention lane
  (``ops.attention.PAGED_ATTN_LANES``): on the in-place lanes
  (``"cuda"``, and ``"reference"``, its name on the CPU, refused on a
  CUDA device) each layer writes the new tokens' k/v straight into their
  pages (write before attend) and attends through the page table with
  ``ops.paged_attention``, which runs its plain version on CPU tensors
  and only there; the ``"gather"`` lane, the measured baseline,
  gathers each slot's logical view from the pool, runs the contiguous
  forward over it and scatters the written pages back.

Page 0 is the garbage page: read-table entries a slot has not allocated
point at it (their positions are past the slot's cursor, so the mask zeroes
them exactly), and write-table entries for shared or unallocated pages
redirect there, so a slot never writes a page it does not own. The
scheduler (``serve/_private/continuous.py``) keeps the tables on the host.

JAX donated the caches to its compiled programs and got new ones back; here
the caches and the cursors are updated in place, and the programs return
only logits. Every layer of an arena shares one cursor tensor, updated once
per program call.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np
import torch

from ray_tpu_torch._private.device import resolve_device
from ray_tpu_torch.models.transformer import (TransformerConfig, _head,
                                              _mlp, _norm, forward)
from ray_tpu_torch.ops.attention import check_paged_attn_lane
from ray_tpu_torch.ops.paged_attention import paged_attention
from ray_tpu_torch.ops.rotary import apply_rotary

Rope = Optional[Tuple[torch.Tensor, torch.Tensor]]

NEG_INF = -1e30


# ---------------------------------------------------------------------------
# contiguous KV caches


@dataclasses.dataclass
class LayerKVCache:
    """One layer's fixed-capacity cache. k/v: [B, max_len, Hkv, D]; length:
    [B] int32, the tokens each row has cached. (JAX keeps one scalar for
    the batch; a cursor per row lets the slot arena step every slot in one
    batch.)"""

    k: torch.Tensor
    v: torch.Tensor
    length: torch.Tensor

    @classmethod
    def zeros(cls, batch: int, max_len: int, kv_heads: int, head_dim: int,
              dtype: torch.dtype, device: torch.device) -> "LayerKVCache":
        shape = (batch, max_len, kv_heads, head_dim)
        return cls(k=torch.zeros(shape, dtype=dtype, device=device),
                   v=torch.zeros(shape, dtype=dtype, device=device),
                   length=torch.zeros(batch, dtype=torch.int32,
                                      device=device))

    def update(self, k_new: torch.Tensor, v_new: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Write [B, S, Hkv, D] new keys/values at each row's cursor, in
        place, and advance the cursors by S; returns the full buffers. As
        with ``lax.dynamic_update_slice``, a write that would run past the
        end starts earlier instead."""
        B, S = k_new.shape[:2]
        start = torch.clamp(self.length.long(), 0, self.k.shape[1] - S)
        idx = start[:, None] + torch.arange(S, device=start.device)
        rows = torch.arange(B, device=start.device)[:, None]
        self.k[rows, idx] = k_new.to(self.k.dtype)
        self.v[rows, idx] = v_new.to(self.v.dtype)
        self.length = self.length + S
        return self.k, self.v

    def mask_bias(self, q_len: int) -> torch.Tensor:
        """Additive bias [B, 1, 1, q_len, max_len]: query i of row b (at
        position length[b] + i) may attend to cache position j iff
        j <= length[b] + i."""
        dev = self.k.device
        qpos = self.length.long()[:, None] + torch.arange(q_len, device=dev)
        jpos = torch.arange(self.k.shape[1], device=dev)
        allowed = jpos[None, None, :] <= qpos[:, :, None]
        bias = torch.where(allowed, 0.0, NEG_INF).to(torch.float32)
        return bias[:, None, None]


def init_caches(cfg: TransformerConfig, batch: int, max_len: int,
                device: Optional[torch.device | str] = None,
                dtype: Optional[torch.dtype] = None) -> List[LayerKVCache]:
    """Zeroed caches, one per layer, on ``device`` (the card unless
    ``"cpu"`` is asked for), in ``dtype`` (default ``cfg.dtype``)."""
    device = resolve_device(device)
    return [LayerKVCache.zeros(batch, max_len, cfg.kv_heads, cfg.head_dim,
                               dtype or cfg.dtype, device)
            for _ in range(cfg.num_layers)]


def prefill(cfg: TransformerConfig, params, tokens: torch.Tensor,
            caches: List[LayerKVCache]) -> torch.Tensor:
    """Run the prompt [B, S] through the model, filling the caches.
    Returns the logits at the last position [B, vocab]."""
    positions = caches[0].length[:, None] + torch.arange(
        tokens.shape[1], dtype=torch.int32, device=tokens.device)
    logits = forward(cfg, params, tokens, positions=positions,
                     kv_caches=caches)
    return logits[:, -1]


def decode_step(cfg: TransformerConfig, params, token: torch.Tensor,
                caches: List[LayerKVCache]) -> torch.Tensor:
    """One token step. token: [B, 1]. Returns logits [B, vocab]."""
    logits = forward(cfg, params, token,
                     positions=caches[0].length[:, None], kv_caches=caches)
    return logits[:, -1]


def sample_token(logits: torch.Tensor,
                 generator: Optional[torch.Generator] = None,
                 temperature: float = 0.0, top_k: int = 0) -> torch.Tensor:
    """Greedy (temperature 0) or temperature/top-k sampling from
    ``generator`` (on the logits' device). [B, V] -> [B] int64."""
    if temperature == 0.0:
        return torch.argmax(logits, dim=-1)
    logits = logits.float() / temperature
    if top_k > 0:
        top = torch.topk(logits, top_k, dim=-1).values[..., -1:]
        logits = torch.where(logits < top, NEG_INF, logits)
    probs = torch.softmax(logits, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0]


@torch.no_grad()
def generate(cfg: TransformerConfig, params, prompt: torch.Tensor,
             generator: Optional[torch.Generator], max_new_tokens: int,
             temperature: float = 0.0, top_k: int = 0) -> torch.Tensor:
    """prompt [B, S] -> generated [B, max_new_tokens] (greedy or sampled),
    through contiguous caches on the prompt's device: prefill, then one
    decode step per token."""
    batch, prompt_len = prompt.shape
    if prompt_len + max_new_tokens > cfg.max_seq_len:
        # position tables are sized cfg.max_seq_len; past that a gather
        # clamps and decodes silently wrong
        raise ValueError(
            f"prompt_len ({prompt_len}) + max_new_tokens ({max_new_tokens}) "
            f"exceeds cfg.max_seq_len ({cfg.max_seq_len})")
    caches = init_caches(cfg, batch, prompt_len + max_new_tokens,
                         device=prompt.device)
    logits = prefill(cfg, params, prompt, caches)
    out = []
    for i in range(max_new_tokens):
        tok = sample_token(logits, generator, temperature, top_k)
        out.append(tok)
        if i + 1 < max_new_tokens:
            logits = decode_step(cfg, params, tok[:, None], caches)
    return torch.stack(out, dim=1)


# ---------------------------------------------------------------------------
# slot arena: one sequence per row, a cursor per slot (the continuous
# scheduler's contiguous substrate; the speculative drafter's arena)


@dataclasses.dataclass
class SlotKVCache:
    """One layer's slot arena. k/v: [slots, max_len, Hkv, D]; lengths:
    [slots] int32 write cursors, one tensor shared by every layer."""

    k: torch.Tensor
    v: torch.Tensor
    lengths: torch.Tensor


def init_slot_caches(cfg: TransformerConfig, slots: int, max_len: int,
                     device: Optional[torch.device | str] = None,
                     dtype: Optional[torch.dtype] = None
                     ) -> List[SlotKVCache]:
    """Zeroed arenas, one per layer, sharing one cursor tensor, on
    ``device`` (the card unless ``"cpu"`` is asked for)."""
    if max_len > cfg.max_seq_len:
        # the position tables are sized cfg.max_seq_len; a longer arena
        # would read clamped positions and decode silently wrong
        raise ValueError(
            f"slot arena max_len ({max_len}) exceeds cfg.max_seq_len "
            f"({cfg.max_seq_len})")
    device = resolve_device(device)
    shape = (slots, max_len, cfg.kv_heads, cfg.head_dim)
    dtype = dtype or cfg.dtype
    lengths = torch.zeros(slots, dtype=torch.int32, device=device)
    return [SlotKVCache(k=torch.zeros(shape, dtype=dtype, device=device),
                        v=torch.zeros(shape, dtype=dtype, device=device),
                        lengths=lengths)
            for _ in range(cfg.num_layers)]


def reset_slot(caches: List[SlotKVCache], slot: int) -> None:
    """Recycle a slot: rewind its cursor. Stale k/v need no scrub: writes
    are contiguous from 0 and come before attention, so every position a
    new sequence attends to was written by it."""
    caches[0].lengths[slot] = 0


def prefill_into_slot(cfg: TransformerConfig, params, tokens, real_len: int,
                      slot: int, caches: List[SlotKVCache]) -> torch.Tensor:
    """One prefill chunk into ONE slot. tokens: [1, C], zero-padded past
    ``real_len``. Writes k/v at [cursor, cursor + C) and advances the
    slot's cursor by ``real_len`` only (pad positions are written over
    before anything attends to them). Returns the logits [vocab] at the
    last real token. Caller contract: cursor + C fits the arena."""
    lengths = caches[0].lengths
    rows = [LayerKVCache(k=c.k[slot:slot + 1], v=c.v[slot:slot + 1],
                         length=lengths[slot:slot + 1]) for c in caches]
    positions = lengths[slot:slot + 1, None] + torch.arange(
        tokens.shape[1], dtype=torch.int32, device=tokens.device)
    logits = forward(cfg, params, tokens, positions=positions,
                     kv_caches=rows)
    lengths[slot] += real_len
    return logits[0, real_len - 1]


def _forward_slots(cfg: TransformerConfig, params, tokens, positions,
                   rows: List[LayerKVCache]) -> torch.Tensor:
    """``forward`` over a batch of slots whose contiguous caches are
    ``rows`` (row s of each is slot s). JAX vmaps one sequence's program
    over the slots. A batch is the same math in every layer but MoE,
    whose expert capacity is pooled over the rows of one call, so an MoE
    model runs one slot at a time (writes through each row's view land in
    the batch's buffers). Returns logits [slots, K, vocab]."""
    if cfg.mlp != "moe":
        return forward(cfg, params, tokens, positions=positions,
                       kv_caches=rows)
    return torch.cat([forward(
        cfg, params, tokens[s:s + 1], positions=positions[s:s + 1],
        kv_caches=[LayerKVCache(k=r.k[s:s + 1], v=r.v[s:s + 1],
                                length=r.length[s:s + 1]) for r in rows])
        for s in range(tokens.shape[0])])


def slot_decode_step(cfg: TransformerConfig, params, tokens, active,
                     caches: List[SlotKVCache]) -> torch.Tensor:
    """One decode step over the WHOLE arena. tokens/active: [slots] int32.
    Every slot writes its token's k/v at its cursor and attends under its
    own mask row; inactive slots run on garbage: their logits are not read
    and their cursors do not advance. (JAX vmaps a one-sequence program
    over the slots; here the slots are one batch, see ``_forward_slots``.)
    Returns logits [slots, vocab]."""
    lengths = caches[0].lengths
    rows = [LayerKVCache(k=c.k, v=c.v, length=lengths) for c in caches]
    # a free slot's cursor may sit at the end of the arena: clamp its
    # position as XLA's gather would
    positions = torch.clamp(lengths, max=cfg.max_seq_len - 1)[:, None]
    logits = _forward_slots(cfg, params, tokens[:, None], positions, rows)
    lengths += active
    return logits[:, 0]


# ---------------------------------------------------------------------------
# paged KV arena


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
                      device: Optional[torch.device | str] = None,
                      dtype: Optional[torch.dtype] = None
                      ) -> List[PagedKVCache]:
    """Zeroed pools in ``dtype`` (default ``cfg.dtype``), one per layer,
    sharing one cursor tensor, on ``device`` (the card unless ``"cpu"`` is
    asked for)."""
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
    dtype = dtype or cfg.dtype
    lengths = torch.zeros(slots, dtype=torch.int32, device=device)
    return [PagedKVCache(k=torch.zeros(shape, dtype=dtype, device=device),
                         v=torch.zeros(shape, dtype=dtype, device=device),
                         lengths=lengths)
            for _ in range(cfg.num_layers)]


def paged_reset_slot(caches: List[PagedKVCache], slot: int,
                     length: int = 0) -> None:
    """Point a slot's cursor at ``length`` (0 for a cold admit; the cached
    prefix length for a prefix-cache hit). No scrub: every position a new
    sequence attends to is written by it first."""
    caches[0].lengths[slot] = length


def _gather_row(c: PagedKVCache, tables) -> Tuple[torch.Tensor,
                                                  torch.Tensor]:
    """[S, P] page tables -> the slots' logical [S, P*T, Hkv, D] k/v views
    (JAX's ``_gather_row`` takes one [P] row; a batch of rows here)."""
    S, P = tables.shape
    T, H, D = c.k.shape[1:]
    idx = tables.long()
    return (c.k[idx].reshape(S, P * T, H, D),
            c.v[idx].reshape(S, P * T, H, D))


def _gathered_window(cfg: TransformerConfig, params, tokens, positions,
                     slot_ids, read_tables, write_tables,
                     caches: List[PagedKVCache]) -> torch.Tensor:
    """The gather lane's K-token window over the slots ``slot_ids`` [S]:
    gather each slot's logical view through its read table, run
    ``forward`` over the views as contiguous caches (write at the slot's
    cursor, then attend under its mask row), and scatter back the pages
    the window wrote, ``min(P, ceil(K / T) + 1)`` of them from the page
    holding the cursor, through the write table: shared and unallocated
    entries land on the garbage page, and window pages clipped to the
    table's end repeat a page with the same content. Returns the logits
    [S, K, vocab]. Cursors are not moved here."""
    S, K = tokens.shape
    T = caches[0].k.shape[1]
    P = read_tables.shape[1]
    lengths = caches[0].lengths[slot_ids]
    views = [_gather_row(c, read_tables) for c in caches]
    rows = [LayerKVCache(k=k, v=v, length=lengths) for k, v in views]
    logits = _forward_slots(cfg, params, tokens,
                            positions.clamp(0, cfg.max_seq_len - 1), rows)
    W = min(P, -(-K // T) + 1)
    widx = torch.clamp(lengths.long()[:, None] // T
                       + torch.arange(W, device=tokens.device), max=P - 1)
    dest = write_tables.long().gather(1, widx)                 # [S, W]
    Hkv, D = caches[0].k.shape[2:]
    for c, r in zip(caches, rows):
        for pool, view in ((c.k, r.k), (c.v, r.v)):
            pages = view.reshape(S, P, T, Hkv, D)
            src = pages[torch.arange(S, device=tokens.device)[:, None], widx]
            pool[dest.reshape(-1)] = src.reshape(S * W, T, Hkv, D)
    return logits


def _paged_forward_inplace(cfg: TransformerConfig, params, tokens, positions,
                           lengths, read_tables, write_tables,
                           caches: List[PagedKVCache], rope: Rope
                           ) -> torch.Tensor:
    """One K-token window over S slots; returns the last block's output
    [S, K, d] (the callers apply the head to the rows they need).

    tokens/positions: [S, K]; lengths: [S] attention cursors;
    read_tables/write_tables: [S, P] int32. Each layer (1) writes the
    window's k/v into its pages through the write table, in place, and
    (2) attends through the read table with the kernel's wrapper, which
    runs the plain version on CPU tensors and only there. Layer math
    mirrors ``ray_tpu.models.transformer._block``."""
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
        # MoE capacity is pooled over all S x K rows of the call, inactive
        # slots and pad rows included, as in JAX's in-place lanes
        m, _ = _mlp(cfg, p["mlp"], _norm(cfg, p["ln2"], x))
        x = x + m
    return x


def paged_prefill_into_slot(cfg: TransformerConfig, params, tokens,
                            real_len: int, slot: int, read_row, write_row,
                            caches: List[PagedKVCache], rope: Rope, *,
                            attn: str = "cuda") -> torch.Tensor:
    """One prefill chunk into ONE slot. tokens: [1, C], zero-padded past
    ``real_len``; read_row/write_row: [P] int32 (shared prefix-cache pages
    appear in read_row but redirect to the garbage page in write_row).
    The chunk attends from the slot's cursor BEFORE the chunk; the cursor
    then advances by ``real_len``. Returns the logits [vocab] at the last
    real token. ``attn``: one of ``ops.attention.PAGED_ATTN_LANES`` (the
    gather lane scatters back only the window of pages the chunk wrote).

    Caller contract (scheduler-enforced): every page covering the real
    tokens is allocated and owned; cursor + C fits the logical view."""
    check_paged_attn_lane(attn, tokens.device)
    lengths = caches[0].lengths[slot:slot + 1]
    positions = lengths[:, None] + torch.arange(
        tokens.shape[1], dtype=torch.int32, device=tokens.device)[None]
    if attn == "gather":
        logits = _gathered_window(
            cfg, params, tokens, positions,
            torch.tensor([slot], device=tokens.device), read_row[None],
            write_row[None], caches)[0, real_len - 1]
    else:
        x = _paged_forward_inplace(cfg, params, tokens, positions, lengths,
                                   read_row[None], write_row[None], caches,
                                   rope)
        logits = _head(cfg, params, x[0, real_len - 1])
    caches[0].lengths[slot] += real_len
    return logits


def paged_decode_step(cfg: TransformerConfig, params, tokens, active,
                      read_tables, write_tables,
                      caches: List[PagedKVCache], rope: Rope, *,
                      attn: str = "cuda") -> torch.Tensor:
    """One decode step over the whole arena. tokens/active: [slots] int32;
    read_tables/write_tables: [slots, P] int32. Inactive slots run on
    garbage: their logits are not read, their cursors do not advance, and
    their write lands where the slot's next real write goes first. On the
    gather lane each slot's math is the contiguous arena's over its
    gathered view (JAX vmaps it; a batch of slots here), and the page
    holding each cursor is scattered back. Returns logits [slots, vocab]."""
    check_paged_attn_lane(attn, tokens.device)
    lengths = caches[0].lengths
    if attn == "gather":
        slots = torch.arange(tokens.shape[0], device=tokens.device)
        logits = _gathered_window(cfg, params, tokens[:, None],
                                  lengths[:, None], slots, read_tables,
                                  write_tables, caches)[:, 0]
    else:
        x = _paged_forward_inplace(cfg, params, tokens[:, None],
                                   lengths[:, None], lengths, read_tables,
                                   write_tables, caches, rope)
        logits = _head(cfg, params, x[:, 0])
    lengths += active
    return logits


def paged_verify_step(cfg: TransformerConfig, params, tokens, read_tables,
                      write_tables, caches: List[PagedKVCache], rope: Rope,
                      *, attn: str = "cuda") -> torch.Tensor:
    """Speculative-decoding verify: score K candidate tokens per slot in
    ONE call over all slots. tokens: [slots, K] int32, each slot's
    [next_token, d_1 .. d_{K-1}] at positions [cursor, cursor + K).
    logits[s, j] is the model's distribution over the token after position
    cursor + j, the one the sequential ``paged_decode_step`` loop gives
    after accepting d_1 .. d_j: ``paged_attention`` computes row j of a
    window exactly as a 1-token call at cursor + j.

    The k/v of all K positions are written; the cursors do NOT advance
    (acceptance is the host's decision, applied by ``paged_rewind_slots``).
    Rejected positions hold stale k/v past the cursor, masked until the
    next write covers them; shared and unallocated write entries redirect
    to the garbage page. On the gather lane the window runs over each
    slot's gathered view, whose mask spans the full view, and its pages
    are scattered back. Returns logits [slots, K, vocab]."""
    check_paged_attn_lane(attn, tokens.device)
    lengths = caches[0].lengths
    positions = lengths[:, None] + torch.arange(
        tokens.shape[1], dtype=torch.int32, device=tokens.device)[None]
    if attn == "gather":
        slots = torch.arange(tokens.shape[0], device=tokens.device)
        return _gathered_window(cfg, params, tokens, positions, slots,
                                read_tables, write_tables, caches)
    x = _paged_forward_inplace(cfg, params, tokens, positions, lengths,
                               read_tables, write_tables, caches, rope)
    return _head(cfg, params, x)


def paged_rewind_slots(caches: List[PagedKVCache], new_lengths) -> None:
    """Set every slot's cursor after a verify round's acceptance: accepted
    slots advance to cursor + accepted + 1; rejected tails are left behind
    the cursor, masked until written over. No page is freed or changed.
    new_lengths: [slots] ints on the host."""
    caches[0].lengths.copy_(torch.from_numpy(
        np.asarray(new_lengths, np.int32)))
