"""Continuous (iteration-level) batching scheduler over a KV arena.

Counterpart: ``ray_tpu/serve/_private/continuous.py``. With
``kv_layout="paged"`` (the default) the scheduler owns a pool of KV pages
shared by ``slots`` sequence slots; with ``"contiguous"`` (the measured
baseline) a slot arena of ``arena_len`` tokens per slot. Per iteration it
runs at most ONE prefill chunk and ONE decode step (or, with a drafter,
one speculative round) over every slot:

  * new requests are admitted into free slots between iterations and
    prefilled in ``prefill_chunk``-token chunks, one chunk per iteration,
    so a long prompt never stalls the decodes in flight;
  * a radix prefix cache turns a prompt that shares a cached prefix into a
    page-table splice plus a cursor jump instead of a re-prefill;
  * finished, EOS (``eos_id``) or cancelled sequences retire their slot
    and pages at once;
  * every sampled token streams to its request's asyncio queue in the
    iteration that produced it;
  * with a ``speculative.Drafter`` (paged layout only), each round the
    drafter proposes up to ``spec_k`` tokens per slot and ONE
    ``paged_verify_step`` call scores them all, with exact accept-prefix +
    corrected-resample semantics; the plain decode step then never runs.
    At temperature 0 the emitted tokens are the argmax of the verify
    call's rows, which equal sequential decode steps' only up to rounding:
    the kernel's window rows are 1-token calls bit for bit, but a verify
    call's projections run over slots x (spec_k + 1) rows and a step's
    over slots rows, and the two GEMMs round otherwise. In float32 the
    gap is 5.04e-5 x RMS at llama3_8b and the texts equal the plain greedy
    ones at llama_debug; in bf16 it reaches bf16's own error (0.21 x RMS),
    and at llama3_8b 0 of 11 temperature-0 speculative texts equalled the
    plain ones (``chip_smoke.py``, NVIDIA H100 80GB HBM3, 700 W).

Knobs, as in the JAX scheduler, each validated at build: ``kv_layout``,
``page_tokens``, ``kv_pages`` (0: the worst case, every slot's whole
logical range plus the garbage page; a smaller pool also caps the
admissible prompt), ``prefix_cache``, ``cache_dtype`` (the KV arena's
dtype, which may differ from the model's: K4 widens both), ``eos_id`` and
``attn`` (the paged lane, resolved once by
``ops.attention.resolve_paged_attn_lane``: the kernel on the card, its
plain version on the CPU, or the gathered-view baseline). The contiguous
layout refuses ``attn``, ``prefix_cache=True`` and a drafter.

All torch work runs on the scheduler's own thread (on CUDA, on that
thread's current stream); the replica's event loop only touches queues.
Logits go to the host for sampling, which is numpy, so equal logits draw
equal tokens from equal seeds on the CPU and on the card.

Not carried by the port yet: cross-replica page migration, flight spans
and metrics (they come with the runtime). ``compiled_programs`` is left
out: the port runs eagerly and compiles no program.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ray_tpu_torch.models.decode import (init_paged_caches,
                                         init_slot_caches,
                                         paged_decode_step,
                                         paged_prefill_into_slot,
                                         paged_reset_slot,
                                         paged_rewind_slots,
                                         paged_verify_step,
                                         prefill_into_slot, reset_slot,
                                         slot_decode_step)
from ray_tpu_torch.ops.attention import resolve_paged_attn_lane
from ray_tpu_torch.ops.paged_attention import paged_attention
from ray_tpu_torch.ops.rotary import rope_frequencies
from ray_tpu_torch.serve._private.paging import (OutOfPagesError, PageArena,
                                                 RadixCache)
from ray_tpu_torch.serve._private.speculative import (_softmax,
                                                      accept_greedy,
                                                      accept_sample)

# sequence states
_QUEUED = "queued"
_PREFILL = "prefill"
_DECODE = "decode"
_DONE = "done"


class SchedulerClosedError(RuntimeError):
    pass


class _Seq:
    """One in-flight generation request and its consumer-side queue."""

    __slots__ = ("prompt", "remaining_prompt", "max_new", "temperature",
                 "seed", "slot", "state", "n_generated", "next_token",
                 "queue", "loop", "cancelled", "rng", "cached_len", "cursor",
                 "owned_pages", "radix_node", "table_fill", "drafter_len",
                 "drafter_pending")

    def __init__(self, prompt: List[int], max_new: int, temperature: float,
                 seed: int, loop, queue):
        self.prompt = prompt
        self.remaining_prompt = list(prompt)
        self.max_new = max_new
        self.temperature = temperature
        self.seed = seed
        self.slot: Optional[int] = None
        self.state = _QUEUED
        self.n_generated = 0
        self.next_token: Optional[int] = None
        self.queue = queue
        self.loop = loop
        self.cancelled = False
        self.rng = None  # numpy Generator, made at first use (temperature > 0)
        # ---- paged-arena bookkeeping (host mirrors of device state) ----
        self.cached_len = 0            # spliced prefix tokens (page-aligned)
        self.cursor = 0                # mirrors the slot's device cursor
        self.owned_pages: List[int] = []  # pages this slot must free
        self.radix_node = None         # ref-counted prefix-cache node
        self.table_fill = 0            # logical pages present in the table
        # ---- speculative decoding (per-slot drafter sync state) ----
        self.drafter_len = -1          # drafter's valid context length
        self.drafter_pending: List[int] = []  # tokens drafter must catch up


class ContinuousScheduler:
    """Continuous-batching scheduler over a paged or contiguous KV arena.

    ``params`` are the model's parameters on ``device``, shared by its
    programs. The scheduler owns the KV arena, updated in place.
    ``drafter`` (a ``speculative.Drafter`` with the scheduler's slot count)
    turns on speculative decoding with ``spec_k`` draft tokens a round.
    The knobs take the JAX scheduler's values and refusals; where JAX reads
    a config default for ``None``, the port takes the same default as the
    argument's."""

    def __init__(self, cfg, params, *, device: torch.device,
                 slots: int = 8, prefill_chunk: int = 32,
                 arena_len: Optional[int] = None,
                 eos_id: Optional[int] = None,
                 cache_dtype: Optional[torch.dtype] = None,
                 kv_layout: str = "paged", page_tokens: int = 16,
                 kv_pages: int = 0, prefix_cache: Optional[bool] = None,
                 drafter=None, spec_k: int = 4,
                 attn: Optional[str] = None):
        self.cfg = cfg
        self.params = params
        self.device = torch.device(device)
        self.slots = int(slots)
        self.prefill_chunk = int(prefill_chunk)
        self.arena_len = int(cfg.max_seq_len if arena_len is None
                             else arena_len)
        self.eos_id = eos_id
        self.kv_layout = kv_layout
        if self.kv_layout not in ("paged", "contiguous"):
            raise ValueError(
                f"kv_layout must be 'paged' or 'contiguous', got "
                f"{self.kv_layout!r}")
        self._paged = self.kv_layout == "paged"
        if self.slots < 1:
            raise ValueError(f"slots must be >= 1, got {self.slots}")
        if self.prefill_chunk < 1:
            raise ValueError(
                f"prefill_chunk must be >= 1, got {self.prefill_chunk}")
        if self.prefill_chunk > self.arena_len:
            raise ValueError(
                f"prefill_chunk ({self.prefill_chunk}) exceeds the arena "
                f"length ({self.arena_len})")
        self._arena = None
        self._radix = None
        if self._paged:
            self.page_tokens = int(page_tokens)
            if self.page_tokens < 1:
                raise ValueError(
                    f"page_tokens must be >= 1, got {self.page_tokens}")
            if self.arena_len % self.page_tokens != 0:
                raise ValueError(
                    f"arena_len ({self.arena_len}) must be a multiple of "
                    f"page_tokens ({self.page_tokens})")
            self._pages_per_slot = self.arena_len // self.page_tokens
            kvp = int(kv_pages)
            if kvp < 0:
                raise ValueError(f"kv_pages must be >= 0, got {kvp}")
            if kvp == 0:
                # the worst case: every slot could fill its whole logical
                # range, plus the reserved garbage page
                kvp = self.slots * self._pages_per_slot + 1
            self.num_pages = kvp
            self._arena = PageArena(self.num_pages, self.page_tokens)
            if prefix_cache is None or prefix_cache:
                self._radix = RadixCache(self._arena)
            # host-side page tables: logical page j of slot s lives at
            # physical page read_tables[s, j]; 0 = the garbage page
            self._read_tables = np.zeros(
                (self.slots, self._pages_per_slot), np.int32)
            self._write_tables = np.zeros(
                (self.slots, self._pages_per_slot), np.int32)
            # resolved once, at build: a typo fails the constructor, and
            # stats() names the lane that runs
            self.attn_lane = resolve_paged_attn_lane(attn, self.device)
            self._caches = init_paged_caches(
                cfg, self.slots, self.num_pages, self.page_tokens,
                self._pages_per_slot, self.device, cache_dtype)
        else:
            if attn is not None:
                # the lane picks between paged attention programs; the
                # contiguous arena has no page tables to attend through
                raise ValueError(
                    "attn lane selection requires kv_layout='paged' "
                    "(the contiguous arena has no page tables)")
            if prefix_cache:
                raise ValueError(
                    "prefix_cache requires kv_layout='paged' (the "
                    "contiguous arena has no shareable pages)")
            self.attn_lane = None
            self.page_tokens = 0
            self._pages_per_slot = 0
            self.num_pages = 0
            self._caches = init_slot_caches(cfg, self.slots, self.arena_len,
                                            self.device, cache_dtype)
        self._kv_itemsize = self._caches[0].k.element_size()
        self.spec_k = int(spec_k)
        if self.spec_k < 1:
            raise ValueError(f"spec_k must be >= 1, got {self.spec_k}")
        if drafter is not None:
            if not self._paged:
                raise ValueError(
                    "speculative decoding requires kv_layout='paged' (the "
                    "verify step scores K tokens through page tables)")
            if drafter.slots != self.slots:
                raise ValueError(
                    f"drafter has {drafter.slots} slots, scheduler has "
                    f"{self.slots}: they must share the slot numbering")
        self._drafter = drafter
        self._rope = None
        if cfg.pos == "rope":
            # built once per scheduler, on the CPU, then moved
            self._rope = tuple(t.to(self.device) for t in rope_frequencies(
                cfg.head_dim, cfg.max_seq_len, cfg.rope_theta))
        self._slot_seqs: List[Optional[_Seq]] = [None] * self.slots
        self._prefill_rr = 0  # round-robin cursor over prefilling slots
        self._pending: deque = deque()
        self._lock = threading.Lock()
        self._wake = threading.Event()
        self._closed = False
        self._error: Optional[BaseException] = None
        self._n_steps = 0              # plain decode steps + verify rounds
        self._n_plain_steps = 0
        self._n_spec_rounds = 0
        self._n_drafted = 0
        self._n_accepted = 0
        self._n_spec_emitted = 0
        self._spec_seconds = 0.0
        self._draft_seconds = 0.0
        self._verify_seconds = 0.0
        self._n_prefill_chunks = 0
        self._n_admitted = 0
        self._n_retired = 0
        self._n_retired_eos = 0
        self._n_tokens = 0
        self._n_attn_bytes = 0
        self._n_prefix_hit_tokens = 0
        self._n_kernel_launches = 0
        self._decode_seconds = 0.0
        self._admitted_mid_flight = 0
        self._max_active_slots = 0
        self._peak_queue_depth = 0
        self._thread = threading.Thread(
            target=self._run, name="serve-continuous-scheduler", daemon=True)
        self._thread.start()

    # ------------------------------------------------------------- submit

    def max_prompt_len(self, max_new: int) -> int:
        """Longest admissible prompt for a generation budget: the padded
        prefill chunks AND prompt + new tokens must fit the arena. With a
        paged pool smaller than one slot's worst case, the whole pool's
        pages cap one sequence too, so an over-budget request is refused
        at submit, before any page is allocated. With speculation on, a
        verify round near the end of a generation writes up to ``spec_k``
        positions past the final cursor; they are reserved too."""
        c = self.prefill_chunk
        effective = self.arena_len
        if self._paged:
            effective = min(effective,
                            self._arena.usable_pages * self.page_tokens)
        reserve = self.spec_k if self._drafter is not None else 0
        return min((effective // c) * c, effective - max_new - reserve)

    def submit(self, prompt_ids: List[int], *, max_new_tokens: int,
               temperature: float = 0.0, seed: int = 0,
               loop=None, queue=None) -> _Seq:
        """Enqueue a generation. ``("tok", id)``, ``("end", reason)`` or
        ``("err", message)`` events arrive on ``queue`` through
        ``loop.call_soon_threadsafe``. Thread-safe."""
        if not prompt_ids:
            raise ValueError("prompt must be non-empty")
        if max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        if len(prompt_ids) > self.max_prompt_len(max_new_tokens):
            raise ValueError(
                f"prompt of {len(prompt_ids)} tokens + {max_new_tokens} new "
                f"tokens does not fit a {self.arena_len}-token arena slot "
                f"(prefill pads prompts to {self.prefill_chunk}-token "
                f"chunks)")
        seq = _Seq(list(prompt_ids), max_new_tokens, temperature, seed,
                   loop, queue)
        with self._lock:
            if self._closed:
                raise SchedulerClosedError(
                    "scheduler is shut down" if self._error is None
                    else f"scheduler failed: {self._error!r}")
            self._pending.append(seq)
            self._peak_queue_depth = max(self._peak_queue_depth,
                                         len(self._pending))
        self._wake.set()
        return seq

    def cancel(self, seq: _Seq) -> None:
        """Mark a sequence cancelled; its slot retires on the next
        iteration (pending sequences are dropped at admission)."""
        seq.cancelled = True
        self._wake.set()

    # -------------------------------------------------------------- loop

    def _emit(self, seq: _Seq, item) -> None:
        if seq.loop is None or seq.queue is None:
            return
        try:
            seq.loop.call_soon_threadsafe(seq.queue.put_nowait, item)
        except RuntimeError:
            # the consumer's loop is gone: nobody is listening
            seq.cancelled = True

    def _release_slot_resources(self, seq: _Seq) -> None:
        """Paged teardown of one slot: drop the prefix-cache ref, free
        owned pages and zero the page-table rows (an inactive slot then
        touches only page 0)."""
        if not self._paged or seq.slot is None:
            return
        if seq.radix_node is not None:
            self._radix.release(seq.radix_node)
            seq.radix_node = None
        if seq.owned_pages:
            self._arena.free(seq.owned_pages)
            seq.owned_pages = []
        seq.table_fill = 0
        self._read_tables[seq.slot, :] = 0
        self._write_tables[seq.slot, :] = 0

    def _finish(self, seq: _Seq, item) -> None:
        self._release_slot_resources(seq)
        if seq.slot is not None:
            self._slot_seqs[seq.slot] = None
            seq.slot = None
        seq.state = _DONE
        self._n_retired += 1
        self._emit(seq, item)

    def _retire(self, seq: _Seq, reason: str) -> None:
        self._finish(seq, ("end", reason))

    def _fail(self, seq: _Seq, msg: str) -> None:
        self._finish(seq, ("err", msg))

    def _ensure_pages(self, seq: _Seq, upto: int) -> bool:
        """Grow the slot's page table to cover [0, upto) tokens, evicting
        LRU unreferenced prefix-cache nodes under pressure. On exhaustion
        the SEQUENCE fails; the scheduler and other slots keep running."""
        need = -(-upto // self.page_tokens)
        missing = need - seq.table_fill
        if missing <= 0:
            return True
        try:
            pages = self._arena.alloc(missing)
        except OutOfPagesError:
            if self._radix is not None:
                self._radix.evict(missing - self._arena.free_pages)
            try:
                pages = self._arena.alloc(missing)
            except OutOfPagesError:
                self._fail(seq, f"kv arena out of pages (need {missing} "
                                f"more, {self._arena.free_pages} free of "
                                f"{self._arena.usable_pages}; nothing "
                                f"evictable)")
                return False
        slot = seq.slot
        for j, p in enumerate(pages, start=seq.table_fill):
            self._read_tables[slot, j] = p
            self._write_tables[slot, j] = p
        seq.owned_pages.extend(pages)
        seq.table_fill = need
        return True

    def _sample(self, seq: _Seq, logits_row: np.ndarray) -> int:
        if seq.temperature <= 0.0:
            return int(logits_row.argmax())
        if seq.rng is None:
            seq.rng = np.random.default_rng(seq.seed)
        x = np.asarray(logits_row, np.float64) / seq.temperature
        x -= x.max()
        p = np.exp(x)
        p /= p.sum()
        return int(seq.rng.choice(len(p), p=p))

    def _emit_token(self, seq: _Seq, tok: int) -> bool:
        """Record and stream one sampled token; True if the sequence is
        finished (its budget used, or the token is ``eos_id``)."""
        seq.n_generated += 1
        self._n_tokens += 1
        self._emit(seq, ("tok", tok))
        if self.eos_id is not None and tok == self.eos_id:
            return True
        return seq.n_generated >= seq.max_new

    def _retire_finished(self, seq: _Seq, tok: int) -> None:
        """Retire a sequence whose last token ``tok`` finished it."""
        if self.eos_id is not None and tok == self.eos_id:
            self._n_retired_eos += 1
            self._retire(seq, "eos")
        else:
            self._retire(seq, "length")

    def _splice_prefix(self, seq: _Seq) -> None:
        """Prefix-cache lookup at admission: splice the longest cached
        page-aligned prefix of the prompt into the slot's read table (write
        entries stay on the garbage page: shared pages are immutable) and
        jump the cursor past it. The last prompt token is never matched: it
        re-prefills to give the first sampled token's logits. The splice is
        clamped so the remaining tail's padded chunks still fit."""
        pages, matched, node = self._radix.match(seq.prompt[:-1])
        if matched == 0:
            self._radix.note_miss()
            return
        T, C = self.page_tokens, self.prefill_chunk
        keep = matched
        while keep > 0:
            rem = len(seq.prompt) - keep
            if keep + (-(-rem // C)) * C <= self.arena_len:
                break
            keep -= T
        if keep <= 0:
            self._radix.release(node)
            self._radix.note_miss()
            return
        self._radix.note_hit()
        n = keep // T
        self._read_tables[seq.slot, :n] = pages[:n]
        seq.cached_len = keep
        seq.table_fill = n
        seq.radix_node = node
        self._n_prefix_hit_tokens += keep

    def _admit(self) -> None:
        while True:
            with self._lock:
                if not self._pending:
                    break
                free = next((i for i, s in enumerate(self._slot_seqs)
                             if s is None), None)
                if free is None:
                    break
                seq = self._pending.popleft()
            if seq.cancelled:
                self._retire(seq, "cancelled")
                continue
            in_flight = any(s is not None for s in self._slot_seqs)
            seq.slot = free
            seq.state = _PREFILL
            self._slot_seqs[free] = seq
            if self._paged:
                self._read_tables[free, :] = 0
                self._write_tables[free, :] = 0
                if self._radix is not None:
                    self._splice_prefix(seq)
                seq.cursor = seq.cached_len
                seq.remaining_prompt = seq.prompt[seq.cached_len:]
                paged_reset_slot(self._caches, free, seq.cached_len)
            else:
                reset_slot(self._caches, free)
            self._n_admitted += 1
            if in_flight:
                self._admitted_mid_flight += 1

    def _upload(self, a: np.ndarray) -> torch.Tensor:
        return torch.tensor(a, dtype=torch.int32, device=self.device)

    def _record_attn(self, qk: int, n_slots: int,
                     longest: Optional[int] = None) -> None:
        """Account the KV bytes the paged attention lane streamed for one
        attention-bearing program call, from host mirrors alone (cursors,
        table shapes). The gather lane builds a contiguous
        ``[pages_per_slot * page_tokens]`` view per slot and layer however
        little of it is live; the in-place lanes read only the pages that
        cover the longest live sequence."""
        if not self._paged:
            return
        cfg = self.cfg
        T = self.page_tokens
        row = cfg.kv_heads * cfg.head_dim * self._kv_itemsize
        if self.attn_lane == "gather":
            pages = n_slots * self._pages_per_slot
        else:
            if longest is None:
                longest = max((s.cursor for s in self._slot_seqs
                               if s is not None), default=0)
            pages = n_slots * min(-(-(longest + qk) // T),
                                  self._pages_per_slot)
        # k + v pools, every layer: pages read through the table plus the
        # qk freshly written rows per slot
        self._n_attn_bytes += 2 * cfg.num_layers * row * (
            pages * T + n_slots * qk)

    def _prefill_one(self) -> bool:
        """Advance ONE prefilling sequence by one chunk, round-robin over
        slots. Returns True if a chunk ran."""
        start = self._prefill_rr
        for off in range(self.slots):
            i = (start + off) % self.slots
            seq = self._slot_seqs[i]
            if seq is None or seq.state != _PREFILL:
                continue
            self._prefill_rr = (i + 1) % self.slots
            if seq.cancelled:
                self._retire(seq, "cancelled")
                continue
            # pages only up to the REAL tokens of this chunk: pad positions
            # past them land on unallocated entries, i.e. page 0
            if self._paged and not self._ensure_pages(
                    seq, seq.cursor + min(len(seq.remaining_prompt),
                                          self.prefill_chunk)):
                continue
            chunk = seq.remaining_prompt[:self.prefill_chunk]
            seq.remaining_prompt = seq.remaining_prompt[self.prefill_chunk:]
            real = len(chunk)
            padded = chunk + [0] * (self.prefill_chunk - real)
            tokens = self._upload(np.asarray([padded]))
            n0 = paged_attention.launches
            if self._paged:
                logits = paged_prefill_into_slot(
                    self.cfg, self.params, tokens, real, seq.slot,
                    self._upload(self._read_tables[seq.slot]),
                    self._upload(self._write_tables[seq.slot]),
                    self._caches, self._rope, attn=self.attn_lane)
            else:
                logits = prefill_into_slot(self.cfg, self.params, tokens,
                                           real, seq.slot, self._caches)
            row = logits.float().cpu().numpy()
            self._n_kernel_launches += paged_attention.launches - n0
            self._record_attn(self.prefill_chunk, 1, longest=seq.cursor)
            seq.cursor += real
            self._n_prefill_chunks += 1
            if not seq.remaining_prompt:
                if self._radix is not None:
                    self._offer_prompt_pages(seq)
                # prompt resident: sample the first token now (TTFT)
                tok = self._sample(seq, row)
                seq.state = _DECODE
                if self._emit_token(seq, tok):
                    self._retire_finished(seq, tok)
                else:
                    seq.next_token = tok
            return True
        return False

    def _offer_prompt_pages(self, seq: _Seq) -> None:
        """Offer the resident prompt's full pages to the radix cache. Pages
        the tree adopts become shared and read-only (their write-table
        entries go to the garbage page; pads and decode tokens land in
        later pages anyway); spans cached first by another sequence stay
        slot-owned duplicates. The slot swaps its admission-time node ref
        for the deeper inserted node."""
        T = self.page_tokens
        ins_len = (len(seq.prompt) // T) * T
        if ins_len <= seq.cached_len:
            return
        n = ins_len // T
        slot = seq.slot
        offered = [int(x) for x in self._read_tables[slot, :n]]
        dups, node = self._radix.insert(seq.prompt[:ins_len], offered)
        adopted = set(offered) - set(dups)
        if adopted:
            seq.owned_pages = [p for p in seq.owned_pages
                               if p not in adopted]
            for j in range(n):
                if int(self._write_tables[slot, j]) in adopted:
                    self._write_tables[slot, j] = 0
        if node is not None:
            if seq.radix_node is not None:
                self._radix.release(seq.radix_node)
            seq.radix_node = node

    def _decode_once(self) -> bool:
        """One batched decode iteration over every DECODE slot."""
        toks = np.zeros(self.slots, np.int32)
        active = np.zeros(self.slots, np.int32)
        live: List[_Seq] = []
        for i, seq in enumerate(self._slot_seqs):
            if seq is None or seq.state != _DECODE:
                continue
            if seq.cancelled:
                self._retire(seq, "cancelled")
                continue
            if self._paged and not self._ensure_pages(seq, seq.cursor + 1):
                continue
            toks[i] = seq.next_token
            active[i] = 1
            live.append(seq)
        if not live:
            return False
        t0 = time.perf_counter()
        n0 = paged_attention.launches
        if self._paged:
            logits = paged_decode_step(
                self.cfg, self.params, self._upload(toks),
                self._upload(active), self._upload(self._read_tables),
                self._upload(self._write_tables), self._caches, self._rope,
                attn=self.attn_lane)
        else:
            logits = slot_decode_step(self.cfg, self.params,
                                      self._upload(toks),
                                      self._upload(active), self._caches)
        la = logits.float().cpu().numpy()  # waits for the step to finish
        self._n_kernel_launches += paged_attention.launches - n0
        self._decode_seconds += time.perf_counter() - t0
        self._record_attn(1, self.slots)
        self._n_steps += 1
        self._n_plain_steps += 1
        self._max_active_slots = max(self._max_active_slots, len(live))
        for seq in live:
            seq.cursor += 1
            tok = self._sample(seq, la[seq.slot])
            if self._emit_token(seq, tok):
                self._retire_finished(seq, tok)
            else:
                seq.next_token = tok
        return True

    # ------------------------------------------------ speculative decode

    def _prime_drafter(self, seq: _Seq) -> None:
        """First speculative round for a freshly decoding slot: give the
        drafter the sequence's whole context up to the cursor. A drafter
        sharing the target's params ADOPTS the paged KV by a gather
        (prefix splices included); another drafter runs the prompt
        through its own model."""
        if self._drafter.shares_target:
            self._drafter.adopt_from_paged(
                seq.slot, self._caches, self._read_tables[seq.slot],
                int(seq.cursor), self.page_tokens)
        else:
            self._drafter.prefill_prompt(seq.slot, seq.prompt,
                                         self.prefill_chunk)
        seq.drafter_len = int(seq.cursor)
        seq.drafter_pending = []

    def _decode_spec(self) -> bool:
        """One speculative round over every DECODE slot: exactly ``spec_k``
        batched drafter steps propose tokens, ONE ``paged_verify_step``
        scores every proposal, and exact accept-prefix + corrected
        resample emits 1..spec_k+1 tokens per live sequence. Rejections
        rewind CURSORS only (on the host): no page is freed or changed;
        stale KV past a cursor is masked until written over.

        Drafter sync: the drafter always steps ``spec_k`` times, but after
        a fully accepted round it first catches up on the accepted token
        it never consumed (``drafter_pending``), producing one fewer draft
        that round."""
        k = self.spec_k
        K = k + 1
        live: List[_Seq] = []
        for seq in self._slot_seqs:
            if seq is None or seq.state != _DECODE:
                continue
            if seq.cancelled:
                self._retire(seq, "cancelled")
                continue
            # the verify window writes positions [cursor, cursor + K)
            if not self._ensure_pages(seq, seq.cursor + K):
                continue
            live.append(seq)
        if not live:
            return False
        t0 = time.perf_counter()
        for seq in live:
            if seq.drafter_len < 0:
                self._prime_drafter(seq)
        # ---- draft: k batched drafter steps, sampled on the host -------
        feed = {s.slot: list(s.drafter_pending) + [s.next_token]
                for s in live}
        pend0 = {s.slot: list(s.drafter_pending) for s in live}
        drafts: Dict[int, List[int]] = {s.slot: [] for s in live}
        dprobs: Dict[int, List[Any]] = {s.slot: [] for s in live}
        toks = np.zeros(self.slots, np.int32)
        active = np.zeros(self.slots, np.int32)
        for s in live:
            active[s.slot] = 1
        for _ in range(k):
            for s in live:
                sl = s.slot
                toks[sl] = feed[sl].pop(0) if feed[sl] else drafts[sl][-1]
            la = self._drafter.step(toks, active)
            for s in live:
                sl = s.slot
                if feed[sl]:
                    continue  # still catching up; not at the draft frontier
                if s.temperature <= 0.0:
                    d = int(la[sl].argmax())
                else:
                    if s.rng is None:
                        s.rng = np.random.default_rng(s.seed)
                    p = _softmax(la[sl], s.temperature)
                    dprobs[sl].append(p)
                    d = int(s.rng.choice(len(p), p=p))
                drafts[sl].append(d)
        t1 = time.perf_counter()
        # ---- verify: ONE K-token target call over every slot -----------
        vt = np.zeros((self.slots, K), np.int32)
        for s in live:
            row = [s.next_token] + drafts[s.slot]
            vt[s.slot, :len(row)] = row
        n0 = paged_attention.launches
        vlogits = paged_verify_step(
            self.cfg, self.params, self._upload(vt),
            self._upload(self._read_tables), self._upload(self._write_tables),
            self._caches, self._rope, attn=self.attn_lane)
        va = vlogits.float().cpu().numpy()  # waits for the call to finish
        self._n_kernel_launches += paged_attention.launches - n0
        t2 = time.perf_counter()
        self._record_attn(K, self.slots)
        self._n_steps += 1
        self._n_spec_rounds += 1
        self._max_active_slots = max(self._max_active_slots, len(live))
        # ---- exact acceptance + cursor rewind on the host ---------------
        new_lengths = self._caches[0].lengths.cpu().numpy().copy()
        dlen = self._drafter.lengths().copy()
        for s in live:
            sl = s.slot
            ds = drafts[sl]
            old = s.cursor
            nxt = s.next_token
            if s.temperature <= 0.0:
                a, emitted = accept_greedy(ds, va[sl])
            else:
                if s.rng is None:
                    s.rng = np.random.default_rng(s.seed)
                pt = [_softmax(va[sl, j], s.temperature)
                      for j in range(len(ds) + 1)]
                a, emitted = accept_sample(ds, dprobs[sl], pt, s.rng)
            self._n_drafted += len(ds)
            self._n_accepted += a
            new_cursor = old + a + 1
            s.cursor = new_cursor
            new_lengths[sl] = new_cursor
            # drafter sync: positions [L0, L0 + k) were consumed this
            # round; the valid prefix stops at the last accepted position,
            # and the accepted tokens the drafter missed are next round's
            # catch-up feed
            L0 = s.drafter_len
            valid = min(L0 + k, new_cursor)
            hist = pend0[sl] + [nxt] + list(ds[:a])
            s.drafter_pending = hist[valid - L0:new_cursor - L0]
            s.drafter_len = valid
            dlen[sl] = valid
            for tok in emitted:
                s.next_token = tok
                self._n_spec_emitted += 1
                if self._emit_token(s, tok):
                    self._retire_finished(s, tok)
                    break
        paged_rewind_slots(self._caches, new_lengths)
        self._drafter.set_lengths(dlen)
        self._draft_seconds += t1 - t0
        self._verify_seconds += t2 - t1
        self._spec_seconds += time.perf_counter() - t0
        return True

    def _run(self) -> None:
        try:
            if self.device.type == "cuda":
                torch.cuda.set_device(self.device)
            with torch.no_grad():
                while True:
                    with self._lock:
                        if self._closed:
                            break
                    self._admit()
                    did = self._prefill_one()
                    if self._drafter is not None:
                        did = self._decode_spec() or did
                    else:
                        did = self._decode_once() or did
                    if not did:
                        with self._lock:
                            idle = not self._pending and all(
                                s is None or s.cancelled
                                for s in self._slot_seqs)
                            if idle:
                                self._wake.clear()
                        self._wake.wait(timeout=1.0)
        except BaseException as e:  # noqa: BLE001 — crosses to consumers
            self._error = e
            with self._lock:
                self._closed = True
                pending = list(self._pending)
                self._pending.clear()
            for seq in list(self._slot_seqs) + pending:
                if seq is not None:
                    self._fail(seq, f"{type(e).__name__}: {e}")
        finally:
            with self._lock:
                self._closed = True

    # --------------------------------------------------------- lifecycle

    def shutdown(self, timeout_s: float = 5.0) -> None:
        with self._lock:
            if self._closed:
                return
            self._closed = True
            pending = list(self._pending)
            self._pending.clear()
        self._wake.set()
        self._thread.join(timeout=timeout_s)
        for seq in pending + list(self._slot_seqs):
            if seq is not None:
                self._fail(seq, "scheduler shut down")
        if self._radix is not None:
            self._radix.clear()

    @property
    def closed(self) -> bool:
        return self._closed

    def queue_depth(self) -> int:
        """Requests waiting for a free slot."""
        with self._lock:
            return len(self._pending)

    def prefix_digest(self) -> Dict[str, Any]:
        """The radix cache's chain-hash digest, for a router. Read off the
        scheduler's thread, so a rare read during a change of the tree is
        retried rather than locked: the digest is advisory, and a stale
        one costs one cold prefill at most. Empty with the contiguous
        layout or the prefix cache off."""
        if self._radix is None:
            return {}
        for _ in range(8):
            try:
                return self._radix.digest()
            except RuntimeError:
                continue
        return {}

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            q = len(self._pending)
        out = {
            "mode": "continuous",
            "kv_layout": self.kv_layout,
            "slots": self.slots,
            "prefill_chunk": self.prefill_chunk,
            "arena_len": self.arena_len,
            "decode_steps": self._n_steps,
            "decode_seconds": self._decode_seconds,
            "prefill_chunks": self._n_prefill_chunks,
            "admitted": self._n_admitted,
            "retired": self._n_retired,
            "retired_eos": self._n_retired_eos,
            "tokens_generated": self._n_tokens,
            "admitted_mid_flight": self._admitted_mid_flight,
            "max_active_slots": self._max_active_slots,
            "peak_queue_depth": self._peak_queue_depth,
            "queue_depth": q,
            "active_slots": sum(1 for s in self._slot_seqs if s is not None),
            "kernel_launches": self._n_kernel_launches,
        }
        if self._paged:
            out["page_tokens"] = self.page_tokens
            out["pages_per_slot"] = self._pages_per_slot
            out["attn_lane"] = self.attn_lane
            out["attn_bytes_moved"] = self._n_attn_bytes
            out.update(self._arena.stats())
            if self._radix is not None:
                out.update(self._radix.stats())
                out["prefix_hit_tokens"] = self._n_prefix_hit_tokens
        out["plain_decode_steps"] = self._n_plain_steps
        out["verify_rounds"] = self._n_spec_rounds
        if self._drafter is not None:
            out["spec_k"] = self.spec_k
            out["drafter"] = self._drafter.name
            out["spec_rounds"] = self._n_spec_rounds
            out["spec_drafted_tokens"] = self._n_drafted
            out["spec_accepted_tokens"] = self._n_accepted
            out["spec_accept_rate"] = (
                self._n_accepted / self._n_drafted
                if self._n_drafted else 0.0)
            out["spec_tokens_per_step"] = (
                self._n_spec_emitted / self._n_spec_rounds
                if self._n_spec_rounds else 0.0)
            out["spec_seconds"] = self._spec_seconds
            out["spec_draft_seconds"] = self._draft_seconds
            out["spec_verify_seconds"] = self._verify_seconds
            out["drafter_arena_bytes"] = self._drafter.arena_bytes
        return out
