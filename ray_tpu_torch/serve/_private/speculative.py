"""Speculative decoding for the continuous scheduler.

Counterpart: ``ray_tpu/serve/_private/speculative.py``. A drafter model
proposes k tokens per decoding slot; the target model scores all k, plus
the bonus position, in ONE ``paged_verify_step`` call over the slots.
Acceptance is the exact algorithm of arXiv:2211.17192: accept the longest
draft prefix whose tokens survive the q/p coin flips, resample the first
rejection from the corrected distribution max(q - p, 0), and sample the
bonus token from the target when every draft survives. The output
distribution is the target model's, as far as the verify call's logits
are the single-token program's: at temperature 0 the emitted tokens are
the sequential greedy loop's up to the rounding of the verify call's
wider GEMMs (the scheduler's docstring gives the measured gap).

The ``Drafter`` owns a contiguous slot arena (``models/decode.py``
``SlotKVCache``) that mirrors the scheduler's slot numbering. The drafter
``"self"`` shares the target's params: a slot's drafter KV is then ADOPTED
from the target's paged cache by a gather, with no drafter prefill;
another drafter prefills the prompt through its own model. Rejected drafts
rewind cursors only: stale KV past a cursor is masked until written over.

The acceptance functions are numpy on the host, as in JAX, so equal logits
and equal seeds give equal tokens on the CPU and on the card. The counters
``m_spec_drafted`` and ``m_spec_accepted`` (the process's metric registry)
are fed by the scheduler, whose ``stats()`` carries the same counts.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch

from ray_tpu_torch.models.decode import (init_slot_caches,
                                         prefill_into_slot, reset_slot,
                                         slot_decode_step)
from ray_tpu_torch._private.metrics import Counter

m_spec_drafted = Counter(
    "ray_tpu_serve_spec_drafted_tokens_total",
    "Draft tokens proposed by the speculative drafter")
m_spec_accepted = Counter(
    "ray_tpu_serve_spec_accepted_tokens_total",
    "Draft tokens accepted by target-model verification")


def _softmax(logits_row, temperature: float) -> np.ndarray:
    x = np.asarray(logits_row, np.float64) / temperature
    x -= x.max()
    p = np.exp(x)
    return p / p.sum()


def accept_sample(draft_tokens: Sequence[int], p_draft, p_target,
                  rng) -> Tuple[int, List[int]]:
    """Exact speculative acceptance (temperature > 0).

    draft_tokens: the k proposed tokens. p_draft: [k, V] drafter
    probabilities (row j is the distribution d_{j+1} was sampled from).
    p_target: [k+1, V] target probabilities (row j scores position j;
    row k is the bonus distribution valid only when every draft is
    accepted). Returns ``(accepted, emitted)`` where emitted is
    ``drafts[:accepted] + [corrected-or-bonus token]``: always exactly
    one more token than accepted, matching what sequential sampling from
    the target would emit in distribution."""
    k = len(draft_tokens)
    for j in range(k):
        d = int(draft_tokens[j])
        q = float(p_target[j][d])
        p = float(p_draft[j][d])
        if p > 0.0 and rng.uniform() < min(1.0, q / p):
            continue
        resid = np.maximum(np.asarray(p_target[j], np.float64)
                           - np.asarray(p_draft[j], np.float64), 0.0)
        s = resid.sum()
        if s <= 0.0:
            # q == p pointwise (possible up to float round-off): any
            # sample from q is exact
            tok = int(rng.choice(len(resid), p=np.asarray(p_target[j],
                                                          np.float64)
                                 / np.asarray(p_target[j],
                                              np.float64).sum()))
        else:
            tok = int(rng.choice(len(resid), p=resid / s))
        return j, [int(t) for t in draft_tokens[:j]] + [tok]
    pt = np.asarray(p_target[k], np.float64)
    tok = int(rng.choice(len(pt), p=pt / pt.sum()))
    return k, [int(t) for t in draft_tokens] + [tok]


def accept_greedy(draft_tokens: Sequence[int],
                  target_logits) -> Tuple[int, List[int]]:
    """Temperature-0 acceptance: accept the longest prefix where each
    draft equals the target argmax, then emit the target argmax at the
    first divergence (or the bonus argmax after a full accept). Over the
    logits rows the single-token program produces, this is what the
    sequential greedy loop emits, token for token; a verify call's rows
    equal those up to its GEMMs' rounding."""
    k = len(draft_tokens)
    emitted: List[int] = []
    for j in range(k):
        t = int(np.asarray(target_logits[j]).argmax())
        if t != int(draft_tokens[j]):
            return j, emitted + [t]
        emitted.append(t)
    bonus = int(np.asarray(target_logits[k]).argmax())
    return k, emitted + [bonus]


class Drafter:
    """The drafter's model state: params and a contiguous slot arena that
    shares the scheduler's slot numbering. All methods run on the
    scheduler's thread; the arena and its cursors change in place."""

    def __init__(self, cfg, params, *, slots: int, arena_len: int,
                 device: torch.device, name: str = "self",
                 shares_target: bool = False):
        self.cfg = cfg
        self.params = params
        self.name = name
        # True iff ``params`` are the TARGET's params: only then is the
        # target's paged KV the drafter's own and adoption valid
        self.shares_target = shares_target
        self.slots = slots
        self.arena_len = arena_len
        self.device = torch.device(device)
        self._caches = init_slot_caches(cfg, slots, arena_len, self.device)

    @property
    def arena_bytes(self) -> int:
        """Bytes of the drafter's k/v arena, all layers."""
        return sum(c.k.nbytes + c.v.nbytes for c in self._caches)

    # ------------------------------------------------------------ state

    def lengths(self) -> np.ndarray:
        return self._caches[0].lengths.cpu().numpy()

    def set_lengths(self, new_lengths) -> None:
        """Cursor rewind after a verify round (rejected drafts' KV stays,
        masked until written over)."""
        self._caches[0].lengths.copy_(torch.from_numpy(
            np.asarray(new_lengths, np.int32)))

    def reset_slot(self, slot: int) -> None:
        reset_slot(self._caches, slot)

    # ----------------------------------------------------- slot priming

    def adopt_from_paged(self, slot: int, target_caches, read_row,
                         length: int, page_tokens: int) -> None:
        """Prime a slot by copying the target's paged KV for positions
        [0, length) into the drafter's row through the slot's read row.
        Valid ONLY when the drafter shares the target's params: then the
        target's KV is, bit for bit, the KV this drafter would compute."""
        if not self.shares_target:
            raise RuntimeError(
                "adopt_from_paged requires a drafter sharing the target's "
                "params (drafter='self')")
        n_pages = -(-length // page_tokens)
        idx = torch.from_numpy(np.asarray(read_row[:n_pages], np.int64)).to(
            self.device)
        for dc, tc in zip(self._caches, target_caches):
            H, D = tc.k.shape[2:]
            dc.k[slot, :length] = tc.k[idx].reshape(-1, H, D)[:length]
            dc.v[slot, :length] = tc.v[idx].reshape(-1, H, D)[:length]
        self._caches[0].lengths[slot] = length

    def prefill_prompt(self, slot: int, tokens: Sequence[int],
                       chunk: int) -> None:
        """Prime a slot by running the prompt through the DRAFTER model in
        ``chunk``-token pieces (a distinct drafter cannot adopt the
        target's KV: another model, another cache)."""
        self.reset_slot(slot)
        rest = list(tokens)
        while rest:
            piece, rest = rest[:chunk], rest[chunk:]
            real = len(piece)
            padded = torch.tensor([piece + [0] * (chunk - real)],
                                  dtype=torch.int32, device=self.device)
            prefill_into_slot(self.cfg, self.params, padded, real, slot,
                              self._caches)

    # ------------------------------------------------------------- step

    def step(self, tokens: np.ndarray, active: np.ndarray) -> np.ndarray:
        """One batched drafter decode step over all slots. Returns the
        [slots, vocab] logits as float32 numpy (the host samples drafts)."""
        logits = slot_decode_step(
            self.cfg, self.params,
            torch.from_numpy(np.asarray(tokens, np.int32)).to(self.device),
            torch.from_numpy(np.asarray(active, np.int32)).to(self.device),
            self._caches)
        return logits.float().cpu().numpy()
