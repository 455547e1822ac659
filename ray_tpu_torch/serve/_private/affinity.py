"""Prefix-affinity routing: page-aligned chain hashes of prompt prefixes,
the router's view of every replica's digest, and the fleet counters.

Counterpart: ``ray_tpu/serve/_private/affinity.py``. The hash at page i is

    h_i = blake2b(h_{i-1} || int32(tokens of page i), digest_size=8)

so ``h_i`` commits to the whole first i pages: one set-membership test of
a prompt's ``h_i`` against a replica's digest is a full prefix comparison
(up to a 64-bit collision, which costs a cold prefill, never a wrong
token). The same bytes as the JAX package's, so the two digests of one
cache are equal.

``AffinityIndex`` is the router's side: the controller relays each
replica's digest from the stats it already polls, and the router steers
a prompt to the replica holding the deepest match, unless that replica
is fail-marked or its in-flight count exceeds the least-loaded one's by
more than the skew bound. Then the router falls back to pow-2 choice and
hands the chosen replica a ``_fleet_hint`` naming the holder, so it can
pull the pages itself (never through the controller).
"""

from __future__ import annotations

import hashlib
from typing import Dict, List, Optional, Sequence, Tuple

from ray_tpu_torch._private.metrics import Counter

m_affinity_hits = Counter(
    "ray_tpu_serve_fleet_affinity_hits_total",
    "Router picks steered to a replica holding the prompt's prefix")
m_affinity_misses = Counter(
    "ray_tpu_serve_fleet_affinity_misses_total",
    "Router picks that fell back to pow-2 (no digest match, load skew, "
    "or fail-marked holder)")
m_migrations = Counter(
    "ray_tpu_serve_fleet_migrations_total",
    "Cross-replica prefix page pulls completed (spliced into the puller)")
m_migrated_pages = Counter(
    "ray_tpu_serve_fleet_migrated_pages_total",
    "KV pages copied between replicas by completed migrations")

# the hash "before page 0": any fixed 8 bytes; zeros keep digests
# reproducible across processes
CHAIN_SEED = 0
_DIGEST_SIZE = 8


def extend_chain(prev: int, span: Sequence[int]) -> int:
    """One chain step: fold one page's tokens onto the running hash."""
    h = hashlib.blake2b(
        prev.to_bytes(_DIGEST_SIZE, "little")
        + b"".join(int(t).to_bytes(4, "little", signed=True) for t in span),
        digest_size=_DIGEST_SIZE)
    return int.from_bytes(h.digest(), "little")


def chain_hashes(tokens: Sequence[int], page_tokens: int,
                 seed: int = CHAIN_SEED) -> List[int]:
    """Chain hash at every page boundary of ``tokens`` (a trailing partial
    page is dropped: digests are page-aligned like the radix tree).
    tokens of d full pages -> [h_1 .. h_d]."""
    if page_tokens < 1:
        raise ValueError(f"page_tokens must be >= 1, got {page_tokens}")
    out: List[int] = []
    prev = seed
    full = (len(tokens) // page_tokens) * page_tokens
    for i in range(0, full, page_tokens):
        prev = extend_chain(prev, tokens[i:i + page_tokens])
        out.append(prev)
    return out


def prompt_chain(prompt_ids: Sequence[int], page_tokens: int) -> List[int]:
    """Chain hashes of the routable prefix of a prompt. The last prompt
    token is never cached (admission matches ``prompt[:-1]``), so a router
    hashes the same clipped span."""
    return chain_hashes(prompt_ids[:len(prompt_ids) - 1], page_tokens)


class AffinityIndex:
    """Router-side view of every replica's prefix digest.

    ``update`` takes the controller's ``listen_for_digests`` payload
    (replica key -> digest dict as ``RadixCache.digest`` makes it, plus
    the replica's tokenizer kind and vocabulary); ``steer`` answers the
    per-pick question: which replica key holds the deepest page-aligned
    match for this prompt chain, and how deep. All methods are cheap
    dict and set work: the router calls them under its lock."""

    def __init__(self):
        self._sets: Dict[str, frozenset] = {}
        self._page_tokens: Optional[int] = None
        self._vocab_size: Optional[int] = None
        self._tok: str = ""
        self.version: int = -1

    def update(self, payload: Dict) -> None:
        """payload: {"version": int, "digests": {key: digest-dict}}, each
        digest-dict carrying page_tokens, vocab_size, tok and hashes."""
        sets: Dict[str, frozenset] = {}
        for key, d in (payload.get("digests") or {}).items():
            if not d:
                continue
            self._page_tokens = d.get("page_tokens", self._page_tokens)
            self._vocab_size = d.get("vocab_size", self._vocab_size)
            self._tok = d.get("tok", self._tok)
            sets[key] = frozenset(d.get("hashes") or ())
        self._sets = sets
        self.version = payload.get("version", self.version)

    @property
    def page_tokens(self) -> Optional[int]:
        return self._page_tokens

    def ready(self) -> bool:
        return self._page_tokens is not None and bool(self._sets)

    def tokenize(self, prompt: str) -> Optional[List[int]]:
        """Router-side tokenization for steering. Only the byte tokenizer
        is reproducible outside the replica; a request under any other
        tokenizer is steerable only with explicit ``prompt_ids``."""
        if self._tok != "byte" or self._vocab_size is None:
            return None
        v = self._vocab_size
        return [b % v for b in prompt.encode("utf-8")]

    def chain_for(self, prompt: str = "",
                  prompt_ids: Optional[Sequence[int]] = None) -> List[int]:
        if not self.ready():
            return []
        ids = list(prompt_ids) if prompt_ids is not None else (
            self.tokenize(prompt))
        if not ids:
            return []
        return prompt_chain(ids, self._page_tokens)

    def depth(self, key: str, chain: Sequence[int]) -> int:
        """Pages of ``chain`` the replica ``key`` holds: the deepest i with
        chain[i-1] present (a chain hash commits to the whole prefix, so
        the scan from the deep end is exact)."""
        s = self._sets.get(key)
        if not s:
            return 0
        for i in range(len(chain), 0, -1):
            if chain[i - 1] in s:
                return i
        return 0

    def steer(self, chain: Sequence[int], keys: Sequence[str]
              ) -> Tuple[Optional[str], int]:
        """(holder_key, depth_pages) of the deepest match among ``keys``,
        or (None, 0) when no replica holds even one page."""
        best_key, best_depth = None, 0
        for key in keys:
            d = self.depth(key, chain)
            if d > best_depth:
                best_key, best_depth = key, d
        return best_key, best_depth

    def stats(self) -> Dict[str, int]:
        return {
            "replicas": len(self._sets),
            "hashes": sum(len(s) for s in self._sets.values()),
            "version": self.version,
        }
