"""Page-aligned chain hashes of prompt prefixes: the radix cache's digest.

Counterpart: the pure functions of ``ray_tpu/serve/_private/affinity.py``
(``CHAIN_SEED``, ``extend_chain``, ``chain_hashes``, ``prompt_chain``).
The hash at page i is

    h_i = blake2b(h_{i-1} || int32(tokens of page i), digest_size=8)

so ``h_i`` commits to the whole first i pages: one set-membership test of
a prompt's ``h_i`` against a replica's digest is a full prefix comparison
(up to a 64-bit collision, which costs a cold prefill, never a wrong
token). The same bytes as the JAX package's, so the two digests of one
cache are equal. The router side (``AffinityIndex``) and the fleet
metrics come with the runtime.
"""

from __future__ import annotations

import hashlib
from typing import List, Sequence

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
