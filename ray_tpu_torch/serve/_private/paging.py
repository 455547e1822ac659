"""Paged KV arena allocator and prefix/radix cache.

Counterpart: ``ray_tpu/serve/_private/paging.py`` (``PageArena``,
``RadixCache``), with its flight instants (``serve.prefix_hit``,
``serve.page_alloc``, ``serve.evict``) and its counters and gauge in the
process's metric registry.

  * ``PageArena``: a free-list allocator over the fixed pool of
    ``page_tokens``-sized KV pages. Page 0 is RESERVED as the garbage page.
  * ``RadixCache``: a radix tree over PROMPT token prefixes whose nodes
    reference refcounted read-only pages. Admitting a request whose prompt
    shares a cached prefix becomes a page-table splice plus a cursor jump
    instead of a re-prefill. Every node covers a whole number of pages, so
    a partial match splits an edge at a page boundary. Eviction is LRU over
    refcount-0 leaves under arena pressure. Each node carries the chain
    hash of every page it holds (``affinity.chain_hashes``), and the cache
    keeps a digest of the resident hashes up to date at insert and evict
    (a split keeps the set as it is), for a router to steer prompts by.

Both are single-thread structures: the continuous scheduler touches them
only from its own loop thread.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Tuple

from ray_tpu_torch._private import flight
from ray_tpu_torch._private.metrics import Counter, Gauge
from ray_tpu_torch.serve._private.affinity import CHAIN_SEED, chain_hashes

F_PREFIX_HIT = flight.intern("serve.prefix_hit")
F_PAGE_ALLOC = flight.intern("serve.page_alloc")
F_EVICT = flight.intern("serve.evict")

m_prefix_hits = Counter(
    "ray_tpu_serve_prefix_hits_total",
    "Admissions that spliced a cached KV prefix instead of re-prefilling")
m_prefix_misses = Counter(
    "ray_tpu_serve_prefix_misses_total",
    "Admissions that found no cached prefix (cold prefill)")
m_pages_allocated = Counter(
    "ray_tpu_serve_kv_pages_allocated_total",
    "KV pages handed out by the paged arena")
m_pages_freed = Counter(
    "ray_tpu_serve_kv_pages_freed_total",
    "KV pages returned to the paged arena free list")
m_pages_in_use = Gauge(
    "ray_tpu_serve_kv_pages_in_use",
    "KV pages currently allocated (slot-owned + prefix-cache resident)")

GARBAGE_PAGE = 0


class OutOfPagesError(RuntimeError):
    """The arena has no free page and nothing evictable remains."""


class PageArena:
    """Free-list allocator over the paged KV pool. Page ids index the
    ``PagedKVCache`` pools; page 0 never leaves the allocator."""

    def __init__(self, num_pages: int, page_tokens: int):
        if page_tokens < 1:
            raise ValueError(
                f"page_tokens must be >= 1, got {page_tokens}")
        if num_pages < 2:
            raise ValueError(
                f"kv arena needs >= 2 pages (page 0 is reserved), "
                f"got {num_pages}")
        self.num_pages = num_pages
        self.page_tokens = page_tokens
        # LIFO free list: recently freed pages are reused first (their
        # content is dead: cursors never read past a slot's own writes)
        self._free: List[int] = list(range(num_pages - 1, 0, -1))
        # outstanding ids: a double free or a foreign id would hand one
        # physical page to two slots, so the free site fails loudly
        self._outstanding: set = set()
        self._allocated_total = 0
        self._freed_total = 0
        self._peak_in_use = 0

    @property
    def usable_pages(self) -> int:
        return self.num_pages - 1

    @property
    def free_pages(self) -> int:
        return len(self._free)

    @property
    def pages_in_use(self) -> int:
        return self.usable_pages - len(self._free)

    def alloc(self, n: int) -> List[int]:
        """Allocate ``n`` pages or raise ``OutOfPagesError`` allocating
        none (the caller retries after eviction)."""
        if n <= 0:
            return []
        if len(self._free) < n:
            raise OutOfPagesError(
                f"kv arena out of pages: need {n}, "
                f"{len(self._free)} free of {self.usable_pages}")
        pages = [self._free.pop() for _ in range(n)]
        self._outstanding.update(pages)
        self._allocated_total += n
        self._peak_in_use = max(self._peak_in_use, self.pages_in_use)
        m_pages_allocated.inc(n)
        m_pages_in_use.set(float(self.pages_in_use))
        flight.instant(F_PAGE_ALLOC, n)
        return pages

    def free(self, pages: List[int]) -> None:
        for p in pages:
            if p == GARBAGE_PAGE:
                raise ValueError("page 0 is reserved and never allocated")
            if p not in self._outstanding:
                raise ValueError(
                    f"page {p} freed while not allocated (double free or "
                    f"foreign id): it would alias two sequences' KV")
            self._outstanding.discard(p)
            self._free.append(p)
        if pages:
            self._freed_total += len(pages)
            m_pages_freed.inc(len(pages))
            m_pages_in_use.set(float(self.pages_in_use))

    def stats(self) -> Dict[str, int]:
        return {
            "num_pages": self.num_pages,
            "usable_pages": self.usable_pages,
            "pages_in_use": self.pages_in_use,
            "pages_free": len(self._free),
            "pages_allocated_total": self._allocated_total,
            "pages_freed_total": self._freed_total,
            "peak_pages_in_use": self._peak_in_use,
        }


class _RadixNode:
    __slots__ = ("tokens", "pages", "children", "parent", "refs",
                 "last_used", "hashes")

    def __init__(self, tokens: Tuple[int, ...], pages: List[int],
                 parent: Optional["_RadixNode"],
                 hashes: Optional[List[int]] = None):
        self.tokens = tokens          # this EDGE's token span
        self.pages = pages            # pages backing exactly that span
        self.children: Dict[int, "_RadixNode"] = {}  # first token -> child
        self.parent = parent
        self.refs = 0                 # live slots holding this node
        self.last_used = 0.0
        # per-page chain hashes, parallel to ``pages``: hashes[i] commits
        # to the whole root path through page i; a split slices them
        self.hashes: List[int] = hashes if hashes is not None else []

    def chain_end(self) -> int:
        """The chain value new children extend from."""
        return self.hashes[-1] if self.hashes else CHAIN_SEED


class RadixCache:
    """Radix tree over prompt prefixes; nodes own read-only pages.

    Refcounting: ``match``/``insert`` return the deepest node on the path
    with ``refs`` already incremented; the caller MUST ``release`` it when
    the sequence retires. A node is evictable iff it is a leaf with
    refs == 0.
    """

    def __init__(self, arena: PageArena, clock=time.monotonic):
        self.arena = arena
        self.page_tokens = arena.page_tokens
        self._root = _RadixNode((), [], None)
        self._clock = clock
        self._hits = 0
        self._misses = 0
        self._evicted_pages = 0
        # the digest: a count per resident chain hash (a hash evicted and
        # inserted again must not flicker) and a version stamp
        self._digest: Dict[int, int] = {}
        self._digest_version = 0

    def match(self, tokens: List[int]) -> Tuple[List[int], int,
                                                Optional[_RadixNode]]:
        """Longest cached page-aligned prefix of ``tokens``: (pages,
        matched_len, node), node ref-counted (None for no match). A partial
        edge match splits the edge at the page boundary. The caller records
        the hit or miss with ``note_hit``/``note_miss``, after any clamp."""
        now = self._clock()
        node = self._root
        pages: List[int] = []
        matched = 0
        rest = tokens
        while rest:
            child, n = self._advance(node, rest, now)
            if n == 0:
                break
            pages.extend(child.pages)
            matched += n
            rest = rest[n:]
            node = child
        if node is self._root:
            return [], 0, None
        node.refs += 1
        return pages, matched, node

    def note_hit(self, matched_tokens: int) -> None:
        """Record an admission that spliced a cached prefix (after any
        clamp: only an avoided prefill counts)."""
        self._hits += 1
        m_prefix_hits.inc()
        flight.instant(F_PREFIX_HIT, matched_tokens)

    def note_miss(self) -> None:
        self._misses += 1
        m_prefix_misses.inc()

    def _advance(self, node: _RadixNode, rest: List[int], now: float
                 ) -> Tuple[Optional[_RadixNode], int]:
        """One descent step shared by ``match`` and ``insert``: find the
        child edge for ``rest``, page-align the shared length, split the
        edge there and stamp its LRU time. n == 0 means no child, or a
        collision with no full shared page (whose LRU stamp is then NOT
        refreshed)."""
        child = node.children.get(rest[0])
        if child is None:
            return None, 0
        span = child.tokens
        n = 0
        limit = min(len(span), len(rest))
        while n < limit and span[n] == rest[n]:
            n += 1
        n = (n // self.page_tokens) * self.page_tokens
        if n == 0:
            return child, 0
        child.last_used = now
        if n < len(span):
            child = self._split(child, n)
            child.last_used = now
        return child, n

    def _split(self, node: _RadixNode, at: int) -> _RadixNode:
        """Split ``node``'s edge after ``at`` tokens (a page multiple);
        returns the new upper node. The lower half keeps the children and
        the refs."""
        T = self.page_tokens
        upper = _RadixNode(tuple(node.tokens[:at]), node.pages[: at // T],
                           node.parent, hashes=node.hashes[: at // T])
        upper.last_used = node.last_used
        node.parent.children[upper.tokens[0]] = upper
        lower_tokens = tuple(node.tokens[at:])
        node.tokens = lower_tokens
        node.pages = node.pages[at // T:]
        # the hashes commit to the whole root path: the split moves them,
        # the digest's set is unchanged
        node.hashes = node.hashes[at // T:]
        node.parent = upper
        upper.children[lower_tokens[0]] = node
        return upper

    def insert(self, tokens: List[int], pages: List[int]
               ) -> Tuple[List[int], Optional[_RadixNode]]:
        """Offer the pages backing ``tokens`` (page-aligned length). Spans
        already cached keep their EXISTING pages; the novel suffix's pages
        are adopted. Returns (duplicate_pages, node): the caller's pages
        NOT adopted and the deepest node of the path, ref-counted."""
        T = self.page_tokens
        if len(tokens) % T != 0 or len(tokens) // T != len(pages):
            raise ValueError(
                f"insert span must be page-aligned: {len(tokens)} tokens, "
                f"{len(pages)} pages, page_tokens={T}")
        now = self._clock()
        node = self._root
        rest = list(tokens)
        rest_pages = list(pages)
        duplicates: List[int] = []
        while rest:
            child, n = self._advance(node, rest, now)
            if child is None:
                new = _RadixNode(
                    tuple(rest), rest_pages, node,
                    hashes=chain_hashes(rest, T, seed=node.chain_end()))
                new.last_used = now
                node.children[rest[0]] = new
                self._digest_add(new.hashes)
                node = new
                rest, rest_pages = [], []
                break
            if n == 0:
                # same first token but no full shared page: the cache keeps
                # the incumbent
                duplicates.extend(rest_pages)
                rest, rest_pages = [], []
                break
            duplicates.extend(rest_pages[: n // T])
            rest = rest[n:]
            rest_pages = rest_pages[n // T:]
            node = child
        duplicates.extend(rest_pages)
        if node is self._root:
            return duplicates, None
        node.refs += 1
        return duplicates, node

    def release(self, node: Optional[_RadixNode]) -> None:
        if node is not None:
            if node.refs <= 0:
                raise RuntimeError("radix node released more times than "
                                   "matched")
            node.refs -= 1

    def evict(self, need_pages: int) -> int:
        """Free LRU refcount-0 leaves until ``need_pages`` pages went back
        to the arena (or nothing evictable remains). Returns pages freed."""
        freed = 0
        while freed < need_pages:
            candidates = []
            stack = [self._root]
            while stack:
                n = stack.pop()
                for c in n.children.values():
                    if not c.children and c.refs == 0:
                        candidates.append(c)
                    else:
                        stack.append(c)
            if not candidates:
                break
            candidates.sort(key=lambda c: c.last_used)
            for victim in candidates:
                if freed >= need_pages:
                    break
                victim.parent.children.pop(victim.tokens[0])
                self._digest_remove(victim.hashes)
                self.arena.free(victim.pages)
                flight.instant(F_EVICT, len(victim.pages))
                freed += len(victim.pages)
                self._evicted_pages += len(victim.pages)
        return freed

    def clear(self) -> int:
        """Drop every unreferenced node. Returns pages freed."""
        return self.evict(1 << 30)

    def _digest_add(self, hashes: List[int]) -> None:
        for h in hashes:
            self._digest[h] = self._digest.get(h, 0) + 1
        if hashes:
            self._digest_version += 1

    def _digest_remove(self, hashes: List[int]) -> None:
        for h in hashes:
            n = self._digest.get(h, 0) - 1
            if n <= 0:
                self._digest.pop(h, None)
            else:
                self._digest[h] = n
        if hashes:
            self._digest_version += 1

    def digest(self) -> Dict:
        """Every resident page-boundary chain hash and a version stamp,
        kept up to date by insert, evict and split: a copy of the keys,
        cheap at poll rates."""
        return {
            "page_tokens": self.page_tokens,
            "hashes": list(self._digest.keys()),
            "version": self._digest_version,
        }

    def _walk_totals(self) -> Tuple[int, int, int]:
        """(nodes, resident_pages, active_refs) in one tree walk."""
        nodes, pages, refs = -1, 0, 0  # -1: exclude the root sentinel
        stack = [self._root]
        while stack:
            n = stack.pop()
            nodes += 1
            pages += len(n.pages)
            refs += n.refs
            stack.extend(n.children.values())
        return nodes, pages, refs

    def resident_pages(self) -> int:
        return self._walk_totals()[1]

    def active_refs(self) -> int:
        return self._walk_totals()[2]

    def node_count(self) -> int:
        return self._walk_totals()[0]

    def stats(self) -> Dict[str, int]:
        nodes, pages, refs = self._walk_totals()
        hits, misses = self._hits, self._misses
        return {
            "prefix_hits": hits,
            "prefix_misses": misses,
            "prefix_hit_rate": round(hits / max(hits + misses, 1), 4),
            "radix_nodes": nodes,
            "radix_resident_pages": pages,
            "radix_active_refs": refs,
            "evicted_pages_total": self._evicted_pages,
        }
