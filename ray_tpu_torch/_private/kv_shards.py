"""Namespace-sharded controller KV.

First step toward a scale-out control plane (ROADMAP item 1): the
controller's internal KV — function table, collective rendezvous, serve
weights claims, PG readiness mirror — is partitioned into N in-process
shards by namespace hash. Each shard owns its table, its own mutation
lock, and its own named WAL stream in the control store
(``gcs_store`` stream ``kv<i>``), so:

  * KV mutations in different shards fsync their WAL frames
    concurrently (the appends run on different executor threads under
    different locks) instead of serializing behind one log;
  * a shard is already a self-contained unit — table + lock + durable
    log — which is exactly the boundary a later PR needs to move shards
    out of the controller process (the reference's Redis-backed GCS
    store client shape, ``redis_store_client.h``).

Routing is a pure function of (namespace, shard count): every key of a
namespace lives in one shard, so ``kv_keys(prefix)`` and the kv_wait
notify path never fan out. Snapshots store the MERGED dict and
redistribute on load, so changing ``controller_kv_shards`` between
controller incarnations is safe.
"""

from __future__ import annotations

import asyncio
import zlib
from typing import Any, Dict, List


def shard_index(ns: str, num_shards: int) -> int:
    """Stable shard routing: crc32 of the namespace (NOT Python's
    ``hash``, which is salted per process — two controller incarnations
    must route identically or recovery would look up the wrong shard)."""
    if num_shards <= 1:
        return 0
    return zlib.crc32(ns.encode("utf-8", "surrogatepass")) % num_shards


class KvShard:
    """One shard: table + mutation lock + WAL stream name."""

    __slots__ = ("index", "stream", "data", "lock")

    def __init__(self, index: int):
        self.index = index
        self.stream = f"kv{index}"
        # ns -> key -> value (same shape the unsharded controller held)
        self.data: Dict[str, Dict[str, Any]] = {}
        self.lock = asyncio.Lock()

    def num_keys(self) -> int:
        return sum(len(d) for d in self.data.values())


class KvShardMap:
    """N in-process KV shards behind the old dict-of-namespaces surface."""

    def __init__(self, num_shards: int = 8):
        if int(num_shards) < 1:
            raise ValueError(
                f"controller_kv_shards must be >= 1, got {num_shards}")
        self.shards: List[KvShard] = [
            KvShard(i) for i in range(int(num_shards))]

    def __len__(self) -> int:
        return len(self.shards)

    def shard_for(self, ns: str) -> KvShard:
        return self.shards[shard_index(ns, len(self.shards))]

    # ---------------------------------------------------------- table access

    def namespace(self, ns: str) -> Dict[str, Any]:
        """The live (mutable) table of one namespace, created on demand —
        the ``kv.setdefault(ns, {})`` shape the controller handlers use."""
        return self.shard_for(ns).data.setdefault(ns, {})

    def peek(self, ns: str) -> Dict[str, Any]:
        """Read-only view of one namespace ({} when absent, NOT created)."""
        return self.shard_for(ns).data.get(ns, {})

    # ------------------------------------------------------ snapshot / load

    def merged(self) -> Dict[str, Dict[str, Any]]:
        """Flat ns->table dict for the controller snapshot: shard-count
        agnostic on disk (a restarted controller with a different shard
        count redistributes on load)."""
        out: Dict[str, Dict[str, Any]] = {}
        for shard in self.shards:
            for ns, table in shard.data.items():
                out[ns] = dict(table)
        return out

    def load(self, merged: Dict[str, Dict[str, Any]]) -> None:
        for shard in self.shards:
            shard.data.clear()
        for ns, table in (merged or {}).items():
            self.shard_for(ns).data[ns] = dict(table)

    # ------------------------------------------------------------- metrics

    def keys_per_shard(self) -> List[int]:
        return [shard.num_keys() for shard in self.shards]

    def total_keys(self) -> int:
        return sum(self.keys_per_shard())

    def num_namespaces(self) -> int:
        return sum(len(shard.data) for shard in self.shards)
