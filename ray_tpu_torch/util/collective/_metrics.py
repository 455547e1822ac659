"""Shared instrumentation for the host-backend collective data paths.

One definition site for the counters every algorithm (shm / ring / kv)
reports into — keeping the shm and kv paths free of any dependency on
the ring transport module.
"""

from __future__ import annotations

import contextlib
from typing import Dict

from ray_tpu_torch._private import flight
from ray_tpu_torch._private.metrics import Counter, Gauge, Histogram

ops_total = Counter(
    "ray_tpu_collective_ops_total",
    "Collective operations completed in this process, by algo/backend")
bytes_total = Counter(
    "ray_tpu_collective_bytes_total",
    "Collective payload bytes moved by this process, by algo/backend")
chunks_total = Counter(
    "ray_tpu_collective_chunks_total",
    "Collective transfer frames/chunk rounds issued, by algo/backend")
round_seconds = Histogram(
    "ray_tpu_collective_round_seconds",
    "Wall-clock seconds per collective call, by algo")
# ---- async overlap (allreduce_coalesced_async / CollectiveWork) ----
overlap_rounds_total = Counter(
    "ray_tpu_collective_overlap_rounds_total",
    "Bucket rounds reduced by the async overlap runner, by algo/backend "
    "(zero means every coalesced call took the synchronous path)")
wait_seconds = Histogram(
    "ray_tpu_collective_wait_seconds",
    "Wall-clock seconds callers block in CollectiveWork.wait() — compare "
    "against ray_tpu_collective_round_seconds for the overlap fraction")
staging_bytes = Gauge(
    "ray_tpu_collective_staging_bytes",
    "Bytes held in the overlap runner's persistent staging-buffer pool "
    "(flat after warmup = steady state allocates nothing)")
staging_allocs_total = Counter(
    "ray_tpu_collective_staging_allocs_total",
    "Staging buffer allocations by the overlap runner (stops moving once "
    "the pool serves every bucket)")


def labels(algo: str) -> Dict[str, str]:
    return {"algo": algo, "backend": "host"}


_flight_round_ids: Dict[str, int] = {}


@contextlib.contextmanager
def round_timer(algo: str):
    """``round_seconds`` histogram + a per-algo flight-recorder span
    (``col.shm_round`` / ``col.ring_round`` / ``col.kv_round``) around one
    collective call — the histogram averages, the span shows WHERE in the
    iteration the round sat."""
    nid = _flight_round_ids.get(algo)
    if nid is None:
        nid = flight.intern(f"col.{algo}_round")
        _flight_round_ids[algo] = nid
    t0 = flight.now()
    try:
        with round_seconds.time(labels={"algo": algo}):
            yield
    finally:
        # record failed rounds too (the histogram does): a round that
        # times out on peer death is the stall the timeline is FOR
        flight.span_since(nid, t0)
