"""On-demand live profiling of running workers.

The reference attaches py-spy/memray to worker PIDs from the dashboard
agent (`dashboard/modules/reporter/reporter_agent.py:391`). Here the
collectors run IN-PROCESS, served by the worker's own RPC loop — no
external profiler binary, no ptrace capability needed, and the `device`
kind reports what a GPU operator actually asks first ("what is holding
device memory?"), which a generic sampling profiler can't see:

- ``stack``:  every thread's current Python stack (sys._current_frames)
- ``memory``: RSS/peak + gc stats + largest tracemalloc allocations
  (tracemalloc starts on first request; subsequent calls diff against a
  live trace)
- ``device``: per-card bytes held by torch's caching allocator
  (``torch.cuda.memory_stats``: allocated, reserved, peak, live
  allocations)

All three return plain dicts, served by the worker's ``profile`` RPC.
"""

from __future__ import annotations

import gc
import os
import sys
import threading
import traceback
from typing import Any, Dict

_tracemalloc_started = False


def collect(kind: str, limit: int = 20) -> Dict[str, Any]:
    if kind == "stack":
        return collect_stacks()
    if kind == "memory":
        return collect_memory(limit)
    if kind == "device":
        return collect_device(limit)
    raise ValueError(f"unknown profile kind {kind!r} "
                     "(expected stack|memory|device)")


def collect_stacks() -> Dict[str, Any]:
    names = {t.ident: t.name for t in threading.enumerate()}
    out = {}
    for ident, frame in sys._current_frames().items():
        out[f"{names.get(ident, '?')}-{ident}"] = traceback.format_stack(
            frame)
    return {"pid": os.getpid(), "threads": out}


def collect_memory(limit: int = 20) -> Dict[str, Any]:
    global _tracemalloc_started
    import tracemalloc

    if not _tracemalloc_started:
        tracemalloc.start()
        _tracemalloc_started = True
        first = True
    else:
        first = False
    rss = peak = None
    try:
        with open(f"/proc/{os.getpid()}/status") as f:
            for line in f:
                if line.startswith("VmRSS"):
                    rss = int(line.split()[1]) * 1024
                elif line.startswith("VmHWM"):
                    peak = int(line.split()[1]) * 1024
    except OSError:
        pass
    top = []
    if not first:  # a just-started trace has nothing attributed yet
        snap = tracemalloc.take_snapshot()
        for stat in snap.statistics("lineno")[:limit]:
            top.append({"site": str(stat.traceback[0]),
                        "bytes": stat.size, "count": stat.count})
    return {
        "pid": os.getpid(),
        "rss_bytes": rss,
        "peak_rss_bytes": peak,
        "gc_objects": len(gc.get_objects()),
        "gc_counts": gc.get_count(),
        "tracemalloc_top": top,
        "tracemalloc_warming_up": first,
    }


def collect_device(limit: int = 20) -> Dict[str, Any]:
    """Per-card memory of this process's caching allocator. ``limit`` is
    taken for the other collectors' signature; the allocator's stats have
    no per-tensor breakdown to cut."""
    # do not DRAG torch in (or initialize CUDA) just to say "none"
    torch = sys.modules.get("torch")
    if torch is None or not torch.cuda.is_initialized():
        return {"pid": os.getpid(), "cuda_initialized": False,
                "devices": {}}
    per_device: Dict[str, Dict[str, Any]] = {}
    for i in range(torch.cuda.device_count()):
        st = torch.cuda.memory_stats(i)
        per_device[f"cuda:{i}"] = {
            "name": torch.cuda.get_device_name(i),
            "allocated_bytes": int(st.get("allocated_bytes.all.current", 0)),
            "reserved_bytes": int(st.get("reserved_bytes.all.current", 0)),
            "peak_allocated_bytes": int(
                st.get("allocated_bytes.all.peak", 0)),
            "allocations": int(st.get("allocation.all.current", 0)),
        }
    return {"pid": os.getpid(), "cuda_initialized": True,
            "devices": per_device}
