"""Flight recorder: always-on, in-band span timing for the zero-RPC data
plane, drained out-of-band.

The steady-state hot loops this framework exists for — 1F1B stage loops,
continuous-batching iterations, collective rounds, Sebulba ranks — issue
ZERO control-plane RPCs, so the task-event timeline never sees them, and
the span tracer (`util/tracing.py`) pays a lock + ``json.dumps`` + file
write per span, unusable at per-microbatch rates. This module is the
dashboard/reporter + timeline layer those loops can afford:

  * Each thread records into its OWN fixed-size ring buffer of packed
    20-byte binary records — no locks, no allocation, no syscalls on the
    record path (one ``perf_counter_ns`` read + one ``pack_into``).
    Wrapping overwrites the oldest records; the drop count is reported.
  * Names are interned once per process into a u16 table; hot sites hold
    the integer id (``_F_X = flight.intern("...")`` at module import).
  * Recording NEVER issues an RPC: the existing zero-RPC counter proofs
    hold with the recorder on, by construction.
  * Draining is out-of-band: a ``flight_dump`` RPC registered on every
    worker/supervisor/controller core snapshots the rings without
    stalling the recording threads (a seqlock-style count-copy-count
    window excludes records torn by concurrent writes), and
    ``ray_tpu_torch.util.state.flight_timeline(path)`` fans the drain out,
    aligns clocks across hosts (monotonic->wall anchor per process +
    an RTT/2-corrected wall-offset handshake per node) and merges
    everything into one Chrome-trace/Perfetto JSON.

Record layout (little-endian, 20 bytes):
    [t_ns u64][arg u64][name_id u16][kind u8][reserved u8]
Kinds: BEGIN/END (nesting duration events), INSTANT (point + arg),
SPAN (t_ns = end, arg = duration ns — one record per completed wait),
COUNTER (arg = value; rendered as a Perfetto counter track).

Knobs: ``RAY_TPU_TORCH_FLIGHT_ENABLED`` (default on), and
``RAY_TPU_TORCH_FLIGHT_BUFFER_RECORDS`` (per-thread ring capacity).
"""

from __future__ import annotations

import os
import struct
import threading
import time
from typing import Any, Dict, Iterable, List, Optional, Tuple

_REC = struct.Struct("<QQHBB")
REC_SIZE = _REC.size  # 20

BEGIN, END, INSTANT, SPAN, COUNTER = 0, 1, 2, 3, 4

# ------------------------------------------------------------ configuration


def _env_bool(name: str, default: bool) -> bool:
    raw = os.environ.get(name)
    if raw is None:
        return default
    return raw.lower() in ("1", "true", "yes", "on")


_enabled: bool = _env_bool("RAY_TPU_TORCH_FLIGHT_ENABLED", True)
try:
    _cap: int = max(64, int(os.environ.get(
        "RAY_TPU_TORCH_FLIGHT_BUFFER_RECORDS", "16384")))
except ValueError:
    _cap = 16384
_role: str = "process"


def is_enabled() -> bool:
    return _enabled


def configure(enabled: Optional[bool] = None,
              records: Optional[int] = None) -> None:
    """Flip the recorder / resize NEW rings (existing rings keep their
    capacity). Tests and the overhead probe use this; production control
    is the ``RAY_TPU_TORCH_FLIGHT_*`` env knobs."""
    global _enabled, _cap
    if enabled is not None:
        _enabled = bool(enabled)
    if records is not None:
        if int(records) < 1:
            raise ValueError(f"flight ring needs >= 1 record, got {records}")
        _cap = int(records)


def set_role(role: str) -> None:
    """Stamp this process's role (driver/worker/supervisor/controller)
    into its dumps so the merged timeline can group rows."""
    global _role
    _role = str(role)


# ------------------------------------------------------------- name intern

_names: List[str] = []
_name_ids: Dict[str, int] = {}
_intern_lock = threading.Lock()


def intern(name: str) -> int:
    """Process-wide u16 id for ``name`` (stable for the process's life).
    Hot sites call this once at import and record with the integer."""
    nid = _name_ids.get(name)  # racy read is safe: ids are append-only
    if nid is not None:
        return nid
    with _intern_lock:
        nid = _name_ids.get(name)
        if nid is None:
            if len(_names) >= 0xFFFF:
                return 0xFFFF  # table full: degrade to a catch-all id
            nid = len(_names)
            _names.append(name)
            _name_ids[name] = nid
        return nid


# ------------------------------------------------------------ ring buffers


class _Ring:
    """One thread's fixed-size record ring. Only the owning thread writes;
    drainers read ``count`` around a buffer copy to bound torn records."""

    __slots__ = ("buf", "cap", "count", "tid", "name", "owner")

    def __init__(self, cap: int, tid: int, name: str,
                 owner: "weakref.ref[threading.Thread]"):
        self.buf = bytearray(cap * REC_SIZE)
        self.cap = cap
        self.count = 0
        self.tid = tid
        self.name = name
        self.owner = owner  # weakref: a ring must not pin its Thread

    def dead(self) -> bool:
        t = self.owner()
        return t is None or not t.is_alive()


_tls = threading.local()
_rings: List[_Ring] = []
_rings_lock = threading.Lock()


def _new_ring() -> _Ring:
    import weakref

    t = threading.current_thread()
    ring = _Ring(_cap, t.ident or 0, t.name, weakref.ref(t))
    with _rings_lock:
        # prune rings of exited threads here (the only place the ring
        # list grows): a process cycling short-lived recording threads
        # must not accrete one ~cap*20B buffer per dead thread, nor ship
        # them in every drain forever. A dead thread's last records stay
        # drainable until the NEXT recording thread starts.
        _rings[:] = [r for r in _rings if not r.dead()]
        _rings.append(ring)
    _tls.ring = ring
    return ring


# The record functions below inline the ring write (no helper-call hop)
# and bind their C dependencies as defaults: at per-microbatch rates the
# per-record Python overhead IS the product's overhead budget, so every
# global lookup on this path is spent twice per channel op.
_U64MASK = 0xFFFFFFFFFFFFFFFF


def _record(name_id: int, kind: int, t_ns: int, arg: int,
            _pack=_REC.pack_into) -> None:
    ring = getattr(_tls, "ring", None)
    if ring is None:
        ring = _new_ring()
    i = ring.count
    _pack(ring.buf, (i % ring.cap) * REC_SIZE,
          t_ns, arg & _U64MASK, name_id, kind, 0)
    ring.count = i + 1


# ------------------------------------------------------------- record API


def now(_pcn=time.perf_counter_ns) -> int:
    """Span start stamp: ``perf_counter_ns`` when recording, else 0 (the
    matching ``span_since`` then no-ops — two cheap calls per wait)."""
    return _pcn() if _enabled else 0


def begin(name_id: int, _pcn=time.perf_counter_ns) -> None:
    if _enabled:
        _record(name_id, BEGIN, _pcn(), 0)


def end(name_id: int, _pcn=time.perf_counter_ns) -> None:
    if _enabled:
        _record(name_id, END, _pcn(), 0)


def instant(name_id: int, arg: int = 0, _pcn=time.perf_counter_ns,
            _pack=_REC.pack_into) -> None:
    if not _enabled:
        return
    ring = getattr(_tls, "ring", None)
    if ring is None:
        ring = _new_ring()
    i = ring.count
    _pack(ring.buf, (i % ring.cap) * REC_SIZE,
          _pcn(), arg & _U64MASK, name_id, INSTANT, 0)
    ring.count = i + 1


def counter(name_id: int, value: int) -> None:
    """A sampled value rendered as a Perfetto counter track (e.g. the
    per-flush bubble fraction in basis points)."""
    if _enabled:
        _record(name_id, COUNTER, time.perf_counter_ns(), value)


def span_since(name_id: int, t0_ns: int, _pcn=time.perf_counter_ns,
               _pack=_REC.pack_into) -> None:
    """Record a completed span whose start was stamped with ``now()``.
    One record per wait — t = end, arg = duration."""
    if not _enabled or not t0_ns:
        return
    ring = getattr(_tls, "ring", None)
    if ring is None:
        ring = _new_ring()
    t = _pcn()
    i = ring.count
    _pack(ring.buf, (i % ring.cap) * REC_SIZE,
          t, (t - t0_ns) & _U64MASK, name_id, SPAN, 0)
    ring.count = i + 1


def record_span(name: str, duration_ns: int) -> None:
    """A just-finished span by name (the ``util/tracing.py`` bridge: user
    spans land on the same merged timeline)."""
    if _enabled:
        _record(intern(name), SPAN, time.perf_counter_ns(),
                max(0, int(duration_ns)))


class _Span:
    __slots__ = ("_nid", "_t0")

    def __init__(self, nid: int):
        self._nid = nid
        self._t0 = 0

    def __enter__(self):
        self._t0 = now()
        return self

    def __exit__(self, *exc):
        span_since(self._nid, self._t0)


def span(name: str) -> _Span:
    """``with flight.span("phase"):`` convenience (interns per call — hot
    loops should hold the id and use ``now()``/``span_since`` instead)."""
    return _Span(intern(name))


# ------------------------------------------------------------------ drain


def metrics_snapshot() -> Dict[str, float]:
    """Registry totals sampled at drain time, folded into the timeline as
    counter events (Counters/Gauges directly; Histograms as _count/_sum)."""
    from ray_tpu_torch._private.metrics import (Counter as _C, Gauge as _G,
                                          Histogram as _H, default_registry)

    out: Dict[str, float] = {}
    reg = default_registry()
    with reg._lock:
        metrics = list(reg._metrics.values())
    for m in metrics:
        try:
            if isinstance(m, (_C, _G)):
                out[m.name] = m.total()
            elif isinstance(m, _H):
                out[m.name + "_count"] = float(m.count_total())
                out[m.name + "_sum"] = m.sum_total()
        except Exception:
            continue
    return out


def drain() -> Dict[str, Any]:
    """Snapshot every ring in this process WITHOUT stalling the recording
    threads: read count, copy the buffer, read count again — records the
    writer may have touched during the copy (and the slots they recycled)
    are excluded from the valid window, so the snapshot is consistent."""
    with _rings_lock:
        rings = list(_rings)
    me = threading.get_ident()
    threads: List[Dict[str, Any]] = []
    for r in rings:
        n0 = r.count
        data = bytes(r.buf)
        n1 = r.count
        if r.tid == me:
            lo = max(0, n1 - r.cap)
        else:
            # a foreign writer may have PACKED record n1 into its slot
            # before incrementing count — the slot that previously held
            # seq n1 - cap can already carry the new bytes, so exclude
            # one slot beyond the plain wrap window
            lo = max(0, n1 + 1 - r.cap)
        threads.append({
            "tid": r.tid, "name": r.name, "cap": r.cap,
            "count": n0, "valid_from": lo, "dropped": lo,
            "data": data,
        })
    with _intern_lock:
        names = list(_names)
    return {
        "pid": os.getpid(),
        "role": _role,
        "names": names,
        # anchor pair mapping this process's monotonic stamps to its
        # host's wall clock (cross-host offsets are corrected per-node
        # by the driver's RTT/2 handshake with each supervisor)
        "perf_ns": time.perf_counter_ns(),
        "wall_ns": time.time_ns(),
        "threads": threads,
        "metrics": metrics_snapshot(),
    }


def _reset_for_tests() -> None:
    """Drop this thread's ring and every dead thread's ring. Rings of
    OTHER live threads stay registered: ``_tls`` can only be unbound for
    the calling thread, so de-listing a live foreign ring would leave
    its owner writing into a buffer no drain can ever see."""
    me = threading.get_ident()
    with _rings_lock:
        _rings[:] = [r for r in _rings
                     if r.tid != me and not r.dead()]
    if getattr(_tls, "ring", None) is not None:
        _tls.ring = None


# ----------------------------------------------------------------- decode


def decode(dump: Dict[str, Any], node: str = "",
           clock_offset_ns: int = 0) -> List[Dict[str, Any]]:
    """One process dump -> Chrome-trace events (ts in wall-clock µs,
    already shifted by the node's measured clock offset). Rows group
    node -> process (role+pid) -> thread. Unmatched END records at the
    head of a wrapped ring are dropped so viewers keep clean nesting."""
    names = dump.get("names", [])
    wall_base = dump["wall_ns"] - dump["perf_ns"] - clock_offset_ns
    pid = f"{node + '/' if node else ''}{dump.get('role', 'proc')}" \
          f":{dump['pid']}"
    events: List[Dict[str, Any]] = []

    def us(t_ns: int) -> float:
        return (t_ns + wall_base) / 1e3

    for th in dump.get("threads", []):
        tid = f"{th.get('name', 'thread')}({th.get('tid', 0)})"
        buf, cap = th["data"], th["cap"]
        open_ids: List[int] = []
        thread_events: List[Dict[str, Any]] = []
        for seq in range(min(th["valid_from"], th["count"]), th["count"]):
            t_ns, arg, nid, kind, _ = _REC.unpack_from(
                buf, (seq % cap) * REC_SIZE)
            name = names[nid] if nid < len(names) else f"name{nid}"
            if kind == BEGIN:
                open_ids.append(nid)
                thread_events.append({"name": name, "cat": "flight",
                                      "ph": "B", "ts": us(t_ns),
                                      "pid": pid, "tid": tid})
            elif kind == END:
                if not open_ids or open_ids[-1] != nid:
                    continue  # its BEGIN was overwritten by the wrap
                open_ids.pop()
                thread_events.append({"name": name, "cat": "flight",
                                      "ph": "E", "ts": us(t_ns),
                                      "pid": pid, "tid": tid})
            elif kind == INSTANT:
                thread_events.append({"name": name, "cat": "flight",
                                      "ph": "i", "s": "t", "ts": us(t_ns),
                                      "pid": pid, "tid": tid,
                                      "args": {"arg": arg}})
            elif kind == SPAN:
                thread_events.append({"name": name, "cat": "flight",
                                      "ph": "X", "ts": us(t_ns - arg),
                                      "dur": max(arg / 1e3, 0.001),
                                      "pid": pid, "tid": tid})
            elif kind == COUNTER:
                thread_events.append({"name": name, "ph": "C",
                                      "ts": us(t_ns), "pid": pid,
                                      "args": {"value": arg}})
        if th.get("dropped"):
            thread_events.append({
                "name": "flight.dropped", "ph": "C", "ts": us(t_ns)
                if th["count"] > th["valid_from"]
                else (dump["wall_ns"] - clock_offset_ns) / 1e3,
                "pid": pid, "args": {"value": th["dropped"]}})
        events.extend(thread_events)
    # registry counters sampled at dump time, one track per metric
    dump_us = (dump["wall_ns"] - clock_offset_ns) / 1e3
    for mname, value in (dump.get("metrics") or {}).items():
        events.append({"name": mname, "ph": "C", "ts": dump_us,
                       "pid": pid, "args": {"value": value}})
    return events


def merge_dumps(entries: Iterable[Tuple[Dict[str, Any], str, int]],
                path: Optional[str] = None) -> List[Dict[str, Any]]:
    """Merge ``(dump, node_label, clock_offset_ns)`` triples into one
    Chrome-trace event list; write JSON to ``path`` when given. Events
    stay in per-thread record order (B/E nesting must not be resorted);
    Perfetto/chrome://tracing accept interleaved streams."""
    events: List[Dict[str, Any]] = []
    for dump, node, offset_ns in entries:
        try:
            events.extend(decode(dump, node=node,
                                 clock_offset_ns=int(offset_ns)))
        except Exception:
            continue  # one corrupt dump must not lose the rest
    if path:
        import json

        with open(path, "w") as f:
            json.dump(events, f)
    return events


def local_timeline(path: Optional[str] = None) -> List[Dict[str, Any]]:
    """This process's rings only — the no-cluster fallback (e.g. a chaos
    seed dumping after its cluster already unwound)."""
    return merge_dumps([(drain(), "local", 0)], path=path)
