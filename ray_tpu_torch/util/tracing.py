"""Distributed tracing: span contexts that ride task metadata.

Analog of `python/ray/util/tracing/tracing_helper.py`: when tracing is
enabled, every task/actor submission captures the caller's span context
into the TaskSpec (`trace_ctx`), and the executing worker opens a child
span around the user function — so cross-process call trees stitch into
one trace. Spans export through a pluggable exporter; the default writes
JSON lines to `spans-<pid>.jsonl` in the session log dir, and
`collect_spans()` merges them into a Chrome-trace-compatible list
(`ray timeline`'s span feed). OpenTelemetry, when installed, can be
bridged by passing an exporter that forwards to an otel tracer — the
core never imports otel (the reference lazily imports it the same way,
tracing_helper.py:36-82).

Usage:
    from ray_tpu_torch.util import tracing
    tracing.enable()
    with tracing.span("ingest"):
        ref = my_task.remote(...)       # child span on the worker
"""

from __future__ import annotations

import contextlib
import contextvars
import json
import os
import tempfile
import threading
import time
import uuid
from typing import Any, Callable, Dict, List, Optional

_current: contextvars.ContextVar[Optional[Dict[str, str]]] = (
    contextvars.ContextVar("ray_tpu_trace_ctx", default=None))

_enabled = False
_exporter: Optional[Callable[[Dict[str, Any]], None]] = None
_lock = threading.Lock()
_file = None
_file_path: Optional[str] = None


def enable(exporter: Optional[Callable[[Dict[str, Any]], None]] = None,
           ) -> None:
    """Turn tracing on in THIS process (drivers and workers each call it;
    workers auto-enable when a traced task arrives)."""
    global _enabled, _exporter
    _enabled = True
    _exporter = exporter


def disable() -> None:
    global _enabled
    _enabled = False


def is_enabled() -> bool:
    return _enabled


def _default_root() -> str:
    # outside a session: the root sessions live under (node.py), in this
    # process's temporary directory
    return os.path.join(tempfile.gettempdir(), "ray_tpu_torch")


def _spans_path() -> str:
    base = os.environ.get("RAY_TPU_TORCH_SESSION_DIR", _default_root())
    d = os.path.join(base, "logs") if os.path.isdir(
        os.path.join(base, "logs")) else base
    os.makedirs(d, exist_ok=True)
    return os.path.join(d, f"spans-{os.getpid()}.jsonl")


def _emit(span: Dict[str, Any]) -> None:
    global _file, _file_path
    # user spans also land in the flight recorder (when it is on), so
    # they appear on the same merged cluster timeline as the data-plane
    # hot-loop spans — a lock-free ring write, nothing like the
    # file-export cost below
    from ray_tpu_torch._private import flight

    if flight.is_enabled():
        flight.record_span(span["name"], int(span["duration_s"] * 1e9))
    if _exporter is not None:
        _exporter(span)
        return
    with _lock:
        # the session dir can change after init() (spans emitted before
        # init land in the default location) — follow it, don't cache the
        # first resolution forever
        path = _spans_path()
        if _file is None or path != _file_path:
            if _file is not None:
                _file.close()
            _file = open(path, "a", buffering=1)
            _file_path = path
        _file.write(json.dumps(span) + "\n")


def current_context() -> Optional[Dict[str, str]]:
    """The (trace_id, span_id) pair submissions should propagate."""
    return _current.get()


def context_for_submission() -> Optional[Dict[str, str]]:
    """What a task submission should carry: the active span's context, a
    fresh root context when tracing is on but no span is open, or None
    when tracing is off (zero overhead on the untraced path)."""
    if not _enabled:
        return None
    ctx = _current.get()
    if ctx is not None:
        return dict(ctx)
    return {"trace_id": uuid.uuid4().hex, "span_id": ""}


@contextlib.contextmanager
def span(name: str, attributes: Optional[Dict[str, Any]] = None):
    """Open a span; nested spans and remote tasks become children."""
    if not _enabled:
        yield None
        return
    parent = _current.get()
    ctx = {
        "trace_id": (parent or {}).get("trace_id", uuid.uuid4().hex),
        "span_id": uuid.uuid4().hex[:16],
    }
    token = _current.set(ctx)
    start = time.time()
    try:
        yield ctx
    finally:
        _current.reset(token)
        _emit({
            "name": name,
            "trace_id": ctx["trace_id"],
            "span_id": ctx["span_id"],
            "parent_id": (parent or {}).get("span_id"),
            "start_s": start,
            "duration_s": time.time() - start,
            "pid": os.getpid(),
            "attributes": attributes or {},
        })


@contextlib.contextmanager
def remote_span(name: str, trace_ctx: Dict[str, str]):
    """Worker-side: continue a propagated context around task execution."""
    global _enabled
    _enabled = True    # a traced task arriving means tracing is on
    parent_like = {"trace_id": trace_ctx["trace_id"],
                   "span_id": uuid.uuid4().hex[:16]}
    token = _current.set(parent_like)
    start = time.time()
    try:
        yield
    finally:
        _current.reset(token)
        _emit({
            "name": name,
            "trace_id": trace_ctx["trace_id"],
            "span_id": parent_like["span_id"],
            "parent_id": trace_ctx.get("span_id"),
            "start_s": start,
            "duration_s": time.time() - start,
            "pid": os.getpid(),
            "attributes": {"remote": True},
        })


def collect_spans(session_dir: Optional[str] = None) -> List[Dict[str, Any]]:
    """Merge every process's span files (driver + workers) for analysis or
    a Chrome-trace dump."""
    import glob as _glob

    base = session_dir or os.environ.get("RAY_TPU_TORCH_SESSION_DIR",
                                         _default_root())
    out: List[Dict[str, Any]] = []
    for pat in (os.path.join(base, "logs", "spans-*.jsonl"),
                os.path.join(base, "spans-*.jsonl")):
        for f in _glob.glob(pat):
            try:
                with open(f) as fh:
                    for line in fh:
                        line = line.strip()
                        if line:
                            out.append(json.loads(line))
            except OSError:
                continue
    out.sort(key=lambda s: s["start_s"])
    return out


def to_chrome_trace(spans: List[Dict[str, Any]]) -> List[Dict[str, Any]]:
    """Spans -> chrome://tracing 'X' events (complements the task-event
    timeline in util/state.py)."""
    return [{
        "name": s["name"],
        "cat": "span",
        "ph": "X",
        "ts": s["start_s"] * 1e6,
        "dur": s["duration_s"] * 1e6,
        "pid": s.get("pid", 0),
        "tid": int(s["trace_id"][:6], 16),
        "args": dict(s.get("attributes", {}),
                     trace_id=s["trace_id"], span_id=s["span_id"],
                     parent_id=s.get("parent_id")),
    } for s in spans]
