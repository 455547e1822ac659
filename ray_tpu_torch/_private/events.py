"""Structured event framework — JSONL lifecycle events per daemon.

Analog of the reference's event framework (`src/ray/util/event.h`
RAY_EVENT macros + `dashboard/modules/event/`): daemons append one JSON
object per line to ``<session>/logs/events_<component>_<pid>.jsonl``
with a stable schema (timestamp, severity, source_type, event_type,
message, custom fields), and the state API
(`ray_tpu_torch.util.state.list_cluster_events`) merges the session's files
into one time-ordered view. Free-text logs remain for humans; events are
the machine-queryable lifecycle record.
"""

from __future__ import annotations

import json
import logging
import os
import threading
import time
import uuid
from typing import Any, Dict, List, Optional

logger = logging.getLogger(__name__)

SEVERITIES = ("DEBUG", "INFO", "WARNING", "ERROR")


class EventLogger:
    """Append-only JSONL writer, safe across threads; one per daemon."""

    def __init__(self, component: str, session_dir: str):
        self.component = component
        self._lock = threading.Lock()
        self._fh = None
        self.path = ""
        if session_dir:
            log_dir = os.path.join(session_dir, "logs")
            try:
                os.makedirs(log_dir, exist_ok=True)
                self.path = os.path.join(
                    log_dir, f"events_{component}_{os.getpid()}.jsonl")
                self._fh = open(self.path, "a", buffering=1)  # line-buffered
            except OSError:
                logger.warning("event log unavailable for %s", component)

    def emit(self, event_type: str, message: str = "",
             severity: str = "INFO", **fields: Any) -> None:
        if self._fh is None:
            return
        record = {
            "event_id": uuid.uuid4().hex[:16],
            "timestamp": time.time(),
            "severity": severity if severity in SEVERITIES else "INFO",
            "source_type": self.component,
            "source_pid": os.getpid(),
            "event_type": event_type,
            "message": message,
        }
        if fields:
            record["custom_fields"] = fields
        try:
            with self._lock:
                self._fh.write(json.dumps(record) + "\n")
        except Exception:
            pass  # events must never take a daemon down

    def close(self) -> None:
        if self._fh is not None:
            try:
                self._fh.close()
            except Exception:
                pass
            self._fh = None


_null = None


def null_logger() -> EventLogger:
    """Shared no-op logger (no session dir)."""
    global _null
    if _null is None:
        _null = EventLogger("null", "")
    return _null


def read_events(session_dir: str, *, limit: int = 1000,
                event_type: Optional[str] = None,
                source_type: Optional[str] = None,
                severity: Optional[str] = None) -> List[Dict[str, Any]]:
    """Merge every daemon's event file in *session_dir* into one
    time-ordered list (newest last), with optional filters."""
    log_dir = os.path.join(session_dir, "logs")
    out: List[Dict[str, Any]] = []
    try:
        names = sorted(os.listdir(log_dir))
    except OSError:
        return out
    for name in names:
        if not (name.startswith("events_") and name.endswith(".jsonl")):
            continue
        try:
            with open(os.path.join(log_dir, name)) as f:
                for line in f:
                    try:
                        rec = json.loads(line)
                    except json.JSONDecodeError:
                        continue
                    if event_type and rec.get("event_type") != event_type:
                        continue
                    if source_type and rec.get("source_type") != source_type:
                        continue
                    if severity and rec.get("severity") != severity:
                        continue
                    out.append(rec)
        except OSError:
            continue
    out.sort(key=lambda r: r.get("timestamp", 0))
    return out[-limit:]
