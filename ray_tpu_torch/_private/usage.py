"""Usage telemetry (ref `python/ray/_private/usage/usage_lib.py`).

Records which libraries/features a cluster actually exercises plus
coarse cluster shape, and writes one JSON report under the session dir
at shutdown (`usage_report.json`). Reporting to a collector URL is
OPT-IN via RAY_TPU_TORCH_USAGE_REPORT_URL (the reference reports by default
and offers RAY_USAGE_STATS_ENABLED=0; a framework that runs in
zero-egress pods, so the polarity flips to off-by-default). Disable
recording entirely with RAY_TPU_TORCH_USAGE_STATS_ENABLED=0."""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Any, Dict, Set

_lock = threading.Lock()
_libraries: Set[str] = set()
_features: Set[str] = set()
_started = time.time()


def enabled() -> bool:
    return os.environ.get("RAY_TPU_TORCH_USAGE_STATS_ENABLED", "1") != "0"


def record_library_usage(name: str) -> None:
    """Called from library __init__ (train/tune/serve/data/rllib/...)."""
    if enabled():
        with _lock:
            _libraries.add(name)


def record_feature_usage(name: str) -> None:
    """Finer-grained feature tags (e.g. 'streaming_generator',
    'device_objects', 'pipeline_1f1b')."""
    if enabled():
        with _lock:
            _features.add(name)


def _cluster_shape() -> Dict[str, Any]:
    try:
        import ray_tpu_torch

        if not ray_tpu_torch.is_initialized():
            return {}
        nodes = ray_tpu_torch.nodes()
        total = ray_tpu_torch.cluster_resources()
        return {"num_nodes": len(nodes),
                "total_cpus": total.get("CPU"),
                "total_gpus": total.get("GPU")}
    except Exception:
        return {}


def build_report() -> Dict[str, Any]:
    import platform
    import sys

    with _lock:
        libs, feats = sorted(_libraries), sorted(_features)
    return {
        "schema_version": 1,
        "session_duration_s": round(time.time() - _started, 1),
        "python": sys.version.split()[0],
        "platform": platform.platform(),
        "libraries_used": libs,
        "features_used": feats,
        "cluster": _cluster_shape(),
    }


def write_report(session_dir: str) -> str:
    """Persist the report locally; POST it only when a collector URL is
    configured. Called from shutdown; must never raise."""
    path = os.path.join(session_dir, "usage_report.json")
    try:
        report = build_report()
        with open(path, "w") as f:
            json.dump(report, f, indent=2)
        url = os.environ.get("RAY_TPU_TORCH_USAGE_REPORT_URL", "")
        if url:
            import urllib.request

            req = urllib.request.Request(
                url, data=json.dumps(report).encode(),
                headers={"Content-Type": "application/json"})
            urllib.request.urlopen(req, timeout=5).read()
    except Exception:
        pass
    return path
