"""User-defined metrics (≈ `ray.util.metrics` Counter/Gauge/Histogram).

Metrics record into the process-local registry; in daemons they are
served on that daemon's /metrics endpoint, and in driver/worker
processes they can be rendered with `render()` or scraped cluster-wide
with ``util.state.cluster_metrics(all_nodes=True)``. Names should be
prometheus-safe.
"""

from __future__ import annotations

from ray_tpu_torch._private.metrics import (Counter, Gauge, Histogram,
                                            default_registry)

__all__ = ["Counter", "Gauge", "Histogram", "render"]


def render() -> str:
    """Prometheus text exposition of this process's registry."""
    return default_registry().render_prometheus()
