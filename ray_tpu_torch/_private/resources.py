"""Resource accounting.

Analog of the reference's scheduling resource model
(`src/ray/raylet/scheduling/cluster_resource_manager`, `NodeResources`):
a node advertises a map of resource name → float capacity; tasks/actors demand
resource maps; placement-group bundles reserve slices and re-expose them under
formatted names.

GPUs are a first-class resource ("GPU"), counted without touching a card
(reference `python/ray/_private/accelerators/nvidia_gpu.py`). The TPU pod's
slice-head gang resource has no counterpart here, and neither has the JAX
package's `_private/accelerators.py`: it reads GCE TPU metadata and pod
gang resources, which GPU hosts do not have. A slice gang's head resource
is given to a node as a custom resource, and `parallel/slices.py` builds
the gang's placement group.
"""

from __future__ import annotations

import os
import subprocess
from typing import Dict, Optional

EPS = 1e-9

CPU = "CPU"
GPU = "GPU"
MEMORY = "memory"
OBJECT_STORE_MEMORY = "object_store_memory"


class ResourceSet(dict):
    """A {name: amount} map with arithmetic. Amounts are floats >= 0."""

    @classmethod
    def of(cls, mapping: Optional[Dict[str, float]]) -> "ResourceSet":
        rs = cls()
        if mapping:
            for k, v in mapping.items():
                if v < 0:
                    raise ValueError(f"negative resource {k}={v}")
                if v > 0:
                    rs[k] = float(v)
        return rs

    def fits(self, other: "ResourceSet") -> bool:
        """True if self has at least `other` of every resource."""
        return all(self.get(k, 0.0) + EPS >= v for k, v in other.items())

    def subtract(self, other: "ResourceSet") -> None:
        for k, v in other.items():
            cur = self.get(k, 0.0) - v
            if cur < -EPS:
                raise ValueError(f"resource {k} went negative ({cur})")
            if cur <= EPS:
                self.pop(k, None)
            else:
                self[k] = cur

    def add(self, other: "ResourceSet") -> None:
        for k, v in other.items():
            self[k] = self.get(k, 0.0) + v

    def copy(self) -> "ResourceSet":
        return ResourceSet.of(self)

    def utilization(self, total: "ResourceSet") -> float:
        """Max fractional utilization across resources present in `total`."""
        util = 0.0
        for k, cap in total.items():
            if cap > 0:
                used = cap - self.get(k, 0.0)
                util = max(util, used / cap)
        return util


def detect_node_resources(
    num_cpus: Optional[float] = None,
    num_gpus: Optional[int] = None,
    memory_bytes: Optional[int] = None,
    object_store_bytes: Optional[int] = None,
    custom: Optional[Dict[str, float]] = None,
) -> ResourceSet:
    """Detect this host's schedulable resources.

    GPU detection never imports torch or initializes CUDA (a daemon that
    did would hold a context on every card): we trust explicit args, then
    ``CUDA_VISIBLE_DEVICES``, then count the lines of ``nvidia-smi -L``.
    """
    rs = ResourceSet()
    rs[CPU] = float(num_cpus if num_cpus is not None else (os.cpu_count() or 1))
    if num_gpus is None:
        num_gpus = _detect_gpus()
    if num_gpus:
        rs[GPU] = float(num_gpus)
    if memory_bytes is None:
        memory_bytes = _detect_memory()
    rs[MEMORY] = float(memory_bytes)
    if object_store_bytes:
        rs[OBJECT_STORE_MEMORY] = float(object_store_bytes)
    if custom:
        for k, v in custom.items():
            rs[k] = float(v)
    return rs


def _detect_gpus() -> int:
    visible = os.environ.get("CUDA_VISIBLE_DEVICES")
    if visible is not None:
        return len([c for c in visible.split(",") if c.strip()])
    try:
        out = subprocess.run(["nvidia-smi", "-L"], capture_output=True,
                             text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return 0
    if out.returncode != 0:
        return 0
    return sum(1 for line in out.stdout.splitlines()
               if line.startswith("GPU "))


def _detect_memory() -> int:
    try:
        import psutil

        return int(psutil.virtual_memory().total)
    except Exception:
        return 8 * 1024**3


def pg_resource_name(pg_id_hex: str, bundle_index: int | None = None) -> str:
    """Formatted resource name for a placement-group bundle reservation.

    Mirrors the reference's `<name>_group_<index>_<pg_id>` convention so tasks
    scheduled into a bundle consume the reserved slice, not the free pool.
    """
    if bundle_index is None:
        return f"bundle_group_{pg_id_hex}"
    return f"bundle_group_{bundle_index}_{pg_id_hex}"
