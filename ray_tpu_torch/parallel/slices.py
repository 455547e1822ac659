"""Accelerator-slice topology and gang scheduling.

Counterpart: ``ray_tpu/parallel/slices.py``. A slice-wide job is a
STRICT_SPREAD placement group: one bundle per host, each demanding the
host's accelerators, with bundle 0 adding the slice-head resource, so the
whole gang is placed or none of it is. The topology strings keep the JAX
package's names (``v5p-64``, ``v4-8``): they name the gang's shape, chips
and chips per host. The port's bundles ask for the runtime's ``GPU``
resource where the JAX package's ask for ``TPU``; the head resource and the
STRICT_SPREAD/STRICT_PACK choice stay as they are.

``worker_env_for_host`` gives what ``torch.distributed``'s ``env://``
rendezvous reads (``MASTER_ADDR``, ``MASTER_PORT``, ``NODE_RANK``,
``NNODES``) from the same inputs as the JAX package's pod-slice wiring.
"""

from __future__ import annotations

import dataclasses
import os
import re
from typing import Dict, List, Optional

# chips per host for known TPU generations (v4/v5p: 4 chips/host; v5e/v6e: 8
# for the common configurations; overridable).
_CHIPS_PER_HOST = {"v4": 4, "v5p": 4, "v5litepod": 8, "v5e": 8, "v6e": 8}

ACCELERATOR_RESOURCE = "GPU"


@dataclasses.dataclass(frozen=True)
class SliceTopology:
    """A slice, e.g. v5p-64: generation, total chips, chips per host."""

    generation: str
    num_chips: int
    chips_per_host: int

    @classmethod
    def parse(cls, name: str) -> "SliceTopology":
        """Parse an accelerator-type string like 'v5p-64' or 'v4-8'.

        The trailing number is TensorCores for v2-v4 (2 cores/chip) and chips
        for v5e+; we normalize to chips.
        """
        m = re.fullmatch(r"(v\d+[a-z]*(?:pod)?)-(\d+)", name.strip().lower())
        if not m:
            raise ValueError(f"cannot parse TPU topology {name!r}")
        gen, n = m.group(1), int(m.group(2))
        cores_per_chip = 2 if gen in ("v2", "v3", "v4", "v5p") else 1
        chips = n // cores_per_chip
        cph = _CHIPS_PER_HOST.get(gen, 4)
        return cls(gen, max(chips, 1), min(cph, max(chips, 1)))

    @property
    def num_hosts(self) -> int:
        return max(1, self.num_chips // self.chips_per_host)

    @property
    def head_resource(self) -> str:
        """The gang-head resource name."""
        return f"TPU-{self.generation}-{self.num_chips}-head"

    def bundles(self) -> List[Dict[str, float]]:
        """One bundle per host; bundle 0 carries the head resource."""
        out = []
        for host in range(self.num_hosts):
            b: Dict[str, float] = {ACCELERATOR_RESOURCE: float(self.chips_per_host)}
            if host == 0:
                b[self.head_resource] = 1.0
            out.append(b)
        return out

    @classmethod
    def detect(cls) -> Optional["SliceTopology"]:
        """Detect from the environment (no device access)."""
        acc = os.environ.get("TPU_ACCELERATOR_TYPE") or os.environ.get(
            "RAY_TPU_TOPOLOGY"
        )
        if acc:
            try:
                return cls.parse(acc)
            except ValueError:
                return None
        return None


def slice_placement_group(topology: SliceTopology, name: str = ""):
    """Reserve a whole slice as a gang: STRICT_SPREAD, one bundle per host."""
    from ray_tpu_torch.util.placement_group import placement_group

    strategy = "STRICT_SPREAD" if topology.num_hosts > 1 else "STRICT_PACK"
    return placement_group(
        topology.bundles(), strategy=strategy, name=name or f"slice-{topology.generation}"
    )


def worker_env_for_host(topology: SliceTopology, host_index: int,
                        coordinator: str) -> Dict[str, str]:
    """Env vars for the per-host trainer worker: ``env://`` rendezvous at
    ``coordinator`` (``host:port``), this host's rank among the slice's
    hosts, and their count."""
    host, sep, port = coordinator.rpartition(":")
    if not sep or not host or not port.isdigit():
        raise ValueError(f"coordinator must be 'host:port', got {coordinator!r}")
    return {
        "MASTER_ADDR": host,
        "MASTER_PORT": port,
        "NODE_RANK": str(host_index),
        "NNODES": str(topology.num_hosts),
    }
