"""Node providers: how the autoscaler actually gets machines.

Analog of `python/ray/autoscaler/node_provider.py` (the plugin interface)
and the fake multi-node provider in `_private/fake_multi_node`:

  * LocalNodeProvider — spawns real supervisor processes on this host;
    the hermetic test/provider used by the autoscaler tests. A node type
    that counts ``GPU`` gets its card ids explicitly (``node_config
    ["gpu_ids"]``, default ``0..n-1``), never from the caller's
    ``CUDA_VISIBLE_DEVICES``.

A node type is a host shape: its resources, ``GPU`` among them, with the
whole-card ids its supervisor hands the workers it leases cards to.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Any, Dict, List


@dataclasses.dataclass
class NodeType:
    """One launchable host shape (≈ available_node_types entries in the
    reference's autoscaler YAML)."""

    name: str
    resources: Dict[str, float]
    max_workers: int = 10
    # provider-specific payload (LocalNodeProvider reads "gpu_ids")
    node_config: Dict[str, Any] = dataclasses.field(default_factory=dict)


def gpu_ids(node_type: NodeType) -> List[str]:
    """The card ids a node of this type hands its workers, one per ``GPU``
    it counts: ``node_config["gpu_ids"]`` when given (a card may be listed
    more than once, to share it), else ``0..n-1`` — what
    ``init(num_gpus=n)`` gives a driver that sets no
    ``CUDA_VISIBLE_DEVICES``."""
    n = node_type.resources.get("GPU", 0)
    if n != int(n):
        raise ValueError(f"node type {node_type.name}: GPU={n} is not a "
                         f"whole number of cards")
    ids = node_type.node_config.get("gpu_ids")
    if ids is None:
        return [str(i) for i in range(int(n))]
    ids = [str(i).strip() for i in ids]
    if len(ids) != int(n) or not all(ids):
        raise ValueError(f"node type {node_type.name}: gpu_ids {ids} do "
                         f"not name its {int(n)} GPU(s)")
    return ids


class NodeProvider:
    """Minimal provider surface the autoscaler drives.

    Contract for v2 reconciliation: a provider must arrange for each
    launched node's supervisor to advertise the node label
    ``provider_id=<its provider node id>`` — that label is the join key
    between the cloud view and the control-plane view
    (`autoscaler/v2.py` ``Reconciler._sync_cluster``)."""

    def create_node(self, node_type: NodeType, count: int) -> List[str]:
        """Launch `count` nodes of the type; returns provider node ids."""
        raise NotImplementedError

    def terminate_node(self, provider_node_id: str) -> None:
        raise NotImplementedError

    def non_terminated_nodes(self) -> List[Dict[str, Any]]:
        """[{id, node_type, node_id_hex?}] for nodes this provider launched
        and has not terminated."""
        raise NotImplementedError


class LocalNodeProvider(NodeProvider):
    """Spawns supervisor processes on this host (one per 'node').

    Wraps a `ray_tpu_torch.cluster_utils.Cluster`-compatible session: it
    talks to the same controller and session dir, so autoscaled nodes join
    the cluster exactly like `Cluster.add_node` ones.
    """

    def __init__(self, session_dir: str, controller_addr, config=None):
        from ray_tpu_torch._private.config import Config

        self._session_dir = session_dir
        self._controller_addr = controller_addr
        self._config = config or Config.from_env()
        self._lock = threading.Lock()
        self._nodes: Dict[str, Dict[str, Any]] = {}
        self._next_id = 0

    def create_node(self, node_type: NodeType, count: int) -> List[str]:
        from ray_tpu_torch._private.node import start_supervisor

        out = []
        resources = {k: float(v) for k, v in node_type.resources.items()}
        resources.setdefault("memory", 2.0 * 1024**3)
        # the supervisor's workers get their cards from this list, set
        # here so it never follows the caller's CUDA_VISIBLE_DEVICES
        cards = ",".join(gpu_ids(node_type))
        with self._lock:
            for _ in range(count):
                self._next_id += 1
                pid = f"local-{node_type.name}-{self._next_id}"
                proc, addr = start_supervisor(
                    self._session_dir,
                    self._config,
                    self._controller_addr,
                    resources=dict(resources),
                    node_name=pid,
                    # the provider<->control-plane join key the v2
                    # reconciler matches on (v2.py _sync_cluster); every
                    # NodeProvider must arrange for the node's supervisor
                    # to advertise it
                    labels={"provider_id": pid,
                            "node_type": node_type.name},
                    env={"CUDA_VISIBLE_DEVICES": cards},
                )
                self._nodes[pid] = {
                    "id": pid,
                    "node_type": node_type.name,
                    "proc": proc,
                    "address": addr,
                }
                out.append(pid)
        return out

    def terminate_node(self, provider_node_id: str) -> None:
        with self._lock:
            rec = self._nodes.pop(provider_node_id, None)
        if rec is not None:
            try:
                rec["proc"].kill()
                rec["proc"].wait(timeout=5)
            except Exception:
                pass

    def non_terminated_nodes(self) -> List[Dict[str, Any]]:
        with self._lock:
            return [
                {"id": r["id"], "node_type": r["node_type"],
                 "node_name": r["id"]}
                for r in self._nodes.values()
            ]

    def shutdown(self) -> None:
        for pid in [r["id"] for r in self.non_terminated_nodes()]:
            self.terminate_node(pid)
