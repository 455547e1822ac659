"""Multi-node test cluster on one host.

Analog of the reference's ``python/ray/cluster_utils.py:135``: start a real
controller plus N real supervisor processes on one machine, so multi-node
semantics (scheduling, spillback, placement groups, node failure, object
transfer) are exercised with real process boundaries — the reference's core
integration-test pattern (SURVEY §4).
"""

from __future__ import annotations

import os
import subprocess
import time
from typing import Dict, List, Optional, Tuple

from ray_tpu_torch._private.config import Config
from ray_tpu_torch._private.node import start_controller, start_supervisor, new_session_dir

Address = Tuple[str, int]


class ClusterNode:
    def __init__(self, proc: subprocess.Popen, address: Address, name: str):
        self.proc = proc
        self.address = address
        self.name = name

    def kill(self) -> None:
        """Hard-kill the supervisor process (chaos testing)."""
        try:
            self.proc.kill()
            self.proc.wait(timeout=5)
        except Exception:
            pass


class Cluster:
    """≈ ray.cluster_utils.Cluster (add_node :201, remove_node :274)."""

    def __init__(self, config: Optional[Config] = None):
        self.config = config or Config.from_env()
        self.session_dir = new_session_dir()
        self.controller_proc, self.controller_addr = start_controller(
            self.session_dir, self.config
        )
        self.nodes: List[ClusterNode] = []

    @property
    def address(self) -> str:
        return f"{self.controller_addr[0]}:{self.controller_addr[1]}"

    def add_node(
        self,
        num_cpus: float = 1,
        num_gpus: int = 0,
        resources: Optional[Dict[str, float]] = None,
        object_store_memory: Optional[int] = None,
        name: str = "",
        labels: Optional[Dict[str, str]] = None,
    ) -> ClusterNode:
        node_resources = {"CPU": float(num_cpus), "memory": 2.0 * 1024**3}
        if num_gpus:
            node_resources["GPU"] = float(num_gpus)
        if resources:
            node_resources.update({k: float(v) for k, v in resources.items()})
        name = name or f"node{len(self.nodes)}"
        proc, addr = start_supervisor(
            self.session_dir,
            self.config,
            self.controller_addr,
            resources=node_resources,
            node_name=name,
            labels=labels,
        )
        node = ClusterNode(proc, addr, name)
        self.nodes.append(node)
        return node

    def restart_controller(self) -> None:
        """Hard-kill the controller and start a replacement on the SAME
        address; it recovers actors/PGs/jobs/KV from the session-dir
        snapshot (controller fault-tolerance chaos testing)."""
        try:
            self.controller_proc.kill()
            self.controller_proc.wait(timeout=5)
        except Exception:
            pass
        # the dead controller's address file would satisfy the startup
        # wait immediately; remove it so we observe the NEW controller's
        # write (and actually detect a failed respawn)
        try:
            os.remove(os.path.join(self.session_dir, "controller_address"))
        except FileNotFoundError:
            pass
        self.controller_proc, addr = start_controller(
            self.session_dir, self.config, port=self.controller_addr[1]
        )
        assert addr == self.controller_addr, (addr, self.controller_addr)

    def remove_node(self, node: ClusterNode) -> None:
        node.kill()
        if node in self.nodes:
            self.nodes.remove(node)

    def wait_for_nodes(self, count: Optional[int] = None, timeout: float = 30) -> None:
        import asyncio

        from ray_tpu_torch._private.rpc import RpcClient

        want = count if count is not None else len(self.nodes)

        async def poll():
            client = RpcClient(self.controller_addr)
            try:
                deadline = time.monotonic() + timeout
                while time.monotonic() < deadline:
                    views = await client.call("node_views")
                    if sum(1 for v in views if v["alive"]) >= want:
                        return
                    await asyncio.sleep(0.05)
                raise TimeoutError(f"cluster did not reach {want} alive nodes")
            finally:
                await client.close()

        asyncio.run(poll())

    def shutdown(self) -> None:
        for node in self.nodes:
            node.kill()
        self.nodes.clear()
        try:
            self.controller_proc.terminate()
            self.controller_proc.wait(timeout=3)
        except Exception:
            try:
                self.controller_proc.kill()
            except Exception:
                pass
