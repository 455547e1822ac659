"""The port's autoscaler v1 (``ray_tpu_torch.autoscaler``): the twins of
``tests/test_autoscaler.py`` (packing, and end to end over real
supervisor processes through ``LocalNodeProvider``; its ``TestTPUShapes``
has no counterpart), the packing functions held equal to the JAX
package's on seeded random demands and node types, and GPU node types: a
launched node hands its workers the card ids its type names, whatever
``CUDA_VISIBLE_DEVICES`` the caller holds. The end-to-end cases share
one cluster; every ``get`` waits at most ``TIMEOUT`` seconds."""

import os
import sys
import time

import cloudpickle
import numpy as np
import pytest

import ray_tpu_torch as rt
from ray_tpu.autoscaler import autoscaler as jax_autoscaler
from ray_tpu.autoscaler.node_provider import NodeType as JaxNodeType
from ray_tpu_torch.autoscaler import (AutoscalerConfig, LocalNodeProvider,
                                      NodeType, StandardAutoscaler)
from ray_tpu_torch.autoscaler import autoscaler as port_autoscaler
from ray_tpu_torch.autoscaler.autoscaler import (_nodes_to_launch,
                                                 _unmet_after_packing)
from ray_tpu_torch.autoscaler.node_provider import gpu_ids
from ray_tpu_torch.cluster_utils import Cluster
from tests.test_torch_runtime_cluster import \
    retire_leftover_jax_runtime_for_later_files

os.environ.setdefault("RAY_TPU_TORCH_LOG_LEVEL", "WARNING")
cloudpickle.register_pickle_by_value(sys.modules[__name__])

TIMEOUT = 60


@pytest.fixture(scope="module", autouse=True)
def _no_leftover_jax_runtime():
    yield
    retire_leftover_jax_runtime_for_later_files()


class TestPacking:
    def test_unmet_after_packing_uses_existing_capacity(self):
        alive = [{"available": {"CPU": 2.0}}]
        demand = [{"CPU": 1.0}, {"CPU": 1.0}, {"CPU": 1.0}]
        unmet = _unmet_after_packing(demand, alive, [])
        assert unmet == [{"CPU": 1.0}]

    def test_nodes_to_launch_packs_multiple_bundles_per_node(self):
        unmet = [{"CPU": 1.0}] * 4
        types = [NodeType("quad", {"CPU": 4.0})]
        launches = _nodes_to_launch(unmet, types, current=0, max_workers=8)
        assert launches == {"quad": 1}

    def test_nodes_to_launch_prefers_smallest_feasible(self):
        unmet = [{"CPU": 1.0}]
        types = [NodeType("big", {"CPU": 16.0}),
                 NodeType("small", {"CPU": 2.0})]
        launches = _nodes_to_launch(unmet, types, current=0, max_workers=8)
        assert launches == {"small": 1}

    def test_nodes_to_launch_respects_max_workers(self):
        unmet = [{"CPU": 4.0}] * 5
        types = [NodeType("quad", {"CPU": 4.0})]
        launches = _nodes_to_launch(unmet, types, current=3, max_workers=5)
        assert launches == {"quad": 2}

    def test_unfittable_bundle_skipped(self):
        unmet = [{"GPU": 8.0}]
        types = [NodeType("cpuonly", {"CPU": 4.0})]
        assert _nodes_to_launch(unmet, types, current=0, max_workers=8) == {}

    def test_gpu_bundles_go_to_the_gpu_type(self):
        """Two one-card bundles pack onto one node of the type that counts
        two cards (the smaller CPU type cannot hold them); a CPU bundle
        that no longer fits there opens a CPU node; the per-type cap
        holds."""
        types = [NodeType("cpu", {"CPU": 2.0}),
                 NodeType("gpu", {"CPU": 2.0, "GPU": 2.0}, max_workers=1)]
        unmet = [{"CPU": 1.0, "GPU": 1.0}] * 2
        assert _nodes_to_launch(unmet, types, current=0,
                                max_workers=8) == {"gpu": 1}
        assert _nodes_to_launch(unmet + [{"CPU": 1.0}], types, current=0,
                                max_workers=8) == {"gpu": 1, "cpu": 1}
        # a third card needs a second gpu node, which its cap refuses
        assert _nodes_to_launch([{"GPU": 1.0}] * 3, types, current=0,
                                max_workers=8) == {"gpu": 1}
        assert _nodes_to_launch([{"GPU": 1.0}], types, current=0,
                                max_workers=8,
                                existing_by_type={"gpu": 1}) == {}


def _random_case(seed: int):
    """Seeded demands, node types and live nodes over CPU, GPU and a
    custom resource."""
    rng = np.random.default_rng(seed)
    keys = ["CPU", "GPU", "memory_gb"]

    def bundle(hi):
        out = {}
        for k in keys:
            if rng.random() < (0.9 if k == "CPU" else 0.4):
                out[k] = float(rng.integers(1, hi + 1))
        return out or {"CPU": 1.0}

    types = [(f"t{i}", bundle(8), int(rng.integers(1, 4)))
             for i in range(int(rng.integers(1, 5)))]
    demand = [bundle(4) for _ in range(int(rng.integers(0, 12)))]
    alive = [{"available": bundle(4)} for _ in range(int(rng.integers(0, 3)))]
    pending = [int(i) for i in rng.integers(0, len(types),
                                            int(rng.integers(0, 3)))]
    current = int(rng.integers(0, 4))
    max_workers = int(rng.integers(1, 8))
    existing = {name: int(rng.integers(0, 2)) for name, _, _ in types}
    return types, demand, alive, pending, current, max_workers, existing


@pytest.mark.parametrize("seed", range(8))
def test_packing_equals_the_jax_package(seed):
    """``_unmet_after_packing`` then ``_nodes_to_launch`` of the port and
    of the JAX package on the same seeded inputs give equal outputs."""
    types, demand, alive, pending, current, max_workers, existing = \
        _random_case(seed)
    outs = []
    for nt_cls, mod in ((NodeType, port_autoscaler),
                        (JaxNodeType, jax_autoscaler)):
        node_types = [nt_cls(n, dict(r), max_workers=m) for n, r, m in types]
        unmet = mod._unmet_after_packing(
            [dict(b) for b in demand], [dict(a) for a in alive],
            [node_types[i] for i in pending])
        launches = mod._nodes_to_launch(
            unmet, node_types, current=current, max_workers=max_workers,
            existing_by_type=dict(existing))
        outs.append((unmet, launches))
    assert outs[0] == outs[1]


class TestGpuIds:
    def test_default_is_zero_to_n(self):
        assert gpu_ids(NodeType("g", {"CPU": 1, "GPU": 3})) == ["0", "1",
                                                               "2"]
        assert gpu_ids(NodeType("c", {"CPU": 1})) == []

    def test_one_card_listed_twice(self):
        nt = NodeType("g", {"GPU": 2}, node_config={"gpu_ids": [0, 0]})
        assert gpu_ids(nt) == ["0", "0"]

    @pytest.mark.parametrize("resources,ids", [
        ({"GPU": 2}, ["0"]),          # fewer ids than cards
        ({"GPU": 1}, ["0", "1"]),     # more ids than cards
        ({"GPU": 0.5}, None),         # not a whole card
    ])
    def test_refused(self, resources, ids):
        cfg = {} if ids is None else {"gpu_ids": ids}
        with pytest.raises(ValueError):
            gpu_ids(NodeType("g", resources, node_config=cfg))


@pytest.fixture(scope="module")
def cluster():
    c = Cluster()
    c.add_node(num_cpus=2)
    c.wait_for_nodes(1)
    rt.init(address=c.address)
    yield c
    rt.shutdown()
    c.shutdown()


def _node_where():
    return rt.get_runtime_context().get_node_id()


class _Card:
    def where(self):
        return (rt.get_runtime_context().get_node_id(),
                os.environ.get("CUDA_VISIBLE_DEVICES"))


class TestEndToEnd:
    def test_infeasible_demand_launches_node_then_runs(self, cluster):
        """Infeasible demand -> provider adds a node -> the parked lease is
        rescued and the task runs."""
        provider = LocalNodeProvider(cluster.session_dir,
                                     cluster.controller_addr)
        autoscaler = StandardAutoscaler(
            cluster.controller_addr, provider,
            AutoscalerConfig(
                node_types=[NodeType("quad", {"CPU": 4.0})],
                max_workers=2, update_interval_s=0.5))
        try:
            ref = rt.remote(_node_where).options(num_cpus=4).remote()
            # let the supervisor gossip the pending demand
            deadline = time.monotonic() + 10
            summary = {"launched": {}}
            while time.monotonic() < deadline and not summary["launched"]:
                time.sleep(0.3)
                summary = autoscaler.update()
            assert summary["launched"] == {"quad": 1}
            assert rt.get(ref, timeout=TIMEOUT)
            # second update inside the grace window: no double launch
            assert autoscaler.update()["launched"] == {}
        finally:
            autoscaler.stop()
            provider.shutdown()

    def test_idle_autoscaled_node_scaled_down(self, cluster):
        provider = LocalNodeProvider(cluster.session_dir,
                                     cluster.controller_addr)
        autoscaler = StandardAutoscaler(
            cluster.controller_addr, provider,
            AutoscalerConfig(
                node_types=[NodeType("quad", {"CPU": 4.0})],
                max_workers=2, idle_timeout_s=1.5, launch_grace_s=3.0))
        try:
            (pid,) = provider.create_node(NodeType("quad", {"CPU": 4.0}), 1)
            deadline = time.monotonic() + 30
            removed = []
            while time.monotonic() < deadline and not removed:
                time.sleep(0.5)
                removed = autoscaler.update()["removed"]
            assert removed == [pid], "idle node never scaled down"
            assert provider.non_terminated_nodes() == []
        finally:
            autoscaler.stop()
            provider.shutdown()

    def test_gpu_node_hands_out_its_own_card_ids(self, cluster):
        """Two ``num_gpus=1`` actors, with no card anywhere in the
        cluster, make the loop launch one node of the type that lists card
        0 twice; both actors land there and see ``"0"``, though this
        process holds another ``CUDA_VISIBLE_DEVICES``. After they are
        killed the node is retired."""
        from ray_tpu_torch.util import state

        provider = LocalNodeProvider(cluster.session_dir,
                                     cluster.controller_addr)
        autoscaler = StandardAutoscaler(
            cluster.controller_addr, provider,
            AutoscalerConfig(
                node_types=[NodeType("cpu", {"CPU": 2.0}),
                            NodeType("gpu", {"CPU": 2.0, "GPU": 2.0},
                                     max_workers=1,
                                     node_config={"gpu_ids": ["0", "0"]})],
                max_workers=2, update_interval_s=0.3, idle_timeout_s=1.0))
        saved = os.environ.get("CUDA_VISIBLE_DEVICES")
        os.environ["CUDA_VISIBLE_DEVICES"] = "5,6"
        autoscaler.run_in_thread()
        try:
            Card = rt.remote(_Card).options(num_gpus=1, num_cpus=1)
            actors = [Card.remote() for _ in range(2)]
            where = rt.get([a.where.remote() for a in actors],
                           timeout=TIMEOUT)
            (rec,) = provider.non_terminated_nodes()
            assert rec["node_type"] == "gpu"
            node = next(n for n in state.list_nodes()
                        if n["labels"].get("provider_id") == rec["id"])
            assert node["total"]["GPU"] == 2.0
            assert node["labels"]["node_type"] == "gpu"
            assert where == [(node["node_id_hex"], "0")] * 2
            for a in actors:
                rt.kill(a)
            deadline = time.monotonic() + 30
            while time.monotonic() < deadline and \
                    provider.non_terminated_nodes():
                time.sleep(0.2)
            assert provider.non_terminated_nodes() == []
        finally:
            autoscaler.stop()
            provider.shutdown()
            if saved is None:
                os.environ.pop("CUDA_VISIBLE_DEVICES", None)
            else:
                os.environ["CUDA_VISIBLE_DEVICES"] = saved

    def test_a_reused_node_name_gets_the_live_address(self, cluster):
        """A second provider in the session names its first node as the
        first one did; the address it records is its own live
        supervisor's, not the one the dead node left in the session
        directory."""
        import asyncio

        from ray_tpu_torch._private.rpc import RpcClient

        nt = NodeType("solo", {"CPU": 1.0})
        first = LocalNodeProvider(cluster.session_dir,
                                  cluster.controller_addr)
        (name,) = first.create_node(nt, 1)
        first.shutdown()
        second = LocalNodeProvider(cluster.session_dir,
                                   cluster.controller_addr)
        try:
            assert second.create_node(nt, 1) == [name]
            addr = second._nodes[name]["address"]

            async def ping():
                client = RpcClient(tuple(addr), connect_timeout_s=5)
                try:
                    return await client.call("ping", timeout=5)
                finally:
                    await client.close()

            asyncio.run(ping())
        finally:
            second.shutdown()
