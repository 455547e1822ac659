"""Placement groups in the port's runtime (``ray_tpu_torch.util.
placement_group``), on the CPU: bundles and the group table, the four
strategies on one node (and STRICT_SPREAD across two), an actor in a
bundle, ``ready()``, removal giving the resources back, and a bundle that
holds ``GPU`` on a cluster that declares ``num_gpus=1`` (no card needed:
the supervisor hands out the card id ``"0"``, which the actor sees in
``CUDA_VISIBLE_DEVICES``). Every ``get`` waits at most ``TIMEOUT``
seconds; a group that cannot place is shown by a ``wait`` that times out.
"""

import os
import time

import pytest

import ray_tpu_torch as rt
from ray_tpu_torch._private.exceptions import PlacementGroupError
from ray_tpu_torch.cluster_utils import Cluster
from ray_tpu_torch.util import (PlacementGroup, placement_group,
                                placement_group_table,
                                remove_placement_group)

os.environ.setdefault("RAY_TPU_TORCH_LOG_LEVEL", "WARNING")

TIMEOUT = 60


@rt.remote
class Probe:
    def where(self):
        ctx = rt.get_runtime_context()
        return ctx.get_node_id(), os.environ.get("CUDA_VISIBLE_DEVICES")


@rt.remote
def _visible():
    return os.environ.get("CUDA_VISIBLE_DEVICES")


@pytest.fixture(scope="class")
def cluster():
    rt.init(num_cpus=4, num_gpus=1, object_store_memory=64 * 1024 * 1024)
    yield
    rt.shutdown()


def _cpus_become(want: float, timeout: float = 10.0) -> bool:
    """The controller's view of free CPUs follows the supervisors' periodic
    sync: poll it."""
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if rt.available_resources().get("CPU", 0) == want:
            return True
        time.sleep(0.05)
    return False


def _record(pg):
    return next(r for r in placement_group_table()
                if r["pg_id_hex"] == pg.id.hex())


class TestOneNode:
    """One node that declares 4 CPUs and 1 GPU."""

    def test_bundles_table_and_ready(self, cluster):
        before = rt.available_resources()["CPU"]
        pg = placement_group([{"CPU": 1}, {"CPU": 2}], strategy="PACK",
                             name="two")
        try:
            assert isinstance(pg, PlacementGroup) and pg.bundle_count == 2
            assert rt.get(pg.ready(), timeout=TIMEOUT) is True
            assert pg.wait(TIMEOUT)
            rec = _record(pg)
            assert rec["state"] == "CREATED" and rec["strategy"] == "PACK"
            assert rec["bundles"] == [{"CPU": 1.0}, {"CPU": 2.0}]
            assert _cpus_become(before - 3)
        finally:
            remove_placement_group(pg)


    def test_actor_in_a_bundle(self, cluster):
        pg = placement_group([{"CPU": 1}, {"CPU": 1}])
        assert pg.wait(TIMEOUT)
        try:
            actors = [Probe.options(num_cpus=1, placement_group=pg,
                                    placement_group_bundle_index=i).remote()
                      for i in range(2)]
            nodes = rt.get([a.where.remote() for a in actors], timeout=TIMEOUT)
            assert len({n for n, _ in nodes}) == 1
            # no card asked for: the bundle's workers see none
            assert all(v == "" for _, v in nodes)
            # the bundle is full: a third actor on bundle 0 waits
            extra = Probe.options(num_cpus=1, placement_group=pg,
                                  placement_group_bundle_index=0).remote()
            ready, _ = rt.wait([extra.where.remote()], timeout=2)
            assert not ready
            rt.kill(actors[0])
            assert rt.get(extra.where.remote(), timeout=TIMEOUT)[1] == ""
            for a in (actors[1], extra):
                rt.kill(a)
        finally:
            remove_placement_group(pg)


    @pytest.mark.parametrize("strategy,places", [
        ("PACK", True), ("SPREAD", True), ("STRICT_PACK", True),
        ("STRICT_SPREAD", False)])
    def test_strategies_on_one_node(self, cluster, strategy, places):
        """Two one-CPU bundles on one node: every strategy places them but
        STRICT_SPREAD, which needs two nodes and stays pending."""
        pg = placement_group([{"CPU": 1}, {"CPU": 1}], strategy=strategy)
        try:
            assert pg.wait(TIMEOUT if places else 1.5) is places
            assert _record(pg)["state"] == ("CREATED" if places else "PENDING")
        finally:
            remove_placement_group(pg)


    def test_refuses_bad_arguments(self, cluster):
        with pytest.raises(ValueError, match="strategy"):
            placement_group([{"CPU": 1}], strategy="BOGUS")
        with pytest.raises(ValueError, match="bundles"):
            placement_group([{"CPU": 1}, {}])
        with pytest.raises(TypeError, match="PlacementGroup"):
            Probe.options(placement_group="pg").remote()


    def test_remove_gives_the_resources_back(self, cluster):
        before = rt.available_resources()["CPU"]
        pg = placement_group([{"CPU": 2}])
        assert pg.wait(TIMEOUT)
        assert _cpus_become(before - 2)
        remove_placement_group(pg)
        assert _record(pg)["state"] == "REMOVED"
        with pytest.raises(PlacementGroupError, match="removed"):
            pg.wait(TIMEOUT)
        assert _cpus_become(before)


    def test_gpu_bundle(self, cluster):
        """A bundle holding the cluster's one GPU: its actor is given card
        "0"; a GPU task outside the group waits while the bundle holds the
        card, and runs once the group is removed and the actor is gone."""
        pg = placement_group([{"CPU": 1, "GPU": 1}])
        assert pg.wait(TIMEOUT)
        a = Probe.options(num_cpus=1, num_gpus=1, placement_group=pg,
                          placement_group_bundle_index=0).remote()
        assert rt.get(a.where.remote(), timeout=TIMEOUT)[1] == "0"
        outside = _visible.options(num_gpus=1).remote()
        ready, _ = rt.wait([outside], timeout=2)
        assert not ready
        rt.kill(a)
        remove_placement_group(pg)
        assert rt.get(outside, timeout=TIMEOUT) == "0"


def test_strict_spread_across_two_nodes():
    c = Cluster()
    try:
        c.add_node(num_cpus=2)
        c.add_node(num_cpus=2)
        c.wait_for_nodes(2)
        rt.init(address=c.address)
        pg = placement_group([{"CPU": 1}, {"CPU": 1}],
                             strategy="STRICT_SPREAD")
        assert rt.get(pg.ready(), timeout=TIMEOUT)
        probes = [Probe.options(num_cpus=1, placement_group=pg,
                                placement_group_bundle_index=i).remote()
                  for i in range(2)]
        nodes = rt.get([p.where.remote() for p in probes], timeout=TIMEOUT)
        assert nodes[0][0] != nodes[1][0]
        three = placement_group([{"CPU": 1}] * 3, strategy="STRICT_SPREAD")
        assert not three.wait(1.5)
        remove_placement_group(three)
        remove_placement_group(pg)
    finally:
        if rt.is_initialized():
            rt.shutdown()
        c.shutdown()
