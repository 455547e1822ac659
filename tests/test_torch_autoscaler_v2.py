"""The port's autoscaler v2 (``ray_tpu_torch.autoscaler.v2``): the twins
of ``tests/test_autoscaler_v2.py`` (the instance manager's state machine,
the reconciler over a scripted fake cloud), each scenario also run
through the JAX package's ``Reconciler`` with its own fake provider and
the instance histories held equal, and ``reconcile`` driven every tick
against a live cluster's ``autoscaler_state``: a ``num_gpus=1`` task on
a head with no GPU walks a ``gpu`` instance from QUEUED to TERMINATED."""

import os
import sys
import threading
import time

import cloudpickle
import pytest

import ray_tpu_torch as rt
from ray_tpu.autoscaler import autoscaler as jax_autoscaler
from ray_tpu.autoscaler import node_provider as jax_node_provider
from ray_tpu.autoscaler import v2 as jax_v2
from ray_tpu_torch.autoscaler import autoscaler as port_autoscaler
from ray_tpu_torch.autoscaler import node_provider as port_node_provider
from ray_tpu_torch.autoscaler import v2 as port_v2
from ray_tpu_torch.autoscaler.autoscaler import (AutoscalerConfig,
                                                 fetch_autoscaler_state)
from ray_tpu_torch.autoscaler.node_provider import NodeProvider, NodeType
from ray_tpu_torch.autoscaler.v2 import (ALLOCATED, QUEUED, RAY_RUNNING,
                                        REQUESTED, TERMINATED, TERMINATING,
                                        InstanceManager, Reconciler)
from tests.test_torch_runtime_cluster import \
    retire_leftover_jax_runtime_for_later_files

os.environ.setdefault("RAY_TPU_TORCH_LOG_LEVEL", "WARNING")
cloudpickle.register_pickle_by_value(sys.modules[__name__])

TIMEOUT = 60


@pytest.fixture(scope="module", autouse=True)
def _no_leftover_jax_runtime():
    yield
    retire_leftover_jax_runtime_for_later_files()


class FakeProvider(NodeProvider):
    """Cloud stub: create_node queues allocations that 'arrive' when the
    test calls fill(); supports stockouts and preemption."""

    def __init__(self, stockout_types=()):
        self.pending = []  # (node_type_name, count)
        self.live = {}     # provider_id -> {"id", "node_type"}
        self.terminated = []
        self.stockout_types = set(stockout_types)
        self._n = 0

    def create_node(self, node_type, count: int):
        if node_type.name in self.stockout_types:
            return []  # the cloud accepted the request but never fills
        ids = []
        for _ in range(count):
            self._n += 1
            pid = f"prov-{self._n}"
            self.live[pid] = {"id": pid, "node_type": node_type.name}
            ids.append(pid)
        return ids

    def terminate_node(self, provider_node_id: str):
        self.live.pop(provider_node_id, None)
        self.terminated.append(provider_node_id)

    def non_terminated_nodes(self):
        return list(self.live.values())


# each package's v2 module, with its own config and node-type classes
PACKAGES = {
    "port": (port_v2, port_autoscaler, port_node_provider),
    "jax": (jax_v2, jax_autoscaler, jax_node_provider),
}


def _config(pkg="port", **kw):
    _, auto, prov = PACKAGES[pkg]
    return auto.AutoscalerConfig(
        node_types=[prov.NodeType(name="cpu4", resources={"CPU": 4.0},
                                  max_workers=kw.get("type_max", 10))],
        max_workers=kw.get("max_workers", 10),
    )


def _state(nodes=(), demand_on_first=()):
    out = []
    for i, n in enumerate(nodes):
        out.append(dict(n))
        if i == 0:
            out[0]["pending_demand"] = list(demand_on_first)
    return {"nodes": out}


def _node(node_id, provider_id="", cpu=4.0, avail=None):
    return {
        "node_id_hex": node_id, "alive": True,
        "total": {"CPU": cpu},
        "available": {"CPU": cpu if avail is None else avail},
        "labels": {"provider_id": provider_id} if provider_id else {},
        "pending_demand": [],
    }


class TestInstanceManager:
    def test_transitions_validated(self):
        im = InstanceManager()
        inst = im.create("cpu4", "req1")
        assert inst.status == QUEUED
        im.transition(inst, REQUESTED)
        im.transition(inst, ALLOCATED)
        with pytest.raises(ValueError, match="invalid transition"):
            im.transition(inst, QUEUED)
        assert [s for _, s, _ in inst.history] == [
            QUEUED, REQUESTED, ALLOCATED]

    def test_version_bumps(self):
        im = InstanceManager()
        v0 = im.version
        inst = im.create("cpu4", "r")
        im.transition(inst, REQUESTED)
        assert im.version == v0 + 2

    def test_transition_table_equals_the_jax_package(self):
        assert port_v2._VALID_TRANSITIONS == jax_v2._VALID_TRANSITIONS


# ---------------------------------------------------------- the scenarios
# each takes (v2 module, config, provider) and returns the reconciler;
# the JAX package's and the port's run the same script


def _lifecycle(v2, cfg, prov):
    r = v2.Reconciler(cfg, prov)
    # tick 1: unmet demand -> QUEUED -> REQUESTED (provider call)
    head = _node("head", cpu=0.0)
    s = r.reconcile(_state([head], demand_on_first=[{"CPU": 4.0}]))
    assert s["instances"][REQUESTED] == 1
    assert len(prov.live) == 1
    # tick 2: provider shows the node -> ALLOCATED
    s = r.reconcile(_state([head]))
    assert s["instances"][ALLOCATED] == 1
    # tick 3: node registered with the control plane -> RAY_RUNNING
    pid = next(iter(prov.live))
    s = r.reconcile(_state([head, _node("worker1", provider_id=pid)]))
    assert s["instances"][RAY_RUNNING] == 1
    # and the pass is idempotent: nothing new launches
    s = r.reconcile(_state([head, _node("worker1", provider_id=pid)]))
    assert s["launching"] == {}
    assert s["instances"][RAY_RUNNING] == 1
    return r


def _stockout(v2, cfg, prov):
    prov.stockout_types = {"cpu4"}
    r = v2.Reconciler(cfg, prov)
    r.ALLOCATION_TIMEOUT_S = 0.0  # expire immediately
    head = _node("head", cpu=0.0)
    r.reconcile(_state([head], demand_on_first=[{"CPU": 4.0}]))
    # next pass: REQUESTED times out -> ALLOCATION_FAILED -> retried
    s = r.reconcile(_state([head], demand_on_first=[{"CPU": 4.0}]))
    assert s["instances"][REQUESTED] == 1  # the retry re-requested
    inst = next(iter(r.im.instances.values()))
    assert inst.retries == 1
    # exhaust retries -> TERMINATED, no infinite loop
    for _ in range(8):
        r.reconcile(_state([head], demand_on_first=[{"CPU": 4.0}]))
    assert [i for i in r.im.instances.values()
            if i.retries >= r.MAX_ALLOCATION_RETRIES]
    return r


def _preempted(v2, cfg, prov):
    r = v2.Reconciler(cfg, prov)
    head = _node("head", cpu=0.0)
    r.reconcile(_state([head], demand_on_first=[{"CPU": 4.0}]))
    r.reconcile(_state([head]))  # ALLOCATED
    pid = next(iter(prov.live))
    r.reconcile(_state([head, _node("w1", provider_id=pid)]))
    # the cloud preempts the node out from under us
    prov.live.pop(pid)
    s = r.reconcile(_state([head]))
    assert s["instances"][RAY_RUNNING] == 0
    assert s["instances"][TERMINATED] == 1
    return r


def _idle(v2, cfg, prov):
    r = v2.Reconciler(cfg, prov, idle_timeout_s=0.0)
    head = _node("head", cpu=0.0)
    r.reconcile(_state([head], demand_on_first=[{"CPU": 4.0}]))
    r.reconcile(_state([head]))
    pid = next(iter(prov.live))
    worker = _node("w1", provider_id=pid)
    # fully idle + zero demand -> terminated via the state machine (with
    # idle_timeout 0 the pass that sees RAY_RUNNING may already reclaim)
    s = r.reconcile(_state([head, worker]))
    if not s["removed"]:
        s = r.reconcile(_state([head, worker]))
    assert s["removed"]
    assert prov.terminated == [pid]
    assert r.im.by_status(TERMINATED)
    return r


def _late_fill(v2, cfg, prov):
    """A request that times out and is retried may still fill later; the
    stray node (no instance left to claim it) must be terminated."""
    prov.stockout_types = {"cpu4"}
    r = v2.Reconciler(cfg, prov)
    r.ALLOCATION_TIMEOUT_S = 0.0
    head = _node("head", cpu=0.0)
    r.reconcile(_state([head], demand_on_first=[{"CPU": 4.0}]))
    # timeout -> ALLOCATION_FAILED -> retry (still stockout)
    r.reconcile(_state([head], demand_on_first=[{"CPU": 4.0}]))
    # exhaust retries so no REQUESTED instance remains
    for _ in range(8):
        r.reconcile(_state([head]))
    prov.stockout_types = set()
    prov._n += 1
    pid = f"prov-{prov._n}"
    prov.live[pid] = {"id": pid, "node_type": "cpu4"}
    r.reconcile(_state([head]))
    assert pid in prov.terminated, "late-filled orphan not reaped"
    return r


def _dead_node(v2, cfg, prov):
    r = v2.Reconciler(cfg, prov)
    head = _node("head", cpu=0.0)
    r.reconcile(_state([head], demand_on_first=[{"CPU": 4.0}]))
    r.reconcile(_state([head]))
    pid = next(iter(prov.live))
    r.reconcile(_state([head, _node("w1", provider_id=pid)]))
    # node vanishes from the cluster view but the cloud still bills it
    s = r.reconcile(_state([head]))
    assert s["instances"][RAY_RUNNING] == 0
    assert pid in prov.terminated  # reconciler cleaned the cloud side
    return r


def _two_types_capped(v2, cfg, prov):
    """Demand over the per-type cap and the cluster cap: only what fits
    launches, and a repeated pass adds nothing."""
    head = _node("head", cpu=0.0)
    r = v2.Reconciler(cfg, prov)
    demand = [{"CPU": 4.0}] * 5
    for _ in range(3):
        r.reconcile(_state([head], demand_on_first=demand))
    assert len(r.im.instances) == 2
    return r


SCENARIOS = {
    "demand_to_running_lifecycle": (_lifecycle, {}),
    "stockout_times_out_then_retries": (_stockout, {}),
    "preempted_instance_detected": (_preempted, {}),
    "idle_scale_down": (_idle, {}),
    "late_filled_abandoned_request_is_reaped": (_late_fill, {}),
    "dead_ray_node_terminated_at_provider": (_dead_node, {}),
    "caps": (_two_types_capped, {"type_max": 2, "max_workers": 3}),
}


def _histories(r):
    """Each instance's (status, reason) walk, in creation order."""
    return [(i.node_type, i.retries, [(s, why) for _, s, why in i.history])
            for i in r.im.instances.values()]


class TestReconciler:
    @pytest.mark.parametrize("name", sorted(SCENARIOS))
    def test_scenario(self, name):
        fn, kw = SCENARIOS[name]
        fn(port_v2, _config("port", **kw), FakeProvider())

    @pytest.mark.parametrize("name", sorted(SCENARIOS))
    def test_histories_equal_the_jax_package(self, name):
        """The same scenario through the JAX package's reconciler, with a
        fake cloud of its own: equal instance histories and equal calls
        to the cloud."""
        fn, kw = SCENARIOS[name]
        outs = []
        for pkg in ("port", "jax"):
            prov = FakeProvider()
            r = fn(PACKAGES[pkg][0], _config(pkg, **kw), prov)
            outs.append((_histories(r), r.im.version, sorted(prov.live),
                         prov.terminated))
        assert outs[0] == outs[1]
        assert outs[0][0], "the scenario made no instance"


# ------------------------------------------------ the loop, on a cluster


def _visible():
    return (rt.get_runtime_context().get_node_id(),
            os.environ.get("CUDA_VISIBLE_DEVICES"))


def test_reconcile_loop_walks_a_gpu_instance_through_its_life():
    """``reconcile`` every tick over a live cluster whose head has no GPU:
    a ``num_gpus=1`` task makes it launch the ``gpu`` type's node (card 0
    listed twice), the task runs there and sees card ``"0"``; once the
    node idles the instance is retired. Its history is QUEUED ->
    REQUESTED -> ALLOCATED -> RAY_RUNNING -> TERMINATING -> TERMINATED."""
    from ray_tpu_torch._private import api
    from ray_tpu_torch.autoscaler import LocalNodeProvider

    info = rt.init(num_cpus=2, num_gpus=0,
                   object_store_memory=64 * 1024 * 1024)
    core = api._require_core()
    provider = LocalNodeProvider(info["session_dir"], core.controller_addr)
    cfg = AutoscalerConfig(
        node_types=[NodeType("cpu", {"CPU": 2.0}),
                    NodeType("gpu", {"CPU": 2.0, "GPU": 2.0}, max_workers=1,
                             node_config={"gpu_ids": ["0", "0"]})],
        max_workers=2, update_interval_s=0.3)
    r = Reconciler(cfg, provider, idle_timeout_s=1.0)
    stop = threading.Event()

    def loop():
        while not stop.wait(cfg.update_interval_s):
            r.reconcile(fetch_autoscaler_state(core.controller_addr))

    thread = threading.Thread(target=loop, daemon=True)
    thread.start()
    try:
        node, visible = rt.get(
            rt.remote(_visible).options(num_gpus=1).remote(),
            timeout=TIMEOUT)
        assert visible == "0"
        # the pass that terminates the node also marks it TERMINATED
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline and (
                provider.non_terminated_nodes() and thread.is_alive()):
            time.sleep(0.2)
        stop.set()
        thread.join(TIMEOUT)
        assert not thread.is_alive()
        (inst,) = r.im.instances.values()
        assert inst.node_type == "gpu" and inst.node_id_hex == node
        assert [s for _, s, _ in inst.history] == [
            QUEUED, REQUESTED, ALLOCATED, RAY_RUNNING, TERMINATING,
            TERMINATED]
        assert provider.non_terminated_nodes() == []
    finally:
        stop.set()
        provider.shutdown()
        rt.shutdown()
