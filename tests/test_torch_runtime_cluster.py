"""The port's runtime across processes that stand for nodes (the cases of
``tests/test_multinode.py`` it needs): cross-node object pulls, actor
restart on node death and an actor without restarts that dies, GPU pinning
with a faked ``GPU`` resource, and the copy's own environment prefix (a
JAX cluster in the same process is never joined)."""

import os
import time

import numpy as np
import pytest
import torch

import ray_tpu
import ray_tpu_torch as rt
from ray_tpu_torch.cluster_utils import Cluster

# the copy reads only RAY_TPU_TORCH_* variables: fast failure detection
# for hermetic clusters (tests/conftest.py sets the JAX runtime's)
os.environ.setdefault("RAY_TPU_TORCH_LOG_LEVEL", "WARNING")
os.environ.setdefault("RAY_TPU_TORCH_HEALTH_CHECK_PERIOD_MS", "200")
os.environ.setdefault("RAY_TPU_TORCH_HEALTH_CHECK_TIMEOUT_MS", "1000")
os.environ.setdefault("RAY_TPU_TORCH_HEALTH_CHECK_FAILURE_THRESHOLD", "3")


def _wait_for(pred, timeout=30.0, interval=0.2, msg="condition"):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return
        time.sleep(interval)
    raise TimeoutError(f"timed out waiting for {msg}")


@pytest.fixture
def cluster():
    c = Cluster()
    yield c
    if rt.is_initialized():
        rt.shutdown()
    c.shutdown()


@rt.remote
def _node_id():
    return rt.get_runtime_context().node_id


@rt.remote
def _make_array(n):
    return np.arange(n, dtype=np.float64)


@rt.remote
def _make_tensor(n):
    return torch.arange(n, dtype=torch.float32).to(torch.bfloat16)


@rt.remote
def _double(x):
    return x * 2


def test_cross_node_object_pull(cluster):
    """Arena-sized objects made on node A are pulled to node B: a numpy
    array and a bf16 tensor, bit for bit."""
    cluster.add_node(num_cpus=2, resources={"nodeA": 10})
    cluster.add_node(num_cpus=2, resources={"nodeB": 10})
    cluster.wait_for_nodes(2)
    rt.init(address=cluster.address)
    a = rt.get(_node_id.options(resources={"nodeA": 1}).remote(), timeout=60)
    b = rt.get(_node_id.options(resources={"nodeB": 1}).remote(), timeout=60)
    assert a != b
    ref = _make_array.options(resources={"nodeA": 1}).remote(300_000)
    out = rt.get(_double.options(resources={"nodeB": 1}).remote(ref),
                 timeout=60)
    np.testing.assert_array_equal(out, np.arange(300_000) * 2.0)
    tref = _make_tensor.options(resources={"nodeA": 1}).remote(300_000)
    got = rt.get(_double.options(resources={"nodeB": 1}).remote(tref),
                 timeout=60)
    want = torch.arange(300_000, dtype=torch.float32).to(torch.bfloat16) * 2
    assert got.dtype == torch.bfloat16
    assert torch.equal(got.view(torch.int16), want.view(torch.int16))


def test_actor_restart_on_node_death(cluster):
    cluster.add_node(num_cpus=2, resources={"stable": 10})
    victim = cluster.add_node(num_cpus=2, resources={"doomed": 10})
    cluster.wait_for_nodes(2)
    rt.init(address=cluster.address)

    @rt.remote
    class Counter:
        def __init__(self):
            self.n = 0

        def incr(self):
            self.n += 1
            return self.n

        def node(self):
            return rt.get_runtime_context().node_id

    c = Counter.options(max_restarts=1, num_cpus=1,
                        resources={"doomed": 1}).remote()
    assert rt.get(c.incr.remote(), timeout=60) == 1
    doomed = rt.get(c.node.remote(), timeout=60)
    cluster.remove_node(victim)
    cluster.add_node(num_cpus=2, resources={"doomed": 10})
    cluster.wait_for_nodes(2)

    def restarted():
        # an answer from the dying node's worker is not the restart
        try:
            return rt.get(c.node.remote(), timeout=5) != doomed
        except Exception:
            return False

    _wait_for(restarted, timeout=30, msg="actor restart")
    # restarted from scratch: its state is a fresh counter's
    assert rt.get(c.incr.remote(), timeout=30) == 1


def test_actor_without_restarts_dies(cluster):
    cluster.add_node(num_cpus=2)
    victim = cluster.add_node(num_cpus=2, resources={"doomed": 10})
    cluster.wait_for_nodes(2)
    rt.init(address=cluster.address)

    @rt.remote
    class A:
        def ping(self):
            return "pong"

    a = A.options(resources={"doomed": 1}).remote()
    assert rt.get(a.ping.remote(), timeout=60) == "pong"
    cluster.remove_node(victim)
    _wait_for(lambda: sum(1 for v in rt.nodes() if v["alive"]) == 1,
              timeout=30, msg="node death declaration")
    with pytest.raises(Exception):
        rt.get(a.ping.remote(), timeout=30)


@rt.remote
class _GpuProbe:
    def visible(self):
        return (os.getpid(), os.environ.get("CUDA_VISIBLE_DEVICES"),
                rt.get_runtime_context().get_gpu_ids())


@rt.remote
def _visible():
    return os.getpid(), os.environ.get("CUDA_VISIBLE_DEVICES")


def test_gpu_pinning_with_a_faked_resource():
    """Two num_gpus=1 actors on a node that claims 2 GPUs see distinct
    cards; a task with no GPU sees none; pooled GPU task workers keep the
    card they were spawned for, and a third GPU actor pends until a card
    is free."""
    rt.init(num_cpus=8, num_gpus=2)
    try:
        assert rt.cluster_resources()["GPU"] == 2
        a, b = (_GpuProbe.options(num_gpus=1).remote() for _ in range(2))
        (_, va, ida), (_, vb, idb) = rt.get(
            [a.visible.remote(), b.visible.remote()], timeout=60)
        assert {va, vb} == {"0", "1"}
        assert ida == [va] and idb == [vb]
        assert rt.get(_visible.remote(), timeout=60)[1] == ""
        third = _GpuProbe.options(num_gpus=1).remote()
        ready, _ = rt.wait([third.visible.remote()], timeout=2)
        assert not ready  # both cards are held by live actors
        rt.kill(a)
        pid, vc, _ = rt.get(third.visible.remote(), timeout=60)
        assert vc == va  # the card a gave back
        rt.kill(b)
        rt.kill(third)
        # sequential and concurrent GPU tasks: a worker process never
        # changes its card, whatever lease it is pooled back into
        seen = {}
        for _ in range(3):
            outs = rt.get([_visible.options(num_gpus=1).remote()
                           for _ in range(4)], timeout=60)
            for pid, v in outs:
                assert v in ("0", "1")
                assert seen.setdefault(pid, v) == v
    finally:
        rt.shutdown()


def test_never_joins_a_jax_cluster(monkeypatch):
    """A JAX cluster in the same process sets RAY_TPU_ADDRESS and
    RAY_TPU_SESSION_DIR; the port reads and writes only its own prefix, so
    it starts its own cluster under its own session root."""
    monkeypatch.delenv("RAY_TPU_TORCH_ADDRESS", raising=False)
    monkeypatch.delenv("RAY_TPU_TORCH_SESSION_DIR", raising=False)
    jax_info = ray_tpu.init(num_cpus=2,
                            object_store_memory=64 * 1024 * 1024)
    try:
        assert os.environ.get("RAY_TPU_ADDRESS")
        with pytest.raises(ConnectionError, match="RAY_TPU_TORCH_ADDRESS"):
            rt.init(address="auto")
        info = rt.init(num_cpus=2, num_gpus=0,
                       object_store_memory=64 * 1024 * 1024)
        try:
            assert info["address"] != jax_info["address"]
            assert os.path.basename(os.path.dirname(
                info["session_dir"])) == "ray_tpu_torch"
            assert os.environ["RAY_TPU_TORCH_SESSION_DIR"] == \
                info["session_dir"]
            assert os.environ["RAY_TPU_SESSION_DIR"] != info["session_dir"]
            port_nodes = {n["node_id_hex"] for n in rt.nodes()}
            jax_nodes = {n["node_id_hex"] for n in ray_tpu.nodes()}
            assert port_nodes and jax_nodes and not port_nodes & jax_nodes
            assert rt.get(_double.remote(21), timeout=60) == 42
        finally:
            rt.shutdown()
    finally:
        ray_tpu.shutdown()
