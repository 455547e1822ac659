"""The port's runtime across processes that stand for nodes (the cases of
``tests/test_multinode.py`` it needs): cross-node object pulls, actor
restart on node death and an actor without restarts that dies, GPU pinning
with a faked ``GPU`` resource, and the copy's own environment prefix (a
JAX cluster in the same process is never joined)."""

import os
import threading
import time
import warnings

import numpy as np
import pytest
import torch

import ray_tpu
import ray_tpu_torch as rt
from ray_tpu import serve as jserve
from ray_tpu.serve._private.router import Router as JaxRouter
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


# How long a JAX router thread can take to see its stop: its long-poll get
# gives up after ``LONG_POLL_TIMEOUT_S + 30`` s (``ray_tpu/serve/_private/
# router.py``, ``Router._poll_loop``), and a runtime an earlier file left
# up may never answer it; 15 s more of margin.
RETIRE_TIMEOUT_S = JaxRouter.LONG_POLL_TIMEOUT_S + 45


def retire_leftover_jax_runtime(timeout: float = RETIRE_TIMEOUT_S) -> None:
    """Shut down a JAX runtime that an earlier test left up in this
    process, and the JAX router threads that would start it again.

    The JAX serve router's polling threads (``ray_tpu/serve/_private/
    router.py``, ``Router._poll_loop`` and ``_digest_poll_loop``) go on
    calling ``ray_tpu.get``/``.remote()`` after a test file's
    ``ray_tpu.shutdown()``, and the JAX ``_require_core`` then starts a
    new local cluster that nothing shuts down; the next
    ``ray_tpu.init()`` in the process raises "called twice" (ROADMAP §C).
    The JAX package is left as it is, so the tests that start a JAX
    cluster of their own call this first. It waits for each thread as long
    as that thread's long-poll get can block (``RETIRE_TIMEOUT_S``); the
    wait is paid only where such a thread exists."""
    threads = [t for t in threading.enumerate()
               if isinstance(getattr(getattr(t, "_target", None),
                                     "__self__", None), JaxRouter)]
    for t in threads:
        t._target.__self__.stop()
    if ray_tpu.is_initialized():
        ray_tpu.shutdown()  # a thread blocked in a get wakes and returns
    for t in threads:
        t.join(timeout)
    assert not any(t.is_alive() for t in threads), "JAX router threads"
    if ray_tpu.is_initialized():
        ray_tpu.shutdown()  # one a thread started before it saw stop()



def retire_leftover_jax_runtime_for_later_files() -> None:
    """``retire_leftover_jax_runtime`` for a port test file that starts no
    JAX runtime itself: after the file, it retires one that an earlier file
    left up in this worker, so the JAX files that follow do not meet it. A
    JAX thread that still does not stop is reported as a warning: the port
    file's own tests never touch it."""
    try:
        retire_leftover_jax_runtime()
    except AssertionError as e:
        warnings.warn(f"a JAX runtime left up by an earlier test file "
                      f"could not be retired: {e}")


class _SilentRef:
    """A long-poll reference that no runtime answers: its get blocks for
    its whole timeout, then gives up. ``ray_tpu.get`` hands it its timeout
    through the compiled-graph path, so no JAX runtime is needed."""
    _is_compiled_dag_ref = True

    def get(self, timeout=None):
        time.sleep(timeout)
        raise TimeoutError("the long poll was not answered")


class _SilentController:
    """A JAX serve controller whose ``listen_for_change`` never answers."""

    def __init__(self):
        self.listen_for_change = self

    def remote(self, *args):
        return _SilentRef()


def test_retire_waits_out_a_router_thread_blocked_in_its_long_poll():
    """The state the port's cluster tests met in a whole parallel run: a
    JAX router thread left by an earlier file, blocked in its long-poll
    get (``timeout=LONG_POLL_TIMEOUT_S + 30``) on a runtime that does not
    answer it within 30 s. ``retire_leftover_jax_runtime`` with its
    default wait stops the thread and waits until its get gives up, so no
    "JAX router threads" error reaches the caller."""
    retire_leftover_jax_runtime()
    router = JaxRouter(_SilentController(), "silent", "silent")
    router.LONG_POLL_TIMEOUT_S = 1.0  # its get blocks 31 s
    router._ensure_polling()
    thread = router._poll_thread
    t0 = time.monotonic()
    retire_leftover_jax_runtime()
    waited = time.monotonic() - t0
    assert not thread.is_alive()
    assert waited >= router.LONG_POLL_TIMEOUT_S + 30 - 1.0
    assert RETIRE_TIMEOUT_S >= JaxRouter.LONG_POLL_TIMEOUT_S + 30


@jserve.deployment
class _JaxEcho:
    def __call__(self, x):
        return x


def test_jax_router_threads_restart_a_shut_down_jax_runtime():
    """The state ``test_never_joins_a_jax_cluster`` met under the
    parallel run: a JAX handle used in this process leaves router threads
    that start a new JAX runtime within seconds of ``serve.shutdown()``
    and ``ray_tpu.shutdown()``; ``retire_leftover_jax_runtime`` stops them
    and shuts that runtime down for good."""
    retire_leftover_jax_runtime()
    ray_tpu.init(num_cpus=2, object_store_memory=64 * 1024 * 1024)
    try:
        h = jserve.run(_JaxEcho.bind(), name="leak", route_prefix="/leak")
        assert h.remote(3).result(timeout=60) == 3
    finally:
        jserve.shutdown()
        ray_tpu.shutdown()
    _wait_for(ray_tpu.is_initialized, msg="the JAX router to restart a "
                                          "JAX runtime")
    retire_leftover_jax_runtime()
    assert not ray_tpu.is_initialized()
    time.sleep(2.0)  # longer than the routers' retry sleeps
    assert not ray_tpu.is_initialized()


def test_never_joins_a_jax_cluster(monkeypatch):
    """A JAX cluster in the same process sets RAY_TPU_ADDRESS and
    RAY_TPU_SESSION_DIR; the port reads and writes only its own prefix, so
    it starts its own cluster under its own session root."""
    monkeypatch.delenv("RAY_TPU_TORCH_ADDRESS", raising=False)
    monkeypatch.delenv("RAY_TPU_TORCH_SESSION_DIR", raising=False)
    # under a parallel run, an earlier file in this worker process may
    # have left a JAX runtime up (see retire_leftover_jax_runtime)
    retire_leftover_jax_runtime()
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
