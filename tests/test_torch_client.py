"""The port's client mode (``ray_tpu_torch.util.client``): a separate
server process owns the cluster; this test process drives it purely over
the client protocol, through ``init(address="client://...")``, and never
joins the cluster. The twins of ``tests/test_client.py``, and tensors: a
bf16 tensor round-trips through the client bit for bit and a task's
tensor result comes back as a CPU tensor. A ``.bind`` graph runs through
the client too, since a DAG node submits through ``remote``.
"""

import gc
import os
import subprocess
import sys
import time

import pytest
import torch

from tests.test_torch_runtime_cluster import \
    retire_leftover_jax_runtime_for_later_files

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SERVER_SCRIPT = """
import asyncio, sys
sys.path.insert(0, %r)
from ray_tpu_torch.util.client.server import ClientServer

async def main():
    srv = ClientServer(None, host="127.0.0.1", port=0,
                       init_kwargs={"num_cpus": 8, "num_gpus": 0,
                                    "object_store_memory": 128 * 1024 * 1024})
    addr = await srv.start()
    print("READY %%d" %% addr[1], flush=True)
    await asyncio.Event().wait()

asyncio.run(main())
""" % REPO


@pytest.fixture(scope="module", autouse=True)
def _no_leftover_jax_runtime():
    """A JAX runtime that an earlier test file left up in this worker (JAX's
    serve router threads restart a shut one) is shut down after this file,
    so the next JAX file in the worker does not meet it (ROADMAP §C)."""
    yield
    retire_leftover_jax_runtime_for_later_files()


@pytest.fixture(scope="module")
def client_cluster():
    import ray_tpu_torch as rt

    env = dict(os.environ)
    env.setdefault("RAY_TPU_TORCH_LOG_LEVEL", "WARNING")
    proc = subprocess.Popen([sys.executable, "-c", SERVER_SCRIPT],
                            stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True, env=env)
    try:
        port = None
        deadline = time.time() + 60
        while time.time() < deadline:
            line = proc.stdout.readline()
            if line.startswith("READY"):
                port = int(line.split()[1])
                break
            if proc.poll() is not None:
                raise RuntimeError(
                    f"client server died: {proc.stdout.read()}")
        assert port, "client server never came up"
        info = rt.init(address=f"client://127.0.0.1:{port}")
        assert info.get("client")
        yield port
    finally:
        rt.shutdown()
        proc.terminate()
        proc.wait(timeout=30)


def test_put_get_roundtrip(client_cluster):
    import numpy as np

    import ray_tpu_torch as rt

    ref = rt.put({"a": np.arange(1000), "b": "hello"})
    out = rt.get(ref)
    assert out["b"] == "hello"
    np.testing.assert_array_equal(out["a"], np.arange(1000))


def test_bf16_tensor_roundtrip_bit_for_bit(client_cluster):
    import ray_tpu_torch as rt

    g = torch.Generator().manual_seed(0)
    x = torch.randn(33, 65, generator=g).to(torch.bfloat16)
    out = rt.get(rt.put({"t": x, "scalar": x[0, 0]}))
    assert out["t"].dtype == torch.bfloat16 and out["t"].device.type == "cpu"
    assert torch.equal(out["t"].view(torch.int16), x.view(torch.int16))
    assert torch.equal(out["scalar"].view(torch.int16),
                       x[0, 0].view(torch.int16))


def test_tensor_task_result_comes_back_on_the_cpu(client_cluster):
    import ray_tpu_torch as rt

    @rt.remote
    def double(t):
        return t * 2

    x = torch.arange(12, dtype=torch.float32).reshape(3, 4).to(torch.bfloat16)
    out = rt.get(double.remote(x))
    assert out.device.type == "cpu"
    assert torch.equal(out.view(torch.int16), (x * 2).view(torch.int16))


def test_remote_task_and_nested_refs(client_cluster):
    import ray_tpu_torch as rt

    @rt.remote
    def add(x, y):
        return x + y

    a = rt.put(10)
    r1 = add.remote(a, 5)          # client ref as an arg
    r2 = add.remote(r1, [1, 2][0])  # chained ref
    assert rt.get(r2) == 16


def test_dag_through_the_client(client_cluster):
    import ray_tpu_torch as rt
    from ray_tpu_torch.dag import InputNode

    @rt.remote
    def add(x, y):
        return x + y

    with InputNode() as inp:
        dag = add.bind(add.bind(inp, 1), 10)
    assert rt.get(dag.execute(5)) == 16


def test_task_exception_propagates(client_cluster):
    import ray_tpu_torch as rt

    @rt.remote
    def boom():
        raise ValueError("kaboom")

    with pytest.raises(Exception, match="kaboom"):
        rt.get(boom.remote())


def test_wait(client_cluster):
    import ray_tpu_torch as rt

    @rt.remote
    def fast():
        return 1

    @rt.remote
    def slow():
        import time as t

        t.sleep(5)
        return 2

    f, s = fast.remote(), slow.remote()
    ready, not_ready = rt.wait([f, s], num_returns=1, timeout=4)
    assert ready and rt.get(ready[0]) == 1
    assert len(not_ready) == 1


def test_actor_lifecycle(client_cluster):
    import ray_tpu_torch as rt

    @rt.remote
    class Counter:
        def __init__(self, start):
            self.n = start

        def incr(self, k=1):
            self.n += k
            return self.n

    c = Counter.options(name="client_counter").remote(100)
    assert rt.get(c.incr.remote()) == 101
    assert rt.get(c.incr.remote(9)) == 110

    # named lookup from the client
    c2 = rt.get_actor("client_counter")
    assert rt.get(c2.incr.remote()) == 111

    # handles can ride inside task args
    @rt.remote
    def poke(counter):
        import ray_tpu_torch as rt

        return rt.get(counter.incr.remote(1000))

    assert rt.get(poke.remote(c)) == 1111

    rt.kill(c)
    time.sleep(0.5)
    with pytest.raises(Exception):
        rt.get(c2.incr.remote(), timeout=5)


def test_cluster_queries(client_cluster):
    import ray_tpu_torch as rt

    assert len(rt.nodes()) >= 1
    assert rt.cluster_resources().get("CPU", 0) >= 8
    assert rt.available_resources().get("CPU", 0) >= 1
    assert rt.is_initialized()


def test_ref_release_doesnt_break_session(client_cluster):
    import ray_tpu_torch as rt

    refs = [rt.put(i) for i in range(20)]
    del refs
    gc.collect()
    # the next call flushes the release batch; the session still works
    assert rt.get(rt.put("still alive")) == "still alive"


def test_client_mode_refuses_a_second_init(client_cluster):
    import ray_tpu_torch as rt

    with pytest.raises(RuntimeError, match="twice"):
        rt.init()
    assert rt.init(ignore_reinit_error=True)["client"] is True


def test_server_listens_on_loopback_unless_told_otherwise():
    """Sessions are unauthenticated and their payloads are unpickled, so
    the port's server binds the loopback interface by default, in the
    constructor and on the command line (ROADMAP §C)."""
    import inspect

    from ray_tpu_torch.util.client import server

    sig = inspect.signature(server.ClientServer.__init__)
    assert sig.parameters["host"].default == "127.0.0.1"
    assert server._arg_parser().parse_args([]).host == "127.0.0.1"
    assert server._arg_parser().parse_args(
        ["--host", "0.0.0.0"]).host == "0.0.0.0"
