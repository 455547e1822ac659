"""The port's binary RPC ingress against the JAX package's, side by side:
the same deployments behind JAX's ``serve.start_rpc_ingress`` and the
port's, the same calls through each package's ``ServeRpcClient``, equal
answers. The cases: the three of ``tests/test_serve_rpc_ingress.py``
(unary, streamed, multiplexed) and the three of
``tests/test_cpp_serve_client.py``, with ``cpp/serve_client/demo.cpp``
compiled by g++ as it is and run against both ingresses. A JAX-side call
that times out runs once more (``test_torch_serve_http.jax_side``)."""

import os
import subprocess

import pytest

import ray_tpu
import ray_tpu_torch as rt
from ray_tpu import serve as jserve
from ray_tpu.serve.rpc_ingress_client import ServeRpcClient as JaxClient
from ray_tpu_torch import serve
from ray_tpu_torch.serve.rpc_ingress_client import ServeRpcClient
from tests.test_torch_runtime_cluster import retire_leftover_jax_runtime
from tests.test_torch_serve_http import JAX_TIMEOUT, TIMEOUT, jax_side

os.environ.setdefault("RAY_TPU_TORCH_LOG_LEVEL", "WARNING")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPP_DIR = os.path.join(REPO, "cpp", "serve_client")


@pytest.fixture(scope="module")
def ports():
    """JAX's RPC ingress and the port's, each on its own cluster in this
    process: their ports, JAX's first."""
    retire_leftover_jax_runtime()
    ray_tpu.init(num_cpus=16, object_store_memory=128 * 1024 * 1024)
    rt.init(num_cpus=16, num_gpus=0, object_store_memory=128 * 1024 * 1024)
    try:
        yield [jserve.start_rpc_ingress(), serve.start_rpc_ingress()]
    finally:
        serve.shutdown()
        rt.shutdown()
        jserve.shutdown()
        retire_leftover_jax_runtime()


@pytest.fixture
def deploy(ports):
    """deploy(name, jax_target, port_target=jax_target): the callables
    deployed in the two packages under one application name; deleted
    after the test."""
    names = []

    def _deploy(name, jax_target, port_target=None):
        names.append(name)
        jserve.run(jserve.deployment(jax_target, name=name).bind(),
                   name=name)
        serve.run(serve.deployment(port_target or jax_target,
                                   name=name).bind(), name=name)

    yield _deploy
    for name in names:
        jserve.delete(name)
        serve.delete(name)


def _clients(ports):
    return [JaxClient(f"127.0.0.1:{ports[0]}",
                      request_timeout_s=JAX_TIMEOUT),
            ServeRpcClient(f"127.0.0.1:{ports[1]}",
                           request_timeout_s=TIMEOUT)]


def _both(ports, call):
    """``call(client)`` through JAX's client to JAX's ingress (see
    ``jax_side``) and through the port's to the port's."""
    jax_client, port_client = _clients(ports)
    try:
        return [jax_side(lambda: call(jax_client)), call(port_client)]
    finally:
        jax_client.close()
        port_client.close()


def double(x):
    return {"y": x["v"] * 2}


def tokens(req):
    def gen():
        for i in range(int(req["n"])):
            yield f"tok{i} "
    return gen()


def mux(pkg):
    """The multiplexed deployment of ``tests/test_serve_rpc_ingress.py``,
    on ``pkg``'s ``multiplexed`` and request context."""

    class Mux:
        @pkg.multiplexed(max_num_models_per_replica=2)
        async def get(self, mid):
            return mid.upper()

        async def __call__(self, x):
            m = await self.get(pkg.get_multiplexed_model_id())
            return {"model": m}

    return Mux


def test_unary_invoke(deploy, ports):
    deploy("calc", double)
    jax_out, port_out = _both(ports, lambda c: c.invoke("calc", {"v": 21}))
    assert port_out == jax_out == {"y": 42}

    def missing(c):
        with pytest.raises(Exception, match="no application") as e:
            c.invoke("missing", {})
        return e.typename

    jax_out, port_out = _both(ports, missing)
    assert port_out == jax_out


def test_streaming_invoke(deploy, ports):
    deploy("stream", tokens)
    jax_out, port_out = _both(
        ports, lambda c: list(c.invoke_stream("stream", {"n": 5})))
    assert port_out == jax_out == [f"tok{i} " for i in range(5)]


def test_multiplexed_invoke(deploy, ports):
    """The model id rides the call to the replica (the router's model
    affinity key and the replica's request context)."""
    deploy("mux", mux(jserve), mux(serve))
    jax_out, port_out = _both(
        ports, lambda c: c.invoke("mux", {}, multiplexed_model_id="gemma"))
    assert port_out == jax_out == {"model": "GEMMA"}


# ------------------------------------------- tests/test_cpp_serve_client.py


@pytest.fixture(scope="module")
def demo_binary(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("cppbin") / "serve_demo")
    build = subprocess.run(
        ["g++", "-O2", "-std=c++17", "-o", out,
         os.path.join(CPP_DIR, "demo.cpp")],
        capture_output=True, text=True, timeout=300)
    assert build.returncode == 0, build.stderr[-3000:]
    return out


def _demo(binary, ports, *args):
    """The C++ demo against JAX's ingress (see ``jax_side``) and the
    port's."""
    flags = [a for a in args if a.startswith("--")]
    rest = [a for a in args if not a.startswith("--")]

    def run(port, timeout):
        return subprocess.run(
            [binary, *flags, "127.0.0.1", str(port), *rest],
            capture_output=True, text=True, timeout=timeout)

    return [jax_side(lambda: run(ports[0], JAX_TIMEOUT)),
            run(ports[1], 120)]


def echo(req):
    return {"text": f"echo:{req['prompt']}", "n": 7, "ok": True,
            "nothing": None, "items": [1, 2, 3]}


def cpp_tokens(req):
    def gen():
        for i in range(4):
            yield f"tok{i}"
    return gen()


def fine(req):
    return {"text": "ok"}


def test_cpp_invoke_roundtrip(deploy, ports, demo_binary):
    deploy("cppapp", echo)
    jax_run, port_run = _demo(demo_binary, ports, "cppapp",
                              "native c++ says hi")
    assert port_run.returncode == 0, port_run.stderr[-2000:]
    assert port_run.stdout == jax_run.stdout
    assert port_run.stdout.strip() == "echo:native c++ says hi"


def test_cpp_streaming_invoke(deploy, ports, demo_binary):
    deploy("cppstream", cpp_tokens)
    jax_run, port_run = _demo(demo_binary, ports, "--stream", "cppstream",
                              "go")
    assert port_run.returncode == 0, port_run.stderr[-2000:]
    assert port_run.stdout == jax_run.stdout
    assert port_run.stdout.split() == [f"tok{i}" for i in range(4)]


def test_cpp_server_error_surfaces(deploy, ports, demo_binary):
    deploy("errapp", fine)
    jax_run, port_run = _demo(demo_binary, ports, "no_such_app", "x")
    assert port_run.returncode == jax_run.returncode == 1
    assert "error" in port_run.stderr.lower()
