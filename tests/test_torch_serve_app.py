"""The port's serve control plane (``ray_tpu_torch.serve``) on one local
cluster of the port's runtime, held to the behaviours that
``tests/test_serve.py`` asserts for the JAX package (HTTP aside: the proxy
is not ported): class, function and init-args deployments, method calls,
replica spread, status and delete, composition through nested handles,
async concurrency, ``serve.batch``, queue-depth scale-up and idle-at-min,
a killed replica replaced, generator, async-generator and native streams
with their errors, and the router's failure mark. Then an LLM deployment
behind an ingress deployment: llama_debug in float32 on the weights of one
JAX ``init_params`` (converted by ``convert.from_jax``), temperature-0
texts equal to the JAX ``LLMServerImpl``'s in-process.
"""

import asyncio
import os
import subprocess
import sys
import textwrap
import time
from functools import partial

import jax
import numpy as np
import pytest

import ray_tpu_torch as rt
from ray_tpu.models import presets as jpresets
from ray_tpu.models import transformer as jtransformer
from ray_tpu.serve.llm import LLMServerImpl as JaxLLMServerImpl
from ray_tpu_torch import serve

os.environ.setdefault("RAY_TPU_TORCH_LOG_LEVEL", "WARNING")

TIMEOUT = 60


@pytest.fixture(scope="module")
def cluster():
    info = rt.init(num_cpus=16, num_gpus=0,
                   object_store_memory=256 * 1024 * 1024)
    yield info
    serve.shutdown()
    rt.shutdown()


@pytest.fixture
def app(cluster):
    """Deletes every application a test deployed."""
    names = []
    yield names.append
    for name in names:
        serve.delete(name)


def _run(app, application, name):
    app(name)
    return serve.run(application, name=name, route_prefix=f"/{name}")


@serve.deployment
class Doubler:
    def __call__(self, x):
        return x * 2


@serve.deployment
def plus_one(x):
    return x + 1


@serve.deployment
class WithArgs:
    def __init__(self, base, scale=1):
        self.base = base
        self.scale = scale

    def __call__(self, x):
        return self.base + x * self.scale


@serve.deployment
class Multi:
    def __call__(self, x):
        return x

    def square(self, x):
        return x * x


@serve.deployment(num_replicas=3)
class PidReporter:
    def __call__(self, _):
        return os.getpid()


def test_class_function_and_init_args_deployments(app):
    assert _run(app, Doubler.bind(), "d1").remote(21).result(
        timeout=TIMEOUT) == 42
    assert _run(app, plus_one.bind(), "d2").remote(41).result(
        timeout=TIMEOUT) == 42
    h = _run(app, WithArgs.bind(100, scale=3), "d3")
    assert h.remote(5).result(timeout=TIMEOUT) == 115


def test_method_call(app):
    h = _run(app, Multi.bind(), "d4")
    assert h.square.remote(7).result(timeout=TIMEOUT) == 49


def test_num_replicas_spread(app):
    h = _run(app, PidReporter.bind(), "d5")
    pids = {h.remote(None).result(timeout=TIMEOUT) for _ in range(30)}
    assert len(pids) >= 2  # pow-2 routing spreads load


def test_status_and_delete(cluster):
    serve.run(Doubler.bind(), name="d6", route_prefix="/d6")
    st = serve.status()
    assert st["d6"]["Doubler"]["status"] == "RUNNING"
    assert st["d6"]["Doubler"]["replicas"] == 1
    assert serve.get_app_handle("d6").remote(2).result(
        timeout=TIMEOUT) == 4
    serve.delete("d6")
    assert "d6" not in serve.status()


@serve.deployment
class Preprocess:
    def __call__(self, x):
        return x + 1


@serve.deployment
class Ingress:
    def __init__(self, pre):
        self.pre = pre

    async def __call__(self, x):
        y = await self.pre.remote(x)
        return y * 10


def test_composition_through_nested_handles(app):
    h = _run(app, Ingress.bind(Preprocess.bind()), "chain")
    assert h.remote(4).result(timeout=TIMEOUT) == 50


@serve.deployment(max_ongoing_requests=16)
class Slow:
    async def __call__(self, x):
        await asyncio.sleep(0.2)
        return x


def test_async_concurrent_requests(app):
    h = _run(app, Slow.bind(), "conc")
    h.remote(-1).result(timeout=TIMEOUT)  # the router and replica are up
    t0 = time.monotonic()
    responses = [h.remote(i) for i in range(8)]
    out = [r.result(timeout=TIMEOUT) for r in responses]
    assert sorted(out) == list(range(8))
    assert time.monotonic() - t0 < 1.2  # concurrent, not 8 x 0.2 serial


@serve.deployment(max_ongoing_requests=32)
class Batched:
    def __init__(self):
        self.batch_sizes = []

    @serve.batch(max_batch_size=8, batch_wait_timeout_s=0.1)
    async def handle(self, items):
        self.batch_sizes.append(len(items))
        return [i * 2 for i in items]

    async def __call__(self, x):
        if x == "sizes":
            return self.batch_sizes
        return await self.handle(x)


def test_serve_batch(app):
    h = _run(app, Batched.bind(), "batch")
    responses = [h.remote(i) for i in range(8)]
    assert [r.result(timeout=TIMEOUT) for r in responses] == [
        i * 2 for i in range(8)]
    assert max(h.remote("sizes").result(timeout=TIMEOUT)) > 1


def _wait_replicas(app_name, dep, n, timeout=30):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if serve.status().get(app_name, {}).get(dep, {}).get(
                "replicas") == n:
            return True
        time.sleep(0.3)
    return False


_AUTOSCALE = {"min_replicas": 1, "max_replicas": 3,
              "target_ongoing_requests": 2}


@serve.deployment(autoscaling_config=_AUTOSCALE)
class Backlogged:
    def queue_depth(self):
        return 50  # a backlog with no request in flight

    def __call__(self, x):
        return x


@serve.deployment(autoscaling_config=serve.AutoscalingConfig(**_AUTOSCALE))
class Idle:
    def queue_depth(self):
        return 0

    def __call__(self, x):
        return x


def test_queue_depth_scales_up_and_idle_stays_at_min(app):
    """A replica with no request in flight but a deep queue triggers
    scale-up (in-flight counts alone undercount a saturated continuous
    batcher); an idle one stays at the minimum."""
    _run(app, Backlogged.bind(), "qd")
    h = _run(app, Idle.bind(), "qd2")
    assert _wait_replicas("qd", "Backlogged", 3), serve.status()
    assert h.remote(1).result(timeout=TIMEOUT) == 1
    time.sleep(2.0)  # several autoscale passes
    assert serve.status()["qd2"]["Idle"]["replicas"] == 1


@serve.deployment
class Fragile:
    def __call__(self, x):
        if x == "die":
            os._exit(1)
        return os.getpid()


def test_killed_replica_is_replaced(app):
    h = _run(app, Fragile.bind(), "frag")
    pid = h.remote("ok").result(timeout=TIMEOUT)
    with pytest.raises(Exception):
        h.remote("die").result(timeout=TIMEOUT)
    deadline = time.monotonic() + 30
    new = None
    while time.monotonic() < deadline and new is None:
        try:
            new = h.remote("ok").result(timeout=5)
        except Exception:
            time.sleep(0.5)
    assert new is not None and new != pid, "replica was not replaced"


@serve.deployment
class Streamer:
    def __call__(self, n):
        def gen():
            for i in range(n):
                yield f"tok{i} "
        return gen()


@serve.deployment
class AStreamer:
    async def __call__(self, n):
        async def gen():
            for i in range(n):
                await asyncio.sleep(0.001)
                yield i * 10
        return gen()


@serve.deployment
class Bad:
    def __call__(self, _):
        def gen():
            yield "ok"
            raise ValueError("boom")
        return gen()


def test_streams_chunk_pull_and_native(app):
    """Sync and async generators stream through the chunk pull
    (``stream_next``) and through ``options(stream=True)`` (the native
    generator transport)."""
    h = _run(app, Streamer.bind(), "stream")
    assert list(h.remote(5)) == [f"tok{i} " for i in range(5)]
    resp = h.options(stream=True).remote(4)
    assert isinstance(resp.ref, rt.ObjectRefGenerator)
    assert list(resp) == [f"tok{i} " for i in range(4)]
    h2 = _run(app, AStreamer.bind(), "astream")
    assert list(h2.remote(4)) == [0, 10, 20, 30]
    assert list(h2.options(stream=True).remote(3)) == [0, 10, 20]


def test_stream_errors_propagate(app):
    h = _run(app, Bad.bind(), "badstream")
    it = iter(h.remote(None))
    assert next(it) == "ok"
    with pytest.raises(RuntimeError, match="boom"):
        list(it)
    it = iter(h.options(stream=True).remote(None))
    assert next(it) == "ok"
    with pytest.raises(Exception, match="boom"):
        list(it)


def test_router_failure_mark_skews_pick():
    """A replica with a recent failure loses every pow-2 draw until the
    mark clears."""
    from ray_tpu_torch.serve._private.router import Router

    r = Router(None, "app", "dep")
    rep_a, rep_b = object(), object()
    r._replicas = [rep_a, rep_b]
    r._inflight = {0: 0, 1: 0}
    r._key_to_idx = {r._replica_key(rep_a): 0, r._replica_key(rep_b): 1}
    r._note_result(r._replica_key(rep_a), ok=False)
    assert {r._pick()[0] for _ in range(20)} == {1}
    r._note_result(r._replica_key(rep_a), ok=True)
    r._inflight = {0: 0, 1: 0}
    assert {r._pick()[0] for _ in range(50)} == {0, 1}


def test_serve_imports_no_torch():
    """``ray_tpu_torch.serve`` is the runtime and the control plane only:
    a driver that deploys plain functions never loads torch."""
    code = ("import sys, ray_tpu_torch.serve; "
            "print('torch' in sys.modules)")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=60, check=True)
    assert out.stdout.strip() == "False"


def test_router_threads_never_restart_a_shut_down_runtime():
    """After ``serve.shutdown`` and ``rt.shutdown``, the router's polling
    threads retire instead of calling into the runtime, whose calls would
    start a new local cluster (the JAX router's threads do that)."""
    code = textwrap.dedent("""
        import time
        import ray_tpu_torch as rt
        from ray_tpu_torch import serve

        @serve.deployment
        def echo(x):
            return x

        rt.init(num_cpus=4, num_gpus=0, object_store_memory=64 << 20)
        h = serve.run(echo.bind(), name="e")
        assert h.remote({"prompt": "a prompt for the digest poll"}).result(
            timeout=60)
        serve.shutdown()
        rt.shutdown()
        time.sleep(3.0)  # past the threads' retry backoff
        print(rt.is_initialized())
        """)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120,
                         env=dict(os.environ, RAY_TPU_TORCH_LOG_LEVEL="ERROR"))
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "False"


def test_controller_is_detached_and_asks_for_no_card(app):
    from ray_tpu_torch._private import api as rt_api
    from ray_tpu_torch.serve._private.controller import CONTROLLER_NAME

    _run(app, Doubler.bind(), "ctl")
    core = rt_api._core
    rec = core._run(core.clients.get(core.controller_addr).call(
        "actor_by_name", {"name": CONTROLLER_NAME,
                          "namespace": "default"}), timeout=TIMEOUT)
    assert rec["detached"] and rec["state"] == "ALIVE"
    gpus = core._run(core.clients.get(core.supervisor_addr).call(
        "gpu_visible_devices", {"worker_id_hex": rec["worker_id_hex"]}),
        timeout=TIMEOUT)
    assert gpus == []


# ------------------------------------------------- an LLM behind ingress

NEW = 6
PROMPTS = ["hi", "hello 123", "a much longer prompt than the others!"]


@pytest.fixture(scope="module")
def jax_texts_and_tree():
    cfg = jpresets.llama_debug()
    params = jax.jit(partial(jtransformer.init_params, cfg))(
        jax.random.PRNGKey(0))
    srv = JaxLLMServerImpl(max_new_tokens=NEW, slots=4, prefill_chunk=8,
                           page_tokens=4, share_weights=False,
                           attn="reference", params_loader=lambda c: params)
    try:
        texts = [asyncio.run(srv({"prompt": p}))["text"] for p in PROMPTS]
    finally:
        srv.shutdown()
    return texts, jax.tree.map(np.asarray, params)


@serve.deployment
class TextIngress:
    def __init__(self, llm):
        self.llm = llm

    async def __call__(self, prompt):
        out = await self.llm.remote({"prompt": prompt})
        return out["text"]


def _from_jax(tree, cfg):
    from ray_tpu_torch import convert

    return convert.from_jax(tree)


def test_llm_behind_an_ingress_deployment(app, jax_texts_and_tree):
    """Composition with the LLM deployment: an ingress deployment holds a
    handle to ``LLMServer`` (llama_debug, float32, on the CPU); its
    temperature-0 texts equal the JAX replica's in-process (exact
    tokens)."""
    from ray_tpu_torch.serve.llm import LLMServer

    jax_texts, tree = jax_texts_and_tree
    llm = LLMServer.bind(max_new_tokens=NEW, slots=4, prefill_chunk=8,
                         page_tokens=4, device="cpu",
                         params_loader=partial(_from_jax, tree))
    h = _run(app, TextIngress.bind(llm), "llm_ingress")
    texts = [h.remote(p).result(timeout=TIMEOUT) for p in PROMPTS]
    assert texts == jax_texts
