"""``serve.run(build_app("llama_debug", ...))`` on the port's runtime against
the JAX package's ``LLMServerImpl`` in-process, both on the weights of one
JAX ``init_params`` (converted in each replica by ``convert.from_jax``),
float32 on the CPU: with 1 and with 2 replicas behind the router, the
temperature-0 texts, whole, streamed through ``options(stream=True)`` and
through the chunk pull, equal JAX's exactly (token for token); a request
sampled at 0.8 returns all its tokens. The same texts over the port's
ingress: HTTP through ``serve.start``'s proxy, whole and streamed, and the
binary RPC ingress through ``ServeRpcClient.invoke``/``invoke_stream``.
The weights broadcast: ``push_weights`` into a ``weights_bcast`` replica,
whose texts equal the root's.
"""

import asyncio
import os
from functools import partial

import httpx
import jax
import numpy as np
import pytest

import ray_tpu_torch as rt
from ray_tpu.models import presets as jpresets
from ray_tpu.models import transformer as jtransformer
from ray_tpu.serve.llm import LLMServerImpl as JaxLLMServerImpl
from ray_tpu_torch import serve
from ray_tpu_torch.serve._private import weights
from ray_tpu_torch.serve.llm import LLMServerImpl, build_app
from ray_tpu_torch.serve.rpc_ingress_client import ServeRpcClient

os.environ.setdefault("RAY_TPU_TORCH_LOG_LEVEL", "WARNING")

TIMEOUT = 60
NEW = 6
SERVER_KW = dict(max_new_tokens=NEW, slots=4, prefill_chunk=8, page_tokens=4)
PROMPTS = ["hi", "hello 123", "a much longer prompt than the others!"]
SAMPLED = {"prompt": "hello 123 sampled", "temperature": 0.8}


@pytest.fixture(scope="module")
def jax_run():
    cfg = jpresets.llama_debug()
    params = jax.jit(partial(jtransformer.init_params, cfg))(
        jax.random.PRNGKey(0))
    srv = JaxLLMServerImpl(share_weights=False, attn="reference",
                           params_loader=lambda c: params, **SERVER_KW)
    try:
        texts = [asyncio.run(srv({"prompt": p}))["text"] for p in PROMPTS]
    finally:
        srv.shutdown()
    return texts, jax.tree.map(np.asarray, params)


@pytest.fixture(scope="module")
def cluster(jax_run):
    rt.init(num_cpus=16, num_gpus=0, object_store_memory=256 * 1024 * 1024)
    yield [rt.put(jax_run[1])]
    serve.shutdown()
    rt.shutdown()


def _load(boxed, cfg):
    from ray_tpu_torch import convert

    return convert.from_jax(rt.get(boxed[0], timeout=TIMEOUT))


def _stream(h, req) -> str:
    gen = h.options(stream=True).remote(dict(req, stream=True)).ref
    pieces = []
    while True:
        try:
            pieces.append(rt.get(gen.next(timeout=TIMEOUT), timeout=TIMEOUT))
        except StopIteration:
            return "".join(pieces)


@pytest.mark.parametrize("replicas", [1, 2])
def test_build_app_texts_equal_jax(cluster, jax_run, replicas):
    jax_texts, _ = jax_run
    name = f"llm{replicas}"
    h = serve.run(build_app(
        "llama_debug", num_replicas=replicas, device="cpu",
        params_loader=partial(_load, cluster), weights_key=f"jax0:{name}",
        attn="reference", **SERVER_KW),
        name=name, route_prefix=f"/{name}", timeout_s=120)
    try:
        st = serve.status()[name]["llm"]
        assert st["status"] == "RUNNING" and st["replicas"] == replicas
        # requests sent together, spread over the replicas by the router
        resps = [h.remote({"prompt": p}) for p in PROMPTS * 2]
        whole = [r.result(timeout=TIMEOUT)["text"] for r in resps]
        assert whole == jax_texts * 2
        assert [_stream(h, {"prompt": p}) for p in PROMPTS] == jax_texts
        # the chunk pull (stream_next) without options(stream=True)
        assert "".join(h.remote({"prompt": PROMPTS[2], "stream": True})) \
            == jax_texts[2]
        out = h.remote(SAMPLED).result(timeout=TIMEOUT)
        assert out["num_tokens"] == NEW
        modes = sorted(h.weights_info.remote().result(timeout=TIMEOUT)["mode"]
                       for _ in range(8))
        assert set(modes) <= {"published", "attached"}
    finally:
        serve.delete(name)


def test_texts_over_http_and_rpc_equal_jax(cluster, jax_run):
    """The temperature-0 texts over the port's ingress equal JAX's
    in-process ones: HTTP whole (JSON) and streamed (chunked
    ``X-Serve-Stream``), RPC ``invoke`` and ``invoke_stream``."""
    jax_texts, _ = jax_run
    serve.run(build_app(
        "llama_debug", device="cpu", params_loader=partial(_load, cluster),
        weights_key="jax0:ingress", attn="reference", **SERVER_KW),
        name="ingress", route_prefix="/ingress", timeout_s=120)
    try:
        url = f"http://127.0.0.1:{serve.start(http_port=0)}/ingress"
        whole, streamed = [], []
        for p in PROMPTS:
            r = httpx.post(url, json={"prompt": p}, timeout=TIMEOUT)
            assert r.status_code == 200
            whole.append(r.json()["text"])
            r = httpx.post(url, json={"prompt": p, "stream": True},
                           timeout=TIMEOUT)
            assert r.headers["x-serve-stream"] == "1"
            streamed.append(r.text)
        assert whole == jax_texts and streamed == jax_texts
        client = ServeRpcClient(f"127.0.0.1:{serve.start_rpc_ingress()}")
        try:
            assert [client.invoke("ingress", {"prompt": p})["text"]
                    for p in PROMPTS] == jax_texts
            assert ["".join(client.invoke_stream(
                "ingress", {"prompt": p, "stream": True}))
                for p in PROMPTS] == jax_texts
        finally:
            client.close()
    finally:
        serve.delete("ingress")


@rt.remote
def _bcast_receiver(group: str):
    """A GPU-less replica on a "new node": its weights come over the
    broadcast (``weights_bcast``), not from its loader."""
    srv = LLMServerImpl(device="cpu", share_weights=False,
                        weights_bcast={"group": group, "world_size": 2,
                                       "rank": 1}, **SERVER_KW)
    try:
        return [asyncio.run(srv({"prompt": p}))["text"] for p in PROMPTS]
    finally:
        srv.shutdown()


def test_left_for_later_raise(cluster):
    """What was left for later, the weights broadcast, now runs: a
    replica's ``push_weights`` feeds a ``weights_bcast`` replica in a task,
    whose temperature-0 texts equal the root's. A root without a tree
    raises."""
    with pytest.raises(ValueError, match="root must pass"):
        weights.broadcast_params(None, "g", 1, 0)
    h = serve.run(build_app("llama_debug", device="cpu", share_weights=False,
                            **SERVER_KW), name="nb", route_prefix="/nb",
                  timeout_s=120)
    try:
        assert h.weights_info.remote().result(timeout=TIMEOUT) == {
            "mode": "local", "shared": False}
        root = [h.remote({"prompt": p}).result(timeout=TIMEOUT)["text"]
                for p in PROMPTS]
        texts = _bcast_receiver.remote("nb-bcast")
        assert h.push_weights.remote("nb-bcast", 2).result(timeout=TIMEOUT)
        assert rt.get(texts, timeout=TIMEOUT) == root
    finally:
        serve.delete("nb")
