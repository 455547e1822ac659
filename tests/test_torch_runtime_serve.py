"""The slice end to end on the CPU: the port's replica hosted in an actor of
the port's runtime against the JAX package's ``LLMServerImpl`` in-process,
both at llama_debug on the weights of one JAX init (converted by
``convert.from_jax`` inside the actor, reaching it through ``rt.put`` of the
numpy tree), with ``tests/test_torch_serve.py``'s settings: 4 slots, 8-token
chunks, 4-token pages, 6 new tokens, 10 requests, one sampled at 0.8.

``ReplicaHost`` stands in for the serve control plane's replica actor,
which is not ported yet: it owns one ``LLMServerImpl`` and answers whole
and streamed requests. ``expect(n)`` holds the next n requests until all n
have arrived and then submits them in arrival order, so requests that come
over RPC one by one reach the scheduler as an in-process ``gather`` of them
does.
"""

import asyncio
import os
from functools import partial

import jax
import numpy as np
import pytest

import ray_tpu_torch as rt
from ray_tpu.models import presets as jpresets
from ray_tpu.models import transformer as jtransformer
from ray_tpu.serve.llm import LLMServerImpl as JaxLLMServerImpl

os.environ.setdefault("RAY_TPU_TORCH_LOG_LEVEL", "WARNING")

SLOTS, CHUNK, PAGE, NEW = 4, 8, 4, 6
PROMPTS = ["hi", "hello 123", "a much longer prompt than the others!"]
SAMPLED = {"prompt": "hello 123 sampled", "temperature": 0.8}
TIMEOUT = 120


class ReplicaHost:
    """One ``LLMServerImpl`` in an async actor (see the module docstring)."""

    def __init__(self, params_tree, **server_kw):
        from ray_tpu_torch import LLMServerImpl, convert

        self.srv = LLMServerImpl(
            params_loader=lambda cfg: convert.from_jax(params_tree),
            **server_kw)
        self._expect = 0
        self._arrived = 0
        self._all_in = None

    async def expect(self, n):
        self._expect, self._arrived = n, 0
        self._all_in = asyncio.Event()

    async def _arrive(self):
        if self._all_in is None:
            return
        ev = self._all_in
        self._arrived += 1
        if self._arrived == self._expect:
            self._all_in = None
            ev.set()
            # the waiters wake in arrival order, queued before this yield
            await asyncio.sleep(0)
        else:
            await ev.wait()

    async def generate(self, req):
        await self._arrive()
        return await self.srv(req)

    async def stream(self, req):
        await self._arrive()
        async for piece in await self.srv(dict(req, stream=True)):
            yield piece

    async def stats(self):
        return self.srv.scheduler_stats()

    async def launches(self):
        """K4's launch counter in this worker process."""
        from ray_tpu_torch.ops.paged_attention import paged_attention

        return paged_attention.launches

    async def param_devices(self):
        from ray_tpu_torch.models.transformer import map_params

        seen = set()
        map_params(lambda _p, t: seen.add(str(t.device)), self.srv.params)
        return sorted(seen)


Host = rt.remote(ReplicaHost)


@pytest.fixture(scope="module")
def cluster():
    info = rt.init(num_cpus=8, num_gpus=0,
                   object_store_memory=256 * 1024 * 1024)
    yield info
    rt.shutdown()


@pytest.fixture(scope="module")
def jax_run():
    """The JAX replica in-process on the weights of one JAX init: its
    texts and stats, and the weights as a numpy tree."""
    cfg = jpresets.llama_debug()
    params = jax.jit(partial(jtransformer.init_params, cfg))(
        jax.random.PRNGKey(0))
    srv = JaxLLMServerImpl(
        max_new_tokens=NEW, slots=SLOTS, prefill_chunk=CHUNK,
        page_tokens=PAGE, share_weights=False, attn="reference",
        params_loader=lambda cfg: params)

    async def go():
        return await asyncio.gather(*[srv(r) for r in _requests()])

    try:
        outs = asyncio.run(go())
        stats = srv.scheduler_stats()
    finally:
        srv.shutdown()
    return ([o["text"] for o in outs], stats,
            jax.tree.map(np.asarray, params))


def _requests():
    return [{"prompt": p} for p in PROMPTS * 3] + [SAMPLED]


def _host(tree_ref):
    return Host.options(max_concurrency=32).remote(
        tree_ref, max_new_tokens=NEW, slots=SLOTS, prefill_chunk=CHUNK,
        page_tokens=PAGE, device="cpu")


def _stream_text(h, req) -> str:
    gen = h.stream.options(num_returns="streaming").remote(req)
    return "".join(rt.get(list(gen), timeout=TIMEOUT))


@pytest.mark.parametrize("mode", ["whole", "stream"])
def test_actor_replica_matches_jax(cluster, jax_run, mode):
    """Temperature-0 and sampled texts, whole or streamed through
    ``num_returns="streaming"``, and the prefix hits equal the JAX
    replica's."""
    jax_texts, jax_stats, tree = jax_run
    h = _host(rt.put(tree))
    try:
        rt.get(h.expect.remote(len(_requests())), timeout=TIMEOUT)
        if mode == "whole":
            refs = [h.generate.remote(r) for r in _requests()]
            texts = [o["text"] for o in rt.get(refs, timeout=TIMEOUT)]
        else:
            gens = [h.stream.options(num_returns="streaming").remote(r)
                    for r in _requests()]
            texts = ["".join(rt.get(list(g), timeout=TIMEOUT))
                     for g in gens]
        st = rt.get(h.stats.remote(), timeout=TIMEOUT)
        assert texts == jax_texts
        assert st["attn_lane"] == "reference"
        assert st["prefix_hits"] > 0
        assert st["prefix_hits"] == jax_stats["prefix_hits"]
        assert st["tokens_generated"] == NEW * len(_requests())
        # the CPU lane runs no kernel, in the scheduler's count or K4's
        assert st["kernel_launches"] == 0
        assert rt.get(h.launches.remote(), timeout=TIMEOUT) == 0
        assert rt.get(h.param_devices.remote(), timeout=TIMEOUT) == ["cpu"]
    finally:
        rt.kill(h)


def test_requests_one_by_one_and_stream_equals_whole(cluster, jax_run):
    """Requests that reach the actor one at a time, as they come over RPC,
    still give JAX's texts (float32 on the CPU); a streamed text equals the
    whole one."""
    jax_texts, _, tree = jax_run
    h = _host(rt.put(tree))
    try:
        refs = [h.generate.remote(r) for r in _requests()]
        texts = [o["text"] for o in rt.get(refs, timeout=TIMEOUT)]
        assert texts == jax_texts
        whole = rt.get(h.generate.remote({"prompt": PROMPTS[2]}),
                       timeout=TIMEOUT)["text"]
        assert _stream_text(h, {"prompt": PROMPTS[2]}) == whole
        assert whole == jax_texts[2]
    finally:
        rt.kill(h)


@rt.remote
class _Probe:
    def visible(self):
        return os.environ.get("CUDA_VISIBLE_DEVICES")

    def build_replica(self):
        from ray_tpu_torch import LLMServerImpl

        LLMServerImpl(preset="llama_debug")


def test_replica_without_a_device_in_a_gpu_less_actor_raises(cluster):
    """An actor that asked for no GPU sees no card, so a replica that names
    no device refuses to start there."""
    p = _Probe.remote()
    try:
        assert rt.get(p.visible.remote(), timeout=TIMEOUT) == ""
        with pytest.raises(rt.TaskError, match="no CUDA device"):
            rt.get(p.build_replica.remote(), timeout=TIMEOUT)
    finally:
        rt.kill(p)
