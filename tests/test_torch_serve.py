"""The port's ``LLMServerImpl`` on the CPU against the JAX package's, end to
end through the continuous paged scheduler: the same llama_debug weights
(converted from one JAX init), the same prompts, more requests than slots,
prefix-cache hits. Temperature-0 texts must be identical; so must a sampled
text, since both sides sample with numpy from the host logits and the same
per-request seed.
"""

import asyncio
from functools import partial

import jax
import numpy as np
import pytest
import torch

from ray_tpu.models import presets as jpresets
from ray_tpu.models import transformer as jtransformer
from ray_tpu.serve.llm import LLMServerImpl as JaxLLMServerImpl
from ray_tpu_torch import LLMServerImpl, convert

SLOTS, CHUNK, PAGE, NEW = 4, 8, 4, 6
PROMPTS = ["hi", "hello 123", "a much longer prompt than the others!"]
SAMPLED = {"prompt": "hello 123 sampled", "temperature": 0.8}


@pytest.fixture(scope="module")
def jax_params():
    cfg = jpresets.llama_debug()
    return jax.jit(partial(jtransformer.init_params, cfg))(
        jax.random.PRNGKey(0))


def _drive(srv, reqs):
    async def go():
        return await asyncio.gather(*[srv(r) for r in reqs])

    try:
        outs = asyncio.run(go())
        return [o["text"] for o in outs], srv.scheduler_stats()
    finally:
        srv.shutdown()


def _requests():
    return [{"prompt": p} for p in PROMPTS * 3] + [SAMPLED]


def test_texts_match_jax_server(jax_params):
    host = jax.tree.map(np.asarray, jax_params)
    jax_texts, jax_stats = _drive(JaxLLMServerImpl(
        max_new_tokens=NEW, slots=SLOTS, prefill_chunk=CHUNK,
        page_tokens=PAGE, share_weights=False, attn="reference",
        params_loader=lambda cfg: jax_params), _requests())
    texts, stats = _drive(LLMServerImpl(
        max_new_tokens=NEW, slots=SLOTS, prefill_chunk=CHUNK,
        page_tokens=PAGE, device="cpu",
        params_loader=lambda cfg: convert.from_jax(host)), _requests())
    assert texts == jax_texts
    assert stats["attn_lane"] == "reference"
    assert stats["prefix_hits"] > 0
    assert stats["prefix_hits"] == jax_stats["prefix_hits"]
    assert stats["tokens_generated"] == NEW * len(_requests())
    assert stats["kernel_launches"] == 0  # the CPU lane runs no kernel
    assert stats["pages_in_use"] == stats["radix_resident_pages"]


def test_stream_equals_whole_text():
    srv = LLMServerImpl(max_new_tokens=NEW, slots=SLOTS, prefill_chunk=CHUNK,
                        page_tokens=PAGE, device="cpu")

    async def go():
        whole = await srv({"prompt": PROMPTS[1]})
        pieces = [p async for p in await srv({"prompt": PROMPTS[1],
                                              "stream": True})]
        return whole["text"], "".join(pieces)

    try:
        whole, streamed = asyncio.run(go())
    finally:
        srv.shutdown()
    assert whole == streamed and len(whole) > 0


def test_oversized_prompt_rejected_and_server_stays_healthy():
    srv = LLMServerImpl(max_new_tokens=NEW, slots=SLOTS, prefill_chunk=CHUNK,
                        page_tokens=PAGE, device="cpu")
    try:
        with pytest.raises(ValueError, match="does not fit"):
            asyncio.run(srv({"prompt": "x" * 200}))
        assert srv.check_health()
    finally:
        srv.shutdown()
    assert not srv.check_health()


def test_no_device_and_no_card_raises(monkeypatch):
    """Without ``device="cpu"``, a machine with no CUDA card refuses to
    serve rather than carry on on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        LLMServerImpl()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        LLMServerImpl(device="cuda")
