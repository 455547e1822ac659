"""The port's serve baselines and replica knobs on the CPU against the JAX
package: the gather lane's programs, and the replica's temperature-0 texts
under each knob, at llama_debug in float32 on weights converted from one
JAX init.

Programs: ``paged_prefill_into_slot``, ``paged_decode_step`` and
``paged_verify_step`` on the gather lane against JAX's gather lane,
logits within ``LOGIT_TOL`` (as ``test_torch_decode.py``) and every page
of the pools within ``OP_TOL``. Texts: ``attn="gather"``,
``kv_layout="contiguous"``, ``kv_pages`` below the worst case,
``prefix_cache=False``, ``eos_id`` and ``scheduler="batch"`` (whole and
streamed) equal the JAX replica's, and the port's lanes and layouts equal
each other, as the JAX package's do. Both replicas detokenize to token ids,
so a text is its token sequence.
"""

import asyncio
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models import decode as jdecode
from ray_tpu.models import presets as jpresets
from ray_tpu.models import transformer as jtransformer
from ray_tpu.serve._private.continuous import \
    ContinuousScheduler as JaxScheduler
from ray_tpu.serve.llm import LLMServerImpl as JaxLLMServerImpl
from ray_tpu_torch import LLMServerImpl, convert
from ray_tpu_torch.models import decode, presets, transformer
from ray_tpu_torch.ops.rotary import rope_frequencies
from ray_tpu_torch.serve._private.continuous import ContinuousScheduler

OP_TOL = dict(atol=1e-5, rtol=1e-5)
LOGIT_TOL = dict(atol=1e-4, rtol=0)
SLOTS, CHUNK, PAGE, NEW = 4, 8, 4, 6
PROMPTS = ["hi", "hello 123", "a much longer prompt than the others!"]


def _ids_text(ids):
    return "".join(f"<{int(i)}>" for i in ids)


def _t(a):
    return torch.from_numpy(np.asarray(a))


@pytest.fixture(scope="module")
def weights():
    """(jax params, host numpy tree) of one llama_debug init."""
    cfg = jpresets.llama_debug()
    jparams = jax.jit(partial(jtransformer.init_params, cfg))(
        jax.random.PRNGKey(0))
    return jparams, jax.tree.map(np.asarray, jparams)


def _requests():
    return [{"prompt": p} for p in PROMPTS * 3]


def _drive(srv, reqs):
    async def go():
        return await asyncio.gather(*[srv(r) for r in reqs])

    try:
        return [o["text"] for o in asyncio.run(go())], srv.scheduler_stats()
    finally:
        srv.shutdown()


def _servers(weights, **kw):
    """A JAX replica (``share_weights=False``) and a port replica on the CPU,
    on the same weights, with the same knobs."""
    jparams, host = weights
    common = dict(max_new_tokens=NEW, slots=SLOTS, prefill_chunk=CHUNK,
                  page_tokens=PAGE, detokenize=_ids_text, **kw)
    if kw.get("scheduler") == "batch":
        for k in ("slots", "prefill_chunk", "page_tokens"):
            common.pop(k)
    jax_srv = JaxLLMServerImpl(share_weights=False,
                               params_loader=lambda cfg: jparams, **common)
    srv = LLMServerImpl(device="cpu",
                        params_loader=lambda cfg: convert.from_jax(host),
                        **common)
    return jax_srv, srv


# --------------------------------------------------- gather-lane programs


def test_gather_lane_programs_match_jax(weights):
    """Prefill chunks into slots 0 and 1 (the second in two chunks, its
    cursor off a page boundary), two decode steps with slot 2 inactive and
    then slot 1 inactive, and a 3-token verify window over all slots, each
    on the gather lane against JAX's: logits, cursors and every page of
    the pools but the garbage page (several slots' redirected writes race
    there, on both sides)."""
    jparams, host = weights
    jcfg, cfg = jpresets.llama_debug(), presets.llama_debug()
    params = transformer.place_params(cfg, convert.from_jax(host),
                                      torch.device("cpu"))
    S, T, P = 3, 4, 8
    need = [4, 5, 2]  # pages each slot owns; the rest of a row is page 0
    tables = np.zeros((S, P), np.int32)
    first = 1
    for s, n in enumerate(need):
        tables[s, :n] = np.arange(first, first + n)
        first += n
    N = first
    jc = jdecode.init_paged_caches(jcfg, S, N, T, P)
    tc = decode.init_paged_caches(cfg, S, N, T, P, device="cpu")
    jprefill = jax.jit(partial(jdecode.paged_prefill_into_slot, jcfg,
                               attn="gather"))
    rng = np.random.default_rng(0)
    for slot, real in ((0, 7), (1, 8), (1, 3)):
        chunk = np.zeros((1, CHUNK), np.int32)
        chunk[0, :real] = rng.integers(1, cfg.vocab_size, real)
        row = tables[slot]
        want, jc = jprefill(jparams, jnp.asarray(chunk), real, slot,
                            jnp.asarray(row), jnp.asarray(row), jc)
        got = decode.paged_prefill_into_slot(
            cfg, params, _t(chunk), real, slot, _t(row), _t(row), tc, None,
            attn="gather")
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   **LOGIT_TOL)
    jstep = jax.jit(partial(jdecode.paged_decode_step, jcfg, attn="gather"))
    for i, active in enumerate(([1, 1, 0], [1, 0, 0])):
        toks = rng.integers(1, cfg.vocab_size, S).astype(np.int32)
        act = np.asarray(active, np.int32)
        want, jc = jstep(jparams, jnp.asarray(toks), jnp.asarray(act),
                         jnp.asarray(tables), jnp.asarray(tables), jc)
        got = decode.paged_decode_step(cfg, params, _t(toks), _t(act),
                                       _t(tables), _t(tables), tc, None,
                                       attn="gather")
        live = act.astype(bool)
        np.testing.assert_allclose(got.numpy()[live],
                                   np.asarray(want)[live], **LOGIT_TOL,
                                   err_msg=f"step {i}")
    assert tc[0].lengths.tolist() == np.asarray(jc[0].lengths).tolist() \
        == [9, 12, 0]
    win = rng.integers(1, cfg.vocab_size, (S, 3)).astype(np.int32)
    want, jc = jax.jit(partial(jdecode.paged_verify_step, jcfg,
                               attn="gather"))(
        jparams, jnp.asarray(win), jnp.asarray(tables), jnp.asarray(tables),
        jc)
    got = decode.paged_verify_step(cfg, params, _t(win), _t(tables),
                                   _t(tables), tc, None, attn="gather")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LOGIT_TOL)
    assert tc[0].lengths.tolist() == [9, 12, 0]
    for layer in range(cfg.num_layers):
        for pool, jpool in ((tc[layer].k, jc[layer].k),
                            (tc[layer].v, jc[layer].v)):
            np.testing.assert_allclose(pool.numpy()[1:],
                                       np.asarray(jpool)[1:], **OP_TOL)


def test_gather_and_inplace_lanes_agree(weights):
    """The port's gather lane against its own in-place lane on the same
    calls: decode logits within LOGIT_TOL and the same argmax."""
    _, host = weights
    cfg = presets.llama_debug()
    params = transformer.place_params(cfg, convert.from_jax(host),
                                      torch.device("cpu"))
    S, T, P = 2, 4, 8
    tables = (1 + np.arange(S * P, dtype=np.int32)).reshape(S, P)
    rope = rope_frequencies(cfg.head_dim, cfg.max_seq_len, cfg.rope_theta)
    outs = {}
    for attn in ("gather", "reference"):
        tc = decode.init_paged_caches(cfg, S, S * P + 1, T, P, device="cpu")
        rng = np.random.default_rng(1)
        for slot, real in ((0, 6), (1, 8)):
            chunk = np.zeros((1, CHUNK), np.int32)
            chunk[0, :real] = rng.integers(1, cfg.vocab_size, real)
            decode.paged_prefill_into_slot(
                cfg, params, _t(chunk), real, slot, _t(tables[slot]),
                _t(tables[slot]), tc, rope, attn=attn)
        toks = rng.integers(1, cfg.vocab_size, S).astype(np.int32)
        outs[attn] = decode.paged_decode_step(
            cfg, params, _t(toks), _t(np.ones(S, np.int32)), _t(tables),
            _t(tables), tc, rope, attn=attn).numpy()
    np.testing.assert_allclose(outs["gather"], outs["reference"],
                               **LOGIT_TOL)
    assert (outs["gather"].argmax(-1) == outs["reference"].argmax(-1)).all()


def test_unknown_lane_rejected_before_any_math():
    cfg = presets.llama_debug()
    tokens = torch.zeros((1, 1), dtype=torch.int32)
    for fn, nargs in ((decode.paged_decode_step, 5),
                      (decode.paged_verify_step, 4),
                      (decode.paged_prefill_into_slot, 6)):
        for lane in ("pallas", "auto", "", "bogus"):
            with pytest.raises(ValueError, match="unknown paged attention"):
                fn(cfg, None, tokens, *([None] * nargs), attn=lane)


def test_moe_slot_decode_step_matches_jax_vmap():
    """JAX vmaps the slot arena's one-sequence decode program over the
    slots, so an MoE layer's expert capacity is one slot's. The port
    batches the slots and so runs an MoE model one slot at a time: pooled
    over 8 slots, capacity overflow dropped rows JAX keeps (logits 0.04
    off at moe_debug before)."""
    jcfg, cfg = jpresets.moe_debug(), presets.moe_debug()
    jparams = jax.jit(partial(jtransformer.init_params, jcfg))(
        jax.random.PRNGKey(0))
    params = transformer.place_params(
        cfg, convert.from_jax(jax.tree.map(np.asarray, jparams)),
        torch.device("cpu"))
    slots, L = 8, 32
    jc = jdecode.init_slot_caches(jcfg, slots, L)
    tc = decode.init_slot_caches(cfg, slots, L, device="cpu")
    jstep = jax.jit(partial(jdecode.slot_decode_step, jcfg))
    rng = np.random.default_rng(0)
    act = np.ones(slots, np.int32)
    for i in range(4):
        toks = rng.integers(1, cfg.vocab_size, slots).astype(np.int32)
        want, jc = jstep(jparams, jnp.asarray(toks), jnp.asarray(act), jc)
        got = decode.slot_decode_step(cfg, params, _t(toks), _t(act), tc)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   **LOGIT_TOL, err_msg=f"step {i}")


# ----------------------------------------------------------- replica texts


@pytest.mark.parametrize("knobs", [
    dict(attn="gather"),
    dict(kv_layout="contiguous"),
    # below the worst case (4 x 32 + 1): four live sequences of the longest
    # prompt (11 pages each) fit; the cache's retired prefixes are evicted
    # under pressure
    dict(kv_pages=48),
    dict(prefix_cache=False),
], ids=lambda kw: ",".join(f"{k}={v}" for k, v in kw.items()))
def test_texts_match_jax_server(weights, knobs):
    jax_srv, srv = _servers(weights, **knobs)
    jax_texts, jax_stats = _drive(jax_srv, _requests())
    texts, stats = _drive(srv, _requests())
    assert texts == jax_texts
    assert stats["kv_layout"] == jax_stats["kv_layout"]
    assert stats.get("num_pages") == jax_stats.get("num_pages")
    assert ("prefix_hits" in stats) == ("prefix_hits" in jax_stats)
    assert stats.get("attn_lane") == jax_stats.get("attn_lane")
    assert stats["kernel_launches"] == 0


def test_eos_retires_early_like_jax(weights):
    """``eos_id`` set to the third token the longest prompt's greedy text
    emits: that request retires on "eos" after it, as JAX's does, and
    every text equals the JAX replica's (each the plain text up to its
    first EOS)."""
    jax_srv, srv = _servers(weights)
    base, _ = _drive(srv, _requests())
    eos = int(base[2].split(">")[2][1:])
    jax_srv.shutdown()
    jax_srv, srv = _servers(weights, eos_id=eos)
    jax_texts, _ = _drive(jax_srv, _requests())
    texts, stats = _drive(srv, _requests())
    assert texts == jax_texts
    assert stats["retired_eos"] >= 3  # the three copies of the prompt
    tag = f"<{eos}>"
    for got, plain in zip(texts, base):
        want = plain[:plain.index(tag) + len(tag)] if tag in plain else plain
        assert got == want


def test_batch_scheduler_matches_jax(weights):
    """``scheduler="batch"``: the flush-and-drain baseline, whole requests
    (grouped by prompt length in one flush) and a stream, against the JAX
    replica's, whose stream is a plain generator."""
    jax_srv, srv = _servers(weights, scheduler="batch", max_batch_size=4)
    jax_texts, jax_stats = _drive(jax_srv, _requests())
    texts, stats = _drive(srv, _requests())
    assert texts == jax_texts
    assert stats == jax_stats == {"mode": "batch", "max_batch_size": 4}
    jax_srv, srv = _servers(weights, scheduler="batch")

    async def stream(server):
        out = await server({"prompt": PROMPTS[2], "stream": True})
        if hasattr(out, "__aiter__"):
            return [p async for p in out]
        return list(out)

    jax_pieces = asyncio.run(stream(jax_srv))
    pieces = asyncio.run(stream(srv))
    assert pieces == jax_pieces and len(pieces) == NEW
    assert "".join(pieces) == texts[2]


def test_cache_dtype_matches_jax_scheduler(weights):
    """``cache_dtype=bfloat16`` under the float32 model: the port's
    scheduler against JAX's (whose replica has no such knob), texts of the
    in-place lanes equal."""
    jparams, host = weights
    jcfg, cfg = jpresets.llama_debug(), presets.llama_debug()
    params = transformer.place_params(cfg, convert.from_jax(host),
                                      torch.device("cpu"))
    prompt_ids = [list(p.encode()) for p in PROMPTS] * 2
    kw = dict(slots=SLOTS, prefill_chunk=CHUNK, page_tokens=PAGE)
    jax_sched = JaxScheduler(jcfg, jparams, attn="reference",
                             cache_dtype=jnp.bfloat16, **kw)
    sched = ContinuousScheduler(cfg, params, device=torch.device("cpu"),
                                cache_dtype=torch.bfloat16, **kw)
    try:
        want = _drive_sched(jax_sched, prompt_ids)
        got = _drive_sched(sched, prompt_ids)
    finally:
        jax_sched.shutdown()
        sched.shutdown()
    assert got == want
    assert sched._caches[0].k.dtype == torch.bfloat16


def _drive_sched(sched, prompt_ids):
    async def one(ids, seed):
        q: asyncio.Queue = asyncio.Queue()
        sched.submit(ids, max_new_tokens=NEW, seed=seed,
                     loop=asyncio.get_running_loop(), queue=q)
        toks = []
        while True:
            kind, val = await q.get()
            if kind == "tok":
                toks.append(val)
            elif kind == "end":
                return toks
            else:
                raise RuntimeError(val)

    async def go():
        return await asyncio.gather(*[one(ids, i)
                                      for i, ids in enumerate(prompt_ids)])

    return asyncio.run(go())


def test_lanes_and_layouts_equal_each_other(weights):
    """Paging relocates KV bytes, the gather lane reads them through a
    view, the batch path through contiguous caches: none of it may change
    a temperature-0 text (JAX: ``test_paged_equals_contiguous_arena``,
    ``test_token_streams_identical_across_lanes``)."""
    _, host = weights
    texts = {}
    for name, kw in (("reference", {}), ("gather", dict(attn="gather")),
                     ("contiguous", dict(kv_layout="contiguous")),
                     ("small pool", dict(kv_pages=48)),
                     ("no prefix cache", dict(prefix_cache=False)),
                     ("batch", dict(scheduler="batch"))):
        if kw.get("scheduler") != "batch":
            kw.update(slots=SLOTS, prefill_chunk=CHUNK, page_tokens=PAGE)
        srv = LLMServerImpl(max_new_tokens=NEW, device="cpu",
                            detokenize=_ids_text,
                            params_loader=lambda cfg: convert.from_jax(host),
                            **kw)
        texts[name], _ = _drive(srv, _requests())
    for name, t in texts.items():
        assert t == texts["reference"], name
