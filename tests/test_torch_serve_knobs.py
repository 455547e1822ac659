"""The port's scheduler and replica knobs: their validation and refusals,
the paged arena under pressure, the request-level batcher, the paged
attention lane resolver and the radix cache's digest. Each mirrors a JAX
test of the same contract (named in its docstring); the digest is held
against the JAX package's own ``RadixCache``.

The JAX package also reads its knobs from environment variables through a
config layer; the port has none, so the tests of that path have no
counterpart here.
"""

import asyncio
import time

import numpy as np
import pytest
import torch

from ray_tpu.serve._private.paging import PageArena as JaxPageArena
from ray_tpu.serve._private.paging import RadixCache as JaxRadixCache
from ray_tpu_torch import LLMServerImpl
from ray_tpu_torch import serve
from ray_tpu_torch.models import decode
from ray_tpu_torch.models.decode import generate
from ray_tpu_torch.models.presets import llama_debug
from ray_tpu_torch.models.transformer import init_params
from ray_tpu_torch.ops.attention import (PAGED_ATTN_CHOICES,
                                         PAGED_ATTN_LANES,
                                         check_paged_attn_lane,
                                         resolve_paged_attn_lane)
from ray_tpu_torch.ops.rotary import rope_frequencies
from ray_tpu_torch.serve._private.affinity import (CHAIN_SEED, chain_hashes,
                                                   prompt_chain)
from ray_tpu_torch.serve._private.continuous import ContinuousScheduler
from ray_tpu_torch.serve._private.paging import PageArena, RadixCache
from ray_tpu_torch.serve._private.speculative import Drafter

CHUNK, PAGE, NEW = 8, 8, 6
CPU = torch.device("cpu")


class _Cfg:  # never reaches a program: validation fires first
    max_seq_len = 128


def _sequential_reference(srv, prompt: str, new_tokens: int = NEW) -> str:
    """Greedy tokens of one prompt through contiguous caches, no
    scheduler."""
    ids = torch.tensor([srv._tokenize(prompt)], dtype=torch.int32)
    out = generate(srv.cfg, srv.params, ids, None, new_tokens)
    return srv._detokenize(out[0].tolist())


# ----------------------------------------------------------------- knobs


class TestKnobValidation:
    """JAX: ``tests/test_paged_kv.py::TestKnobValidation``."""

    def test_explicit_zero_page_tokens_rejected(self):
        with pytest.raises(ValueError, match="page_tokens"):
            ContinuousScheduler(_Cfg(), None, device=CPU, page_tokens=0)

    def test_misaligned_arena_rejected(self):
        with pytest.raises(ValueError, match="multiple"):
            ContinuousScheduler(_Cfg(), None, device=CPU, arena_len=100,
                                page_tokens=16)

    def test_prefix_cache_requires_paged_layout(self):
        with pytest.raises(ValueError, match="prefix_cache"):
            ContinuousScheduler(_Cfg(), None, device=CPU,
                                kv_layout="contiguous", prefix_cache=True)

    def test_unknown_layout_rejected(self):
        with pytest.raises(ValueError, match="kv_layout"):
            ContinuousScheduler(_Cfg(), None, device=CPU, kv_layout="ring")

    def test_negative_kv_pages_rejected(self):
        with pytest.raises(ValueError, match="kv_pages"):
            ContinuousScheduler(_Cfg(), None, device=CPU, kv_pages=-1)

    def test_over_budget_prompt_rejected_before_any_page_allocated(self):
        """Admission is page-aware: a prompt whose prompt + budget can
        never fit the pool fails at submit, and no page was ever handed
        out for it."""
        srv = LLMServerImpl(max_new_tokens=4, slots=4, prefill_chunk=CHUNK,
                            page_tokens=PAGE, arena_len=64,
                            kv_pages=5,  # 4 usable pages = 32 tokens
                            prefix_cache=False, device="cpu")
        try:
            with pytest.raises(ValueError, match="arena"):
                asyncio.run(srv({"prompt": "x" * 40}))
            st = srv.scheduler_stats()
            assert st["pages_allocated_total"] == 0, st
            out = asyncio.run(srv({"prompt": "hello 123",
                                   "max_new_tokens": 2}))
            assert out["num_tokens"] == 2
        finally:
            srv.shutdown()

    def test_contiguous_layout_refuses_a_lane_and_a_drafter(self):
        """JAX: ``ContinuousScheduler.__init__`` refuses ``attn=`` and a
        drafter on the contiguous arena (``continuous.py:296-339``)."""
        cfg = llama_debug()
        with pytest.raises(ValueError, match="attn lane selection"):
            ContinuousScheduler(cfg, None, device=CPU,
                                kv_layout="contiguous", attn="gather")
        drafter = Drafter(cfg, None, slots=8, arena_len=cfg.max_seq_len,
                          device=CPU)
        with pytest.raises(ValueError, match="speculative decoding requires"):
            ContinuousScheduler(cfg, None, device=CPU,
                                kv_layout="contiguous", drafter=drafter)


def test_explicit_zero_knobs_rejected():
    """JAX: ``tests/test_serve_llm.py::test_explicit_zero_knobs_rejected``:
    slots=0 and prefill_chunk=0 raise, never a default."""
    with pytest.raises(ValueError, match="slots"):
        ContinuousScheduler(_Cfg(), None, device=CPU, slots=0)
    with pytest.raises(ValueError, match="prefill_chunk"):
        ContinuousScheduler(_Cfg(), None, device=CPU, prefill_chunk=0)


def test_batch_mode_validates_request_knobs():
    """JAX: ``tests/test_serve_llm.py::
    test_batch_mode_validates_request_knobs``: the request-level path
    checks the budget before it sizes a cache, and refuses a per-request
    temperature it cannot honour."""
    srv = LLMServerImpl(max_new_tokens=4, scheduler="batch", device="cpu")

    async def drive():
        with pytest.raises(ValueError, match="max_seq_len"):
            await srv({"prompt": "hi", "max_new_tokens": 10_000})
        with pytest.raises(ValueError, match=">= 1"):
            await srv({"prompt": "hi", "max_new_tokens": 0})
        with pytest.raises(ValueError, match="temperature"):
            await srv({"prompt": "hi", "temperature": 0.7})
        out = await srv({"prompt": "hi", "max_new_tokens": 2})
        assert out["num_tokens"] == 2
        out = await srv({"prompt_ids": [104, 105], "max_new_tokens": 3})
        assert out["num_tokens"] == 3

    asyncio.run(drive())
    assert srv.check_health() and srv.queue_depth() == 0
    assert srv.prefix_digest() == {}


def test_replica_refusals():
    """JAX: ``LLMServerImpl.__init__`` (``llm.py:180-187``): a drafter or
    a lane needs the continuous scheduler; an unknown scheduler raises."""
    with pytest.raises(ValueError, match="scheduler must be"):
        LLMServerImpl(scheduler="fifo", device="cpu")
    with pytest.raises(ValueError, match="drafter"):
        LLMServerImpl(scheduler="batch", drafter="self", device="cpu")
    with pytest.raises(ValueError, match="attn lane selection"):
        LLMServerImpl(scheduler="batch", attn="gather", device="cpu")


def test_replica_knobs_pass_through():
    """``preset_overrides`` reshape the model, custom tokenizers and
    ``prompt_ids`` reach the scheduler, and the replica reports its queue
    and its prefix digest (with the tokenizer the router must use)."""
    seen = []
    srv = LLMServerImpl(preset_overrides={"max_seq_len": 64},
                        max_new_tokens=3, slots=2, prefill_chunk=CHUNK,
                        page_tokens=PAGE, device="cpu",
                        tokenize=lambda text: [1 + len(w)
                                               for w in text.split()],
                        detokenize=lambda ids: seen.extend(ids) or "x")
    try:
        assert srv.cfg.max_seq_len == 64
        assert srv.scheduler_stats()["arena_len"] == 64
        out = asyncio.run(srv({"prompt": "a bb ccc dddd " * 3}))
        assert out["text"] == "x" and len(seen) == 3
        out = asyncio.run(srv({"prompt_ids": list(range(1, 20))}))
        d = srv.prefix_digest()
        assert d["tok"] == "opaque" and d["vocab_size"] == 256
        assert d["page_tokens"] == PAGE and d["hashes"]
        assert set(prompt_chain(list(range(1, 20)), PAGE)) <= set(d["hashes"])
        assert srv.queue_depth() == 0
    finally:
        srv.shutdown()
    contiguous = LLMServerImpl(kv_layout="contiguous", device="cpu")
    try:
        assert contiguous.prefix_digest() == {}
        st = contiguous.scheduler_stats()
        assert st["kv_layout"] == "contiguous" and "attn_lane" not in st
    finally:
        contiguous.shutdown()


# -------------------------------------------------------------- eviction


def test_arena_pressure_evicts_lru_and_stays_correct():
    """JAX: ``tests/test_paged_kv.py::TestEvictionAndCancel::
    test_arena_pressure_evicts_lru_and_stays_correct``: a pool too small to
    cache every distinct prompt evicts refcount-0 nodes LRU; an evicted
    prefix simply prefills again, and every text stays exact."""
    srv = LLMServerImpl(max_new_tokens=4, slots=2, prefill_chunk=CHUNK,
                        page_tokens=PAGE, arena_len=64,
                        kv_pages=2 * (64 // PAGE) + 1, device="cpu")
    try:
        # distinct from byte 0 so no page is shared between prompts: each
        # caches its own full pages and the pool must churn
        prompts = [f"{i} unique preamble body tail xx" for i in range(6)]
        refs = {p: _sequential_reference(srv, p, 4) for p in prompts}

        async def drive():
            outs = []
            for p in prompts:       # one after another: most churn
                outs.append(await srv({"prompt": p}))
            outs += await asyncio.gather(*[
                srv({"prompt": p}) for p in prompts])
            return outs

        for o in asyncio.run(drive()):
            assert o["text"] == refs[o["prompt"]], \
                f"eviction corrupted {o['prompt']!r}"
        st = srv.scheduler_stats()
        assert st["evicted_pages_total"] > 0, \
            f"pool never came under pressure: {st}"
        assert st["pages_in_use"] == st["radix_resident_pages"]
        assert st["radix_active_refs"] == 0
    finally:
        srv.shutdown()


# ----------------------------------------------------------- lane resolver


def test_lane_resolver_choices():
    """JAX: ``resolve_paged_attn_lane`` (``ops/attention.py:55-75``), with
    the port's lanes: "auto" follows the device; unknown and falsy values
    raise and name the port's choices, JAX's "pallas" among them."""
    assert PAGED_ATTN_CHOICES == ("auto", "cuda", "reference", "gather")
    cpu, card = torch.device("cpu"), torch.device("cuda", 0)
    assert resolve_paged_attn_lane(None, cpu) == "reference"
    assert resolve_paged_attn_lane("auto", cpu) == "reference"
    assert resolve_paged_attn_lane("auto", card) == "cuda"
    assert resolve_paged_attn_lane("cuda", card) == "cuda"
    assert resolve_paged_attn_lane("gather", card) == "gather"
    assert resolve_paged_attn_lane("gather", cpu) == "gather"
    assert resolve_paged_attn_lane("reference", cpu) == "reference"
    for bad in ("pallas", "", "0", 0, False, "Reference", "flash"):
        with pytest.raises(ValueError, match=r"'auto', 'cuda', 'reference', "
                                             r"'gather'"):
            resolve_paged_attn_lane(bad, cpu)


def test_reference_lane_refused_on_a_cuda_device():
    """A plain version never serves where the card is: the scheduler on a
    CUDA device refuses ``attn="reference"`` at build, before it allocates
    anything on the card (none is needed to show it); and the kernel's
    lane needs the card."""
    cfg = llama_debug()
    with pytest.raises(ValueError, match="CPU only"):
        ContinuousScheduler(cfg, None, device=torch.device("cuda", 0),
                            attn="reference")
    with pytest.raises(ValueError, match="needs a CUDA device"):
        ContinuousScheduler(cfg, None, device=CPU, attn="cuda")
    with pytest.raises(ValueError, match="unknown paged attention lane"):
        ContinuousScheduler(cfg, None, device=CPU, attn="pallas")


def test_reference_lane_refused_by_the_replica_with_a_card(monkeypatch):
    """The replica's path to the same refusal, with a card faked as in
    ``test_torch_serve.py``: the replica resolves a CUDA device and keeps
    the (absent) weights where they are, and its scheduler's lane check
    raises."""
    import ray_tpu_torch.serve.llm as llm

    monkeypatch.setattr(llm, "resolve_device",
                        lambda device=None: torch.device("cuda", 0))
    monkeypatch.setattr(llm, "place_params",
                        lambda cfg, params, device: params)
    with pytest.raises(ValueError, match="CPU only"):
        LLMServerImpl(attn="reference",
                      params_loader=lambda cfg: None)


def test_programs_lane_check():
    """The paged programs' one lane check: every lane on the CPU, the
    kernel's and the gather lane on a CUDA device, "reference" refused
    there; the scheduler's "auto" and anything unknown are no program
    lane."""
    cpu, card = torch.device("cpu"), torch.device("cuda", 0)
    assert PAGED_ATTN_LANES == ("cuda", "reference", "gather")
    for lane in PAGED_ATTN_LANES:
        check_paged_attn_lane(lane, cpu)
    check_paged_attn_lane("cuda", card)
    check_paged_attn_lane("gather", card)
    with pytest.raises(ValueError, match="CPU only"):
        check_paged_attn_lane("reference", card)
    for bad in ("auto", "pallas", "", None):
        with pytest.raises(ValueError, match="unknown paged attention lane"):
            check_paged_attn_lane(bad, cpu)


class _OnCard(torch.Tensor):
    """A CPU tensor that reports a CUDA device: enough for a check that
    reads the device before any work."""
    device = property(lambda self: torch.device("cuda", 0))


def _paged_setup(S=2, P=4, T=4):
    cfg = llama_debug()
    params = init_params(cfg, seed=0, device="cpu")
    rope = rope_frequencies(cfg.head_dim, cfg.max_seq_len, cfg.rope_theta)
    caches = decode.init_paged_caches(cfg, S, S * P + 1, T, P, device="cpu")
    tables = (1 + torch.arange(S * P, dtype=torch.int32)).reshape(S, P)
    return cfg, params, rope, caches, tables


def _paged_run(setup, tokens, attn):
    """One prefill chunk into slot 0, one decode step over both slots, one
    3-token verify window: each program's logits."""
    cfg, params, rope, caches, tables = setup
    one = torch.ones(2, dtype=torch.int32)
    return [
        decode.paged_prefill_into_slot(
            cfg, params, tokens(torch.tensor([[5, 9, 13, 0]],
                                             dtype=torch.int32)),
            3, 0, tables[0], tables[0], caches, rope, attn=attn),
        decode.paged_decode_step(
            cfg, params, tokens(torch.tensor([3, 11], dtype=torch.int32)),
            one, tables, tables, caches, rope, attn=attn),
        decode.paged_verify_step(
            cfg, params, tokens(torch.tensor([[4, 7, 2], [8, 1, 6]],
                                             dtype=torch.int32)),
            tables, tables, caches, rope, attn=attn)]


def test_programs_refuse_reference_on_a_cuda_device():
    """Each paged program handed tokens on a CUDA device refuses the
    "reference" lane before it writes a page or moves a cursor: the
    plain version never serves where the card is, whoever calls the
    programs."""
    cfg, params, rope, caches, tables = _paged_setup()

    def on_card(t):
        return torch.Tensor._make_subclass(_OnCard, t)

    one = torch.ones(2, dtype=torch.int32)
    calls = [
        lambda: decode.paged_prefill_into_slot(
            cfg, params, on_card(torch.ones((1, 4), dtype=torch.int32)), 3,
            0, tables[0], tables[0], caches, rope, attn="reference"),
        lambda: decode.paged_decode_step(
            cfg, params, on_card(torch.ones(2, dtype=torch.int32)), one,
            tables, tables, caches, rope, attn="reference"),
        lambda: decode.paged_verify_step(
            cfg, params, on_card(torch.ones((2, 3), dtype=torch.int32)),
            tables, tables, caches, rope, attn="reference")]
    for call in calls:
        with pytest.raises(ValueError, match="CPU only"):
            call()
    assert int(caches[0].lengths.abs().sum()) == 0
    assert all(float(c.k.abs().sum()) == 0 for c in caches)


def test_reference_lane_attends_through_the_kernel_wrapper(monkeypatch):
    """On the CPU the "reference" lane is the "cuda" lane: both attend
    through ``ops.paged_attention`` once per layer and program call (the
    wrapper runs the plain version on CPU tensors), with bitwise equal
    logits. No program calls the plain version past the wrapper."""
    calls = []
    wrapped = decode.paged_attention

    def counting(*a, **kw):
        calls.append(a[0].shape)
        return wrapped(*a, **kw)

    monkeypatch.setattr(decode, "paged_attention", counting)
    runs = {}
    for lane in ("reference", "cuda"):
        calls.clear()
        setup = _paged_setup()
        runs[lane] = _paged_run(setup, lambda t: t, lane)
        assert len(calls) == 3 * setup[0].num_layers, lane
    for a, b in zip(runs["reference"], runs["cuda"]):
        assert torch.equal(a, b)


# ----------------------------------------------------------- digest


def test_radix_digest_equals_jax():
    """The port's ``RadixCache.digest()`` against JAX's over one sequence
    of insert, split (a match and an insert that diverge mid-edge), evict
    and clear: the same chain hashes and version stamps at every step."""
    T = 4
    caches = [RadixCache(PageArena(64, T)), JaxRadixCache(JaxPageArena(64, T))]
    rng = np.random.default_rng(0)
    base = [int(t) for t in rng.integers(1, 256, 24)]
    other = base[:8] + [int(t) for t in rng.integers(1, 256, 12)]
    third = [int(t) for t in rng.integers(1, 256, 8)]

    def digests():
        out = [c.digest() for c in caches]
        for d in out:
            d["hashes"] = sorted(d["hashes"])
        return out

    steps = []
    nodes = {}
    for i, c in enumerate(caches):
        arena = c.arena
        _, nodes[i, "a"] = c.insert(base, arena.alloc(6))
    steps.append(digests())
    for i, c in enumerate(caches):
        _, _, node = c.match(base[:12])  # splits base's edge after 3 pages
        c.release(node)
    steps.append(digests())
    for i, c in enumerate(caches):
        # shares base's first 2 pages, splits there, adopts 3 new pages
        dups, nodes[i, "b"] = c.insert(other, c.arena.alloc(5))
        c.arena.free(dups)
        _, nodes[i, "c"] = c.insert(third, c.arena.alloc(2))
    steps.append(digests())
    for i, c in enumerate(caches):
        c.release(nodes[i, "a"])
        c.release(nodes[i, "c"])
        assert c.evict(2) >= 2
    steps.append(digests())
    for i, c in enumerate(caches):
        c.release(nodes[i, "b"])
        c.clear()
    steps.append(digests())
    for port, jax_d in steps:
        assert port == jax_d
    assert steps[0][0]["hashes"] == sorted(chain_hashes(base, T))
    assert steps[-1][0]["hashes"] == []
    assert chain_hashes([], T) == [] and CHAIN_SEED == 0
    port = caches[0]
    assert port.resident_pages() == port.node_count() == 0
    assert port.active_refs() == 0


# ------------------------------------------------------------ batching


class TestBatchQueueHardening:
    """JAX: ``tests/test_serve_llm.py::TestBatchQueueHardening``, against
    the port's copy of ``serve/batching.py``."""

    def test_deploy_time_size_and_timeout_overrides(self):
        sizes = []

        class Dep:
            def __init__(self):
                setattr(self, "__serve_batch_size_fn", 3)
                setattr(self, "__serve_batch_timeout_fn", 5.0)

            @serve.batch(max_batch_size=64, batch_wait_timeout_s=0.001)
            async def fn(self, items):
                sizes.append(len(items))
                return [i * 2 for i in items]

        async def drive():
            d = Dep()
            # 3 submits == the overridden size: a full flush at once (the
            # 5 s override timeout would stall otherwise)
            t0 = time.monotonic()
            out = await asyncio.wait_for(
                asyncio.gather(d.fn(1), d.fn(2), d.fn(3)), timeout=2.0)
            assert time.monotonic() - t0 < 2.0
            return out

        assert asyncio.run(drive()) == [2, 4, 6]
        assert sizes == [3], f"override ignored: {sizes}"

    def test_len_mismatch_fails_every_waiter(self):
        class Dep:
            @serve.batch(max_batch_size=2, batch_wait_timeout_s=0.01)
            async def fn(self, items):
                return [1]  # wrong length

        async def drive():
            d = Dep()
            r = await asyncio.gather(d.fn("a"), d.fn("b"),
                                     return_exceptions=True)
            assert all(isinstance(x, ValueError) for x in r), r
            assert all("results for" in str(x) for x in r)

        asyncio.run(drive())

    def test_per_item_error_isolation(self):
        class Dep:
            @serve.batch(max_batch_size=3, batch_wait_timeout_s=0.01)
            async def fn(self, items):
                return [ValueError(f"bad {i}") if i == 2 else i * 10
                        for i in items]

        async def drive():
            d = Dep()
            r = await asyncio.gather(d.fn(1), d.fn(2), d.fn(3),
                                     return_exceptions=True)
            assert r[0] == 10 and r[2] == 30
            assert isinstance(r[1], ValueError) and "bad 2" in str(r[1])

        asyncio.run(drive())

    def test_full_flush_timer_race_no_double_flush(self):
        flushed = []

        class Dep:
            @serve.batch(max_batch_size=4, batch_wait_timeout_s=0.0)
            async def fn(self, items):
                flushed.append(len(items))
                await asyncio.sleep(0)  # yield so flushes interleave
                return list(items)

        async def drive():
            d = Dep()
            out = []
            for _round in range(20):
                out += await asyncio.gather(*[d.fn(i) for i in range(7)])
            return out

        out = asyncio.run(drive())
        assert len(out) == 20 * 7
        assert sorted(out) == sorted(list(range(7)) * 20)
        assert sum(flushed) == 20 * 7, f"lost/duplicated items: {flushed}"

    def test_function_batch_still_works(self):
        @serve.batch(max_batch_size=4, batch_wait_timeout_s=0.01)
        async def fn(items):
            return [i + 1 for i in items]

        async def drive():
            return await asyncio.gather(*[fn(i) for i in range(4)])

        assert asyncio.run(drive()) == [1, 2, 3, 4]

    def test_sync_function_refused(self):
        with pytest.raises(TypeError, match="async"):
            serve.batch(lambda items: items)
