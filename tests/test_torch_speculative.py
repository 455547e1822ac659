"""Speculative decoding in the port (``ray_tpu_torch.serve._private.
speculative`` and the scheduler's speculative round) on the CPU.

The acceptance functions give JAX's output on the same inputs and the same
numpy rng. The port's spec server is held to the contracts of the JAX
package's ``TestSpeculativeParity``, ``TestAcceptanceSampling`` and the
drafter cases of ``TestKnobValidation`` (``tests/test_serve_fleet.py``):
temperature-0 texts equal the sequential greedy reference with accept rate
1.0 for the self drafter, slots reused, ``spec_k=1``, sampling, and the
knobs' errors. Then the port's spec server against the JAX package's, on
the same llama_debug weights: identical texts.
"""

import asyncio
from functools import partial

import jax
import numpy as np
import pytest
import torch

from ray_tpu.models import presets as jpresets
from ray_tpu.models import transformer as jtransformer
from ray_tpu.serve._private import speculative as jspec
from ray_tpu.serve.llm import LLMServerImpl as JaxLLMServerImpl
from ray_tpu_torch import LLMServerImpl, convert
from ray_tpu_torch.models import decode
from ray_tpu_torch.serve._private.continuous import ContinuousScheduler
from ray_tpu_torch.serve._private.speculative import (Drafter, _softmax,
                                                      accept_greedy,
                                                      accept_sample)

SLOTS = 4
CHUNK = 8
NEW = 6
PROMPTS = ["hi", "hello 123", "a much longer prompt than the others!"]


def _mk_server(**kw):
    kw.setdefault("max_new_tokens", NEW)
    kw.setdefault("slots", SLOTS)
    kw.setdefault("prefill_chunk", CHUNK)
    kw.setdefault("device", "cpu")
    return LLMServerImpl(**kw)


def _run(server, request):
    return asyncio.run(server(dict(request)))


def _gather(server, reqs):
    async def drive():
        return await asyncio.gather(*[server(r) for r in reqs])

    return asyncio.run(drive())


@torch.no_grad()
def _sequential_reference(srv, prompt, new_tokens):
    """Greedy tokens from the contiguous-cache programs, one at a time."""
    ids = srv._tokenize(prompt)
    caches = decode.init_caches(srv.cfg, 1, len(ids) + new_tokens,
                                device="cpu")
    logits = decode.prefill(srv.cfg, srv.params,
                            torch.tensor([ids], dtype=torch.int32), caches)
    out = []
    for _ in range(new_tokens):
        t = int(logits.argmax(-1)[0])
        out.append(t)
        logits = decode.decode_step(srv.cfg, srv.params,
                                    torch.tensor([[t]], dtype=torch.int32),
                                    caches)
    return srv._detokenize(out)


# ------------------------------------------------- acceptance against JAX


def _random_case(rng, k, vocab):
    p_draft = rng.dirichlet(np.ones(vocab) * 0.5, size=k)
    p_target = rng.dirichlet(np.ones(vocab) * 0.5, size=k + 1)
    drafts = [int(rng.choice(vocab, p=p)) for p in p_draft]
    return drafts, p_draft, p_target


def test_accept_sample_matches_jax():
    """200 random rounds (k 1-4, vocab 6): the same (accepted, emitted)
    from the same inputs and equal rng seeds, and the rngs end equal."""
    rng = np.random.default_rng(0)
    for i in range(200):
        k = 1 + i % 4
        drafts, pd, pt = _random_case(rng, k, 6)
        a, b = np.random.default_rng(i), np.random.default_rng(i)
        assert accept_sample(drafts, pd, pt, a) == jspec.accept_sample(
            drafts, pd, pt, b)
        assert a.uniform() == b.uniform()


def test_accept_greedy_and_softmax_match_jax():
    rng = np.random.default_rng(1)
    for i in range(100):
        k = 1 + i % 4
        logits = rng.standard_normal((k + 1, 5)).astype(np.float32)
        drafts = [int(x) for x in rng.integers(0, 5, k)]
        if i % 2:  # half the rounds: drafts that the target accepts
            drafts = [int(r.argmax()) for r in logits[:k]]
        assert accept_greedy(drafts, logits) == jspec.accept_greedy(
            drafts, logits)
        np.testing.assert_array_equal(_softmax(logits[0], 0.7),
                                      jspec._softmax(logits[0], 0.7))


# ---------------------------------------- TestAcceptanceSampling (port)


class TestAcceptanceSampling:
    def test_greedy_acceptance_prefix_rule(self):
        logits = np.zeros((4, 8), np.float32)
        logits[0, 3] = 9  # target argmax after position: 3
        logits[1, 5] = 9
        logits[2, 2] = 9
        logits[3, 7] = 9
        acc, emitted = accept_greedy([3, 5, 2], logits)
        assert acc == 3
        assert emitted == [3, 5, 2, 7]  # all accepted + bonus
        acc, emitted = accept_greedy([3, 9, 2], logits)
        assert acc == 1
        assert emitted == [3, 5]  # replacement from the verify row

    def test_sample_acceptance_matches_target_distribution(self):
        """The arXiv:2211.17192 guarantee: tokens emitted by speculative
        sampling are distributed exactly per the target distribution,
        whatever the draft distribution (here a deliberately skewed one)."""
        rng = np.random.default_rng(0)
        vocab = 4
        p_target = np.asarray([0.5, 0.3, 0.15, 0.05])
        p_draft = np.asarray([0.05, 0.15, 0.3, 0.5])  # reversed
        counts = np.zeros(vocab)
        n_trials = 20000
        accepted_total = 0
        for _ in range(n_trials):
            d = int(rng.choice(vocab, p=p_draft))
            acc, emitted = accept_sample(
                [d], [p_draft], [p_target, p_target], rng)
            accepted_total += acc
            counts[emitted[0]] += 1
        emp = counts / counts.sum()
        assert np.abs(emp - p_target).max() < 0.02, emp
        # acceptance rate = sum_t min(p, q) for these distributions
        expect = float(np.minimum(p_target, p_draft).sum())
        assert abs(accepted_total / n_trials - expect) < 0.02

    def test_identical_distributions_always_accept(self):
        rng = np.random.default_rng(1)
        p = np.asarray([0.25, 0.25, 0.25, 0.25])
        for _ in range(200):
            d = int(rng.integers(4))
            acc, emitted = accept_sample([d], [p], [p, p], rng)
            assert acc == 1
            assert emitted[0] == d

    def test_softmax_temperature(self):
        row = np.asarray([1.0, 2.0, 3.0], np.float32)
        p = _softmax(row, 1.0)
        assert abs(p.sum() - 1.0) < 1e-9
        sharp = _softmax(row, 0.25)
        assert sharp[2] > p[2]  # lower temperature sharpens


# ---------------------------------------- TestSpeculativeParity (port)


@pytest.fixture(scope="module")
def spec_server():
    srv = _mk_server(drafter="self", spec_k=4)
    yield srv
    srv.shutdown()


class TestSpeculativeParity:
    def test_temp0_bit_identical_mixed_lengths(self, spec_server):
        """k-token drafting + one verify call emits EXACTLY the sequential
        greedy tokens: mixed prompt lengths, chunked prefill, concurrent
        slots and all; the plain decode step never runs."""
        srv = spec_server
        refs = {p: _sequential_reference(srv, p, NEW) for p in PROMPTS}
        for o in _gather(srv, [{"prompt": p} for p in PROMPTS * 3]):
            assert o["text"] == refs[o["prompt"]], (
                f"speculative output diverged for {o['prompt']!r}")
            assert o["num_tokens"] == NEW
        st = srv.scheduler_stats()
        assert st["spec_rounds"] > 0
        assert st["spec_drafted_tokens"] > 0
        # self drafter at temperature 0: every draft is accepted
        assert st["spec_accept_rate"] == 1.0
        assert st["spec_tokens_per_step"] > 1.0
        assert st["plain_decode_steps"] == 0
        assert st["verify_rounds"] == st["spec_rounds"] == st["decode_steps"]

    def test_slot_reuse_stays_exact(self, spec_server):
        """More requests than slots force retire/reuse mid-speculation;
        rewound cursors and drafter sync must not leak between occupants."""
        srv = spec_server
        ref = _sequential_reference(srv, "hello 123", NEW)
        outs = _gather(srv, [{"prompt": "hello 123"}
                             for _ in range(SLOTS * 3)])
        for o in outs:
            assert o["text"] == ref

    def test_k1_degenerate_matches(self):
        """spec_k=1: one draft + bonus. Still exact, still more than one
        token per verify round at full acceptance."""
        srv = _mk_server(drafter="self", spec_k=1)
        try:
            ref = _sequential_reference(srv, "hello 123", NEW)
            out = _run(srv, {"prompt": "hello 123"})
            assert out["text"] == ref
            st = srv.scheduler_stats()
            assert st["spec_k"] == 1
            assert st["spec_tokens_per_step"] > 1.0
        finally:
            srv.shutdown()

    def test_temp_gt0_runs_and_counts(self):
        srv = _mk_server(drafter="self", spec_k=3, temperature=0.8)
        try:
            out = _run(srv, {"prompt": "hello 123"})
            assert out["num_tokens"] == NEW
            st = srv.scheduler_stats()
            assert st["spec_drafted_tokens"] > 0
            assert 0.0 < st["spec_accept_rate"] <= 1.0
        finally:
            srv.shutdown()

    def test_distinct_drafter_prefills_and_stays_exact(self):
        """A drafter that is not the target (llama_debug from its own seed
        under a target from another seed) primes each slot by running the
        prompt through its own model; temperature-0 texts are still the
        target's greedy texts, whatever it proposes."""
        from ray_tpu_torch.models.transformer import init_params

        srv = _mk_server(drafter="llama_debug", spec_k=3,
                         params_loader=lambda cfg: init_params(
                             cfg, seed=7, device="cpu"))
        try:
            assert not srv._sched._drafter.shares_target
            refs = {p: _sequential_reference(srv, p, NEW) for p in PROMPTS}
            for o in _gather(srv, [{"prompt": p} for p in PROMPTS * 2]):
                assert o["text"] == refs[o["prompt"]]
            st = srv.scheduler_stats()
            assert st["drafter"] == "llama_debug"
            assert st["spec_drafted_tokens"] > 0
            assert st["spec_accept_rate"] < 1.0
        finally:
            srv.shutdown()


# ------------------------------------------ TestKnobValidation (drafter)


class TestKnobValidation:
    def test_explicit_zero_spec_k_rejected(self):
        with pytest.raises(ValueError, match="spec_k"):
            _mk_server(drafter="self", spec_k=0)

    def test_unknown_drafter_preset_rejected(self):
        with pytest.raises(ValueError, match="drafter"):
            _mk_server(drafter="no_such_preset")

    def test_drafter_vocab_mismatch_rejected(self):
        with pytest.raises(ValueError, match="vocab_size"):
            _mk_server(drafter="gpt2_small")

    def test_drafter_slots_must_match_the_scheduler(self):
        srv = _mk_server()
        try:
            drafter = Drafter(srv.cfg, srv.params, slots=SLOTS + 1,
                              arena_len=64, device=torch.device("cpu"))
            with pytest.raises(ValueError, match="slots"):
                ContinuousScheduler(srv.cfg, srv.params,
                                    device=torch.device("cpu"), slots=SLOTS,
                                    drafter=drafter)
        finally:
            srv.shutdown()

    def test_speculation_reserves_spec_k_positions(self):
        """A verify round near the end of a generation writes up to spec_k
        positions past the last cursor: those are kept free at admission."""
        plain = _mk_server()
        spec = _mk_server(drafter="self", spec_k=4)
        try:
            assert (plain._sched.max_prompt_len(NEW)
                    - spec._sched.max_prompt_len(NEW)) == 4
        finally:
            plain.shutdown()
            spec.shutdown()


# ------------------------------------------------ against the JAX server


def test_spec_texts_match_jax_spec_server():
    """The port's spec server against the JAX package's (self drafter,
    spec_k 4, its in-place reference lane) on the same llama_debug
    weights: identical texts, temperature 0 and one sampled request, and
    the same acceptance counts."""
    jparams = jax.jit(partial(jtransformer.init_params,
                              jpresets.llama_debug()))(jax.random.PRNGKey(0))
    host = jax.tree.map(np.asarray, jparams)
    reqs = [{"prompt": p} for p in PROMPTS * 2] + [
        {"prompt": "hello 123 sampled", "temperature": 0.8}]
    kw = dict(max_new_tokens=NEW, slots=SLOTS, prefill_chunk=CHUNK,
              page_tokens=4, drafter="self", spec_k=4)
    jsrv = JaxLLMServerImpl(share_weights=False, attn="reference",
                            params_loader=lambda cfg: jparams, **kw)
    try:
        want = [o["text"] for o in _gather(jsrv, reqs)]
        jst = jsrv.scheduler_stats()
    finally:
        jsrv.shutdown()
    srv = LLMServerImpl(device="cpu",
                        params_loader=lambda cfg: convert.from_jax(host),
                        **kw)
    try:
        got = [o["text"] for o in _gather(srv, reqs)]
        st = srv.scheduler_stats()
    finally:
        srv.shutdown()
    assert got == want
    for key in ("spec_rounds", "spec_drafted_tokens",
                "spec_accepted_tokens"):
        assert st[key] == jst[key], key
