"""The port's contiguous and slot-arena serving programs and the paged verify
window (``ray_tpu_torch.models.decode``) on the CPU against the JAX package,
on the same weights converted from one JAX init and the same numpy inputs.

Float32 throughout; logits hold to 1e-4 and cache contents to 1e-5, as in
``test_torch_model.py``. Verify logits against the port's own 1-token
steps hold to 1e-5: the same arithmetic, only the batch shapes differ.
"""

import copy
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models import decode as jdecode
from ray_tpu.models import presets as jpresets
from ray_tpu_torch._private import convert
from ray_tpu_torch.models import decode, presets, transformer
from ray_tpu_torch.ops import rotary

OP_TOL = dict(atol=1e-5, rtol=1e-5)
LOGIT_TOL = dict(atol=1e-4, rtol=0)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _gpt2_tiny(mod, dtype, **kw):
    return mod.gpt2_small(vocab_size=96, num_layers=2, embed_dim=32,
                          num_heads=4, max_seq_len=64, dtype=dtype, **kw)


CONFIGS = {
    "llama_debug": (lambda: jpresets.llama_debug(),
                    lambda: presets.llama_debug()),
    "gpt2_tiny": (lambda: _gpt2_tiny(jpresets, jnp.float32,
                                     scan_layers=False),
                  lambda: _gpt2_tiny(presets, torch.float32)),
}


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def model_pair(request):
    from ray_tpu.models import transformer as jtransformer

    jcfg, cfg = (f() for f in CONFIGS[request.param])
    jparams = jax.jit(partial(jtransformer.init_params, jcfg))(
        jax.random.PRNGKey(0))
    params = transformer.place_params(
        cfg, convert.from_jax(jax.tree.map(np.asarray, jparams)),
        torch.device("cpu"))
    return jcfg, jparams, cfg, params


def _tokens(cfg, seed, shape):
    return np.random.default_rng(seed).integers(
        1, cfg.vocab_size, shape).astype(np.int32)


# ------------------------------------------------------------ contiguous


def test_prefill_and_decode_steps_match_jax(model_pair):
    """A 2 x 5 prompt into contiguous caches, then three decode steps:
    logits against ``prefill``/``decode_step``, then the caches' k/v and
    cursors."""
    jcfg, jparams, cfg, params = model_pair
    B, S, L = 2, 5, 16
    prompt = _tokens(cfg, 0, (B, S))
    jc = jdecode.init_caches(jcfg, B, L)
    tc = decode.init_caches(cfg, B, L, device="cpu")
    want, jc = jax.jit(partial(jdecode.prefill, jcfg))(
        jparams, jnp.asarray(prompt), jc)
    got = decode.prefill(cfg, params, _t(prompt), tc)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LOGIT_TOL)
    jstep = jax.jit(partial(jdecode.decode_step, jcfg))
    for i in range(3):
        tok = _tokens(cfg, 10 + i, (B, 1))
        want, jc = jstep(jparams, jnp.asarray(tok), jc)
        got = decode.decode_step(cfg, params, _t(tok), tc)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   **LOGIT_TOL, err_msg=f"step {i}")
    for layer in range(cfg.num_layers):
        assert tc[layer].length.tolist() == [S + 3] * B
        assert int(jc[layer].length) == S + 3
        np.testing.assert_allclose(tc[layer].k.numpy(),
                                   np.asarray(jc[layer].k), **OP_TOL)
        np.testing.assert_allclose(tc[layer].v.numpy(),
                                   np.asarray(jc[layer].v), **OP_TOL)


def test_generate_greedy_matches_jax(model_pair):
    jcfg, jparams, cfg, params = model_pair
    prompt = _tokens(cfg, 1, (2, 6))
    want = jdecode.generate(jcfg, jparams, jnp.asarray(prompt),
                            jax.random.PRNGKey(0), 8)
    got = decode.generate(cfg, params, _t(prompt), None, 8)
    assert got.tolist() == np.asarray(want).tolist()


def test_mask_bias_per_row():
    """Each row's cursor sets its own mask row: query i of row b sees cache
    positions <= length[b] + i, as JAX's scalar-cursor bias does for one
    row."""
    c = decode.LayerKVCache.zeros(2, 6, 1, 4, torch.float32,
                                  torch.device("cpu"))
    c.length = torch.tensor([1, 3], dtype=torch.int32)
    bias = c.mask_bias(2)
    assert tuple(bias.shape) == (2, 1, 1, 2, 6)
    for b, n in enumerate((1, 3)):
        jc = jdecode.LayerKVCache.zeros(1, 6, 1, 4, jnp.float32)
        jc = jc.__class__(k=jc.k, v=jc.v, length=jnp.int32(n))
        assert bias[b, 0, 0].tolist() == np.asarray(
            jc.mask_bias(2))[0, 0, 0].tolist()


def test_update_clamps_a_write_past_the_end():
    """As ``lax.dynamic_update_slice``: a write that would run past the
    buffer starts earlier instead."""
    c = decode.LayerKVCache.zeros(1, 4, 1, 1, torch.float32,
                                  torch.device("cpu"))
    c.length = torch.tensor([3], dtype=torch.int32)
    new = torch.tensor([[[[7.0]], [[8.0]]]])
    c.update(new, new)
    assert c.k[0, :, 0, 0].tolist() == [0.0, 0.0, 7.0, 8.0]
    assert c.length.tolist() == [5]


def test_sample_token():
    logits = torch.tensor([[0.0, 3.0, 1.0, 2.0], [5.0, 5.0, 0.0, 0.0]])
    assert decode.sample_token(logits).tolist() == [1, 0]  # first max
    g = torch.Generator().manual_seed(0)
    draws = torch.stack([decode.sample_token(logits, g, 1.0, top_k=2)
                         for _ in range(200)])
    assert set(draws[:, 0].tolist()) == {1, 3}
    assert set(draws[:, 1].tolist()) == {0, 1}
    again = torch.stack([decode.sample_token(
        logits, torch.Generator().manual_seed(5), 0.7) for _ in range(3)])
    assert (again == again[0]).all()  # one seed, one draw


# ------------------------------------------------------------ slot arena


def test_slot_arena_matches_jax(model_pair):
    """Prefill chunks into slots 1 and 0 (the second in two chunks), then
    decode steps over all three slots with slot 2 inactive and then slot
    1 inactive: logits of the live slots, every slot's cursor, and the k/v
    of the written positions, against ``prefill_into_slot`` /
    ``slot_decode_step``. ``reset_slot`` rewinds a cursor."""
    jcfg, jparams, cfg, params = model_pair
    slots, L, C = 3, 32, 8
    jc = jdecode.init_slot_caches(jcfg, slots, L)
    tc = decode.init_slot_caches(cfg, slots, L, device="cpu")
    jprefill = jax.jit(partial(jdecode.prefill_into_slot, jcfg))
    jstep = jax.jit(partial(jdecode.slot_decode_step, jcfg))
    for slot, real, seed in ((1, 5, 0), (0, 8, 1), (0, 3, 2)):
        chunk = np.zeros((1, C), np.int32)
        chunk[0, :real] = _tokens(cfg, seed, real)
        want, jc = jprefill(jparams, jnp.asarray(chunk), real, slot, jc)
        got = decode.prefill_into_slot(cfg, params, _t(chunk), real, slot,
                                       tc)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   **LOGIT_TOL)
    assert tc[0].lengths.tolist() == [11, 5, 0]
    for i, active in enumerate(([1, 1, 0], [1, 0, 0], [1, 1, 0])):
        toks = _tokens(cfg, 20 + i, slots)
        act = np.asarray(active, np.int32)
        want, jc = jstep(jparams, jnp.asarray(toks), jnp.asarray(act), jc)
        got = decode.slot_decode_step(cfg, params, _t(toks), _t(act), tc)
        live = act.astype(bool)
        np.testing.assert_allclose(got.numpy()[live],
                                   np.asarray(want)[live], **LOGIT_TOL,
                                   err_msg=f"step {i}")
        assert tc[0].lengths.tolist() == np.asarray(jc[0].lengths).tolist()
    for layer in range(cfg.num_layers):
        for slot, n in enumerate(tc[0].lengths.tolist()):
            np.testing.assert_allclose(tc[layer].k.numpy()[slot, :n],
                                       np.asarray(jc[layer].k)[slot, :n],
                                       **OP_TOL)
    decode.reset_slot(tc, 1)
    assert tc[0].lengths.tolist() == [14, 0, 0]
    with pytest.raises(ValueError, match="max_seq_len"):
        decode.init_slot_caches(cfg, 1, cfg.max_seq_len + 1, device="cpu")


# --------------------------------------------------------- paged verify


def _paged_setup(cfg, S=3, T=4, P=8):
    N = S * P + 1
    tables = (1 + np.arange(S * P, dtype=np.int32)).reshape(S, P)
    rope = None
    if cfg.pos == "rope":
        rope = rotary.rope_frequencies(cfg.head_dim, cfg.max_seq_len,
                                       cfg.rope_theta)
    return N, T, P, tables, rope


def _prefilled(cfg, params, lens, tables, N, T, P, rope):
    """Port paged caches with slot s prefilled with lens[s] tokens."""
    tc = decode.init_paged_caches(cfg, len(lens), N, T, P, device="cpu")
    for s, n in enumerate(lens):
        if not n:
            continue
        chunk = np.zeros((1, 16), np.int32)
        chunk[0, :n] = _tokens(cfg, 40 + s, n)
        decode.paged_prefill_into_slot(cfg, params, _t(chunk), n, s,
                                       _t(tables[s]), _t(tables[s]), tc,
                                       rope)
    return tc


def test_paged_verify_matches_jax(model_pair):
    """Slots at cursors 5, 11 and 0 score a 5-token window each in one
    ``paged_verify_step``, against JAX's in-place ``attn="reference"``
    lane: logits, the k/v written for all 5 positions, unmoved cursors."""
    jcfg, jparams, cfg, params = model_pair
    lens, K = [5, 11, 0], 5
    N, T, P, tables, rope = _paged_setup(cfg)
    jc = jdecode.init_paged_caches(jcfg, 3, N, T, P)
    jprefill = jax.jit(partial(jdecode.paged_prefill_into_slot, jcfg,
                               attn="reference"))
    for s, n in enumerate(lens):
        chunk = np.zeros((1, 16), np.int32)
        chunk[0, :n] = _tokens(cfg, 40 + s, n)
        if n:
            _, jc = jprefill(jparams, jnp.asarray(chunk), n, s,
                             jnp.asarray(tables[s]), jnp.asarray(tables[s]),
                             jc)
    tc = _prefilled(cfg, params, lens, tables, N, T, P, rope)
    win = _tokens(cfg, 50, (3, K))
    want, jc = jax.jit(partial(jdecode.paged_verify_step, jcfg,
                               attn="reference"))(
        jparams, jnp.asarray(win), jnp.asarray(tables), jnp.asarray(tables),
        jc)
    got = decode.paged_verify_step(cfg, params, _t(win), _t(tables),
                                   _t(tables), tc, rope)
    assert tuple(got.shape) == (3, K, cfg.vocab_size)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LOGIT_TOL)
    assert tc[0].lengths.tolist() == lens
    for layer in range(cfg.num_layers):
        for s, n in enumerate(lens):
            pages = tables[s, :-(-(n + K) // T)]
            np.testing.assert_allclose(tc[layer].k.numpy()[pages],
                                       np.asarray(jc[layer].k)[pages],
                                       **OP_TOL)


def test_paged_verify_equals_sequential_steps(model_pair):
    """Row j of a verify window is what ``paged_decode_step`` gives after
    the window's first j tokens: one verify call against K 1-token steps on
    a copy of the same caches."""
    _, _, cfg, params = model_pair
    lens, K = [5, 11, 0], 5
    N, T, P, tables, rope = _paged_setup(cfg)
    tc = _prefilled(cfg, params, lens, tables, N, T, P, rope)
    seq = copy.deepcopy(tc)
    seq = [decode.PagedKVCache(k=c.k, v=c.v, lengths=seq[0].lengths)
           for c in seq]
    win = _tokens(cfg, 51, (3, K))
    got = decode.paged_verify_step(cfg, params, _t(win), _t(tables),
                                   _t(tables), tc, rope)
    ones = torch.ones(3, dtype=torch.int32)
    for j in range(K):
        want = decode.paged_decode_step(cfg, params, _t(win[:, j]), ones,
                                        _t(tables), _t(tables), seq, rope)
        np.testing.assert_allclose(got[:, j].numpy(), want.numpy(),
                                   **OP_TOL, err_msg=f"row {j}")


def test_paged_rewind_slots():
    """Every layer shares one cursor tensor: one rewind sets them all; no
    page content changes."""
    cfg = presets.llama_debug()
    caches = decode.init_paged_caches(cfg, 3, 9, 4, 2, device="cpu")
    caches[0].k.fill_(1.0)
    decode.paged_rewind_slots(caches, np.asarray([7, 0, 3]))
    for c in caches:
        assert c.lengths.tolist() == [7, 0, 3]
    assert bool((caches[0].k == 1.0).all())
