"""The port's model layers (``ray_tpu_torch.ops``, ``.models``, ``.convert``)
on the CPU against the JAX package, on the same inputs made with numpy.

Float32 throughout. Layer ops hold to 1e-5: each side does the same float32
arithmetic, and only the order of a few sums differs. The paged programs'
logits hold to 1e-4: they run two layers of matmuls whose float32 sums run
in a different order in XLA and in PyTorch, and the differences add up
through the residual stream.
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models import decode as jdecode
from ray_tpu.models import presets as jpresets
from ray_tpu.models import transformer as jtransformer
from ray_tpu.ops import norms as jnorms
from ray_tpu.ops import rotary as jrotary
from ray_tpu_torch._private import convert
from ray_tpu_torch.models import decode, presets
from ray_tpu_torch.models import transformer
from ray_tpu_torch.ops import norms, rotary

OP_TOL = dict(atol=1e-5, rtol=1e-5)
LOGIT_TOL = dict(atol=1e-4, rtol=0)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def test_rms_and_layer_norm_match_jax():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 5, 16)).astype(np.float32) * 3
    w = rng.standard_normal(16).astype(np.float32)
    b = rng.standard_normal(16).astype(np.float32)
    np.testing.assert_allclose(
        norms.rms_norm(_t(x), _t(w), 1e-5).numpy(),
        np.asarray(jnorms.rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-5)),
        **OP_TOL)
    np.testing.assert_allclose(
        norms.layer_norm(_t(x), _t(w), _t(b)).numpy(),
        np.asarray(jnorms.layer_norm(jnp.asarray(x), jnp.asarray(w),
                                     jnp.asarray(b))), **OP_TOL)


def test_rotary_matches_jax_with_positions():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 3, 4, 16)).astype(np.float32)
    pos = np.array([[0, 7, 63], [5, 6, 120]], np.int32)
    cos, sin = rotary.rope_frequencies(16, 128, 500000.0)
    jcos, jsin = jrotary.rope_frequencies(16, 128, 500000.0)
    np.testing.assert_allclose(cos.numpy(), np.asarray(jcos), **OP_TOL)
    np.testing.assert_allclose(sin.numpy(), np.asarray(jsin), **OP_TOL)
    got = rotary.apply_rotary(_t(x), cos, sin, _t(pos).long())
    want = jrotary.apply_rotary(jnp.asarray(x), jcos, jsin, jnp.asarray(pos))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **OP_TOL)


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
    jcfg_fn, cfg_fn = CONFIGS[request.param]
    jcfg, cfg = jcfg_fn(), cfg_fn()
    jparams = jax.jit(partial(jtransformer.init_params, jcfg))(
        jax.random.PRNGKey(0))
    params = transformer.place_params(cfg, convert.from_jax(_np(jparams)),
                                      torch.device("cpu"))
    return jcfg, jparams, cfg, params


def test_mlp_matches_jax(model_pair):
    """swiglu (llama_debug) and tanh-gelu with biases (gpt2_tiny)."""
    jcfg, jparams, cfg, params = model_pair
    x = np.random.default_rng(2).standard_normal(
        (2, 3, cfg.embed_dim)).astype(np.float32)
    jblock = jdecode._layer_params(jcfg, jparams, 1)
    want, _ = jtransformer._mlp(jcfg, jblock["mlp"], jnp.asarray(x))
    got, aux = transformer._mlp(cfg, params["blocks"][1]["mlp"], _t(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **OP_TOL)
    assert aux == 0.0  # only the MoE layer has a routing loss


def test_convert_round_trip(model_pair):
    """Both JAX layouts: llama_debug's blocks are scan-stacked, gpt2_tiny's
    are per-layer "0".."L-1"."""
    jcfg, jparams, cfg, _ = model_pair
    tree = _np(jparams)
    params = convert.from_jax(tree)
    assert len(params["blocks"]) == jcfg.num_layers
    assert tuple(params["blocks"][0]["attn"]["wq"].shape) == (
        cfg.embed_dim, cfg.num_heads, cfg.head_dim)
    back = convert.to_jax(params, stacked=jcfg.scan_layers)
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
        assert a.dtype == b.dtype and np.array_equal(a, b)


def test_place_params_keeps_norms_f32():
    cfg = presets.llama_debug(dtype=torch.bfloat16)
    params = transformer.init_params(cfg, seed=0, device="cpu")
    assert params["blocks"][0]["attn"]["wq"].dtype == torch.bfloat16
    assert params["blocks"][0]["ln1"]["scale"].dtype == torch.float32
    placed = transformer.place_params(cfg, convert.from_jax(
        convert.to_jax(params)), torch.device("cpu"))
    assert placed["lm_head"]["kernel"].dtype == torch.bfloat16
    assert placed["final_norm"]["scale"].dtype == torch.float32


def test_paged_prefill_then_decode_matches_jax(model_pair):
    """One in-place prefill chunk into slot 0, then three decode steps over
    both slots (slot 1 inactive on the first), logits against JAX's
    paged_prefill_into_slot / paged_decode_step(attn="reference") on the
    same converted params."""
    jcfg, jparams, cfg, params = model_pair
    S, T, P, C, real = 2, 4, 8, 8, 6
    N = S * P + 1
    tables = (1 + np.arange(S * P, dtype=np.int32)).reshape(S, P)
    jc = jdecode.init_paged_caches(jcfg, S, N, T, P)
    tc = decode.init_paged_caches(cfg, S, N, T, P, device="cpu")
    rope = None
    if cfg.pos == "rope":
        rope = rotary.rope_frequencies(cfg.head_dim, cfg.max_seq_len,
                                       cfg.rope_theta)
    rng = np.random.default_rng(3)
    prompt = np.zeros((1, C), np.int32)
    prompt[0, :real] = rng.integers(1, cfg.vocab_size, real)

    # jitted as the JAX scheduler runs them
    jprefill = jax.jit(partial(jdecode.paged_prefill_into_slot, jcfg,
                               attn="reference"))
    jstep = jax.jit(partial(jdecode.paged_decode_step, jcfg,
                            attn="reference"))
    want, jc = jprefill(jparams, jnp.asarray(prompt), real, 0,
                        jnp.asarray(tables[0]), jnp.asarray(tables[0]), jc)
    got = decode.paged_prefill_into_slot(
        cfg, params, _t(prompt), real, 0, _t(tables[0]), _t(tables[0]), tc,
        rope)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LOGIT_TOL)
    assert tc[0].lengths.tolist() == [real, 0]

    for step, active in enumerate(([1, 0], [1, 1], [1, 1])):
        toks = rng.integers(1, cfg.vocab_size, S).astype(np.int32)
        act = np.asarray(active, np.int32)
        want, jc = jstep(jparams, jnp.asarray(toks), jnp.asarray(act),
                         jnp.asarray(tables), jnp.asarray(tables), jc)
        got = decode.paged_decode_step(cfg, params, _t(toks), _t(act),
                                       _t(tables), _t(tables), tc, rope)
        live = act.astype(bool)
        np.testing.assert_allclose(got.numpy()[live],
                                   np.asarray(want)[live], **LOGIT_TOL,
                                   err_msg=f"decode step {step}")
        assert tc[0].lengths.tolist() == np.asarray(jc[0].lengths).tolist()
    for layer in range(cfg.num_layers):
        # every page a live token was written to holds the same k/v
        written = tables[:, :3].ravel()
        np.testing.assert_allclose(tc[layer].k.numpy()[written],
                                   np.asarray(jc[layer].k)[written],
                                   **OP_TOL)
