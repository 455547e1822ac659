"""The port's training path on the CPU (``ray_tpu_torch.ops.losses``,
``models.transformer.forward``/``loss_fn``, ``models.training``,
``_private.convert``'s train state) against the JAX package, on the same
weights and batches made with numpy.

Tolerances, float32 throughout (the compute dtype of llama_debug and of the
tiny GPT-2 here), but for the fused CE's bf16 cases:
  * cross entropy, value and grads: atol = rtol = 1e-5. The same float32
    arithmetic; the sums run in another order. With bf16 operands the value
    holds to the same (the logits are the products' float32 sums on both
    sides); the grads to one bf16 step (2^-7) of the largest grad, as the
    backward's products take the cotangent in bf16.
  * loss_fn value and grads of a two-layer model: atol 2e-5, rtol 1e-4.
    Two layers of matmuls whose float32 sums run in another order in XLA
    and in PyTorch; the grads of the smallest weights are the least exact.
  * five training steps: losses and grad norms to rtol 1e-5, params and
    Adam moments to atol 1e-6 + rtol 1e-4 (an Adam step divides by
    sqrt(nu), which brings the grads' rounding up to the step's size).
    The first step's params are compared bit for bit: its rate is 0.
  * the train state through ``convert`` and back: bit for bit.
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ray_tpu.models import presets as jpresets
from ray_tpu.models import training as jtraining
from ray_tpu.models import transformer as jtransformer
from ray_tpu.ops import losses as jlosses
from ray_tpu_torch._private import convert
from ray_tpu_torch.models import presets, training, transformer
from ray_tpu_torch.ops import losses

CE_TOL = dict(atol=1e-5, rtol=1e-5)
LOSS_TOL = dict(atol=2e-5, rtol=1e-4)
STATE_TOL = dict(atol=1e-6, rtol=1e-4)


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


# ------------------------------------------------------------------- losses


@pytest.mark.parametrize("masked", [False, True], ids=["nomask", "mask"])
def test_softmax_cross_entropy_matches_jax(masked):
    rng = np.random.default_rng(0)
    logits = rng.standard_normal((3, 7, 50)).astype(np.float32) * 4
    labels = rng.integers(0, 50, (3, 7)).astype(np.int32)
    mask = (rng.random((3, 7)) > 0.3).astype(np.float32) if masked else None

    def jloss(x):
        return jlosses.softmax_cross_entropy(
            x, jnp.asarray(labels), None if mask is None else
            jnp.asarray(mask), z_loss=1e-3)

    (want, want_n), want_g = jax.value_and_grad(jloss, has_aux=True)(
        jnp.asarray(logits))
    x = _t(logits).requires_grad_(True)
    got, n = losses.softmax_cross_entropy(
        x, _t(labels), None if mask is None else _t(mask), z_loss=1e-3)
    (g,) = torch.autograd.grad(got, (x,))
    np.testing.assert_allclose(got.item(), float(want), **CE_TOL)
    assert n.item() == float(want_n)
    np.testing.assert_allclose(g.numpy(), np.asarray(want_g), **CE_TOL)


@pytest.mark.parametrize("tied,dtype", [
    (True, "float32"), (False, "float32"),
    (True, "bfloat16"), (False, "bfloat16")],
    ids=["tied", "untied", "tied-bf16", "untied-bf16"])
def test_fused_cross_entropy_matches_jax(tied, dtype):
    """Vocab 200 (padded to 256 with -1e30 columns), 2 x 13 = 26 tokens in
    chunks of 8 (padded to 32 with mask 0), z-loss and a mask; the value and
    the grads of hidden and table. In bf16, the card's compute dtype, each
    chunk's logits are the product's float32 sum, as JAX's
    ``preferred_element_type`` keeps them, so the value still matches to
    CE_TOL (logits rounded to bf16 miss by ~3e-4); the grads' products take
    the cotangent in bf16, so they match to one bf16 step of the largest
    grad."""
    rng = np.random.default_rng(1)
    V, D = 200, 16
    hidden = rng.standard_normal((2, 13, D)).astype(np.float32)
    table = (rng.standard_normal((V, D) if tied else (D, V)) * 0.3).astype(
        np.float32)
    labels = rng.integers(0, V, (2, 13)).astype(np.int32)
    mask = (rng.random((2, 13)) > 0.2).astype(np.float32)
    kw = dict(z_loss=1e-4, chunk=8, transpose_table=not tied)

    def jloss(h, w):
        return jlosses.fused_softmax_cross_entropy(
            h, w, jnp.asarray(labels), jnp.asarray(mask),
            compute_dtype=getattr(jnp, dtype), **kw)

    (want, want_n), want_g = jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True)(jnp.asarray(hidden),
                                             jnp.asarray(table))
    h, w = _t(hidden).requires_grad_(True), _t(table).requires_grad_(True)
    got, n = losses.fused_softmax_cross_entropy(
        h, w, _t(labels), _t(mask), compute_dtype=getattr(torch, dtype),
        **kw)
    grads = torch.autograd.grad(got, (h, w))
    np.testing.assert_allclose(got.item(), float(want), **CE_TOL)
    assert n.item() == float(want_n)
    for g, wg in zip(grads, want_g):
        wg = np.asarray(wg, np.float32)
        assert g.dtype == torch.float32
        tol = (CE_TOL if dtype == "float32" else
               dict(rtol=0, atol=2.0 ** -7 * np.abs(wg).max()))
        np.testing.assert_allclose(g.numpy(), wg, **tol)


# ------------------------------------------------------------------ models


def _gpt2_tiny(mod, dtype, **kw):
    return mod.gpt2_small(vocab_size=96, num_layers=2, embed_dim=32,
                          num_heads=4, max_seq_len=64, dtype=dtype, **kw)


MODELS = {
    "llama_debug": (lambda **kw: jpresets.llama_debug(**kw),
                    lambda **kw: presets.llama_debug(**kw)),
    "gpt2_tiny": (lambda **kw: _gpt2_tiny(jpresets, jnp.float32,
                                          scan_layers=False, **kw),
                  lambda **kw: _gpt2_tiny(presets, torch.float32, **kw)),
}


@pytest.fixture(scope="module", params=sorted(MODELS))
def model(request):
    jcfg_fn, cfg_fn = MODELS[request.param]
    jcfg = jcfg_fn(ce_chunk=8)
    jparams = jax.jit(partial(jtransformer.init_params, jcfg))(
        jax.random.PRNGKey(0))
    return request.param, jcfg, _np(jparams)


def _batch(cfg, seed, B=2, S=12):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    mask = np.ones((B, S), np.float32)
    mask[1, -4:] = 0.0
    return {"tokens": tokens, "mask": mask}


def _port_params(jparams):
    return transformer.map_params(
        lambda _p, t: t.requires_grad_(True), convert.from_jax(jparams))


def test_forward_logits_match_jax(model):
    name, jcfg, jparams = model
    cfg = MODELS[name][1]()
    tokens = _batch(cfg, 2)["tokens"]
    want = jtransformer.forward(jcfg, jparams, jnp.asarray(tokens))
    got = transformer.forward(cfg, convert.from_jax(jparams), _t(tokens))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LOSS_TOL)


# (remat, remat_policy, attn_impl, fused_ce)
VARIANTS = {
    "remat_off": (False, "full", "flash", True),
    "remat_full": (True, "full", "flash", True),
    "remat_dots": (True, "dots", "flash", True),
    "reference_attn": (True, "full", "reference", True),
    "unfused_ce": (False, "full", "auto", False),
}


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_loss_and_grads_match_jax(model, variant):
    """loss_fn's value, token count and every param's grad against
    ``jax.value_and_grad(loss_fn)``, under each remat policy and both
    attention paths (the flash op runs the kernels' plain versions)."""
    name, jcfg, jparams = model
    remat, policy, impl, fused = VARIANTS[variant]
    cfg = MODELS[name][1](remat=remat, remat_policy=policy, attn_impl=impl,
                          fused_ce=fused, ce_chunk=8)
    jcfg = MODELS[name][0](fused_ce=fused, ce_chunk=8)
    batch = _batch(cfg, 3)
    (want, wm), want_g = jax.value_and_grad(
        lambda p: jtransformer.loss_fn(jcfg, p, jax.tree.map(jnp.asarray,
                                                             batch)),
        has_aux=True)(jax.tree.map(jnp.asarray, jparams))
    params = _port_params(jparams)
    got, metrics = transformer.loss_fn(
        cfg, params, {k: _t(v) for k, v in batch.items()})
    leaves = transformer._leaves(params)
    grads = torch.autograd.grad(got, leaves)
    np.testing.assert_allclose(got.item(), float(want), **LOSS_TOL)
    assert metrics["tokens"].item() == float(wm["tokens"])
    want_tree = convert.from_jax(_np(want_g))
    for g, w in zip(grads, transformer._leaves(want_tree)):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), w.numpy(), **LOSS_TOL)


def test_count_params_matches_jax(model):
    _, _, jparams = model
    assert transformer.count_params(convert.from_jax(jparams)) == \
        jtransformer.count_params(jparams)


def test_unknown_remat_policy_is_rejected():
    cfg = presets.llama_debug(remat_policy="some")
    params = transformer.init_params(cfg, device="cpu",
                                     param_dtype=torch.float32)
    with pytest.raises(ValueError, match="remat_policy"):
        transformer.forward(cfg, params, torch.zeros((1, 4), dtype=torch.long))


# ---------------------------------------------------------------- training


def test_schedule_matches_optax():
    ocfg = training.OptimizerConfig(learning_rate=1e-3, warmup_steps=3,
                                    decay_steps=9, min_lr_ratio=0.1)
    want = optax.warmup_cosine_decay_schedule(
        init_value=0.0, peak_value=1e-3, warmup_steps=3, decay_steps=9,
        end_value=1e-4)
    tx = training.make_optimizer(ocfg)
    for count in range(14):
        np.testing.assert_allclose(tx.schedule(count), float(want(count)),
                                   rtol=1e-6, atol=0)


@pytest.mark.parametrize("clip", [100.0, 0.05], ids=["no_clip", "clip"])
def test_five_steps_match_jax_make_train_step(model, clip):
    """Five steps of ``make_train_step`` from the same state on the same
    batches: losses, token counts and grad norms each step, then the params,
    Adam moments and counts. With clip 0.05 every step clips; with 100 none
    does. Step 1's rate is schedule(0) = 0: the params do not move."""
    name, jcfg, jparams = model
    cfg = MODELS[name][1](ce_chunk=8)
    ocfg = jtraining.OptimizerConfig(learning_rate=1e-2, warmup_steps=2,
                                     decay_steps=6, grad_clip=clip)
    jstate, jtx = jtraining.init_train_state(jcfg, ocfg,
                                             jax.random.PRNGKey(0))
    jstep = jtraining.make_train_step(jcfg, jtx, donate=False)
    state = convert.train_state_from_jax(_np(jstate), device="cpu")
    tx = training.make_optimizer(training.OptimizerConfig(
        **ocfg.__dict__))
    step = training.make_train_step(cfg, tx)
    first = [t.detach().clone() for t in transformer._leaves(state.params)]
    for i in range(5):
        batch = _batch(cfg, 10 + i)
        jstate, jm = jstep(jstate, jax.tree.map(jnp.asarray, batch))
        state, m = step(state, {k: _t(v) for k, v in batch.items()})
        np.testing.assert_allclose(m["loss"].item(), float(jm["loss"]),
                                   rtol=1e-5, err_msg=f"loss, step {i}")
        np.testing.assert_allclose(m["grad_norm"].item(),
                                   float(jm["grad_norm"]), rtol=1e-5,
                                   err_msg=f"grad_norm, step {i}")
        assert m["tokens"].item() == float(jm["tokens"])
        if i == 0:
            for a, b in zip(first, transformer._leaves(state.params)):
                assert torch.equal(a, b.detach())
        if clip < 1:
            assert float(jm["grad_norm"]) > clip
    assert state.step == int(jstate.step) == 5
    want = convert.train_state_from_jax(_np(jstate), device="cpu")
    assert state.opt_state.count == want.opt_state.count == 5
    for tree in ("params", "mu", "nu"):
        got_t = state.params if tree == "params" else getattr(
            state.opt_state, tree)
        want_t = want.params if tree == "params" else getattr(
            want.opt_state, tree)
        for a, b in zip(transformer._leaves(got_t),
                        transformer._leaves(want_t)):
            np.testing.assert_allclose(a.detach().numpy(),
                                       b.detach().numpy(), **STATE_TOL,
                                       err_msg=tree)


def test_train_state_round_trip_and_resume(model):
    """JAX state after two steps -> the port -> JAX: every leaf, both optax
    counts and the step, bit for bit; then the third step from the carried
    state gives the same loss and params on both sides."""
    name, jcfg, _ = model
    cfg = MODELS[name][1](ce_chunk=8)
    ocfg = jtraining.OptimizerConfig(learning_rate=1e-2, warmup_steps=1,
                                     decay_steps=5)
    jstate, jtx = jtraining.init_train_state(jcfg, ocfg,
                                             jax.random.PRNGKey(1))
    jstep = jtraining.make_train_step(jcfg, jtx, donate=False)
    for i in range(2):
        jstate, _ = jstep(jstate, jax.tree.map(jnp.asarray, _batch(cfg, i)))
    tree = _np(jstate)
    state = convert.train_state_from_jax(tree, device="cpu")
    assert state.step == 2 and state.opt_state.count == 2
    back = convert.train_state_to_jax(state, like=tree)
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
        assert a.dtype == b.dtype and np.array_equal(a, b)

    batch = _batch(cfg, 7)
    jstate, jm = jstep(jax.tree.map(jnp.asarray, back),
                       jax.tree.map(jnp.asarray, batch))
    step = training.make_train_step(cfg, training.make_optimizer(
        training.OptimizerConfig(**ocfg.__dict__)))
    state, m = step(state, {k: _t(v) for k, v in batch.items()})
    np.testing.assert_allclose(m["loss"].item(), float(jm["loss"]),
                               rtol=1e-5)
    got = convert.train_state_to_jax(state, like=tree)
    for a, b in zip(jax.tree.leaves(got.params),
                    jax.tree.leaves(_np(jstate.params))):
        np.testing.assert_allclose(a, b, **STATE_TOL)


def test_init_train_state_keeps_float32_leaves():
    cfg = presets.llama_debug(dtype=torch.bfloat16)
    state, tx = training.init_train_state(cfg, training.OptimizerConfig(),
                                          seed=0, device="cpu")
    leaves = transformer._leaves(state.params)
    assert all(t.dtype == torch.float32 and t.requires_grad for t in leaves)
    assert state.step == 0 and state.opt_state.count == 0
    assert all(not t.any() for t in transformer._leaves(state.opt_state.mu))
    # the same seed gives the served params, cast once to bf16
    served = transformer.init_params(cfg, seed=0, device="cpu")
    for a, b in zip(leaves, transformer._leaves(served)):
        assert torch.equal(a.detach().to(b.dtype), b)
    # bf16 compute over float32 params: float32 grads
    _, metrics = training.make_train_step(cfg, tx)(
        state, {"tokens": torch.randint(0, cfg.vocab_size, (2, 9))})
    assert torch.isfinite(metrics["loss"]) and metrics["loss"].dtype == \
        torch.float32


def test_entry_points_resolve_the_card_by_default():
    """With no device named, the entry points ask for the card and raise
    here, where there is none; they never carry on on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    cfg = presets.llama_debug()
    for call in (lambda: training.init_train_state(
                     cfg, training.OptimizerConfig()),
                 lambda: transformer.init_params(cfg)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
