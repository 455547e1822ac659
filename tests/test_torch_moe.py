"""The port's mixture-of-experts layer (``ray_tpu_torch.ops.moe``) and the
``moe_debug`` model on the CPU against the JAX package, on the same inputs
made with numpy and the same weights converted from a JAX init.

Float32 throughout. The layer holds to 1e-5 (ops) and the paged serving
programs' logits to 1e-4, as in ``test_torch_model.py``; losses, grads and
the 5-step trajectory hold to the tolerances of ``test_torch_train.py``.
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models import decode as jdecode
from ray_tpu.models import presets as jpresets
from ray_tpu.models import training as jtraining
from ray_tpu.models import transformer as jtransformer
from ray_tpu.ops import moe as jmoe
from ray_tpu_torch._private import convert
from ray_tpu_torch.models import decode, presets, training, transformer
from ray_tpu_torch.ops import moe, rotary

OP_TOL = dict(atol=1e-5, rtol=1e-5)
LOGIT_TOL = dict(atol=1e-4, rtol=0)
LOSS_TOL = dict(atol=2e-5, rtol=1e-4)
STATE_TOL = dict(atol=1e-6, rtol=1e-4)
# params after five Adam steps at learning rate 1e-2: an element whose
# second moment is near zero (an embedding row seen once) turns a last-digit
# grad difference into a visible update difference, so the params hold to
# 1e-3 of one step's size (1e-5) instead of 1e-6
PARAM_TOL = dict(atol=1e-5, rtol=1e-4)
E, K = 4, 2


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _layer_inputs(seed, B=2, S=8, d=16, f=32):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, S, d)).astype(np.float32)
    shapes = dict(w_router=(d, E), w_gate=(E, d, f), w_up=(E, d, f),
                  w_down=(E, f, d))
    p = {k: (rng.standard_normal(s) * 0.3).astype(np.float32)
         for k, s in shapes.items()}
    return x, p


def _both(x, p, cf):
    want_y, want_aux = jmoe.moe_layer(
        jax.tree.map(jnp.asarray, p), jnp.asarray(x), num_experts=E,
        top_k=K, capacity_factor=cf, dtype=jnp.float32)
    got_y, got_aux = moe.moe_layer(
        {k: _t(v) for k, v in p.items()}, _t(x), num_experts=E, top_k=K,
        capacity_factor=cf, dtype=torch.float32)
    return (np.asarray(want_y), float(want_aux)), (got_y.numpy(),
                                                   float(got_aux))


def _dropped(x, p, cf):
    """(token, choice) rows past their expert's capacity, counted in numpy
    the JAX way: token-major order over the top-k choices."""
    xt = x.reshape(-1, x.shape[-1])
    logits = xt @ p["w_router"]
    idx = np.argsort(-logits, axis=-1, kind="stable")[:, :K].reshape(-1)
    cap = max(1, int(np.ceil(xt.shape[0] * K / E * cf)))
    seen = np.zeros(E, int)
    dropped = 0
    for e in idx:
        dropped += seen[e] >= cap
        seen[e] += 1
    return dropped


@pytest.mark.parametrize("cf", [2.0, 0.5], ids=["in_capacity", "overflow"])
def test_moe_layer_matches_jax(cf):
    """Output and aux loss against ``moe_layer``. At capacity factor 2 a
    bucket holds every token, so nothing can overflow; at 0.5 rows
    overflow and are dropped (checked to happen)."""
    x, p = _layer_inputs(0)
    (want_y, want_aux), (got_y, got_aux) = _both(x, p, cf)
    np.testing.assert_allclose(got_y, want_y, **OP_TOL)
    np.testing.assert_allclose(got_aux, want_aux, **OP_TOL)
    assert (_dropped(x, p, cf) > 0) == (cf < 1)


def test_tied_router_rows_pick_the_lower_expert_first():
    """Router rows with exact ties: experts 1, 2 and 3 share one column,
    so the top-2 of every token whose best expert is among them is a tie.
    ``jax.lax.top_k`` takes the lower index first; so must the port, at
    the same capacity (0.5, so the tie decides which rows overflow)."""
    x, p = _layer_inputs(1)
    p["w_router"][:, 2] = p["w_router"][:, 1]
    p["w_router"][:, 3] = p["w_router"][:, 1]
    probs = torch.softmax(_t(x.reshape(-1, 16) @ p["w_router"]), -1)
    vals, idx = moe._top_k(probs, K)
    _, jidx = jax.lax.top_k(jnp.asarray(probs.numpy()), K)
    assert idx.tolist() == np.asarray(jidx).tolist()
    tied = (idx[:, 0] == 1) & (idx[:, 1] == 2)
    assert bool(tied.any())
    (want_y, want_aux), (got_y, got_aux) = _both(x, p, 0.5)
    np.testing.assert_allclose(got_y, want_y, **OP_TOL)
    np.testing.assert_allclose(got_aux, want_aux, **OP_TOL)


@pytest.mark.parametrize("cf", [2.0, 0.5], ids=["in_capacity", "overflow"])
def test_moe_layer_grads_match_jax(cf):
    """Grads of sum(y * w) + aux with respect to x and every weight,
    against ``jax.grad``."""
    x, p = _layer_inputs(2)
    w = np.random.default_rng(3).standard_normal(x.shape).astype(np.float32)

    def jloss(xx, pp):
        y, aux = jmoe.moe_layer(pp, xx, num_experts=E, top_k=K,
                                capacity_factor=cf, dtype=jnp.float32)
        return jnp.sum(y * w) + aux

    want_x, want_p = jax.grad(jloss, argnums=(0, 1))(
        jnp.asarray(x), jax.tree.map(jnp.asarray, p))
    tx = _t(x).requires_grad_(True)
    tp = {k: _t(v).requires_grad_(True) for k, v in p.items()}
    y, aux = moe.moe_layer(tp, tx, num_experts=E, top_k=K,
                           capacity_factor=cf, dtype=torch.float32)
    (y * _t(w)).sum().add(aux).backward()
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(want_x), **OP_TOL)
    for k in p:
        np.testing.assert_allclose(tp[k].grad.numpy(),
                                   np.asarray(want_p[k]), **OP_TOL,
                                   err_msg=k)


# ------------------------------------------------------------ moe_debug


@pytest.fixture(scope="module")
def jax_moe():
    jcfg = jpresets.moe_debug(ce_chunk=8)
    jparams = jax.jit(partial(jtransformer.init_params, jcfg))(
        jax.random.PRNGKey(0))
    return jcfg, _np(jparams)


def _batch(cfg, seed, B=2, S=12):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    mask = np.ones((B, S), np.float32)
    mask[1, -4:] = 0.0
    return {"tokens": tokens, "mask": mask}


def test_init_params_builds_the_moe_block():
    cfg = presets.moe_debug()
    params = transformer.init_params(cfg, seed=0, device="cpu",
                                     param_dtype=torch.float32)
    mlp = params["blocks"][0]["mlp"]
    d, f = cfg.embed_dim, cfg.hidden_dim
    assert {k: tuple(v.shape) for k, v in mlp.items()} == {
        "w_router": (d, E), "w_gate": (E, d, f), "w_up": (E, d, f),
        "w_down": (E, f, d)}
    with pytest.raises(ValueError, match="moe_num_experts"):
        transformer.init_params(presets.moe_debug(moe_num_experts=1),
                                device="cpu")


@pytest.mark.parametrize("stacked", [True, False], ids=["stacked",
                                                         "per_layer"])
def test_convert_carries_the_moe_leaves(jax_moe, stacked):
    """Scan-stacked [L, E, d, f] leaves and per-layer ones, both ways bit
    for bit; ``place_params`` puts the MoE weights in ``cfg.dtype``."""
    _, tree = jax_moe
    if not stacked:
        tree = dict(tree, blocks={
            str(i): jax.tree.map(lambda a, i=i: a[i], tree["blocks"])
            for i in range(2)})
    params = convert.from_jax(tree)
    assert tuple(params["blocks"][1]["mlp"]["w_down"].shape) == (E, 128, 64)
    np.testing.assert_array_equal(
        params["blocks"][1]["mlp"]["w_gate"].numpy(),
        np.asarray(jax_moe[1]["blocks"]["mlp"]["w_gate"])[1])
    back = convert.to_jax(params, stacked=stacked)
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
        assert np.array_equal(a, b)
    placed = transformer.place_params(presets.moe_debug(
        dtype=torch.bfloat16), params, torch.device("cpu"))
    assert {t.dtype for t in placed["blocks"][0]["mlp"].values()} == {
        torch.bfloat16}
    assert placed["blocks"][0]["ln2"]["scale"].dtype == torch.float32


# (remat, remat_policy, fused_ce)
VARIANTS = {
    "remat_off": (False, "full", True),
    "remat_full": (True, "full", True),
    "remat_dots": (True, "dots", True),
    "unfused_ce": (False, "full", False),
}


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_moe_debug_loss_and_grads_match_jax(jax_moe, variant):
    """``loss_fn`` of moe_debug (cross-entropy + 0.01 x the routing loss
    summed over the layers): value, ``moe_aux`` and every param's grad
    against ``jax.value_and_grad``, under each remat policy."""
    _, jparams = jax_moe
    remat, policy, fused = VARIANTS[variant]
    cfg = presets.moe_debug(remat=remat, remat_policy=policy,
                            fused_ce=fused, ce_chunk=8)
    jcfg = jpresets.moe_debug(fused_ce=fused, ce_chunk=8)
    batch = _batch(cfg, 3)
    (want, wm), want_g = jax.value_and_grad(
        lambda p: jtransformer.loss_fn(jcfg, p, jax.tree.map(jnp.asarray,
                                                             batch)),
        has_aux=True)(jax.tree.map(jnp.asarray, jparams))
    params = transformer.map_params(lambda _p, t: t.requires_grad_(True),
                                    convert.from_jax(jparams))
    got, metrics = transformer.loss_fn(
        cfg, params, {k: _t(v) for k, v in batch.items()})
    grads = torch.autograd.grad(got, transformer._leaves(params))
    np.testing.assert_allclose(got.item(), float(want), **LOSS_TOL)
    np.testing.assert_allclose(metrics["loss"].item(), float(wm["loss"]),
                               **LOSS_TOL)
    np.testing.assert_allclose(metrics["moe_aux"].item(),
                               float(wm["moe_aux"]), **OP_TOL)
    assert metrics["moe_aux"].item() > 0
    want_tree = convert.from_jax(_np(want_g))
    for g, w in zip(grads, transformer._leaves(want_tree)):
        np.testing.assert_allclose(g.numpy(), w.numpy(), **LOSS_TOL)


def test_moe_debug_five_steps_match_jax(jax_moe):
    """Five ``make_train_step`` steps of moe_debug from the same state on
    the same batches: loss, routing loss and grad norm each step, then the
    Adam moments (``STATE_TOL``) and the params (``PARAM_TOL``)."""
    jcfg = jpresets.moe_debug(ce_chunk=8)
    cfg = presets.moe_debug(ce_chunk=8)
    ocfg = jtraining.OptimizerConfig(learning_rate=1e-2, warmup_steps=2,
                                     decay_steps=6)
    jstate, jtx = jtraining.init_train_state(jcfg, ocfg,
                                             jax.random.PRNGKey(0))
    jstep = jtraining.make_train_step(jcfg, jtx, donate=False)
    state = convert.train_state_from_jax(_np(jstate), device="cpu")
    step = training.make_train_step(cfg, training.make_optimizer(
        training.OptimizerConfig(**ocfg.__dict__)))
    for i in range(5):
        batch = _batch(cfg, 10 + i)
        jstate, jm = jstep(jstate, jax.tree.map(jnp.asarray, batch))
        state, m = step(state, {k: _t(v) for k, v in batch.items()})
        for key in ("loss", "moe_aux", "grad_norm"):
            np.testing.assert_allclose(m[key].item(), float(jm[key]),
                                       rtol=1e-5, err_msg=f"{key}, step {i}")
    want = convert.train_state_from_jax(_np(jstate), device="cpu")
    for tree in ("params", "mu", "nu"):
        got_t = state.params if tree == "params" else getattr(
            state.opt_state, tree)
        want_t = want.params if tree == "params" else getattr(
            want.opt_state, tree)
        for a, b in zip(transformer._leaves(got_t),
                        transformer._leaves(want_t)):
            np.testing.assert_allclose(
                a.detach().numpy(), b.detach().numpy(),
                **(PARAM_TOL if tree == "params" else STATE_TOL),
                err_msg=tree)


def test_moe_paged_prefill_then_decode_match_jax(jax_moe):
    """moe_debug through the paged programs: a prefill chunk into slot 0,
    then decode steps over both slots, against JAX's in-place
    ``attn="reference"`` lane (whose MoE capacity is pooled over every row
    of the call, inactive slots included, as the port's is)."""
    jcfg = jpresets.moe_debug()
    _, tree = jax_moe
    jparams = jax.tree.map(jnp.asarray, tree)
    cfg = presets.moe_debug()
    params = transformer.place_params(cfg, convert.from_jax(tree),
                                      torch.device("cpu"))
    S, T, P, C, real = 2, 4, 8, 8, 6
    N = S * P + 1
    tables = (1 + np.arange(S * P, dtype=np.int32)).reshape(S, P)
    jc = jdecode.init_paged_caches(jcfg, S, N, T, P)
    tc = decode.init_paged_caches(cfg, S, N, T, P, device="cpu")
    rope = rotary.rope_frequencies(cfg.head_dim, cfg.max_seq_len,
                                   cfg.rope_theta)
    rng = np.random.default_rng(3)
    prompt = np.zeros((1, C), np.int32)
    prompt[0, :real] = rng.integers(1, cfg.vocab_size, real)
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


def test_moe_debug_server_texts_match_jax(jax_moe):
    """moe_debug served end to end, the port's ``LLMServerImpl`` against
    the JAX package's on its in-place ``attn="reference"`` lane, the same
    weights: identical texts at temperature 0 and for one sampled
    request."""
    import asyncio

    from ray_tpu.serve.llm import LLMServerImpl as JaxLLMServerImpl
    from ray_tpu_torch import LLMServerImpl

    _, tree = jax_moe
    reqs = [{"prompt": p} for p in ("hi", "hello 123", "hello 1234")] + [
        {"prompt": "hello sampled", "temperature": 0.8}]
    kw = dict(preset="moe_debug", max_new_tokens=6, slots=4,
              prefill_chunk=8, page_tokens=4)

    def drive(srv):
        async def go():
            return await asyncio.gather(*[srv(r) for r in reqs])

        try:
            return [o["text"] for o in asyncio.run(go())]
        finally:
            srv.shutdown()

    want = drive(JaxLLMServerImpl(
        share_weights=False, attn="reference",
        params_loader=lambda cfg: jax.tree.map(jnp.asarray, tree), **kw))
    got = drive(LLMServerImpl(
        device="cpu", params_loader=lambda cfg: convert.from_jax(tree), **kw))
    assert got == want
