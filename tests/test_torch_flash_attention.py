"""The port's flash attention (``ray_tpu_torch.ops.flash_attention``) and its
dispatcher (``ray_tpu_torch.ops.attention``) on the CPU, against the JAX
package's flash attention run in interpret mode, as ``tests/test_ops.py``
runs it, on the same inputs made with numpy.

On the CPU the port's wrappers run the kernels' plain versions; the CUDA
kernels themselves are held against those plain versions on the card by
``chip_smoke.py``.

Tolerances, float32 throughout:
  * O, lse and the grads dQ, dK, dV: atol = rtol = 2e-5, as
    ``tests/test_ops.py`` holds the JAX kernel to its reference. Both sides
    do the same float32 arithmetic; the sums run in another order.
  * a ragged length against JAX ``reference_attention`` (the JAX kernel
    only takes lengths its blocks divide): the same 2e-5.
  * bf16 inputs: O to atol 2^-7 + rtol 2^-8 (see that test), lse 2e-5;
    the plain backward's dQ, dK, dV to atol 2^-8 + rtol 2^-7 (see that
    test).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.ops.attention import attention as jattention
from ray_tpu.ops import flash_attention as jflash
from ray_tpu_torch.ops import attention as tattention
from ray_tpu_torch.ops import flash_attention as fa

TOL = dict(atol=2e-5, rtol=2e-5)


def _inputs(b=2, s=128, h=4, hkv=None, d=32, seed=0):
    rng = np.random.default_rng(seed)
    hkv = hkv or h
    q = rng.standard_normal((b, s, h, d)).astype(np.float32)
    k = rng.standard_normal((b, s, hkv, d)).astype(np.float32)
    v = rng.standard_normal((b, s, hkv, d)).astype(np.float32)
    do = rng.standard_normal((b, s, h, d)).astype(np.float32)
    return q, k, v, do


def _t(a):
    return torch.from_numpy(np.array(a))


def _head_major(a):
    return jnp.asarray(a).transpose(0, 2, 1, 3)


HEADS = {"mha": (4, None), "gqa": (8, 2)}


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("heads", sorted(HEADS))
def test_forward_and_lse_match_jax_kernel(causal, heads):
    """O and lse of the port against ``_flash_fwd`` in interpret mode (lse
    [B, H, S] against JAX's [B, H, S, 1])."""
    h, hkv = HEADS[heads]
    q, k, v, _ = _inputs(h=h, hkv=hkv)
    scale = 1.0 / np.sqrt(q.shape[-1])
    jo, jlse = jflash._flash_fwd(_head_major(q), _head_major(k),
                                 _head_major(v), scale, causal, 64, 64, None,
                                 True)
    o, lse = fa.flash_forward(_t(q), _t(k), _t(v), causal=causal)
    np.testing.assert_allclose(o.numpy(), np.asarray(jo).transpose(0, 2, 1, 3),
                               **TOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse)[..., 0], **TOL)
    out = fa.flash_attention(_t(q), _t(k), _t(v), causal=causal)
    assert torch.equal(out, o)


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("heads", sorted(HEADS))
def test_grads_match_jax_vjp(causal, heads):
    """dQ, dK, dV through the port's autograd Function against ``jax.vjp``
    of the JAX custom-VJP op (its dq and dkv kernels in interpret mode)."""
    h, hkv = HEADS[heads]
    q, k, v, do = _inputs(s=64, h=h, hkv=hkv)
    _, vjp = jax.vjp(lambda a, b, c: jflash.flash_attention(
        a, b, c, None, causal, 32, 32), jnp.asarray(q), jnp.asarray(k),
        jnp.asarray(v))
    want = vjp(jnp.asarray(do))
    tq, tk, tv = (_t(a).requires_grad_(True) for a in (q, k, v))
    out = fa.flash_attention(tq, tk, tv, causal=causal)
    got = torch.autograd.grad(out, (tq, tk, tv), _t(do))
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL,
                                   err_msg=name)


def test_ragged_length_matches_jax_reference():
    """S = 100 (no power-of-two tile divides it) with GQA: forward and
    grads against JAX ``reference_attention`` and its autograd."""
    q, k, v, do = _inputs(b=1, s=100, h=6, hkv=2, d=16, seed=3)
    want_o, vjp = jax.vjp(lambda a, b, c: jflash.reference_attention(
        a, b, c, causal=True), jnp.asarray(q), jnp.asarray(k),
        jnp.asarray(v))
    tq, tk, tv = (_t(a).requires_grad_(True) for a in (q, k, v))
    out = fa.flash_attention(tq, tk, tv, causal=True)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want_o),
                               **TOL)
    got = torch.autograd.grad(out, (tq, tk, tv), _t(do))
    for g, w in zip(got, vjp(jnp.asarray(do))):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


def test_bf16_forward_matches_jax_kernel():
    """bf16 inputs: both sides round P to bf16 before P.V and O to bf16 at
    the end. With one 64-key block JAX's running max is the row max, so P
    rounds alike; the float32 sums differ in order only, and O may round
    to the next bf16 value: a bf16 step of the row's largest terms
    (atol 2^-7, the terms are at most ~1) plus one of the value itself."""
    q, k, v, _ = _inputs(b=1, s=64, h=4, hkv=2, d=16, seed=4)
    q, k, v = (np.asarray(jnp.asarray(a, jnp.bfloat16)) for a in (q, k, v))
    jo, jlse = jflash._flash_fwd(_head_major(q), _head_major(k),
                                 _head_major(v), 0.25, True, 64, 64, None,
                                 True)
    o, lse = fa.flash_forward(*(_t(a.astype(np.float32)).bfloat16()
                                for a in (q, k, v)))
    assert o.dtype == torch.bfloat16 and lse.dtype == torch.float32
    want = np.asarray(jo.astype(jnp.float32)).transpose(0, 2, 1, 3)
    np.testing.assert_allclose(o.float().numpy(), want, atol=2.0 ** -7,
                               rtol=2.0 ** -8)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse)[..., 0], **TOL)


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("heads", sorted(HEADS))
def test_bf16_grads_match_jax_kernel(causal, heads):
    """bf16 q, k, v, dO: the plain versions of K2 and K3, the yardstick the
    card's kernels are held to, against JAX ``_flash_bwd`` in interpret mode,
    both fed the same O, lse and delta (delta as ``_flash_bwd`` forms it).
    With one 64-key block both sides form P and dS in float32 from the same
    rows and round them to bf16 alike; the float32 sums may run in another
    order, so a grad may round to the neighbouring bf16 value (rtol 2^-7,
    one step), and a P or dS a float32 rounding apart may round to
    neighbouring bf16 values, moving a grad by at most 2^-8 |dS| |q| (atol
    2^-8; here |dS| |q| < 1)."""
    h, hkv = HEADS[heads]
    q, k, v, do = (np.asarray(jnp.asarray(a, jnp.bfloat16))
                   for a in _inputs(b=1, s=64, h=h, hkv=hkv, d=16, seed=7))
    tq, tk, tv, tdo = (_t(a.astype(np.float32)).bfloat16()
                       for a in (q, k, v, do))
    o, lse = fa.flash_forward_reference(tq, tk, tv, 0.25, causal)
    o = np.asarray(jnp.asarray(o.float().numpy(), jnp.bfloat16))
    delta = jnp.sum(jnp.asarray(do, jnp.float32) * jnp.asarray(o, jnp.float32),
                    axis=-1)                                # [B, S, H]
    jlse = jnp.asarray(lse.numpy())[..., None]              # [B, H, S, 1]
    want = jflash._flash_bwd(_head_major(q), _head_major(k), _head_major(v),
                             _head_major(o), jlse, _head_major(do), 0.25,
                             causal, 64, 64, None, True)
    tdelta = _t(delta).transpose(1, 2).contiguous()         # [B, H, S]
    dq = fa.flash_dq_reference(tq, tk, tv, tdo, lse, tdelta, 0.25, causal)
    dk, dv = fa.flash_dkv_reference(tq, tk, tv, tdo, lse, tdelta, 0.25,
                                    causal)
    for name, g, w in zip(("dq", "dk", "dv"), (dq, dk, dv), want):
        assert g.dtype == torch.bfloat16
        np.testing.assert_allclose(
            g.float().numpy(),
            np.asarray(w.astype(jnp.float32)).transpose(0, 2, 1, 3),
            atol=2.0 ** -8, rtol=2.0 ** -7, err_msg=name)


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("d", [64, 128])
def test_bf16_dq_gate_admits_float64_plain_and_refuses_2pct_off(d, causal):
    """The card's bf16 dQ gate (``chip_smoke``'s per-element 0.25 x RMS +
    2^-7 |plain| and 2e-3 relative L2), through ``chip_smoke``'s own helpers
    on CPU tensors at B1 S128 GQA 4/2: the plain dQ with its float32 steps
    in float64 (a second correct version) passes it, and that dQ 2% off
    does not."""
    import chip_smoke

    q, k, v, do = (_t(a).bfloat16() for a in _inputs(b=1, s=128, h=4, hkv=2,
                                                      d=d, seed=11))
    o, lse = fa.flash_forward_reference(q, k, v, causal=causal)
    delta = fa.delta_rows(do, o)
    ref = fa.flash_dq_reference(q, k, v, do, lse, delta, causal=causal)
    alt = chip_smoke._dq_float64(torch, fa, q, k, v, do, lse, delta, causal)
    assert alt.dtype == torch.bfloat16 and alt.shape == ref.shape
    gate = chip_smoke._gate("dq", "bfloat16")
    assert (gate["dq_atol_rms"], gate["dq_rtol"], gate["dq_l2"]) == (
        0.25, 2.0 ** -7, 2e-3)
    shares = chip_smoke._plain64_shares("dq", alt, ref, gate)
    assert shares["dq_plain64_gate_used"] <= 1.0, shares
    assert chip_smoke._off_gate_used(alt, ref, "dq", gate) > 1.0


def test_launch_counters_only_count_kernels():
    """The CPU path runs the plain versions and launches nothing."""
    q, k, v, do = (_t(a) for a in _inputs(s=32))
    before = [f.launches for f in fa.KERNELS]
    tq = q.requires_grad_(True)
    fa.flash_attention(tq, k, v).backward(do)
    assert [f.launches for f in fa.KERNELS] == before


@pytest.mark.parametrize("wrapper", ["flash_forward", "flash_dq",
                                     "flash_dkv"])
def test_wrappers_never_fall_back_off_the_cpu(wrapper):
    """A tensor that is neither on the CPU nor on a card is refused, not
    run through the plain version."""
    q = torch.empty((1, 8, 2, 16), device="meta")
    rows = torch.empty((1, 2, 8), device="meta")
    args = (q, q, q) if wrapper == "flash_forward" else (q, q, q, q, rows,
                                                          rows)
    with pytest.raises(ValueError, match="CPU or CUDA"):
        getattr(fa, wrapper)(*args)


def test_dispatcher_rejects_a_typo():
    q, k, v, _ = (_t(a) for a in _inputs(s=16))
    with pytest.raises(ValueError, match="unknown attention impl"):
        tattention.attention(q, k, v, impl="flsh")


def test_dispatcher_bias_forces_reference_and_matches_jax():
    q, k, v, _ = _inputs(b=1, s=16, h=4, hkv=2, d=16, seed=5)
    bias = np.random.default_rng(6).standard_normal(
        (1, 2, 2, 16, 16)).astype(np.float32)
    want = jattention(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), impl="flash",
                                bias=jnp.asarray(bias))
    before = [f.launches for f in fa.KERNELS]
    got = tattention.attention(_t(q), _t(k), _t(v), impl="flash",
                               bias=_t(bias))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert [f.launches for f in fa.KERNELS] == before


@pytest.mark.parametrize("impl", ["auto", "reference", "flash"])
def test_dispatcher_impls_match_jax_on_cpu(impl):
    """'auto' on a CPU tensor is the plain attention, as JAX's 'auto' off
    the TPU; 'flash' runs the kernels' plain versions."""
    q, k, v, _ = _inputs(s=64, h=4, hkv=2)
    want = jattention(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), impl=impl)
    got = tattention.attention(_t(q), _t(k), _t(v), impl=impl)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    if impl == "auto":
        assert torch.equal(got, fa.reference_attention(_t(q), _t(k), _t(v)))
