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


# the float32 gate's cases: train parity's shape (D 16) and GQA 4/2 at D 64
F32_GATE_CASES = {"d16": dict(b=2, s=48, h=4, hkv=2, d=16),
                  "d64": dict(b=1, s=128, h=4, hkv=2, d=64)}


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("shape", sorted(F32_GATE_CASES))
@pytest.mark.parametrize("key", ["dq", "dk", "dv"])
def test_f32_grad_gate_admits_float64_plain_and_refuses_2pct_off(key, shape,
                                                                 causal):
    """The card's float32 gate (``chip_smoke.F32_GATE``: 1e-5 x RMS + 1e-5
    |plain| per element), through ``chip_smoke``'s own helpers on CPU
    tensors: the plain dQ, dK and dV with their float32 steps in float64
    (a second correct version) pass it, and the same 2% off do not."""
    import chip_smoke

    q, k, v, do = (_t(a) for a in _inputs(**F32_GATE_CASES[shape], seed=12))
    o, lse = fa.flash_forward_reference(q, k, v, causal=causal)
    delta = fa.delta_rows(do, o)
    dq = fa.flash_dq_reference(q, k, v, do, lse, delta, causal=causal)
    dk, dv = fa.flash_dkv_reference(q, k, v, do, lse, delta, causal=causal)
    ref = {"dq": dq, "dk": dk, "dv": dv}[key]
    alts = dict(zip(("dq", "dk", "dv"), (
        chip_smoke._dq_float64(torch, fa, q, k, v, do, lse, delta, causal),)
        + chip_smoke._dkv_float64(torch, fa, q, k, v, do, lse, delta,
                                  causal)))
    alt = alts[key]
    assert alt.dtype == torch.float32 and alt.shape == ref.shape
    gate = chip_smoke._gate(key, "float32")
    assert (gate[f"{key}_atol_rms"], gate[f"{key}_rtol"], gate[f"{key}_l2"]
            ) == (*chip_smoke.F32_GATE, None) == (1e-5, 1e-5, None)
    shares = chip_smoke._plain64_shares(key, alt, ref, gate)
    assert shares[f"{key}_plain64_gate_used"] <= 1.0, shares
    assert chip_smoke._off_gate_used(alt, ref, key, gate) > 1.0


def _parts64(x):
    return tuple(p.double() for p in _bf16_parts(x.float()))


def _six(eq, a, b):
    """``einsum(eq, a, b)`` of float32 a and b as the six cross products of
    their bf16 parts above 2^-24, each exact, summed in float64."""
    pa, pb = _parts64(a), _parts64(b)
    return sum(torch.einsum(eq, pa[i], pb[j])
               for i, j in ((2, 0), (1, 1), (0, 2), (1, 0), (0, 1), (0, 0)))


def _split_bf16_dq_dkv(q, k, v, do, lse, delta, causal):
    """The float32 K2 and K3 of ``csrc/flash_attention.cu`` modelled in
    float64 on the CPU: S and dP as each 16-deep k-step's six products,
    rounded to float32 and added in float32; P and dS in float32; dQ as
    each key tile's dS.K (64 keys, 32 at D 128), dV and dK as each query
    tile's P^T.dO and dS^T.Q, the query heads of a group and their tiles
    in the kernel's order, each tile's six products rounded to float32 and
    added in float32. (The kernels' sums of products round toward zero
    inside the tensor cores; the model rounds to nearest.)"""
    B, S, H, D = q.shape
    Hkv = k.shape[2]
    G = H // Hkv
    scale = 1.0 / np.sqrt(D)
    tile = 64 if D <= 64 else 32
    qg, dog = (t.reshape(B, S, Hkv, G, D) for t in (q, do))
    s = dp = torch.zeros((B, Hkv, G, S, S))
    for d0 in range(0, D, 16):
        cut = slice(d0, d0 + 16)
        s = s + _six("bqhgd,bkhd->bhgqk", qg[..., cut], k[..., cut]).float()
        dp = dp + _six("bqhgd,bkhd->bhgqk", dog[..., cut], v[..., cut]).float()
    s = s * scale
    if causal:
        s = s.masked_fill(torch.ones(S, S, dtype=torch.bool).triu(1),
                          fa.NEG_INF)
    rows = (lse.reshape(B, Hkv, G, S, 1), delta.reshape(B, Hkv, G, S, 1))
    p = torch.exp(s - rows[0])
    ds = p * (dp - rows[1]) * scale
    dq = torch.zeros((B, S, Hkv, G, D))
    for k0 in range(0, S, tile):
        dq = dq + _six("bhgqk,bkhd->bqhgd", ds[..., k0:k0 + tile],
                       k[:, k0:k0 + tile]).float()
    dk = dv = torch.zeros((B, S, Hkv, D))
    for g in range(G):
        for q0 in range(0, S, tile):
            cut = slice(q0, q0 + tile)
            dv = dv + _six("bhqk,bqhd->bkhd", p[:, :, g, cut],
                           dog[:, cut, :, g]).float()
            dk = dk + _six("bhqk,bqhd->bkhd", ds[:, :, g, cut],
                           qg[:, cut, :, g]).float()
    return dq.reshape(q.shape), dk, dv


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("shape", ["d16", "d64", "d128"])
def test_split_bf16_backward_model_lies_within_f32_gate(shape, causal):
    """The arithmetic of the float32 tensor-core K2 and K3, modelled on the
    CPU (``_split_bf16_dq_dkv``), on inputs made with numpy whose O and lse
    come from JAX's ``_flash_fwd`` in interpret mode: dQ, dK and dV lie
    within the card's float32 gate of ``flash_dq_reference`` and
    ``flash_dkv_reference``."""
    import chip_smoke

    dims = dict(F32_GATE_CASES, d128=dict(b=1, s=64, h=4, hkv=2, d=128))
    q, k, v, do = _inputs(**dims[shape], seed=13)
    block = 16 if q.shape[1] % 64 else 64
    jo, jlse = jflash._flash_fwd(_head_major(q), _head_major(k),
                                 _head_major(v), 1.0 / np.sqrt(q.shape[-1]),
                                 causal, block, block, None, True)
    tq, tk, tv, tdo = (_t(a) for a in (q, k, v, do))
    o = _t(np.asarray(jo).transpose(0, 2, 1, 3))
    lse = _t(np.asarray(jlse)[..., 0])
    delta = fa.delta_rows(tdo, o)
    want = (fa.flash_dq_reference(tq, tk, tv, tdo, lse, delta,
                                  causal=causal),
            *fa.flash_dkv_reference(tq, tk, tv, tdo, lse, delta,
                                    causal=causal))
    got = _split_bf16_dq_dkv(tq, tk, tv, tdo, lse, delta, causal)
    for key, g, w in zip(("dq", "dk", "dv"), got, want):
        used = chip_smoke._gate_err(g, w, key,
                                    chip_smoke._gate(key, "float32"))[2]
        assert used <= 1.0, (key, used)
        assert not torch.equal(g, w)  # another order of sums


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


@pytest.mark.parametrize("name,dtype,d,route", [
    ("flash_fwd", torch.float32, 64, "tensor cores"),
    ("flash_fwd", torch.float32, 128, "tensor cores"),
    ("flash_fwd", torch.float32, 16, "FMA"),
    ("flash_dq", torch.float32, 64, "tensor cores"),
    ("flash_dkv", torch.float32, 128, "tensor cores"),
    ("flash_dq", torch.float32, 16, "tensor cores"),
    ("flash_dkv", torch.float32, 16, "tensor cores"),
    ("flash_fwd", torch.bfloat16, 64, "tensor cores"),
    ("flash_dkv", torch.bfloat16, 128, "tensor cores"),
    ("flash_dq", torch.bfloat16, 16, "FMA")])
def test_kernel_route_mirrors_the_kernels(name, dtype, d, route):
    assert fa.kernel_route(name, dtype, d) == route


NS = "_ZN51_GLOBAL__N__ba107a96_18_flash_attention_cu_1ad8dec0"
PA = "_ZN51_GLOBAL__N__c4fc24a1_18_paged_attention_cu_104c41dd"


@pytest.mark.parametrize("mangled,label", [
    (NS + "24flash_fwd_f32_mma_kernelILi64EEEvPKfS2_S2_PfS3_iiiifi",
     "flash_fwd_f32_mma_kernel<f32, 64>"),
    (NS[:-1] + "120flash_fwd_mma_kernelILi128EEEvPK13__nv_bfloat16S3_",
     "flash_fwd_mma_kernel<bf16, 128>"),
    (NS + "16flash_dkv_kernelIfLi16EEEvPKT_S3_S3_S3_PKfS5_PS1_S6_iiiifi",
     "flash_dkv_kernel<f32, 16>"),
    (NS + "23flash_dq_f32_mma_kernelILi64EEEvPKfS2_S2_S2_S2_S2_Pfiiiifi",
     "flash_dq_f32_mma_kernel<f32, 64>"),
    (NS + "24flash_dkv_f32_mma_kernelILi16EEEvPKfS2_S2_S2_S2_S2_PfS3_iiiifi",
     "flash_dkv_f32_mma_kernel<f32, 16>"),
    (NS + "24flash_dkv_f32_mma_kernelILi128EEEvPKfS2_S2_S2_S2_S2_PfS3_iiiifi",
     "flash_dkv_f32_mma_kernel<f32, 128>"),
    (PA + "32paged_attention_split_mma_kernelIf13__nv_bfloat16Li128EEEvPKT_"
     "PKT0_S7_PKiS9_PfSA_iiiiiiif",
     "paged_attention_split_mma_kernel<f32, bf16, 128>"),
    (PA + "32paged_attention_split_mma_kernelIffLi16EEEvPKT_PKT0_S5_PKiS7_"
     "PfS8_iiiiiiif",
     "paged_attention_split_mma_kernel<f32, f32, 16>"),
    (PA + "32paged_attention_split_mma_kernelI13__nv_bfloat16fLi128EEEvPKT_"
     "PKT0_S7_PKiS9_PfSA_iiiiiiif",
     "paged_attention_split_mma_kernel<bf16, f32, 128>"),
    (NS + "28paged_attention_split_kernelIf13__nv_bfloat16Li128EEEvPKT_",
     "paged_attention_split_kernel<f32, bf16, 128>"),
    # a type repeated in the template arguments is a substitution: S1_ is
    # the third name seen (the namespace, the kernel's name, then bf16)
    (PA + "32paged_attention_split_mma_kernelI13__nv_bfloat16S1_Li128EEEv"
     "PKT_PKT0_S7_PKiS9_PfSA_iiiiiiif",
     "paged_attention_split_mma_kernel<bf16, bf16, 128>"),
    (PA + "28paged_attention_split_kernelI13__nv_bfloat16S1_Li64EEEvPKT_"
     "PKT0_S7_PKiS9_PfSA_iiiiiiiif",
     "paged_attention_split_kernel<bf16, bf16, 64>"),
    (PA + "32paged_attention_split_mma_kernelI13__nv_bfloat16S1_Li16EEEv"
     "PKT_PKT0_S7_PKiS9_PfSA_iiiiiiif",
     "paged_attention_split_mma_kernel<bf16, bf16, 16>"),
    # outside a namespace the kernel's name is the first (S_), bf16 S0_
    ("_Z28paged_attention_split_kernelI13__nv_bfloat16S0_Li32EEvPKT_PKT0_"
     "S5_PKiS7_PfS8_iiiiiiiif",
     "paged_attention_split_kernel<bf16, bf16, 32>"),
    (PA + "28paged_attention_merge_kernelI13__nv_bfloat16Li1EEEvPKfS4_PKiPT_"
     "iiiiiii",
     "paged_attention_merge_kernel<bf16, 1>")])
def test_chip_smoke_labels_each_kernel_instantiation(mangled, label):
    """The build phase's names for the kernels whose HMMA instructions and
    spills it gates, from the mangled names nvcc gives them."""
    import chip_smoke

    assert chip_smoke.kernel_label(mangled) == label
    assert ("mma" in label) == (label in chip_smoke.TENSOR_CORE_KERNELS)


def _bf16_parts(x):
    """x as hi + mid + lo bf16 parts, as the float32 tensor-core K1 splits
    each operand (``split3`` in ``csrc/flash_attention.cu``)."""
    hi = x.to(torch.bfloat16)
    r = x - hi.float()
    mid = r.to(torch.bfloat16)
    lo = (r - mid.float()).to(torch.bfloat16)
    return hi, mid, lo


def test_float32_is_three_bf16_parts_and_six_products_keep_its_precision():
    """The arithmetic the float32 tensor-core K1 rests on: every float32
    value is the sum of its three bf16 parts exactly, and a dot product
    as the six cross products of the parts above 2^-24 (each exact in
    float32) lies within float32's rounding of the exact dot product."""
    rng = np.random.default_rng(5)
    x = torch.from_numpy((rng.standard_normal(1 << 16)
                          * np.exp2(rng.integers(-60, 60, 1 << 16)))
                         .astype(np.float32))
    hi, mid, lo = _bf16_parts(x)
    assert torch.equal(hi.double() + mid.double() + lo.double(), x.double())
    q, k = (torch.from_numpy(rng.standard_normal((64, 128)).astype(
        np.float32)) for _ in range(2))
    qp, kp = _bf16_parts(q), _bf16_parts(k)
    six = sum(qp[i].double() @ kp[j].double().T
              for i, j in ((2, 0), (1, 1), (0, 2), (1, 0), (0, 1), (0, 0)))
    exact = q.double() @ k.double().T
    scale = q.double().abs() @ k.double().abs().T
    assert float(((six - exact).abs() / scale).max()) < 2.0 ** -22


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
