"""The port's paged attention (``ray_tpu_torch.ops.paged_attention``) on the
CPU, against the JAX package's ``paged_attention(impl="reference")`` and a
full-softmax oracle over the gathered view, on the same numpy inputs.

Float32 throughout; atol = rtol = 1e-5: both sides do the same online
softmax in float32, but their sums run in different orders. The CUDA kernel
itself runs only on the card (``chip_smoke.py`` holds it against
``paged_attention_reference`` there).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ray_tpu.ops.paged_attention import paged_attention as jax_paged_attention
from ray_tpu_torch.ops.paged_attention import (SPLIT_KEYS, paged_attention,
                                               paged_attention_reference,
                                               split_plan)

TOL = dict(atol=1e-5, rtol=1e-5)


def _mk_pools(rng, S, K, H, Hkv, D, T, P, lengths, garbage_fill=0.0,
              shared_prefix=0):
    """Random pools and per-slot tables covering ``lengths[s] + K`` tokens;
    table entries past a slot's need point at the garbage page 0, filled
    with ``garbage_fill``. The first ``shared_prefix`` logical pages of
    every slot point at the SAME physical pages (a prefix-cache hit)."""
    need = [min(P, -(-(int(L) + K) // T)) for L in lengths]
    N = sum(need) + 1
    kp = rng.standard_normal((N, T, Hkv, D)).astype(np.float32)
    vp = rng.standard_normal((N, T, Hkv, D)).astype(np.float32)
    kp[0] = garbage_fill
    vp[0] = garbage_fill
    tables = np.zeros((S, P), np.int32)
    pid = 1
    for s in range(S):
        for j in range(need[s]):
            tables[s, j] = pid
            pid += 1
    for s in range(1, S):
        n = min(shared_prefix, need[s], need[0])
        tables[s, :n] = tables[0, :n]
    q = rng.standard_normal((S, K, H, D)).astype(np.float32)
    return q, kp, vp, tables, np.asarray(lengths, np.int32)


def _full_softmax_oracle(q, kp, vp, tables, lengths):
    """Materialize each slot's contiguous view and run a plain masked
    softmax (the pattern of tests/test_paged_attention.py)."""
    S, K, H, D = q.shape
    N, T, Hkv, _ = kp.shape
    P = tables.shape[1]
    G = H // Hkv
    sm = 1.0 / np.sqrt(D)
    out = np.zeros_like(q)
    for s in range(S):
        kv = kp[tables[s]].reshape(P * T, Hkv, D)
        vv = vp[tables[s]].reshape(P * T, Hkv, D)
        for i in range(K):
            qpos = lengths[s] + i
            for h in range(H):
                scores = kv[:, h // G] @ q[s, i, h] * sm
                scores[np.arange(P * T) > qpos] = -np.inf
                w = np.exp(scores - scores.max())
                w /= w.sum()
                out[s, i, h] = w @ vv[:, h // G]
    return out


def _port(args):
    return paged_attention(*[torch.from_numpy(a) for a in args]).numpy()


def _jax(args):
    return np.asarray(jax_paged_attention(*[jnp.asarray(a) for a in args],
                                          impl="reference"))


@pytest.mark.parametrize("K", [1, 3])
@pytest.mark.parametrize("shared_prefix", [0, 2])
def test_matches_jax_reference_and_oracle(K, shared_prefix):
    """Lengths include 0 and an exact page boundary (8 = two full pages of
    T=4); G = 2; the garbage page holds 1e4."""
    rng = np.random.default_rng(10 * K + shared_prefix)
    args = _mk_pools(rng, S=4, K=K, H=4, Hkv=2, D=8, T=4, P=6,
                     lengths=[0, 5, 8, 13], garbage_fill=1e4,
                     shared_prefix=shared_prefix)
    got = _port(args)
    np.testing.assert_allclose(got, _jax(args), **TOL)
    np.testing.assert_allclose(got, _full_softmax_oracle(*args), **TOL)


def test_garbage_page_content_never_leaks():
    """Masked pages add exact zeros: the garbage page's content cannot
    change a single output bit."""
    outs = []
    for fill in (0.0, 1e4):
        args = _mk_pools(np.random.default_rng(3), S=3, K=2, H=4, Hkv=2,
                         D=8, T=4, P=8, lengths=[2, 6, 11],
                         garbage_fill=fill)
        outs.append(_port(args))
    assert np.array_equal(outs[0], outs[1])


def test_window_row_equals_single_token_call():
    """Row i of a K-token window equals a K=1 call at lengths + i, which
    the verify and prefill windows rely on."""
    rng = np.random.default_rng(7)
    q, kp, vp, tables, lengths = _mk_pools(
        rng, S=3, K=4, H=4, Hkv=2, D=8, T=4, P=8, lengths=[0, 3, 8])
    win = _port((q, kp, vp, tables, lengths))
    for i in range(4):
        one = _port((q[:, i:i + 1].copy(), kp, vp, tables, lengths + i))
        np.testing.assert_allclose(win[:, i:i + 1], one, **TOL)


def test_bf16_inputs_keep_dtype():
    args = _mk_pools(np.random.default_rng(4), S=2, K=1, H=4, Hkv=2, D=8,
                     T=4, P=4, lengths=[3, 6])
    t = [torch.from_numpy(a) for a in args]
    for i in range(3):
        t[i] = t[i].to(torch.bfloat16)
    out = paged_attention(*t)
    assert out.dtype == torch.bfloat16 and out.shape == t[0].shape
    ref = paged_attention_reference(*[x.float() if x.is_floating_point()
                                      else x for x in t])
    # bf16 keeps 8 mantissa bits: one rounding of values of size ~1
    np.testing.assert_allclose(out.float().numpy(), ref.numpy(), atol=1e-2)


def test_shape_and_head_mismatches_rejected():
    q, kp, vp, tables, lengths = [torch.from_numpy(a) for a in _mk_pools(
        np.random.default_rng(5), S=2, K=1, H=4, Hkv=2, D=8, T=4, P=4,
        lengths=[3, 3])]
    with pytest.raises(ValueError, match="slot axis"):
        paged_attention(q[:1], kp, vp, tables, lengths)
    with pytest.raises(ValueError, match="slot axis"):
        paged_attention(q, kp, vp, tables, lengths[:1])
    with pytest.raises(ValueError, match="head"):
        paged_attention(q[:, :, :3], kp, vp, tables, lengths)
    with pytest.raises(ValueError, match="head"):
        paged_attention(q[..., :4], kp, vp, tables, lengths)


@pytest.mark.parametrize("P,T", [(128, 16), (8, 4), (100, 16), (3, 256),
                                 (7, 48), (1, 16)])
def test_split_plan_covers_each_page_once(P, T):
    """The kernel's split of a P-page table: fixed page ranges, every page
    of [0, P) in exactly one split, in ascending order, none longer than
    the pages per split, whose keys stay within SPLIT_KEYS (or one page)."""
    plan = split_plan(S=8, K=1, H=32, Hkv=8, D=128, T=T, P=P, elem_bytes=2)
    pps = plan.pages_per_split
    # split j walks pages [j * pps, min((j + 1) * pps, P)), as the kernel
    ranges = [range(j * pps, min((j + 1) * pps, P))
              for j in range(plan.splits)]
    assert all(len(r) > 0 for r in ranges)
    assert [p for r in ranges for p in r] == list(range(P))
    assert pps * T <= max(SPLIT_KEYS, T)
    assert plan.workspace[2] == plan.splits


@pytest.mark.parametrize("dtype_bytes", [2, 4])
def test_split_plan_depends_on_shapes_alone(dtype_bytes):
    """The split count, grid and workspace follow from P, T, K and the heads
    (never from lengths): the serve arena's 128-page tables give 8 splits,
    512 blocks for 8 decode slots of llama3_8b, and a 32-token prefill
    chunk 8 tiles of 16 query rows."""
    decode = split_plan(S=8, K=1, H=32, Hkv=8, D=128, T=16, P=128,
                        elem_bytes=dtype_bytes)
    assert (decode.pages_per_split, decode.splits, decode.row_tiles) == (
        16, 8, 1)
    assert decode.grid == (8, 8, 8)
    assert decode.workspace == (8, 8, 8, 4, 128)
    prefill = split_plan(S=1, K=32, H=32, Hkv=8, D=128, T=16, P=128,
                         elem_bytes=dtype_bytes)
    assert prefill.row_tiles == 8 and prefill.grid == (1, 8, 64)
    assert prefill.workspace == (1, 8, 8, 128, 128)
    # bf16 takes the tensor-core kernel, whose query tile is always 16 rows
    assert decode.tensor_cores == prefill.tensor_cores == (dtype_bytes == 2)
    if dtype_bytes == 2:
        assert decode.smem_bytes == prefill.smem_bytes == 73536
    else:
        assert decode.smem_bytes == 80192 < prefill.smem_bytes <= 232448
    assert split_plan(S=8, K=1, H=32, Hkv=8, D=96, T=16, P=128,
                      elem_bytes=2).tensor_cores is False
    assert split_plan(S=8, K=1, H=32, Hkv=8, D=128, T=8, P=128,
                      elem_bytes=2).tensor_cores is False


def test_cpu_tensors_never_count_as_kernel_launches():
    args = _mk_pools(np.random.default_rng(6), S=1, K=1, H=4, Hkv=2, D=8,
                     T=4, P=4, lengths=[2])
    n0 = paged_attention.launches
    _port(args)
    assert paged_attention.launches == n0


# a pool of another dtype than q's (``cache_dtype``): both sides widen q
# and every page to float32 and write q's dtype, so a float32 output holds
# to TOL and a bf16 one to one bf16 rounding step (2^-7 of the value)
MIXED = {"f32_q_bf16_pool": (torch.float32, jnp.float32, torch.bfloat16,
                             jnp.bfloat16, TOL),
         "bf16_q_f32_pool": (torch.bfloat16, jnp.bfloat16, torch.float32,
                             jnp.float32, dict(atol=1e-5, rtol=2.0 ** -7))}


@pytest.mark.parametrize("pair", sorted(MIXED))
@pytest.mark.parametrize("K", [1, 3])
def test_mixed_dtype_pool_matches_jax_reference(pair, K):
    """The plain version over a pool of another dtype than q's, against
    JAX's ``_paged_attention_reference`` on the same numpy inputs."""
    tq, jq, tp, jp, tol = MIXED[pair]
    rng = np.random.default_rng(20 + K)
    q, kp, vp, tables, lengths = _mk_pools(
        rng, S=4, K=K, H=4, Hkv=2, D=8, T=4, P=6, lengths=[0, 5, 8, 13],
        garbage_fill=1e4, shared_prefix=1)
    got = paged_attention(
        torch.from_numpy(q).to(tq), torch.from_numpy(kp).to(tp),
        torch.from_numpy(vp).to(tp), torch.from_numpy(tables),
        torch.from_numpy(lengths))
    assert got.dtype == tq
    want = jax_paged_attention(
        jnp.asarray(q, jq), jnp.asarray(kp, jp), jnp.asarray(vp, jp),
        jnp.asarray(tables), jnp.asarray(lengths), impl="reference")
    assert want.dtype == jq
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **tol)


def test_mixed_pairs_route_f32_q_to_tensor_cores_and_bf16_q_to_fma():
    """Float32 q over a bf16 pool goes to the tensor-core split kernel,
    whose query tile holds q as three bf16 planes; bf16 q over a float32
    pool goes to the float32 FMA split kernel, whose page ring holds the
    pool's rows and whose query tile holds q's (the shared memory each
    kernel takes)."""
    dec = dict(S=8, K=1, H=32, Hkv=8, D=128, T=16, P=128)
    pre = dict(dec, S=1, K=32)
    for shapes, pool, qb, tc, smem in ((dec, 2, 4, True, 82240),
                                       (pre, 2, 4, True, 82240),
                                       (dec, 4, 2, False, 79168),
                                       (pre, 4, 2, False, 95296)):
        plan = split_plan(**shapes, elem_bytes=pool, q_bytes=qb)
        assert plan.tensor_cores is tc
        assert plan.smem_bytes == smem
    assert split_plan(**dec, elem_bytes=2, q_bytes=2).tensor_cores


# float32 q over a bf16 pool at (D, T): the route and the split kernel's
# shared memory. The tensor cores take the bf16 kernel's head widths and
# pages of a multiple of 16 tokens where the tile (three query planes)
# fits one block; the rest stays on the FMA kernel, as does bf16 q over a
# float32 pool
F32_Q_PLANS = [(32, 16, 4, 2, True, 36160), (64, 16, 4, 2, True, 51520),
               (64, 32, 4, 2, True, 79136), (128, 16, 4, 2, True, 82240),
               (128, 48, 4, 2, True, 185620), (256, 16, 4, 2, True, 143680),
               (96, 16, 4, 2, False, 30528), (128, 8, 4, 2, False, 27008),
               (128, 64, 4, 2, False, 170256), (256, 32, 4, 2, False, 155936),
               (64, 16, 2, 4, False, 45888), (128, 16, 2, 4, False, 79168)]


@pytest.mark.parametrize("D,T,qb,pool,tc,smem", F32_Q_PLANS)
def test_mixed_pair_split_plan_route(D, T, qb, pool, tc, smem):
    plan = split_plan(S=8, K=1, H=32, Hkv=8, D=D, T=T, P=128,
                      elem_bytes=pool, q_bytes=qb)
    assert plan.tensor_cores is tc
    assert plan.smem_bytes == smem <= 232448
    # the bf16 pair at the same shape shares the route where both fit
    both = split_plan(S=8, K=1, H=32, Hkv=8, D=D, T=T, P=128, elem_bytes=2,
                      q_bytes=2)
    if tc:
        assert both.tensor_cores
        assert smem - both.smem_bytes == 2 * 16 * 2 * (D + 8)


@pytest.mark.parametrize("qd,kd,vd", [
    (torch.float16, torch.float16, torch.float16),
    (torch.float32, torch.float16, torch.float16),
    (torch.float32, torch.bfloat16, torch.float32),
    (torch.float64, torch.float32, torch.float32)])
def test_unsupported_dtype_pair_raises_before_any_launch(qd, kd, vd):
    """The kernel's wrapper refuses a dtype pair it has no entry for (and
    a k pool unlike the v pool) before it touches the card."""
    from ray_tpu_torch.ops.paged_attention import _paged_attention_cuda

    q, kp, vp, tables, lengths = [torch.from_numpy(a) for a in _mk_pools(
        np.random.default_rng(8), S=1, K=1, H=4, Hkv=2, D=8, T=4, P=4,
        lengths=[2])]
    n0 = paged_attention.launches
    with pytest.raises(TypeError, match="dtype"):
        _paged_attention_cuda(q.to(qd), kp.to(kd), vp.to(vd), tables,
                              lengths, 1.0)
    assert paged_attention.launches == n0
