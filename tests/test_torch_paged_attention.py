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
    # bf16 and float32 both take the tensor-core kernel, whose query tile
    # is always 16 rows (a float32 pool's ring holds 2 steps, not 3)
    assert decode.tensor_cores and prefill.tensor_cores
    assert decode.smem_bytes == prefill.smem_bytes == {2: 73536,
                                                       4: 99648}[dtype_bytes]
    assert split_plan(S=8, K=1, H=32, Hkv=8, D=96, T=16, P=128,
                      elem_bytes=dtype_bytes).tensor_cores is False
    assert split_plan(S=8, K=1, H=32, Hkv=8, D=128, T=8, P=128,
                      elem_bytes=dtype_bytes).tensor_cores is False


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


def test_mixed_pairs_route_to_tensor_cores():
    """Both mixed pairs take the tensor-core split kernel at llama3_8b's
    decode and prefill shapes: float32 q over a bf16 pool with q as three
    bf16 planes in its query tile, bf16 q over a float32 pool with a ring
    of two steps of float32 pages (the shared memory each takes)."""
    dec = dict(S=8, K=1, H=32, Hkv=8, D=128, T=16, P=128)
    pre = dict(dec, S=1, K=32)
    for shapes, pool, qb, tc, smem in ((dec, 2, 4, True, 82240),
                                       (pre, 2, 4, True, 82240),
                                       (dec, 4, 2, True, 90944),
                                       (pre, 4, 2, True, 90944)):
        plan = split_plan(**shapes, elem_bytes=pool, q_bytes=qb)
        assert plan.tensor_cores is tc
        assert plan.smem_bytes == smem
    assert split_plan(**dec, elem_bytes=2, q_bytes=2).tensor_cores


# (D, T, q bytes, pool bytes): the route and the split kernel's shared
# memory. The tensor cores take every pair at head widths 16-256 with
# pages of a multiple of 16 tokens where the tile fits one block: the
# ring of 4-page steps (3 over a bf16 pool, 2 over a float32 one) of rows
# of D + 8 pool elements, the query tile (three bf16 planes under float32
# q), the scores and page ids. The rest stays on the FMA kernel.
SPLIT_PLANS = [(32, 16, 4, 2, True, 36160), (64, 16, 4, 2, True, 51520),
               (64, 32, 4, 2, True, 79136), (128, 16, 4, 2, True, 82240),
               (128, 48, 4, 2, True, 185620), (256, 16, 4, 2, True, 143680),
               (96, 16, 4, 2, False, 30528), (128, 8, 4, 2, False, 27008),
               (128, 64, 4, 2, False, 170256), (256, 32, 4, 2, False, 155936),
               (64, 16, 2, 4, True, 56128), (128, 16, 2, 4, True, 90944),
               (128, 16, 4, 4, True, 99648), (64, 16, 4, 4, True, 60736),
               (256, 16, 4, 4, True, 177472), (16, 16, 4, 4, True, 31552),
               (16, 16, 2, 2, True, 26944), (16, 16, 4, 2, True, 28480),
               (16, 16, 2, 4, True, 30016), (128, 32, 4, 4, True, 169248),
               (16, 8, 4, 4, False, 8576), (128, 48, 4, 4, False, 227348),
               (96, 16, 2, 4, False, 62272)]


@pytest.mark.parametrize("D,T,qb,pool,tc,smem", SPLIT_PLANS)
def test_split_plan_route_of_each_pair(D, T, qb, pool, tc, smem):
    plan = split_plan(S=8, K=1, H=32, Hkv=8, D=D, T=T, P=128,
                      elem_bytes=pool, q_bytes=qb)
    assert plan.tensor_cores is tc
    assert plan.smem_bytes == smem <= 232448
    # the bf16 pair at the same shape shares the route where both fit
    both = split_plan(S=8, K=1, H=32, Hkv=8, D=D, T=T, P=128, elem_bytes=2,
                      q_bytes=2)
    if tc and pool == 2:
        assert both.tensor_cores
        assert smem - both.smem_bytes == 2 * 16 * 2 * (D + 8) * (qb // 4)


@pytest.mark.parametrize("qb", [2, 4])
def test_float32_pool_keeps_two_blocks_an_sm_at_llama3_8b(qb):
    """Over a float32 pool at D 128 and 16-token pages the tensor-core
    block takes at most ~113 KB, so two fit an SM's 228 KB (1 KB reserved
    a block): the ring holds 2 steps of float32 pages; 3 would take one
    block an SM."""
    plan = split_plan(S=8, K=1, H=32, Hkv=8, D=128, T=16, P=128,
                      elem_bytes=4, q_bytes=qb)
    assert plan.tensor_cores
    assert 2 * (plan.smem_bytes + 1024) <= 228 * 1024
    assert plan.smem_bytes <= 113 * 1024
    three_steps = plan.smem_bytes + 4 * 16 * (128 + 8) * 4
    assert 2 * (three_steps + 1024) > 228 * 1024


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


# --------------------------------- the float32-pool tensor-core arithmetic


def _parts(x):
    """x (float32) as its hi, mid and lo bf16 parts, held in float32, as
    ``split3`` in ``csrc/paged_attention.cu`` splits q, K, V and P."""
    hi = x.to(torch.bfloat16).float()
    mid = (x - hi).to(torch.bfloat16).float()
    lo = (x - hi - mid).to(torch.bfloat16).float()
    return hi, mid, lo


def _mma(c, a, b):
    """One mma.sync per 16-deep slice: c + a . b, the slice's products of
    bf16 parts summed exactly, the sum rounded once to float32 (the card
    rounds it toward zero; this rounds to nearest)."""
    for k0 in range(0, a.shape[-1], 16):
        c = (c.double() + a[:, k0:k0 + 16].double()
             @ b[k0:k0 + 16].double()).float()
    return c


# the small products, smallest first, in the kernel's order (q or P's
# part, K or V's part; 0 hi, 1 mid, 2 lo); hi . hi comes last
SMALL_SIX = ((2, 0), (1, 1), (0, 2), (1, 0), (0, 1))
SMALL_THREE = ((0, 2), (0, 1))  # bf16 q (one part) over K's lo, then mid


def _split_mma_emulation(q, kp, vp, tables, lengths, f32_q):
    """The tensor-core split kernel over a float32 pool, in torch, for
    float32 q (``f32_q``: six products each way) or bf16 q (three for S,
    six for P.V): per (slot, kv head) and split of SPLIT_KEYS keys, S with
    the small products over every 16-wide k-step first and hi . hi last,
    scaled and masked to -1e30; the split's exact softmax; P.V per warp
    (pages w, w + 4, ...), each page's sum from zero with the small
    products over its 16-key tiles first, then added to the warp's sum;
    the warps' sums added in order; the merge of a row's splits up to its
    own. Returns float32 [S, K, H, D]."""
    S, K, H, D = q.shape
    _, T, Hkv, _ = kp.shape
    P = tables.shape[1]
    G = H // Hkv
    pps = max(1, SPLIT_KEYS // T)
    scale = torch.tensor(1.0 / np.sqrt(D), dtype=torch.float32)
    neg = torch.tensor(-1e30, dtype=torch.float32)
    small_s = SMALL_SIX if f32_q else SMALL_THREE
    out = torch.zeros((S, K, H, D), dtype=torch.float32)
    for s in range(S):
        L = int(lengths[s])
        live = min(-(-(L + K) // T), P)
        pos = L + torch.arange(K).repeat_interleave(G)  # row r = i G + g
        for kvh in range(Hkv):
            rows = q[s, :, kvh * G:(kvh + 1) * G].reshape(K * G, D).float()
            qp = _parts(rows) if f32_q else (rows,)
            splits = []
            for first in range(0, live, pps):
                pages = [int(x) for x in tables[s, first:min(first + pps,
                                                             live)]]
                keys = torch.cat([kp[p, :, kvh] for p in pages])
                kparts = _parts(keys)
                sc = torch.zeros((K * G, len(keys)), dtype=torch.float32)
                for k0 in range(0, D, 16):
                    for i, j in small_s:
                        sc = _mma(sc, qp[i][:, k0:k0 + 16],
                                  kparts[j][:, k0:k0 + 16].T)
                for k0 in range(0, D, 16):
                    sc = _mma(sc, qp[0][:, k0:k0 + 16],
                              kparts[0][:, k0:k0 + 16].T)
                key = first * T + torch.arange(len(keys))
                sc = torch.where(key[None] <= pos[:, None], sc * scale, neg)
                m = sc.max(dim=1).values
                pr = torch.exp(sc - m[:, None])
                acc = torch.zeros((K * G, D), dtype=torch.float32)
                for w in range(4):
                    warp = torch.zeros((K * G, D), dtype=torch.float32)
                    for pg in range(w, len(pages), 4):
                        pparts = _parts(pr[:, pg * T:(pg + 1) * T])
                        vparts = _parts(vp[pages[pg], :, kvh])
                        pv = torch.zeros((K * G, D), dtype=torch.float32)
                        for pair in SMALL_SIX + ((0, 0),):
                            pv = _mma(pv, pparts[pair[0]], vparts[pair[1]])
                        warp = warp + pv
                    acc = acc + warp
                splits.append((m, pr.sum(dim=1), acc))
            for r in range(K * G):
                last = min(int(pos[r]), P * T - 1) // (pps * T)
                m = max(float(splits[j][0][r]) for j in range(last + 1))
                m = torch.tensor(m, dtype=torch.float32)
                l = torch.zeros((), dtype=torch.float32)
                acc = torch.zeros(D, dtype=torch.float32)
                for j in range(last + 1):
                    w = torch.exp(splits[j][0][r] - m)
                    l = (w.double() * splits[j][1][r].double()
                         + l.double()).float()
                    acc = (w.double() * splits[j][2][r].double()
                           + acc.double()).float()
                i, g = divmod(r, G)
                out[s, i, kvh * G + g] = acc / (l if l != 0 else 1.0)
    return out


# (K, lengths, H, Hkv, D, P): llama_debug's decode shape in the harness
# serve probe (D 16) and llama3_8b's group of 4 at D 128, at decode and in
# a verify window of SPEC_K + 1 = 5 rows whose positions cross the first
# split boundary (256 keys)
EMULATED = {"decode_d16": (1, [10, 16], 4, 2, 16, 8),
            "verify_d16": (5, [0, 37], 4, 2, 16, 8),
            "decode_d128": (1, [37, 300], 8, 2, 128, 24),
            "verify_d128": (5, [16, 252], 8, 2, 128, 24)}


@pytest.mark.parametrize("f32_q", [True, False], ids=["f32_q", "bf16_q"])
@pytest.mark.parametrize("case", sorted(EMULATED))
def test_float32_pool_tensor_core_arithmetic_matches_jax(case, f32_q):
    """The float32-pool tensor-core kernel's arithmetic (split3 parts in
    bf16, three or six products in float32, its order of sums), emulated
    in torch, against JAX's reference on the same seeded numpy inputs
    within float32's TOL. Under bf16 q both sides widen q's bf16 values
    to float32 (as the TPU kernel does), and the kernel's bf16 output is
    one rounding of that within one bf16 step of JAX's bf16 output."""
    K, lengths, H, Hkv, D, P = EMULATED[case]
    rng = np.random.default_rng(len(case) + 7 * K + D)
    q, kp, vp, tables, lens = _mk_pools(
        rng, S=2, K=K, H=H, Hkv=Hkv, D=D, T=16, P=P, lengths=lengths,
        garbage_fill=1e4)
    if not f32_q:  # q's values as bf16 holds them
        q = torch.from_numpy(q).to(torch.bfloat16).float().numpy()
    got = _split_mma_emulation(torch.from_numpy(q), torch.from_numpy(kp),
                               torch.from_numpy(vp), torch.from_numpy(tables),
                               torch.from_numpy(lens), f32_q)
    np.testing.assert_allclose(got.numpy(), _jax((q, kp, vp, tables, lens)),
                               **TOL)
    if not f32_q:
        want = jax_paged_attention(
            jnp.asarray(q, jnp.bfloat16), jnp.asarray(kp), jnp.asarray(vp),
            jnp.asarray(tables), jnp.asarray(lens), impl="reference")
        np.testing.assert_allclose(
            got.to(torch.bfloat16).float().numpy(),
            np.asarray(want, np.float32), atol=1e-5, rtol=2.0 ** -7)
