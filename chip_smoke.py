#!/usr/bin/env python3
"""Runs the PyTorch/CUDA port (``ray_tpu_torch``) on one NVIDIA card and
checks it, phase by phase. Usage, from the root of a checkout:

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit, no result line) if any
of its checks fails:

  1. card: the card's name and power limit, as nvidia-smi gives them.
  2. build: nvcc builds both kernel sources of ``ray_tpu_torch/csrc/``
     (paged attention; flash attention K1-K3) for sm_90a into
     ``build/kernels/``, one nvcc each, started together; ptxas lines;
     ``cuobjdump -sass`` counts the HMMA (tensor-core) instructions of each
     kernel, and the run fails if the bf16 K1, K2 or K3 at D=64 or 128, or
     the bf16 split kernel of K4 at any of its head widths, has none.
  3. kernel: the paged-attention kernel (split over pages, then merged;
     the split kernel on the tensor cores in bf16, float32 FMA in float32
     and for a pool of the other dtype than q's) against
     ``paged_attention_reference`` on the card, at llama3_8b shapes
     (H=32, Hkv=8, D=128, 16-token pages), for the (q, pool) dtype pairs
     bf16/bf16, float32/float32, float32/bf16 and bf16/float32 (a float16
     call must raise), for decode (8
     slots, 1 token), prefill (1 slot, a 32-token chunk) and the
     speculative verify window (8 slots, 5 tokens, cursors 0 to 2043); row
     i of a window against a 1-token call at length + i, bit for bit: the
     32-token windows at length 45 and at length 240 (the window crosses a
     split boundary) and the verify window; two
     decode calls bitwise equal; one call under
     ``torch.cuda.set_sync_debug_mode("error")``, so a host read of the
     lengths fails the run; the launch counter; the split plan; times of
     the kernel, of its plain version, of scaled_dot_product_attention over
     a pre-gathered contiguous view (a yardstick only: the port never calls
     it) and the bound (live-page bytes over the memory rate, or the
     operations over the peak rate, whichever is larger).
  4. flash: the flash-attention forward (K1), dQ (K2) and dK/dV (K3)
     kernels against their plain versions on the card, bf16 and float32, at
     gpt2_small (B16 S1024 H12 D64), gpt_1b (B4 S1024 H16/8 D128), a
     group-4 case (B1 S2048 H32/8 D128), a ragged S=1000 and a non-causal
     case: O, lse, dQ, dK, dV within the stated tolerances, an O, a dQ, a
     dK and a dV 2% off refused, two runs of K2 and of K3 bitwise equal;
     times of each kernel, its plain version, the library yardstick (SDPA
     forward for K1; the autograd backward of that same call for K2 and K3
     together) and the bound. In bf16, K1, K2 and K3 run on the tensor
     cores (mma.sync); every float32 kernel runs float32 FMA.
  5. serve: ``LLMServerImpl(preset="llama3_8b")`` at full width and depth
     (32 layers), random bf16 weights from a seeded torch.Generator,
     answers 12 streamed requests that share a prefix (8 slots, one request
     sampled at temperature 0.7), through the kernel on every layer.
  6. spec-serve: the same server and requests with speculative decoding
     (the self drafter, spec_k 4): every round 4 drafter steps over a
     contiguous slot arena, then one K4 verify window per layer; launches
     exactly layers x (prefill chunks + verify rounds), no plain decode
     step; tokens/s, round ms, TTFT, accept rate, tokens per round, the
     drafter arena's size, peak memory, and how many temperature-0 texts
     equal the serve phase's (counted, not gated). Then one verify call
     against 5
     sequential decode steps on a copy of the same caches, with the bf16
     weights and with them upcast to float32: logits within
     ``VERIFY_GATE`` of their RMS per element, and a float32 output 2%
     off refused.
  7. serve-lanes: the JAX replica's serve baselines and knobs at
     llama3_8b, full width and 32 layers, on one tree of the serve phase's
     seed-0 weights: (a) ``attn="gather"``, (b) ``kv_layout="contiguous"``,
     (c) a 97-page pool with the prefix cache and an ``eos_id`` from the
     serve phase's first greedy text (at least one request retires on
     "eos", at most 96 pages in use), (d) ``scheduler="batch"``, (e) a
     float32 KV cache under the bf16 model (K4's bf16 q / float32 pool
     pair), (f) the same weights in float32 over a bf16 KV cache (K4's
     float32 q / bf16 pool pair); the 12 requests each: tokens/s, TTFT,
     decode-step ms, K4 launches exact per dtype pair (0 off the
     in-place lane), temperature-0 texts equal to the serve phase's
     (counted, not gated). The kernels line's launches of the two mixed
     pairs come from (e) and (f).
  8. parity: in float32, the port on the card against the port on the
     CPU with the same weights, temperature-0 texts identical: llama_debug;
     llama_debug with the self drafter (also equal to the texts without
     it); moe_debug (the mixture-of-experts layer); llama_debug under
     (a)-(d) and with a bf16 KV cache (K4's float32/bf16 pair, launches
     exact); the bf16 model over a float32 cache (K4's bf16/float32 pair,
     launches exact, texts counted); ``attn="reference"`` on the card
     refused.
  9. train: ``init_train_state`` + ``make_train_step`` on the card, bf16
     compute over float32 params, random weights from a seed and random
     tokens: gpt2_small at full width and depth (12 layers, d 768, vocab
     50257), B16 x S1024, remat off, CE chunk 8192, one warm-up step and 5
     timed steps (step ms, tokens/s, model-flop utilization against the
     bf16 dense peak), one torch.profiler step (device time by kernel
     group, the flash group by kernel); one step under the default full
     remat; gpt_1b at full width with 4 of its 16 layers (cut for time),
     B4 x S1024, 'dots' remat, 5 timed steps and one profiled. Losses and
     grad norms finite, the loss going down, and the flash launch counters
     exactly layers x steps for K2 and K3 and (remat ? 2 : 1) x layers x
     steps for K1. Before them, the fused CE with bf16 operands at
     gpt2_small's width and vocab against float64 (its logits keep the
     product's float32 result).
 10. train parity: llama_debug, a tiny GPT-2 (learned positions,
     layernorm, tied) and moe_debug in float32, five steps on the card
     against five on the CPU from the same weights on the same batches:
     losses, grad norms and moe_debug's routing losses within the stated
     tolerance.

The line before the last is ``{"kernels": [...]}``; the last is
``{"ok": true, "device": {...}}``. Details go to
``chiprun_out/chip_smoke.json``.
"""

from __future__ import annotations

import asyncio
import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# one H100 SXM (NVIDIA's data sheet, dense, at its 700 W limit)
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}  # f32 off tensor cores

SOURCES = ("paged_attention", "flash_attention")
# the kernel instantiations that must run on the tensor cores
TENSOR_CORE_KERNELS = (
    tuple(f"{name}_mma_kernel<bf16, {d}>"
          for name in ("flash_fwd", "flash_dq", "flash_dkv")
          for d in (64, 128))
    + tuple(f"paged_attention_split_mma_kernel<bf16, {d}>"
            for d in (32, 64, 128, 256)))
ARENA_LEN = 2048          # serve arena per slot: 128 pages of 16 tokens
SERVE_NEW_TOKENS = 32
SPEC_K = 4                # draft tokens per speculative round
# the verify window's slot cursors: 0 to the last that fits the arena
VERIFY_LENGTHS = [0, 16, 37, 100, 255, 640, 1024, ARENA_LEN - SPEC_K - 1]
TOL = {"float32": (1e-5, 1e-5),       # atol, rtol: sum order differs
       "bfloat16": (1e-5, 2.0 ** -7)}  # at most one bf16 rounding step
# K4's (q dtype, pool dtype) pairs: one pool dtype as q's, and a pool of
# the other dtype (``cache_dtype``), which the FMA split kernel widens
K4_PAIRS = {"bfloat16": ("bfloat16", "bfloat16"),
            "float32": ("float32", "float32"),
            "float32_q_bfloat16_pool": ("float32", "bfloat16"),
            "bfloat16_q_float32_pool": ("bfloat16", "float32")}


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout
    line = out.strip().splitlines()[0]
    print(line, flush=True)
    return line


def kernel_label(mangled: str) -> str:
    """``flash_dkv_kernel<bf16, 128>`` from a mangled kernel name; the
    number is the head dim (the largest the kernel takes, for the paged
    split kernels), or the head-dim elements per lane of the paged merge
    kernel. The paged FMA split kernel names q's element type, then the
    pool's (``paged_attention_split_kernel<f32, bf16, 128>``). The
    tensor-core kernels (``*_mma_kernel<D>``) take bf16 only."""
    import re

    m = re.search(r"\d+([a-z_]+_kernel)I((?:13__nv_bfloat16|f)*)Li(\d+)E",
                  mangled)
    if not m:
        return mangled.split()[-1][:60]
    types = [{"f": "f32"}.get(t, "bf16")
             for t in re.findall(r"13__nv_bfloat16|f", m[2])] or ["bf16"]
    return f"{m[1]}<{', '.join(types)}, {m[3]}>"


def ptxas_lines(log: str) -> list:
    """One line per kernel from nvcc's ``-Xptxas -v`` output: its
    instantiation (``kernel_label``), then its registers and spills."""
    import re

    out, kernel, spill = [], None, ""
    for ln in log.splitlines():
        if "Function properties for" in ln:
            kernel = kernel_label(ln)
        elif "spill" in ln:
            spill = ln.strip()
        elif "registers" in ln and kernel:
            regs = re.search(r"Used (\d+) registers", ln)
            out.append(f"{kernel}: {regs[1] if regs else '?'} registers; "
                       f"{spill}")
            kernel, spill = None, ""
    # another layout of the output: keep its lines as they are
    return out or [ln.strip() for ln in log.splitlines()
                   if "registers" in ln or "spill" in ln]


def build_phase() -> dict:
    """Both kernel sources, one nvcc each, started together."""
    from concurrent.futures import ThreadPoolExecutor

    from ray_tpu_torch.ops import _build

    def build(name):
        t0 = time.perf_counter()
        _build.load(name)
        return time.perf_counter() - t0

    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(SOURCES)) as pool:
        seconds = dict(zip(SOURCES, pool.map(build, SOURCES)))
    out = {"seconds": time.perf_counter() - t0}
    for name in SOURCES:
        ptxas = ptxas_lines(_build.build_log.get(name, "(reused build)"))
        print(f"build: {name}.cu with nvcc for sm_90a in "
              f"{seconds[name]:.2f} s", flush=True)
        for ln in ptxas:
            print(f"  ptxas: {ln}")
        out[name] = {"seconds": seconds[name], "ptxas": ptxas}
    hmma = {}
    for name in SOURCES:
        out[name]["hmma"] = counts = hmma_counts(_build.library_path(name))
        hmma.update(counts)
        print(f"build: HMMA (tensor-core) instructions per kernel of "
              f"{name}.cu: "
              + ", ".join(f"{k} {n}" for k, n in sorted(counts.items())),
              flush=True)
    for key in TENSOR_CORE_KERNELS:
        if not hmma.get(key):
            raise AssertionError(f"{key}: no HMMA instruction in the built "
                                 "library: the kernel is off the tensor "
                                 "cores")
    return out


def hmma_counts(so: Path) -> dict:
    """HMMA instructions per kernel function in the SASS of a built
    library, read with ``cuobjdump -sass``; raises if the tool is
    missing."""
    import shutil

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([tool, "-sass", str(so)], check=True,
                          capture_output=True, text=True, timeout=300).stdout
    counts, name = {}, None
    for ln in sass.splitlines():
        if "Function :" in ln:
            name = kernel_label(ln.split("Function :", 1)[1].strip())
            counts[name] = 0
        elif name is not None and "HMMA" in ln:
            counts[name] += 1
    return counts


# --------------------------------------------------------------- kernel


def make_case(torch, dtype, S, K, lengths, *, H=32, Hkv=8, D=128, T=16,
              P=ARENA_LEN // 16, seed=0, device="cuda", pool_dtype=None):
    """Pools, page tables and queries at the given shapes, q in ``dtype``
    and the pools in ``pool_dtype`` (default: ``dtype``). Each slot owns
    the pages its length + K tokens need, scattered over the pool; table
    entries past them point at page 0, which holds 1e4."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    need = [min(P, -(-(L + K) // T)) for L in lengths]
    N = sum(need) + 1
    perm = (torch.randperm(N - 1, generator=g) + 1).int()
    tables = torch.zeros((S, P), dtype=torch.int32)
    at = 0
    for s in range(S):
        tables[s, :need[s]] = perm[at:at + need[s]]
        at += need[s]
    kp = torch.randn((N, T, Hkv, D), generator=g)
    vp = torch.randn((N, T, Hkv, D), generator=g)
    kp[0] = 1e4
    vp[0] = 1e4
    q = torch.randn((S, K, H, D), generator=g)
    pool_dtype = pool_dtype or dtype
    return dict(q=q.to(device, dtype), k_pool=kp.to(device, pool_dtype),
                v_pool=vp.to(device, pool_dtype), tables=tables.to(device),
                lengths=torch.tensor(lengths, dtype=torch.int32,
                                     device=device))


def time_ms(torch, fn, iters=20, warmup=3):
    """Mean device time of ``fn`` over ``iters`` calls, each timed with
    CUDA events after a 256 MB write that evicts the 50 MB L2, so every
    call starts from a cold cache as a layer of the model would. The card
    then spins for about 0.5 ms before the start event, so the host's time
    to enqueue ``fn`` (a Python wrapper's checks and allocations) lies
    inside the spin and not between the events."""
    flush = torch.empty(256 * 2 ** 20, dtype=torch.uint8, device="cuda")
    for _ in range(warmup):
        fn()
    total = 0.0
    for _ in range(iters):
        flush.zero_()
        torch.cuda._sleep(1_000_000)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        total += start.elapsed_time(end)
    return total / iters


def bound(case, dtype_name):
    """Least time the card could take: every input read once (only the
    pages the kernel walks, in the pool's dtype), the output written once
    (in q's), against the memory rate; the q.k and p.v products over the
    walked keys against the peak rate for ``dtype_name``, the type they
    are computed in. Returns (ms, "bytes" | "operations")."""
    q, kp, lengths = case["q"], case["k_pool"], case["lengths"]
    S, K, H, D = q.shape
    _, T, Hkv, _ = kp.shape
    P = case["tables"].shape[1]
    pages = sum(min(P, -(-(int(L) + K) // T)) for L in lengths.tolist())
    nbytes = (2 * pages * T * Hkv * D * kp.element_size()  # live k, v pages
              + 2 * q.numel() * q.element_size()           # q in, out
              + case["tables"].numel() * 4 + S * 4)
    flops = 2 * 2 * K * H * pages * T * D
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype_name] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def sdpa_call(torch, case):
    """scaled_dot_product_attention over each slot's pre-gathered,
    head-expanded contiguous view with the paged mask (built outside the
    timed call). Where the pools' dtype is not q's, q and the views are
    widened to float32 first, as the kernel widens both."""
    q, kp, vp = case["q"], case["k_pool"], case["v_pool"]
    if q.dtype != kp.dtype:
        q, kp, vp = q.float(), kp.float(), vp.float()
    tables, lengths = case["tables"].long(), case["lengths"].long()
    S, K, H, D = q.shape
    _, T, Hkv, _ = kp.shape
    n = int(((lengths.max() + K + T - 1) // T).clamp(max=tables.shape[1]))
    L = n * T
    G = H // Hkv
    kv = kp[tables[:, :n]].reshape(S, L, Hkv, D)
    vv = vp[tables[:, :n]].reshape(S, L, Hkv, D)
    kv = kv.repeat_interleave(G, dim=2).transpose(1, 2).contiguous()
    vv = vv.repeat_interleave(G, dim=2).transpose(1, 2).contiguous()
    qh = q.transpose(1, 2).contiguous()                     # [S, H, K, D]
    qpos = lengths[:, None] + torch.arange(K, device=q.device)[None]
    mask = (torch.arange(L, device=q.device)[None, None]
            <= qpos[:, :, None])[:, None]                   # [S, 1, K, L]
    f = torch.nn.functional.scaled_dot_product_attention
    return lambda: f(qh, kv, vv, attn_mask=mask)


def _plan_line(case) -> dict:
    """The kernel's split plan for a case, printed on a line of its own."""
    from ray_tpu_torch.ops.paged_attention import split_plan

    S, K, H, D = case["q"].shape
    _, T, Hkv, _ = case["k_pool"].shape
    plan = split_plan(S, K, H, Hkv, D, T, case["tables"].shape[1],
                      case["k_pool"].element_size(),
                      case["q"].element_size())
    units = "tensor cores" if plan.tensor_cores else "FMA units"
    print(f"  split plan: {plan.splits} splits of {plan.pages_per_split} "
          f"pages, {plan.row_tiles} row tiles, grid {plan.grid}, workspace "
          f"{plan.workspace}, {plan.smem_bytes} B shared memory, split "
          f"kernel on the {units}", flush=True)
    return plan._asdict()


def _window_rows_check(torch, paged_attention, case, dtype_name):
    """Row i of the case's window equals a 1-token call at length + i, bit
    for bit."""
    win = paged_attention(**case)
    for i in range(case["q"].shape[1]):
        one = paged_attention(case["q"][:, i:i + 1], case["k_pool"],
                              case["v_pool"], case["tables"],
                              case["lengths"] + i)
        if not torch.equal(win[:, i:i + 1], one):
            raise AssertionError(
                f"{dtype_name}: window row {i} at length "
                f"{case['lengths'].tolist()} differs from the 1-token call "
                f"at length + {i}")


def kernel_phase(torch) -> dict:
    from ray_tpu_torch.ops.paged_attention import (paged_attention,
                                                   paged_attention_reference)

    shapes = {
        # 8 slots, 1 token; lengths include 0 and page boundaries
        "decode": dict(S=8, K=1, lengths=[0, 16, 37, 100, 255, 640, 1024,
                                          2047]),
        # 1 slot, a 32-token prefill chunk at a cursor off a page boundary
        "prefill": dict(S=1, K=32, lengths=[45]),
        # the speculative verify window: 8 slots x (spec_k + 1) tokens
        "verify": dict(S=8, K=SPEC_K + 1, lengths=VERIFY_LENGTHS),
    }
    # 32-token windows whose rows are checked against 1-token calls; at
    # length 240 the window's positions 240-271 cross the boundary between
    # the first two 256-key splits
    windows = [dict(S=1, K=32, lengths=[45]), dict(S=1, K=32, lengths=[240]),
               shapes["verify"]]
    results = {}
    for dtype_name, (q_name, pool_name) in K4_PAIRS.items():
        dtype, pool_dtype = getattr(torch, q_name), getattr(torch, pool_name)
        atol, rtol = TOL[q_name]  # the output is in q's dtype
        # the tensor cores compute the bf16 pair, float32 FMA the others
        compute = "bfloat16" if pool_name == q_name == "bfloat16" \
            else "float32"
        for shape_name, shp in shapes.items():
            case = make_case(torch, dtype, **shp, pool_dtype=pool_dtype)
            n0 = paged_attention.launches
            got = paged_attention(**case)
            torch.cuda.synchronize()
            if paged_attention.launches != n0 + 1:
                raise AssertionError("the launch counter did not move")
            if not torch.equal(got, paged_attention(**case)):
                raise AssertionError(f"{shape_name} {dtype_name}: two calls "
                                     "differ")
            # the wrapper must not read lengths or tables on the host
            torch.cuda.set_sync_debug_mode("error")
            try:
                again = paged_attention(**case)
            finally:
                torch.cuda.set_sync_debug_mode(0)
            if not torch.equal(got, again):
                raise AssertionError(f"{shape_name} {dtype_name}: the call "
                                     "under the sync check differs")
            ref = paged_attention_reference(**case)
            err = (got.float() - ref.float()).abs()
            limit = atol + rtol * ref.float().abs()
            max_err = float(err.max())
            if not bool((err <= limit).all()):
                raise AssertionError(
                    f"{shape_name} {dtype_name}: kernel disagrees with its "
                    f"plain version (max |err| {max_err:.3e})")
            if not torch.isfinite(got).all():
                raise AssertionError(f"{shape_name} {dtype_name}: non-finite")
            print(f"kernel {shape_name} {dtype_name}: max|err| "
                  f"{max_err:.3e} (tol {atol:g} + {rtol:g}*|ref|); two "
                  "calls bitwise equal; no host sync in the call",
                  flush=True)
            plan = _plan_line(case)
            sdpa = sdpa_call(torch, case)
            sdpa_err = float((sdpa().transpose(1, 2).float()
                              - ref.float()).abs().max())
            ms = time_ms(torch, lambda: paged_attention(**case))
            plain_ms = time_ms(torch,
                               lambda: paged_attention_reference(**case))
            library_ms = time_ms(torch, sdpa)
            bound_ms, bound_by = bound(case, compute)
            r = dict(max_abs_err=max_err, atol=atol, rtol=rtol, ms=ms,
                     plain_ms=plain_ms, library_ms=library_ms,
                     bound_ms=bound_ms, bound_by=bound_by,
                     sdpa_max_abs_err=sdpa_err, plan=plan)
            results[f"{shape_name}_{dtype_name}"] = r
            print(f"  times: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
                  f"sdpa {library_ms:.4f} ms, bound {bound_ms:.5f} ms "
                  f"({bound_by})", flush=True)
        # row i of a 32-token window == a 1-token call at length + i
        for shp in windows:
            _window_rows_check(torch, paged_attention,
                               make_case(torch, dtype, **shp, seed=1,
                                         pool_dtype=pool_dtype),
                               dtype_name)
        print(f"kernel {dtype_name}: every row of the 32-token windows at "
              f"lengths 45 and 240 and of the {SPEC_K + 1}-token verify "
              f"windows at lengths {VERIFY_LENGTHS} equals a 1-token call "
              "bit for bit", flush=True)
    # a pair the kernels have no entry for raises; nothing falls back
    case = make_case(torch, torch.float16, **shapes["decode"])
    try:
        paged_attention(**case)
    except TypeError:
        pass
    else:
        raise AssertionError("K4 ran a float16 call")
    return results


# --------------------------------------------------------- flash kernels

FLASH_CASES = {
    "gpt2_small": dict(B=16, S=1024, H=12, Hkv=12, D=64, causal=True),
    "gpt_1b": dict(B=4, S=1024, H=16, Hkv=8, D=128, causal=True),
    "group4": dict(B=1, S=2048, H=32, Hkv=8, D=128, causal=True),
    "ragged": dict(B=2, S=1000, H=12, Hkv=4, D=64, causal=True),
    "full": dict(B=2, S=512, H=16, Hkv=8, D=128, causal=False),
}
# Per element, |kernel - plain| <= atol + rtol * |plain|, with atol a
# fraction of the plain output's RMS (the size of a typical element):
#  * O in bf16: rtol one bf16 step (2^-7), as both sides round O to bf16;
#    atol 0.04 x RMS for P, which the kernel rounds to bf16 against the
#    running row max and the plain version against the final one.
#  * dQ, dK and dV in bf16 (tensor-core K2 and K3): rtol one bf16 step, as
#    the sums run in another order and the result may round to the
#    neighbouring bf16 value. A P or dS whose float32 value differs by a
#    rounding on the two sides now and then rounds to neighbouring bf16
#    values before its product, and moves a few elements by much more. Two
#    correct plain versions differ so too: each run computes the plain dQ,
#    dK and dV with their float32 steps in float64 (``_dq_float64``,
#    ``_dkv_float64``), records how far they lie from the float32 ones,
#    and fails if the gate refuses them. So atol is 0.25 x RMS, which holds
#    off gross faults only, and the whole tensor must also lie within 2e-3
#    of the plain one in relative L2 norm, which a bias of 2% (2e-2) breaks
#    tenfold; PERF.md has the measured shares.
#  * O, dQ, dK and dV in float32: the float32 gate, 1e-5 x RMS and 1e-5.
#    In O only the order of the sums differs; the float32 K2 and K3 run the
#    same sequential float32 FMA chains as their plain versions and agree
#    with them bit for bit.
# Each run also checks that the gates refuse an O 2% off on the rows past
# the first key tile, and a dQ, a dK and a dV 2% off.
# lse is float32 on both sides, from the same scores: an absolute tolerance.
F32_GATE = (1e-5, 1e-5)  # (atol / RMS of the plain output, rtol)
FLASH_TOL = {("o", "bfloat16"): (0.04, 2.0 ** -7),
             ("dq", "bfloat16"): (0.25, 2.0 ** -7),
             ("dk", "bfloat16"): (0.25, 2.0 ** -7),
             ("dv", "bfloat16"): (0.25, 2.0 ** -7)}
# relative L2 gates: ||kernel - plain|| <= l2 x ||plain||
FLASH_L2 = {("dq", "bfloat16"): 2e-3, ("dk", "bfloat16"): 2e-3,
            ("dv", "bfloat16"): 2e-3}
# the first row a 2%-off copy scales
OFF_FROM_ROW = {"o": 64, "dq": 0, "dk": 0, "dv": 0}
LSE_ATOL = 1e-4


def flash_inputs(torch, case, dtype, seed=0):
    g = torch.Generator(device="cpu").manual_seed(seed)
    B, S, H, Hkv, D = (case[k] for k in ("B", "S", "H", "Hkv", "D"))
    q, do = (torch.randn((B, S, H, D), generator=g) for _ in range(2))
    k, v = (torch.randn((B, S, Hkv, D), generator=g) for _ in range(2))
    return [t.to("cuda", dtype) for t in (q, k, v, do)]


def flash_bounds(case, dtype_name, item):
    """(ms, "bytes" | "operations") for K1, K2, K3: every input read once,
    every output written once, against the memory rate; 4 B H D flops per
    visible (query, key) pair for K1 (q.k and p.v), 1.5x that for K2 and 2x
    for K3, against the peak rate for the inputs' type."""
    B, S, H, Hkv, D = (case[k] for k in ("B", "S", "H", "Hkv", "D"))
    pairs = S * (S + 1) // 2 if case["causal"] else S * S
    fwd_flops = 4 * B * H * D * pairs
    qb, kvb, rows = B * S * H * D * item, B * S * Hkv * D * item, B * H * S * 4
    work = {"fwd": (fwd_flops, 2 * qb + 2 * kvb + rows),
            "dq": (1.5 * fwd_flops, 3 * qb + 2 * kvb + 2 * rows),
            "dkv": (2 * fwd_flops, 2 * qb + 4 * kvb + 2 * rows)}
    out = {}
    for name, (flops, nbytes) in work.items():
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = flops / PEAK_FLOPS[dtype_name] * 1e3
        out[name] = ((t_bytes, "bytes") if t_bytes >= t_ops
                     else (t_ops, "operations"))
    return out


def _flash_err(got, ref, atol_rms, rtol, l2=None):
    """(max |got - ref|, relative L2 error, the largest share of a gate
    used: the per-element gate's, and the L2 gate's where there is one)."""
    got, ref = got.float(), ref.float()
    err = (got - ref).abs()
    norm = max(float(ref.norm()), 1e-30)
    atol = atol_rms * norm / ref.numel() ** 0.5  # atol_rms x RMS
    rel_l2 = float(err.norm()) / norm
    used = float((err / (atol + rtol * ref.abs())).max())
    if l2 is not None:
        used = max(used, rel_l2 / l2)
    return float(err.max()), rel_l2, used


def _gate(key, dtype_name) -> dict:
    """The gate of output ``key`` ("o", "dq", "dk", "dv") in a dtype:
    ``<key>_atol_rms``, ``<key>_rtol`` and ``<key>_l2`` (None: no L2
    part)."""
    atol_rms, rtol = FLASH_TOL.get((key, dtype_name), F32_GATE)
    return {f"{key}_atol_rms": atol_rms, f"{key}_rtol": rtol,
            f"{key}_l2": FLASH_L2.get((key, dtype_name))}


def _gate_err(got, ref, key, gate):
    """``_flash_err`` of ``got`` against ``ref`` under ``key``'s gate."""
    return _flash_err(got, ref, gate[f"{key}_atol_rms"], gate[f"{key}_rtol"],
                      gate[f"{key}_l2"])


def _off_gate_used(got, ref, key, gate) -> float:
    """The share of ``key``'s gate used by ``got`` 2% off from row
    ``OFF_FROM_ROW[key]`` on."""
    off = got.float().clone()
    off[:, OFF_FROM_ROW[key]:] *= 1.02
    return _gate_err(off, ref, key, gate)[2]


def _plain64_shares(key, alt, ref, gate) -> dict:
    """How far the plain version run in float64 (``alt``) lies from the
    float32 one (``ref``): max |err| over RMS, relative L2 and the share of
    ``key``'s gate it uses."""
    err, rel_l2, used = _gate_err(alt, ref, key, gate)
    rms = float(ref.float().square().mean().sqrt())
    return {f"{key}_plain64_max_err_rms": err / rms,
            f"{key}_plain64_rel_l2": rel_l2,
            f"{key}_plain64_gate_used": used}


def _p_ds_float64(torch, fa, q, k, v, do, lse, delta, causal):
    """P and dS of the plain backward with its float32 steps in float64,
    for Sq == Sk; and q, dO as float64 [B, S, Hkv, G, D]."""
    B, S, H, D = q.shape
    Hkv = k.shape[2]
    f64 = torch.float64
    scale = 1.0 / math.sqrt(D)
    qg = q.reshape(B, S, Hkv, H // Hkv, D).to(f64)
    dog = do.reshape(B, S, Hkv, H // Hkv, D).to(f64)

    def rows(t):  # [B, H, S] -> [B, Hkv, G, S, 1]
        return t.to(f64).reshape(B, Hkv, H // Hkv, S, 1)

    s = torch.einsum("bqhgd,bkhd->bhgqk", qg, k.to(f64)) * scale
    if causal:
        pos = torch.arange(S, device=q.device)
        s = s.masked_fill(pos[:, None] < pos[None, :], fa.NEG_INF)
    p = torch.exp(s - rows(lse))
    dp = torch.einsum("bqhgd,bkhd->bhgqk", dog, v.to(f64))
    ds = p * (dp - rows(delta)) * scale
    return p, ds, qg, dog


def _dq_float64(torch, fa, q, k, v, do, lse, delta, causal):
    """``flash_dq_reference`` with its float32 steps in float64 (dS still
    rounded to k's dtype before dS.K), for Sq == Sk."""
    _, ds, _, _ = _p_ds_float64(torch, fa, q, k, v, do, lse, delta, causal)
    dq = torch.einsum("bhgqk,bkhd->bqhgd", ds.to(k.dtype).to(torch.float64),
                      k.to(torch.float64))
    return dq.reshape(q.shape).to(q.dtype)


def _dkv_float64(torch, fa, q, k, v, do, lse, delta, causal):
    """``flash_dkv_reference`` with its float32 steps in float64 (P and dS
    still rounded to the operands' dtype before their products), for
    Sq == Sk."""
    p, ds, qg, dog = _p_ds_float64(torch, fa, q, k, v, do, lse, delta,
                                   causal)
    f64 = torch.float64
    dv = torch.einsum("bhgqk,bqhgd->bkhd", p.to(do.dtype).to(f64), dog)
    dk = torch.einsum("bhgqk,bqhgd->bkhd", ds.to(q.dtype).to(f64), qg)
    return dk.to(k.dtype), dv.to(v.dtype)


def flash_kernel_phase(torch, cases=None, timed=True) -> dict:
    """K1, K2 and K3 against their plain versions on the card, bf16 and
    float32; K2 and K3 twice, bit for bit; times of each kernel, its plain
    version, the library yardstick (SDPA forward for K1; the autograd
    backward of that same call for K2 and K3 together) and the bound."""
    import torch.nn.functional as F

    from ray_tpu_torch.ops import flash_attention as fa

    results = {}
    for dtype_name in ("bfloat16", "float32"):
        dtype = getattr(torch, dtype_name)
        for name in cases or FLASH_CASES:
            case = FLASH_CASES[name]
            causal = case["causal"]
            q, k, v, do = flash_inputs(torch, case, dtype)
            n0 = [f.launches for f in fa.KERNELS]
            o, lse = fa.flash_forward(q, k, v, causal=causal)
            delta = fa.delta_rows(do, o)
            dq = fa.flash_dq(q, k, v, do, lse, delta, causal=causal)
            dq2 = fa.flash_dq(q, k, v, do, lse, delta, causal=causal)
            dk, dv = fa.flash_dkv(q, k, v, do, lse, delta, causal=causal)
            dk2, dv2 = fa.flash_dkv(q, k, v, do, lse, delta, causal=causal)
            torch.cuda.synchronize()
            if [f.launches - n for f, n in zip(fa.KERNELS, n0)] != [1, 2, 2]:
                raise AssertionError("the flash launch counters did not move")
            if not torch.equal(dq, dq2):
                raise AssertionError(f"{name} {dtype_name}: two runs of K2 "
                                     "differ")
            if not (torch.equal(dk, dk2) and torch.equal(dv, dv2)):
                raise AssertionError(f"{name} {dtype_name}: two runs of K3 "
                                     "differ")
            o_ref, lse_ref = fa.flash_forward_reference(q, k, v,
                                                        causal=causal)
            dq_ref = fa.flash_dq_reference(q, k, v, do, lse, delta,
                                           causal=causal)
            dk_ref, dv_ref = fa.flash_dkv_reference(q, k, v, do, lse, delta,
                                                    causal=causal)
            r = {"lse_atol": LSE_ATOL}
            for key, got, ref in (("o", o, o_ref), ("dq", dq, dq_ref),
                                  ("dk", dk, dk_ref), ("dv", dv, dv_ref)):
                if not torch.isfinite(got).all():
                    raise AssertionError(f"{name} {dtype_name}: {key} is "
                                         "not finite")
                r.update(_gate(key, dtype_name))
                err, rel_l2, used = _gate_err(got, ref, key, r)
                r[f"{key}_max_abs_err"], r[f"{key}_gate_used"] = err, used
                r[f"{key}_rel_l2"] = rel_l2
                if not used <= 1.0:
                    raise AssertionError(
                        f"{name} {dtype_name}: {key} kernel disagrees with "
                        f"its plain version: it uses {used:.3g} x its "
                        f"tolerance {r[f'{key}_atol_rms']:g} x RMS + "
                        f"{r[f'{key}_rtol']:g} x |ref| per element (max "
                        f"|err| {err:.3e}), relative L2 {rel_l2:.2e} (gate "
                        f"{r[f'{key}_l2']})")
            for key, got, ref in (("o", o, o_ref), ("dq", dq, dq_ref),
                                  ("dk", dk, dk_ref), ("dv", dv, dv_ref)):
                used = _off_gate_used(got, ref, key, r)
                r[f"{key}_2pct_off_gate_used"] = used
                if not used > 1.0:
                    raise AssertionError(f"{name} {dtype_name}: the {key} "
                                         f"tolerance lets a {key} 2% off "
                                         "pass")
            if ("dk", dtype_name) in FLASH_L2:
                # the gate must admit a second correct version: the plain
                # one with its float32 steps in float64
                alts = ((_dq_float64(torch, fa, q, k, v, do, lse, delta,
                                     causal),)
                        + _dkv_float64(torch, fa, q, k, v, do, lse, delta,
                                       causal))
                for key, alt, ref in zip(("dq", "dk", "dv"), alts,
                                         (dq_ref, dk_ref, dv_ref)):
                    r.update(_plain64_shares(key, alt, ref, r))
                    if not r[f"{key}_plain64_gate_used"] <= 1.0:
                        raise AssertionError(
                            f"{name} {dtype_name}: the {key} gate refuses "
                            "the plain version run in float64")
                del alts
            r["lse_max_abs_err"] = float((lse - lse_ref).abs().max())
            if not r["lse_max_abs_err"] <= LSE_ATOL:
                raise AssertionError(f"{name} {dtype_name}: lse differs by "
                                     f"{r['lse_max_abs_err']:.3e}")
            print(f"flash {name} {dtype_name}: max|err| (share of its "
                  f"tolerance) o {r['o_max_abs_err']:.2e} "
                  f"({r['o_gate_used']:.2f}), dq {r['dq_max_abs_err']:.2e} "
                  f"({r['dq_gate_used']:.2f}), dk {r['dk_max_abs_err']:.2e} "
                  f"({r['dk_gate_used']:.2f}), dv {r['dv_max_abs_err']:.2e} "
                  f"({r['dv_gate_used']:.2f}), lse "
                  f"{r['lse_max_abs_err']:.2e}; relative L2 dq "
                  f"{r['dq_rel_l2']:.2e}, dk {r['dk_rel_l2']:.2e}, dv "
                  f"{r['dv_rel_l2']:.2e}; 2% off uses o "
                  f"{r['o_2pct_off_gate_used']:.1f}, dq "
                  f"{r['dq_2pct_off_gate_used']:.1f}, dk "
                  f"{r['dk_2pct_off_gate_used']:.1f}, dv "
                  f"{r['dv_2pct_off_gate_used']:.1f}; K2 and K3 bitwise "
                  "equal twice", flush=True)
            if "dk_plain64_gate_used" in r:
                print("  the plain version in float64 against float32: "
                      + ", ".join(
                          f"{key} max|err| "
                          f"{r[f'{key}_plain64_max_err_rms']:.3f} x RMS, "
                          f"relative L2 {r[f'{key}_plain64_rel_l2']:.2e}, "
                          f"{r[f'{key}_plain64_gate_used']:.2f} of the gate"
                          for key in ("dq", "dk", "dv")), flush=True)
            del o_ref, lse_ref, dq_ref, dk_ref, dv_ref, dq2, dk2, dv2
            if timed:
                r.update(_flash_times(torch, F, fa, case, dtype_name,
                                      (q, k, v, do, lse, delta)))
            results[f"{name}_{dtype_name}"] = r
            torch.cuda.empty_cache()
    return results


def _flash_times(torch, F, fa, case, dtype_name, inputs) -> dict:
    q, k, v, do, lse, delta = inputs
    causal = case["causal"]
    gqa = case["H"] != case["Hkv"]
    qh, kh, vh, doh = (t.transpose(1, 2).contiguous().requires_grad_(True)
                       for t in (q, k, v, do))
    out = F.scaled_dot_product_attention(qh, kh, vh, is_causal=causal,
                                         enable_gqa=gqa)
    calls = {
        "fwd": (lambda: fa.flash_forward(q, k, v, causal=causal),
                lambda: fa.flash_forward_reference(q, k, v, causal=causal)),
        "dq": (lambda: fa.flash_dq(q, k, v, do, lse, delta, causal=causal),
               lambda: fa.flash_dq_reference(q, k, v, do, lse, delta,
                                             causal=causal)),
        "dkv": (lambda: fa.flash_dkv(q, k, v, do, lse, delta, causal=causal),
                lambda: fa.flash_dkv_reference(q, k, v, do, lse, delta,
                                               causal=causal)),
    }
    with torch.no_grad():
        sdpa_fwd = time_ms(torch, lambda: F.scaled_dot_product_attention(
            qh, kh, vh, is_causal=causal, enable_gqa=gqa))
    sdpa_bwd = time_ms(torch, lambda: torch.autograd.grad(
        out, (qh, kh, vh), doh, retain_graph=True))
    bounds = flash_bounds(case, dtype_name, q.element_size())
    r = {}
    for name, (kernel, plain) in calls.items():
        r[f"{name}_ms"] = time_ms(torch, kernel)
        r[f"{name}_plain_ms"] = time_ms(torch, plain, iters=5, warmup=1)
        r[f"{name}_bound_ms"], r[f"{name}_bound_by"] = bounds[name]
    r["fwd_library_ms"] = sdpa_fwd
    r["dq_library_ms"] = r["dkv_library_ms"] = sdpa_bwd  # one call, the pair
    print(f"  times: K1 {r['fwd_ms']:.3f} ms (plain {r['fwd_plain_ms']:.3f}, "
          f"sdpa {sdpa_fwd:.3f}, bound {r['fwd_bound_ms']:.4f} "
          f"{r['fwd_bound_by']}); K2 {r['dq_ms']:.3f} ms (plain "
          f"{r['dq_plain_ms']:.3f}, bound {r['dq_bound_ms']:.4f}); K3 "
          f"{r['dkv_ms']:.3f} ms (plain {r['dkv_plain_ms']:.3f}, bound "
          f"{r['dkv_bound_ms']:.4f}); sdpa backward (K2 + K3) "
          f"{sdpa_bwd:.3f} ms", flush=True)
    return r


# ---------------------------------------------------------------- train

TRAIN_STEPS = 5
# device kernels by the first group whose key is in the kernel's name
KERNEL_GROUPS = (
    ("flash", ("flash_fwd", "flash_dq", "flash_dkv")),
    ("gemm", ("nvjet", "gemm", "cutlass", "xmma", "cublas")),
    ("copy_cast", ("copy", "Memcpy", "Memset")),
    ("reduce", ("reduce", "norm")),
    ("elementwise", ("elementwise", "index", "scatter", "gather")),
)
# card against CPU, float32, five steps on the same weights and batches:
# relative, losses and grad norms (the flash kernels and the CPU's plain
# versions sum in another order; Adam carries the difference forward)
TRAIN_PARITY_RTOL = 1e-4


def _reset_counters(fa):
    for f in fa.KERNELS:
        f.launches = 0


def train_run(torch, cfg, B, S, steps, profile=False) -> dict:
    """``init_train_state`` + ``make_train_step`` on the card: one warm-up
    step, then ``steps`` counted steps on one batch of random tokens; the
    flash launch counters go to 0 just before the counted steps."""
    from ray_tpu_torch import (OptimizerConfig, init_train_state,
                               make_train_step)
    from ray_tpu_torch.models.transformer import count_params
    from ray_tpu_torch.ops import flash_attention as fa

    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    state, tx = init_train_state(
        cfg, OptimizerConfig(warmup_steps=10, decay_steps=1000), seed=0)
    step = make_train_step(cfg, tx)
    g = torch.Generator(device="cuda").manual_seed(1)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (B, S), generator=g,
                                     device="cuda")}
    state, m = step(state, batch)  # warm-up: cuBLAS handles, allocator
    first_loss = float(m["loss"])
    setup_s = time.perf_counter() - t0
    _reset_counters(fa)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    metrics = []
    for _ in range(steps):
        state, m = step(state, batch)
        metrics.append(m)
    torch.cuda.synchronize()
    dt = (time.perf_counter() - t1) / steps
    launches = {f.__name__: f.launches for f in fa.KERNELS}
    losses = [float(m["loss"]) for m in metrics]
    norms = [float(m["grad_norm"]) for m in metrics]
    L = cfg.num_layers
    fwd_per_step = 2 * L if cfg.remat else L  # remat runs K1 again
    want = {"flash_forward": fwd_per_step * steps,
            "flash_dq": L * steps, "flash_dkv": L * steps}
    if launches != want:
        raise AssertionError(f"flash launches {launches}, expected {want} "
                             f"({L} layers x {steps} steps, remat "
                             f"{cfg.remat} {cfg.remat_policy})")
    finite = [x for x in losses + norms if not math.isfinite(x)]
    if finite or not math.isfinite(first_loss):
        raise AssertionError(f"non-finite losses or grad norms: {losses} "
                             f"{norms}")
    n_params = count_params(state.params)
    flops_per_token = 6 * n_params + 12 * L * S * cfg.embed_dim
    r = dict(layers=L, embed_dim=cfg.embed_dim, vocab=cfg.vocab_size,
             batch=B, seq=S, remat=cfg.remat, remat_policy=cfg.remat_policy,
             ce_chunk=cfg.ce_chunk, steps=steps, params=n_params,
             setup_s=setup_s, warmup_loss=first_loss, losses=losses,
             grad_norms=norms, step_ms=dt * 1e3,
             tokens_per_s=B * S / dt,
             mfu=flops_per_token * B * S / dt / PEAK_FLOPS["bfloat16"],
             launches=launches,
             peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
    if profile:
        r["profile"] = profile_train_step(torch, step, state, batch)
    return r


def profile_train_step(torch, step, state, batch) -> dict:
    """One train step under torch.profiler: device kernel time by kernel
    against the host clock over the step."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step(state, batch)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            n, us = kernels.get(e.name, (0, 0.0))
            kernels[e.name] = (n + 1, us + e.time_range.elapsed_us())
    busy_ms = sum(us for _, us in kernels.values()) / 1e3
    top = sorted(kernels.items(), key=lambda kv: -kv[1][1])[:10]
    groups, flash = {}, {}
    for name, (n, us) in kernels.items():
        group = next((g for g, keys in KERNEL_GROUPS
                      if any(k in name for k in keys)), "other")
        c, ms = groups.get(group, (0, 0.0))
        groups[group] = (c + n, ms + us / 1e3)
        if group == "flash":  # "void (anonymous namespace)::<kernel>(..."
            flash[name.split("::", 1)[-1].split("(", 1)[0]] = dict(
                count=n, ms=us / 1e3)
    r = dict(wall_ms=wall * 1e3,
             device_busy_ms=busy_ms if kernels else None,
             kernel_launches=sum(n for n, _ in kernels.values()),
             groups={g: dict(count=n, ms=ms) for g, (n, ms) in
                     sorted(groups.items(), key=lambda kv: -kv[1][1])},
             flash=flash,
             top=[dict(name=k[:90], count=n, ms=us / 1e3)
                  for k, (n, us) in top])
    if kernels:
        print(f"profile: one train step in {r['wall_ms']:.1f} ms wall "
              f"(profiled); device kernels busy {busy_ms:.1f} ms "
              f"({100 * busy_ms / r['wall_ms']:.1f}%), "
              f"{r['kernel_launches']} device kernels; by group: "
              + ", ".join(f"{g} {v['ms']:.1f} ms ({v['count']}x)"
                          for g, v in r["groups"].items()), flush=True)
        print("  flash: " + ", ".join(f"{k} {v['ms']:.2f} ms ({v['count']}x)"
                                      for k, v in sorted(flash.items())))
        for t in r["top"]:
            print(f"  {t['ms']:9.3f} ms {t['count']:6d}x  {t['name']}")
    else:
        print("profile: the profiler saw no device kernels (not measured)")
    return r


def _print_train(name, r):
    print(f"train {name}: {r['layers']} layers, d={r['embed_dim']}, vocab "
          f"{r['vocab']}, B{r['batch']} x S{r['seq']}, remat "
          f"{r['remat'] and r['remat_policy']}, {r['params'] / 1e6:.1f}M "
          f"params: {r['steps']} steps, {r['step_ms']:.1f} ms/step, "
          f"{r['tokens_per_s']:.0f} tokens/s, MFU {100 * r['mfu']:.2f}% of "
          f"bf16 dense peak; losses {[round(x, 4) for x in r['losses']]}, "
          f"grad norms {[round(x, 3) for x in r['grad_norms']]}; flash "
          f"launches {r['launches']}; peak memory {r['peak_mem_gb']:.1f} GB",
          flush=True)


# the fused CE in bf16 against float64 on the same bf16 operands, token by
# token: relative
CE_RTOL = 1e-5


def ce_precision_check(torch) -> dict:
    """The fused CE with bf16 operands at gpt2_small's width and vocab, one
    8192-token chunk with logits of a trained model's scale (std ~4): the
    loss of each of 8 tokens (a one-token mask) against float64 on the same
    operands. The chunk's logits must be the product's float32 result, as
    JAX keeps them; beside it, for the record, the losses from logits
    rounded to bf16. (Over the mean of many tokens the rounding averages
    out, so single tokens are checked.)"""
    from ray_tpu_torch.ops.losses import fused_softmax_cross_entropy

    n, V, D = 8192, 50257, 768
    g = torch.Generator(device="cuda").manual_seed(5)
    x = torch.randn((n, D), generator=g, device="cuda").bfloat16()
    w = (torch.randn((V, D), generator=g, device="cuda") * 0.15).bfloat16()
    labels = torch.randint(0, V, (n,), generator=g, device="cuda")
    picks = torch.randperm(n, generator=torch.Generator().manual_seed(6))[:8]

    def per_token(logits):
        lab = logits.gather(-1, labels[:, None])[:, 0]
        return (torch.logsumexp(logits, -1) - lab)[picks.cuda()].tolist()

    ref = per_token(x.double() @ w.double().T)
    rounded = per_token((x @ w.T).double())
    got = []
    for t in picks.tolist():
        mask = torch.zeros(n, device="cuda")
        mask[t] = 1.0
        got.append(float(fused_softmax_cross_entropy(
            x, w.float(), labels, mask, chunk=n)[0]))
    rel = max(abs(a - b) / abs(b) for a, b in zip(got, ref))
    rel_bf16 = max(abs(a - b) / abs(b) for a, b in zip(rounded, ref))
    r = dict(tokens=picks.tolist(), loss=got, float64=ref, bf16_logits=rounded,
             max_rel_err=rel, bf16_logits_max_rel_err=rel_bf16, rtol=CE_RTOL)
    print(f"CE precision: bf16 operands, {n} x {V} x {D}, the losses of 8 "
          f"tokens against float64: within {rel:.2e} (rtol {CE_RTOL:g}); "
          f"from bf16-rounded logits {rel_bf16:.2e}", flush=True)
    if not rel <= CE_RTOL:
        raise AssertionError("the fused CE's logits lost float32 precision")
    return r


def train_phase(torch) -> dict:
    """gpt2_small at full width and depth, B16 x S1024, remat off, chunk
    8192 (the first candidate of bench.py); one step of it under the
    default full remat; gpt_1b at full width, 4 of its 16 layers, under
    the 'dots' policy (its first bench.py candidate)."""
    from ray_tpu_torch import presets

    out = {"ce_precision": ce_precision_check(torch)}
    torch.cuda.empty_cache()
    runs = {
        "gpt2_small": (presets.gpt2_small(remat=False, ce_chunk=8192), 16,
                       1024, TRAIN_STEPS, True),
        "gpt2_small_remat_full": (presets.gpt2_small(ce_chunk=8192), 16,
                                  1024, 1, False),
        "gpt_1b_4_layers": (presets.gpt_1b(num_layers=4, remat_policy="dots",
                                           ce_chunk=8192), 4, 1024,
                            TRAIN_STEPS, True),
    }
    for name, (cfg, B, S, steps, prof) in runs.items():
        out[name] = r = train_run(torch, cfg, B, S, steps, profile=prof)
        _print_train(name, r)
        if name != "gpt2_small_remat_full" and not (
                r["losses"][-1] < r["warmup_loss"]):
            raise AssertionError(f"{name}: the loss did not go down")
        torch.cuda.empty_cache()
    return out


def train_parity_phase(torch) -> dict:
    """llama_debug, a tiny GPT-2 (learned positions, layernorm, tied
    embeddings) and moe_debug in float32: five steps of the port on the
    card against five on the CPU, from the same weights on the same
    batches; for moe_debug the routing loss too, which must be finite."""
    from ray_tpu_torch import (OptimizerConfig, init_train_state,
                               make_train_step, presets)
    from ray_tpu_torch.models.transformer import init_params
    from ray_tpu_torch.ops import flash_attention as fa

    configs = {
        "llama_debug": presets.llama_debug(ce_chunk=32),
        "gpt2_tiny": presets.gpt2_small(vocab_size=300, num_layers=2,
                                        embed_dim=64, num_heads=4,
                                        max_seq_len=64, dtype=torch.float32,
                                        ce_chunk=32),
        "moe_debug": presets.moe_debug(ce_chunk=32),
    }
    ocfg = OptimizerConfig(learning_rate=1e-2, warmup_steps=2,
                           decay_steps=6)
    out = {}
    for name, cfg in configs.items():
        host = init_params(cfg, seed=3, device="cpu",
                           param_dtype=torch.float32)
        g = torch.Generator(device="cpu").manual_seed(4)
        batches = [{"tokens": torch.randint(0, cfg.vocab_size, (2, 48),
                                            generator=g)}
                   for _ in range(TRAIN_STEPS)]
        runs = {}
        for dev in ("cuda", "cpu"):
            _reset_counters(fa)
            state, tx = init_train_state(cfg, ocfg, device=dev, params=host)
            step = make_train_step(cfg, tx)
            ms = [step(state, b)[1] for b in batches]
            runs[dev] = tuple([float(m[k]) for m in ms] for k in (
                "loss", "grad_norm", "moe_aux") if k in ms[0])
            if dev == "cuda" and fa.flash_dkv.launches == 0:
                raise AssertionError("the card run did not use the kernels")
        if not all(math.isfinite(x) for x in sum(runs["cuda"], [])):
            raise AssertionError(f"{name}: non-finite metrics {runs}")
        rel = max(abs(a - b) / abs(b) for x, y in zip(runs["cuda"],
                                                      runs["cpu"])
                  for a, b in zip(x, y))
        out[name] = dict(card=runs["cuda"], cpu=runs["cpu"], max_rel=rel,
                         rtol=TRAIN_PARITY_RTOL)
        what = ("losses, grad norms and routing losses"
                if len(runs["cpu"]) > 2 else "losses and grad norms")
        print(f"train parity {name}: float32, {TRAIN_STEPS} steps, {what} "
              f"card vs CPU within {rel:.2e} (rtol "
              f"{TRAIN_PARITY_RTOL:g}); losses "
              f"{[round(x, 5) for x in runs['cuda'][0]]}", flush=True)
        if not rel <= TRAIN_PARITY_RTOL:
            raise AssertionError(f"{name}: card and CPU training differ: "
                                 f"{runs}")
    return out


# ---------------------------------------------------------------- serve


async def _stream(srv, req):
    t0 = time.perf_counter()
    ttft, pieces = None, []
    async for piece in await srv(dict(req, stream=True)):
        if ttft is None:
            ttft = time.perf_counter() - t0
        pieces.append(piece)
    return ttft, pieces


SYSTEM_PROMPT = ("You are a careful assistant for a distributed systems "
                 "team. Answer briefly and precisely. Question: ")
SAMPLED = 5  # the serve requests' one request sampled at temperature 0.7


def _ids_text(ids) -> str:
    """The llama3_8b servers' detokenizer: each token as ``<id>``, so a
    text is its token sequence (the byte tokenizer folds 128256 ids onto
    256 bytes)."""
    return "".join(f"<{int(i)}>" for i in ids)


def _text_ids(text: str) -> list:
    return [int(t) for t in text[1:-1].split("><")] if text else []


def _llama3_8b_server(torch, name, **kw):
    """``LLMServerImpl`` of llama3_8b at full width and depth on the card,
    random bf16 weights from seed 0 (or ``params_loader``'s); prints its
    shape and set-up time."""
    from ray_tpu_torch import LLMServerImpl

    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    srv = LLMServerImpl(preset="llama3_8b", arena_len=ARENA_LEN,
                        max_new_tokens=SERVE_NEW_TOKENS,
                        detokenize=_ids_text, **kw)
    torch.cuda.synchronize()
    cfg = srv.cfg
    st = srv.scheduler_stats()
    arena = (f"scheduler {st['mode']}, max batch {st['max_batch_size']}"
             if st["mode"] == "batch" else
             f"{st['kv_layout']} arena, slots {st['slots']}, pages "
             f"{st.get('num_pages', 0)}, lane {st.get('attn_lane')}")
    print(f"{name}: llama3_8b, {cfg.num_layers} layers, d={cfg.embed_dim}"
          f", vocab {cfg.vocab_size}, {cfg.dtype}, arena_len "
          f"{ARENA_LEN}, {arena}; ready in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    return srv


def _serve_prompts() -> list:
    """The serve phases' 12 prompts: ~140 byte tokens each, sharing a
    ~123-token prefix."""
    return [SYSTEM_PROMPT + f"what does step {i} of the plan do?"
            for i in range(12)]


def _serve_requests(srv, batch: bool = False):
    """A warm-up request, then the 12 requests that share a prefix:
    streamed (request 5 sampled at 0.7) through the continuous scheduler;
    whole, all at temperature 0 (the batch path refuses a per-request
    temperature), through the batch scheduler, whose TTFT is each
    request's completion. The K4 launch counter is set to 0 just before
    the 12 and read just after. Returns (texts, TTFTs, wall seconds, K4
    launches, stats before, stats after)."""
    from ray_tpu_torch.ops.paged_attention import paged_attention

    asyncio.run(srv({"prompt": "warm up", "max_new_tokens": 2}))
    reqs = [{"prompt": p} for p in _serve_prompts()]
    if not batch:
        reqs[SAMPLED]["temperature"] = 0.7
    before = srv.scheduler_stats()

    async def whole(req):
        t0 = time.perf_counter()
        out = await srv(req)
        return time.perf_counter() - t0, [out["text"]]

    async def go():
        return await asyncio.gather(*[whole(r) if batch else _stream(srv, r)
                                      for r in reqs])

    paged_attention.launches = 0
    paged_attention.pair_launches.clear()
    t1 = time.perf_counter()
    outs = asyncio.run(go())
    wall = time.perf_counter() - t1
    launches = paged_attention.launches
    st = srv.scheduler_stats()
    texts = ["".join(pieces) for _, pieces in outs]
    return texts, [t for t, _ in outs], wall, launches, before, st


def _check_paged_run(texts, st) -> None:
    """The serve and spec-serve phases' requests each returned all their
    tokens, through the kernel's lane."""
    for i, text in enumerate(texts):
        n = len(_text_ids(text))
        if n != SERVE_NEW_TOKENS:
            raise AssertionError(f"request {i} returned {n} tokens, not "
                                 f"{SERVE_NEW_TOKENS}")
    if st["attn_lane"] != "cuda":
        raise AssertionError(f"attn_lane is {st['attn_lane']!r}")


def serve_phase(torch) -> dict:
    srv = _llama3_8b_server(torch, "serve")
    try:
        cfg = srv.cfg
        texts, ttfts, wall, launches, before, st = _serve_requests(srv)
        prof = profile_decode(torch, srv, SYSTEM_PROMPT)
    finally:
        srv.shutdown()
    _check_paged_run(texts, st)
    steps = st["decode_steps"] - before["decode_steps"]
    chunks = st["prefill_chunks"] - before["prefill_chunks"]
    own = st["kernel_launches"] - before["kernel_launches"]
    if st["prefix_hits"] <= 0:
        raise AssertionError("no prefix-cache hit")
    if launches != cfg.num_layers * (chunks + steps) or own != launches:
        raise AssertionError(
            f"{launches} kernel launches (scheduler counted {own}), "
            f"expected {cfg.num_layers} x ({chunks} prefill chunks + "
            f"{steps} decode steps)")
    if st["max_active_slots"] > 8:
        raise AssertionError("more than 8 sequences decoded at once")
    tokens = len(texts) * SERVE_NEW_TOKENS
    r = dict(requests=len(texts), tokens=tokens, wall_s=wall,
             tokens_per_s=tokens / wall,
             decode_step_ms=(st["decode_seconds"]
                             - before["decode_seconds"]) / steps * 1e3,
             ttft_mean_s=sum(ttfts) / len(ttfts), ttft_max_s=max(ttfts),
             decode_steps=steps, prefill_chunks=chunks, launches=launches,
             prefix_hits=st["prefix_hits"] - before.get("prefix_hits", 0),
             max_active_slots=st["max_active_slots"],
             peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
             profile=prof, texts=texts)
    print(f"serve: {r['requests']} requests, {tokens} tokens in {wall:.2f} s"
          f" = {r['tokens_per_s']:.1f} tokens/s; mean decode step "
          f"{r['decode_step_ms']:.2f} ms over {steps} steps; TTFT mean "
          f"{r['ttft_mean_s']:.3f} s, max {r['ttft_max_s']:.3f} s; "
          f"{chunks} prefill chunks; {launches} kernel launches = "
          f"{cfg.num_layers} x ({chunks} + {steps}); prefix hits "
          f"{r['prefix_hits']}", flush=True)
    return r


# verify logits against spec_k + 1 sequential decode steps, per element:
# |verify - sequential| <= gate x RMS(sequential). K4's window rows are
# bitwise equal to 1-token calls, but cuBLAS rounds the 40-row projections
# of a verify call otherwise than the 8-row ones of a step (8-row and
# 1-row steps are bitwise equal). In bf16 that rounding difference grows
# through 32 layers of random weights to the size of bf16's own error (the
# bf16 model against the same weights in float32: up to 0.32 x RMS, 5.5%
# in relative L2, on an H100 80GB HBM3 at 700 W), so the bf16 gate holds
# only against gross faults and the 2%-off refusal is held in float32, the
# same weights upcast, where the difference is 5e-5 x RMS.
VERIFY_GATE = {"bfloat16": 0.5, "float32": 1e-3}
VERIFY_OFF = 0.02  # a float32 verify output this far off is refused


def _verify_and_steps(torch, cfg, params, rope, lens, K, T=16):
    """Paged caches for len(lens) slots, slot s prefilled (32-token chunks
    of random tokens from a fixed seed) to cursor lens[s]; then one
    ``paged_verify_step`` over a K-token window of random tokens, and K
    ``paged_decode_step`` calls on a copy of the same caches. Returns the
    two [slots, K, vocab] float32 logits and the host ms of the verify
    call (its second call: a verify writes the same k/v again and moves
    no cursor) and of each step, each ending in a synchronize."""
    from ray_tpu_torch.models import decode

    P = ARENA_LEN // T
    need = [-(-(n + K) // T) for n in lens]
    tables = torch.zeros((len(lens), P), dtype=torch.int32)
    first = 1
    for s, n in enumerate(need):
        tables[s, :n] = torch.arange(first, first + n)
        first += n
    tables = tables.cuda()
    caches = decode.init_paged_caches(cfg, len(lens), first, T, P,
                                      device="cuda")
    g = torch.Generator(device="cpu").manual_seed(7)
    for s, n in enumerate(lens):
        for c0 in range(0, n, 32):
            real = min(32, n - c0)
            chunk = torch.zeros((1, 32), dtype=torch.int32)
            chunk[0, :real] = torch.randint(1, cfg.vocab_size, (real,),
                                            generator=g)
            decode.paged_prefill_into_slot(cfg, params, chunk.cuda(), real,
                                           s, tables[s], tables[s], caches,
                                           rope)
    win = torch.randint(1, cfg.vocab_size, (len(lens), K), generator=g,
                        dtype=torch.int32).cuda()
    lengths = caches[0].lengths.clone()
    copy = [decode.PagedKVCache(k=c.k.clone(), v=c.v.clone(),
                                lengths=lengths) for c in caches]
    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3

    def verify_call():
        return decode.paged_verify_step(cfg, params, win, tables, tables,
                                        caches, rope)

    verify_call()  # warm-up; the timed call writes the same k/v again
    verify, verify_ms = timed(verify_call)
    ones = torch.ones(len(lens), dtype=torch.int32, device="cuda")
    steps, step_ms = [], []
    for j in range(K):
        out, ms = timed(lambda: decode.paged_decode_step(
            cfg, params, win[:, j].contiguous(), ones, tables, tables, copy,
            rope))
        steps.append(out)
        step_ms.append(ms)
    verify, seq = verify.float(), torch.stack(steps, dim=1).float()
    if caches[0].lengths.tolist() != lens:
        raise AssertionError("the verify call moved the cursors")
    if lengths.tolist() != [n + K for n in lens]:
        raise AssertionError("the decode steps did not advance the cursors")
    return verify, seq, dict(verify_ms=verify_ms, step_ms=step_ms)


def verify_logits_check(torch, srv) -> dict:
    """One verify call against ``spec_k + 1`` sequential decode steps on a
    copy of the same caches, 8 slots at cursors 0-640, with the served
    bf16 weights and with the same weights upcast to float32 (a float32
    copy of llama3_8b, 32 GB, for the length of the check)."""
    import dataclasses

    from ray_tpu_torch.models.transformer import place_params

    cfg, rope = srv.cfg, srv._sched._rope
    lens, K = [0, 16, 37, 100, 255, 300, 480, 640], SPEC_K + 1
    v16, s16, t16 = _verify_and_steps(torch, cfg, srv.params, rope, lens,
                                      K)
    cfg32 = dataclasses.replace(cfg, dtype=torch.float32)
    p32 = place_params(cfg32, srv.params, torch.device("cuda"))
    v32, s32, _ = _verify_and_steps(torch, cfg32, p32, rope, lens, K)
    del p32

    def share(a, b):  # max |a - b| over the RMS of b
        return float((a - b).abs().max() / b.square().mean().sqrt())

    r = dict(lengths=lens, window=K, gate=VERIFY_GATE,
             rms=float(s16.square().mean().sqrt()),
             bfloat16=share(v16, s16), float32=share(v32, s32),
             bf16_own_error=share(s16, s32),
             off_share=share(s32 * (1 + VERIFY_OFF), s32),
             argmax_equal_bf16=float((v16.argmax(-1) == s16.argmax(-1))
                                     .float().mean()),
             rel_l2_bf16=float((v16 - s16).norm() / s16.norm()),
             verify_ms=t16["verify_ms"], step_ms=t16["step_ms"])
    steps = ", ".join(f"{ms:.2f}" for ms in r["step_ms"])
    print(f"spec-serve verify check: one {K}-token verify call against {K} "
          f"decode steps on a copy of the caches (cursors {lens}): max "
          f"|diff| {r['bfloat16']:.4f} x RMS in bf16 (gate "
          f"{VERIFY_GATE['bfloat16']}; relative L2 {r['rel_l2_bf16']:.4f}; "
          f"argmax equal in {100 * r['argmax_equal_bf16']:.1f}% of rows; "
          f"the bf16 steps against float32 {r['bf16_own_error']:.4f}), "
          f"{r['float32']:.2e} x RMS in float32 (gate "
          f"{VERIFY_GATE['float32']:g}); an output {100 * VERIFY_OFF:g}% "
          f"off is {r['off_share']:.4f} x RMS. In bf16 the verify call "
          f"took {r['verify_ms']:.2f} ms and the {K} steps "
          f"{sum(r['step_ms']):.2f} ms ({steps}): verifying by the steps' "
          "own 8-row GEMMs, the arrangement that would make them agree "
          "bitwise, costs the difference a round", flush=True)
    for dtype_name, gate in VERIFY_GATE.items():
        if not r[dtype_name] <= gate:
            raise AssertionError(f"{dtype_name} verify logits differ from "
                                 "the sequential decode steps' beyond the "
                                 "gate")
    if r["off_share"] <= VERIFY_GATE["float32"]:
        raise AssertionError(f"the float32 gate would pass an output "
                             f"{100 * VERIFY_OFF:g}% off")
    return r


def _equal_greedy(texts, plain, eos=None) -> int:
    """How many of the temperature-0 requests' texts equal the plain serve
    phase's (each plain text cut after its first ``eos``, if given)."""
    n = 0
    for i, (got, want) in enumerate(zip(texts, plain)):
        if i == SAMPLED:
            continue
        ids = _text_ids(want)
        if eos is not None and eos in ids:
            ids = ids[:ids.index(eos) + 1]
        n += _text_ids(got) == ids
    return n


def spec_serve_phase(torch, card, plain) -> dict:
    """llama3_8b at full width and depth with the self drafter, spec_k 4:
    the serve phase's 12 streamed requests through drafter steps and K4
    verify windows; how many temperature-0 texts equal the plain serve
    phase's ``plain`` texts; then the verify logits check."""
    srv = _llama3_8b_server(torch, "spec-serve", drafter="self",
                            spec_k=SPEC_K)
    try:
        cfg = srv.cfg
        texts, ttfts, wall, launches, before, st = _serve_requests(srv)
        peak = torch.cuda.max_memory_allocated() / 1e9  # the serving run
        prof = profile_decode(torch, srv, SYSTEM_PROMPT)
        check = verify_logits_check(torch, srv)
    finally:
        srv.shutdown()
    d = {k: st[k] - before[k] for k in (
        "decode_steps", "plain_decode_steps", "verify_rounds",
        "prefill_chunks", "kernel_launches", "spec_drafted_tokens",
        "spec_accepted_tokens", "spec_seconds", "spec_draft_seconds",
        "spec_verify_seconds", "tokens_generated")}
    rounds, chunks = d["verify_rounds"], d["prefill_chunks"]
    if d["plain_decode_steps"] != 0:
        raise AssertionError(f"{d['plain_decode_steps']} plain decode steps "
                             "ran with a drafter")
    if rounds <= 0 or d["spec_drafted_tokens"] <= 0:
        raise AssertionError(f"no speculative round ran: {d}")
    if (launches != cfg.num_layers * (chunks + rounds)
            or d["kernel_launches"] != launches):
        raise AssertionError(
            f"{launches} kernel launches (scheduler counted "
            f"{d['kernel_launches']}), expected {cfg.num_layers} x ({chunks} "
            f"prefill chunks + {rounds} verify rounds)")
    _check_paged_run(texts, st)
    tokens = len(texts) * SERVE_NEW_TOKENS
    equal = _equal_greedy(texts, plain)
    print(f"spec-serve: {equal} of {len(texts) - 1} temperature-0 texts "
          "equal the plain serve phase's, token for token", flush=True)
    r = dict(requests=len(texts), tokens=tokens, wall_s=wall,
             greedy_texts_equal=equal, tokens_per_s=tokens / wall,
             verify_rounds=rounds,
             prefill_chunks=chunks, launches=launches,
             round_ms=d["spec_seconds"] / rounds * 1e3,
             draft_ms=d["spec_draft_seconds"] / rounds * 1e3,
             verify_ms=d["spec_verify_seconds"] / rounds * 1e3,
             ttft_mean_s=sum(ttfts) / len(ttfts), ttft_max_s=max(ttfts),
             accept_rate=(d["spec_accepted_tokens"]
                          / d["spec_drafted_tokens"]),
             drafted=d["spec_drafted_tokens"],
             accepted=d["spec_accepted_tokens"],
             # each request's first token comes from its prefill
             tokens_per_round=(d["tokens_generated"] - len(texts)) / rounds,
             drafter_arena_gb=st["drafter_arena_bytes"] / 1e9,
             peak_mem_gb=peak, profile=prof, verify_check=check)
    print(f"spec-serve: {r['requests']} requests, {tokens} tokens in "
          f"{wall:.2f} s = {r['tokens_per_s']:.1f} tokens/s; {rounds} rounds "
          f"of {SPEC_K} drafter steps + 1 verify, mean round "
          f"{r['round_ms']:.1f} ms (drafting {r['draft_ms']:.1f}, verify "
          f"{r['verify_ms']:.1f}); TTFT mean {r['ttft_mean_s']:.3f} s, max "
          f"{r['ttft_max_s']:.3f} s; accept rate {r['accept_rate']:.3f} "
          f"({r['accepted']}/{r['drafted']}), {r['tokens_per_round']:.2f} "
          f"tokens per round (all slots); {chunks} prefill chunks; "
          f"{launches} kernel launches = {cfg.num_layers} x ({chunks} + "
          f"{rounds}); 0 plain decode steps; drafter arena "
          f"{r['drafter_arena_gb']:.2f} GB; peak memory {peak:.1f} GB; "
          f"card {card}", flush=True)
    return r


# the serve-lanes phase's pool for (c): a request takes 11 pages (~140
# prompt tokens + 32 new, 16-token pages); 12 for each of the 8 slots plus
# the garbage page, against 8 x 128 + 1 for the worst case
LANES_KV_PAGES = 8 * 12 + 1
EOS_AT = 8  # (c)'s eos_id: this token of the first greedy serve text


def serve_lanes_phase(torch, plain) -> dict:
    """The JAX replica's serve baselines and knobs at llama3_8b, full width
    and all 32 layers, on one tree of seed-0 bf16 weights (the serve
    phase's) shared by every configuration through ``params_loader``:
    (a) ``attn="gather"``, (b) ``kv_layout="contiguous"``, (c) a pool of
    ``LANES_KV_PAGES`` pages with the prefix cache and an ``eos_id`` the
    serve phase's first greedy text emits, (d) ``scheduler="batch"``. Each
    (e) ``cache_dtype=torch.float32`` (K4 on its bf16 q / float32 pool
    pair), (f) the same tree in float32 (``preset_overrides``) over
    ``cache_dtype=torch.bfloat16`` (K4's float32 q / bf16 pool pair).
    Each runs the serve phase's 12 requests and is freed before the next.
    K4 launches are exact for each dtype pair: 0 off the in-place lane,
    layers x (chunks + steps) on it. The count of temperature-0 texts
    equal to the serve phase's ``plain`` texts (up to the EOS in (c)) is
    printed, not gated: in bf16 the lanes' attention and the batch path's
    GEMMs round otherwise, and (e) and (f) keep or widen other
    roundings."""
    from ray_tpu_torch import presets
    from ray_tpu_torch.models.transformer import init_params
    from ray_tpu_torch.ops.paged_attention import paged_attention

    cfg = presets.llama3_8b()
    t0 = time.perf_counter()
    params = init_params(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    print(f"serve-lanes: seed-0 bf16 weights of llama3_8b, one tree for "
          f"every configuration, in {time.perf_counter() - t0:.1f} s",
          flush=True)
    eos = _text_ids(plain[0])[EOS_AT]
    configs = {
        "a_gather": dict(attn="gather"),
        "b_contiguous": dict(kv_layout="contiguous"),
        "c_kv_pages": dict(kv_pages=LANES_KV_PAGES, eos_id=eos),
        "d_batch": dict(scheduler="batch"),
        "e_cache_f32": dict(cache_dtype=torch.float32),
        "f_f32_cache_bf16": dict(preset_overrides={"dtype": torch.float32},
                                 cache_dtype=torch.bfloat16),
    }
    # the K4 dtype pair (q/pool) of each in-place configuration
    pairs = {"c_kv_pages": "bfloat16/bfloat16",
             "e_cache_f32": "bfloat16/float32",
             "f_f32_cache_bf16": "float32/bfloat16"}
    out = {"eos_id": eos}
    for name, kw in configs.items():
        batch = kw.get("scheduler") == "batch"
        srv = _llama3_8b_server(torch, f"serve-lanes {name}",
                                params_loader=lambda c: params, **kw)
        try:
            texts, ttfts, wall, launches, before, st = _serve_requests(
                srv, batch)
            pair_launches = dict(paged_attention.pair_launches)
        finally:
            srv.shutdown()
            del srv
            _free(torch)
        tokens = sum(len(_text_ids(t)) for t in texts)
        r = dict(requests=len(texts), tokens=tokens, wall_s=wall,
                 tokens_per_s=tokens / wall,
                 ttft_mean_s=sum(ttfts) / len(ttfts), ttft_max_s=max(ttfts),
                 launches=launches, pair_launches=pair_launches,
                 greedy_texts_equal=_equal_greedy(
                     texts, plain, eos if "eos_id" in kw else None))
        line = ""
        if not batch:
            steps = st["decode_steps"] - before["decode_steps"]
            chunks = st["prefill_chunks"] - before["prefill_chunks"]
            r.update(decode_steps=steps, prefill_chunks=chunks,
                     decode_step_ms=(st["decode_seconds"]
                                     - before["decode_seconds"])
                     / steps * 1e3)
            line = (f"; mean decode step {r['decode_step_ms']:.2f} ms over "
                    f"{steps} steps, {chunks} prefill chunks")
        want = {}
        if name in pairs:
            want = {pairs[name]: cfg.num_layers * (r["prefill_chunks"]
                                                   + r["decode_steps"])}
        if name == "c_kv_pages":
            r.update(peak_pages_in_use=st["peak_pages_in_use"],
                     num_pages=st["num_pages"],
                     evicted_pages=st["evicted_pages_total"],
                     retired_eos=st["retired_eos"] - before["retired_eos"])
            line += (f"; peak pages in use {r['peak_pages_in_use']} of "
                     f"{st['usable_pages']}, {r['evicted_pages']} pages "
                     f"evicted, {r['retired_eos']} requests retired on "
                     f"eos_id {eos}")
            if r["retired_eos"] < 1:
                raise AssertionError("(c): no request retired on 'eos'")
            if r["peak_pages_in_use"] > LANES_KV_PAGES - 1:
                raise AssertionError(f"(c): {r['peak_pages_in_use']} pages "
                                     "in use at the peak")
        if pair_launches != want or launches != sum(want.values()):
            raise AssertionError(f"serve-lanes {name}: K4 launches "
                                 f"{pair_launches} ({launches} in all), "
                                 f"expected {want}")
        print(f"serve-lanes {name}: {r['requests']} requests, {tokens} "
              f"tokens in {wall:.2f} s = {r['tokens_per_s']:.1f} tokens/s; "
              f"TTFT mean {r['ttft_mean_s']:.3f} s, max "
              f"{r['ttft_max_s']:.3f} s{line}; K4 launches by q/pool "
              f"dtype {pair_launches} (expected {want}); "
              f"{r['greedy_texts_equal']} of 11 "
              "temperature-0 texts equal the serve phase's", flush=True)
        out[name] = r
    del params
    return out


def profile_decode(torch, srv, system) -> dict:
    """Where a decode step's (or, with a drafter, a speculative round's)
    time goes: 8 requests that hit the prefix cache, 16 tokens each, under
    torch.profiler; device kernel time by kernel, against the host clock
    over the decode steps or verify rounds."""
    from torch.profiler import ProfilerActivity, profile

    reqs = [{"prompt": system + f"and step {i}?", "max_new_tokens": 16}
            for i in range(8)]
    before = srv.scheduler_stats()

    async def go():
        return await asyncio.gather(*[srv(r) for r in reqs])

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        asyncio.run(go())
        wall = time.perf_counter() - t0
    st = srv.scheduler_stats()
    steps = st["decode_steps"] - before["decode_steps"]
    chunks = st["prefill_chunks"] - before["prefill_chunks"]
    kernels = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            n, us = kernels.get(e.name, (0, 0.0))
            kernels[e.name] = (n + 1, us + e.time_range.elapsed_us())
    busy_ms = sum(us for _, us in kernels.values()) / 1e3
    top = sorted(kernels.items(), key=lambda kv: -kv[1][1])[:8]
    # K4: its split kernel and its merge kernel
    k4 = [(n, us) for name, (n, us) in kernels.items()
          if "paged_attention" in name]
    r = dict(wall_ms=wall * 1e3, decode_steps=steps, prefill_chunks=chunks,
             decode_ms=(st["decode_seconds"] - before["decode_seconds"]
                        + st.get("spec_seconds", 0.0)
                        - before.get("spec_seconds", 0.0)) * 1e3,
             device_busy_ms=busy_ms if kernels else None,
             kernel_launches=sum(n for n, _ in kernels.values()),
             paged_attention_kernels=sum(n for n, _ in k4),
             paged_attention_ms=sum(us for _, us in k4) / 1e3,
             top=[dict(name=k[:90], count=n, ms=us / 1e3)
                  for k, (n, us) in top])
    if kernels:
        kind = "verify rounds" if "spec_seconds" in st else "decode steps"
        print(f"profile: {steps} {kind} + {chunks} prefill chunks in "
              f"{r['wall_ms']:.1f} ms wall; device kernels busy "
              f"{busy_ms:.1f} ms ({100 * busy_ms / r['wall_ms']:.1f}%), "
              f"{r['kernel_launches']} device kernels; K4 (split + merge "
              f"kernels) {r['paged_attention_ms']:.2f} ms in "
              f"{r['paged_attention_kernels']} kernels", flush=True)
        for t in r["top"]:
            print(f"  {t['ms']:9.3f} ms {t['count']:6d}x  {t['name']}")
    else:
        print("profile: the profiler saw no device kernels (not measured)")
    return r


# --------------------------------------------------------------- parity


def _parity_texts(preset, host, dev, **kw):
    """Temperature-0 texts of 9 requests (3 prompts x 3) from a small
    server on ``dev`` with the given host weights, and its stats."""
    from ray_tpu_torch import LLMServerImpl

    prompts = ["hi", "hello 123", "a much longer prompt than the others!"]
    srv = LLMServerImpl(preset=preset, max_new_tokens=8, slots=4,
                        prefill_chunk=8, page_tokens=4, device=dev,
                        detokenize=_ids_text, params_loader=lambda c: host,
                        **kw)
    try:
        async def go():
            return await asyncio.gather(
                *[srv({"prompt": p}) for p in prompts * 3])

        return [o["text"] for o in asyncio.run(go())], srv.scheduler_stats()
    finally:
        srv.shutdown()


def parity_phase(torch) -> dict:
    """In float32, the port on the card against the port on the CPU, on the
    same weights: llama_debug, llama_debug with the self drafter (whose
    texts must also equal the card's own texts without it), and
    moe_debug."""
    from ray_tpu_torch import presets
    from ray_tpu_torch.models import decode
    from ray_tpu_torch.models.transformer import init_params, place_params
    from ray_tpu_torch.ops.rotary import rope_frequencies

    cfg = presets.llama_debug()
    host = init_params(cfg, seed=0, device="cpu")
    texts = {dev: _parity_texts("llama_debug", host, dev)[0]
             for dev in ("cuda", "cpu")}
    if texts["cuda"] != texts["cpu"]:
        raise AssertionError(f"card and CPU texts differ: {texts}")
    spec, spec_stats = {}, {}
    for dev in ("cuda", "cpu"):
        spec[dev], spec_stats[dev] = _parity_texts(
            "llama_debug", host, dev, drafter="self", spec_k=SPEC_K)
    if not spec["cuda"] == spec["cpu"] == texts["cuda"]:
        raise AssertionError(f"spec texts differ (card, CPU, card without "
                             f"the drafter): {spec['cuda']} {spec['cpu']} "
                             f"{texts['cuda']}")
    st = spec_stats["cuda"]
    if st["plain_decode_steps"] or not st["verify_rounds"] or not (
            st["kernel_launches"]):
        raise AssertionError(f"the card's spec run did not verify through "
                             f"the kernel: {st}")
    moe_host = init_params(presets.moe_debug(), seed=0, device="cpu")
    moe = {dev: _parity_texts("moe_debug", moe_host, dev)[0]
           for dev in ("cuda", "cpu")}
    if moe["cuda"] != moe["cpu"]:
        raise AssertionError(f"moe_debug card and CPU texts differ: {moe}")
    # the programs' logits, side by side: one prefill chunk + 3 decode steps
    diffs = []
    runs = {}
    for dev in ("cuda", "cpu"):
        params = place_params(cfg, host, torch.device(dev))
        rope = tuple(t.to(dev) for t in rope_frequencies(
            cfg.head_dim, cfg.max_seq_len, cfg.rope_theta))
        caches = decode.init_paged_caches(cfg, 2, 17, 4, 8, device=dev)
        tables = (1 + torch.arange(16, dtype=torch.int32)).reshape(2, 8)
        tables = tables.to(dev)
        out = [decode.paged_prefill_into_slot(
            cfg, params, torch.tensor([[5, 9, 13, 2, 7, 0, 0, 0]],
                                      dtype=torch.int32, device=dev),
            5, 0, tables[0], tables[0], caches, rope)[None]]
        for step in range(3):
            toks = torch.tensor([3 + step, 11], dtype=torch.int32,
                                device=dev)
            act = torch.tensor([1, 1], dtype=torch.int32, device=dev)
            out.append(decode.paged_decode_step(cfg, params, toks, act,
                                                tables, tables, caches,
                                                rope))
        runs[dev] = [o.cpu() for o in out]
    for a, b in zip(runs["cuda"], runs["cpu"]):
        diffs.append(float((a - b).abs().max()))
    r = dict(texts_equal=True, max_logit_diff=max(diffs),
             spec_accept_rate=st["spec_accept_rate"],
             spec_verify_rounds=st["verify_rounds"],
             lanes=parity_lanes(torch, cfg, host, texts["cpu"]))
    print(f"parity: float32, card and CPU texts identical ({len(texts['cpu'])}"
          f" requests each): llama_debug; llama_debug with the self drafter "
          f"(spec_k {SPEC_K}, accept rate {st['spec_accept_rate']:.3f}, "
          f"{st['verify_rounds']} verify rounds), equal to the texts without "
          f"it; moe_debug. llama_debug's largest logit difference "
          f"{r['max_logit_diff']:.3e}", flush=True)
    if not r["max_logit_diff"] < 1e-4:
        raise AssertionError("card and CPU logits differ by more than 1e-4")
    return r


def parity_lanes(torch, cfg, host, base) -> dict:
    """The serve-lanes configurations and ``cache_dtype`` at llama_debug:
    card texts against CPU texts, identical in float32 for (a)
    ``attn="gather"``, (b) ``kv_layout="contiguous"``, (c) a pool below the
    worst case with an ``eos_id`` (the third token of the longest prompt's
    text ``base[2]``), (d) ``scheduler="batch"``, and a bf16 cache under
    the float32 model, which runs K4 on the (float32 q, bf16 pool) pair,
    its launches exact. Then the bf16 model over a float32 cache, K4's
    (bf16 q, float32 pool) pair, launches exact (card against CPU texts
    counted, not gated: bf16 GEMMs round otherwise on the two). And
    ``attn="reference"`` on the card must raise."""
    from ray_tpu_torch import LLMServerImpl
    from ray_tpu_torch.ops.paged_attention import paged_attention

    eos = _text_ids(base[2])[2]
    # 4 slots of the longest prompt + 8 tokens, 12 pages each, fit
    configs = {"a_gather": dict(attn="gather"),
               "b_contiguous": dict(kv_layout="contiguous"),
               "c_kv_pages": dict(kv_pages=4 * 12 + 1, eos_id=eos),
               "d_batch": dict(scheduler="batch"),
               "cache_bf16": dict(cache_dtype=torch.bfloat16),
               "bf16_cache_f32": dict(
                   preset_overrides={"dtype": torch.bfloat16},
                   cache_dtype=torch.float32)}
    pairs = {"cache_bf16": "float32/bfloat16",
             "bf16_cache_f32": "bfloat16/float32"}
    out = {"eos_id": eos}
    for name, kw in configs.items():
        paged_attention.pair_launches.clear()
        paged_attention.launches = 0
        card, st = _parity_texts("llama_debug", host, "cuda", **kw)
        launches = dict(paged_attention.pair_launches)
        cpu, _ = _parity_texts("llama_debug", host, "cpu", **kw)
        equal = sum(a == b for a, b in zip(card, cpu))
        r = dict(texts_equal=equal, launches=launches)
        if name == "bf16_cache_f32":
            print(f"parity {name}: {equal} of {len(cpu)} card texts equal "
                  "the CPU's (bf16 model, not gated)", flush=True)
        elif equal != len(cpu):
            raise AssertionError(f"parity {name}: card and CPU texts "
                                 f"differ: {card} {cpu}")
        if name == "c_kv_pages" and st["retired_eos"] < 1:
            raise AssertionError("parity c_kv_pages: no 'eos' retire")
        if st["mode"] == "batch" or st["kv_layout"] == "contiguous" \
                or st.get("attn_lane") == "gather":
            want = {}
        else:
            n = cfg.num_layers * (st["prefill_chunks"] + st["decode_steps"])
            want = {pairs.get(name, "float32/float32"): n}
        if launches != want:
            raise AssertionError(f"parity {name}: K4 launches {launches}, "
                                 f"expected {want}")
        out[name] = r
    try:
        LLMServerImpl(preset="llama_debug", attn="reference",
                      params_loader=lambda c: host)
    except ValueError as e:
        out["reference_on_card"] = str(e)
    else:
        raise AssertionError("attn='reference' served on the card")
    print(f"parity lanes: float32 card and CPU texts identical for "
          f"gather, contiguous, kv_pages 49 with eos_id {eos}, batch and a "
          f"bf16 cache (K4 (float32 q, bf16 pool) launches "
          f"{out['cache_bf16']['launches']}); the bf16 model over a "
          f"float32 cache ran K4 (bf16 q, float32 pool) "
          f"{out['bf16_cache_f32']['launches']}; attn='reference' on the "
          "card refused", flush=True)
    return out


def _free(torch):
    """Drop a finished phase's server (16 GB of llama3_8b weights) from the
    card before the next phase builds its own."""
    import gc

    gc.collect()
    torch.cuda.empty_cache()


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    if not (ROOT / "ray_tpu_torch" / "csrc" / "paged_attention.cu").exists():
        print("chip_smoke: run it from a checkout of the repository "
              "(ray_tpu_torch/ is missing)", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from ray_tpu_torch._private.device import resolve_device

    resolve_device()  # TF32 off
    t_start = time.perf_counter()
    card = card_line()
    build = build_phase()
    kern = kernel_phase(torch)
    flash = flash_kernel_phase(torch)
    serve = serve_phase(torch)
    _free(torch)
    spec_serve = spec_serve_phase(torch, card, serve["texts"])
    _free(torch)
    lanes = serve_lanes_phase(torch, serve["texts"])
    _free(torch)
    parity = parity_phase(torch)
    train = train_phase(torch)
    train_parity = train_parity_phase(torch)
    main_case = kern["decode_bfloat16"]
    kernels = {"kernels": [{
        "name": "paged_attention",
        "route": "cuda",
        "source": "ray_tpu_torch/csrc/paged_attention.cu",
        "replaces": "ray_tpu/ops/paged_attention.py:139",
        "launches": serve["launches"],
        "max_abs_err": main_case["max_abs_err"],
        "ms": main_case["ms"],
        "plain_ms": main_case["plain_ms"],
        "bound_ms": main_case["bound_ms"],
        "bound_by": main_case["bound_by"],
        "library_ms": main_case["library_ms"],
    }]}
    # K4 over a pool of another dtype than q's, at llama3_8b decode; their
    # launches come from the serve-lanes runs of llama3_8b with that pair
    for pair, label, run in (
            ("float32_q_bfloat16_pool", "f32q_bf16pool", "f_f32_cache_bf16"),
            ("bfloat16_q_float32_pool", "bf16q_f32pool", "e_cache_f32")):
        case = kern[f"decode_{pair}"]
        kernels["kernels"].append({
            "name": f"paged_attention_{label}",
            "route": "cuda",
            "source": "ray_tpu_torch/csrc/paged_attention.cu",
            "replaces": "ray_tpu/ops/paged_attention.py:139",
            "launches": lanes[run]["launches"],
            "max_abs_err": case["max_abs_err"],
            "ms": case["ms"],
            "plain_ms": case["plain_ms"],
            "bound_ms": case["bound_ms"],
            "bound_by": case["bound_by"],
            "library_ms": case["library_ms"],
        })
    # the flash kernels at the main path's shapes: gpt2_small, bf16
    fcase = flash["gpt2_small_bfloat16"]
    launches = train["gpt2_small"]["launches"]
    for key, name, line, err in (
            ("fwd", "flash_attention_fwd", 103, fcase["o_max_abs_err"]),
            ("dq", "flash_attention_dq", 203, fcase["dq_max_abs_err"]),
            ("dkv", "flash_attention_dkv", 239,
             max(fcase["dk_max_abs_err"], fcase["dv_max_abs_err"]))):
        kernels["kernels"].append({
            "name": name,
            "route": "cuda",
            "source": "ray_tpu_torch/csrc/flash_attention.cu",
            "replaces": f"ray_tpu/ops/flash_attention.py:{line}",
            "launches": launches[{"fwd": "flash_forward", "dq": "flash_dq",
                                  "dkv": "flash_dkv"}[key]],
            "max_abs_err": err,
            "ms": fcase[f"{key}_ms"],
            "plain_ms": fcase[f"{key}_plain_ms"],
            "bound_ms": fcase[f"{key}_bound_ms"],
            "bound_by": fcase[f"{key}_bound_by"],
            "library_ms": fcase[f"{key}_library_ms"],
        })
    detail = {"card": card, "build": build, "kernel": kern, "flash": flash,
              "serve": serve, "spec_serve": spec_serve,
              "serve_lanes": lanes, "parity": parity,
              "train": train,
              "train_parity": train_parity,
              "seconds": time.perf_counter() - t_start}
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(detail, indent=1))
    print(json.dumps(kernels))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
