#!/usr/bin/env python3
"""Runs the PyTorch/CUDA port (``ray_tpu_torch``) on one NVIDIA card and
checks it, phase by phase. Usage, from the root of a checkout:

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit, no result line) if any
of its checks fails:

  1. card: the card's name and power limit, as nvidia-smi gives them.
  2. build: nvcc builds the paged-attention kernel from
     ``ray_tpu_torch/csrc/`` for sm_90a into ``build/kernels/``.
  3. kernel: the kernel against ``paged_attention_reference`` on the card,
     at llama3_8b shapes (H=32, Hkv=8, D=128, 16-token pages), bf16 and
     float32, for decode (8 slots, 1 token) and prefill (1 slot, a
     32-token chunk); row i of a 32-token window against a 1-token call at
     length + i, bit for bit; the launch counter; times of the kernel, of
     its plain version, of scaled_dot_product_attention over a pre-gathered
     contiguous view (a yardstick only: the port never calls it) and the
     bound (live-page bytes over the memory rate, or the operations over
     the peak rate, whichever is larger).
  4. serve: ``LLMServerImpl(preset="llama3_8b")`` at full width and depth
     (32 layers), random bf16 weights from a seeded torch.Generator,
     answers 12 streamed requests that share a prefix (8 slots, one request
     sampled at temperature 0.7), through the kernel on every layer.
  5. parity: llama_debug in float32, the port on the card against the port
     on the CPU with the same weights: temperature-0 texts identical.

The line before the last is ``{"kernels": [...]}``; the last is
``{"ok": true, "device": {...}}``. Details go to
``chiprun_out/chip_smoke.json``.
"""

from __future__ import annotations

import asyncio
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# one H100 SXM (NVIDIA's data sheet, dense, at its 700 W limit)
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}  # f32 off tensor cores

ARENA_LEN = 2048          # serve arena per slot: 128 pages of 16 tokens
SERVE_NEW_TOKENS = 32
TOL = {"float32": (1e-5, 1e-5),       # atol, rtol: sum order differs
       "bfloat16": (1e-5, 2.0 ** -7)}  # at most one bf16 rounding step


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout
    line = out.strip().splitlines()[0]
    print(line, flush=True)
    return line


def build_phase() -> dict:
    from ray_tpu_torch.ops import _build

    t0 = time.perf_counter()
    _build.load("paged_attention")
    seconds = time.perf_counter() - t0
    log = _build.build_log.get("paged_attention", "(reused build)")
    ptxas = [ln.strip() for ln in log.splitlines()
             if "registers" in ln or "spill" in ln]
    print(f"build: paged_attention.cu with nvcc for sm_90a in "
          f"{seconds:.2f} s", flush=True)
    for ln in ptxas:
        print(f"  ptxas: {ln}")
    return {"seconds": seconds, "ptxas": ptxas}


# --------------------------------------------------------------- kernel


def make_case(torch, dtype, S, K, lengths, *, H=32, Hkv=8, D=128, T=16,
              P=ARENA_LEN // 16, seed=0, device="cuda"):
    """Pools, page tables and queries at the given shapes. Each slot owns
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
    return dict(q=q.to(device, dtype), k_pool=kp.to(device, dtype),
                v_pool=vp.to(device, dtype), tables=tables.to(device),
                lengths=torch.tensor(lengths, dtype=torch.int32,
                                     device=device))


def time_ms(torch, fn, iters=20, warmup=3):
    """Mean device time of ``fn`` over ``iters`` calls, each timed with
    CUDA events after a 256 MB write that evicts the 50 MB L2, so every
    call starts from a cold cache as a layer of the model would."""
    flush = torch.empty(256 * 2 ** 20, dtype=torch.uint8, device="cuda")
    for _ in range(warmup):
        fn()
    total = 0.0
    for _ in range(iters):
        flush.zero_()
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
    pages the kernel walks), the output written once, against the memory
    rate; the q.k and p.v products over the walked keys against the peak
    rate for the inputs' type. Returns (ms, "bytes" | "operations")."""
    q, kp, lengths = case["q"], case["k_pool"], case["lengths"]
    S, K, H, D = q.shape
    _, T, Hkv, _ = kp.shape
    P = case["tables"].shape[1]
    item = q.element_size()
    pages = sum(min(P, -(-(int(L) + K) // T)) for L in lengths.tolist())
    nbytes = (2 * pages * T * Hkv * D * item     # k and v of live pages
              + 2 * q.numel() * item             # q in, out
              + case["tables"].numel() * 4 + S * 4)
    flops = 2 * 2 * K * H * pages * T * D
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype_name] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def sdpa_call(torch, case):
    """scaled_dot_product_attention over each slot's pre-gathered,
    head-expanded contiguous view with the paged mask (built outside the
    timed call)."""
    q, kp, vp = case["q"], case["k_pool"], case["v_pool"]
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


def kernel_phase(torch) -> dict:
    from ray_tpu_torch.ops.paged_attention import (paged_attention,
                                                   paged_attention_reference)

    shapes = {
        # 8 slots, 1 token; lengths include 0 and page boundaries
        "decode": dict(S=8, K=1, lengths=[0, 16, 37, 100, 255, 640, 1024,
                                          2047]),
        # 1 slot, a 32-token prefill chunk at a cursor off a page boundary
        "prefill": dict(S=1, K=32, lengths=[45]),
    }
    results = {}
    for dtype_name in ("bfloat16", "float32"):
        dtype = getattr(torch, dtype_name)
        atol, rtol = TOL[dtype_name]
        for shape_name, shp in shapes.items():
            case = make_case(torch, dtype, **shp)
            n0 = paged_attention.launches
            got = paged_attention(**case)
            torch.cuda.synchronize()
            if paged_attention.launches != n0 + 1:
                raise AssertionError("the launch counter did not move")
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
            sdpa = sdpa_call(torch, case)
            sdpa_err = float((sdpa().transpose(1, 2).float()
                              - ref.float()).abs().max())
            ms = time_ms(torch, lambda: paged_attention(**case))
            plain_ms = time_ms(torch,
                               lambda: paged_attention_reference(**case))
            library_ms = time_ms(torch, sdpa)
            bound_ms, bound_by = bound(case, dtype_name)
            r = dict(max_abs_err=max_err, atol=atol, rtol=rtol, ms=ms,
                     plain_ms=plain_ms, library_ms=library_ms,
                     bound_ms=bound_ms, bound_by=bound_by,
                     sdpa_max_abs_err=sdpa_err)
            results[f"{shape_name}_{dtype_name}"] = r
            print(f"kernel {shape_name} {dtype_name}: max|err| "
                  f"{max_err:.3e} (tol {atol:g} + {rtol:g}*|ref|), "
                  f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
                  f"sdpa {library_ms:.4f} ms, bound {bound_ms:.5f} ms "
                  f"({bound_by})", flush=True)
        # row i of a 32-token window == a 1-token call at length + i
        case = make_case(torch, dtype, **shapes["prefill"], seed=1)
        win = paged_attention(**case)
        for i in range(case["q"].shape[1]):
            one = paged_attention(case["q"][:, i:i + 1], case["k_pool"],
                                  case["v_pool"], case["tables"],
                                  case["lengths"] + i)
            if not torch.equal(win[:, i:i + 1], one):
                raise AssertionError(
                    f"{dtype_name}: window row {i} differs from the 1-token "
                    f"call at length + {i}")
        print(f"kernel {dtype_name}: all 32 window rows equal 1-token calls "
              f"bit for bit", flush=True)
    return results


# ---------------------------------------------------------------- serve


async def _stream(srv, req):
    t0 = time.perf_counter()
    ttft, pieces = None, []
    async for piece in await srv(dict(req, stream=True)):
        if ttft is None:
            ttft = time.perf_counter() - t0
        pieces.append(piece)
    return ttft, pieces


def serve_phase(torch) -> dict:
    from ray_tpu_torch import LLMServerImpl
    from ray_tpu_torch.ops.paged_attention import paged_attention

    t0 = time.perf_counter()
    srv = LLMServerImpl(preset="llama3_8b", arena_len=ARENA_LEN,
                        max_new_tokens=SERVE_NEW_TOKENS)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    try:
        cfg = srv.cfg
        print(f"serve: llama3_8b, {cfg.num_layers} layers, d={cfg.embed_dim}"
              f", vocab {cfg.vocab_size}, {cfg.dtype}, arena_len "
              f"{ARENA_LEN}, slots {srv._sched.slots}, pages "
              f"{srv._sched.num_pages}; weights and pool ready in "
              f"{setup_s:.1f} s", flush=True)
        # warm-up (cuBLAS handles, allocator), outside the counted run
        asyncio.run(srv({"prompt": "warm up", "max_new_tokens": 2}))
        system = ("You are a careful assistant for a distributed systems "
                  "team. Answer briefly and precisely. Question: ")
        reqs = [{"prompt": system + f"what does step {i} of the plan do?"}
                for i in range(12)]
        reqs[5]["temperature"] = 0.7
        before = srv.scheduler_stats()
        paged_attention.launches = 0

        async def go():
            return await asyncio.gather(*[_stream(srv, r) for r in reqs])

        t1 = time.perf_counter()
        outs = asyncio.run(go())
        wall = time.perf_counter() - t1
        launches = paged_attention.launches
        st = srv.scheduler_stats()
        prof = profile_decode(torch, srv, system)
    finally:
        srv.shutdown()
    steps = st["decode_steps"] - before["decode_steps"]
    chunks = st["prefill_chunks"] - before["prefill_chunks"]
    own = st["kernel_launches"] - before["kernel_launches"]
    for i, (_ttft, pieces) in enumerate(outs):
        if len(pieces) != SERVE_NEW_TOKENS:
            raise AssertionError(f"request {i} returned {len(pieces)} "
                                 f"tokens, not {SERVE_NEW_TOKENS}")
    if st["attn_lane"] != "cuda":
        raise AssertionError(f"attn_lane is {st['attn_lane']!r}")
    if st["prefix_hits"] <= 0:
        raise AssertionError("no prefix-cache hit")
    if launches != cfg.num_layers * (chunks + steps) or own != launches:
        raise AssertionError(
            f"{launches} kernel launches (scheduler counted {own}), "
            f"expected {cfg.num_layers} x ({chunks} prefill chunks + "
            f"{steps} decode steps)")
    if st["max_active_slots"] > 8:
        raise AssertionError("more than 8 sequences decoded at once")
    tokens = len(reqs) * SERVE_NEW_TOKENS
    ttfts = [t for t, _ in outs]
    r = dict(requests=len(reqs), tokens=tokens, wall_s=wall,
             tokens_per_s=tokens / wall,
             decode_step_ms=(st["decode_seconds"]
                             - before["decode_seconds"]) / steps * 1e3,
             ttft_mean_s=sum(ttfts) / len(ttfts), ttft_max_s=max(ttfts),
             decode_steps=steps, prefill_chunks=chunks, launches=launches,
             prefix_hits=st["prefix_hits"] - before.get("prefix_hits", 0),
             max_active_slots=st["max_active_slots"],
             peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
             profile=prof)
    print(f"serve: {r['requests']} requests, {tokens} tokens in {wall:.2f} s"
          f" = {r['tokens_per_s']:.1f} tokens/s; mean decode step "
          f"{r['decode_step_ms']:.2f} ms over {steps} steps; TTFT mean "
          f"{r['ttft_mean_s']:.3f} s, max {r['ttft_max_s']:.3f} s; "
          f"{chunks} prefill chunks; {launches} kernel launches = "
          f"{cfg.num_layers} x ({chunks} + {steps}); prefix hits "
          f"{r['prefix_hits']}", flush=True)
    return r


def profile_decode(torch, srv, system) -> dict:
    """Where a decode step's time goes: 8 requests that hit the prefix
    cache, 16 tokens each, under torch.profiler; device kernel time by
    kernel, against the host clock over the decode steps."""
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
    r = dict(wall_ms=wall * 1e3, decode_steps=steps, prefill_chunks=chunks,
             decode_ms=(st["decode_seconds"] - before["decode_seconds"])
             * 1e3,
             device_busy_ms=busy_ms if kernels else None,
             kernel_launches=sum(n for n, _ in kernels.values()),
             top=[dict(name=k[:90], count=n, ms=us / 1e3)
                  for k, (n, us) in top])
    if kernels:
        print(f"profile: {steps} decode steps + {chunks} prefill chunks in "
              f"{r['wall_ms']:.1f} ms wall; device kernels busy "
              f"{busy_ms:.1f} ms ({100 * busy_ms / r['wall_ms']:.1f}%), "
              f"{r['kernel_launches']} device kernels", flush=True)
        for t in r["top"]:
            print(f"  {t['ms']:9.3f} ms {t['count']:6d}x  {t['name']}")
    else:
        print("profile: the profiler saw no device kernels (not measured)")
    return r


# --------------------------------------------------------------- parity


def parity_phase(torch) -> dict:
    """llama_debug in float32: the port on the card against the port on
    the CPU, on the same weights."""
    from ray_tpu_torch import LLMServerImpl, presets
    from ray_tpu_torch.models import decode
    from ray_tpu_torch.models.transformer import init_params, place_params
    from ray_tpu_torch.ops.rotary import rope_frequencies

    cfg = presets.llama_debug()
    host = init_params(cfg, seed=0, device="cpu")
    prompts = ["hi", "hello 123", "a much longer prompt than the others!"]
    texts = {}
    for dev in ("cuda", "cpu"):
        srv = LLMServerImpl(max_new_tokens=8, slots=4, prefill_chunk=8,
                            page_tokens=4, device=dev,
                            params_loader=lambda c: host)
        try:
            async def go():
                return await asyncio.gather(
                    *[srv({"prompt": p}) for p in prompts * 3])

            texts[dev] = [o["text"] for o in asyncio.run(go())]
        finally:
            srv.shutdown()
    if texts["cuda"] != texts["cpu"]:
        raise AssertionError(f"card and CPU texts differ: {texts}")
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
    r = dict(texts_equal=True, max_logit_diff=max(diffs))
    print(f"parity: llama_debug float32, card and CPU texts identical "
          f"({len(texts['cpu'])} requests); largest logit difference "
          f"{r['max_logit_diff']:.3e}", flush=True)
    if not r["max_logit_diff"] < 1e-4:
        raise AssertionError("card and CPU logits differ by more than 1e-4")
    return r


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
    serve = serve_phase(torch)
    parity = parity_phase(torch)
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
    detail = {"card": card, "build": build, "kernel": kern, "serve": serve,
              "parity": parity, "seconds": time.perf_counter() - t_start}
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
