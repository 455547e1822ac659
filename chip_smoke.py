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
 11. runtime (run after serve-lanes, before parity): the port's runtime
     (``ray_tpu_torch.init``, a controller, a supervisor and worker
     processes): ``rt.init()`` counts one GPU; 200 no-op actor calls
     (median round trip); a GPU-less actor sees
     ``CUDA_VISIBLE_DEVICES=""`` and its ``LLMServerImpl()`` refuses, a
     ``num_gpus=1`` actor sees the card and builds its replica there;
     llama3_8b at full width and 32 layers in a ``num_gpus=1`` actor
     (``ReplicaHost``: no control plane and no weights in the arena, the
     yardstick for phase 12) on the serve phase's seed-0 weights and
     settings, its warm-up and 12 requests streamed through
     ``num_returns="streaming"``, arriving together, request 5 sampled at
     0.7, pings to the actor while it serves: every request returns all
     its tokens, K4's launches counted in the worker are exactly layers x
     (prefill chunks + decode steps), a request's stream equals its whole
     text, temperature-0 texts equal to the serve phase's counted (bf16:
     not gated); the same 12 again on the warm prefix cache, whole,
     streamed, whole (all tokens each; tokens/s, decode-step ms, prefill
     chunks and prefix hits per pass, so streaming's cost is read apart
     from the cache); float32 llama_debug texts from a GPU actor equal the
     in-process replica's on the card; 1 GiB tensors through the object
     store bit for bit (a host tensor through the arena, here and in an
     actor; a bf16 CUDA tensor put as a device object, registry count
     +1, the source then written in place, the owner's get a copy equal
     to the value put and writing it changing nothing, fetched by a GPU
     actor; a task's 1 GiB CUDA return fetched here), with GB/s. Every get has a timeout; its expiry fails the run.
 12. serve-app (run after runtime): the serve library on the card.
     ``rt.init`` with a 24 GiB arena; ``serve.run`` of ``LLMServer``
     (a subclass defined here that reads K4's counter in the replica's
     worker) with ``num_replicas=1, num_gpus=1``: llama3_8b at full width
     and 32 layers, the serve phase's arena, slots, chunks and pages,
     random bf16 weights from seed 0, shared through the node's arena.
     Gates: ``serve.status()`` RUNNING; ``weights_info()`` "published" and
     shared; the params on ``cuda:0``; the serve controller's worker given
     no card (``CUDA_VISIBLE_DEVICES=""``); a GPU-less task attaches to the
     published tree with a loader that refuses ("attached", the arena's
     used bytes do not grow, per-leaf sums equal the replica's); the
     warm-up and the 12 requests streamed through the
     ``DeploymentHandle`` (``options(stream=True)``), sent together,
     request 5 sampled at 0.7: every request returns all its tokens, K4's
     launches in the replica's worker exactly layers x (prefill chunks +
     decode steps); a streamed request equals its whole text; counted, not
     gated, the bf16 texts equal to the serve phase's. Then whole,
     streamed, whole, streamed on the warm cache (tokens/s, decode-step
     ms, chunks, prefix hits each, and the streamed/whole step ratio),
     against the serve phase and the runtime phase's ``ReplicaHost``.
     Then the ingress, against the same replica: ``serve.start(http_port=0)``
     (the HTTP proxy) and ``serve.start_rpc_ingress()``, driven with
     ``http.client`` and the port's ``ServeRpcClient``. Gates:
     ``/-/healthz`` answers ``ok`` and ``/-/routes`` names the app; the
     proxy's and the RPC ingress's workers have no card
     (``CUDA_VISIBLE_DEVICES=""``); the 12 requests streamed over HTTP
     (``"stream": true``), sent together from threads, request 5 at 0.7:
     every request returns all its tokens and K4's launches in the
     replica are exactly layers x (prefill chunks + decode steps); then
     HTTP whole, HTTP streamed, RPC whole
     (``invoke``), RPC streamed (``invoke_stream``) on the warm cache
     (tokens/s, decode-step ms, TTFT on the client's clock, the first
     chunk for streams, chunks and prefix hits each; the streamed/whole
     step ratio of HTTP and of RPC beside the handle's); a solo request's
     text streamed and whole over both equals the handle's. Counted, not
     gated, the bf16 texts of the HTTP pass equal to the serve phase's.
     float32 llama_debug one request at a time through the handle, over
     HTTP and over RPC from a ``num_gpus=1`` replica equals the in-process
     replica's on the card; after ``serve.shutdown()`` a ``num_gpus=1``
     actor starts within 120 s.
 13. dp-train (run last, with its own ``rt.init``; part (d) runs inside
     phase 12's cluster, against its llama3_8b replica, before
     ``serve.delete``): the collectives' group API and Train on the card.
     (a) In a ``num_gpus=1`` actor, ``init_collective_group(1, 0,
     backend="nccl")``: allreduce SUM, MEAN and MAX, broadcast, allgather
     and reducescatter of a bf16 and a float32 CUDA tensor equal the
     input bit for bit on ``cuda:0``; a ``torch.profiler`` capture of a
     MEAN allreduce shows NCCL's one-rank kernel (an in-place SUM at world
     1 launches none); a GPU-less NCCL group is refused, never run on
     gloo. (b) ``TorchTrainer`` with ``ScalingConfig(num_workers=1,
     use_gpu=True)`` and ``TorchConfig(backend="nccl",
     distributed=True)``: gpt2_small at full size with the train phase's
     settings, seed and batch, one warm-up and 5 timed steps, each step's
     grads averaged by ``allreduce_coalesced`` (MEAN) on an NCCL group and
     a ``train.report``, a checkpoint at step 3. Gates: the worker's
     ``CUDA_VISIBLE_DEVICES`` is its card, K1, K2 and K3 each launch
     exactly layers x steps in the worker, losses finite and going down,
     6 reports, the checkpoint loads back to the step's params bit for
     bit. Counted, not gated: losses equal to the train phase's. Step ms,
     tokens/s and MFU beside the train phase's, the NCCL allreduce's ms.
     (c) A mixed world of 2 over the host backend (rank 0 a ``num_gpus=1``
     actor, rank 1 with no card): ``GradientAverager`` on llama_debug in
     float32, 5 steps, each rank on half of each batch; the averaged grads
     the same bytes on both ranks every step (rank 0 reads them back from
     the card), losses and grad norms within ``TRAIN_PARITY_RTOL`` of one
     process on the full batch on the card; GB/s of the average. (d) The
     serve-app replica's ``push_weights`` to a GPU-less task that builds
     ``LLMServerImpl(weights_bcast=...)`` on the CPU: its per-leaf sums
     equal the replica's (291 leaves); seconds and GB/s.
 14. pipeline (run after phase 13, with its own ``rt.init``): pipeline
     and tensor-parallel training. (a) Emulated tp2 on the card:
     gpt2_small (untied, ``remat=False``, ``ce_chunk=8192``) at full width
     and all 12 layers in 2 chunks with ``tensor_parallel=2``, the two
     ranks on two threads of this process (``emulate_tp``, the barrier
     reducer), B2 x S1024. Gates: each rank's loss within ``TP_LOSS_RTOL``
     (relative) of the fused ``loss_fn`` on the card; the grads
     reassembled with ``reassemble_pipeline_params`` within
     ``TP_GRAD_RTOL`` relative L2 of the fused grads, all leaves
     together, and each leaf within ``TP_LEAF_RTOL`` (bf16: the partial
     sums are rounded to bf16 before the reduce, the fused matmul once);
     the same grads 2% off must be refused; K1, K2 and K3
     exactly 12 launches per rank (one forward and one backward per
     block), counted per thread. (b) ``PipelineTrainer`` over two stages:
     gpt2_small at full width (d 768, 12 heads, vocab 50257), untied,
     ``remat=False``, 4 layers, ``stage_options=[{"num_gpus": 0},
     {"num_gpus": 1}]`` (the embedding and 2 blocks on the CPU, then 2
     blocks, the head and the loss on the card), M=4 microbatches of 2 x
     1024, SGD, 1 warm and 3 timed steps, ``buffer_bytes`` holding a
     3 MiB bf16 activation. Gates: the losses within
     ``TRAIN_PARITY_RTOL`` of the same chunk math run in this process on
     the same devices (bit-equal steps counted), finite; the card stage's
     K1, K2 and K3 launches over the timed steps exactly blocks x M x
     steps each (the last chunk runs K1 once per block per microbatch:
     its forward and backward are one pass; a non-last chunk would run
     it twice, forward and recompute; K2 and K3 once per block), read
     from the stage's flush reports; the card stage's device ``cuda:0``,
     stage 0's ``cpu``. Counted, not gated: the gap to the fused model in
     one process on the card, step ms, tokens/s, each stage's bubble
     fraction and the rpc-call deltas of its reports (0 in steady
     flushes). (c) llama_debug in float32, S=2, the same placement, M=2
     of 2 x 48, 3 steps: losses within ``TRAIN_PARITY_RTOL`` of the
     fused model in one process on the CPU; the card stage's K1 twice per
     block and microbatch (llama_debug runs under remat, which runs the
     block again in the backward), K2 and K3 once.

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


# ------------------------------------------------------------------ runtime
# The port's runtime: a cluster started by rt.init() on this machine, the
# replica in a worker process that holds the card. Every get takes
# RT_TIMEOUT; its expiry (an actor that never starts, a hung stream) fails
# the run.
RT_TIMEOUT = 600.0
TRANSFER_BYTES = 1 << 30  # each transfer: a 1 GiB tensor
NOOP_CALLS = 200


def _payload(torch, seed: int, device="cuda"):
    """TRANSFER_BYTES of bf16 from a seeded generator on ``device``: the
    same bits in every process on the same card."""
    g = torch.Generator(device=device).manual_seed(seed)
    return torch.randn(TRANSFER_BYTES // 2, generator=g, device=device,
                       dtype=torch.bfloat16)


def _same_bits(torch, a, b) -> bool:
    return (a.dtype == b.dtype and a.shape == b.shape and torch.equal(
        a.reshape(-1).view(torch.int16), b.reshape(-1).view(torch.int16)))


class ReplicaHost:
    """One ``LLMServerImpl`` in an async actor of the port's runtime, with
    no serve control plane around it and no weights in the arena: the
    yardstick for the serve-app phase's ``ReplicaActor``, which
    ``serve.run`` starts behind the router. ``expect(n)`` holds the next n
    requests until all n have arrived, then submits them in arrival order,
    so requests that come over RPC one by one reach the scheduler together,
    as an in-process ``gather`` of them does. K4's launch counter is read here, in the
    worker: this process's counter does not see the worker's launches."""

    def __init__(self, params=None, **server_kw):
        import torch

        from ray_tpu_torch import LLMServerImpl

        t0 = time.perf_counter()
        self.srv = LLMServerImpl(
            params_loader=None if params is None else (lambda cfg: params),
            share_weights=False, **server_kw)
        if self.srv.device.type == "cuda":
            torch.cuda.synchronize()
        self.init_s = time.perf_counter() - t0
        self._expect = 0
        self._arrived = 0
        self._all_in = None

    async def expect(self, n: int) -> None:
        self._expect, self._arrived = n, 0
        self._all_in = asyncio.Event()

    async def _arrive(self) -> None:
        if self._all_in is None:
            return
        ev = self._all_in
        self._arrived += 1
        if self._arrived == self._expect:
            self._all_in = None
            ev.set()
            # the waiters wake in arrival order, queued before this yield
            await asyncio.sleep(0)
        else:
            await ev.wait()

    async def generate(self, req):
        await self._arrive()
        return await self.srv(req)

    async def stream(self, req):
        await self._arrive()
        async for piece in await self.srv(dict(req, stream=True)):
            yield piece

    async def stats(self):
        return self.srv.scheduler_stats()

    async def launches(self, reset: bool = False):
        from ray_tpu_torch.ops.paged_attention import paged_attention

        out = (paged_attention.launches, dict(paged_attention.pair_launches))
        if reset:
            paged_attention.launches = 0
            paged_attention.pair_launches.clear()
        return out

    async def ping(self):
        return None

    async def info(self):
        import os

        import torch

        from ray_tpu_torch.models.transformer import map_params

        devices = set()
        map_params(lambda _p, t: devices.add(str(t.device)), self.srv.params)
        return {"init_s": self.init_s, "layers": self.srv.cfg.num_layers,
                "visible": os.environ.get("CUDA_VISIBLE_DEVICES"),
                "card": torch.cuda.get_device_name(),
                "param_devices": sorted(devices),
                "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}

    async def shutdown(self):
        self.srv.shutdown()


class CardProbe:
    """What a worker sees of the card, and the transfers' far end."""

    def info(self):
        import os

        import torch

        return {"visible": os.environ.get("CUDA_VISIBLE_DEVICES"),
                "cuda": torch.cuda.is_available(),
                "card": (torch.cuda.get_device_name()
                         if torch.cuda.is_available() else None)}

    def build_replica(self):
        """A llama_debug replica with no device named: on the card, or a
        refusal where the worker sees none."""
        from ray_tpu_torch import LLMServerImpl
        from ray_tpu_torch.models.transformer import map_params

        srv = LLMServerImpl(preset="llama_debug", share_weights=False)
        try:
            devices = set()
            map_params(lambda _p, t: devices.add(str(t.device)), srv.params)
            return sorted(devices)
        finally:
            srv.shutdown()

    def fetch(self, boxed, seed):
        """Get the tensor behind ``boxed[0]`` (timed here) and hold it bit
        for bit against the seeded payload regenerated on this card."""
        import torch

        import ray_tpu_torch as rt

        t0 = time.perf_counter()
        t = rt.get(boxed[0], timeout=RT_TIMEOUT)
        if t.is_cuda:
            torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        want = _payload(torch, seed)
        return {"seconds": dt, "device": str(t.device),
                "equal": _same_bits(torch, t.to(want.device), want)}



def _made_on_card(seed):
    """A task's return: a 1 GiB CUDA tensor, left on the worker's card."""
    import torch

    t = _payload(torch, seed)
    torch.cuda.synchronize()
    return t


class Noop:
    def ping(self):
        return None


def _consume(rt, gen):
    """A stream's pieces and the time its first arrived, every wait bounded
    by RT_TIMEOUT."""
    first, pieces = None, []
    while True:
        try:
            ref = gen.next(timeout=RT_TIMEOUT)
        except StopIteration:
            return first, pieces
        pieces.append(rt.get(ref, timeout=RT_TIMEOUT))
        if first is None:
            first = time.perf_counter()


def _actor_serve(torch, rt, serve) -> dict:
    """llama3_8b at full width and 32 layers in a num_gpus=1 actor, the
    serve phase's arena, slots, chunks and pages and its seed-0 bf16
    weights: the warm-up, then the 12 requests streamed, arriving
    together, request 5 sampled at 0.7; pings to the actor while it
    serves; K4's launches counted in the worker."""
    from concurrent.futures import ThreadPoolExecutor

    Host = rt.remote(ReplicaHost).options(num_gpus=1, max_concurrency=64)
    t0 = time.perf_counter()
    h = Host.remote(preset="llama3_8b", arena_len=ARENA_LEN,
                    max_new_tokens=SERVE_NEW_TOKENS, detokenize=_ids_text)
    info = rt.get(h.info.remote(), timeout=RT_TIMEOUT)
    start_s = time.perf_counter() - t0
    try:
        rt.get(h.generate.remote({"prompt": "warm up", "max_new_tokens": 2}),
               timeout=RT_TIMEOUT)
        reqs = [{"prompt": p} for p in _serve_prompts()]
        reqs[SAMPLED]["temperature"] = 0.7
        rt.get(h.launches.remote(reset=True), timeout=RT_TIMEOUT)
        before = rt.get(h.stats.remote(), timeout=RT_TIMEOUT)
        rt.get(h.expect.remote(len(reqs)), timeout=RT_TIMEOUT)
        pings = []
        with ThreadPoolExecutor(len(reqs)) as pool:
            t1 = time.perf_counter()
            gens = [h.stream.options(num_returns="streaming").remote(r)
                    for r in reqs]
            futs = [pool.submit(_consume, rt, g) for g in gens]
            while not all(f.done() for f in futs):
                p0 = time.perf_counter()
                rt.get(h.ping.remote(), timeout=RT_TIMEOUT)
                pings.append(time.perf_counter() - p0)
                time.sleep(0.05)
            outs = [f.result(timeout=RT_TIMEOUT) for f in futs]
        wall = time.perf_counter() - t1
        launches, pairs = rt.get(h.launches.remote(), timeout=RT_TIMEOUT)
        st = rt.get(h.stats.remote(), timeout=RT_TIMEOUT)
        texts = ["".join(pieces) for _, pieces in outs]
        # the same 12 again, whole, streamed, whole: the first pass left
        # their shared prefix in the cache, so these three start from the
        # same cache state, and the streamed pass between two whole ones
        # shows what the per-token reports to this process cost the
        # worker's scheduler thread, apart from the prefix cache and order
        again = [_actor_pass(rt, h, reqs, stream)
                 for stream in (False, True, False)]
        # one request alone, streamed and whole: the same batch and cache
        # state (a prompt under one page is never cached), so the same text
        solo = {"prompt": "warm up", "max_new_tokens": 8}
        g = h.stream.options(num_returns="streaming").remote(solo)
        streamed = "".join(_consume(rt, g)[1])
        whole = rt.get(h.generate.remote(solo), timeout=RT_TIMEOUT)["text"]
        info_after = rt.get(h.info.remote(), timeout=RT_TIMEOUT)
        rt.get(h.shutdown.remote(), timeout=RT_TIMEOUT)
    finally:
        rt.kill(h)
    _check_paged_run(texts, st)
    layers = info["layers"]
    steps = st["decode_steps"] - before["decode_steps"]
    chunks = st["prefill_chunks"] - before["prefill_chunks"]
    if not 0 < launches == layers * (chunks + steps):
        raise AssertionError(
            f"{launches} K4 launches in the worker, expected {layers} x "
            f"({chunks} prefill chunks + {steps} decode steps), above 0")
    if streamed != whole or len(_text_ids(whole)) != 8:
        raise AssertionError(f"streamed {streamed!r} != whole {whole!r}")
    if info["visible"] != "0" or info["param_devices"] != ["cuda:0"]:
        raise AssertionError(f"the replica's worker: {info}")
    equal = _equal_greedy(texts, serve["texts"])
    tokens = len(texts) * SERVE_NEW_TOKENS
    ttfts = [first - t1 for first, _ in outs]
    pings.sort()
    r = dict(start_s=start_s, weight_init_s=info["init_s"],
             requests=len(texts), tokens=tokens, wall_s=wall,
             tokens_per_s=tokens / wall,
             decode_step_ms=(st["decode_seconds"]
                             - before["decode_seconds"]) / steps * 1e3,
             ttft_mean_s=sum(ttfts) / len(ttfts), ttft_max_s=max(ttfts),
             decode_steps=steps, prefill_chunks=chunks, launches=launches,
             pair_launches=pairs,
             prefix_hits=st["prefix_hits"] - before.get("prefix_hits", 0),
             warm_passes=again,
             texts_equal_serve=equal,
             ping_during_serve_median_s=pings[len(pings) // 2],
             ping_during_serve_max_s=pings[-1], pings=len(pings),
             peak_mem_gb=info_after["peak_mem_gb"], worker=info)
    print(f"runtime serve: llama3_8b, {layers} layers, in a num_gpus=1 actor "
          f"(CUDA_VISIBLE_DEVICES={info['visible']}, {info['card']}, "
          f"params on {info['param_devices']}); up in {start_s:.2f} s "
          f"(weights {info['init_s']:.2f} s); {tokens} tokens in "
          f"{wall:.2f} s = {r['tokens_per_s']:.1f} tokens/s (in-process "
          f"{serve['tokens_per_s']:.1f}); decode step "
          f"{r['decode_step_ms']:.2f} ms (in-process "
          f"{serve['decode_step_ms']:.2f}); TTFT mean "
          f"{r['ttft_mean_s']:.3f} s, max {r['ttft_max_s']:.3f} s; "
          f"{launches} K4 launches in the worker = {layers} x ({chunks} + "
          f"{steps}); streamed = whole; {equal} of 11 temperature-0 texts "
          f"equal the serve phase's; {len(pings)} pings while serving, "
          f"median {r['ping_during_serve_median_s'] * 1e3:.2f} ms, max "
          f"{r['ping_during_serve_max_s'] * 1e3:.2f} ms; this pass "
          f"{chunks} prefill chunks, {r['prefix_hits']} prefix hits",
          flush=True)
    print("runtime serve, the same 12 again on the warm cache: " + "; ".join(
        f"{p['kind']} {p['tokens_per_s']:.1f} tokens/s, decode step "
        f"{p['decode_step_ms']:.2f} ms ({p['decode_steps']} steps), "
        f"{p['prefill_chunks']} prefill chunks, {p['prefix_hits']} prefix "
        f"hits" for p in again), flush=True)
    return r


def _actor_pass(rt, h, reqs, stream: bool) -> dict:
    """The requests once more through the host, arriving together,
    streamed or whole; every request must return all its tokens. Its
    tokens/s, decode-step ms and the scheduler's work in this pass."""
    before = rt.get(h.stats.remote(), timeout=RT_TIMEOUT)
    rt.get(h.expect.remote(len(reqs)), timeout=RT_TIMEOUT)
    t0 = time.perf_counter()
    if stream:
        from concurrent.futures import ThreadPoolExecutor

        gens = [h.stream.options(num_returns="streaming").remote(r)
                for r in reqs]
        with ThreadPoolExecutor(len(gens)) as pool:
            texts = ["".join(pieces) for _, pieces in pool.map(
                lambda g: _consume(rt, g), gens)]
    else:
        texts = [o["text"] for o in rt.get(
            [h.generate.remote(r) for r in reqs], timeout=RT_TIMEOUT)]
    wall = time.perf_counter() - t0
    st = rt.get(h.stats.remote(), timeout=RT_TIMEOUT)
    _check_paged_run(texts, st)
    steps = st["decode_steps"] - before["decode_steps"]
    return dict(kind="streamed" if stream else "whole", wall_s=wall,
                tokens_per_s=len(texts) * SERVE_NEW_TOKENS / wall,
                decode_step_ms=(st["decode_seconds"]
                                - before["decode_seconds"]) / steps * 1e3,
                decode_steps=steps,
                prefill_chunks=st["prefill_chunks"]
                - before["prefill_chunks"],
                prefix_hits=st["prefix_hits"] - before["prefix_hits"])


def _actor_parity(torch, rt) -> dict:
    """float32 llama_debug: an actor's texts on the card equal the
    in-process replica's on the card, on the same seeded weights."""
    from ray_tpu_torch import presets
    from ray_tpu_torch.models.transformer import init_params

    host = init_params(presets.llama_debug(), seed=0, device="cpu")
    local, _ = _parity_texts("llama_debug", host, "cuda")
    Host = rt.remote(ReplicaHost).options(num_gpus=1, max_concurrency=16)
    h = Host.remote(params=host, preset="llama_debug", max_new_tokens=8,
                    slots=4, prefill_chunk=8, page_tokens=4,
                    detokenize=_ids_text)
    prompts = ["hi", "hello 123", "a much longer prompt than the others!"]
    try:
        rt.get(h.expect.remote(len(prompts) * 3), timeout=RT_TIMEOUT)
        refs = [h.generate.remote({"prompt": p}) for p in prompts * 3]
        texts = [o["text"] for o in rt.get(refs, timeout=RT_TIMEOUT)]
        launches, _ = rt.get(h.launches.remote(), timeout=RT_TIMEOUT)
        rt.get(h.shutdown.remote(), timeout=RT_TIMEOUT)
    finally:
        rt.kill(h)
    if texts != local:
        raise AssertionError(f"actor texts {texts} != in-process {local}")
    if launches <= 0:
        raise AssertionError("the actor's llama_debug ran no K4 launch")
    print(f"runtime parity: float32 llama_debug, {len(texts)} texts from a "
          f"num_gpus=1 actor equal the in-process replica's on the card "
          f"({launches} K4 launches in the worker)", flush=True)
    return dict(texts_equal=True, requests=len(texts), launches=launches)


def _transfers(torch, rt, rt_api) -> dict:
    """1 GiB tensors through the object store, each bit for bit: a host
    tensor through the arena (put, get here, get in an actor); a CUDA
    tensor through put, whose copy stays on the card in this process's
    registry (the source is then written), then fetched by a GPU actor; a CUDA tensor returned by a
    num_gpus=1 task, fetched here."""
    gb = TRANSFER_BYTES / 1e9
    probe = rt.remote(CardProbe).options(num_gpus=1).remote()
    try:
        rt.get(probe.info.remote(), timeout=RT_TIMEOUT)  # up
        host = _payload(torch, 1).cpu()
        t0 = time.perf_counter()
        ref = rt.put(host)
        put_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        back = rt.get(ref, timeout=RT_TIMEOUT)
        get_s = time.perf_counter() - t0
        if not _same_bits(torch, back, host):
            raise AssertionError("the host tensor came back changed")
        del back
        far = rt.get(probe.fetch.remote([ref], 1), timeout=RT_TIMEOUT)
        if not far["equal"]:
            raise AssertionError(f"the actor's host tensor differs: {far}")
        del ref, host
        dev = _payload(torch, 2)
        n0 = len(rt_api._core.device_objects)
        t0 = time.perf_counter()
        dref = rt.put(dev)
        dput_s = time.perf_counter() - t0
        if len(rt_api._core.device_objects) != n0 + 1:
            raise AssertionError("put of a CUDA tensor did not register a "
                                 "device object")
        # the registry holds a copy taken at put: writing the source in
        # place, or the owner's result, changes neither the owner's next
        # get nor the actor's fetch
        dev.add_(1)
        mine = rt.get(dref, timeout=RT_TIMEOUT)
        if mine.data_ptr() == dev.data_ptr() or not _same_bits(
                torch, mine, _payload(torch, 2)):
            raise AssertionError("the owner's get of its device object is "
                                 "not the value put")
        mine.zero_()
        if not _same_bits(torch, rt.get(dref, timeout=RT_TIMEOUT),
                          _payload(torch, 2)):
            raise AssertionError("a write to the owner's get reached the "
                                 "device object")
        del mine
        dfar = rt.get(probe.fetch.remote([dref], 2), timeout=RT_TIMEOUT)
        if not dfar["equal"] or not dfar["device"].startswith("cuda"):
            raise AssertionError(f"the actor's CUDA tensor: {dfar}")
        del dref, dev
    finally:
        rt.kill(probe)
    # the task's worker holds the card once the probe has let it go
    mref = rt.remote(num_gpus=1)(_made_on_card).remote(3)
    rt.wait([mref], timeout=RT_TIMEOUT)
    t0 = time.perf_counter()
    made = rt.get(mref, timeout=RT_TIMEOUT)
    torch.cuda.synchronize()
    ret_s = time.perf_counter() - t0
    if not made.is_cuda or not _same_bits(torch, made, _payload(torch, 3)):
        raise AssertionError("the task's CUDA tensor came back changed")
    del made, mref
    r = dict(bytes=TRANSFER_BYTES,
             host_put_gb_s=gb / put_s, host_get_gb_s=gb / get_s,
             host_actor_get_gb_s=gb / far["seconds"],
             device_put_s=dput_s,
             device_actor_get_gb_s=gb / dfar["seconds"],
             device_return_get_gb_s=gb / ret_s)
    print(f"runtime transfers, 1 GiB each, bit for bit: host tensor put "
          f"{r['host_put_gb_s']:.2f} GB/s, get {r['host_get_gb_s']:.2f} "
          f"GB/s, actor get {r['host_actor_get_gb_s']:.2f} GB/s (the "
          f"arena); CUDA tensor put {dput_s * 1e3:.2f} ms (a device object,"
          f" registry +1), actor get {r['device_actor_get_gb_s']:.2f} GB/s;"
          f" a task's 1 GiB CUDA return fetched at "
          f"{r['device_return_get_gb_s']:.2f} GB/s", flush=True)
    return r


def runtime_phase(torch, serve) -> dict:
    """The port's runtime on this machine: ``rt.init()`` finds one GPU; a
    GPU-less actor refuses to build a replica with no device, a GPU actor
    sees the card; llama3_8b served from a num_gpus=1 actor; float32
    parity of an actor's texts at llama_debug; 1 GiB tensors through the
    object store; the round trip of a no-op actor call."""
    import ray_tpu_torch as rt
    from ray_tpu_torch._private import api as rt_api

    t0 = time.perf_counter()
    rt.init(object_store_memory=3 * 2 ** 30)
    try:
        init_s = time.perf_counter() - t0
        res = rt.cluster_resources()
        if res.get("GPU") != 1:
            raise AssertionError(f"cluster resources {res}: not one GPU")
        noop = rt.remote(Noop).remote()
        rt.get(noop.ping.remote(), timeout=RT_TIMEOUT)
        trips = []
        for _ in range(NOOP_CALLS):
            p0 = time.perf_counter()
            rt.get(noop.ping.remote(), timeout=RT_TIMEOUT)
            trips.append(time.perf_counter() - p0)
        rt.kill(noop)
        trips.sort()
        cpu_probe = rt.remote(CardProbe).remote()
        seen = rt.get(cpu_probe.info.remote(), timeout=RT_TIMEOUT)
        if seen["visible"] != "" or seen["cuda"]:
            raise AssertionError(f"a GPU-less actor sees a card: {seen}")
        try:
            rt.get(cpu_probe.build_replica.remote(), timeout=RT_TIMEOUT)
        except rt.TaskError as e:
            if "no CUDA device" not in str(e):
                raise
        else:
            raise AssertionError("a GPU-less actor built a replica")
        rt.kill(cpu_probe)
        gpu_probe = rt.remote(CardProbe).options(num_gpus=1).remote()
        seen = rt.get(gpu_probe.info.remote(), timeout=RT_TIMEOUT)
        built = rt.get(gpu_probe.build_replica.remote(), timeout=RT_TIMEOUT)
        rt.kill(gpu_probe)
        if (seen["visible"] != "0" or seen["card"]
                != torch.cuda.get_device_name(0) or built != ["cuda:0"]):
            raise AssertionError(f"the GPU actor sees {seen}, its replica's "
                                 f"params are on {built}")
        store = rt_api._core._run(rt_api._core.clients.get(
            rt_api._core.supervisor_addr).call("store_stats"),
            timeout=RT_TIMEOUT)
        free_list = ("the C++ one (_native/allocator.cpp)"
                     if store["native_allocator"] else "the Python one")
        print(f"runtime: cluster up in {init_s:.2f} s, resources GPU "
              f"{res['GPU']:g}, CPU {res['CPU']:g}; a no-op actor call's "
              f"round trip median {trips[NOOP_CALLS // 2] * 1e3:.3f} ms "
              f"({NOOP_CALLS} calls); a GPU-less actor sees "
              f"CUDA_VISIBLE_DEVICES='' and its replica refuses; the GPU "
              f"actor sees '{seen['visible']}' ({seen['card']}), replica "
              f"params on {built}; object store free list: {free_list}",
              flush=True)
        r = dict(init_s=init_s, resources=res,
                 noop_median_ms=trips[NOOP_CALLS // 2] * 1e3,
                 noop_p90_ms=trips[int(NOOP_CALLS * 0.9)] * 1e3,
                 free_list=free_list)
        r["serve"] = _actor_serve(torch, rt, serve)
        r["parity"] = _actor_parity(torch, rt)
        r["transfers"] = _transfers(torch, rt, rt_api)
    finally:
        rt.shutdown()
    return r


# ------------------------------------------------------------- serve-app

# the serve-app phase's arena: llama3_8b's 16.06 GB tree once, plus room
# for the phase's other objects (requests, the float32 llama_debug tree),
# and below the store's 0.8 spilling threshold with the tree in it
SERVE_APP_STORE = 24 * 2 ** 30
SERVE_APP_KEY = "llm:llama3_8b:seed0"   # LLMServerImpl's default key
PARITY_PROMPTS = ["hi", "hello 123", "a much longer prompt than the others!"]


def _leaf_sums(torch, params) -> dict:
    """Per leaf: the sum of its bytes read as int32 words (int16, then
    bytes, where the size does not divide), in int64, on the leaf's
    device. Equal trees give equal sums."""
    from ray_tpu_torch.models.transformer import map_params

    out = {}

    def leaf(path, t):
        raw = t.detach().contiguous().reshape(-1).view(torch.uint8)
        for dt, size in ((torch.int32, 4), (torch.int16, 2),
                         (torch.uint8, 1)):
            if raw.numel() % size == 0:
                break
        out[path] = int(raw.view(dt).sum(dtype=torch.int64))

    map_params(leaf, params)
    return out


def _make_serve_app_llm():
    """The LLM deployment's class with probes into its replica process:
    K4's launch counter (this process's counter does not see the worker's
    launches), where the params live, the init time and per-leaf sums."""
    from ray_tpu_torch.serve.llm import LLMServerImpl

    class ServeAppLLM(LLMServerImpl):
        def __init__(self, **kw):
            import torch

            t0 = time.perf_counter()
            super().__init__(**kw)
            if self.device.type == "cuda":
                torch.cuda.synchronize()
            self.init_s = time.perf_counter() - t0

        def launches(self, reset: bool = False):
            from ray_tpu_torch.ops.paged_attention import paged_attention

            out = (paged_attention.launches,
                   dict(paged_attention.pair_launches))
            if reset:
                paged_attention.launches = 0
                paged_attention.pair_launches.clear()
            return out

        def info(self):
            import os

            import torch

            from ray_tpu_torch.models.transformer import map_params

            devices = set()
            map_params(lambda _p, t: devices.add(str(t.device)), self.params)
            return {"init_s": self.init_s, "layers": self.cfg.num_layers,
                    "visible": os.environ.get("CUDA_VISIBLE_DEVICES"),
                    "card": torch.cuda.get_device_name(),
                    "param_devices": sorted(devices),
                    "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}

        def leaf_sums(self):
            import torch

            return _leaf_sums(torch, self.params)

    return ServeAppLLM


def _attach_shared(key):
    """A GPU-less task: attach to the node's published tree under ``key``
    with a loader that refuses, and sum its leaves on the CPU."""
    import os

    import torch

    from ray_tpu_torch.serve._private import weights

    def refuse():
        raise AssertionError("the attach must not run the loader")

    t0 = time.perf_counter()
    params, info = weights.get_or_publish(key, refuse)
    attach_s = time.perf_counter() - t0
    return {"info": info, "attach_s": attach_s,
            "visible": os.environ.get("CUDA_VISIBLE_DEVICES"),
            "sums": _leaf_sums(torch, params)}


def _store_used(rt_api) -> int:
    core = rt_api._core
    st = core._run(core.clients.get(core.supervisor_addr).call(
        "store_stats"), timeout=RT_TIMEOUT)
    return int(st["capacity"] - st["free_bytes"])


def _named_worker(rt_api, name: str) -> dict:
    """A named actor's worker: the cards its supervisor gave it and the
    CUDA_VISIBLE_DEVICES its process runs under."""
    core = rt_api._core
    rec = core._run(core.clients.get(core.controller_addr).call(
        "actor_by_name", {"name": name, "namespace": "default"}),
        timeout=RT_TIMEOUT)
    sup = core.clients.get(core.supervisor_addr)
    wid = rec["worker_id_hex"]
    gpus = core._run(sup.call("gpu_visible_devices",
                              {"worker_id_hex": wid}), timeout=RT_TIMEOUT)
    workers = core._run(sup.call("worker_profile", {}),
                        timeout=RT_TIMEOUT)["workers"]
    pid = next(w["pid"] for w in workers if w["worker_id_hex"] == wid)
    env = Path(f"/proc/{pid}/environ").read_bytes().split(b"\0")
    visible = next((e.split(b"=", 1)[1].decode() for e in env
                    if e.startswith(b"CUDA_VISIBLE_DEVICES=")), None)
    return {"gpus": gpus, "visible": visible, "detached": rec["detached"]}


def _timed_pass(h, kind: str, run) -> dict:
    """One pass of requests sent together: ``run(t0)`` sends them and
    returns their texts and TTFTs (seconds from ``t0`` on this clock;
    empty when not measured). Every request must return all its tokens.
    Its tokens/s, TTFT, decode-step ms and the scheduler's work in this
    pass, read from the replica."""
    before = h.scheduler_stats.remote().result(timeout=RT_TIMEOUT)
    t0 = time.perf_counter()
    texts, ttfts = run(t0)
    wall = time.perf_counter() - t0
    st = h.scheduler_stats.remote().result(timeout=RT_TIMEOUT)
    _check_paged_run(texts, st)
    steps = st["decode_steps"] - before["decode_steps"]
    r = dict(kind=kind, wall_s=wall,
             tokens_per_s=len(texts) * SERVE_NEW_TOKENS / wall,
             decode_step_ms=(st["decode_seconds"]
                             - before["decode_seconds"]) / steps * 1e3,
             decode_steps=steps,
             prefill_chunks=st["prefill_chunks"] - before["prefill_chunks"],
             prefix_hits=st["prefix_hits"] - before["prefix_hits"],
             texts=texts)
    if ttfts:
        r.update(ttft_mean_s=sum(ttfts) / len(ttfts), ttft_max_s=max(ttfts))
    return r


def _handle_pass(rt, h, reqs, stream: bool) -> dict:
    """The requests through the handle, sent together, streamed
    (``options(stream=True)``, TTFT the first piece) or whole."""
    from concurrent.futures import ThreadPoolExecutor

    def run(t0):
        if not stream:
            resps = [h.remote(r) for r in reqs]
            return [r.result(timeout=RT_TIMEOUT)["text"] for r in resps], []
        sh = h.options(stream=True)
        gens = [sh.remote(dict(r, stream=True)).ref for r in reqs]
        with ThreadPoolExecutor(len(gens)) as pool:
            outs = list(pool.map(lambda g: _consume(rt, g), gens))
        return (["".join(pieces) for _, pieces in outs],
                [first - t0 for first, _ in outs])

    return _timed_pass(h, "streamed" if stream else "whole", run)


def _http(port: int, path: str, body=None, t0=None):
    """One request to the serve proxy through ``http.client``: POST of
    ``body`` as JSON (GET without one). Returns (status, headers, the time
    its first body bytes arrived, seconds from ``t0``, and the body)."""
    import http.client

    t0 = time.perf_counter() if t0 is None else t0
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=RT_TIMEOUT)
    try:
        if body is None:
            conn.request("GET", path)
        else:
            conn.request("POST", path, body=json.dumps(body),
                         headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        first, pieces = None, []
        while True:
            data = resp.read1(1 << 16)
            if not data:
                break
            if first is None:
                first = time.perf_counter() - t0
            pieces.append(data)
        return (resp.status, {k.lower(): v for k, v in resp.getheaders()},
                first, b"".join(pieces))
    finally:
        conn.close()


def _http_text(port: int, path: str, req: dict, t0=None):
    """A request's text over HTTP, whole (the JSON reply's ``text``) or,
    when ``req`` streams, the chunked body; and its TTFT from ``t0``."""
    status, headers, first, body = _http(port, path, req, t0)
    stream = bool(req.get("stream"))
    if status != 200 or (headers.get("x-serve-stream") == "1") != stream:
        raise AssertionError(f"POST {path}: {status} {headers} {body[:300]}")
    if not stream:
        return json.loads(body)["text"], first
    text = body.decode()
    if "[stream " in text:
        raise AssertionError(f"POST {path}: the stream failed: {text[-300:]}")
    return text, first


def _rpc_text(client, app: str, req: dict, t0=None):
    """A request's text over the RPC ingress (``invoke``, or
    ``invoke_stream`` when ``req`` streams) and its TTFT from ``t0``."""
    t0 = time.perf_counter() if t0 is None else t0
    if not req.get("stream"):
        text = client.invoke(app, req)["text"]
        return text, time.perf_counter() - t0
    first, pieces = None, []
    for piece in client.invoke_stream(app, req):
        if first is None:
            first = time.perf_counter() - t0
        pieces.append(piece)
    return "".join(pieces), first


def _ingress_pass(h, reqs, send, kind: str) -> dict:
    """The requests through an ingress, sent together from one thread
    each: ``send(req, t0)`` returns (text, TTFT)."""
    from concurrent.futures import ThreadPoolExecutor

    def run(t0):
        with ThreadPoolExecutor(len(reqs)) as pool:
            outs = list(pool.map(lambda r: send(r, t0), reqs))
        return [t for t, _ in outs], [f for _, f in outs]

    return _timed_pass(h, kind, run)


def _wait_route(port: int, prefix: str) -> dict:
    """The proxy's route table once it lists ``prefix`` (it refreshes
    every second)."""
    deadline = time.monotonic() + RT_TIMEOUT
    while True:
        routes = json.loads(_http(port, "/-/routes")[3])
        if prefix in routes:
            return routes
        if time.monotonic() > deadline:
            raise AssertionError(f"the proxy never routed {prefix}: {routes}")
        time.sleep(0.2)


def _serve_app_ingress(rt_api, serve, h, reqs, layers, solo_text) -> dict:
    """llama3_8b, already RUNNING behind ``serve.run``, over the ingress:
    ``serve.start`` (the HTTP proxy) and ``serve.start_rpc_ingress`` driven
    with the standard library and the port's ``ServeRpcClient``."""
    from ray_tpu_torch.serve import PROXY_NAME, RPC_INGRESS_NAME
    from ray_tpu_torch.serve.rpc_ingress_client import ServeRpcClient

    t0 = time.perf_counter()
    http_port = serve.start(http_port=0)
    rpc_port = serve.start_rpc_ingress()
    start_s = time.perf_counter() - t0
    health = _http(http_port, "/-/healthz")
    routes = _wait_route(http_port, "/llama3_8b")
    workers = {name: _named_worker(rt_api, name)
               for name in (PROXY_NAME, RPC_INGRESS_NAME)}
    if health[0] != 200 or health[3] != b"ok":
        raise AssertionError(f"/-/healthz: {health}")
    if routes["/llama3_8b"] != "llama3_8b/llm":
        raise AssertionError(f"/-/routes: {routes}")
    for name, w in workers.items():
        if w["gpus"] != [] or w["visible"] != "":
            raise AssertionError(f"the {name} worker: {w}")
    client = ServeRpcClient(f"127.0.0.1:{rpc_port}",
                            request_timeout_s=RT_TIMEOUT)
    try:
        def http_send(r, t0):
            return _http_text(http_port, "/llama3_8b", r, t0)

        def rpc_send(r, t0):
            return _rpc_text(client, "llama3_8b", r, t0)

        streamed = [dict(r, stream=True) for r in reqs]
        h.launches.remote(reset=True).result(timeout=RT_TIMEOUT)
        cold = _ingress_pass(h, streamed, http_send, "http streamed")
        launches, _ = h.launches.remote().result(timeout=RT_TIMEOUT)
        steps, chunks = cold["decode_steps"], cold["prefill_chunks"]
        if not 0 < launches == layers * (chunks + steps):
            raise AssertionError(
                f"{launches} K4 launches in the replica over HTTP, expected "
                f"{layers} x ({chunks} prefill chunks + {steps} decode "
                f"steps), above 0")
        warm = [_ingress_pass(h, rs, send, kind) for rs, send, kind in (
            (reqs, http_send, "http whole"),
            (streamed, http_send, "http streamed"),
            (reqs, rpc_send, "rpc whole"),
            (streamed, rpc_send, "rpc streamed"))]
        solo = {"prompt": "warm up", "max_new_tokens": 8}
        solos = {"http whole": http_send(solo, None)[0],
                 "http streamed": http_send(dict(solo, stream=True),
                                            None)[0],
                 "rpc whole": rpc_send(solo, None)[0],
                 "rpc streamed": rpc_send(dict(solo, stream=True), None)[0]}
    finally:
        client.close()
    if any(t != solo_text for t in solos.values()):
        raise AssertionError(f"solo texts over the ingress {solos} != the "
                             f"handle's {solo_text!r}")
    step = {p["kind"]: p["decode_step_ms"] for p in warm}
    return dict(start_s=start_s, http_port=http_port, rpc_port=rpc_port,
                routes=routes, workers=workers, launches=launches,
                cold={k: v for k, v in cold.items() if k != "texts"},
                warm=[{k: v for k, v in p.items() if k != "texts"}
                      for p in warm],
                http_streamed_over_whole_step=(step["http streamed"]
                                               / step["http whole"]),
                rpc_streamed_over_whole_step=(step["rpc streamed"]
                                              / step["rpc whole"]),
                texts=cold["texts"])


def _serve_app_llama3_8b(torch, rt, rt_api, serve, LLM, cls, serve_ref,
                         runtime) -> dict:
    """llama3_8b through serve.run in a num_gpus=1 ReplicaActor: deploy,
    the GPU-less attach, the 12 requests through the handle and the warm
    alternating passes, then the same over the HTTP proxy and the RPC
    ingress."""
    from ray_tpu_torch.serve._private.controller import CONTROLLER_NAME

    t0 = time.perf_counter()
    app = LLM.options(func_or_class=cls, num_replicas=1,
                      ray_actor_options={"num_gpus": 1}).bind(
        preset="llama3_8b", arena_len=ARENA_LEN,
        max_new_tokens=SERVE_NEW_TOKENS, detokenize=_ids_text)
    h = serve.run(app, name="llama3_8b", route_prefix="/llama3_8b",
                  timeout_s=RT_TIMEOUT)
    deploy_s = time.perf_counter() - t0
    status = serve.status()["llama3_8b"]["llm"]
    winfo = h.weights_info.remote().result(timeout=RT_TIMEOUT)
    info = h.info.remote().result(timeout=RT_TIMEOUT)
    ctl = _named_worker(rt_api, CONTROLLER_NAME)
    if status["status"] != "RUNNING" or status["replicas"] != 1:
        raise AssertionError(f"serve.status(): {status}")
    if winfo["mode"] != "published" or not winfo["shared"] or \
            winfo["key"] != SERVE_APP_KEY:
        raise AssertionError(f"the replica's weights: {winfo}")
    if info["visible"] != "0" or info["param_devices"] != ["cuda:0"]:
        raise AssertionError(f"the replica's worker: {info}")
    if ctl["gpus"] != [] or ctl["visible"] != "" or not ctl["detached"]:
        raise AssertionError(f"the controller's worker: {ctl}")
    # ---- the published tree, attached by a GPU-less task on the node
    used0 = _store_used(rt_api)
    att = rt.get(rt.remote(_attach_shared).remote(SERVE_APP_KEY),
                 timeout=RT_TIMEOUT)
    used1 = _store_used(rt_api)
    sums = h.leaf_sums.remote().result(timeout=RT_TIMEOUT)
    if att["info"]["mode"] != "attached" or att["visible"] != "":
        raise AssertionError(f"the GPU-less attach: {att['info']}, "
                             f"CUDA_VISIBLE_DEVICES={att['visible']!r}")
    if used1 > used0:
        raise AssertionError(f"the attach grew the arena: {used0} -> "
                             f"{used1} bytes")
    if att["sums"] != sums:
        bad = [k for k in sums if att["sums"].get(k) != sums[k]]
        raise AssertionError(f"{len(bad)} leaves differ, e.g. {bad[:3]}")
    print(f"serve-app: serve.run(LLMServer llama3_8b, {info['layers']} "
          f"layers, num_gpus=1) RUNNING in {deploy_s:.2f} s (the replica's "
          f"__init__ {info['init_s']:.2f} s: get_or_publish "
          f"{winfo['seconds']:.2f} s = loader and copy to the host "
          f"{winfo['load_seconds']:.2f} s + arena put "
          f"{winfo['put_seconds']:.2f} s + views); weights {winfo['mode']},"
          f" {winfo['nbytes'] / 1e9:.2f} GB in the arena ({used0 / 1e9:.2f}"
          f" GB used); replica CUDA_VISIBLE_DEVICES={info['visible']} "
          f"params on {info['param_devices']}; controller worker cards "
          f"{ctl['gpus']}, CUDA_VISIBLE_DEVICES={ctl['visible']!r}; a "
          f"GPU-less task attached in {att['attach_s']:.2f} s, arena "
          f"{used1 / 1e9:.2f} GB used after, {len(sums)} leaf sums equal",
          flush=True)
    # ---- the serve phase's warm-up and 12 requests through the handle
    h.remote({"prompt": "warm up", "max_new_tokens": 2}).result(
        timeout=RT_TIMEOUT)
    reqs = [{"prompt": p} for p in _serve_prompts()]
    reqs[SAMPLED]["temperature"] = 0.7
    h.launches.remote(reset=True).result(timeout=RT_TIMEOUT)
    first = _handle_pass(rt, h, reqs, stream=True)
    launches, pairs = h.launches.remote().result(timeout=RT_TIMEOUT)
    layers = info["layers"]
    steps, chunks = first["decode_steps"], first["prefill_chunks"]
    if not 0 < launches == layers * (chunks + steps):
        raise AssertionError(
            f"{launches} K4 launches in the replica, expected {layers} x "
            f"({chunks} prefill chunks + {steps} decode steps), above 0")
    # warm cache: whole, streamed, whole, streamed; each pass starts from
    # the same cached prefix, so pairs read streaming's cost apart from it
    warm = [_handle_pass(rt, h, reqs, stream)
            for stream in (False, True, False, True)]
    solo = {"prompt": "warm up", "max_new_tokens": 8}
    streamed = "".join(_consume(rt, h.options(stream=True).remote(
        dict(solo, stream=True)).ref)[1])
    whole = h.remote(solo).result(timeout=RT_TIMEOUT)["text"]
    if streamed != whole or len(_text_ids(whole)) != 8:
        raise AssertionError(f"streamed {streamed!r} != whole {whole!r}")
    ingress = _serve_app_ingress(rt_api, serve, h, reqs, layers, whole)
    peak = h.info.remote().result(timeout=RT_TIMEOUT)["peak_mem_gb"]
    # phase 13 (d), against this replica: its push_weights to a new replica
    push = _push_weights(rt, h, sums, winfo["nbytes"])
    serve.delete("llama3_8b")
    equal = _equal_greedy(first["texts"], serve_ref["texts"])
    ingress["texts_equal_serve"] = _equal_greedy(ingress.pop("texts"),
                                                 serve_ref["texts"])
    ratio = (sum(p["decode_step_ms"] for p in warm if p["kind"] ==
                 "streamed") / sum(p["decode_step_ms"] for p in warm
                                   if p["kind"] == "whole"))
    rtx = runtime["serve"]
    r = dict(deploy_s=deploy_s, replica_init_s=info["init_s"],
             weights=winfo, arena_used_bytes=used0,
             attach=dict(att["info"], seconds=att["attach_s"],
                         arena_used_after=used1, leaves=len(sums)),
             controller=ctl, launches=launches, pair_launches=pairs,
             first={k: v for k, v in first.items() if k != "texts"},
             warm=[{k: v for k, v in p.items() if k != "texts"}
                   for p in warm],
             streamed_over_whole_step=ratio, texts_equal_serve=equal,
             ingress=ingress, peak_mem_gb=peak, push_weights=push,
             texts=first["texts"])
    print(f"serve-app: 12 requests streamed through the handle, sent "
          f"together: {first['tokens_per_s']:.1f} tokens/s (in-process "
          f"serve {serve_ref['tokens_per_s']:.1f}, runtime ReplicaHost "
          f"{rtx['tokens_per_s']:.1f}); decode step "
          f"{first['decode_step_ms']:.2f} ms (in-process "
          f"{serve_ref['decode_step_ms']:.2f}, ReplicaHost "
          f"{rtx['decode_step_ms']:.2f}); TTFT mean "
          f"{first['ttft_mean_s']:.3f} s, max {first['ttft_max_s']:.3f} s;"
          f" {launches} K4 launches in the replica = {layers} x ({chunks} + "
          f"{steps}); {first['prefix_hits']} prefix hits; streamed = whole;"
          f" {equal} of 11 temperature-0 texts equal the serve phase's; "
          f"peak {peak:.1f} GB", flush=True)
    print("serve-app, the same 12 on the warm cache: " + "; ".join(
        f"{p['kind']} {p['tokens_per_s']:.1f} tokens/s, decode step "
        f"{p['decode_step_ms']:.2f} ms ({p['decode_steps']} steps), "
        f"{p['prefill_chunks']} prefill chunks, {p['prefix_hits']} prefix "
        f"hits" for p in warm) + f"; streamed/whole decode step {ratio:.3f}",
        flush=True)
    ing, cold = ingress, ingress["cold"]
    print(f"serve-app ingress: serve.start and serve.start_rpc_ingress up "
          f"in {ing['start_s']:.2f} s; /-/healthz ok, /-/routes "
          f"{ing['routes']}; proxy and RPC ingress workers "
          + ", ".join(f"{n}: cards {w['gpus']}, CUDA_VISIBLE_DEVICES="
                      f"{w['visible']!r}"
                      for n, w in ing["workers"].items())
          + f"; the 12 streamed over HTTP, sent together: "
          f"{cold['tokens_per_s']:.1f} tokens/s (handle "
          f"{first['tokens_per_s']:.1f}), decode step "
          f"{cold['decode_step_ms']:.2f} ms, TTFT mean "
          f"{cold['ttft_mean_s']:.3f} s, max {cold['ttft_max_s']:.3f} s; "
          f"{ing['launches']} K4 launches = {layers} x "
          f"({cold['prefill_chunks']} + {cold['decode_steps']}); "
          f"{cold['prefix_hits']} prefix hits; solo texts streamed = whole "
          f"over both; {ing['texts_equal_serve']} of 11 temperature-0 texts"
          f" equal the serve phase's", flush=True)
    print("serve-app ingress, warm: " + "; ".join(
        f"{p['kind']} {p['tokens_per_s']:.1f} tokens/s, decode step "
        f"{p['decode_step_ms']:.2f} ms ({p['decode_steps']} steps), TTFT "
        f"mean {p['ttft_mean_s']:.3f} s, {p['prefill_chunks']} prefill "
        f"chunks, {p['prefix_hits']} prefix hits" for p in ing["warm"])
        + f"; streamed/whole decode step: HTTP "
        f"{ing['http_streamed_over_whole_step']:.3f}, RPC "
        f"{ing['rpc_streamed_over_whole_step']:.3f}, handle {ratio:.3f}",
        flush=True)
    return r


def _serve_app_parity(torch, rt, serve, LLM, cls) -> dict:
    """float32 llama_debug, one request at a time: the texts through the
    handle, over HTTP and over the RPC ingress from a num_gpus=1 replica
    equal the in-process replica's on the card, on the same seeded
    weights (published into the arena)."""
    from ray_tpu_torch import LLMServerImpl, presets
    from ray_tpu_torch.models.transformer import init_params
    from ray_tpu_torch.serve.rpc_ingress_client import ServeRpcClient

    host = init_params(presets.llama_debug(), seed=0, device="cpu")
    kw = dict(max_new_tokens=8, slots=4, prefill_chunk=8, page_tokens=4,
              detokenize=_ids_text)
    srv = LLMServerImpl(preset="llama_debug", device="cuda",
                        params_loader=lambda c: host, **kw)
    try:
        local = [asyncio.run(srv({"prompt": p}))["text"]
                 for p in PARITY_PROMPTS * 3]
    finally:
        srv.shutdown()
    app = LLM.options(func_or_class=cls, num_replicas=1,
                      ray_actor_options={"num_gpus": 1}).bind(
        preset="llama_debug", params_loader=lambda c: host,
        weights_key="llm:llama_debug:chip-smoke", **kw)
    h = serve.run(app, name="llama_debug", route_prefix="/llama_debug",
                  timeout_s=RT_TIMEOUT)
    texts = [h.remote({"prompt": p}).result(timeout=RT_TIMEOUT)["text"]
             for p in PARITY_PROMPTS * 3]
    http_port = serve.start(http_port=0)
    _wait_route(http_port, "/llama_debug")
    http_texts = [_http_text(http_port, "/llama_debug", {"prompt": p})[0]
                  for p in PARITY_PROMPTS * 3]
    client = ServeRpcClient(f"127.0.0.1:{serve.start_rpc_ingress()}",
                            request_timeout_s=RT_TIMEOUT)
    try:
        rpc_texts = [client.invoke("llama_debug", {"prompt": p})["text"]
                     for p in PARITY_PROMPTS * 3]
    finally:
        client.close()
    launches, _ = h.launches.remote().result(timeout=RT_TIMEOUT)
    mode = h.weights_info.remote().result(timeout=RT_TIMEOUT)["mode"]
    for how, got in (("handle", texts), ("HTTP", http_texts),
                     ("RPC", rpc_texts)):
        if got != local:
            raise AssertionError(f"{how} texts {got} != in-process {local}")
    if launches <= 0 or mode != "published":
        raise AssertionError(f"the float32 replica: {launches} K4 "
                             f"launches, weights {mode}")
    print(f"serve-app parity: float32 llama_debug, {len(texts)} texts "
          f"each through the handle, over HTTP and over the RPC ingress "
          f"from a num_gpus=1 replica (weights {mode}) equal the in-process "
          f"replica's on the card ({launches} K4 launches in the replica)",
          flush=True)
    return dict(texts_equal=True, requests=len(texts), launches=launches)


def serve_app_phase(torch, serve_ref, runtime) -> dict:
    """The serve library on the card: llama3_8b through ``serve.run`` and
    its ``DeploymentHandle``, the GPU-less attach of its published tree,
    float32 parity through the handle, and ``serve.shutdown`` giving the
    card back."""
    import ray_tpu_torch as rt
    from ray_tpu_torch import serve
    from ray_tpu_torch._private import api as rt_api
    from ray_tpu_torch.serve.llm import LLMServer

    cls = _make_serve_app_llm()
    t0 = time.perf_counter()
    rt.init(object_store_memory=SERVE_APP_STORE)
    try:
        init_s = time.perf_counter() - t0
        r = {"init_s": init_s}
        r["llama3_8b"] = _serve_app_llama3_8b(
            torch, rt, rt_api, serve, LLMServer, cls, serve_ref, runtime)
        r["parity"] = _serve_app_parity(torch, rt, serve, LLMServer, cls)
        t1 = time.perf_counter()
        serve.shutdown()
        probe = rt.remote(CardProbe).options(num_gpus=1).remote()
        seen = rt.get(probe.info.remote(), timeout=120)
        rt.kill(probe)
        if seen["visible"] != "0":
            raise AssertionError(f"after serve.shutdown: {seen}")
        r["card_back_s"] = time.perf_counter() - t1
        print(f"serve-app: serve.shutdown() gave the card back: a "
              f"num_gpus=1 actor up {r['card_back_s']:.2f} s after it",
              flush=True)
    finally:
        rt.shutdown()
    return r


def _free(torch):
    """Drop a finished phase's server (16 GB of llama3_8b weights) from the
    card before the next phase builds its own."""
    import gc

    gc.collect()
    torch.cuda.empty_cache()


# ------------------------------------------------------------- dp-train

DP_CKPT_STEP = 3          # (b) reports a checkpoint at this step (0: warm-up)
DP_GROUP = "train_grads"
# (c) mixed world 2: llama_debug in float32, each rank half of 4 rows
DP_MIXED_ROWS, DP_MIXED_SEQ = 4, 48


def _dp_gpt2_loop(config):
    """(b), in the train worker: gpt2_small at the train phase's settings,
    seed and batch; each step's grads averaged with ``allreduce_coalesced``
    (MEAN) on an NCCL group, ``train.report`` every step (the host clock
    over the step ends in the loss's read), a checkpoint at
    ``DP_CKPT_STEP``; the flash launch counters of this process go to 0
    before the warm-up step and are reported with the last step."""
    import os
    import tempfile

    import torch

    from ray_tpu_torch import train
    from ray_tpu_torch._private.device import resolve_device
    from ray_tpu_torch.models import presets
    from ray_tpu_torch.models.training import (OptimizerConfig,
                                               init_train_state)
    from ray_tpu_torch.models.transformer import (_leaves, count_params,
                                                  loss_fn, map_params)
    from ray_tpu_torch.ops import flash_attention as fa
    from ray_tpu_torch.util import collective as col

    resolve_device()  # TF32 off, as in the driver
    ctx = train.get_context()
    col.init_collective_group(ctx.get_world_size(), ctx.get_world_rank(),
                              backend="nccl", group_name=DP_GROUP)
    cfg = presets.gpt2_small(remat=False, ce_chunk=8192)
    B, S = config["batch"], config["seq"]
    state, tx = init_train_state(
        cfg, OptimizerConfig(warmup_steps=10, decay_steps=1000), seed=0)
    g = torch.Generator(device="cuda").manual_seed(1)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (B, S), generator=g,
                                     device="cuda")}
    leaves = _leaves(state.params)
    _reset_counters(fa)
    start, stop = torch.cuda.Event(True), torch.cuda.Event(True)
    for i in range(1 + config["steps"]):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        value, m = loss_fn(cfg, state.params, batch)
        grads = torch.autograd.grad(value, leaves)
        start.record()
        grads = col.allreduce_coalesced(list(grads), group_name=DP_GROUP,
                                        op=col.ReduceOp.MEAN)
        stop.record()
        g_norm = tx.update(grads, state.opt_state, state.params)
        state.step += 1
        loss, norm = float(m["loss"].detach()), float(g_norm)
        step_ms = (time.perf_counter() - t0) * 1e3
        metrics = {"step": i, "loss": loss, "grad_norm": norm,
                   "step_ms": step_ms,
                   "allreduce_ms": start.elapsed_time(stop),
                   "visible": os.environ.get("CUDA_VISIBLE_DEVICES"),
                   "backend": col.collective._manager.get(DP_GROUP).backend}
        if i == config["steps"]:
            metrics.update(
                launches={f.__name__: f.launches for f in fa.KERNELS},
                layers=cfg.num_layers, params=count_params(state.params),
                embed_dim=cfg.embed_dim,
                peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
        with tempfile.TemporaryDirectory() as d:
            ckpt = None
            if i == DP_CKPT_STEP:
                torch.save(map_params(lambda _p, t: t.detach().cpu(),
                                      state.params),
                           os.path.join(d, "params.pt"))
                metrics["ckpt_sums"] = _leaf_sums(torch, state.params)
                ckpt = train.Checkpoint.from_directory(d)
            train.report(metrics, checkpoint=ckpt)
    col.destroy_collective_group(DP_GROUP)


def _bytes_equal(torch, a, b) -> bool:
    return (a.dtype == b.dtype and a.shape == b.shape and torch.equal(
        a.contiguous().view(torch.uint8), b.contiguous().view(torch.uint8)))


class NcclProbe:
    """(a), in a num_gpus=1 actor: the NCCL group at world 1."""

    def run(self) -> dict:
        import os

        import torch
        from torch.profiler import ProfilerActivity, profile

        from ray_tpu_torch.util import collective as col

        name = "nccl-world-1"
        col.init_collective_group(1, 0, backend="nccl", group_name=name)
        out = {"visible": os.environ.get("CUDA_VISIBLE_DEVICES"),
               "backend": col.collective._manager.get(name).backend,
               "ops": {}}
        g = torch.Generator(device="cuda").manual_seed(13)
        for dt in (torch.bfloat16, torch.float32):
            x = torch.randn(1024, 257, generator=g, device="cuda").to(dt)
            got = {op.value: col.allreduce(x, name, op=op) for op in (
                col.ReduceOp.SUM, col.ReduceOp.MEAN, col.ReduceOp.MAX)}
            got["broadcast"] = col.broadcast(x, 0, name)
            (got["allgather"],) = col.allgather(x, name)
            got["reducescatter"] = col.reducescatter(x, name)
            out["ops"][str(dt).split(".")[-1]] = {
                k: [str(t.device), t.dtype == dt, _bytes_equal(torch, t, x)]
                for k, t in got.items()}
        kernels = {}
        for op in (col.ReduceOp.SUM, col.ReduceOp.MEAN):
            x = torch.randn(1 << 20, generator=g, device="cuda")
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                col.allreduce(x, name, op=op)
                torch.cuda.synchronize()
            kernels[op.value] = sorted({
                e.name for e in prof.events()
                if e.device_type == torch.autograd.DeviceType.CUDA})
        out["profile"] = kernels
        col.destroy_collective_group(name)
        return out


def _nccl_without_a_card() -> str:
    """A GPU-less task asks for an NCCL group: the refusal's text."""
    from ray_tpu_torch.util import collective as col

    try:
        col.init_collective_group(1, 0, backend="nccl", group_name="nocard")
    except col.CollectiveError as e:
        return str(e)
    return ""


def _mixed_batches(torch, cfg):
    g = torch.Generator(device="cpu").manual_seed(4)
    return [{"tokens": torch.randint(0, cfg.vocab_size,
                                     (DP_MIXED_ROWS, DP_MIXED_SEQ),
                                     generator=g)}
            for _ in range(TRAIN_STEPS)]


def _mixed_rank(rank: int, device: str) -> dict:
    """(c), one rank of the mixed world: llama_debug in float32 from the
    train parity phase's seed-3 weights, this rank's half of each batch,
    the host GradientAverager; per step the half loss, the grad norm, the
    averaged grads' bytes (read back to the host from this rank's
    device) and the average's host-clock seconds."""
    import hashlib
    import os

    import torch

    from ray_tpu_torch.models import presets
    from ray_tpu_torch.models.training import init_train_state
    from ray_tpu_torch.models.transformer import (_leaves, init_params,
                                                  loss_fn)
    from ray_tpu_torch.train import GradientAverager

    cfg = presets.llama_debug(ce_chunk=32)
    host = init_params(cfg, seed=3, device="cpu", param_dtype=torch.float32)
    state, tx = init_train_state(cfg, _dp_ocfg(), device=device, params=host)
    avg = GradientAverager(group_name="mixed", world_size=2, rank=rank)
    half = DP_MIXED_ROWS // 2
    out = {"visible": os.environ.get("CUDA_VISIBLE_DEVICES"), "losses": [],
           "norms": [], "digests": [], "seconds": [], "devices": set()}
    for b in _mixed_batches(torch, cfg):
        part = {"tokens": b["tokens"][rank * half:(rank + 1) * half].to(
            device)}
        leaves = _leaves(state.params)
        value, m = loss_fn(cfg, state.params, part)
        grads = list(torch.autograd.grad(value, leaves))
        if device == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        grads = avg.average(grads)
        out["seconds"].append(time.perf_counter() - t0)
        out["devices"].update(str(t.device) for t in grads)
        out["digests"].append(hashlib.sha256(b"".join(
            t.cpu().numpy().tobytes() for t in grads)).hexdigest())
        out["norms"].append(float(tx.update(grads, state.opt_state,
                                            state.params)))
        out["losses"].append(float(m["loss"].detach()))
    out["bytes"] = sum(t.numel() * t.element_size() for t in leaves)
    out["devices"] = sorted(out["devices"])
    avg.shutdown()
    return out


def _dp_ocfg():
    from ray_tpu_torch.models.training import OptimizerConfig

    return OptimizerConfig(learning_rate=1e-2, warmup_steps=2, decay_steps=6)


def _bcast_receive(group: str) -> dict:
    """(d), a GPU-less task: an ``LLMServerImpl`` of llama3_8b on the CPU
    made with ``weights_bcast``, its weights from the serve-app replica's
    ``push_weights``; the per-leaf sums of its params."""
    import os

    import torch

    from ray_tpu_torch import LLMServerImpl

    t0 = time.perf_counter()
    srv = LLMServerImpl(preset="llama3_8b", device="cpu", share_weights=False,
                        scheduler="batch",
                        weights_bcast={"group": group, "world_size": 2,
                                       "rank": 1})
    init_s = time.perf_counter() - t0
    try:
        return {"sums": _leaf_sums(torch, srv.params), "init_s": init_s,
                "visible": os.environ.get("CUDA_VISIBLE_DEVICES"),
                "mode": srv.weights_info()["mode"]}
    finally:
        srv.shutdown()


def _push_weights(rt, h, sums, nbytes: int) -> dict:
    """(d): the serve-app replica's ``push_weights`` to a GPU-less task
    made with ``weights_bcast``; the task's per-leaf sums equal the
    replica's. GB/s: the tree's bytes over the push's seconds."""
    group = "llama3_8b-push"
    recv = rt.remote(_bcast_receive).remote(group)
    t0 = time.perf_counter()
    h.push_weights.remote(group, 2).result(timeout=RT_TIMEOUT)
    push_s = time.perf_counter() - t0
    got = rt.get(recv, timeout=RT_TIMEOUT)
    if got["visible"] != "" or got["mode"] != "local":
        raise AssertionError(f"the broadcast's receiver: "
                             f"CUDA_VISIBLE_DEVICES={got['visible']!r}, "
                             f"weights {got['mode']}")
    if got["sums"] != sums:
        bad = [k for k in sums if got["sums"].get(k) != sums[k]]
        raise AssertionError(f"push_weights: {len(bad)} of {len(sums)} "
                             f"leaves differ, e.g. {bad[:3]}")
    return {"seconds": push_s, "gb_per_s": nbytes / push_s / 1e9,
            "bytes": nbytes, "receiver_init_s": got["init_s"],
            "leaves": len(sums)}


def dp_train_phase(torch, train_ref, push) -> dict:
    """Phase 13: (a) the NCCL group at world 1 in a GPU actor; (b)
    ``TorchTrainer`` on the card, gpt2_small, every step's grads averaged
    over an NCCL group; (c) a mixed world of 2 (a GPU actor and a GPU-less
    one) over the host backend against a single-process full-batch run on
    the card. ``push`` is (d), run inside the serve-app phase."""
    import shutil

    import ray_tpu_torch as rt
    from ray_tpu_torch import presets
    from ray_tpu_torch.models.training import (init_train_state,
                                               make_train_step)
    from ray_tpu_torch.models.transformer import init_params
    from ray_tpu_torch.train import (RunConfig, ScalingConfig, TorchConfig,
                                     TorchTrainer)

    r = {"push_weights": push}
    t_init = time.perf_counter()
    rt.init()
    storage = ROOT / "build" / "dp_train"
    try:
        r["init_s"] = time.perf_counter() - t_init
        # ---- (a) the NCCL group at world 1
        probe = rt.remote(NcclProbe).options(num_gpus=1).remote()
        a = rt.get(probe.run.remote(), timeout=RT_TIMEOUT)
        rt.kill(probe)
        refusal = rt.get(rt.remote(_nccl_without_a_card).remote(),
                         timeout=RT_TIMEOUT)
        bad = [(dt, k) for dt, ops in a["ops"].items()
               for k, (dev, same_dtype, equal) in ops.items()
               if not (dev == "cuda:0" and same_dtype and equal)]
        onerank = [k for k in a["profile"]["mean"] if "onerank" in k]
        if a["visible"] != "0" or a["backend"] != "nccl" or bad:
            raise AssertionError(f"the NCCL group at world 1: {a}")
        if not onerank:
            raise AssertionError(f"no NCCL kernel in the capture of a MEAN "
                                 f"allreduce: {a['profile']}")
        if "needs a CUDA card" not in refusal:
            raise AssertionError(f"an NCCL group without a card: "
                                 f"{refusal!r}")
        r["nccl"] = dict(a, refusal=refusal, kernel=onerank[0])
        print(f"dp-train (a): NCCL group at world 1 in a num_gpus=1 actor "
              f"(CUDA_VISIBLE_DEVICES={a['visible']}): allreduce SUM, MEAN, "
              f"MAX, broadcast, allgather, reducescatter on bf16 and "
              f"float32 CUDA tensors equal the input bit for bit on cuda:0;"
              f" a MEAN allreduce runs NCCL's one-rank kernel "
              f"({onerank[0][:60]}...), a SUM in place no NCCL kernel "
              f"(device events {a['profile']['sum']}); a GPU-less NCCL "
              f"group refused", flush=True)
        # ---- (b) TorchTrainer on the card, gpt2_small
        shutil.rmtree(storage, ignore_errors=True)
        ref = train_ref["gpt2_small"]
        t0 = time.perf_counter()
        res = TorchTrainer(
            _dp_gpt2_loop,
            train_loop_config={"batch": ref["batch"], "seq": ref["seq"],
                               "steps": TRAIN_STEPS},
            scaling_config=ScalingConfig(num_workers=1, use_gpu=True),
            torch_config=TorchConfig(backend="nccl", distributed=True),
            run_config=RunConfig(storage_path=str(storage), name="gpt2"),
        ).fit()
        fit_s = time.perf_counter() - t0
        if res.error is not None:
            raise AssertionError(f"TorchTrainer: {res.error}")
        hist = res.metrics_history
        last = hist[-1]
        L, steps = last["layers"], len(hist)
        want = {"flash_forward": L * steps, "flash_dq": L * steps,
                "flash_dkv": L * steps}
        losses = [m["loss"] for m in hist]
        if len(hist) != 1 + TRAIN_STEPS:
            raise AssertionError(f"{len(hist)} reports, expected "
                                 f"{1 + TRAIN_STEPS}")
        if any(m["visible"] != "0" or m["backend"] != "nccl" for m in hist):
            raise AssertionError(f"the train worker: {hist[0]}")
        if last["launches"] != want:
            raise AssertionError(f"flash launches in the train worker "
                                 f"{last['launches']}, expected {want}")
        if not all(math.isfinite(x) for x in losses) or \
                not losses[-1] < losses[0]:
            raise AssertionError(f"losses {losses}")
        with res.checkpoint.as_directory() as d:
            loaded = torch.load(Path(d) / "params.pt")
        if _leaf_sums(torch, loaded) != hist[DP_CKPT_STEP]["ckpt_sums"]:
            raise AssertionError("the checkpoint does not load back to the "
                                 "step's params bit for bit")
        timed = hist[1:]
        dt = sum(m["step_ms"] for m in timed) / len(timed) / 1e3
        B, S, d = ref["batch"], ref["seq"], last["embed_dim"]
        flops = (6 * last["params"] + 12 * L * S * d) * B * S
        in_proc = [ref["warmup_loss"]] + ref["losses"]
        equal = sum(a == b for a, b in zip(losses, in_proc))
        rel = max(abs(a - b) / abs(b) for a, b in zip(losses, in_proc))
        r["trainer"] = dict(
            fit_s=fit_s, reports=len(hist), losses=losses,
            grad_norms=[m["grad_norm"] for m in hist],
            step_ms=dt * 1e3, tokens_per_s=B * S / dt,
            mfu=flops / dt / PEAK_FLOPS["bfloat16"],
            step_ms_each=[m["step_ms"] for m in hist],
            allreduce_ms=[m["allreduce_ms"] for m in timed],
            launches=last["launches"], peak_mem_gb=last["peak_mem_gb"],
            losses_equal_in_process=equal, max_rel_vs_in_process=rel,
            checkpoint=res.checkpoint.path, params=last["params"])
        tr = r["trainer"]
        print(f"dp-train (b): TorchTrainer(num_workers=1, use_gpu=True, "
              f"TorchConfig(nccl, distributed=True)), gpt2_small {L} layers,"
              f" B{B} x S{S}: fit {fit_s:.2f} s; {len(hist)} reports; step "
              f"{tr['step_ms']:.1f} ms (in-process {ref['step_ms']:.1f}), "
              f"{tr['tokens_per_s']:.0f} tokens/s (in-process "
              f"{ref['tokens_per_s']:.0f}), MFU {100 * tr['mfu']:.2f}% "
              f"(in-process {100 * ref['mfu']:.2f}%); NCCL allreduce of the "
              f"{last['params'] / 1e6:.1f}M-parameter float32 grads "
              f"{min(tr['allreduce_ms']):.3f}-{max(tr['allreduce_ms']):.3f} "
              f"ms; flash launches in the worker {last['launches']} = "
              f"{L} x {steps}; losses {[round(x, 4) for x in losses]}, "
              f"{equal} of {len(losses)} equal the train phase's bit for "
              f"bit (largest relative difference {rel:.2e}); the step-"
              f"{DP_CKPT_STEP} checkpoint loads back bit for bit", flush=True)
        shutil.rmtree(storage, ignore_errors=True)
        # ---- (c) a mixed world of 2 over the host backend
        r0 = rt.remote(_mixed_rank).options(num_gpus=1).remote(0, "cuda")
        r1 = rt.remote(_mixed_rank).remote(1, "cpu")
        c0, c1 = rt.get([r0, r1], timeout=RT_TIMEOUT)
        cfg = presets.llama_debug(ce_chunk=32)
        host = init_params(cfg, seed=3, device="cpu",
                           param_dtype=torch.float32)
        state, tx = init_train_state(cfg, _dp_ocfg(), device="cuda",
                                     params=host)
        step = make_train_step(cfg, tx)
        full = [step(state, b)[1] for b in _mixed_batches(torch, cfg)]
        full_loss = [float(m["loss"]) for m in full]
        full_norm = [float(m["grad_norm"]) for m in full]
        dp_loss = [(a + b) / 2 for a, b in zip(c0["losses"], c1["losses"])]
        rel = max(abs(a - b) / abs(b) for x, y in (
            (dp_loss, full_loss), (c0["norms"], full_norm))
            for a, b in zip(x, y))
        if (c0["visible"], c1["visible"]) != ("0", "") or \
                c0["devices"] != ["cuda:0"] or c1["devices"] != ["cpu"]:
            raise AssertionError(f"the mixed ranks: {c0['visible']!r} "
                                 f"{c0['devices']}, {c1['visible']!r} "
                                 f"{c1['devices']}")
        if c0["digests"] != c1["digests"]:
            raise AssertionError("the averaged grads differ between the "
                                 "ranks")
        if not rel <= TRAIN_PARITY_RTOL:
            raise AssertionError(f"mixed DP against one process: {dp_loss} "
                                 f"{full_loss} {c0['norms']} {full_norm}")
        gbs = [c0["bytes"] / s / 1e9 for s in c0["seconds"][1:]]
        r["mixed"] = dict(losses=dp_loss, full_batch_losses=full_loss,
                          max_rel=rel, rtol=TRAIN_PARITY_RTOL,
                          grad_bytes=c0["bytes"],
                          seconds_rank0=c0["seconds"],
                          seconds_rank1=c1["seconds"], gb_per_s=gbs)
        print(f"dp-train (c): mixed world 2 (rank 0 num_gpus=1, rank 1 no "
              f"card), host GradientAverager, llama_debug float32, "
              f"{TRAIN_STEPS} steps on halves of {DP_MIXED_ROWS} x "
              f"{DP_MIXED_SEQ}: averaged grads the same bytes on both ranks "
              f"every step; losses and grad norms against one process on "
              f"the full batch on the card within {rel:.2e} (rtol "
              f"{TRAIN_PARITY_RTOL:g}); the average of "
              f"{c0['bytes'] / 1e6:.2f} MB on rank 0 "
              f"{min(gbs):.3f}-{max(gbs):.3f} GB/s (steps 2-5)", flush=True)
        p = push
        print(f"dp-train (d): push_weights from the serve-app replica to a "
              f"GPU-less weights_bcast task: {p['leaves']} leaf sums equal, "
              f"{p['seconds']:.2f} s, {p['gb_per_s']:.2f} GB/s", flush=True)
    finally:
        shutil.rmtree(storage, ignore_errors=True)
        rt.shutdown()
    return r


# ------------------------------------------------------------- pipeline

PIPE_M = 4                 # (b) microbatches per step
PIPE_ROWS, PIPE_SEQ = 2, 1024
PIPE_LAYERS = 4            # (b) depth cut from 12: stage 0 runs on the CPU
PIPE_STEPS = 3             # (b) timed steps, after one warm-up step
PIPE_LR = 0.01
PIPE_BUFFER = 4 * 2 ** 20  # channel slots: a 3 MiB bf16 activation + header
PIPE_OPTIONS = [{"num_gpus": 0}, {"num_gpus": 1}]
# (a), bf16, tp2 against the fused model on the card: the loss, relative;
# the grads, relative L2 over all leaves together (a gradient 2% off must
# be refused) and of each leaf alone (a leaf's bf16 noise is larger than
# the whole's)
TP_LOSS_RTOL = 2.0 ** -7
TP_GRAD_RTOL = 0.015
TP_LEAF_RTOL = 0.05


def _rel_l2(torch, pairs, scale=1.0) -> float:
    """Relative L2 of the ``got`` tensors (times ``scale``) against the
    ``ref`` ones, over all the (got, ref) ``pairs`` together."""
    num = sum(float(torch.sum((g.double() * scale - r.double()) ** 2))
              for g, r in pairs)
    den = sum(float(torch.sum(r.double() ** 2)) for _, r in pairs)
    return math.sqrt(num / max(den, 1e-300))


def _flat_params(tree) -> dict:
    from ray_tpu_torch.models.transformer import map_params

    out = {}
    map_params(lambda p, t: out.__setitem__(p, t), tree)
    return out


def _tp2_emulated(torch) -> dict:
    """(a): gpt2_small in 2 chunks x tensor_parallel=2, both ranks on
    threads of this process on the card, against the fused model."""
    import dataclasses
    import threading
    from collections import Counter

    from ray_tpu_torch import presets
    from ray_tpu_torch.models import transformer as T
    from ray_tpu_torch.ops import flash_attention as fa
    from ray_tpu_torch.util.collective import emulate_tp

    cfg = presets.gpt2_small(tie_embeddings=False, remat=False,
                             ce_chunk=8192)
    full = T.init_params(cfg, 0, "cpu", cfg.param_dtype)
    g = torch.Generator(device="cpu").manual_seed(7)
    tokens = torch.randint(0, cfg.vocab_size, (PIPE_ROWS, PIPE_SEQ),
                           generator=g).cuda()
    params = T.map_params(lambda _p, t: t.cuda().requires_grad_(True), full)
    leaves = T._leaves(params)
    ref_loss, _ = T.loss_fn(cfg, params, {"tokens": tokens})
    ref = dict(zip(_flat_params(params), torch.autograd.grad(ref_loss,
                                                             leaves)))
    ref_loss = float(ref_loss.detach())
    # for the record: the fused bf16 grads' own distance from float32
    f32 = dataclasses.replace(cfg, dtype=torch.float32)
    f32_loss, _ = T.loss_fn(f32, params, {"tokens": tokens})
    f32_grads = torch.autograd.grad(f32_loss, leaves)
    bf16_vs_f32 = _rel_l2(torch, list(zip(ref.values(), f32_grads)))
    del params, leaves, f32_grads
    shards = presets.partition_pipeline_params(cfg, full, 2,
                                               tensor_parallel=2)
    defs = presets.pipeline_stage_defs(cfg, 2, seed=0, tensor_parallel=2)
    # each wrapper is swapped for a pass-through that tallies its calls by
    # thread (= tp rank); a wrapper counts its launches on the name it
    # finds in its module, so the pass-through carries the count meanwhile
    tally, lock = Counter(), threading.Lock()
    originals = {f.__name__: f for f in fa.KERNELS}

    def counted(f):
        def wrapper(*a, **k):
            with lock:
                tally[(threading.current_thread().name, f.__name__)] += 1
            return f(*a, **k)
        wrapper.launches = 0
        return wrapper

    def rank(r, ops):
        sh = [T.map_params(lambda _p, t: t.cuda().requires_grad_(True),
                           shards[c][r]) for c in range(2)]
        out = defs[0]["fwd"](sh[0], tokens, tp_ops=ops)
        x = out[0] + ops.g(out[1]) if defs[0]["tp_tail"] else out
        loss = defs[1]["loss"](sh[1], x, tokens, tp_ops=ops)
        grads = iter(torch.autograd.grad(
            loss, T._leaves(sh[0]) + T._leaves(sh[1])))
        torch.cuda.synchronize()
        return float(loss.detach()), [
            T.map_params(lambda _p, _t: next(grads), s) for s in sh]

    passes = {name: counted(f) for name, f in originals.items()}
    for name, w in passes.items():
        setattr(fa, name, w)
    try:
        t0 = time.perf_counter()
        ranks = emulate_tp(2, rank)
        wall = time.perf_counter() - t0
    finally:
        for name, f in originals.items():
            setattr(fa, name, f)
    got = _flat_params(presets.reassemble_pipeline_params(
        cfg, [[ranks[t][1][c] for t in range(2)] for c in range(2)], 2,
        tensor_parallel=2))
    pairs = [(got[k], ref[k]) for k in ref]
    errs = {k: _rel_l2(torch, [(got[k], ref[k])]) for k in ref}
    whole = _rel_l2(torch, pairs)
    bumped = _rel_l2(torch, pairs, scale=1.02)
    loss_rel = [abs(l - ref_loss) / ref_loss for l, _ in ranks]
    per_rank = {r: {n: tally[(f"tp-rank-{r}", n)] for n in originals}
                for r in range(2)}
    want = {n: cfg.num_layers for n in originals}
    total = {name: w.launches for name, w in passes.items()}
    worst = max(errs, key=errs.get)
    r = dict(layers=cfg.num_layers, batch=PIPE_ROWS, seq=PIPE_SEQ,
             losses=[l for l, _ in ranks], fused_loss=ref_loss,
             loss_rel=loss_rel, loss_rtol=TP_LOSS_RTOL,
             grad_rel_l2=whole, grad_rtol=TP_GRAD_RTOL,
             fused_bf16_vs_float32_rel_l2=bf16_vs_f32,
             grad_2pct_off_rel_l2=bumped, leaf_max_rel_l2=errs[worst],
             leaf_worst=worst, leaf_rtol=TP_LEAF_RTOL, leaves=len(errs),
             leaf_rel_l2=errs, launches_per_rank=per_rank,
             launches_total=total, wall_s=wall)
    print(f"pipeline (a): emulated tp2 on the card, gpt2_small "
          f"{cfg.num_layers} layers in 2 chunks, B{PIPE_ROWS} x "
          f"S{PIPE_SEQ}, 2 rank threads: "
          f"losses {[round(l, 5) for l, _ in ranks]} against the fused "
          f"{ref_loss:.5f} (relative {max(loss_rel):.2e}, rtol "
          f"{TP_LOSS_RTOL:g}); reassembled grads within {whole:.2e} "
          f"relative L2 of the fused (rtol {TP_GRAD_RTOL:g}; the grads 2% "
          f"off: {bumped:.2e}, refused; the fused bf16 grads are "
          f"{bf16_vs_f32:.2e} from float32), each of {len(errs)} leaves "
          f"within {errs[worst]:.2e} ({worst}; rtol {TP_LEAF_RTOL:g}); flash "
          f"launches per rank {per_rank}; {wall:.2f} s", flush=True)
    if per_rank[0] != want or per_rank[1] != want or \
            total != {n: 2 * v for n, v in want.items()}:
        raise AssertionError(f"(a) flash launches per rank {per_rank}, in "
                             f"all {total}, expected {want} per rank")
    if not max(loss_rel) <= TP_LOSS_RTOL:
        raise AssertionError(f"(a) tp2 losses {ranks[0][0]} "
                             f"{ranks[1][0]} against {ref_loss}")
    if not (whole <= TP_GRAD_RTOL < bumped and errs[worst] <= TP_LEAF_RTOL):
        raise AssertionError(f"(a) tp2 grads: {whole:.3e} (2% off "
                             f"{bumped:.3e}), {worst} {errs[worst]:.3e}")
    return r


def _pipe_batch(torch, cfg, M, rows, seq, seed):
    import numpy as np

    g = torch.Generator(device="cpu").manual_seed(seed)
    return torch.randint(0, cfg.vocab_size, (M * rows, seq),
                         generator=g).numpy().astype(np.int32)


def _pipe_in_process(cfg, batch, M, steps, lr, devices):
    """The trainer's chunk math in this process, stage 0 and stage 1 on
    ``devices``: per microbatch stage 0's forward, stage 1's loss and
    backward, stage 0's backward, through the same CPU wire values as
    the channels; then each stage's flush. Returns the step losses."""
    from ray_tpu_torch import presets
    from ray_tpu_torch.train._internal import pipeline as pl

    defs = presets.pipeline_stage_defs(cfg, 2, seed=0)
    stages = [pl._StageRuntime([pl._as_stage_spec(defs[s])], s, 2, 1, M,
                               ("sgd", lr), 1, 0, f"in-process-{s}",
                               device=dev)
              for s, dev in enumerate(devices)]
    mb = batch.shape[0] // M
    losses = []
    for _ in range(steps):
        for m in range(M):
            toks = batch[m * mb:(m + 1) * mb]
            y = pl._to_wire(stages[0].forward(0, m, toks))
            _, gx = stages[1].loss_backward(0, y, toks)
            stages[0].backward(0, m, pl._to_wire(gx))
        stages[0].flush()
        st = stages[1].flush()
        losses.append(st["loss_sum"] / st["microbatches"])
    return losses


def _pipe_fused(torch, cfg, batch, M, steps, lr, device):
    """The fused model in one process on ``device``: per step the M
    microbatches' grads summed in order, divided by M, SGD."""
    from ray_tpu_torch.models import transformer as T
    from ray_tpu_torch.models.training import SGD

    params = T.map_params(
        lambda _p, t: t.to(device).requires_grad_(True),
        T.init_params(cfg, 0, "cpu", cfg.param_dtype))
    leaves = T._leaves(params)
    opt, mb, out = SGD(lr), batch.shape[0] // M, []
    for _ in range(steps):
        acc, ls = None, []
        for m in range(M):
            toks = torch.from_numpy(batch[m * mb:(m + 1) * mb]).to(device)
            loss, _ = T.loss_fn(cfg, params, {"tokens": toks})
            gs = torch.autograd.grad(loss, leaves)
            ls.append(float(loss.detach()))
            acc = list(gs) if acc is None else [a + b for a, b in
                                               zip(acc, gs)]
        opt.update([a / M for a in acc], None, params)
        out.append(sum(ls) / M)
    return out


def _stage_launches(cfg, blocks: int, microbatches: int) -> dict:
    """K1-K3 launches of the LAST chunk over ``microbatches``: its forward
    and backward are one pass, so K1 runs once per block (twice under
    remat, which runs the block again in the backward), K2 and K3 once."""
    k1 = 2 if cfg.remat else 1
    return {"flash_forward": k1 * blocks * microbatches,
            "flash_dq": blocks * microbatches,
            "flash_dkv": blocks * microbatches}


def _check_stage_launches(got: dict, want: dict, what: str) -> None:
    if got != want:
        raise AssertionError(f"{what}: flash launches in the card stage "
                             f"{got}, expected {want}")


def _pipe_trainer_run(cfg, batch, M, steps, lr, warm=True) -> dict:
    """``PipelineTrainer`` over two stages placed by ``PIPE_OPTIONS``:
    the warm-up step (if ``warm``) and ``steps`` timed steps; the
    timed steps' reports."""
    from ray_tpu_torch import presets
    from ray_tpu_torch.train import PipelineTrainer

    t0 = time.perf_counter()
    trainer = PipelineTrainer(
        presets.pipeline_stage_defs(cfg, 2, seed=0), num_microbatches=M,
        optimizer=("sgd", lr), buffer_bytes=PIPE_BUFFER,
        stage_options=PIPE_OPTIONS)
    build_s = time.perf_counter() - t0
    try:
        outs, ms = [], []
        for i in range(steps + (1 if warm else 0)):
            t1 = time.perf_counter()
            outs.append(trainer.step(batch))
            ms.append((time.perf_counter() - t1) * 1e3)
    finally:
        trainer.shutdown()
    timed = outs[1:] if warm else outs
    reps = [r for o in timed for r in o["reports"]]
    card = [r for r in reps if r["stage"] == 1]
    launches = {k: sum(r["kernel_launches"][k] for r in card)
                for k in card[0]["kernel_launches"]}
    return dict(build_s=build_s, losses=[o["loss"] for o in outs],
                step_ms=ms, timed_step_ms=ms[1:] if warm else ms,
                launches=launches,
                devices={r["stage"]: r["device"] for r in reps},
                rpc_calls=[[r["rpc_calls"] for r in o["reports"]]
                           for o in outs],
                bubble={s: [r["bubble_fraction"] for r in reps
                            if r["stage"] == s] for s in (0, 1)},
                busy_s={s: [r["flush_s"] - r["wait_s"] for r in reps
                            if r["stage"] == s] for s in (0, 1)},
                flush_s={s: [r["flush_s"] for r in reps
                             if r["stage"] == s] for s in (0, 1)})


def pipeline_phase(torch) -> dict:
    """Phase 14: (a) emulated tp2 stage math on the card; (b)
    ``PipelineTrainer`` over a CPU stage and a card stage, gpt2_small
    width; (c) the same placement for llama_debug in float32 against the
    fused model on the CPU."""
    import math

    import ray_tpu_torch as rt
    from ray_tpu_torch import presets

    r = {"tp2_emulated": _tp2_emulated(torch)}
    torch.cuda.empty_cache()
    t_init = time.perf_counter()
    rt.init()
    try:
        r["init_s"] = time.perf_counter() - t_init
        # ---- (b) PipelineTrainer, gpt2_small width, CPU + card stages
        cfg = presets.gpt2_small(tie_embeddings=False, remat=False,
                                 ce_chunk=8192, num_layers=PIPE_LAYERS)
        act = PIPE_ROWS * PIPE_SEQ * cfg.embed_dim * 2
        if act + 64 * 1024 > PIPE_BUFFER:
            raise AssertionError(f"a {act}-byte activation does not fit "
                                 f"the {PIPE_BUFFER}-byte channel slots")
        batch = _pipe_batch(torch, cfg, PIPE_M, PIPE_ROWS, PIPE_SEQ, 8)
        b = _pipe_trainer_run(cfg, batch, PIPE_M, PIPE_STEPS, PIPE_LR)
        (lo0, hi0), (lo1, hi1) = presets.pipeline_splits(PIPE_LAYERS, 2)
        blocks = hi1 - lo1
        want = _stage_launches(cfg, blocks, PIPE_M * PIPE_STEPS)
        local = _pipe_in_process(cfg, batch, PIPE_M, PIPE_STEPS + 1,
                                 PIPE_LR, ("cpu", "cuda"))
        fused = _pipe_fused(torch, cfg, batch, PIPE_M, PIPE_STEPS + 1,
                            PIPE_LR, "cuda")
        rel = max(abs(a - c) / abs(c) for a, c in zip(b["losses"], local))
        equal = sum(a == c for a, c in zip(b["losses"], local))
        gap = max(abs(a - c) / abs(c) for a, c in zip(b["losses"], fused))
        dt = sum(b["timed_step_ms"]) / len(b["timed_step_ms"]) / 1e3
        tokens = PIPE_M * PIPE_ROWS * PIPE_SEQ
        card_share = [busy / (ms / 1e3) for busy, ms in
                      zip(b["busy_s"][1], b["timed_step_ms"])]
        r["trainer"] = dict(b, layers=PIPE_LAYERS, microbatches=PIPE_M,
                            rows=PIPE_ROWS, seq=PIPE_SEQ,
                            in_process_losses=local, fused_losses=fused,
                            max_rel_in_process=rel, bit_equal=equal,
                            rtol=TRAIN_PARITY_RTOL, fused_gap=gap,
                            tokens_per_s=tokens / dt, want_launches=want,
                            card_busy_share=card_share)
        print(f"pipeline (b): PipelineTrainer, gpt2_small width "
              f"{PIPE_LAYERS} layers, stage 0 (embedding + "
              f"{hi0 - lo0} blocks) on {b['devices'][0]}, stage 1 "
              f"({blocks} blocks + head + loss) on {b['devices'][1]}; "
              f"M={PIPE_M} of {PIPE_ROWS} x {PIPE_SEQ}, SGD: build "
              f"{b['build_s']:.2f} s; losses "
              f"{[round(x, 5) for x in b['losses']]}, {equal} of "
              f"{len(local)} bit-equal to the same chunk math in this "
              f"process (largest relative difference {rel:.2e}, rtol "
              f"{TRAIN_PARITY_RTOL:g}); gap to the fused model on the card "
              f"{gap:.2e}; step {dt * 1e3:.1f} ms "
              f"({[round(x, 1) for x in b['timed_step_ms']]}), "
              f"{tokens / dt:.0f} tokens/s; card stage busy "
              f"{[round(x, 4) for x in card_share]} of each step; bubble "
              f"stage 0 {[round(x, 4) for x in b['bubble'][0]]}, stage 1 "
              f"{[round(x, 4) for x in b['bubble'][1]]}; rpc calls per "
              f"report {b['rpc_calls']}; card stage flash launches "
              f"{b['launches']}", flush=True)
        _check_stage_launches(b["launches"], want, "(b)")
        if b["devices"] != {0: "cpu", 1: "cuda:0"}:
            raise AssertionError(f"(b) stage devices {b['devices']}")
        if not all(math.isfinite(x) for x in b["losses"]) or \
                not rel <= TRAIN_PARITY_RTOL:
            raise AssertionError(f"(b) losses {b['losses']} against the "
                                 f"in-process chunk math {local}")
        torch.cuda.empty_cache()
        # ---- (c) llama_debug, float32, the same placement
        cfg = presets.llama_debug(ce_chunk=32)
        batch = _pipe_batch(torch, cfg, 2, 2, 48, 9)
        c = _pipe_trainer_run(cfg, batch, 2, 3, 0.05, warm=False)
        cpu = _pipe_fused(torch, cfg, batch, 2, 3, 0.05, "cpu")
        rel = max(abs(a - x) / abs(x) for a, x in zip(c["losses"], cpu))
        lo1, hi1 = presets.pipeline_splits(cfg.num_layers, 2)[1]
        want = _stage_launches(cfg, hi1 - lo1, 2 * 3)
        r["llama_debug"] = dict(c, fused_cpu_losses=cpu, max_rel=rel,
                                rtol=TRAIN_PARITY_RTOL, want_launches=want)
        print(f"pipeline (c): llama_debug float32, stage 0 on "
              f"{c['devices'][0]}, stage 1 on {c['devices'][1]}, 3 steps: "
              f"losses {[round(x, 6) for x in c['losses']]} against the "
              f"fused model on the CPU within {rel:.2e} (rtol "
              f"{TRAIN_PARITY_RTOL:g}); card stage flash launches "
              f"{c['launches']}", flush=True)
        _check_stage_launches(c["launches"], want, "(c)")
        if not rel <= TRAIN_PARITY_RTOL:
            raise AssertionError(f"(c) losses {c['losses']} against the "
                                 f"fused CPU model {cpu}")
    finally:
        rt.shutdown()
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
    flash = flash_kernel_phase(torch)
    serve = serve_phase(torch)
    _free(torch)
    spec_serve = spec_serve_phase(torch, card, serve["texts"])
    _free(torch)
    lanes = serve_lanes_phase(torch, serve["texts"])
    _free(torch)
    runtime = runtime_phase(torch, serve)
    _free(torch)
    serve_app = serve_app_phase(torch, serve, runtime)
    parity = parity_phase(torch)
    train = train_phase(torch)
    train_parity = train_parity_phase(torch)
    dp_train = dp_train_phase(torch, train,
                              serve_app["llama3_8b"]["push_weights"])
    pipeline = pipeline_phase(torch)
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
    # K4 inside the runtime's worker process: llama3_8b served from an actor
    kernels["kernels"].append(dict(
        kernels["kernels"][0], name="paged_attention_in_actor",
        launches=runtime["serve"]["launches"]))
    # K4 inside the ReplicaActor that serve.run started, behind the router
    kernels["kernels"].append(dict(
        kernels["kernels"][0], name="paged_attention_serve_app",
        launches=serve_app["llama3_8b"]["launches"]))
    # the same replica behind the HTTP proxy: the cold pass over HTTP
    kernels["kernels"].append(dict(
        kernels["kernels"][0], name="paged_attention_serve_http",
        launches=serve_app["llama3_8b"]["ingress"]["launches"]))
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
    # the same kernels inside TorchTrainer's train worker (phase 13 (b))
    for name in ("fwd", "dq", "dkv"):
        base = next(k for k in kernels["kernels"]
                    if k["name"] == f"flash_attention_{name}")
        kernels["kernels"].append(dict(
            base, name=f"flash_attention_{name}_train_worker",
            launches=dp_train["trainer"]["launches"][{
                "fwd": "flash_forward", "dq": "flash_dq",
                "dkv": "flash_dkv"}[name]]))
    # and inside PipelineTrainer's card stage (phase 14 (b), timed steps)
    for name in ("fwd", "dq", "dkv"):
        base = next(k for k in kernels["kernels"]
                    if k["name"] == f"flash_attention_{name}")
        kernels["kernels"].append(dict(
            base, name=f"flash_attention_{name}_pipeline_stage",
            launches=pipeline["trainer"]["launches"][{
                "fwd": "flash_forward", "dq": "flash_dq",
                "dkv": "flash_dkv"}[name]]))
    detail = {"card": card, "build": build, "kernel": kern, "flash": flash,
              "serve": serve, "spec_serve": spec_serve,
              "serve_lanes": lanes, "runtime": runtime,
              "serve_app": serve_app, "parity": parity,
              "train": train,
              "train_parity": train_parity, "dp_train": dp_train,
              "pipeline": pipeline,
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
