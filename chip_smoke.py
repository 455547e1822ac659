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
     kernel, and the run fails if the bf16 K1, K2 or K3 or the float32 K1
     at D=64 or 128, or K4's split kernel for any q/pool dtype pair at any
     of its head widths (16-256), has none, or if the float32 K1 or a
     float32-pool K4 a main path launches (D 128, and D 16 under float32
     q) spills.
  3. kernel: the paged-attention kernel (split over pages, then merged;
     the split kernel on the tensor cores for every dtype pair, each
     float32 operand split into three bf16 parts) against
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
     the kernel, of its plain version (over 5 calls), of
     scaled_dot_product_attention over a pre-gathered contiguous view (a
     yardstick only: the port never calls it) and the bound (live-page bytes over the memory rate, or the
     operations over the peak rate, whichever is larger); the split
     kernel each pair and case ran (tensor cores or FMA); and at
     llama_debug's D 16 (the harness serve probe's 2 slots, cursors 10 and
     16, and a verify window), every pair checked the same way and the
     float32 pair timed.
  4. flash: the flash-attention forward (K1), dQ (K2) and dK/dV (K3)
     kernels against their plain versions on the card, bf16 and float32, at
     gpt2_small (B16 S1024 H12 D64), gpt_1b (B4 S1024 H16/8 D128), a
     group-4 case (B1 S2048 H32/8 D128), a ragged S=1000 and a non-causal
     case: O, lse, dQ, dK, dV within the stated tolerances, an O, a dQ, a
     dK and a dV 2% off refused, two runs of K2 and of K3 bitwise equal;
     times of each kernel, its plain version, the library yardstick (SDPA
     forward for K1; the autograd backward of that same call for K2 and K3
     together) and the bound. At D=64 and 128, K1, K2 and K3 in bf16 and K1
     in float32 run on the tensor cores (mma.sync; the float32 K1 as six
     bf16 products of its operands' split parts, held to the float32
     gate); the float32 K2 and K3 run float32 FMA; each case prints the
     route of each kernel. Then K1-K3 in float32 at train parity's shape
     (B2 S48 H4/2 D16, FMA) against their plain versions, timed for the
     kernels line's float32 K1-K3 entries.
  5. serve: ``LLMServerImpl(preset="llama3_8b")`` at full width and depth
     (32 layers), random bf16 weights from a seeded torch.Generator,
     answers 12 streamed requests that share a prefix (8 slots, one request
     sampled at temperature 0.7), through the kernel on every layer.
     Then serve-8: the same at 8 of its 32 layers (``CUT_LAYERS``),
     unprofiled, the plain texts and rates that the runtime and serve-app
     phases' replicas at that depth are held against.
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
     llama3_8b, full width and 8 of its 32 layers (``CUT_LAYERS``, cut for
     time), on one tree of serve-8's seed-0 weights: (a)
     ``attn="gather"``, (b) ``kv_layout="contiguous"``, (c) a 97-page pool
     with the prefix cache and an ``eos_id`` from serve-8's first greedy
     text (at least one request retires on
     "eos", at most 96 pages in use), (d) ``scheduler="batch"``, (e) a
     float32 KV cache under the bf16 model (K4's bf16 q / float32 pool
     pair), (f) the same weights in float32 over a bf16 KV cache (K4's
     float32 q / bf16 pool pair; both on the tensor cores, each route
     checked); the 12 requests each: tokens/s, TTFT,
     decode-step ms, K4 launches exact per dtype pair (0 off the
     in-place lane), temperature-0 texts equal to serve-8's (counted, not
     gated). The kernels line's launches of the two mixed
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
     tolerance; the card runs' K1-K3 launches (float32, D=16) counted.
 11. runtime (run after serve-lanes, before parity): the port's runtime
     (``ray_tpu_torch.init``, a controller, a supervisor and worker
     processes): ``rt.init()`` counts one GPU; 200 no-op actor calls
     (median round trip); a GPU-less actor sees
     ``CUDA_VISIBLE_DEVICES=""`` and its ``LLMServerImpl()`` refuses, a
     ``num_gpus=1`` actor sees the card and builds its replica there;
     llama3_8b at full width and 8 of its 32 layers (``CUT_LAYERS``, cut
     for time) in a ``num_gpus=1`` actor (``ReplicaHost``: no control
     plane and no weights in the arena, the yardstick for phase 12) on
     seed-0 weights and the serve phase's settings, its warm-up and 12
     requests streamed through
     ``num_returns="streaming"``, arriving together, request 5 sampled at
     0.7, pings to the actor while it serves: every request returns all
     its tokens, K4's launches counted in the worker are exactly layers x
     (prefill chunks + decode steps), a request's stream equals its whole
     text, temperature-0 texts equal to serve-8's counted (bf16: not
     gated), tokens/s and decode-step ms beside serve-8's; the same 12
     again on the warm prefix cache, whole, streamed, whole (all tokens
     each; tokens/s, decode-step ms, prefill
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
     and 8 layers (``CUT_LAYERS``), the serve phase's arena, slots, chunks
     and pages,
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
     gated, the bf16 texts equal to serve-8's. Then whole, streamed,
     whole, streamed on the warm cache (tokens/s, decode-step ms, chunks,
     prefix hits each, and the streamed/whole step ratio), against
     serve-8 and the runtime phase's ``ReplicaHost``.
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
     gated, the bf16 texts of the HTTP pass equal to serve-8's.
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
     equal the replica's (75 leaves: 8 layers); seconds and GB/s.
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
     ``remat=False``, 2 layers (``PIPE_LAYERS``, cut for time),
     ``stage_options=[{"num_gpus": 0}, {"num_gpus": 1}]`` (the embedding
     and 1 block on the CPU, then 1 block, the head and the loss on the
     card), M=4 microbatches of 2 x
     1024, SGD, 1 warm and 1 timed step, ``buffer_bytes`` holding a
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
 15. tune (run after phase 14, with its own ``rt.init``): Tune on the
     card, gpt2_small at full width (``remat=False``, CE chunk 8192, bf16
     compute), params from seed 0, AdamW with no warmup, phase 13's batch
     recipe at B8 x S1024. (a) ASHA (max_t 6, grace 2, rf 2, metric loss,
     min) over ``with_resources(fn, {"CPU": 1, "GPU": 1})`` at 12 layers,
     lr 3e-3, 1e-4 (the stronger first: one trial at a time,
     ``max_concurrent_trials=1``), one step and one report per
     iteration. Gates: each trial's process sees card 0 alone
     (``CUDA_VISIBLE_DEVICES``, ``cuda:0``); K1, K2 and K3 launch exactly
     12 x its iterations in each trial; at least one trial stops before
     max_t; the stop decisions equal a replay of the recorded results
     through a fresh ``ASHAScheduler``; every trial's first loss within
     ``TRAIN_PARITY_RTOL`` of one in-process step (bit-equal trials
     counted). (c) ``Tuner`` over ``TorchTrainer(ScalingConfig(
     num_workers=1, use_gpu=True))``, 12 layers, two trials over
     ``train_loop_config.lr``, 3 steps each, gang ``[{"CPU": 1}, {"CPU":
     1, "GPU": 1}]``, the two trials together on the node of (b) below
     that lists the one card twice. Gates: the inner worker sees card 0;
     K1-K3 exactly
     12 x 3 in each inner worker; ``get_best_result()`` the lower final
     loss; the losses within ``TRAIN_PARITY_RTOL`` of the same steps in
     process (bit-equal steps counted). (b) PBT (perturbation interval 2)
     over the same function at 4 layers, lr 1e-4 and 3e-3, 6 iterations,
     a checkpoint (CPU tensors) every 2; PBT compares live trials, so the
     two run together, on a node that lists the one card twice
     (``CUDA_VISIBLE_DEVICES=0,0``, ``num_gpus=2``). Gates: at least one
     exploit (a trial's rate changes); every restarted trial's params and
     Adam moments, loaded onto ``cuda:0``, equal its checkpoint byte for
     byte (sha256 of the card copy, of the saving trial's card copy and
     of the file); its step counter goes on from the checkpoint's.
     Counted: seconds per trial (start, CUDA init, setup) and step ms
     against the in-process step and phase 13's.
 16. dag (run after phase 15, with its own ``rt.init``): the DAG API on
     the card. (a) ``Learner.step.bind(prep.bind(InputNode()))``: a CPU
     task byte-tokenizes text into a B8 x S1024 batch, a ``num_gpus=1``
     actor runs gpt2_small's train step (12 layers, seed 0); 3 executes.
     (b) The same chain compiled (``prep`` a CPU actor's method, a fresh
     ``Learner``), 2 warm and 10 timed executes. Gates: the losses within
     ``TRAIN_PARITY_RTOL`` of (a)'s (bit-equal steps counted); K1-K3
     exactly 12 per execute in the card actor; the driver's outbound RPC
     count unchanged over the timed executes; ``teardown()`` returns the
     store's pins and the pin gauge to where they were. Counted: ms per
     execute, compiled against dynamic against the in-process step. (c)
     ``workflow.run`` of prep, a ``num_gpus=1`` task that takes the loss
     of gpt2_small's seed-0 weights (one marker file per run), and a
     summary that fails on this first run; then ``workflow.resume``,
     which must take the card step's loss from its checkpoint, and a
     second resume with every step checkpointed. Gates: the first run
     raises, the resumed results agree bit for bit, one marker. (d) A
     ``ray_tpu_torch.util.client.server`` process owns a cluster with the
     card; a client process connects with ``init(address="client://...")``
     and runs the same loss task. Gates: the loss equals (c)'s resumed
     one bit for bit (so the card step's checkpoint held the loss a fresh
     run computes), arrives as a CPU float32 tensor, and the client
     process never initialized CUDA.

 17. autoscale (run after phase 16, with its own ``rt.init(num_gpus=0)``: the
     head has no GPU, so nothing here reaches the card unless an
     autoscaler launches its node). Node types ``cpu`` ``{"CPU": 2}`` and
     ``gpu`` ``{"CPU": 2, "GPU": 2}`` over the one card listed twice
     (``gpu_ids`` 0, 0), ``max_workers=1``; gpt2_small at full width and
     depth (12 layers, bf16 compute), weights from a seed-0 generator on
     the CPU moved to the card, B8 x S1024 numpy token batches. (a) v1's
     ``StandardAutoscaler`` over ``LocalNodeProvider`` (tick 1 s, idle
     5 s): an ``ActorPool`` of two ``num_gpus=1`` scorers (each batch's
     forward loss under no_grad, a ``(batch, pid, ms)`` on a
     ``util.queue.Queue``, a ``batches_scored`` counter), 16 batches
     through ``map``, 16 through ``map_unordered``. Gates: exactly one
     ``gpu`` node launched, labelled and showing GPU 2 in
     ``state.list_nodes()``; both scorers ALIVE there; ``map`` in input
     order, ``map_unordered`` all 16; each loss within
     ``TRAIN_PARITY_RTOL`` of this process's on the card (bit-equal
     counted); 32 queue entries from both pids; ``batches_scored`` 32 in
     ``cluster_metrics(all_nodes=True)``; at least 32 finished ``score``
     calls in ``summarize_tasks()``; ``timeline(path)`` spans naming both
     pids; K1 exactly 12 x 32 over the scorers, K2 and K3 none; after the
     kill the node retired within idle + 3 ticks + 10 s (gone from the
     provider, dead in ``list_nodes``). (b) v2's ``Reconciler`` loop over
     a fresh provider; ``python -m ray_tpu_torch.scripts.jobs submit
     --follow`` of a driver whose one ``num_gpus=1`` task scores batch 0.
     Gates: SUCCEEDED, ``status`` and ``list`` agreeing; the logs' JSON
     loss within ``TRAIN_PARITY_RTOL`` of this process's, K1 12; the
     ``gpu`` instance's history QUEUED, REQUESTED, ALLOCATED,
     RAY_RUNNING, TERMINATING, TERMINATED; a job exiting 1 ends FAILED.
     Printed: seconds from demand to node, to both ALIVE, to the first
     batch; ms a batch in the actors and in process; seconds to retire;
     the job's seconds.

 18. data (run after phase 17, with its own ``rt.init`` and a 4 GiB
     store): the data library feeding gpt2_small at full size (12 layers,
     d 768, 12 heads, vocab 50257, bf16 compute, ``remat=False``, CE chunk
     8192, params from seed 0, AdamW with no warmup), B8 x S1024. (a)
     bench.py's ``data_regime_main`` on the card: ``range(192,
     parallelism=24).map_batches(_feed_tokens_batch)`` through
     ``StreamingExecutor(num_readers=1, epochs=2, seed=0).feed``, then the
     same loader with ``.random_shuffle(seed=1)`` through
     ``ExchangeExecutor(num_producers=1, num_consumers=2,
     drop_last=True).feed`` (``is_channel_backed`` asserted), each
     compute-bound (both epochs) and input-bound (a block delay of 2x the
     bare step, 24 steps); each read-only arena view copied out and to the
     card inside the step, which ends in ``float(loss)``. Gates: every
     batch equal bit for bit to ``task_epoch_batches`` /
     ``task_exchange_batches`` (merged) at the same seed; each step's loss
     within ``TRAIN_PARITY_RTOL`` of the same steps in process on the
     baseline's batches (bit-equal steps counted); K1, K2 and K3 exactly
     12 x steps here; each arm's input-bound stall fraction above its
     compute-bound one. Counted: stall fractions and steps/s over 24 steps,
     each warm epoch's ``consumer_rpc_calls`` and its stages' rpc calls,
     the bare step's ms. (b) ``TorchTrainer(ScalingConfig(num_workers=1,
     use_gpu=True), datasets={"train": range(48, parallelism=6)
     .map_batches(_feed_tokens_batch)})``, the worker's loop
     ``get_dataset_shard("train").iter_device_batches(batch_size=8,
     prefetch=2)``, one step and one report per batch. Gates: the worker
     sees card 0; every batch on ``cuda:0``, int32, from pinned staging;
     every row exactly once (the first 4 tokens of each row); K1-K3
     exactly 12 x 6 in the worker; the losses within
     ``TRAIN_PARITY_RTOL`` of the same batches stepped in process. (c)
     ``range_tensor(64, shape=(1024, 1024))`` (int64, 8 MiB a row) in
     batches of 8 through ``iter_device_batches`` at prefetch 2 and 0:
     every tensor on ``cuda:0`` equal bit for bit, the staging buffers
     pinned, ``device="cpu"`` equal; counted: the copy's GB/s from CUDA
     events against a pageable ``torch.as_tensor(...).to("cuda")``, the
     consumer's wait per batch. (d) the native codec loaded in this
     process and in a worker; (a)'s first epoch of token rows through
     ``write_tfrecords`` and ``read_tfrecords`` equal.

 19. rl (run after phase 18, in this process, no new card process): RLlib
     on the card. (a) ``AnakinTrainer`` at ``bench_rllib.run_anakin``'s
     shape (32 envs, rollout 16, 84x84x4 uint8 frames, the Nature-CNN,
     6 actions, seed 0): 2 warm iterations, one update under
     ``torch.cuda.set_sync_debug_mode("error")`` (the rollout, the env
     step, V-trace, the grads and Adam read nothing back), 20 timed
     iterations (env steps/s, ms an iteration), 3 under torch.profiler
     (device kernels an iteration, device-busy share); one iteration's
     recorded actions replayed through the env's CPU mirror from its
     start give its obs, rewards and truncations bit for bit; that
     trajectory's loss, metrics and grads on the card and on the CPU from
     the same float32 params within ``RL_LOSS_RTOL`` (relative) and
     ``RL_GRAD_RTOL`` (relative L2: each leaf under the CPU's ReLU masks,
     and all leaves together as computed), at most ``RL_FLIP_SHARE`` of
     the ReLU inputs of another sign on the card; every loss finite. (b) The
     PPO-Atari learner (``bench_rllib.run``'s batch: 512 rows of 84x84x4,
     minibatch 256, 2 epochs, so 4 updates) on the card and on the CPU
     from the same seed on the same minibatches: the metrics of each
     update within ``RL_LOSS_RTOL``, the params after the 4 updates within
     ``RL_PARAM_RTOL``; ms an update on the card. IMPALA's V-trace loss and
     grads on a [8, 32] conv batch, card against CPU, within the same
     tolerances. (c) multi-agent PPO through ``PPOConfig(...).build()
     .train()`` with JAX's test config (``TargetMatchEnv``, 2 policies),
     its learners and runner on ``cuda:0``: the return reaches 28 within
     25 iterations.

 20. rl-more (run after phase 19, in this process, no new card process):
     the rest of RLlib on the card, K1-K4 counted over the phase (0 each,
     gated). (a) ``MARWILConfig(beta=2)`` and ``BCConfig`` ``.build()
     .train()`` on JAX's ``test_beats_bc_on_mixed_data`` rows (3000 rows,
     obs 6, 4 actions, hiddens (64,), 15 iterations of 24 updates), the
     learner on ``cuda:0``, BC's rows through a port ``Dataset`` (its
     rows equal, ``num_rows`` 3000): MARWIL's optimal-action accuracy above
     0.85 and BC's + 0.15 (JAX's bars); the first 4 updates' metrics within
     ``RL_LOSS_RTOL`` and the params after them within ``RL_PARAM_RTOL``
     (relative L2) of the same run with ``.learners(device="cpu")``; ms an
     update (host clock, ending in its metric read). (b) CQL at JAX's
     ``test_cql_learns_offline`` config (2000 bandit rows, hiddens (32,
     32), 12 iterations of 16 updates, ``bc_iters=1``) on ``cuda:0``: the
     greedy mean action within 0.25 of 0.5, every metric finite; the first
     2 iterations' metrics, params and polyak targets against the CPU's
     within the same tolerances; ms an update. (c) SAC with no env at
     Pendulum's shapes (obs 3, 1 action, hiddens (256, 256), batch 256), 8
     updates of one ``training_step`` from a fixed replay of 4096
     synthetic transitions, card against CPU from the same seed: each
     update's targets (relative L2) and metrics, the params and the polyak
     targets after the 8; ms an update. (d) DreamerV3 with no env at the
     config's defaults (B16 T16 H15, deter 128, 8x8, hidden 128) and
     CartPole's shapes (obs 4, 2 actions), on a fixed batch with Gumbel
     noise drawn on the CPU and copied to both devices: the world-model
     and actor-critic losses within ``RL_LOSS_RTOL`` and grads within
     ``RL_GRAD_RTOL`` (relative L2, largest leaf) of the CPU's; the
     categorical draws that differ counted, at most ``RLM_DRAW_SHARE`` of
     them, and where any differ the card is held under the CPU's draws;
     one update pair under ``torch.cuda.set_sync_debug_mode("error")``,
     then 8 pairs timed (ms a world-model update, ms an actor-critic
     update). SAC's and DreamerV3's env loops need gymnasium, which the
     card's machine lacks: they run in the CPU tests only.
 21. mesh (run after phase 20, in this process): the SPMD layer on a
     world-1 NCCL group opened from a ``FileStore`` in a temp dir, closed
     with ``destroy_process_group`` at the end. (a) gpt2_small at full
     size, B16 x S1024, remat off, chunk 8192: 5 steps through
     ``init_train_state(..., mesh=)`` and ``make_train_step(..., mesh=)``
     on ``build_mesh(MeshSpec.auto(1))``, and the same 5 steps meshless
     from the same seed and batch; each loss and grad norm within
     ``MESH_WORLD1_RTOL`` (1e-6) of the meshless one (bit-equality
     printed), K1, K2 and K3 launched exactly 12 x 5 times each around
     the 5 mesh steps, step ms of both; then ``MESH_REMAT_STEPS`` steps of
     each with remat on (the default: each block and its params' gather
     run again in backward on autograd's device thread), held the same
     way, K1 24, K2 and K3 12 launches a mesh step. (b) the
     ``attn_impl="ring"`` loss and grads at gpt2_small width (12 layers, B2 x S1024, float32, remat
     on: the blocks run again in backward on autograd's device thread)
     over an ``sp`` axis of size 1 against the meshless ones, the loss
     within ``TRAIN_PARITY_RTOL``, the grads within
     ``MESH_RING_GRAD_RTOL`` (relative L2, largest leaf). (c)
     ``pipeline_1f1b`` over a ``pp`` axis of size 1, two gpt2_small
     blocks (bf16) as the stage, 4 microbatches of B2 x S1024: the loss
     within ``MESH_1F1B_LOSS_RTOL`` and the grads within
     ``MESH_1F1B_GRAD_RTOL`` (relative L2, largest leaf) of sequential
     autodiff, K1 4 x 4, K2 and K3 2 x 4
     launches around the call. NCCL refuses two ranks on one card, so the
     collectives of worlds of 2 or more are held on the CPU (gloo) only.
 22. harness (run after phase 21): the harness scripts on the card. (a)
     ``harness.card_probe()``: a killable child's 64x64 product on
     ``cuda:0`` prints ``PROBE-OK``. (b) ``scripts/microbenchmark.py``'s
     groups but the RL one (the card's machine has no gymnasium) at the
     smoke budget (``HARNESS_BUDGET_S`` a probe), on a cluster that lists
     the card ``microbenchmark.CARD_ACTORS`` times, so the pipeline
     probe's stage actors each ask a card: every value above 0, every
     engagement guard of the probes held (compiled DAG on channels,
     pipeline channels deeper than 1 with no steady RPC, both data
     planes on channels with no steady RPC, the collectives on shm or the
     ring, ``admitted_mid_flight`` > 0 in the continuous serve probe, K4
     counted on each paged lane), and the serve probe's in-process
     replica on the card (K4 launched during it). (c) the paged-lane
     group at llama3_8b's width (4096, 32 heads, 8 kv heads, D 128, MLP
     14336, vocab 128256), ``HARNESS_PA_LAYERS`` of 32 layers, bf16,
     seed-0 weights drawn on the card, 8 slots of 16-token pages, 128 live
     tokens a slot on a 512-token arena, then the pool sweep (8 and 128
     pages a slot): both arms' first greedy tokens equal, K4 exactly
     layers x steps on the ``"cuda"`` arm and 0 on ``"gather"``; ms a
     step of each arm. (d) ``chaos_soak.run_serve_chaos`` at seed
     ``HARNESS_CHAOS_SEED`` with its two llama_debug replicas on the card
     listed twice (``CUDA_VISIBLE_DEVICES=0,0``): the workload's own
     asserts (burst outputs the temperature-0 reference or clean errors,
     recovery, paged state back to baseline, the cancelled stream's
     prefix clean), and K4 launched in a live replica.
 23. sharded objects (run after phase 22): DTensors through the object
     layer's ``put``/``get``, on a cluster that lists the card twice.
     gpt2_small at full size in float32, its weights drawn from a seed-0
     generator on the CPU. (a) On a world-1 NCCL group in this process,
     the tree as DTensors on ``build_mesh(MeshSpec.auto(1))``, put leaf by
     leaf: every entry ``DEVICE``, nothing in the in-process store, the
     owner's get DTensors with the same placements, their local tensors
     bit-equal and on ``cuda:0``; a ``num_gpus=1`` consumer actor gets
     every leaf whole on its card, each bit-equal to the seed's, and runs
     the forward loss at B2 x S1024 through K1's float32 kernel (on the
     tensor cores, split-bf16): the loss
     bit-equal to the same forward here on the unsharded tree, K1 exactly
     12 in the consumer. (b) A gloo world of 4 CPU runtime actors holds
     the tree on a 2x2 ``("fsdp", "tp")`` mesh sharded by the port's
     rules (``shard_params``), every rank puts every leaf (one object a
     leaf, owned by rank 0); the consumer assembles every leaf on its
     card from the 4 holders: each bit-equal to the seed's, the loss
     bit-equal to (a)'s, K1 exactly 12 again; after every ref is dropped
     every holder's registry is empty within ``SHARDED_FREE_S``. The
     fetch's seconds and GB/s of each; K1 in float32 at the consumer's
     shape (B2 S1024 H12 D64, causal) against its plain version, with its
     times, SDPA's and its bound.

The serve-app phase splits the time ``serve.shutdown()`` takes to give
the card back into its steps, from the host clock: the controller's
``graceful_shutdown`` returns, each replica's process is gone, the
serve actors are killed, the cluster shows ``GPU: 1`` free, and a
``num_gpus=1`` probe actor is up.

The script and every process it starts write and read Python's bytecode
under ``build/pycache`` (``cache_bytecode``), so the first process to
import torch compiles it for all the others.

Before phase 2 a preflight line gives what the port's ``reap_all()``
swept and whether pyarrow, pandas and gymnasium import (with their
versions). Before the result lines a line gives each phase's seconds on
the host clock. The line before the last is ``{"kernels": [...]}``; the last is
``{"ok": true, "device": {...}}``. Details go to
``chiprun_out/chip_smoke.json``.
"""

from __future__ import annotations

import asyncio
import json
import math
import subprocess
import sys
import threading
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# one H100 SXM (NVIDIA's data sheet, dense, at its 700 W limit)
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}  # f32 off tensor cores
# float32 on the tensor cores as split-bf16 products: the float32 K1 and
# K4 over a float32 pool under float32 q take six bf16 products for each
# float32 one (both operands in three parts); K4's float32 q over a bf16
# pool three (q and P in three parts, the pool exact); K4's bf16 q over a
# float32 pool three in S (K in three parts) and six in P.V, 4.5 a product
# on the whole; their operations bound is those products over the bf16
# peak
PEAK_FLOPS.update({"float32_bf16x6": PEAK_FLOPS["bfloat16"] / 6,
                   "float32_bf16x4.5": PEAK_FLOPS["bfloat16"] / 4.5,
                   "float32_bf16x3": PEAK_FLOPS["bfloat16"] / 3})

SOURCES = ("paged_attention", "flash_attention")
# the kernel instantiations that must run on the tensor cores
SPLIT_BF16_K1 = tuple(f"flash_fwd_f32_mma_kernel<f32, {d}>" for d in (64, 128))
TENSOR_CORE_KERNELS = (
    tuple(f"{name}_mma_kernel<bf16, {d}>"
          for name in ("flash_fwd", "flash_dq", "flash_dkv")
          for d in (64, 128))
    + SPLIT_BF16_K1
    + tuple(f"paged_attention_split_mma_kernel<{tq}, {tp}, {d}>"
            for tq in ("bf16", "f32") for tp in ("bf16", "f32")
            for d in (16, 32, 64, 128, 256)))
# the instantiations whose ptxas report must show no spill: the float32 K1
# (three planes of fragments), and K4 over a float32 pool where a main path
# launches it (llama3_8b's D 128 under either q; llama_debug's D 16, float32
# in the harness and bf16 over a float32 cache in the parity phase)
NO_SPILL_KERNELS = SPLIT_BF16_K1 + tuple(
    f"paged_attention_split_mma_kernel<{tq}, f32, {d}>"
    for tq, d in (("bf16", 128), ("f32", 128), ("f32", 16), ("bf16", 16)))
ARENA_LEN = 2048          # serve arena per slot: 128 pages of 16 tokens
SERVE_NEW_TOKENS = 32
SPEC_K = 4                # draft tokens per speculative round
# the runtime, serve-app and serve-lanes phases' llama3_8b: full width, 8
# of its 32 layers (cut for time; the serve and spec-serve phases keep all
# 32 in process, and serve-8 gives the cut model's plain texts)
CUT_LAYERS = 8
CUT_OVERRIDES = {"num_layers": CUT_LAYERS}
# the verify window's slot cursors: 0 to the last that fits the arena
VERIFY_LENGTHS = [0, 16, 37, 100, 255, 640, 1024, ARENA_LEN - SPEC_K - 1]
# K4's decode cursors: 0, page boundaries, and the arena's last token
DECODE_LENGTHS = [0, 16, 37, 100, 255, 640, 1024, ARENA_LEN - 1]
TOL = {"float32": (1e-5, 1e-5),       # atol, rtol: sum order differs
       "bfloat16": (1e-5, 2.0 ** -7)}  # at most one bf16 rounding step
# K4's (q dtype, pool dtype) pairs: one pool dtype as q's, and a pool of
# the other dtype (``cache_dtype``); each runs on the tensor cores at
# llama3_8b's and llama_debug's shapes, float32 operands as three bf16
# parts
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
    kernel. The paged split kernels name q's element type, then the
    pool's (``paged_attention_split_kernel<f32, bf16, 128>``,
    ``paged_attention_split_mma_kernel<bf16, bf16, 128>``). The flash
    tensor-core kernels (``*_mma_kernel<D>``) take bf16, but
    ``flash_fwd_f32_mma_kernel`` float32. A type that repeats in the
    template arguments is mangled as a substitution (``S1_``: the third
    name seen, counting each prefix of the nested name), resolved here."""
    import re

    types = {"f": "f32", "13__nv_bfloat16": "bf16"}
    for z in re.finditer(r"_ZN?(?=\d)", mangled):
        # the (nested) name: <length><identifier> pieces up to the
        # template arguments; each prefix is a substitution candidate
        i, seen = z.end(), []
        while (n := re.match(r"\d+", mangled[i:])) is not None:
            i += len(n[0])
            seen.append(None)
            name = mangled[i:i + int(n[0])]
            i += int(n[0])
        if not seen or mangled[i:i + 1] != "I":
            continue
        args, i = [], i + 1
        while True:
            tail = mangled[i:]
            t = next((k for k in types if tail.startswith(k)), None)
            sub = re.match(r"S([0-9A-Z]*)_", tail)
            dim = re.match(r"Li(\d+)E", tail)
            if t is not None:
                args.append(types[t])
                if t[0].isdigit():  # a class type: a candidate of its own
                    seen.append(types[t])
                i += len(t)
            elif sub is not None:
                k = int(sub[1], 36) + 1 if sub[1] else 0
                if k >= len(seen) or seen[k] is None:
                    break
                args.append(seen[k])
                i += len(sub[0])
            elif dim is not None:
                args = args or (["f32"] if "_f32_" in name else ["bf16"])
                return f"{name}<{', '.join(args)}, {dim[1]}>"
            else:
                break
    return mangled.split()[-1][:60]


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
    # the float32 K1 and the main path's float32-pool K4: nothing may spill
    for key in NO_SPILL_KERNELS:
        name = "flash_attention" if key.startswith("flash") else (
            "paged_attention")
        line = next((ln for ln in out[name]["ptxas"]
                     if ln.startswith(f"{key}:")), None)
        if _build.build_log.get(name) is not None and (
                line is None or "0 bytes spill stores" not in line
                or "0 bytes spill loads" not in line):
            raise AssertionError(f"{key} spills or was not reported by "
                                 f"ptxas: {line!r}")
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


def _k4_check(torch, case, label, q_name):
    """One K4 case against its plain version within ``TOL`` of q's dtype:
    the launch counter moves by one, two calls are bitwise equal, a third
    under the sync check (the wrapper reads no length or table on the
    host) too, and the output is finite. Returns (plain output, max
    |err|)."""
    from ray_tpu_torch.ops.paged_attention import (paged_attention,
                                                   paged_attention_reference)

    atol, rtol = TOL[q_name]  # the output is in q's dtype
    n0 = paged_attention.launches
    got = paged_attention(**case)
    torch.cuda.synchronize()
    if paged_attention.launches != n0 + 1:
        raise AssertionError("the launch counter did not move")
    if not torch.equal(got, paged_attention(**case)):
        raise AssertionError(f"{label}: two calls differ")
    torch.cuda.set_sync_debug_mode("error")
    try:
        again = paged_attention(**case)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    if not torch.equal(got, again):
        raise AssertionError(f"{label}: the call under the sync check "
                             "differs")
    ref = paged_attention_reference(**case)
    err = (got.float() - ref.float()).abs()
    limit = atol + rtol * ref.float().abs()
    max_err = float(err.max())
    if not bool((err <= limit).all()):
        raise AssertionError(f"{label}: kernel disagrees with its plain "
                             f"version (max |err| {max_err:.3e})")
    if not torch.isfinite(got).all():
        raise AssertionError(f"{label}: non-finite")
    print(f"kernel {label}: max|err| {max_err:.3e} (tol {atol:g} + "
          f"{rtol:g}*|ref|); two calls bitwise equal; no host sync in the "
          "call", flush=True)
    return ref, max_err


def _k4_peak(q_name, pool_name, tensor_cores) -> str:
    """The peak of K4's route for a pair: the tensor cores in bf16, a
    float32 operand as three bf16 parts (``PEAK_FLOPS``'s ``float32_bf16x*``
    keys), or float32 FMA."""
    if not tensor_cores:
        return "float32"
    return {("bfloat16", "bfloat16"): "bfloat16",
            ("float32", "bfloat16"): "float32_bf16x3",
            ("bfloat16", "float32"): "float32_bf16x4.5",
            ("float32", "float32"): "float32_bf16x6"}[q_name, pool_name]


def _k4_times(torch, case, ref, max_err, q_name, pool_name, plan) -> dict:
    """A K4 case's kernel, plain and SDPA times against its bound (and,
    on the tensor cores in float32, the bound at the FMA peak beside)."""
    from ray_tpu_torch.ops.paged_attention import (paged_attention,
                                                   paged_attention_reference)

    atol, rtol = TOL[q_name]
    compute = _k4_peak(q_name, pool_name, plan["tensor_cores"])
    sdpa = sdpa_call(torch, case)
    sdpa_err = float((sdpa().transpose(1, 2).float()
                      - ref.float()).abs().max())
    ms = time_ms(torch, lambda: paged_attention(**case))
    plain_ms = time_ms(torch, lambda: paged_attention_reference(**case),
                       iters=5, warmup=1)
    library_ms = time_ms(torch, sdpa)
    bound_ms, bound_by = bound(case, compute)
    r = dict(max_abs_err=max_err, atol=atol, rtol=rtol, ms=ms,
             plain_ms=plain_ms, library_ms=library_ms, bound_ms=bound_ms,
             bound_by=bound_by, bound_peak=compute,
             sdpa_max_abs_err=sdpa_err, plan=plan)
    if compute.startswith("float32_bf16x"):
        r["fma_bound_ms"] = bound(case, "float32")[0]
    print(f"  times: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, sdpa "
          f"{library_ms:.4f} ms, bound {bound_ms:.5f} ms ({bound_by}, peak "
          f"{compute})", flush=True)
    return r


# llama_debug's K4 shapes (H 4, Hkv 2, D 16, 16-token pages, 128-token
# arena: 8-page tables) in the harness serve probe (2 slots; cursors 10
# and 16, the longest each of its prompt lengths 3 and 9 reaches under its
# 8-token cap), and a verify window over them
K4_D16 = {"decode_d16": dict(S=2, K=1, lengths=[10, 16], H=4, Hkv=2, D=16,
                             P=8),
          "verify_d16": dict(S=2, K=SPEC_K + 1, lengths=[13, 100], H=4,
                             Hkv=2, D=16, P=8)}


# the same tokens in 8-token pages, which the route rule sends to the FMA
# kernel (the tensor cores take pages of a multiple of 16): llama3_8b's
# decode, prefill and verify, and llama_debug's D 16 decode and verify
K4_FMA = {"decode_t8": dict(S=8, K=1, lengths=DECODE_LENGTHS, T=8,
                            P=ARENA_LEN // 8),
          "prefill_t8": dict(S=1, K=32, lengths=[45], T=8, P=ARENA_LEN // 8),
          "verify_t8": dict(S=8, K=SPEC_K + 1, lengths=VERIFY_LENGTHS, T=8,
                            P=ARENA_LEN // 8),
          "decode_d16_t8": dict(K4_D16["decode_d16"], T=8, P=16),
          "verify_d16_t8": dict(K4_D16["verify_d16"], T=8, P=16)}


def _k4_fma_route(torch, results, dtype_name, q_name, pool_name):
    """Each ``K4_FMA`` case of a pair on the FMA kernel, against its plain
    version; the decode cases of the float32-pool pairs timed beside their
    16-token cases on the tensor cores; every verify window row equal to
    its 1-token call."""
    from ray_tpu_torch.ops.paged_attention import paged_attention

    dtype, pool_dtype = getattr(torch, q_name), getattr(torch, pool_name)
    for shape_name, shp in K4_FMA.items():
        case = make_case(torch, dtype, **shp, pool_dtype=pool_dtype)
        plan = _plan_line(case)
        if plan["tensor_cores"]:
            raise AssertionError(f"{shape_name} {dtype_name}: the route "
                                 "rule sent 8-token pages to the tensor "
                                 "cores")
        ref, max_err = _k4_check(torch, case,
                                 f"{shape_name} {dtype_name} (FMA)", q_name)
        key = f"{shape_name}_{dtype_name}"
        if shape_name.startswith("decode") and pool_name == "float32" and (
                shape_name == "decode_t8" or q_name == "float32"):
            results[key] = _k4_times(torch, case, ref, max_err, q_name,
                                     pool_name, plan)
        else:
            results[key] = dict(max_abs_err=max_err, plan=plan)
        if shape_name.startswith("verify"):
            _window_rows_check(torch, paged_attention,
                               make_case(torch, dtype, **shp, seed=1,
                                         pool_dtype=pool_dtype),
                               f"{dtype_name} (FMA)")
    print(f"kernel {dtype_name}: on the FMA kernel with 8-token pages, "
          "every row of the verify windows equals a 1-token call bit for "
          "bit", flush=True)


def kernel_phase(torch) -> dict:
    from ray_tpu_torch.ops.paged_attention import paged_attention

    shapes = {
        # 8 slots, 1 token; lengths include 0 and page boundaries
        "decode": dict(S=8, K=1, lengths=DECODE_LENGTHS),
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
        for shape_name, shp in shapes.items():
            case = make_case(torch, dtype, **shp, pool_dtype=pool_dtype)
            ref, max_err = _k4_check(torch, case,
                                     f"{shape_name} {dtype_name}", q_name)
            plan = _plan_line(case)
            results[f"{shape_name}_{dtype_name}"] = _k4_times(
                torch, case, ref, max_err, q_name, pool_name, plan)
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
        # llama_debug's D 16 (its serving in the harness and the parity
        # phase): checked for every pair, timed for the float32 one, whose
        # launches the kernels line counts there
        for shape_name, shp in K4_D16.items():
            case = make_case(torch, dtype, **shp, pool_dtype=pool_dtype)
            ref, max_err = _k4_check(torch, case,
                                     f"{shape_name} {dtype_name}", q_name)
            plan = _plan_line(case)
            if (shape_name, dtype_name) == ("decode_d16", "float32"):
                results["decode_d16_float32"] = _k4_times(
                    torch, case, ref, max_err, q_name, pool_name, plan)
            else:
                results[f"{shape_name}_{dtype_name}"] = dict(
                    max_abs_err=max_err, plan=plan)
        _window_rows_check(torch, paged_attention,
                           make_case(torch, dtype, **K4_D16["verify_d16"],
                                     seed=1, pool_dtype=pool_dtype),
                           dtype_name)
        print(f"kernel {dtype_name}: every row of the D 16 verify windows "
              f"at lengths {K4_D16['verify_d16']['lengths']} equals a "
              "1-token call bit for bit", flush=True)
        _k4_fma_route(torch, results, dtype_name, q_name, pool_name)
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
#    In O only the order of the sums differs (at D=64 and 128 the float32
#    K1 runs six bf16 products of split parts on the tensor cores, whose
#    sums round toward zero); the float32 K2 and K3 run the same
#    sequential float32 FMA chains as their plain versions and agree with
#    them bit for bit.
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
    for K3, against the peak rate of the kernel's route: the inputs' type,
    or for the float32 K1 on the tensor cores six bf16 products a float32
    one (``float32_bf16x6``), with its bound at the float32 FMA peak beside
    it (``fwd_fma``)."""
    import torch

    from ray_tpu_torch.ops.flash_attention import kernel_route

    B, S, H, Hkv, D = (case[k] for k in ("B", "S", "H", "Hkv", "D"))
    pairs = S * (S + 1) // 2 if case["causal"] else S * S
    fwd_flops = 4 * B * H * D * pairs
    qb, kvb, rows = B * S * H * D * item, B * S * Hkv * D * item, B * H * S * 4
    work = {"fwd": (fwd_flops, 2 * qb + 2 * kvb + rows),
            "dq": (1.5 * fwd_flops, 3 * qb + 2 * kvb + 2 * rows),
            "dkv": (2 * fwd_flops, 2 * qb + 4 * kvb + 2 * rows)}
    peaks = {name: dtype_name for name in work}
    if dtype_name == "float32" and kernel_route(
            "flash_fwd", torch.float32, D) == "tensor cores":
        peaks["fwd"] = "float32_bf16x6"
        work["fwd_fma"] = work["fwd"]
        peaks["fwd_fma"] = "float32"
    out = {}
    for name, (flops, nbytes) in work.items():
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = flops / PEAK_FLOPS[peaks[name]] * 1e3
        out[name] = ((t_bytes, "bytes") if t_bytes >= t_ops
                     else (t_ops, "operations"))
    return out


def flash_routes(dtype, D) -> dict:
    """The route (tensor cores or FMA) K1, K2 and K3 take in ``dtype`` at
    head width ``D``."""
    from ray_tpu_torch.ops.flash_attention import kernel_route

    return {key: kernel_route(f"flash_{key}", dtype, D)
            for key in ("fwd", "dq", "dkv")}


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
            r = {"lse_atol": LSE_ATOL,
                 "routes": flash_routes(dtype, case["D"])}
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
                  "equal twice; routes K1 " + r["routes"]["fwd"] + ", K2 "
                  + r["routes"]["dq"] + ", K3 " + r["routes"]["dkv"],
                  flush=True)
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
    if cases is None:
        results["train_parity_shape_float32"] = _flash_f32_small(torch)
    return results


# the float32 K1-K3 of train parity's llama_debug and moe_debug (tokens
# [2, 48], 4 heads over 2 kv heads of width 16): FMA
TRAIN_PARITY_FLASH = dict(B=2, S=48, H=4, Hkv=2, D=16, causal=True)


def _flash_f32_small(torch) -> dict:
    """K1, K2 and K3 in float32 at ``TRAIN_PARITY_FLASH`` against their
    plain versions under the float32 gate, with their times, their plain
    versions', SDPA's forward and backward and their bounds."""
    import torch.nn.functional as F

    from ray_tpu_torch.ops import flash_attention as fa

    case = TRAIN_PARITY_FLASH
    q, k, v, do = flash_inputs(torch, case, torch.float32)
    o, lse = fa.flash_forward(q, k, v, causal=True)
    delta = fa.delta_rows(do, o)
    dq = fa.flash_dq(q, k, v, do, lse, delta, causal=True)
    dk, dv = fa.flash_dkv(q, k, v, do, lse, delta, causal=True)
    o_ref, lse_ref = fa.flash_forward_reference(q, k, v, causal=True)
    dq_ref = fa.flash_dq_reference(q, k, v, do, lse, delta, causal=True)
    dk_ref, dv_ref = fa.flash_dkv_reference(q, k, v, do, lse, delta,
                                            causal=True)
    r = {"routes": flash_routes(torch.float32, case["D"]),
         "lse_max_abs_err": float((lse - lse_ref).abs().max())}
    for key, got, ref in (("o", o, o_ref), ("dq", dq, dq_ref),
                          ("dk", dk, dk_ref), ("dv", dv, dv_ref)):
        err, _, used = _gate_err(got, ref, key, _gate(key, "float32"))
        r[f"{key}_max_abs_err"], r[f"{key}_gate_used"] = err, used
        if not (torch.isfinite(got).all() and used <= 1.0):
            raise AssertionError(f"flash f32 at {case}: {key} uses "
                                 f"{used:.3g} x the float32 gate")
    if not r["lse_max_abs_err"] <= LSE_ATOL:
        raise AssertionError(f"flash f32 at {case}: lse differs by "
                             f"{r['lse_max_abs_err']:.3e}")
    r.update(_flash_times(torch, F, fa, case, "float32",
                          (q, k, v, do, lse, delta)))
    print(f"flash f32 at train parity's shape {case}: routes {r['routes']}; "
          f"max|err| o {r['o_max_abs_err']:.2e}, dq {r['dq_max_abs_err']:.2e}"
          f", dk {r['dk_max_abs_err']:.2e}, dv {r['dv_max_abs_err']:.2e} "
          "(float32 gate)", flush=True)
    return r


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
    if "fwd_fma" in bounds:  # the float32 K1 on the tensor cores
        r["fwd_fma_bound_ms"] = bounds["fwd_fma"][0]
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
            if dev == "cuda":
                launches = {f.__name__: f.launches for f in fa.KERNELS}
                if launches["flash_dkv"] == 0:
                    raise AssertionError("the card run did not use the "
                                         "kernels")
        if not all(math.isfinite(x) for x in sum(runs["cuda"], [])):
            raise AssertionError(f"{name}: non-finite metrics {runs}")
        rel = max(abs(a - b) / abs(b) for x, y in zip(runs["cuda"],
                                                      runs["cpu"])
                  for a, b in zip(x, y))
        out[name] = dict(card=runs["cuda"], cpu=runs["cpu"], max_rel=rel,
                         rtol=TRAIN_PARITY_RTOL, launches=launches)
        what = ("losses, grad norms and routing losses"
                if len(runs["cpu"]) > 2 else "losses and grad norms")
        print(f"train parity {name}: float32, {TRAIN_STEPS} steps, {what} "
              f"card vs CPU within {rel:.2e} (rtol "
              f"{TRAIN_PARITY_RTOL:g}); losses "
              f"{[round(x, 5) for x in runs['cuda'][0]]}; K1-K3 launches "
              f"on the card {launches}", flush=True)
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


def serve_phase(torch, overrides=None) -> dict:
    """llama3_8b in this process, the 12 requests; with ``overrides``
    (``CUT_OVERRIDES``) at fewer layers and unprofiled: the plain
    yardstick at the depth of the runtime and serve-app phases' replicas,
    whose texts and rates are held against it."""
    name = "serve" if overrides is None else f"serve-{CUT_LAYERS}"
    srv = _llama3_8b_server(torch, name, preset_overrides=overrides)
    try:
        cfg = srv.cfg
        texts, ttfts, wall, launches, before, st = _serve_requests(srv)
        prof = (profile_decode(torch, srv, SYSTEM_PROMPT)
                if overrides is None else None)
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
             layers=cfg.num_layers, profile=prof, texts=texts)
    print(f"{name}: {r['requests']} requests, {tokens} tokens in {wall:.2f} s"
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
    and ``CUT_LAYERS`` of its 32 layers, on one tree of seed-0 bf16 weights
    (serve-8's) shared by every configuration through ``params_loader``:
    (a) ``attn="gather"``, (b) ``kv_layout="contiguous"``, (c) a pool of
    ``LANES_KV_PAGES`` pages with the prefix cache and an ``eos_id`` the
    serve-8's first greedy text emits, (d) ``scheduler="batch"``. Each
    (e) ``cache_dtype=torch.float32`` (K4 on its bf16 q / float32 pool
    pair), (f) the same tree in float32 (``preset_overrides``) over
    ``cache_dtype=torch.bfloat16`` (K4's float32 q / bf16 pool pair).
    Each runs serve-8's 12 requests and is freed before the next.
    K4 launches are exact for each dtype pair: 0 off the in-place lane,
    layers x (chunks + steps) on it. The count of temperature-0 texts
    equal to serve-8's ``plain`` texts (up to the EOS in (c)) is
    printed, not gated: in bf16 the lanes' attention and the batch path's
    GEMMs round otherwise, and (e) and (f) keep or widen other
    roundings."""
    from ray_tpu_torch import presets
    from ray_tpu_torch.models.transformer import init_params
    from ray_tpu_torch.ops.paged_attention import paged_attention, split_plan

    cfg = presets.llama3_8b(**CUT_OVERRIDES)
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
        "f_f32_cache_bf16": dict(preset_overrides=dict(
            CUT_OVERRIDES, dtype=torch.float32), cache_dtype=torch.bfloat16),
    }
    # the K4 dtype pair (q/pool) of each in-place configuration
    pairs = {"c_kv_pages": "bfloat16/bfloat16",
             "e_cache_f32": "bfloat16/float32",
             "f_f32_cache_bf16": "float32/bfloat16"}
    # the split kernel each pair takes at llama3_8b's decode shape: the
    # tensor cores for each (a float32 operand as three bf16 parts)
    routes = {}
    for name, pair in pairs.items():
        qb, pb = (2 if d == "bfloat16" else 4 for d in pair.split("/"))
        routes[name] = ("tensor cores" if split_plan(
            8, 1, cfg.num_heads, cfg.kv_heads, cfg.head_dim, 16,
            ARENA_LEN // 16, pb, qb).tensor_cores else "FMA")
    if set(routes.values()) != {"tensor cores"}:
        raise AssertionError(f"serve-lanes: K4's routes {routes}")
    out = {"eos_id": eos}
    for name, kw in configs.items():
        batch = kw.get("scheduler") == "batch"
        kw.setdefault("preset_overrides", CUT_OVERRIDES)
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
        if name in routes:
            r["k4_route"] = routes[name]
            line += f"; K4's split kernel on the {routes[name]}"
        print(f"serve-lanes {name}: {r['requests']} requests, {tokens} "
              f"tokens in {wall:.2f} s = {r['tokens_per_s']:.1f} tokens/s; "
              f"TTFT mean {r['ttft_mean_s']:.3f} s, max "
              f"{r['ttft_max_s']:.3f} s{line}; K4 launches by q/pool "
              f"dtype {pair_launches} (expected {want}); "
              f"{r['greedy_texts_equal']} of 11 "
              "temperature-0 texts equal serve-8's", flush=True)
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
    """llama3_8b at full width and ``CUT_LAYERS`` layers in a num_gpus=1
    actor, the serve phase's arena, slots, chunks and pages, seed-0 bf16
    weights: the warm-up, then the 12 requests streamed, arriving
    together, request 5 sampled at 0.7; pings to the actor while it
    serves; K4's launches counted in the worker."""
    from concurrent.futures import ThreadPoolExecutor

    Host = rt.remote(ReplicaHost).options(num_gpus=1, max_concurrency=64)
    t0 = time.perf_counter()
    h = Host.remote(preset="llama3_8b", preset_overrides=CUT_OVERRIDES,
                    arena_len=ARENA_LEN,
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
          f"{wall:.2f} s = {r['tokens_per_s']:.1f} tokens/s (serve-8 "
          f"{serve['tokens_per_s']:.1f}); decode step "
          f"{r['decode_step_ms']:.2f} ms (serve-8 "
          f"{serve['decode_step_ms']:.2f}); TTFT mean "
          f"{r['ttft_mean_s']:.3f} s, max {r['ttft_max_s']:.3f} s; "
          f"{launches} K4 launches in the worker = {layers} x ({chunks} + "
          f"{steps}); streamed = whole; {equal} of 11 temperature-0 texts "
          f"equal serve-8's; {len(pings)} pings while serving, "
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

# the serve-app phase's arena: the 8-layer llama3_8b tree once, plus room
# for the phase's other objects (requests, the float32 llama_debug tree),
# and below the store's 0.8 spilling threshold with the tree in it
SERVE_APP_STORE = 24 * 2 ** 30
# LLMServerImpl's default key for that tree
SERVE_APP_KEY = f"llm:llama3_8b:num_layers={CUT_LAYERS}:seed0"
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
        preset="llama3_8b", preset_overrides=CUT_OVERRIDES,
        arena_len=ARENA_LEN, max_new_tokens=SERVE_NEW_TOKENS,
        detokenize=_ids_text)
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
          f"together: {first['tokens_per_s']:.1f} tokens/s (serve-8 "
          f"{serve_ref['tokens_per_s']:.1f}, runtime ReplicaHost "
          f"{rtx['tokens_per_s']:.1f}); decode step "
          f"{first['decode_step_ms']:.2f} ms (serve-8 "
          f"{serve_ref['decode_step_ms']:.2f}, ReplicaHost "
          f"{rtx['decode_step_ms']:.2f}); TTFT mean "
          f"{first['ttft_mean_s']:.3f} s, max {first['ttft_max_s']:.3f} s;"
          f" {launches} K4 launches in the replica = {layers} x ({chunks} + "
          f"{steps}); {first['prefix_hits']} prefix hits; streamed = whole;"
          f" {equal} of 11 temperature-0 texts equal serve-8's; "
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
          f" equal serve-8's", flush=True)
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
    from ray_tpu_torch.scripts.card_back import card_back
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
        r["card_back"] = back = card_back(rt, rt_api._core, serve)
        if back["visible"] != "0":
            raise AssertionError(f"after serve.shutdown: {back}")
        r["card_back_s"] = back["probe_up_s"]
        print(f"serve-app: serve.shutdown() gave the card back: a "
              f"num_gpus=1 actor up {r['card_back_s']:.2f} s after it "
              f"began; from its start, graceful_shutdown returned "
              f"{back['graceful_shutdown_s']:.2f} s, the replicas' "
              f"processes ({back['replica_pids']}) gone "
              f"{back['replicas_gone_s']:.2f} s, serve.shutdown() returned "
              f"{back['serve_shutdown_s']:.2f} s, GPU 1 free "
              f"{back['gpu_free_s']:.2f} s, the probe up "
              f"{back['probe_up_s']:.2f} s", flush=True)
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
    srv = LLMServerImpl(preset="llama3_8b", preset_overrides=CUT_OVERRIDES,
                        device="cpu", share_weights=False,
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
PIPE_LAYERS = 2            # (b) depth cut from 12: stage 0 runs on the CPU
PIPE_STEPS = 1             # (b) timed steps, after one warm-up step
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


# ----------------------------------------------------------------- tune

TUNE_B, TUNE_S = 8, 1024
# (a) ASHA over the lr grid, best-first: with one trial at a time an
# asynchronous rung only ever compares a trial with those before it, so
# ascending rates (each later trial learning faster) would let every trial
# through. Two rates, not four: each trial is a fresh process on the card
# (about 20 s before its first step ends), and the run has a limit; the
# second is still stopped at the rung at 4 iterations
TUNE_LRS = [3e-3, 1e-4]
TUNE_MAX_T = 6
PBT_LAYERS, PBT_ITERS, PBT_LRS = 4, 6, [1e-4, 3e-3]
GANG_LRS, GANG_STEPS = [1e-4, 1e-3], 3


def _gpt2_tune_setup(torch, layers: int, lr: float):
    """gpt2_small at full width (``layers`` deep), ``remat=False``, CE
    chunk 8192, params from seed 0, AdamW at ``lr`` with no warmup (the
    rate acts from the first update), the batch phase 13's recipe makes
    (a seeded card generator), B8 x S1024."""
    from ray_tpu_torch import presets
    from ray_tpu_torch.models.training import (OptimizerConfig,
                                               init_train_state,
                                               make_train_step)

    cfg = presets.gpt2_small(remat=False, ce_chunk=8192, num_layers=layers)
    state, tx = init_train_state(
        cfg, OptimizerConfig(learning_rate=lr, warmup_steps=0,
                             decay_steps=1000), seed=0, device="cuda")
    g = torch.Generator(device="cuda").manual_seed(1)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (TUNE_B, TUNE_S),
                                     generator=g, device="cuda")}
    return cfg, state, make_train_step(cfg, tx), batch


def _state_leaves(state):
    from ray_tpu_torch.models.transformer import _leaves

    return (_leaves(state.params) + _leaves(state.opt_state.mu)
            + _leaves(state.opt_state.nu))


def _digest(torch, leaves) -> str:
    """sha256 over the leaves' bytes, in order (wherever they live)."""
    import hashlib

    h = hashlib.sha256()
    for t in leaves:
        h.update(t.detach().contiguous().reshape(-1).view(torch.uint8)
                 .cpu().numpy().tobytes())
    return h.hexdigest()


def _tune_trial(config):
    """A phase 15 (a)/(b) trial, in its own process on its card:
    ``_gpt2_tune_setup`` at the trial's depth and rate, one step and one
    ``tune.report`` per iteration; with ``ckpt_every``, a checkpoint of
    the params and Adam moments (CPU tensors, with a digest taken from the
    card) every that many iterations. A trial restarted from a checkpoint
    loads it onto its card, continues its step counter, and reports the
    digest of what it loaded. With ``barrier``, a fresh trial first waits
    until ``population`` trials have reached it (PBT only compares trials
    that are live together). The flash launch counters of this process go
    to 0 before the first step and are reported with every result."""
    import os
    import tempfile

    import torch

    from ray_tpu_torch import tune
    from ray_tpu_torch._private.device import resolve_device
    from ray_tpu_torch.ops import flash_attention as fa
    from ray_tpu_torch.train import Checkpoint

    t_enter = time.time()
    t0 = time.perf_counter()
    resolve_device("cuda")
    torch.zeros(1, device="cuda")
    torch.cuda.synchronize()
    cuda_s = time.perf_counter() - t0
    cfg, state, step, batch = _gpt2_tune_setup(torch, config["layers"],
                                               config["lr"])
    start, restored = 0, None
    ckpt = tune.get_checkpoint()
    if ckpt is not None:
        with ckpt.as_directory() as d:
            blob = torch.load(os.path.join(d, "state.pt"))
        # the file holds CPU tensors: onto this trial's card
        for t, saved in zip(_state_leaves(state), blob["leaves"]):
            t.data.copy_(saved.to(t.device))
        state.opt_state.count = state.step = start = blob["step"]
        restored = {"from": ckpt.path, "from_step": blob["step"],
                    "saved_digest": blob["digest"],
                    "digest": _digest(torch, _state_leaves(state)),
                    "device": str(_state_leaves(state)[0].device)}
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0 - cuda_s
    if config.get("barrier") and ckpt is None:
        os.makedirs(config["barrier"], exist_ok=True)
        open(os.path.join(config["barrier"], str(os.getpid())), "w").close()
        deadline = time.time() + RT_TIMEOUT
        while len(os.listdir(config["barrier"])) < config["population"]:
            if time.time() > deadline:
                raise TimeoutError("the population never came up")
            time.sleep(0.05)
    _reset_counters(fa)
    leaf = _state_leaves(state)[0]
    for it in range(start + 1, config["iters"] + 1):
        t1 = time.perf_counter()
        state, m = step(state, batch)
        loss = float(m["loss"])
        metrics = {"loss": loss, "step": it, "lr": config["lr"],
                   "t": time.time(),
                   "step_ms": (time.perf_counter() - t1) * 1e3,
                   "launches": {f.__name__: f.launches for f in fa.KERNELS},
                   "visible": os.environ.get("CUDA_VISIBLE_DEVICES"),
                   "device": str(leaf.device),
                   "device_count": torch.cuda.device_count(),
                   "layers": cfg.num_layers, "pid": os.getpid()}
        if it == start + 1:
            metrics.update(t_enter=t_enter, cuda_s=cuda_s, setup_s=setup_s,
                           restored=restored)
        every = config.get("ckpt_every")
        if every and it % every == 0:
            leaves = _state_leaves(state)
            with tempfile.TemporaryDirectory() as d:
                torch.save({"step": it, "digest": _digest(torch, leaves),
                            "leaves": [t.detach().cpu() for t in leaves]},
                           os.path.join(d, "state.pt"))
                tune.report(metrics, checkpoint=Checkpoint.from_directory(d))
        else:
            tune.report(metrics)


def _tune_gang_loop(config):
    """Phase 15 (c), in ``TorchTrainer``'s worker: ``_gpt2_tune_setup`` at
    12 layers and the trial's rate, ``GANG_STEPS`` steps, one
    ``train.report`` each; the flash launch counters go to 0 before the
    first step and come with the last report, beside every loss."""
    import os

    import torch

    from ray_tpu_torch import train
    from ray_tpu_torch._private.device import resolve_device
    from ray_tpu_torch.ops import flash_attention as fa

    resolve_device("cuda")
    cfg, state, step, batch = _gpt2_tune_setup(torch, 12, config["lr"])
    _reset_counters(fa)
    losses, ms = [], []
    for i in range(GANG_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
        ms.append((time.perf_counter() - t0) * 1e3)
        metrics = {"loss": losses[-1], "step": i + 1}
        if i == GANG_STEPS - 1:
            metrics.update(
                losses=losses, step_ms=ms,
                launches={f.__name__: f.launches for f in fa.KERNELS},
                visible=os.environ.get("CUDA_VISIBLE_DEVICES"),
                device=str(_state_leaves(state)[0].device),
                layers=cfg.num_layers)
        train.report(metrics)


def _in_process_losses(torch, layers, lr, steps) -> dict:
    """The same setup and steps in this process on the card."""
    cfg, state, step, batch = _gpt2_tune_setup(torch, layers, lr)
    losses, ms = [], []
    for _ in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
        ms.append((time.perf_counter() - t0) * 1e3)
    del state, step, batch
    torch.cuda.empty_cache()
    return {"losses": losses, "step_ms": ms}


def _asha_replay(grid, max_t) -> dict:
    """Feed the recorded results, trial by trial in the order they ran
    (one at a time), to a fresh port ``ASHAScheduler``; for each trial
    the iteration at which it says STOP."""
    import types

    from ray_tpu_torch.tune import ASHAScheduler

    s = ASHAScheduler(grace_period=2, reduction_factor=2, max_t=max_t)
    s.set_objective("loss", "min")
    out = {}
    for r in grid:
        stub = types.SimpleNamespace(trial_id=r.metrics["trial_id"],
                                     config=r.config)
        for m in r.metrics_history:
            if s.on_trial_result(stub, m) == "STOP":
                out[stub.trial_id] = m["training_iteration"]
                break
        s.on_trial_complete(stub, r.metrics)
    return out


def _check_trial_card(m, what):
    if (m["visible"], m["device"], m["device_count"]) != ("0", "cuda:0", 1):
        raise AssertionError(f"{what}: the trial's process sees "
                             f"{m['visible']!r}, {m['device']}, "
                             f"{m['device_count']} cards")


def tune_phase(torch, train_ref, dp_ref) -> dict:
    """Phase 15: Tune on the card. (a) ASHA over a function trainable,
    one trial process per rate on the card; then, on a node that lists
    the card twice, (c) ``Tuner`` over ``TorchTrainer``, the gang path,
    and (b) PBT with checkpoints, each with its two trials sharing the
    card."""
    import os
    import shutil

    import ray_tpu_torch as rt
    from ray_tpu_torch import tune
    from ray_tpu_torch.air.config import RunConfig
    from ray_tpu_torch.train import ScalingConfig, TorchTrainer
    from ray_tpu_torch.tune import (ASHAScheduler, PopulationBasedTraining,
                                    TuneConfig, Tuner)

    r = {}
    storage = ROOT / "build" / "tune"
    shutil.rmtree(storage, ignore_errors=True)
    # in-process references: (c)'s rates, 12 layers; the first loss does
    # not depend on the rate, and is (a)'s reference too
    ref = {lr: _in_process_losses(torch, 12, lr, GANG_STEPS)
           for lr in GANG_LRS}
    first = ref[GANG_LRS[0]]["losses"][0]
    in_ms = ref[GANG_LRS[0]]["step_ms"][1:]
    r["in_process"] = {str(lr): v for lr, v in ref.items()}
    t_init = time.perf_counter()
    rt.init(num_gpus=1)
    try:
        r["init_s"] = time.perf_counter() - t_init
        # ---- (a) ASHA over a function trainable, one trial at a time
        t0 = time.time()
        grid = Tuner(
            tune.with_resources(_tune_trial, {"CPU": 1, "GPU": 1}),
            param_space={"lr": tune.grid_search(TUNE_LRS), "layers": 12,
                         "iters": TUNE_MAX_T},
            tune_config=TuneConfig(
                metric="loss", mode="min", max_concurrent_trials=1,
                scheduler=ASHAScheduler(max_t=TUNE_MAX_T, grace_period=2,
                                        reduction_factor=2)),
            run_config=RunConfig(storage_path=str(storage), name="asha"),
        ).fit()
        fit_s = time.time() - t0
        if grid.num_errors:
            raise AssertionError(f"(a) trials failed: {grid.errors}")
        trials, prev_end = [], t0  # one trial at a time, in grid order
        for res in grid:
            hist = res.metrics_history
            last, m0 = hist[-1], hist[0]
            for m in hist:
                _check_trial_card(m, "(a)")
            n = len(hist)
            want = {"flash_forward": 12 * n, "flash_dq": 12 * n,
                    "flash_dkv": 12 * n}
            if last["launches"] != want:
                raise AssertionError(f"(a) lr {res.config['lr']}: flash "
                                     f"launches {last['launches']}, "
                                     f"expected {want}")
            rel = abs(m0["loss"] - first) / abs(first)
            if not rel <= TRAIN_PARITY_RTOL:
                raise AssertionError(f"(a) lr {res.config['lr']}: first loss "
                                     f"{m0['loss']} against {first} in "
                                     f"process")
            trials.append(dict(
                lr=res.config["lr"], iterations=n,
                losses=[m["loss"] for m in hist], launches=last["launches"],
                first_loss_rel=rel, first_loss_equal=m0["loss"] == first,
                start_s=m0["t_enter"] - prev_end, cuda_s=m0["cuda_s"],
                setup_s=m0["setup_s"],
                step_ms=[m["step_ms"] for m in hist]))
            prev_end = last["t"]
        stopped = {res.metrics["trial_id"]: len(res.metrics_history)
                   for res in grid}
        replay = _asha_replay(grid, TUNE_MAX_T)
        if replay != stopped:
            raise AssertionError(f"(a) stop decisions {stopped} differ from "
                                 f"a replay through a fresh ASHA {replay}")
        early = [t["lr"] for t in trials if t["iterations"] < TUNE_MAX_T]
        if not early:
            raise AssertionError(f"(a) no trial stopped before max_t: "
                                 f"{[t['iterations'] for t in trials]}")
        r["asha"] = dict(trials=trials, fit_s=fit_s, stopped_early=early,
                         first_loss_in_process=first,
                         in_process_step_ms=in_ms,
                         launches={k: sum(t["launches"][k] for t in trials)
                                   for k in trials[0]["launches"]})
        a = r["asha"]
        bit = sum(t["first_loss_equal"] for t in trials)
        print(f"tune (a): ASHA(max_t {TUNE_MAX_T}, grace 2, rf 2) over "
              f"gpt2_small 12 layers B{TUNE_B} x S{TUNE_S}, lr "
              f"{TUNE_LRS}, one trial process at a time on the card "
              f"(CUDA_VISIBLE_DEVICES=0, cuda:0): fit {fit_s:.1f} s; "
              f"iterations {[t['iterations'] for t in trials]}, stopped "
              f"early lr {early}, equal to a replay through a fresh ASHA; "
              f"flash launches 12 x iterations in every trial; first losses"
              f" within {max(t['first_loss_rel'] for t in trials):.2e} of "
              f"the in-process step ({bit} of {len(trials)} bit-equal); per"
              f" trial start {[round(t['start_s'], 2) for t in trials]} s, "
              f"CUDA init {[round(t['cuda_s'], 2) for t in trials]} s, "
              f"setup {[round(t['setup_s'], 2) for t in trials]} s; step "
              f"ms in the trials "
              f"{[round(min(t['step_ms'][1:]), 1) for t in trials]} (best "
              f"after the first), in process "
              f"{[round(x, 1) for x in in_ms]}, phase 13 (B16) "
              f"{train_ref['gpt2_small']['step_ms']:.1f} in process and "
              f"{dp_ref['trainer']['step_ms']:.1f} in its train worker",
              flush=True)
    finally:
        rt.shutdown()
    # ---- (c) and (b) on a node that lists the one card twice
    # (CUDA_VISIBLE_DEVICES=0,0 with num_gpus=2: each trial is handed
    # "card 0", the same device): PBT compares live trials, so its two
    # trials run together, and (c)'s two gangs run together to save a
    # trial's start-up
    saved = os.environ.get("CUDA_VISIBLE_DEVICES")
    os.environ["CUDA_VISIBLE_DEVICES"] = "0,0"
    try:
        rt.init(num_gpus=2)
    finally:
        if saved is None:
            del os.environ["CUDA_VISIBLE_DEVICES"]
        else:
            os.environ["CUDA_VISIBLE_DEVICES"] = saved
    try:
        # ---- (c) Tuner over TorchTrainer: the gang path, the two
        # trials' gangs placed together on the card listed twice
        t0 = time.time()
        trainer = TorchTrainer(
            _tune_gang_loop, train_loop_config={"lr": 0.0},
            scaling_config=ScalingConfig(num_workers=1, use_gpu=True),
            run_config=RunConfig(storage_path=str(storage / "inner")))
        tuner = Tuner(
            trainer,
            param_space={"train_loop_config": {
                "lr": tune.grid_search(GANG_LRS)}},
            tune_config=TuneConfig(metric="loss", mode="min",
                                   max_concurrent_trials=2),
            run_config=RunConfig(storage_path=str(storage), name="gang"))
        gang = tuner._resolve_trainable()[2]
        if gang != [{"CPU": 1.0}, {"CPU": 1.0, "GPU": 1.0}]:
            raise AssertionError(f"(c) gang bundles {gang}")
        grid = tuner.fit()
        fit_s = time.time() - t0
        if grid.num_errors:
            raise AssertionError(f"(c) trials failed: {grid.errors}")
        rows = []
        for res in grid:
            m, lr = res.metrics, res.config["train_loop_config"]["lr"]
            want = {"flash_forward": 12 * GANG_STEPS,
                    "flash_dq": 12 * GANG_STEPS,
                    "flash_dkv": 12 * GANG_STEPS}
            if (m["visible"], m["device"]) != ("0", "cuda:0"):
                raise AssertionError(f"(c) the inner worker sees "
                                     f"{m['visible']!r}, {m['device']}")
            if m["launches"] != want:
                raise AssertionError(f"(c) flash launches {m['launches']}, "
                                     f"expected {want}")
            want_l = ref[lr]["losses"]
            rel = max(abs(a - b) / abs(b) for a, b in zip(m["losses"],
                                                          want_l))
            if not rel <= TRAIN_PARITY_RTOL:
                raise AssertionError(f"(c) lr {lr}: losses {m['losses']} "
                                     f"against {want_l} in process")
            rows.append(dict(lr=lr, losses=m["losses"], max_rel=rel,
                             bit_equal=sum(a == b for a, b in zip(
                                 m["losses"], want_l)),
                             step_ms=m["step_ms"], launches=m["launches"]))
        best = grid.get_best_result().config["train_loop_config"]["lr"]
        lowest = min(rows, key=lambda x: x["losses"][-1])["lr"]
        if best != lowest:
            raise AssertionError(f"(c) best result lr {best}, the lowest "
                                 f"final loss lr {lowest}")
        r["gang"] = dict(trials=rows, fit_s=fit_s, best_lr=best, gang=gang)
        print(f"tune (c): Tuner over TorchTrainer(num_workers=1, "
              f"use_gpu=True), gang {gang}, gpt2_small 12 layers, lr "
              f"{GANG_LRS}, {GANG_STEPS} steps each, the two trials "
              f"together on the card listed twice: fit {fit_s:.1f} s; the"
              f" inner worker on card 0 (cuda:0), flash launches "
              f"12 x {GANG_STEPS} in each; best lr {best} (the lower final"
              f" loss); losses within "
              f"{max(x['max_rel'] for x in rows):.2e} of the in-process "
              f"run ({sum(x['bit_equal'] for x in rows)} of "
              f"{GANG_STEPS * len(rows)} steps bit-equal); inner step ms "
              f"{[[round(v, 1) for v in x['step_ms']] for x in rows]}",
              flush=True)
        # ---- (b) PBT with checkpoints
        t0 = time.time()
        grid = Tuner(
            tune.with_resources(_tune_trial, {"CPU": 1, "GPU": 1}),
            param_space={"lr": tune.grid_search(PBT_LRS),
                         "layers": PBT_LAYERS, "iters": PBT_ITERS,
                         "ckpt_every": 2, "population": len(PBT_LRS),
                         "barrier": str(storage / "pbt_barrier")},
            tune_config=TuneConfig(
                metric="loss", mode="min", max_concurrent_trials=2,
                scheduler=PopulationBasedTraining(
                    perturbation_interval=2,
                    hyperparam_mutations={"lr": tune.loguniform(1e-4, 3e-3)},
                    seed=0)),
            run_config=RunConfig(storage_path=str(storage), name="pbt"),
        ).fit()
        fit_s = time.time() - t0
        if grid.num_errors:
            raise AssertionError(f"(b) trials failed: {grid.errors}")
        restores, exploits = [], 0
        for res in grid:
            lrs = [m["lr"] for m in res.metrics_history]
            exploits += sum(a != b for a, b in zip(lrs, lrs[1:]))
            for m in res.metrics_history:
                _check_trial_card(m, "(b)")
                rs = m.get("restored")
                if rs is None:
                    continue
                with open(Path(rs["from"]) / "state.pt", "rb") as f:
                    blob = torch.load(f)
                file_digest = _digest(torch, blob["leaves"])
                own = f"trial_{res.metrics['trial_id']}" in rs["from"]
                restores.append(dict(
                    trial=res.metrics["trial_id"], from_own=own,
                    from_step=rs["from_step"], first_step=m["step"],
                    device=rs["device"],
                    equal=rs["digest"] == rs["saved_digest"] == file_digest))
        if not exploits or not restores:
            raise AssertionError(f"(b) no exploit: restores {restores}")
        for x in restores:
            if not x["equal"] or x["device"] != "cuda:0":
                raise AssertionError(f"(b) a restarted trial's state on "
                                     f"the card differs from its "
                                     f"checkpoint: {x}")
            if x["first_step"] != x["from_step"] + 1:
                raise AssertionError(f"(b) the step counter does not "
                                     f"continue from the checkpoint: {x}")
        cross = sum(not x["from_own"] for x in restores)
        r["pbt"] = dict(fit_s=fit_s, restores=restores, exploits=exploits,
                        from_other_trial=cross,
                        final={str(res.config["lr"]): res.metrics["loss"]
                               for res in grid})
        print(f"tune (b): PBT(perturbation_interval 2) over gpt2_small "
              f"{PBT_LAYERS} layers, lr {PBT_LRS}, {PBT_ITERS} iterations, "
              f"a checkpoint every 2, the two trials on the one card "
              f"together: fit {fit_s:.1f} s; {exploits} exploit(s) (the "
              f"rate changed), {len(restores)} restart(s) from a checkpoint"
              f" ({cross} from the other trial's); every "
              f"restarted trial's params and Adam moments on cuda:0 equal "
              f"its checkpoint byte for byte (sha256), its step counter "
              f"going on from the checkpoint's step", flush=True)
    finally:
        rt.shutdown()
        shutil.rmtree(storage, ignore_errors=True)
    return r


# ------------------------------------------------------------------ dag

DAG_WARM, DAG_TIMED = 2, 10
DAG_DYNAMIC = 3
CLIENT_TIMEOUT = 300


def _dag_text(i: int) -> str:
    """Execute i's input: TUNE_B x TUNE_S printable characters from a
    seed."""
    import numpy as np

    rng = np.random.default_rng(100 + i)
    return bytes(rng.integers(32, 127, TUNE_B * TUNE_S).astype(
        np.uint8)).decode()


def _dag_prep(text: str):
    """Byte-tokenize the text into a [B, S] batch of token ids (CPU)."""
    import torch

    ids = torch.tensor(list(text.encode()), dtype=torch.int64)
    return ids[:TUNE_B * TUNE_S].reshape(TUNE_B, TUNE_S)


class DagPrep:
    """Phase 16 (b)'s CPU stage."""

    def prep(self, text):
        return _dag_prep(text)


class DagLearner:
    """Phase 16's card stage: gpt2_small (12 layers) from seed 0, AdamW at
    phase 13's settings, one train step per call on the batch it is given
    (moved onto its card); the flash launch counters of its process go to
    0 when it is built."""

    def __init__(self):
        import torch

        from ray_tpu_torch import presets
        from ray_tpu_torch._private.device import resolve_device
        from ray_tpu_torch.models.training import (OptimizerConfig,
                                                   init_train_state,
                                                   make_train_step)
        from ray_tpu_torch.ops import flash_attention as fa

        resolve_device("cuda")
        cfg = presets.gpt2_small(remat=False, ce_chunk=8192)
        self.state, tx = init_train_state(
            cfg, OptimizerConfig(warmup_steps=10, decay_steps=1000), seed=0,
            device="cuda")
        self.step_fn = make_train_step(cfg, tx)
        self.torch, self.fa = torch, fa
        _reset_counters(fa)

    def step(self, tokens):
        import os

        torch = self.torch
        t0 = time.perf_counter()
        self.state, m = self.step_fn(self.state,
                                     {"tokens": tokens.to("cuda")})
        loss = float(m["loss"])
        return {"loss": loss, "step_ms": (time.perf_counter() - t0) * 1e3,
                "launches": {f.__name__: f.launches for f in self.fa.KERNELS},
                "visible": os.environ.get("CUDA_VISIBLE_DEVICES"),
                "device": str(_state_leaves(self.state)[0].device),
                "cuda_initialized": torch.cuda.is_initialized()}


def _card_loss(tokens, marker_dir):
    """gpt2_small (12 layers) from seed 0 in bf16 on this task's card: the
    loss of the batch, as a 0-dim float32 CUDA tensor (the object layer
    hands it out as a CPU tensor); one marker file per run."""
    import os

    import torch

    from ray_tpu_torch import presets
    from ray_tpu_torch._private.device import resolve_device
    from ray_tpu_torch.models.transformer import init_params, loss_fn

    resolve_device("cuda")
    open(os.path.join(marker_dir, f"{os.getpid()}-{time.time_ns()}"),
         "w").close()
    cfg = presets.gpt2_small(remat=False, ce_chunk=8192)
    params = init_params(cfg, 0, "cuda", param_dtype=cfg.param_dtype)
    with torch.no_grad():
        _, m = loss_fn(cfg, params, {"tokens": tokens.to("cuda")})
    return m["loss"].detach().float()


def _wf_summary(loss, flag):
    """The workflow's last step; it fails until ``flag`` exists, so the
    resume that follows must load the card step's checkpoint."""
    import math
    import os

    if not os.path.exists(flag):
        raise RuntimeError("the summary step fails on its first run")
    return {"loss": loss, "bits_per_token": float(loss) / math.log(2)}


def _bits(torch, t) -> int:
    return int(t.reshape(1).view(torch.int32)[0])


_CLIENT_SERVER = """
import asyncio, signal, sys
sys.path.insert(0, {root!r})
import ray_tpu_torch as rt
from ray_tpu_torch.util.client.server import ClientServer

async def main():
    srv = ClientServer(None, host="127.0.0.1", port=0,
                       init_kwargs={{"num_gpus": 1}})
    addr = await srv.start()
    stop = asyncio.Event()
    asyncio.get_running_loop().add_signal_handler(signal.SIGTERM, stop.set)
    print("READY", addr[1], flush=True)
    await stop.wait()
    await srv.stop()
    await asyncio.to_thread(rt.shutdown)

asyncio.run(main())
"""

_CLIENT = """
import json, sys, time
sys.path.insert(0, {root!r})
import cloudpickle, torch
import chip_smoke as c
import ray_tpu_torch as rt

cloudpickle.register_pickle_by_value(c)
t0 = time.perf_counter()
info = rt.init(address="client://127.0.0.1:{port}")
tokens = c._dag_prep(c._dag_text(0))
loss = rt.get(rt.remote(c._card_loss).options(num_gpus=1).remote(
    tokens, {marker!r}), timeout={timeout})
out = {{"client": info.get("client"), "type": type(loss).__name__,
        "device": str(loss.device), "dtype": str(loss.dtype),
        "bits": int(loss.reshape(1).view(torch.int32)[0]),
        "loss": float(loss), "seconds": time.perf_counter() - t0,
        "cuda_initialized": torch.cuda.is_initialized(),
        "nodes": len(rt.nodes())}}
rt.shutdown()
print("RESULT " + json.dumps(out), flush=True)
"""


def _client_mode(marker_dir) -> dict:
    """(d): a client server process owns a cluster with the card; a client
    process connects through ``client://`` and runs ``_card_loss``."""
    proc = subprocess.Popen(
        [sys.executable, "-c", _CLIENT_SERVER.format(root=str(ROOT))],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        port, lines = None, []
        deadline = time.time() + CLIENT_TIMEOUT
        while time.time() < deadline:
            line = proc.stdout.readline()
            lines.append(line)
            if line.startswith("READY"):
                port = int(line.split()[1])
                break
            if proc.poll() is not None:
                break
        if port is None:
            raise AssertionError(f"(d) the client server did not start: "
                                 f"{''.join(lines)[-3000:]}")
        out = subprocess.run(
            [sys.executable, "-c", _CLIENT.format(
                root=str(ROOT), port=port, marker=str(marker_dir),
                timeout=CLIENT_TIMEOUT)],
            capture_output=True, text=True, timeout=CLIENT_TIMEOUT)
        res = [ln for ln in out.stdout.splitlines()
               if ln.startswith("RESULT ")]
        if out.returncode != 0 or not res:
            raise AssertionError(f"(d) the client failed: "
                                 f"{out.stdout[-2000:]} {out.stderr[-3000:]}")
        return json.loads(res[0][len("RESULT "):])
    finally:
        proc.terminate()
        try:
            proc.wait(timeout=60)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait(timeout=30)


def _store_pins(core) -> int:
    stats = core._run(core.clients.get(core.supervisor_addr).call(
        "store_stats"))
    return stats["pins_total"]


def dag_phase(torch, tune_ref) -> dict:
    """Phase 16: the DAG API on the card. (a) a dynamic DAG, a CPU task
    then a card actor's train step; (b) the same chain compiled onto
    channels; (c) a workflow with a card step, run and resumed; (d) the
    card step from a client process through ``client://``."""
    import gc
    import shutil

    import ray_tpu_torch as rt
    from ray_tpu_torch import workflow
    from ray_tpu_torch._private import api
    from ray_tpu_torch._private.core_worker import _m_pins
    from ray_tpu_torch._private.rpc import _m_client_calls
    from ray_tpu_torch.dag import InputNode

    r = {}
    work = ROOT / "build" / "dag"
    shutil.rmtree(work, ignore_errors=True)
    (work / "markers").mkdir(parents=True)
    texts = [_dag_text(i) for i in range(DAG_WARM + DAG_TIMED)]
    rt.init(num_gpus=1)
    try:
        prep_fn = rt.remote(_dag_prep)
        learner_cls = rt.remote(DagLearner).options(num_gpus=1)
        # ---- (a) dynamic: prep task -> Learner.step
        learner = learner_cls.remote()
        with InputNode() as inp:
            dag = learner.step.bind(prep_fn.bind(inp))
        dyn, dyn_ms = [], []
        for i in range(DAG_DYNAMIC):
            t0 = time.perf_counter()
            dyn.append(rt.get(dag.execute(texts[i]), timeout=RT_TIMEOUT))
            dyn_ms.append((time.perf_counter() - t0) * 1e3)
        rt.kill(learner)
        want = {k: 12 * DAG_DYNAMIC for k in
                ("flash_forward", "flash_dq", "flash_dkv")}
        if dyn[-1]["launches"] != want or dyn[-1]["visible"] != "0" or \
                dyn[-1]["device"] != "cuda:0":
            raise AssertionError(f"(a) the card actor: {dyn[-1]}")
        r["dynamic"] = dict(losses=[x["loss"] for x in dyn],
                            execute_ms=dyn_ms,
                            step_ms=[x["step_ms"] for x in dyn],
                            launches=dyn[-1]["launches"])
        print(f"dag (a): prep.bind(InputNode()) -> Learner.step (num_gpus=1"
              f", gpt2_small 12 layers, B{TUNE_B} x S{TUNE_S} byte tokens)"
              f": {DAG_DYNAMIC} executes, "
              f"{[round(x, 1) for x in dyn_ms]} ms each (the actor's step "
              f"{[round(x['step_ms'], 1) for x in dyn]} ms); losses "
              f"{[round(x['loss'], 5) for x in dyn]}; flash launches "
              f"{dyn[-1]['launches']}", flush=True)
        # ---- (b) compiled: a CPU actor's prep -> a fresh Learner
        core = api._core
        gc.collect()
        time.sleep(0.5)
        pins0, gauge0 = _store_pins(core), _m_pins.value()
        prep = rt.remote(DagPrep).remote()
        learner = learner_cls.remote()
        with InputNode() as inp:
            dag = learner.step.bind(prep.prep.bind(inp))
        t0 = time.perf_counter()
        compiled = dag.experimental_compile()
        compile_s = time.perf_counter() - t0
        if not compiled.is_channel_backed:
            raise AssertionError("(b) the chain did not compile onto "
                                 "channels")
        try:
            comp, comp_ms = [], []
            for i in range(DAG_WARM):
                comp.append(rt.get(compiled.execute(texts[i]),
                                   timeout=RT_TIMEOUT))
            gc.collect()
            time.sleep(0.5)
            rpc0 = _m_client_calls.total()
            for i in range(DAG_WARM, DAG_WARM + DAG_TIMED):
                t0 = time.perf_counter()
                comp.append(rt.get(compiled.execute(texts[i]),
                                   timeout=RT_TIMEOUT))
                comp_ms.append((time.perf_counter() - t0) * 1e3)
            rpcs = int(_m_client_calls.total() - rpc0)
            pins_live = _store_pins(core)
        finally:
            compiled.teardown()
        deadline = time.monotonic() + 15
        while time.monotonic() < deadline and (
                _store_pins(core) != pins0 or _m_pins.value() != gauge0):
            time.sleep(0.2)
        pins_after, gauge_after = _store_pins(core), _m_pins.value()
        rt.kill(learner)
        rt.kill(prep)
        n = DAG_WARM + DAG_TIMED
        want = {k: 12 * n for k in ("flash_forward", "flash_dq",
                                    "flash_dkv")}
        losses = [x["loss"] for x in comp]
        rel = max(abs(a["loss"] - b["loss"]) / abs(b["loss"])
                  for a, b in zip(comp, dyn))
        equal = sum(a["loss"] == b["loss"] for a, b in zip(comp, dyn))
        if comp[-1]["launches"] != want or comp[-1]["visible"] != "0" or \
                comp[-1]["device"] != "cuda:0":
            raise AssertionError(f"(b) the card actor: {comp[-1]}")
        if not rel <= TRAIN_PARITY_RTOL or \
                not all(math.isfinite(x) for x in losses):
            raise AssertionError(f"(b) compiled losses {losses} against "
                                 f"the dynamic DAG's {r['dynamic']}")
        if rpcs != 0:
            raise AssertionError(f"(b) {rpcs} control RPCs over "
                                 f"{DAG_TIMED} compiled executes")
        if not pins_live > pins0 or pins_after != pins0 or \
                gauge_after != gauge0:
            raise AssertionError(f"(b) channel pins {pins0} -> "
                                 f"{pins_live} -> {pins_after}, gauge "
                                 f"{gauge0} -> {gauge_after}")
        step_ms = [x["step_ms"] for x in comp[DAG_WARM:]]
        r["compiled"] = dict(
            losses=losses, execute_ms=comp_ms, step_ms=step_ms,
            compile_s=compile_s, launches=comp[-1]["launches"],
            control_rpcs=rpcs, max_rel_vs_dynamic=rel, bit_equal=equal,
            pins=[pins0, pins_live, pins_after],
            in_process_step_ms=tune_ref["asha"]["in_process_step_ms"])
        med = sorted(comp_ms)[len(comp_ms) // 2]
        print(f"dag (b): the same chain compiled (prep a CPU actor's "
              f"method, a fresh Learner): compile {compile_s:.2f} s; "
              f"{DAG_WARM} warm + {DAG_TIMED} timed executes, median "
              f"{med:.1f} ms ({min(comp_ms):.1f}-{max(comp_ms):.1f}), the "
              f"actor's step {sorted(step_ms)[len(step_ms) // 2]:.1f} ms, "
              f"against the dynamic DAG's "
              f"{[round(x, 1) for x in dyn_ms]} ms and the in-process step"
              f" {[round(x, 1) for x in tune_ref['asha']['in_process_step_ms']]}"
              f" ms (phase 15); {rpcs} control RPCs over the timed "
              f"executes; losses against the dynamic DAG's within "
              f"{rel:.2e} ({equal} of {len(dyn)} bit-equal); flash "
              f"launches {comp[-1]['launches']} = 12 x {n}; channel pins "
              f"{pins0} -> {pins_live} -> {pins_after} after teardown",
              flush=True)
        # ---- (c) a workflow with a card step; its last step fails on
        # the first run, so the resume loads the card step's checkpoint
        markers = work / "markers"
        flag = work / "summary_may_run"
        loss_fn_node = rt.remote(_card_loss).options(num_gpus=1)
        with InputNode() as inp:
            wf = rt.remote(_wf_summary).bind(
                loss_fn_node.bind(prep_fn.bind(inp), str(markers)),
                str(flag))
        t0 = time.perf_counter()
        try:
            first = workflow.run(wf, texts[0], workflow_id="card",
                                 storage=str(work / "wf"))
        except Exception as e:  # noqa: BLE001 - the failure is the gate
            first = e
        run_s = time.perf_counter() - t0
        if not isinstance(first, Exception) or \
                "first run" not in str(first):
            raise AssertionError(f"(c) the first run did not fail in its "
                                 f"summary step: {first!r}")
        flag.touch()
        t0 = time.perf_counter()
        out = workflow.resume("card", storage=str(work / "wf"))
        resume_s = time.perf_counter() - t0
        again = workflow.resume("card", storage=str(work / "wf"))
        n_markers = len(list(markers.iterdir()))
        loss = out["loss"]
        if not (torch.is_tensor(loss) and loss.device.type == "cpu"
                and math.isfinite(float(loss))):
            raise AssertionError(f"(c) workflow result {out}")
        if _bits(torch, again["loss"]) != _bits(torch, loss) or \
                again["bits_per_token"] != out["bits_per_token"]:
            raise AssertionError(f"(c) resumed {again} != {out}")
        if n_markers != 1:
            raise AssertionError(f"(c) the card step ran {n_markers} times")
        r["workflow"] = dict(loss=float(loss), run_s=run_s,
                             resume_s=resume_s, card_runs=n_markers)
        print(f"dag (c): workflow.run of prep -> the card's loss "
              f"(num_gpus=1, gpt2_small 12 layers) -> summary: the summary "
              f"failed as planned after {run_s:.2f} s; workflow.resume "
              f"took the card step's loss from its checkpoint: loss "
              f"{float(loss):.6f} in {resume_s:.2f} s, a second resume the "
              f"same bit for bit, the card step run once", flush=True)
    finally:
        rt.shutdown()
    # ---- (d) client mode
    try:
        d = _client_mode(work / "markers")
        if d["bits"] != _bits(torch, loss):
            raise AssertionError(f"(d) the client's loss {d['loss']} != "
                                 f"(c)'s {float(loss)}")
        if (d["type"], d["device"], d["dtype"]) != ("Tensor", "cpu",
                                                    "torch.float32"):
            raise AssertionError(f"(d) the result: {d}")
        if d["cuda_initialized"] or not d["client"]:
            raise AssertionError(f"(d) the client process: {d}")
        r["client"] = d
        print(f"dag (d): a client process through client:// (CUDA not "
              f"initialized there) ran the card step on the server's "
              f"cluster: loss {d['loss']:.6f}, a CPU float32 tensor equal "
              f"to (c)'s bit for bit, {d['seconds']:.2f} s", flush=True)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return r


# ------------------------------------------------------------- autoscale

AUTOSCALE_BATCHES = 16     # per pass: pool.map, then pool.map_unordered
AUTOSCALE_TICK_S = 1.0     # the autoscalers' update interval
AUTOSCALE_IDLE_S = 5.0     # idle seconds before a launched node is retired
AUTOSCALE_TIMEOUT = 300.0  # a node, an actor or a job that never comes fails
JOB_BATCH = 0              # the batch the job's task scores


def _autoscale_node_types():
    """Phase 17's node types: a CPU host, and a GPU host over the one card
    listed twice (so the pool's two scorers can share it)."""
    from ray_tpu_torch.autoscaler import NodeType

    return [NodeType("cpu", {"CPU": 2}),
            NodeType("gpu", {"CPU": 2, "GPU": 2}, max_workers=1,
                     node_config={"gpu_ids": ["0", "0"]})]


def _score_tokens(i: int):
    """Batch i: TUNE_B x TUNE_S token ids from numpy, seed 1000 + i."""
    import numpy as np

    return np.random.default_rng(1000 + i).integers(
        0, 50257, (TUNE_B, TUNE_S), dtype=np.int64)


def _score_model():
    """gpt2_small at full width and depth (12 layers, d 768, 12 heads,
    vocab 50257, bf16 compute), CE chunk 8192; the weights drawn from a
    seed-0 ``torch.Generator`` on the CPU, then moved to the card, so
    every process holds the same bits."""
    from ray_tpu_torch import presets
    from ray_tpu_torch._private.device import resolve_device
    from ray_tpu_torch.models.transformer import init_params, map_params

    resolve_device("cuda")
    cfg = presets.gpt2_small(remat=False, ce_chunk=8192)
    host = init_params(cfg, 0, "cpu", param_dtype=cfg.param_dtype)
    return cfg, map_params(lambda _p, t: t.to("cuda"), host)


def _params_device(params) -> str:
    from ray_tpu_torch.models.transformer import _leaves

    return str(_leaves(params)[0].device)


def _score(torch, cfg, params, i: int) -> tuple:
    """Batch i's forward loss under no_grad on the card: (loss, ms)."""
    from ray_tpu_torch.models.transformer import loss_fn

    t0 = time.perf_counter()
    tokens = torch.from_numpy(_score_tokens(i)).to("cuda")
    with torch.no_grad():
        _, m = loss_fn(cfg, params, {"tokens": tokens})
    loss = float(m["loss"])  # waits for the card
    return loss, (time.perf_counter() - t0) * 1e3


class Scorer:
    """Phase 17 (a)'s pool member, a ``num_gpus=1`` actor: gpt2_small's
    forward loss of a batch; each call puts ``(batch, pid, ms)`` on the
    queue and adds one to the ``batches_scored`` counter. The flash launch
    counters of its process go to 0 when it is built."""

    def __init__(self, queue):
        import torch

        from ray_tpu_torch.ops import flash_attention as fa
        from ray_tpu_torch.util.metrics import Counter

        self.torch, self.fa, self.queue = torch, fa, queue
        self.cfg, self.params = _score_model()
        self.scored = Counter("batches_scored",
                              "gpt2_small batches scored by the pool")
        _reset_counters(fa)

    def score(self, i):
        import os

        loss, ms = _score(self.torch, self.cfg, self.params, i)
        self.queue.put((i, os.getpid(), ms))
        self.scored.inc()
        return {"batch": i, "loss": loss, "ms": ms, "pid": os.getpid()}

    def info(self):
        import os

        import ray_tpu_torch as rt

        return {"pid": os.getpid(),
                "node": rt.get_runtime_context().get_node_id(),
                "visible": os.environ.get("CUDA_VISIBLE_DEVICES"),
                "device": _params_device(self.params),
                "launches": {f.__name__: f.launches
                             for f in self.fa.KERNELS}}


def _job_score(i: int) -> dict:
    """The job's card task: batch i's loss, with this task's flash
    launches (the counters go to 0 first)."""
    import os

    import torch

    from ray_tpu_torch.ops import flash_attention as fa

    t0 = time.perf_counter()
    cfg, params = _score_model()
    setup_s = time.perf_counter() - t0
    _reset_counters(fa)
    loss, ms = _score(torch, cfg, params, i)
    return {"batch": i, "loss": loss, "ms": ms, "setup_s": setup_s,
            "pid": os.getpid(),
            "visible": os.environ.get("CUDA_VISIBLE_DEVICES"),
            "device": _params_device(params),
            "launches": {f.__name__: f.launches for f in fa.KERNELS}}


_JOB = """
import json, sys
sys.path.insert(0, {root!r})
import cloudpickle
import chip_smoke as c
import ray_tpu_torch as rt

cloudpickle.register_pickle_by_value(c)
rt.init(address="auto")  # the cluster this job was submitted to
out = rt.get(rt.remote(c._job_score).options(num_gpus=1).remote({batch}),
             timeout={timeout})
rt.shutdown()
print("SCORE " + json.dumps(out), flush=True)
"""


def _wait(what: str, cond, timeout: float = AUTOSCALE_TIMEOUT,
          every: float = 0.1):
    """Poll ``cond()`` until it returns a true value; fail the run after
    ``timeout`` seconds."""
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        out = cond()
        if out:
            return out
        time.sleep(every)
    raise AssertionError(f"{what} not within {timeout:.0f} s")


def _jobs_cli(address: str, *args, timeout: float = AUTOSCALE_TIMEOUT):
    """``python -m ray_tpu_torch.scripts.jobs`` with these arguments."""
    return subprocess.run(
        [sys.executable, "-m", "ray_tpu_torch.scripts.jobs", args[0],
         "--address", address, *args[1:]],
        capture_output=True, text=True, timeout=timeout, cwd=str(ROOT))


def _gpu_nodes(state):
    return [n for n in state.list_nodes()
            if (n.get("labels") or {}).get("node_type") == "gpu"]


def _autoscale_pool(rt, core, session_dir, state, card, ref) -> dict:
    """(a): v1's ``StandardAutoscaler`` launches the gpu node for the
    pool's two scorers; 16 batches through ``map``, 16 through
    ``map_unordered``; the queue, the metrics, the state API and the
    timeline read; the actors killed and the node retired."""
    from ray_tpu_torch.autoscaler import (AutoscalerConfig,
                                          LocalNodeProvider,
                                          StandardAutoscaler)
    from ray_tpu_torch.util import ActorPool
    from ray_tpu_torch.util.queue import Queue

    provider = LocalNodeProvider(session_dir, core.controller_addr)
    auto = StandardAutoscaler(core.controller_addr, provider,
                              AutoscalerConfig(
                                  node_types=_autoscale_node_types(),
                                  max_workers=2,
                                  update_interval_s=AUTOSCALE_TICK_S,
                                  idle_timeout_s=AUTOSCALE_IDLE_S))
    auto.run_in_thread()
    try:
        queue = Queue()
        scorer = rt.remote(Scorer).options(num_gpus=1)
        t0 = time.perf_counter()
        actors = [scorer.remote(queue) for _ in range(2)]
        (node,) = _wait("autoscale: the gpu node",
                        lambda: _gpu_nodes(state), every=0.05)
        node_s = time.perf_counter() - t0

        def both_alive():
            recs = [a for a in state.list_actors()
                    if a["class_name"] == "Scorer" and a["state"] == "ALIVE"]
            return recs if len(recs) == 2 else None

        alive = _wait("autoscale: both scorers ALIVE", both_alive)
        alive_s = time.perf_counter() - t0
        pool = ActorPool(actors)
        ordered, first_s = [], None
        for res in pool.map(lambda a, i: a.score.remote(i),
                            range(AUTOSCALE_BATCHES)):
            if first_s is None:
                first_s = time.perf_counter() - t0
            ordered.append(res)
        unordered = list(pool.map_unordered(
            lambda a, i: a.score.remote(i),
            range(AUTOSCALE_BATCHES, 2 * AUTOSCALE_BATCHES)))
        infos = rt.get([a.info.remote() for a in actors],
                       timeout=RT_TIMEOUT)
        entries = queue.get_nowait_batch(4 * AUTOSCALE_BATCHES)
        metrics = state.cluster_metrics(all_nodes=True)
        summary = state.summarize_tasks()
        trace_path = ROOT / "chiprun_out" / "autoscale_timeline.json"
        trace_path.parent.mkdir(exist_ok=True)
        trace = state.timeline(str(trace_path))
        launched = provider.non_terminated_nodes()
        registered = [n for n in state.list_nodes()
                      if (n.get("labels") or {}).get("provider_id")]
        # ---- kill the scorers; the idle node must be retired
        t_kill = time.perf_counter()
        for a in actors:
            rt.kill(a)
        bound_s = AUTOSCALE_IDLE_S + 3 * AUTOSCALE_TICK_S + 10.0
        _wait("autoscale: the gpu node's retirement",
              lambda: not provider.non_terminated_nodes() and not any(
                  n["alive"] for n in _gpu_nodes(state)),
              timeout=bound_s)
        down_s = time.perf_counter() - t_kill
        queue.shutdown()
    finally:
        auto.stop()
        provider.shutdown()
    # ---- gates
    pids = {x["pid"] for x in infos}
    if [n["node_type"] for n in launched] != ["gpu"] or \
            len(registered) != 1:
        raise AssertionError(f"(a) launched {launched}, registered "
                             f"{[n['labels'] for n in registered]}: not "
                             f"exactly one gpu node")
    labels = node["labels"]
    if labels.get("provider_id") != launched[0]["id"] or \
            node["total"].get("GPU") != 2.0:
        raise AssertionError(f"(a) the gpu node in list_nodes: {node}")
    if any(a["node_id_hex"] != node["node_id_hex"] for a in alive) or \
            any(x["node"] != node["node_id_hex"] for x in infos):
        raise AssertionError(f"(a) the scorers are not on the gpu node: "
                             f"{[a['node_id_hex'] for a in alive]}")
    if any((x["visible"], x["device"]) != ("0", "cuda:0") for x in infos) \
            or len(pids) != 2:
        raise AssertionError(f"(a) the scorers' processes: {infos}")
    if [r["batch"] for r in ordered] != list(range(AUTOSCALE_BATCHES)):
        raise AssertionError(f"(a) map's order "
                             f"{[r['batch'] for r in ordered]}")
    if sorted(r["batch"] for r in unordered) != list(
            range(AUTOSCALE_BATCHES, 2 * AUTOSCALE_BATCHES)):
        raise AssertionError(f"(a) map_unordered returned "
                             f"{[r['batch'] for r in unordered]}")
    results = ordered + unordered
    rel = max(abs(r["loss"] - ref["losses"][r["batch"]])
              / abs(ref["losses"][r["batch"]]) for r in results)
    equal = sum(r["loss"] == ref["losses"][r["batch"]] for r in results)
    if not rel <= TRAIN_PARITY_RTOL or \
            not all(math.isfinite(r["loss"]) for r in results):
        raise AssertionError(f"(a) losses {[r['loss'] for r in results]} "
                             f"against in-process {ref['losses']}")
    if len(entries) != 2 * AUTOSCALE_BATCHES or \
            {p for _, p, _ in entries} != pids:
        raise AssertionError(f"(a) the queue gave {len(entries)} entries "
                             f"from pids {sorted({p for _, p, _ in entries})}")
    scored = sum(float(ln.rsplit(" ", 1)[1]) for ln in metrics.splitlines()
                 if ln.startswith("batches_scored{"))
    if scored != 2 * AUTOSCALE_BATCHES:
        raise AssertionError(f"(a) batches_scored sums to {scored}")
    finished = summary.get("score", {}).get("FINISHED", 0)
    if finished < 2 * AUTOSCALE_BATCHES:
        raise AssertionError(f"(a) summarize_tasks: {summary.get('score')}")
    traced = {e["args"].get("worker_pid") for e in trace
              if e["name"] == "score:run"}
    if not pids <= traced or json.loads(trace_path.read_text()) != trace:
        raise AssertionError(f"(a) the timeline's score spans name pids "
                             f"{traced}, not both of {pids}")
    launches = {k: sum(x["launches"][k] for x in infos)
                for k in infos[0]["launches"]}
    want = {"flash_forward": 12 * 2 * AUTOSCALE_BATCHES, "flash_dq": 0,
            "flash_dkv": 0}
    if launches != want:
        raise AssertionError(f"(a) flash launches over the scorers "
                             f"{launches}, expected {want}")
    ms = sorted(r["ms"] for r in results)
    r = dict(node_s=node_s, alive_s=alive_s, first_batch_s=first_s,
             scale_down_s=down_s, scale_down_bound_s=bound_s,
             batch_ms_median=ms[len(ms) // 2], batch_ms=[x["ms"] for x in
                                                       results],
             max_rel_vs_in_process=rel, bit_equal=equal,
             launches=launches, per_actor=infos, queue_entries=len(entries),
             batches_scored=scored, finished_calls=finished,
             timeline_events=len(trace), node=node["node_id_hex"])
    print(f"autoscale (a) [{card}]: StandardAutoscaler over "
          f"LocalNodeProvider (tick {AUTOSCALE_TICK_S} s, idle "
          f"{AUTOSCALE_IDLE_S} s), a head with no GPU: two num_gpus=1 "
          f"scorers -> one gpu node (card 0 listed twice, GPU 2) registered"
          f" {node_s:.2f} s after the demand, both scorers ALIVE there at "
          f"{alive_s:.2f} s, the first batch scored at {first_s:.2f} s; "
          f"{2 * AUTOSCALE_BATCHES} batches (gpt2_small 12 layers, "
          f"B{TUNE_B} x S{TUNE_S}) through map (in order) and map_unordered"
          f": median {r['batch_ms_median']:.1f} ms a batch in the actors "
          f"({ms[0]:.1f}-{ms[-1]:.1f}), {ref['ms_median']:.1f} in process; "
          f"losses within {rel:.2e} of the in-process ones ({equal} of "
          f"{len(results)} bit-equal); queue {len(entries)} entries from "
          f"pids {sorted(pids)}; batches_scored {scored:.0f} over the "
          f"cluster scrape; {finished} score calls FINISHED; timeline "
          f"{len(trace)} events with both pids; flash launches {launches};"
          f" the node retired {down_s:.2f} s after the kill (bound "
          f"{bound_s:.0f} s)", flush=True)
    return r


def _autoscale_job(core, session_dir, address, card, ref, work) -> dict:
    """(b): v2's ``Reconciler`` over a fresh ``LocalNodeProvider``, its
    ``reconcile`` driven every tick from a thread here; a job submitted
    through the CLI with ``--follow`` runs one card task, which makes the
    reconciler launch the gpu node; status, list and logs through the
    CLI; the instance's history; a failing job."""
    from ray_tpu_torch.autoscaler import AutoscalerConfig, LocalNodeProvider
    from ray_tpu_torch.autoscaler.autoscaler import fetch_autoscaler_state
    from ray_tpu_torch.autoscaler.v2 import Reconciler

    job_file = work / "score_job.py"
    job_file.write_text(_JOB.format(root=str(ROOT), batch=JOB_BATCH,
                                    timeout=AUTOSCALE_TIMEOUT))
    provider = LocalNodeProvider(session_dir, core.controller_addr)
    rec = Reconciler(AutoscalerConfig(node_types=_autoscale_node_types(),
                                      max_workers=2,
                                      update_interval_s=AUTOSCALE_TICK_S),
                     provider, idle_timeout_s=AUTOSCALE_IDLE_S)
    stop, failed = threading.Event(), []

    def loop():  # rec.im is read only once this thread has ended
        while not stop.wait(AUTOSCALE_TICK_S):
            try:
                rec.reconcile(fetch_autoscaler_state(core.controller_addr))
            except Exception as e:  # noqa: BLE001 — raised after the join
                failed.append(e)
                return

    thread = threading.Thread(target=loop, name="autoscaler-v2", daemon=True)
    thread.start()
    try:
        t0 = time.perf_counter()
        sub = _jobs_cli(address, "submit", "--follow", "--submission-id",
                        "score-gpt2", "--", sys.executable, str(job_file))
        job_s = time.perf_counter() - t0
        if sub.returncode != 0:
            raise AssertionError(f"(b) the job: rc {sub.returncode}\n"
                                 f"{sub.stdout[-3000:]}\n{sub.stderr[-3000:]}")
        st = json.loads(_jobs_cli(address, "status", "score-gpt2").stdout)
        listed = {j["job_id"]: j["status"] for j in json.loads(
            _jobs_cli(address, "list").stdout)}
        logs = _jobs_cli(address, "logs", "score-gpt2").stdout
        t_done = time.perf_counter()
        # the pass that terminates the node marks its instance TERMINATED
        _wait("autoscale: the gpu instance's retirement",
              lambda: failed or not provider.non_terminated_nodes(),
              timeout=AUTOSCALE_IDLE_S + 3 * AUTOSCALE_TICK_S + 30.0)
        down_s = time.perf_counter() - t_done
        bad = _jobs_cli(address, "submit", "--follow", "--submission-id",
                        "exits-1", "--",
                        f"{sys.executable} -c 'import sys; sys.exit(1)'")
        bad_st = json.loads(_jobs_cli(address, "status", "exits-1").stdout)
    finally:
        stop.set()
        thread.join(60.0)
        provider.shutdown()
    if failed or thread.is_alive():
        raise AssertionError(f"(b) the reconcile loop: {failed or 'hung'}")
    lines = [ln for ln in logs.splitlines() if ln.startswith("SCORE ")]
    if st["status"] != "SUCCEEDED" or listed.get("score-gpt2") != \
            "SUCCEEDED" or len(lines) != 1:
        raise AssertionError(f"(b) status {st['status']}, list {listed}, "
                             f"logs {logs[-2000:]}")
    out = json.loads(lines[0][len("SCORE "):])
    want_loss = ref["losses"][JOB_BATCH]
    rel = abs(out["loss"] - want_loss) / abs(want_loss)
    if not rel <= TRAIN_PARITY_RTOL:
        raise AssertionError(f"(b) the job's loss {out['loss']} against "
                             f"in-process {want_loss}")
    if out["launches"] != {"flash_forward": 12, "flash_dq": 0,
                           "flash_dkv": 0} or \
            (out["visible"], out["device"]) != ("0", "cuda:0"):
        raise AssertionError(f"(b) the job's task: {out}")
    insts = list(rec.im.instances.values())
    walk = [s for _, s, _ in insts[0].history] if len(insts) == 1 else None
    if walk != ["QUEUED", "REQUESTED", "ALLOCATED", "RAY_RUNNING",
                "TERMINATING", "TERMINATED"] or insts[0].node_type != "gpu":
        raise AssertionError(f"(b) the instances: "
                             f"{[(i.node_type, i.history) for i in insts]}")
    if bad.returncode != 1 or bad_st["status"] != "FAILED" or \
            bad_st.get("exit_code") != 1:
        raise AssertionError(f"(b) the failing job: rc {bad.returncode}, "
                             f"{bad_st}")
    hist = insts[0].history
    t_q = hist[0][0]
    r = dict(job_s=job_s, loss=out["loss"], rel_vs_in_process=rel,
             bit_equal=out["loss"] == want_loss, task=out,
             history=[(s, round(t - t_q, 3), why) for t, s, why in hist],
             scale_down_s=down_s, failing_job=bad_st)
    print(f"autoscale (b) [{card}]: v2 Reconciler loop; `python -m "
          f"ray_tpu_torch.scripts.jobs submit --follow` -> SUCCEEDED in "
          f"{job_s:.2f} s (status and list agree); its num_gpus=1 task "
          f"(CUDA_VISIBLE_DEVICES={out['visible']}, {out['device']}, "
          f"model {out['setup_s']:.2f} s, the batch {out['ms']:.1f} ms) "
          f"loss {out['loss']:.6f}, within {rel:.2e} of in-process, flash "
          f"launches {out['launches']}; the gpu instance "
          + " -> ".join(f"{s} (+{t:.2f} s)" for s, t, _ in r["history"])
          + f", retired {down_s:.2f} s after the job; a job exiting 1 "
          f"ends {bad_st['status']} (CLI rc {bad.returncode})", flush=True)
    return r


def autoscale_phase(torch, card) -> dict:
    """Phase 17: a head node with no GPU; the autoscalers launch the
    card's node. (a) v1 with the pool, the queue, metrics and the state
    API; (b) v2 with a job submitted through the CLI."""
    import shutil

    import ray_tpu_torch as rt
    from ray_tpu_torch._private import api
    from ray_tpu_torch.util import state

    # the in-process references: every batch's loss on the card here
    cfg, params = _score_model()
    _score(torch, cfg, params, 0)  # warm-up
    losses, ms = {}, []
    for i in range(2 * AUTOSCALE_BATCHES):
        losses[i], t = _score(torch, cfg, params, i)
        ms.append(t)
    del params
    _free(torch)
    ms.sort()
    ref = {"losses": losses, "ms_median": ms[len(ms) // 2]}
    work = ROOT / "build" / "autoscale"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    info = rt.init(num_gpus=0)
    try:
        core = api._require_core()
        pool = _autoscale_pool(rt, core, info["session_dir"], state, card,
                               ref)
        job = _autoscale_job(core, info["session_dir"], info["address"],
                             card, ref, work)
    finally:
        rt.shutdown()
        shutil.rmtree(work, ignore_errors=True)
    return {"pool": pool, "job": job, "in_process_ms_median":
            ref["ms_median"]}


# ------------------------------------------------------------------ data

DATA_B, DATA_S = 8, 1024
DATA_STEPS = 24            # (a) steps of each arm in its stall window
DATA_EPOCHS = 2            # (a) epochs each executor is built with
INGEST_BATCHES = 6         # (b) batches through TorchTrainer's shard
DEVICE_ROWS, DEVICE_SHAPE, DEVICE_BATCH = 64, (1024, 1024), 8  # (c)
DATA_STORE = 4 * 2 ** 30   # the phase's object store


def _feed_tokens_batch(vocab: int, seq: int, delay_s: float, b):
    """The streaming feed's transform (bench.py's): ids -> a [rows, seq]
    int32 token block, with an optional per-block sleep that makes the
    loader the bottleneck (the input-bound regime)."""
    import numpy as np

    if delay_s:
        time.sleep(delay_s)
    ids = np.asarray(b["id"])
    rng = np.random.default_rng(1234 + int(ids[0]))
    return {"tokens": rng.integers(
        0, vocab, (len(ids), seq)).astype(np.int32)}


def _data_model(torch):
    """Phase 18's model: gpt2_small at full size (12 layers, d 768, 12
    heads, vocab 50257, bf16 compute), ``remat=False``, CE chunk 8192,
    params from seed 0 on the card, AdamW with no warmup."""
    from ray_tpu_torch import presets
    from ray_tpu_torch.models.training import (OptimizerConfig,
                                               init_train_state,
                                               make_train_step)

    cfg = presets.gpt2_small(remat=False, ce_chunk=8192)
    state, tx = init_train_state(
        cfg, OptimizerConfig(warmup_steps=0, decay_steps=1000), seed=0,
        device="cuda")
    return cfg, state, make_train_step(cfg, tx)


def _data_calibrate(torch, state, step, vocab):
    """bench.py's calibration: one step, then 3 timed on seed-0 tokens
    (the bare step, which sizes the input-bound block delay)."""
    import numpy as np

    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, vocab, (DATA_B, DATA_S)).astype(np.int32)).to("cuda")
    state, m = step(state, {"tokens": tokens})
    float(m["loss"])
    t0 = time.perf_counter()
    for _ in range(3):
        state, m = step(state, {"tokens": tokens})
    float(m["loss"])
    return state, (time.perf_counter() - t0) / 3


def _feed_arm(torch, ex, box, step, full: bool) -> dict:
    """Drive the train step through ``ex.feed``: each read-only arena view
    is copied out (the host copy the gate compares) and to the card inside
    the step, which ends in ``float(loss)``, so the slot is acked only
    after the step really ran. The stall window is bench.py's: from the
    end of the first step to the end of step ``DATA_STEPS``; ``full``
    goes on through every epoch (the warm epochs' stats)."""
    import numpy as np

    stall, last_end, seen, losses = [0.0], [None], [], []

    def train_step(b):
        now = time.perf_counter()
        if last_end[0] is not None:
            stall[0] += now - last_end[0]
        host = np.array(b["tokens"])
        box[0], m = step(box[0], {"tokens": torch.from_numpy(host)
                                  .to("cuda")})
        losses.append(float(m["loss"]))
        seen.append(host)
        last_end[0] = time.perf_counter()

    t_first = window = None
    try:
        for _ in ex.feed(train_step):
            if t_first is None:
                t_first, stall[0] = last_end[0], 0.0
            if len(seen) == DATA_STEPS:
                total = max(last_end[0] - t_first, 1e-9)
                window = {"stall_fraction": stall[0] / total,
                          "steps_per_s": (DATA_STEPS - 1) / total}
                if not full:
                    break
        stats = ex.epoch_stats
    finally:
        t0 = time.perf_counter()
        ex.shutdown()
        shutdown_s = time.perf_counter() - t0
    warm = [{"epoch": e["epoch"],
             "consumer_rpc_calls": e["consumer_rpc_calls"],
             "stage_rpc_calls": [s.get("rpc_calls")
                                 for s in e["stage_reports"]]}
            for e in stats[1:]]
    return dict(window, steps=len(seen), batches=seen, losses=losses,
                warm_epochs=warm, shutdown_s=shutdown_s)


def _ingest_loop(config):
    """Phase 18 (b), in ``TorchTrainer``'s worker: the rank's dataset
    shard through ``iter_device_batches(batch_size=8, prefetch=2)``, one
    train step and one ``train.report`` per batch. Each report carries
    the batch's device, dtype and shape, each row's first 4 tokens, the
    step's loss and ms, and this process's flash launches (the counters
    go to 0 before the first step)."""
    import os

    import torch

    from ray_tpu_torch import train
    from ray_tpu_torch._private.device import resolve_device
    from ray_tpu_torch.ops import flash_attention as fa

    resolve_device("cuda")
    cfg, state, step = _data_model(torch)
    _reset_counters(fa)
    it = train.get_dataset_shard("train").iter_device_batches(
        batch_size=DATA_B, prefetch=2)
    for batch in it:
        t = batch["tokens"]
        t0 = time.perf_counter()
        state, m = step(state, {"tokens": t})
        loss = float(m["loss"])
        train.report({
            "loss": loss, "step_ms": (time.perf_counter() - t0) * 1e3,
            "device": str(t.device), "dtype": str(t.dtype),
            "shape": list(t.shape), "rows": t[:, :4].cpu().tolist(),
            "launches": {f.__name__: f.launches for f in fa.KERNELS},
            "visible": os.environ.get("CUDA_VISIBLE_DEVICES"),
            "pinned": [b.is_pinned() for ring in it.staging.values()
                       for b in ring if b is not None]})


def _codec_is_native() -> bool:
    from ray_tpu_torch._native import codec

    return codec._get() is not None


def _replay_losses(torch, arms, vocab=None) -> list:
    """The same steps in this process: a fresh seed-0 state (given
    ``vocab``, through the same calibration first), then each arm's
    batches in the order they ran."""
    cfg, state, step = _data_model(torch)
    if vocab is not None:
        state, _ = _data_calibrate(torch, state, step, vocab)
    out = []
    for batches in arms:
        losses = []
        for host in batches:
            state, m = step(state, {"tokens": torch.from_numpy(host)
                                    .to("cuda")})
            losses.append(float(m["loss"]))
        out.append(losses)
    del state, step
    _free(torch)
    return out


def _loss_parity(got, want, what) -> dict:
    rel = max(abs(a - b) / abs(b) for a, b in zip(got, want))
    if len(got) != len(want) or not rel <= TRAIN_PARITY_RTOL or \
            not all(math.isfinite(x) for x in got):
        raise AssertionError(f"{what}: losses {got} against {want} in "
                             f"process (largest relative {rel:.2e})")
    return {"max_rel": rel, "bit_equal": sum(a == b for a, b in
                                             zip(got, want)),
            "steps": len(got)}


def _data_feed(torch, rd, ds_mod, dx) -> dict:
    """(a): the streaming feed and the exchange arm, each compute-bound
    and input-bound, through one train state in this process."""
    import functools

    from ray_tpu_torch.ops import flash_attention as fa

    vocab = 50257
    t0 = time.perf_counter()
    cfg, state, step = _data_model(torch)
    state, step_s = _data_calibrate(torch, state, step, vocab)
    model_s = time.perf_counter() - t0
    box = [state]
    del state

    def loader(delay, shuffle):
        ds = rd.range(DATA_STEPS * DATA_B, parallelism=DATA_STEPS) \
            .map_batches(functools.partial(_feed_tokens_batch, vocab,
                                           DATA_S, delay))
        return ds.random_shuffle(seed=1) if shuffle else ds

    # the task baselines, at the executors' seed (the delay changes no
    # token, so the undelayed loader stands for both regimes)
    stream_ops, ex_ops = loader(0.0, False)._ops, loader(0.0, True)._ops
    t0 = time.perf_counter()
    base_stream, base_ex = [], []
    for epoch in range(1, DATA_EPOCHS + 1):
        base_stream += [b["tokens"] for b in ds_mod.task_epoch_batches(
            stream_ops, batch_size=DATA_B, epoch=epoch, seed=0)]
        base_ex += [b["tokens"] for b in dx.task_exchange_batches(
            ex_ops, batch_size=DATA_B, num_consumers=2, epoch=epoch,
            seed=0, drop_last=True)]
    baseline_s = time.perf_counter() - t0
    _reset_counters(fa)
    arms = {}
    for name, shuffle in (("stream", False), ("exchange", True)):
        for regime, delay in (("compute_bound", 0.0),
                              ("input_bound", 2.0 * step_s)):
            ops = loader(delay, shuffle)._ops
            t1 = time.perf_counter()
            if shuffle:
                ex = dx.ExchangeExecutor(
                    ops, batch_size=DATA_B, epochs=DATA_EPOCHS, seed=0,
                    num_producers=1, num_consumers=2, drop_last=True)
                if not ex.is_channel_backed:
                    ex.shutdown()
                    raise AssertionError("the exchange arm is not "
                                         "channel-backed")
            else:
                ex = ds_mod.StreamingExecutor(
                    ops, batch_size=DATA_B, epochs=DATA_EPOCHS, seed=0,
                    num_readers=1)
            t2 = time.perf_counter()
            arm = _feed_arm(torch, ex, box, step,
                            full=regime == "compute_bound")
            arm.update(build_s=t2 - t1, seconds=time.perf_counter() - t2,
                       block_delay_ms=delay * 1e3)
            base = base_ex if shuffle else base_stream
            bad = [i for i, (a, b) in enumerate(zip(arm["batches"], base))
                   if a.dtype != b.dtype or not (a == b).all()]
            if bad or len(arm["batches"]) > len(base):
                raise AssertionError(f"(a) {name} {regime}: batches "
                                     f"{bad[:5]} differ from the task "
                                     f"baseline")
            arms[(name, regime)] = arm
    steps = sum(a["steps"] for a in arms.values())
    launches = {f.__name__: f.launches for f in fa.KERNELS}
    want = {k: cfg.num_layers * steps for k in launches}
    if launches != want:
        raise AssertionError(f"(a) flash launches {launches}, expected "
                             f"{want} ({cfg.num_layers} x {steps})")
    del box, step
    _free(torch)
    keys = list(arms)
    t0 = time.perf_counter()
    replay = _replay_losses(torch, [arms[k]["batches"] for k in keys],
                            vocab)
    r = {"bare_step_ms": step_s * 1e3, "baseline_s": baseline_s,
         "model_s": model_s, "replay_s": time.perf_counter() - t0,
         "launches": launches, "steps": steps}
    for k, ref in zip(keys, replay):
        arm = arms[k]
        parity = _loss_parity(arm["losses"], ref, f"(a) {k[0]} {k[1]}")
        r[f"{k[0]}_{k[1]}"] = dict(
            {x: arm[x] for x in ("stall_fraction", "steps_per_s", "steps",
                                 "warm_epochs", "build_s", "seconds",
                                 "shutdown_s", "block_delay_ms",
                                 "losses")},
            parity=parity)
    for name in ("stream", "exchange"):
        cb = r[f"{name}_compute_bound"]["stall_fraction"]
        ib = r[f"{name}_input_bound"]["stall_fraction"]
        if not ib > cb:
            raise AssertionError(f"(a) {name}: the input-bound stall "
                                 f"fraction {ib:.3f} is not above the "
                                 f"compute-bound {cb:.3f}")
    r["first_epoch_tokens"] = arms[("stream", "compute_bound")][
        "batches"][:DATA_STEPS]
    return r


def _data_ingest(torch, rd, dp_ref) -> dict:
    """(b): ``TorchTrainer(datasets={"train": ds})`` on the card; the
    worker reads its ``streaming_split(1, equal=True)`` shard through
    ``iter_device_batches``."""
    import functools
    import shutil
    from collections import Counter

    import numpy as np

    from ray_tpu_torch.train import RunConfig, ScalingConfig, TorchTrainer

    vocab, rows = 50257, INGEST_BATCHES * DATA_B
    ds = rd.range(rows, parallelism=INGEST_BATCHES).map_batches(
        functools.partial(_feed_tokens_batch, vocab, DATA_S, 0.0))
    storage = ROOT / "build" / "data_ingest"
    shutil.rmtree(storage, ignore_errors=True)
    t0 = time.perf_counter()
    res = TorchTrainer(
        _ingest_loop,
        scaling_config=ScalingConfig(num_workers=1, use_gpu=True),
        run_config=RunConfig(storage_path=str(storage), name="ingest"),
        datasets={"train": ds}).fit()
    fit_s = time.perf_counter() - t0
    shutil.rmtree(storage, ignore_errors=True)
    if res.error is not None:
        raise AssertionError(f"(b) TorchTrainer: {res.error}")
    hist = res.metrics_history
    # every row of ds, computed here block by block
    full = {}
    for lo in range(0, rows, DATA_B):
        tok = _feed_tokens_batch(vocab, DATA_S, 0.0,
                                 {"id": np.arange(lo, lo + DATA_B)})["tokens"]
        for row in tok:
            full[tuple(int(x) for x in row[:4])] = row
    got = Counter(tuple(row) for m in hist for row in m["rows"])
    if got != Counter(full.keys()) or len(full) != rows:
        raise AssertionError(f"(b) the rows the worker saw are not every "
                             f"row of ds once: {sum(got.values())} rows, "
                             f"{len(set(got))} distinct of {rows}")
    bad = [m for m in hist if m["device"] != "cuda:0" or m["dtype"] !=
           "torch.int32" or m["shape"] != [DATA_B, DATA_S] or
           m["visible"] != "0" or not m["pinned"] or not all(m["pinned"])]
    if len(hist) != INGEST_BATCHES or bad:
        raise AssertionError(f"(b) {len(hist)} reports; off: "
                             f"{[{k: v for k, v in m.items() if k != 'rows'} for m in bad]}")
    want = {k: 12 * INGEST_BATCHES for k in hist[-1]["launches"]}
    if hist[-1]["launches"] != want:
        raise AssertionError(f"(b) flash launches in the worker "
                             f"{hist[-1]['launches']}, expected {want}")
    batches = [np.stack([full[tuple(row)] for row in m["rows"]])
               for m in hist]
    (ref,) = _replay_losses(torch, [batches])
    parity = _loss_parity([m["loss"] for m in hist], ref, "(b)")
    ms = sorted(m["step_ms"] for m in hist[1:])
    return {"fit_s": fit_s, "reports": len(hist),
            "losses": [m["loss"] for m in hist], "parity": parity,
            "step_ms_each": [m["step_ms"] for m in hist],
            "step_ms_median": ms[len(ms) // 2],
            "first_step_ms": hist[0]["step_ms"],
            "launches": hist[-1]["launches"],
            "visible": hist[0]["visible"],
            "dp_train_step_ms": dp_ref["trainer"]["step_ms"]}


def _device_pass(torch, ds, prefetch, device=None) -> dict:
    """(c): one pass of ``range_tensor`` through ``iter_device_batches``;
    each batch held against the rows it must hold (row i all i)."""
    it = ds.iter_device_batches(batch_size=DEVICE_BATCH, prefetch=prefetch,
                                **({} if device is None else
                                   {"device": device}))
    waits, n = [], 0
    t = time.perf_counter()
    for b in it:
        waits.append(time.perf_counter() - t)
        x = b["data"]
        lo = n * DEVICE_BATCH
        want = torch.arange(lo, lo + DEVICE_BATCH, dtype=torch.int64,
                            device=x.device).view(-1, 1, 1).expand(
            DEVICE_BATCH, *DEVICE_SHAPE)
        want_dev = "cpu" if device == "cpu" else "cuda:0"
        if str(x.device) != want_dev or x.dtype != torch.int64 or \
                not torch.equal(x, want):
            raise AssertionError(f"(c) batch {n} (prefetch {prefetch}, "
                                 f"device {device}): {x.device} {x.dtype}"
                                 f" not the rows {lo}..")
        n += 1
        t = time.perf_counter()
    if n != DEVICE_ROWS // DEVICE_BATCH:
        raise AssertionError(f"(c) {n} batches")
    r = {"batches": n, "wait_ms": [w * 1e3 for w in waits]}
    if device != "cpu":
        bufs = [b for ring in it.staging.values() for b in ring
                if b is not None]
        if not bufs or not all(b.is_pinned() for b in bufs):
            raise AssertionError(f"(c) staging buffers not pinned: "
                                 f"{[b.is_pinned() for b in bufs]}")
        copies = it.copy_ms()
        ms = sorted(t for t, _ in copies)
        r.update(staging_buffers=len(bufs),
                 copy_gb_s=sum(nb for _, nb in copies) / sum(ms) / 1e6,
                 copy_gb_s_median=copies[0][1] / ms[len(ms) // 2] / 1e6,
                 copy_ms=[t for t, _ in copies])
    return r


def _pageable_gb_s(torch) -> float:
    """A pageable ``torch.as_tensor(batch).to("cuda")`` of one (c) batch,
    timed with CUDA events (median of 5)."""
    import numpy as np

    arr = np.broadcast_to(np.arange(DEVICE_BATCH, dtype=np.int64).reshape(
        -1, 1, 1), (DEVICE_BATCH, *DEVICE_SHAPE)).copy()
    times = []
    for _ in range(6):
        a, b = torch.cuda.Event(True), torch.cuda.Event(True)
        a.record()
        torch.as_tensor(arr).to("cuda")
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    times = sorted(times[1:])
    return arr.nbytes / times[len(times) // 2] / 1e6


def _data_codec(rd, tokens) -> dict:
    """(d): the native codec loaded here and in a worker; (a)'s first
    epoch written with ``write_tfrecords`` and read back equal."""
    import shutil

    import numpy as np

    import ray_tpu_torch as rt
    from ray_tpu_torch.data.block import batch_to_block

    here = _codec_is_native()
    there = rt.get(rt.remote(_codec_is_native).remote(), timeout=RT_TIMEOUT)
    if not (here and there):
        raise AssertionError(f"(d) the native codec: driver {here}, "
                             f"worker {there} (the Python fallback is in "
                             f"use)")
    tok = np.concatenate(tokens)
    out = ROOT / "build" / "data_tfrecords"
    shutil.rmtree(out, ignore_errors=True)
    t0 = time.perf_counter()
    ds = rd.from_arrow(batch_to_block({"idx": np.arange(len(tok)),
                                       "tokens": tok}))
    files = ds.write_tfrecords(str(out))
    rows = sorted(rd.read_tfrecords(str(out)).take_all(),
                  key=lambda r: r["idx"])
    back = np.array([r["tokens"] for r in rows])
    secs = time.perf_counter() - t0
    size = sum(Path(f).stat().st_size for f in files)
    shutil.rmtree(out, ignore_errors=True)
    if back.shape != tok.shape or not (back == tok).all():
        raise AssertionError(f"(d) TFRecord round trip: {back.shape} "
                             f"against {tok.shape}")
    return {"native": True, "rows": len(tok), "files": len(files),
            "bytes": size, "seconds": secs}


def data_phase(torch, train_ref, dp_ref) -> dict:
    """Phase 18: Data on the card. (a) the streaming feed and the exchange
    arm into gpt2_small's train step here; (b) ``TorchTrainer``'s dataset
    shard through ``iter_device_batches``; (c) the device iterator alone;
    (d) the native codec and TFRecords."""
    import ray_tpu_torch as rt
    from ray_tpu_torch import data as rd
    from ray_tpu_torch.data._internal import exchange as dx
    from ray_tpu_torch.data._internal import streaming as ds_mod

    t_init = time.perf_counter()
    rt.init(object_store_memory=DATA_STORE)
    r = {"init_s": time.perf_counter() - t_init}
    try:
        t0 = time.perf_counter()
        feed = _data_feed(torch, rd, ds_mod, dx)
        tokens = feed.pop("first_epoch_tokens")
        r["feed"] = dict(feed, seconds=time.perf_counter() - t0)
        print("data (a): gpt2_small 12 layers B8 x S1024 fed by "
              "StreamingExecutor.feed (1 reader) and ExchangeExecutor.feed "
              "(random_shuffle(seed=1), 1 x 2, drop_last): bare step "
              f"{feed['bare_step_ms']:.1f} ms (train phase in process, "
              f"B16: {train_ref['gpt2_small']['step_ms']:.1f}); "
              + "; ".join(
                  f"{k}: stall {v['stall_fraction']:.3f}, "
                  f"{v['steps_per_s']:.2f} steps/s, {v['steps']} steps, "
                  f"loss parity {v['parity']['bit_equal']} of "
                  f"{v['parity']['steps']} bit-equal (largest relative "
                  f"{v['parity']['max_rel']:.2e}), warm epochs "
                  f"{v['warm_epochs']}"
                  for k, v in feed.items() if isinstance(v, dict)
                  and "stall_fraction" in v)
              + f"; every batch equals its task baseline; flash launches "
              f"{feed['launches']} = 12 x {feed['steps']}", flush=True)
        t0 = time.perf_counter()
        ingest = _data_ingest(torch, rd, dp_ref)
        r["ingest"] = dict(ingest, seconds=time.perf_counter() - t0)
        print(f"data (b): TorchTrainer(datasets={{'train': ds}}) with "
              f"ScalingConfig(num_workers=1, use_gpu=True): fit "
              f"{ingest['fit_s']:.2f} s, {ingest['reports']} reports, every "
              f"row once on cuda:0 as int32 (CUDA_VISIBLE_DEVICES="
              f"{ingest['visible']}); first step "
              f"{ingest['first_step_ms']:.1f} ms, then median "
              f"{ingest['step_ms_median']:.1f} ms (phase 13 (b), B16: "
              f"{ingest['dp_train_step_ms']:.1f}); loss parity "
              f"{ingest['parity']['bit_equal']} of "
              f"{ingest['parity']['steps']} bit-equal (largest relative "
              f"{ingest['parity']['max_rel']:.2e}); flash launches in the "
              f"worker {ingest['launches']}", flush=True)
        t0 = time.perf_counter()
        tensors = rd.range_tensor(DEVICE_ROWS, shape=DEVICE_SHAPE)
        dev = {p: _device_pass(torch, tensors, p) for p in (2, 0)}
        cpu = _device_pass(torch, tensors, 2, device="cpu")
        pageable = _pageable_gb_s(torch)
        r["device_iter"] = {"prefetch_2": dev[2], "prefetch_0": dev[0],
                            "cpu": cpu, "pageable_gb_s": pageable,
                            "seconds": time.perf_counter() - t0}
        print(f"data (c): range_tensor({DEVICE_ROWS}, shape="
              f"{DEVICE_SHAPE}) int64 through iter_device_batches in "
              f"batches of {DEVICE_BATCH} (64 MiB): every tensor on cuda:0"
              f" equal bit for bit, staging pinned; pinned copy "
              f"{dev[2]['copy_gb_s_median']:.2f} GB/s median, "
              f"{dev[2]['copy_gb_s']:.2f} over all copies (prefetch 2), "
              f"{dev[0]['copy_gb_s_median']:.2f} and "
              f"{dev[0]['copy_gb_s']:.2f} (prefetch 0), against pageable "
              f"{pageable:.2f} GB/s; consumer wait per batch "
              f"median {sorted(dev[2]['wait_ms'])[4]:.1f} ms (prefetch 2)"
              f", {sorted(dev[0]['wait_ms'])[4]:.1f} ms (prefetch 0); "
              f"device='cpu' equal", flush=True)
        r["codec"] = _data_codec(rd, tokens)
        print(f"data (d): the native codec loaded in the driver and a "
              f"worker; {r['codec']['rows']} token rows of (a)'s first "
              f"epoch through write_tfrecords ({r['codec']['bytes']} bytes)"
              f" and read_tfrecords equal", flush=True)
    finally:
        rt.shutdown()
    return r


# ------------------------------------------------------------------ rl

RL_ENVS, RL_ROLLOUT = 32, 16   # bench_rllib.run_anakin's shape
RL_WARM, RL_TIMED = 2, 20      # (a) warm-up and timed Anakin iterations
RL_PROFILED = 3                # (a) iterations under torch.profiler
RL_ROWS, RL_MB, RL_EPOCHS = 512, 256, 2  # (b) bench_rllib.run's PPO batch
RL_IMPALA_B, RL_IMPALA_T = 8, 32         # (b) IMPALA's [B, T] batch
RL_MA_BAR, RL_MA_ITERS = 28.0, 25        # (c) JAX's multi-agent PPO test
# card against CPU from the same float32 params (TF32 off): losses and
# metrics relative, grads and params relative L2 per leaf (cuDNN's conv
# and cuBLAS sum in another order than the CPU's)
RL_LOSS_RTOL = 1e-4
RL_GRAD_RTOL = 1e-3
# the share of the Nature-CNN's ReLU inputs whose sign may differ between
# the card and the CPU (inputs within rounding of 0; the repeats of
# ray_tpu_torch/scripts/anakin_grad_parity.py count them)
RL_FLIP_SHARE = 1e-5
RL_PARAM_RTOL = 1e-4


def _leaf_rel_l2(torch, a, b) -> float:
    """The largest relative L2 distance between matching leaves."""
    from ray_tpu_torch.models.transformer import _leaves

    worst = 0.0
    for x, y in zip(_leaves(a), _leaves(b)):
        x = torch.as_tensor(x).detach().double().cpu()
        y = torch.as_tensor(y).detach().double().cpu()
        worst = max(worst, float((x - y).norm() / y.norm().clamp_min(1e-30)))
    return worst


def _rel(a: float, b: float) -> float:
    return abs(a - b) / max(abs(b), 1e-30)


def _whole_rel_l2(torch, a, b) -> float:
    """The relative L2 distance of all leaves together."""
    x = torch.cat([t.detach().double().cpu().reshape(-1) for t in a])
    y = torch.cat([t.detach().double().cpu().reshape(-1) for t in b])
    return float((x - y).norm() / y.norm().clamp_min(1e-30))


def _anakin_part(torch) -> dict:
    """(a): Anakin at run_anakin's shape on the card."""
    from torch.profiler import ProfilerActivity, profile

    from ray_tpu_torch.models.transformer import _leaves, map_params
    from ray_tpu_torch.rllib import AnakinTrainer
    from ray_tpu_torch.rllib.env import synthetic_atari as sa
    from ray_tpu_torch.scripts.anakin_grad_parity import with_relu

    tr = AnakinTrainer(num_envs=RL_ENVS, rollout=RL_ROLLOUT, seed=0)
    assert str(tr._obs.device) == "cuda:0", tr._obs.device
    warm = tr.train(RL_WARM)
    # one update with every host read an error: the rollout, the env step,
    # V-trace, the grads and Adam issue none
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        tr.update()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    timed = tr.train(RL_TIMED)
    ms = 1e3 * RL_ROLLOUT * RL_ENVS / timed["env_steps_per_sec"]
    # launches and busy share of an iteration, under the profiler
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(RL_PROFILED):
            tr.update()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kern = [e for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.time_range.elapsed_us() for e in kern) / 1e3
    launches = len(kern) / RL_PROFILED
    # one iteration's actions replayed through the CPU mirror
    t0_cpu, obs0_cpu = tr._t.cpu(), tr._obs.cpu()
    traj = tr.collect()
    frames = torch.from_numpy(sa.frame_bank(0))
    t, obs = t0_cpu, obs0_cpu
    cpu = {k: v.cpu() for k, v in traj.items()}
    for i in range(RL_ROLLOUT):
        assert torch.equal(obs, cpu["obs"][i]), f"obs {i}"
        t, o1, r, tc = sa.torch_step(frames, tr.episode_len, t,
                                     cpu["actions"][i])
        assert torch.equal(r, cpu["rewards"][i]), f"rewards {i}"
        assert torch.equal(tc, cpu["truncs"][i]), f"truncs {i}"
        t, obs = sa.torch_reset(frames, t, o1, tc)
    assert torch.equal(obs, cpu["last_obs"])
    # that trajectory's loss and grads on the card and on the CPU, from
    # the same float32 params. A ReLU input within rounding of 0 may take
    # another sign on each device, and its unit's grad then flows on one
    # only: each leaf's grads are held to the CPU's under the CPU's ReLU
    # masks, the signs that differ are counted, and the grads as computed
    # are held to the CPU's all leaves together
    ref = AnakinTrainer(num_envs=RL_ENVS, rollout=RL_ROLLOUT, seed=0,
                        device="cpu")
    ref.params = map_params(
        lambda _p, x: x.detach().cpu().clone().requires_grad_(True),
        tr.params)
    cmasks, gmasks = [], []
    closs, cmet = with_relu(lambda: ref.loss(ref.params, cpu), cmasks)
    cgrads = torch.autograd.grad(closs, _leaves(ref.params))
    loss, met = with_relu(lambda: tr.loss(tr.params, traj), gmasks)
    grads = torch.autograd.grad(loss, _leaves(tr.params))
    mloss, _ = with_relu(lambda: tr.loss(tr.params, traj), masks=cmasks)
    mgrads = torch.autograd.grad(mloss, _leaves(tr.params))
    flips = sum(int((g.cpu() != c).sum()) for g, c in zip(gmasks, cmasks))
    units = sum(c.numel() for c in cmasks)
    loss_rel = _rel(float(loss.detach()), float(closs.detach()))
    met_rel = max(_rel(float(met[k]), float(cmet[k])) for k in met)
    grad_rel = _leaf_rel_l2(torch, list(mgrads), list(cgrads))
    unmasked_rel = _leaf_rel_l2(torch, list(grads), list(cgrads))
    whole_rel = _whole_rel_l2(torch, grads, cgrads)
    assert loss_rel <= RL_LOSS_RTOL and met_rel <= RL_LOSS_RTOL, (
        loss_rel, met_rel)
    assert len(gmasks) == len(cmasks) and flips <= RL_FLIP_SHARE * units, (
        flips, units)
    assert grad_rel <= RL_GRAD_RTOL, grad_rel
    assert whole_rel <= RL_GRAD_RTOL, whole_rel
    for o in (warm, timed):
        assert all(math.isfinite(o[k]) for k in
                   ("total_loss", "policy_loss", "vf_loss", "entropy")), o
    params = sum(p.numel() for p in _leaves(tr.params))
    return {"env_steps_per_sec": timed["env_steps_per_sec"],
            "ms_per_iteration": ms, "launches_per_iteration": launches,
            "profiled_wall_ms": 1e3 * wall / RL_PROFILED,
            "busy_ms_per_iteration": busy_ms / RL_PROFILED,
            "busy_share": busy_ms / (1e3 * wall),
            "losses": [warm["total_loss"], timed["total_loss"]],
            "loss_rel": loss_rel, "metric_rel": met_rel,
            "grad_rel_l2": grad_rel, "params": params,
            "relu_flips": flips, "relu_units": units,
            "grad_rel_l2_unmasked": unmasked_rel,
            "grad_whole_rel_l2": whole_rel,
            "truncations": int(cpu["truncs"].sum()),
            "reward_mean": timed["reward_mean"]}


def _atari_batch(rng, rows):
    """PPO train rows over the synthetic Atari frames (numpy)."""
    import numpy as np

    from ray_tpu_torch.rllib.env import synthetic_atari as sa

    bank = sa.frame_bank(0)
    return {
        "obs": bank[rng.integers(0, len(bank), rows)],
        "actions": rng.integers(0, 6, rows).astype(np.int64),
        "logp": (rng.normal(size=rows) * 0.1 - 1.79).astype(np.float32),
        "values": rng.normal(size=rows).astype(np.float32),
        "advantages": rng.normal(size=rows).astype(np.float32),
        "value_targets": rng.normal(size=rows).astype(np.float32),
    }


def _learner_part(torch) -> dict:
    """(b): the PPO-Atari learner and IMPALA's loss, card against CPU."""
    import numpy as np

    from ray_tpu_torch.models.transformer import _leaves
    from ray_tpu_torch.rllib import IMPALA, PPO, Learner, RLModuleSpec
    from ray_tpu_torch.rllib.env import synthetic_atari as sa

    spec = RLModuleSpec(obs_dim=84 * 84 * 4, num_actions=6,
                        obs_shape=(84, 84, 4))
    cfg = {"clip_param": 0.2, "vf_clip_param": 10.0, "vf_loss_coeff": 0.5,
           "entropy_coeff": 0.0}
    card = Learner(spec, PPO.loss_fn, {"lr": 3e-4}, seed=0)
    cpu = Learner(spec, PPO.loss_fn, {"lr": 3e-4}, seed=0, device="cpu")
    assert card.device_name() == "cuda:0"
    assert _leaf_rel_l2(torch, card.params, cpu.params) == 0.0
    rng = np.random.default_rng(0)
    flat = _atari_batch(rng, RL_ROWS)
    perm_rng = np.random.default_rng(0)
    ms, worst = [], 0.0
    for _ in range(RL_EPOCHS):
        perm = perm_rng.permutation(RL_ROWS)
        for lo in range(0, RL_ROWS - RL_MB + 1, RL_MB):
            idx = perm[lo:lo + RL_MB]
            mb = {k: v[idx] for k, v in flat.items()}
            mb["kl_coeff"] = np.full(RL_MB, 0.2, np.float32)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            got = card.update_from_batch(mb, cfg)  # ends in its metric read
            ms.append(1e3 * (time.perf_counter() - t0))
            want = cpu.update_from_batch(mb, cfg)
            worst = max(worst, max(_rel(got[k], want[k]) for k in want))
            assert all(math.isfinite(v) for v in got.values()), got
    assert worst <= RL_LOSS_RTOL, worst
    param_rel = _leaf_rel_l2(torch, card.params, cpu.params)
    assert param_rel <= RL_PARAM_RTOL, param_rel
    # IMPALA's V-trace loss and grads on a conv [B, T] batch
    B, T = RL_IMPALA_B, RL_IMPALA_T
    bank = sa.frame_bank(0)
    batch = {
        "obs": bank[rng.integers(0, 32, (B, T))],
        "actions": rng.integers(0, 6, (B, T)).astype(np.int64),
        "logp": (rng.normal(size=(B, T)) * 0.1 - 1.79).astype(np.float32),
        "rewards": (rng.random((B, T)) < 0.2).astype(np.float32),
        "terminateds": np.zeros((B, T), bool),
        "truncateds": rng.random((B, T)) < 0.05,
        "bootstrap_obs": bank[rng.integers(0, 32, B)],
    }
    icfg = {"gamma": 0.99, "clip_rho": 1.0, "clip_c": 1.0,
            "vf_loss_coeff": 0.5, "entropy_coeff": 0.01}
    out = {}
    for name, lr in (("card", card), ("cpu", cpu)):
        lr.loss_fn = IMPALA.loss_fn
        loss, met, grads = lr.compute_grads(batch, icfg)
        out[name] = (float(loss), {k: float(v) for k, v in met.items()},
                     grads)
    impala_loss_rel = max([_rel(out["card"][0], out["cpu"][0])] + [
        _rel(out["card"][1][k], out["cpu"][1][k]) for k in out["cpu"][1]])
    impala_grad_rel = _leaf_rel_l2(torch, out["card"][2], out["cpu"][2])
    assert impala_loss_rel <= RL_LOSS_RTOL, impala_loss_rel
    assert impala_grad_rel <= RL_GRAD_RTOL, impala_grad_rel
    return {"update_ms": ms, "update_ms_median": sorted(ms)[len(ms) // 2],
            "updates": len(ms), "metric_rel": worst,
            "param_rel_l2": param_rel, "impala_loss_rel": impala_loss_rel,
            "impala_grad_rel_l2": impala_grad_rel,
            "params": sum(p.numel() for p in _leaves(card.params))}


def _multi_agent_part(torch) -> dict:
    """(c): multi-agent PPO through PPOConfig(...).build().train() on the
    card, JAX's test config."""
    from ray_tpu_torch.rllib.algorithms.ppo import PPOConfig
    from ray_tpu_torch.rllib.env.multi_agent_env import TargetMatchEnv

    spec_kw = {"obs_dim": 4, "num_actions": 4, "hiddens": (32, 32)}
    config = (
        PPOConfig()
        .environment(env=lambda: TargetMatchEnv(
            num_agents=2, num_targets=4, episode_len=16))
        .multi_agent(
            policies={"p0": dict(spec_kw), "p1": dict(spec_kw)},
            policy_mapping_fn=lambda aid: ("p0" if aid == "agent_0"
                                           else "p1"))
        .env_runners(num_envs_per_env_runner=8, rollout_fragment_length=64)
        .training(lr=3e-3, num_epochs=4, minibatch_size=256,
                  entropy_coeff=0.01)
        .debugging(seed=0))
    algo = config.build()
    try:
        devices = {pid: lg._local.device_name()
                   for pid, lg in algo.learner_groups.items()}
        runner = algo.env_runner_group._local
        runner_dev = {pid: str(p["pi"]["w"].device)
                      for pid, p in runner.params.items()}
        assert set(devices.values()) == {"cuda:0"}, devices
        assert set(runner_dev.values()) == {"cuda:0"}, runner_dev
        best, returns, t0 = -math.inf, [], time.perf_counter()
        for i in range(RL_MA_ITERS):
            r = algo.train()
            ret = r.get("episode_return_mean")
            returns.append(ret)
            if ret is not None:
                best = max(best, ret)
            if best >= RL_MA_BAR:
                break
        secs = time.perf_counter() - t0
    finally:
        algo.stop()
    assert best >= RL_MA_BAR, (best, returns)
    return {"iterations": i + 1, "best": best, "returns": returns,
            "seconds": secs, "learner_devices": devices}


def rl_phase(torch) -> dict:
    """Phase 19: RLlib on the card (run after phase 18, in this process).
    (a) Anakin, (b) the PPO-Atari learner and IMPALA's loss, (c)
    multi-agent PPO."""
    r = {}
    t0 = time.perf_counter()
    r["anakin"] = a = dict(_anakin_part(torch),
                           seconds=time.perf_counter() - t0)
    print(f"rl (a): AnakinTrainer {RL_ENVS} envs x rollout {RL_ROLLOUT}, "
          f"84x84x4 uint8, Nature-CNN ({a['params']} params), 6 actions: "
          f"{a['env_steps_per_sec']:.0f} env steps/s over {RL_TIMED} "
          f"iterations, {a['ms_per_iteration']:.2f} ms an iteration; "
          f"{a['launches_per_iteration']:.0f} device kernels an iteration, "
          f"busy {a['busy_ms_per_iteration']:.2f} of "
          f"{a['profiled_wall_ms']:.2f} ms ({100 * a['busy_share']:.1f}%, "
          f"profiled); an update under sync debug 'error'; one "
          f"iteration's actions replayed through the CPU mirror bit-equal "
          f"({a['truncations']} truncations); card vs CPU loss "
          f"{a['loss_rel']:.2e}, metrics {a['metric_rel']:.2e}, grads "
          f"{a['grad_rel_l2']:.2e} (relative L2, largest leaf, under the "
          f"CPU's ReLU masks; {a['relu_flips']} of {a['relu_units']} ReLU "
          f"signs differ; as computed: largest leaf "
          f"{a['grad_rel_l2_unmasked']:.2e}, all leaves "
          f"{a['grad_whole_rel_l2']:.2e})", flush=True)
    t0 = time.perf_counter()
    r["learner"] = b = dict(_learner_part(torch),
                            seconds=time.perf_counter() - t0)
    print(f"rl (b): PPO-Atari learner ({b['params']} params), "
          f"{RL_ROWS} rows of 84x84x4, minibatch {RL_MB}, {RL_EPOCHS} "
          f"epochs: {b['updates']} updates, "
          f"{b['update_ms_median']:.2f} ms median an update "
          f"({', '.join(f'{x:.2f}' for x in b['update_ms'])}); card vs "
          f"CPU metrics {b['metric_rel']:.2e}, params "
          f"{b['param_rel_l2']:.2e} after {b['updates']}; IMPALA loss "
          f"[{RL_IMPALA_B}, {RL_IMPALA_T}] {b['impala_loss_rel']:.2e}, "
          f"grads {b['impala_grad_rel_l2']:.2e}", flush=True)
    t0 = time.perf_counter()
    r["multi_agent"] = c = dict(_multi_agent_part(torch),
                                seconds_total=time.perf_counter() - t0)
    print(f"rl (c): multi-agent PPO (TargetMatchEnv, 2 policies, learners "
          f"and runner on cuda:0) reached {c['best']:.2f} >= "
          f"{RL_MA_BAR} in {c['iterations']} iterations, "
          f"{c['seconds']:.1f} s", flush=True)
    return r


# ------------------------------------------------------------- rl-more

RLM_ROWS = 3000                # (a) JAX's test_beats_bc_on_mixed_data rows
RLM_ITERS = 15                 # (a) iterations of 24 updates
RLM_PARITY = 4                 # (a) first updates held against the CPU
RLM_CQL_ITERS = 12             # (b) JAX's test_cql_learns_offline
RLM_CQL_PARITY = 2             # (b) first iterations held against the CPU
RLM_SAC_UPDATES = 8            # (c) updates from a fixed replay
RLM_SAC_ROWS = 4096            # (c) synthetic transitions in the replay
RLM_DREAMER_UPDATES = 8        # (d) timed update pairs
# (d) the share of categorical draws that may differ between the card and
# the CPU: a near-tie flips an argmax as a ReLU input near 0 flips its
# sign, and the flipped row's later draws follow another state
RLM_DRAW_SHARE = 0.02
RLM_FORCE = 1e4                # Gumbel noise that forces a draw


def _offline_rows(n, obs_dim=6, n_act=4, seed=0):
    """JAX's ``_make_offline_rows(with_return=True, noise_frac=0.5,
    biased_noise=True)`` (``tests/test_rllib_sac_offline.py``), copied:
    half the rows log the wrong action ``(best + 1) % n_act`` with return
    -1, the rest the best action with return 1."""
    import numpy as np

    rng = np.random.default_rng(seed)
    rows = []
    for _ in range(n):
        obs = rng.normal(size=obs_dim).astype(np.float32)
        best = int(np.argmax(obs[:n_act]))
        a = (best + 1) % n_act if rng.random() < 0.5 else best
        rows.append({"obs": obs, "action": a,
                     "return": 1.0 if a == best else -1.0})
    return rows


def _bandit_rows(n=2000, seed=0):
    """JAX's ``_quadratic_bandit_rows`` (``tests/test_rllib_eval_cql.py``),
    copied: obs in R^2, reward -(a - 0.5)^2, done at once."""
    import numpy as np

    rng = np.random.default_rng(seed)
    obs = rng.uniform(-1, 1, (n, 2)).astype(np.float32)
    act = rng.uniform(-1, 1, (n, 1)).astype(np.float32)
    rew = -((act[:, 0] - 0.5) ** 2)
    nxt = rng.uniform(-1, 1, (n, 2)).astype(np.float32)
    return [{"obs": obs[i], "action": act[i], "reward": float(rew[i]),
             "next_obs": nxt[i], "done": True} for i in range(n)]


def _record_updates(torch, algo, upto, on_card):
    """Wrap ``algo.learner_group.update_from_batch``: every update's
    metrics and host ms (ending in its metric read), and the weights after
    update ``upto``."""
    rec = {"metrics": [], "ms": [], "weights": None}
    real = algo.learner_group.update_from_batch

    def update(batch, cfg):
        if on_card:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = real(batch, cfg)
        rec["ms"].append(1e3 * (time.perf_counter() - t0))
        rec["metrics"].append(dict(out))
        if len(rec["metrics"]) == upto:
            rec["weights"] = algo.learner_group.get_weights()
        return out

    algo.learner_group.update_from_batch = update
    return rec


def _metrics_rel(got: dict, want: dict) -> float:
    """The largest relative difference of two metric dicts' float values
    (the host clock's ``time_total_s`` aside)."""
    return max(_rel(got[k], want[k]) for k in want
               if isinstance(want[k], float) and k != "time_total_s")


def _greedy_accuracy(torch, algo, n=512, seed=99) -> float:
    """Greedy accuracy against the true optimal action on held-out states,
    as JAX's ``_optimal_accuracy`` measures it."""
    import numpy as np

    from ray_tpu_torch.rllib import RLModule
    from ray_tpu_torch.rllib.core.learner import params_from_numpy

    rng = np.random.default_rng(seed)
    obs = rng.normal(size=(n, 6)).astype(np.float32)
    best = np.argmax(obs[:, :4], axis=1)
    dev = torch.device("cuda", 0)
    with torch.no_grad():
        logits = RLModule(algo.spec).forward_inference(
            params_from_numpy(algo.get_weights(), dev),
            torch.from_numpy(obs).to(dev))
    return float(np.mean(logits.argmax(-1).cpu().numpy() == best))


def _imitation_part(torch, rd) -> dict:
    """(a): MARWIL and BC on JAX's mixed rows, on the card."""
    import numpy as np

    from ray_tpu_torch.rllib import BCConfig, MARWILConfig

    rows = _offline_rows(RLM_ROWS)

    def config(cls, data, beta):
        cfg = (cls().environment(observation_dim=6, num_actions=4)
               .offline_data(input_=data)
               .training(lr=3e-3, updates_per_iteration=24,
                         model={"hiddens": (64,)})
               .debugging(seed=1))
        return cfg if beta is None else cfg.training(beta=beta)

    out = {}
    for name, cls, beta in (("marwil", MARWILConfig, 2.0),
                            ("bc", BCConfig, None)):
        # BC reads its rows through a port Dataset
        data = rd.from_items(rows) if name == "bc" else rows
        card = config(cls, data, beta).build()
        cpu = config(cls, rows, beta).learners(device="cpu").build()
        try:
            for k, v in cpu._data.items():  # the Dataset kept the rows
                assert np.array_equal(card._data[k], v), k
            dev = card.learner_group._local.device_name()
            assert dev == "cuda:0", dev
            rec = _record_updates(torch, card, RLM_PARITY, True)
            ref = _record_updates(torch, cpu, RLM_PARITY, False)
            # the CPU twin stops after the parity updates
            cpu.config.updates_per_iteration = RLM_PARITY
            cpu.train()
            results = [card.train() for _ in range(RLM_ITERS)]
            assert results[-1]["num_rows"] == RLM_ROWS, results[-1]
            met_rel = max(_metrics_rel(g, w) for g, w in zip(
                rec["metrics"][:RLM_PARITY], ref["metrics"]))
            param_rel = _leaf_rel_l2(torch, rec["weights"], ref["weights"])
            assert met_rel <= RL_LOSS_RTOL, (name, met_rel)
            assert param_rel <= RL_PARAM_RTOL, (name, param_rel)
            assert all(math.isfinite(v) for r in results for v in r.values()
                       if isinstance(v, float)), results[-1]
            acc = _greedy_accuracy(torch, card)
            ms = rec["ms"]
            out[name] = {"accuracy": acc, "metric_rel": met_rel,
                         "param_rel_l2": param_rel, "updates": len(ms),
                         "update_ms_median": sorted(ms)[len(ms) // 2],
                         "first_update_ms": ms[0],
                         "policy_loss": results[-1]["policy_loss"]}
        finally:
            card.stop()
            cpu.stop()
    assert out["marwil"]["accuracy"] > 0.85, out
    assert out["marwil"]["accuracy"] > out["bc"]["accuracy"] + 0.15, out
    return out


def _cql_part(torch) -> dict:
    """(b): CQL on JAX's bandit rows, on the card."""
    from ray_tpu_torch.rllib.algorithms import CQLConfig
    from ray_tpu_torch.rllib.algorithms.sac import SACModule
    from ray_tpu_torch.rllib.core.learner import params_from_numpy

    rows = _bandit_rows()

    def config():
        return (CQLConfig()
                .environment(observation_dim=2, num_actions=1)
                .offline_data(input_=rows)
                .training(lr=3e-3, train_batch_size=256,
                          updates_per_iteration=16, cql_alpha=1.0,
                          num_cql_actions=4, bc_iters=1, gamma=0.0,
                          model={"hiddens": (32, 32)})
                .debugging(seed=0))

    card, cpu = config().build(), config().learners(device="cpu").build()
    try:
        dev = card.learner_group._local.device_name()
        assert dev == "cuda:0", dev
        met_rel, ms, results = 0.0, [], []
        for i in range(RLM_CQL_ITERS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            got = card.train()
            ms.append(1e3 * (time.perf_counter() - t0)
                      / card.config.updates_per_iteration)
            results.append(got)
            if i < RLM_CQL_PARITY:
                met_rel = max(met_rel, _metrics_rel(got, cpu.train()))
                if i == RLM_CQL_PARITY - 1:
                    param_rel = _leaf_rel_l2(
                        torch, card.learner_group.get_weights(),
                        cpu.learner_group.get_weights())
                    target_rel = _leaf_rel_l2(torch, card._target_q,
                                              cpu._target_q)
        for r in results:
            assert all(math.isfinite(r[k]) for k in (
                "critic_loss", "actor_loss", "cql_penalty", "mean_q_data",
                "entropy", "total_loss")), r
        assert results[-1]["num_offline_transitions"] == len(rows)
        assert met_rel <= RL_LOSS_RTOL, met_rel
        assert param_rel <= RL_PARAM_RTOL, param_rel
        assert target_rel <= RL_PARAM_RTOL, target_rel
        dev = torch.device("cuda", 0)
        with torch.no_grad():
            greedy, _ = SACModule(card.spec).sample_action(
                params_from_numpy(card.learner_group.get_weights(), dev),
                torch.zeros((8, 2), device=dev),
                torch.zeros((8, 1), device=dev))
        mean_act = float(greedy.mean())
        assert abs(mean_act - 0.5) < 0.25, mean_act
    finally:
        card.stop()
        cpu.stop()
    return {"mean_action": mean_act, "metric_rel": met_rel,
            "param_rel_l2": param_rel, "target_rel_l2": target_rel,
            "update_ms": ms, "update_ms_median": sorted(ms)[len(ms) // 2],
            "cql_penalty": results[-1]["cql_penalty"]}


def _sac_part(torch) -> dict:
    """(c): SAC's updates at Pendulum's shapes from a fixed replay, card
    against CPU."""
    import numpy as np

    from ray_tpu_torch.rllib import SAC, SACConfig

    def config():
        return (SACConfig().environment(observation_dim=3, num_actions=1)
                .training(num_steps_sampled_before_learning_starts=0,
                          updates_per_iteration=RLM_SAC_UPDATES,
                          train_batch_size=256,
                          model={"hiddens": (256, 256)})
                .debugging(seed=0))

    rng = np.random.default_rng(0)
    n = RLM_SAC_ROWS
    replay = {"obs": rng.normal(size=(n, 3)).astype(np.float32),
              "actions": rng.uniform(-1, 1, (n, 1)).astype(np.float32),
              "rewards": rng.normal(size=n).astype(np.float32),
              "next_obs": rng.normal(size=(n, 3)).astype(np.float32),
              "terminateds": rng.random(n) < 0.05,
              "truncateds": np.zeros(n, bool)}
    card, cpu = SAC(config()), SAC(config().learners(device="cpu"))
    targets = {"card": [], "cpu": []}
    recs = {}
    for key, algo in (("card", card), ("cpu", cpu)):
        algo.replay.add(replay)
        real = algo._compute_targets

        def compute(batch, weights, real=real, out=targets[key]):
            t = real(batch, weights)
            out.append(t)
            return t

        algo._compute_targets = compute
        recs[key] = _record_updates(torch, algo, RLM_SAC_UPDATES,
                                    key == "card")
    assert card.learner_group._local.device_name() == "cuda:0"
    assert _leaf_rel_l2(torch, card.learner_group.get_weights(),
                        cpu.learner_group.get_weights()) == 0.0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = card.training_step()
    step_ms = 1e3 * (time.perf_counter() - t0) / RLM_SAC_UPDATES
    want = cpu.training_step()
    target_rel = max(_leaf_rel_l2(torch, [torch.from_numpy(g)],
                                  [torch.from_numpy(w)])
                     for g, w in zip(targets["card"], targets["cpu"]))
    met_rel = max(_metrics_rel(g, w) for g, w in zip(
        recs["card"]["metrics"], recs["cpu"]["metrics"]))
    param_rel = _leaf_rel_l2(torch, card.learner_group.get_weights(),
                             cpu.learner_group.get_weights())
    polyak_rel = _leaf_rel_l2(torch, card._target_q, cpu._target_q)
    assert len(targets["card"]) == RLM_SAC_UPDATES
    assert target_rel <= RL_LOSS_RTOL, target_rel
    assert met_rel <= RL_LOSS_RTOL, met_rel
    assert param_rel <= RL_PARAM_RTOL, param_rel
    assert polyak_rel <= RL_PARAM_RTOL, polyak_rel
    assert all(math.isfinite(v) for v in got.values()), got
    card.stop()
    cpu.stop()
    ms = recs["card"]["ms"]
    return {"target_rel_l2": target_rel, "metric_rel": met_rel,
            "param_rel_l2": param_rel, "polyak_rel_l2": polyak_rel,
            "update_ms": ms, "update_ms_median": sorted(ms)[len(ms) // 2],
            "step_ms_per_update": step_ms, "critic_loss": got["critic_loss"],
            "cpu_critic_loss": want["critic_loss"]}


def _forced(idx, n):
    """Gumbel noise that makes every draw ``idx`` (the CPU's)."""
    from ray_tpu_torch.rllib.algorithms.dreamerv3 import one_hot

    return one_hot(idx, n) * RLM_FORCE


def _dreamer_part(torch) -> dict:
    """(d): DreamerV3's two updates at the config's defaults, card
    against CPU, then timed on the card."""
    import numpy as np

    from ray_tpu_torch.models.transformer import _leaves
    from ray_tpu_torch.rllib.algorithms import DreamerV3, DreamerV3Config
    from ray_tpu_torch.rllib.algorithms.dreamerv3 import gumbel

    def config(device=None):
        cfg = DreamerV3Config()
        cfg.observation_dim, cfg.num_actions = 4, 2   # CartPole's shapes
        cfg.learner_device = device
        return cfg

    card, cpu = DreamerV3(config()), DreamerV3(config("cpu"))
    cfg = card.config
    B, T, H = cfg.batch_size_B, cfg.batch_length_T, cfg.horizon_H
    G, C, A = cfg.stoch_groups, cfg.stoch_classes, 2
    assert str(card.params["wm"]["gru"]["wi"].device) == "cuda:0"
    assert _leaf_rel_l2(torch, card.params, cpu.params) == 0.0
    rng = np.random.default_rng(0)
    batch = {"obs": rng.normal(size=(B, T, 4)).astype(np.float32),
             "action": rng.integers(0, A, (B, T)).astype(np.int32),
             "reward": np.ones((B, T), np.float32),
             "cont": (rng.random((B, T)) > 0.05).astype(np.float32)}
    gen = torch.Generator().manual_seed(0)
    noise = [gumbel(s, gen, "cpu") for s in (
        (T, B, G, C), (H, T * B, A), (H, T * B, G, C))]
    dev = torch.device("cuda", 0)
    on = {"card": (card, dev), "cpu": (cpu, torch.device("cpu"))}

    def put(x, d):
        return {k: torch.from_numpy(v).to(d) for k, v in x.items()} \
            if isinstance(x, dict) else x.to(d)

    def wm_grads(key, wm_noise):
        algo, d = on[key]
        loss, aux = algo.wm_loss(algo.params["wm"], put(batch, d),
                                 put(wm_noise, d))
        return loss, aux, torch.autograd.grad(loss, _leaves(
            algo.params["wm"]))

    def ac_grads(key, starts, act_noise, prior_noise):
        algo, d = on[key]
        ac = {"actor": algo.params["actor"], "critic": algo.params["critic"]}
        loss, aux = algo.ac_loss(ac, algo.params["wm"],
                                 tuple(put(s, d) for s in starts),
                                 put(act_noise, d), put(prior_noise, d))
        with torch.no_grad():
            *_, stochs, actions = algo.imagine(
                {"actor": ac["actor"], "wm": algo.params["wm"]},
                tuple(put(s, d) for s in starts), put(act_noise, d),
                put(prior_noise, d))
        return (loss, aux, torch.autograd.grad(loss, _leaves(ac)),
                stochs.reshape(H, T * B, G, C).argmax(-1), actions)

    def draws(stoch):
        return stoch.reshape(stoch.shape[:-1] + (G, C)).argmax(-1)

    # the world model: losses, grads and posterior draws
    closs, caux, cgrads = wm_grads("cpu", noise[0])
    gloss, gaux, ggrads = wm_grads("card", noise[0])
    cdraw, gdraw = draws(caux["starts"][1]), draws(gaux["starts"][1]).cpu()
    wm_flips = int((cdraw != gdraw).sum())
    wm_rel = max(_rel(float(gaux[k].detach()), float(caux[k].detach()))
                 for k in ("wm_loss", "recon_loss", "kl_loss"))
    wm_grad_rel = _leaf_rel_l2(torch, list(ggrads), list(cgrads))
    if wm_flips:
        # hold the card under the CPU's draws
        forced = _forced(cdraw, C)
        gloss, gaux, ggrads = wm_grads("card", forced)
        wm_rel = max(_rel(float(gaux[k].detach()), float(caux[k].detach()))
                     for k in ("wm_loss", "recon_loss", "kl_loss"))
        wm_grad_rel = _leaf_rel_l2(torch, list(ggrads), list(cgrads))
    # the actor and critic from the CPU's posterior starts on both devices
    starts = caux["starts"]
    c2 = ac_grads("cpu", starts, noise[1], noise[2])
    g2 = ac_grads("card", starts, noise[1], noise[2])
    ac_flips = int((g2[3].cpu() != c2[3]).sum()
                   + (g2[4].cpu() != c2[4]).sum())
    ac_draws_n = c2[3].numel() + c2[4].numel()
    if ac_flips:
        g2 = ac_grads("card", starts, _forced(c2[4], A),
                      _forced(c2[3], C))
    ac_rel = max([_rel(float(g2[0].detach()), float(c2[0].detach()))]
                 + [_rel(float(g2[1][k].detach()), float(c2[1][k].detach()))
                    for k in c2[1]])
    ac_grad_rel = _leaf_rel_l2(torch, list(g2[2]), list(c2[2]))
    flips, total = wm_flips + ac_flips, cdraw.numel() + ac_draws_n
    assert flips <= RLM_DRAW_SHARE * total, (wm_flips, ac_flips, total)
    assert wm_rel <= RL_LOSS_RTOL and ac_rel <= RL_LOSS_RTOL, (wm_rel,
                                                               ac_rel)
    assert wm_grad_rel <= RL_GRAD_RTOL, wm_grad_rel
    assert ac_grad_rel <= RL_GRAD_RTOL, ac_grad_rel

    # one update pair with every host read an error, then 8 timed pairs
    bc = put(batch, dev)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        wm_noise, act_noise, prior_noise = card._update_noise()
        aux = card._wm_update(bc, wm_noise)
        out = card._ac_update(aux.pop("starts"), act_noise, prior_noise)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert all(math.isfinite(float(v)) for v in {**aux, **out}.values())
    wm_ms, ac_ms = [], []
    for _ in range(RLM_DREAMER_UPDATES):
        wm_noise, act_noise, prior_noise = card._update_noise()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        aux = card._wm_update(bc, wm_noise)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        out = card._ac_update(aux.pop("starts"), act_noise, prior_noise)
        torch.cuda.synchronize()
        wm_ms.append(1e3 * (t1 - t0))
        ac_ms.append(1e3 * (time.perf_counter() - t1))
    losses = {k: float(v) for k, v in {**aux, **out}.items()}
    assert all(math.isfinite(v) for v in losses.values()), losses
    assert all(st.count == 1 + RLM_DREAMER_UPDATES
               for st in card._opt_state.values())
    card.stop()
    cpu.stop()
    return {"wm_flips": wm_flips, "ac_flips": ac_flips, "draws": total,
            "wm_loss_rel": wm_rel, "wm_grad_rel_l2": wm_grad_rel,
            "ac_loss_rel": ac_rel, "ac_grad_rel_l2": ac_grad_rel,
            "wm_ms": wm_ms, "ac_ms": ac_ms,
            "wm_ms_median": sorted(wm_ms)[len(wm_ms) // 2],
            "ac_ms_median": sorted(ac_ms)[len(ac_ms) // 2],
            "losses": losses,
            "params": sum(p.numel() for p in _leaves(card.params))}


def rl_more_phase(torch) -> dict:
    """Phase 20: the rest of RLlib on the card (run after phase 19, in
    this process). (a) MARWIL and BC, (b) CQL, (c) SAC's updates, (d)
    DreamerV3's updates; K1-K4 counted over the phase (none run)."""
    import ray_tpu_torch as rt
    from ray_tpu_torch import data as rd
    from ray_tpu_torch.ops import flash_attention as fa
    from ray_tpu_torch.ops.paged_attention import paged_attention

    _reset_counters(fa)
    paged_attention.launches = 0
    r = {}
    rt.init(num_gpus=0)
    try:
        t0 = time.perf_counter()
        r["imitation"] = a = dict(_imitation_part(torch, rd),
                                  seconds=time.perf_counter() - t0)
    finally:
        rt.shutdown()
    m, b = a["marwil"], a["bc"]
    print(f"rl-more (a): MARWIL and BC on {RLM_ROWS} mixed rows (obs 6, 4 "
          f"actions, hiddens (64,), {RLM_ITERS} x 24 updates, learners on "
          f"cuda:0, BC through a port Dataset): optimal-action accuracy "
          f"MARWIL {m['accuracy']:.3f} > 0.85, BC {b['accuracy']:.3f}; "
          f"first {RLM_PARITY} updates card vs CPU metrics "
          f"{max(m['metric_rel'], b['metric_rel']):.2e}, params "
          f"{max(m['param_rel_l2'], b['param_rel_l2']):.2e}; "
          f"{m['update_ms_median']:.2f} / {b['update_ms_median']:.2f} ms "
          f"median an update (first {m['first_update_ms']:.2f} / "
          f"{b['first_update_ms']:.2f})", flush=True)
    t0 = time.perf_counter()
    r["cql"] = c = dict(_cql_part(torch), seconds=time.perf_counter() - t0)
    print(f"rl-more (b): CQL on 2000 bandit rows (hiddens (32, 32), "
          f"{RLM_CQL_ITERS} x 16 updates, bc_iters 1, on cuda:0): greedy "
          f"mean action {c['mean_action']:.3f} (0.5 +- 0.25); first "
          f"{RLM_CQL_PARITY} iterations card vs CPU metrics "
          f"{c['metric_rel']:.2e}, params {c['param_rel_l2']:.2e}, targets "
          f"{c['target_rel_l2']:.2e}; {c['update_ms_median']:.2f} ms median "
          f"an update", flush=True)
    t0 = time.perf_counter()
    r["sac"] = s = dict(_sac_part(torch), seconds=time.perf_counter() - t0)
    print(f"rl-more (c): SAC at Pendulum's shapes (obs 3, 1 action, hiddens "
          f"(256, 256), batch 256), {RLM_SAC_UPDATES} updates from a fixed "
          f"replay: card vs CPU targets {s['target_rel_l2']:.2e}, metrics "
          f"{s['metric_rel']:.2e}, params {s['param_rel_l2']:.2e}, polyak "
          f"targets {s['polyak_rel_l2']:.2e}; {s['update_ms_median']:.2f} ms "
          f"median an update, {s['step_ms_per_update']:.2f} ms an update "
          f"with its targets and polyak average", flush=True)
    t0 = time.perf_counter()
    r["dreamer"] = d = dict(_dreamer_part(torch),
                            seconds=time.perf_counter() - t0)
    print(f"rl-more (d): DreamerV3 at the config's defaults (B16 T16 H15, "
          f"deter 128, 8x8, hidden 128, {d['params']} params; obs 4, 2 "
          f"actions): card vs CPU world-model loss {d['wm_loss_rel']:.2e}, "
          f"grads {d['wm_grad_rel_l2']:.2e}; actor-critic loss "
          f"{d['ac_loss_rel']:.2e}, grads {d['ac_grad_rel_l2']:.2e}; "
          f"{d['wm_flips'] + d['ac_flips']} of {d['draws']} categorical "
          f"draws differ ({d['wm_flips']} world model, {d['ac_flips']} "
          f"imagination); an update pair under sync debug 'error'; "
          f"{d['wm_ms_median']:.2f} ms a world-model update, "
          f"{d['ac_ms_median']:.2f} ms an actor-critic update (median of "
          f"{RLM_DREAMER_UPDATES})", flush=True)
    r["launches"] = launches = {
        "flash_forward": fa.KERNELS[0].launches,
        "flash_dq": fa.KERNELS[1].launches,
        "flash_dkv": fa.KERNELS[2].launches,
        "paged_attention": paged_attention.launches}
    assert not any(launches.values()), launches
    print("rl-more: K1-K4 launches in the phase " + json.dumps(launches),
          flush=True)
    return r


MESH_STEPS = 5
# (a) at world 1 runs the meshless step's kernels on the same bits: its
# losses and grad norms read bit-equal to the meshless ones on an H100
# (PERF.md), so each is held within 1e-6 relative
MESH_WORLD1_RTOL = 1e-6
MESH_REMAT_STEPS = 2          # (a) again with remat on, both ways
# (b) float32, the ring's einsum against the flash kernels: relative L2 of
# the largest grad leaf, read 5.66e-06 on an H100 (PERF.md)
MESH_RING_GRAD_RTOL = 5e-5
# (c) 1F1B against sequential autodiff: the loss read equal and the grads
# 5.74e-08 relative L2 on an H100 (PERF.md)
MESH_1F1B_LOSS_RTOL = 1e-6
MESH_1F1B_GRAD_RTOL = 1e-5
MESH_MICRO = 4                # (c) microbatches


def _mesh_steps(torch, cfg, B, S, mesh, steps=MESH_STEPS) -> dict:
    """``steps`` steps of gpt2_small from seed 0 on one batch, with or
    without a mesh; per-step ms (host clock, synchronized) and the K1-K3
    launches around the steps."""
    from ray_tpu_torch import OptimizerConfig
    from ray_tpu_torch.models import training
    from ray_tpu_torch.ops import flash_attention as fa

    state, tx = training.init_train_state(
        cfg, OptimizerConfig(warmup_steps=10, decay_steps=1000), seed=0,
        mesh=mesh)
    step = training.make_train_step(cfg, tx, mesh=mesh)
    g = torch.Generator(device="cuda").manual_seed(1)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (B, S), generator=g,
                                     device="cuda")}
    _reset_counters(fa)
    losses, norms, ms = [], [], []
    for _ in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step(state, batch)
        loss = float(m["loss"])
        ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(loss)
        norms.append(float(m["grad_norm"]))
    launches = {f.__name__: f.launches for f in fa.KERNELS}
    placements = None
    table = state.params["embed"]["table"]
    if hasattr(table, "placements"):
        placements = [str(p) for p in table.placements]
    del state, tx, step
    torch.cuda.empty_cache()
    return dict(losses=losses, grad_norms=norms, step_ms=ms,
                step_ms_median=sorted(ms[1:])[len(ms[1:]) // 2],
                launches=launches, placements=placements)


def _mesh_ring(torch, mesh_spec_cls, build_mesh) -> dict:
    """(b): the ring branch's loss and grads over an sp axis of size 1
    against the meshless (flash) ones, float32, gpt2_small width, B2 x
    S1024, remat on: each block runs again in backward, on autograd's
    device thread, with the mesh it was given."""
    from ray_tpu_torch import presets
    from ray_tpu_torch.models import transformer

    cfg = presets.gpt2_small(remat=True, dtype=torch.float32,
                             ce_chunk=2048)
    ring_cfg = presets.gpt2_small(remat=True, dtype=torch.float32,
                                  ce_chunk=2048, attn_impl="ring")
    params = transformer.init_params(cfg, 3, "cuda",
                                     param_dtype=torch.float32)
    params = transformer.map_params(
        lambda _p, t: t.requires_grad_(True), params)
    leaves = transformer._leaves(params)
    g = torch.Generator(device="cuda").manual_seed(4)
    B, S = 2, 1024
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (B, S), generator=g,
                                     device="cuda")}
    sp = build_mesh(mesh_spec_cls((("sp", 1),)))
    loss = transformer.loss_fn(cfg, params, batch)[0]
    plain_grads = torch.autograd.grad(loss, leaves)
    plain = float(loss.detach())
    loss = transformer.loss_fn(ring_cfg, params, batch, sp_axis="sp",
                               mesh=sp,
                               positions=torch.arange(S, device="cuda"))[0]
    ring_grads = torch.autograd.grad(loss, leaves)
    ring = float(loss.detach())
    rel = abs(ring - plain) / abs(plain)
    grad_rel = max(float((a - b).norm() / b.norm())
                   for a, b in zip(ring_grads, plain_grads) if b.norm() > 0)
    del params, leaves, plain_grads, ring_grads, loss
    torch.cuda.empty_cache()
    if not (rel <= TRAIN_PARITY_RTOL and grad_rel <= MESH_RING_GRAD_RTOL):
        raise AssertionError(f"mesh (b): ring loss {ring} against meshless "
                             f"{plain} (rel {rel:.2e}), grads rel L2 "
                             f"{grad_rel:.2e}")
    return dict(batch=B, seq=S, ring_loss=ring, meshless_loss=plain,
                rel=rel, rtol=TRAIN_PARITY_RTOL, grad_rel_l2=grad_rel,
                grad_rtol=MESH_RING_GRAD_RTOL)


def _mesh_1f1b(torch, mesh_spec_cls, build_mesh) -> dict:
    """(c): ``pipeline_1f1b`` over a pp axis of size 1, two gpt2_small
    blocks as the stage, against sequential autodiff."""
    from torch.distributed.tensor import distribute_tensor

    from ray_tpu_torch import presets
    from ray_tpu_torch.models import transformer
    from ray_tpu_torch.ops import flash_attention as fa
    from ray_tpu_torch.parallel import pipeline

    cfg = presets.gpt2_small(remat=False)
    params = transformer.init_params(cfg, 5, "cuda",
                                     param_dtype=torch.float32)
    blocks = params["blocks"][:2]
    del params
    pp = build_mesh(mesh_spec_cls((("pp", 1),)))
    stacked = pipeline.stack_stage_params([blocks])
    shard = pipeline.stage_param_sharding(stacked, pp)
    placed = pipeline.tree_map(
        lambda x, s: distribute_tensor(x, pp, s.placements,
                                       src_data_rank=None), stacked, shard)
    g = torch.Generator(device="cuda").manual_seed(6)
    x = torch.randn((MESH_MICRO, 2, 1024, cfg.embed_dim), generator=g,
                    device="cuda").to(cfg.dtype)

    def stage_fn(stage, h):
        for p in stage:
            h, _ = transformer._block(cfg, p, h, None, None)
        return h

    def loss_fn(a):
        return (a.float() ** 2).mean()

    _reset_counters(fa)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loss, grads = pipeline.pipeline_1f1b(stage_fn, loss_fn, placed, x,
                                         mesh=pp)
    loss = float(loss)
    ms = (time.perf_counter() - t0) * 1e3
    launches = {f.__name__: f.launches for f in fa.KERNELS}
    want = {"flash_forward": 4 * MESH_MICRO, "flash_dq": 2 * MESH_MICRO,
            "flash_dkv": 2 * MESH_MICRO}
    if launches != want:
        raise AssertionError(f"mesh (c): flash launches {launches}, "
                             f"expected {want}")
    ref_params = transformer.map_params(
        lambda _p, t: t.detach().requires_grad_(True), blocks)
    total = 0.0
    for m in range(MESH_MICRO):
        total = total + loss_fn(stage_fn(ref_params, x[m]))
    total = total / MESH_MICRO
    ref_grads = torch.autograd.grad(total, transformer._leaves(ref_params))
    total = float(total.detach())
    got = [g.to_local()[0] for g in transformer._leaves(grads)]
    grad_rel = max(float((a.float() - b.float()).norm() / b.float().norm())
                   for a, b in zip(got, ref_grads) if b.norm() > 0)
    loss_rel = abs(loss - total) / abs(total)
    if not (loss_rel <= MESH_1F1B_LOSS_RTOL
            and grad_rel <= MESH_1F1B_GRAD_RTOL):
        raise AssertionError(f"mesh (c): 1F1B loss {loss} against "
                             f"sequential {total} (rel "
                             f"{loss_rel:.2e}), grads rel L2 {grad_rel:.2e}")
    del blocks, placed, ref_params, grads, ref_grads
    torch.cuda.empty_cache()
    return dict(microbatches=MESH_MICRO, loss=loss,
                sequential_loss=total, loss_rel=loss_rel,
                grad_rel_l2=grad_rel, launches=launches, call_ms=ms)


def mesh_phase(torch, card) -> dict:
    """Phase 21: the SPMD layer on a world-1 NCCL group (run after phase
    20, in this process)."""
    import os
    import tempfile

    import torch.distributed as dist

    from ray_tpu_torch import presets
    from ray_tpu_torch.parallel.mesh import MeshSpec, build_mesh

    r = {}
    cfg = presets.gpt2_small(remat=False, ce_chunk=8192)
    B, S = 16, 1024
    t0 = time.perf_counter()
    r["meshless"] = plain = _mesh_steps(torch, cfg, B, S, None)
    with tempfile.TemporaryDirectory() as d:
        store = dist.FileStore(os.path.join(d, "store"), 1)
        dist.init_process_group("nccl", store=store, rank=0, world_size=1,
                                device_id=torch.device("cuda", 0))
        try:
            mesh = build_mesh(MeshSpec.auto(1))
            r["mesh"] = got = _mesh_steps(torch, cfg, B, S, mesh)
            r["a_seconds"] = time.perf_counter() - t0
            want = {"flash_forward": 12 * MESH_STEPS,
                    "flash_dq": 12 * MESH_STEPS,
                    "flash_dkv": 12 * MESH_STEPS}
            if got["launches"] != want:
                raise AssertionError(f"mesh (a): flash launches "
                                     f"{got['launches']}, expected {want}")
            rels = [abs(a - b) / abs(b) for a, b in zip(got["losses"],
                                                         plain["losses"])]
            norm_rels = [abs(a - b) / abs(b) for a, b in zip(
                got["grad_norms"], plain["grad_norms"])]
            r["loss_rel"], r["grad_norm_rel"] = max(rels), max(norm_rels)
            r["bit_equal"] = (got["losses"] == plain["losses"]
                              and got["grad_norms"] == plain["grad_norms"])
            bad = [x for x in got["losses"] + got["grad_norms"]
                   if not math.isfinite(x)]
            if bad or max(rels + norm_rels) > MESH_WORLD1_RTOL:
                raise AssertionError(
                    f"mesh (a): losses {got['losses']} and grad norms "
                    f"{got['grad_norms']} against meshless "
                    f"{plain['losses']} and {plain['grad_norms']} (rel "
                    f"{max(rels):.2e}, {max(norm_rels):.2e})")
            print(f"mesh (a): gpt2_small B{B} x S{S}, remat off, "
                  f"{MESH_STEPS} steps on {MeshSpec.auto(1).axes} "
                  f"(DTensor params, embed table {got['placements']}): "
                  f"losses {[round(x, 4) for x in got['losses']]}, meshless "
                  f"{[round(x, 4) for x in plain['losses']]}, max rel "
                  f"{max(rels):.2e} (grad norms {max(norm_rels):.2e}, rtol "
                  f"{MESH_WORLD1_RTOL:g}), bit-equal {r['bit_equal']}; "
                  f"step ms "
                  f"mesh {[round(x, 1) for x in got['step_ms']]} (median of "
                  f"2-{MESH_STEPS} {got['step_ms_median']:.1f}), meshless "
                  f"{[round(x, 1) for x in plain['step_ms']]} (median "
                  f"{plain['step_ms_median']:.1f}); flash launches "
                  f"{got['launches']}; {card}", flush=True)
            # remat on (the config's default): each block, its params'
            # gather with it, runs again in backward on autograd's device
            # thread, through K1 once more
            remat_cfg = presets.gpt2_small(ce_chunk=8192)
            r["remat"] = rm = {
                "meshless": _mesh_steps(torch, remat_cfg, B, S, None,
                                        MESH_REMAT_STEPS),
                "mesh": _mesh_steps(torch, remat_cfg, B, S, mesh,
                                    MESH_REMAT_STEPS)}
            pairs = list(zip(rm["mesh"]["losses"] + rm["mesh"]["grad_norms"],
                             rm["meshless"]["losses"]
                             + rm["meshless"]["grad_norms"]))
            rm["rel"] = max(abs(a - b) / abs(b) for a, b in pairs)
            want = {"flash_forward": 24 * MESH_REMAT_STEPS,
                    "flash_dq": 12 * MESH_REMAT_STEPS,
                    "flash_dkv": 12 * MESH_REMAT_STEPS}
            if (rm["mesh"]["launches"] != want
                    or not all(math.isfinite(a) for a, _ in pairs)
                    or rm["rel"] > MESH_WORLD1_RTOL):
                raise AssertionError(
                    f"mesh (a, remat on): {rm['mesh']} against meshless "
                    f"{rm['meshless']} (rel {rm['rel']:.2e}); flash "
                    f"launches expected {want}")
            print(f"mesh (a, remat on): {MESH_REMAT_STEPS} steps, losses "
                  f"{rm['mesh']['losses']} and grad norms "
                  f"{rm['mesh']['grad_norms']} against meshless (max rel "
                  f"{rm['rel']:.2e}, rtol {MESH_WORLD1_RTOL:g}); step ms "
                  f"mesh {[round(x, 1) for x in rm['mesh']['step_ms']]}, "
                  f"meshless "
                  f"{[round(x, 1) for x in rm['meshless']['step_ms']]}; "
                  f"flash launches {rm['mesh']['launches']}", flush=True)
            t1 = time.perf_counter()
            r["ring"] = b = _mesh_ring(torch, MeshSpec, build_mesh)
            b["seconds"] = time.perf_counter() - t1
            print(f"mesh (b): attn_impl='ring' over sp 1, gpt2_small width "
                  f"(12 layers), B{b['batch']} x S{b['seq']}, float32, "
                  f"remat on: loss {b['ring_loss']:.6f} against meshless "
                  f"{b['meshless_loss']:.6f} (rel {b['rel']:.2e}, rtol "
                  f"{b['rtol']:g}), grads rel L2 {b['grad_rel_l2']:.2e} "
                  f"(rtol {b['grad_rtol']:g})", flush=True)
            t1 = time.perf_counter()
            r["pipeline_1f1b"] = c = _mesh_1f1b(torch, MeshSpec, build_mesh)
            c["seconds"] = time.perf_counter() - t1
            print(f"mesh (c): pipeline_1f1b over pp 1, two gpt2_small "
                  f"blocks (bf16), {c['microbatches']} microbatches of B2 x "
                  f"S1024: loss {c['loss']:.6f} against sequential "
                  f"{c['sequential_loss']:.6f} (rel {c['loss_rel']:.2e}, "
                  f"rtol {MESH_1F1B_LOSS_RTOL:g}), grads rel L2 "
                  f"{c['grad_rel_l2']:.2e} (rtol {MESH_1F1B_GRAD_RTOL:g}); "
                  f"flash launches "
                  f"{c['launches']}; {c['call_ms']:.1f} ms the call",
                  flush=True)
        finally:
            dist.destroy_process_group()
    return r


# --------------------------------------------------------------- harness

HARNESS_BUDGET_S = 0.2     # (b): a probe's wall budget (the CPU smoke's)
HARNESS_PA_LAYERS = 8      # (c): llama3_8b at 8 of its 32 layers
HARNESS_PA_BUDGET_S = 1.0  # (c): 50 steps x 3 an arm, and the pool sweep
HARNESS_CHAOS_SEED = 0     # (d)


def _harness_groups(torch, rt, mb, harness) -> dict:
    """(b): every group but RL on a cluster listing the card
    ``CARD_ACTORS`` times; K4's launches in this process over the serve
    group (its replica is this process's)."""
    from ray_tpu_torch.ops.paged_attention import paged_attention

    with harness.card_listed(mb.CARD_ACTORS):
        rt.init(num_cpus=8, num_gpus=mb.CARD_ACTORS,
                object_store_memory=512 * 1024 * 1024)
    out = {"groups": {}, "records": []}
    try:
        for group in mb.GROUPS:
            if group is mb.rl_group:
                continue
            t0 = time.perf_counter()
            n0 = paged_attention.launches
            recs = group(HARNESS_BUDGET_S, None)
            out["groups"][group.__name__] = {
                "seconds": time.perf_counter() - t0,
                "k4": paged_attention.launches - n0}
            out["records"] += recs
    finally:
        rt.shutdown()
    bad = [r for r in out["records"] if not r["value"] > 0]
    if bad:
        raise AssertionError(f"harness (b): values not above 0: {bad}")
    if out["groups"]["serve_group"]["k4"] <= 0:
        raise AssertionError("harness (b): the continuous serve probe's "
                             "replica launched no K4: not on the card")
    return out


def harness_phase(torch, card) -> dict:
    """Phase 22: the harness scripts on the card (run after phase 21)."""
    import ray_tpu_torch as rt
    from ray_tpu_torch import presets
    from ray_tpu_torch._private import harness
    from ray_tpu_torch.models.transformer import init_params
    from ray_tpu_torch.ops.paged_attention import paged_attention
    from ray_tpu_torch.scripts import chaos_soak
    from ray_tpu_torch.scripts import microbenchmark as mb

    r = {}
    # ---- (a)
    t0 = time.perf_counter()
    if not harness.card_probe(timeout=180):
        raise AssertionError("harness (a): card_probe() failed")
    r["probe_s"] = time.perf_counter() - t0
    print(f"harness (a): card_probe() ok in {r['probe_s']:.1f} s",
          flush=True)
    # ---- (b)
    t0 = time.perf_counter()
    r["groups"] = b = _harness_groups(torch, rt, mb, harness)
    b["seconds"] = time.perf_counter() - t0
    print("harness (b): the RL group is not run: the card's machine has "
          "no gymnasium (CartPole-v1)", flush=True)
    print(f"harness (b): {len(b['records'])} benchmarks at "
          f"{HARNESS_BUDGET_S} s a probe, all above 0, every guard held, "
          f"in {b['seconds']:.1f} s (" + ", ".join(
              f"{k} {v['seconds']:.1f} s" for k, v in b["groups"].items())
          + f"); the serve probe's replica launched K4 "
          f"{b['groups']['serve_group']['k4']} times; " + "; ".join(
              f"{x['benchmark']} {x['value']} {x['unit']}"
              for x in b["records"]) + f"; {card}", flush=True)
    # ---- (c)
    t0 = time.perf_counter()
    cfg = presets.llama3_8b(num_layers=HARNESS_PA_LAYERS,
                            dtype=torch.bfloat16)
    params = init_params(cfg, seed=0, device="cuda")
    paged_attention.launches = 0
    probe = mb.paged_lane_probe(HARNESS_PA_BUDGET_S, "cuda", cfg, params)
    launched = paged_attention.launches
    arms = probe["arms"]
    want = HARNESS_PA_LAYERS * arms["cuda"]["steps"]
    if (probe["inplace"] != "cuda" or arms["cuda"]["k4"] != want
            or arms["gather"]["k4"] != 0):
        raise AssertionError(f"harness (c): K4 {arms['cuda']['k4']} on "
                             f"'cuda' (want {want}), "
                             f"{arms['gather']['k4']} on 'gather'")
    if arms["cuda"]["first"].tolist() != arms["gather"]["first"].tolist():
        raise AssertionError("harness (c): the lanes' greedy tokens differ")
    r["paged"] = c = {
        "layers": HARNESS_PA_LAYERS, "steps": arms["cuda"]["steps"],
        "k4": arms["cuda"]["k4"], "k4_total": launched,
        "cuda_ms": arms["cuda"]["ms"], "gather_ms": arms["gather"]["ms"],
        "sweep": probe["sweep"], "first": arms["cuda"]["first"].tolist()}
    del params
    _free(torch)
    c["seconds"] = time.perf_counter() - t0
    print(f"harness (c): llama3_8b width, {HARNESS_PA_LAYERS} of 32 "
          f"layers, bf16, 8 slots x 128 live tokens on a 512-token arena "
          f"of 16-token pages: 'cuda' {c['cuda_ms']:.3f} ms a step, "
          f"'gather' {c['gather_ms']:.3f} ms a step (gather/cuda "
          f"{c['gather_ms'] / c['cuda_ms']:.2f}x); pool growth 8 -> 128 "
          f"pages a slot: gather {c['sweep']['gather']:.2f}x, cuda "
          f"{c['sweep']['cuda']:.2f}x; first tokens equal {c['first']}; "
          f"K4 {c['k4']} = {HARNESS_PA_LAYERS} x {c['steps']} on 'cuda', "
          f"0 on 'gather' ({launched} over the sweep too); "
          f"{c['seconds']:.1f} s; {card}", flush=True)
    # ---- (d)
    t0 = time.perf_counter()
    with harness.card_listed(2):
        d = chaos_soak.run_serve_chaos(HARNESS_CHAOS_SEED, device=None)
    d["seconds"] = time.perf_counter() - t0
    if not d["k4_launches"] or max(d["k4_launches"]) <= 0:
        raise AssertionError(f"harness (d): no live replica launched K4: "
                             f"{d['k4_launches']}")
    r["chaos"] = d
    _free(torch)
    print(f"harness (d): run_serve_chaos(seed={HARNESS_CHAOS_SEED}) on "
          f"the card listed twice: {d['burst_done']} of 24 burst requests "
          f"exact, {d['burst_errors']} clean errors, prefix hits "
          f"{d['prefix_hits']}, lane {d['attn_lane']!r}, K4 in the live "
          f"replicas {d['k4_launches']}; {d['seconds']:.1f} s; {card}",
          flush=True)
    return r


# ------------------------------------------------------------ sharded objects

SHARDED_B, SHARDED_S = 2, 1024   # the consumer's forward batch
SHARDED_FREE_S = 5.0             # (b): every holder empty after the drop
SHARDED_WORLD = 4                # (b): CPU ranks on a 2x2 mesh
SHARDED_K1 = dict(B=SHARDED_B, S=SHARDED_S, H=12, Hkv=12, D=64, causal=True)


def _sharded_seed():
    """gpt2_small at full size in float32 (compute and params), its
    weights drawn from a seed-0 generator on the CPU: the same bits in
    every process, on any device."""
    import torch

    from ray_tpu_torch import presets
    from ray_tpu_torch.models.transformer import init_params

    cfg = presets.gpt2_small(remat=False, dtype=torch.float32,
                             ce_chunk=2048)
    return cfg, init_params(cfg, 0, "cpu", param_dtype=torch.float32)


def _sharded_loss(torch, cfg, params) -> float:
    """The forward loss of a seeded B2 x S1024 batch under no_grad."""
    import numpy as np

    from ray_tpu_torch.models.transformer import loss_fn

    tokens = np.random.default_rng(23).integers(
        0, cfg.vocab_size, (SHARDED_B, SHARDED_S), dtype=np.int64)
    with torch.no_grad():
        loss, _ = loss_fn(cfg, params,
                          {"tokens": torch.from_numpy(tokens).to("cuda")})
    return float(loss)


def _ref_tree(refs, values):
    """``values`` (in leaf order) in the shape of the tree ``refs``."""
    from ray_tpu_torch.models.transformer import map_params

    it = iter(values)
    return map_params(lambda _p, _r: next(it), refs)


class ShardConsumer:
    """Phase 23's card consumer (``num_gpus=1``): gets every leaf of a tree
    of refs whole on its card, holds each against the seed's, and runs the
    forward loss through K1, counted in this process."""

    def __init__(self):
        self.cfg, self.seed = _sharded_seed()

    def run(self, refs):
        import torch
        from torch.distributed.tensor import DTensor

        import ray_tpu_torch as rt
        from ray_tpu_torch.models.transformer import _leaves
        from ray_tpu_torch.ops import flash_attention as fa

        flat = _leaves(refs)
        t0 = time.perf_counter()
        got = rt.get(flat, timeout=RT_TIMEOUT)
        torch.cuda.synchronize()
        fetch_s = time.perf_counter() - t0
        nbytes = sum(t.numel() * t.element_size() for t in got)
        devices = sorted({str(t.device) for t in got})
        whole = not any(isinstance(t, DTensor) for t in got)
        equal = sum(_bytes_equal(torch, t.cpu(), s)
                    for t, s in zip(got, _leaves(self.seed)))
        _reset_counters(fa)
        loss = _sharded_loss(torch, self.cfg, _ref_tree(refs, got))
        return {"fetch_s": fetch_s, "bytes": nbytes,
                "gb_s": nbytes / fetch_s / 1e9, "leaves": len(got),
                "equal_leaves": equal, "devices": devices, "whole": whole,
                "loss": loss,
                "launches": {f.__name__: f.launches for f in fa.KERNELS}}


class ShardRank:
    """Phase 23 (b)'s CPU rank (``num_gpus=0``): joins a gloo world, holds
    the seed's tree on the 2x2 ``("fsdp", "tp")`` mesh sharded by the
    port's rules, and puts every leaf (every rank does: a collective)."""

    def __init__(self):
        self.refs = None

    def join(self, rank: int, n: int, store: str) -> int:
        import datetime
        import os

        import torch.distributed as dist

        dist.init_process_group(
            "gloo", store=dist.FileStore(store, n), rank=rank, world_size=n,
            timeout=datetime.timedelta(seconds=RT_TIMEOUT))
        return os.getpid()

    def put_tree(self) -> dict:
        import ray_tpu_torch as rt
        from ray_tpu_torch.models.transformer import logical_axes, map_params
        from ray_tpu_torch.parallel.mesh import MeshSpec, build_mesh
        from ray_tpu_torch.parallel.sharding import param_specs, shard_params

        cfg, params = _sharded_seed()
        mesh = build_mesh(MeshSpec.of(fsdp=2, tp=2), device_type="cpu")
        placed = shard_params(params, mesh, specs=param_specs(
            params, mesh, logical=logical_axes(cfg)))
        del params
        t0 = time.perf_counter()
        self.refs = map_params(lambda _p, t: rt.put(t), placed)
        put_s = time.perf_counter() - t0
        sharded = []
        map_params(lambda _p, t: sharded.append(
            any(p.is_shard() for p in t.placements)), placed)
        return {"refs": self.refs, "put_s": put_s,
                "sharded_leaves": sum(sharded)}

    def held(self) -> int:
        from ray_tpu_torch._private import api as rt_api

        return len(rt_api._core.device_objects)

    def drop(self) -> None:
        import gc

        self.refs = None
        gc.collect()


def _k1_at_consumer_shape(torch) -> dict:
    """K1's float32 kernel at the consumer's shape against its plain
    version (the float32 gate), with its times, SDPA's and its bound."""
    import torch.nn.functional as F

    from ray_tpu_torch.ops import flash_attention as fa

    case = SHARDED_K1
    q, k, v, _ = flash_inputs(torch, case, torch.float32)
    o, _ = fa.flash_forward(q, k, v, causal=True)
    o_ref, _ = fa.flash_forward_reference(q, k, v, causal=True)
    gate = _gate("o", "float32")
    err, rel_l2, used = _gate_err(o, o_ref, "o", gate)
    if not (torch.isfinite(o).all() and used <= 1.0):
        raise AssertionError(f"sharded: K1 f32 at {case} uses {used:.3g} x "
                             f"its tolerance (max |err| {err:.3e})")
    qh, kh, vh = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    bounds = flash_bounds(case, "float32", 4)
    bound_ms, bound_by = bounds["fwd"]
    return {"max_abs_err": err, "rel_l2": rel_l2, "gate_used": used,
            "route": flash_routes(torch.float32, case["D"])["fwd"],
            "fma_bound_ms": bounds.get("fwd_fma", bounds["fwd"])[0],
            "ms": time_ms(torch, lambda: fa.flash_forward(q, k, v,
                                                          causal=True)),
            "plain_ms": time_ms(torch, lambda: fa.flash_forward_reference(
                q, k, v, causal=True), iters=5, warmup=1),
            "library_ms": time_ms(torch, lambda: (
                F.scaled_dot_product_attention(qh, kh, vh, is_causal=True))),
            "bound_ms": bound_ms, "bound_by": bound_by}


def _check_consumer(got: dict, want_loss: float, what: str) -> None:
    want = {"flash_forward": 12, "flash_dq": 0, "flash_dkv": 0}
    if (got["equal_leaves"] != got["leaves"] or got["devices"] != ["cuda:0"]
            or not got["whole"] or got["launches"] != want
            or got["loss"] != want_loss or not math.isfinite(got["loss"])):
        raise AssertionError(
            f"sharded {what}: {got['equal_leaves']} of {got['leaves']} "
            f"leaves bit-equal to the seed's, on {got['devices']} (whole "
            f"tensors: {got['whole']}), loss {got['loss']!r} against "
            f"{want_loss!r}, launches {got['launches']} (want {want})")


def sharded_phase(torch, card) -> dict:
    """Phase 23: sharded device objects (run after phase 22)."""
    import gc
    import os
    import tempfile

    import torch.distributed as dist
    from torch.distributed.tensor import DTensor

    import ray_tpu_torch as rt
    from ray_tpu_torch._private import api as rt_api
    from ray_tpu_torch._private import harness
    from ray_tpu_torch.models.transformer import (_leaves, logical_axes,
                                                  map_params)
    from ray_tpu_torch.ops import flash_attention as fa
    from ray_tpu_torch.parallel.mesh import MeshSpec, build_mesh
    from ray_tpu_torch.parallel.sharding import param_specs, shard_params

    r = {}
    with harness.card_listed(2):
        rt.init(num_cpus=8, num_gpus=2,
                object_store_memory=512 * 1024 * 1024)
    tmp = tempfile.TemporaryDirectory()
    try:
        # the actors start while this process draws its tree
        consumer = rt.remote(ShardConsumer).options(num_gpus=1).remote()
        ranks = [rt.remote(ShardRank).options(num_cpus=1, num_gpus=0)
                 .remote() for _ in range(SHARDED_WORLD)]
        joined = [a.join.remote(i, SHARDED_WORLD,
                                os.path.join(tmp.name, "gloo"))
                  for i, a in enumerate(ranks)]
        cfg, host = _sharded_seed()
        params = map_params(lambda _p, t: t.to("cuda"), host)
        del host
        # ---- (a): world 1 on the card, this process the owner
        t0 = time.perf_counter()
        dist.init_process_group(
            "nccl", store=dist.FileStore(os.path.join(tmp.name, "nccl"), 1),
            rank=0, world_size=1, device_id=torch.device("cuda", 0))
        try:
            mesh = build_mesh(MeshSpec.auto(1))
            placed = shard_params(params, mesh, specs=param_specs(
                params, mesh, logical=logical_axes(cfg)))
            core = rt_api._core
            held0 = len(core.device_objects)
            refs = map_params(lambda _p, t: rt.put(t), placed)
            flat = _leaves(refs)
            states = {core.objects[x._object_id].state for x in flat}
            stored = sum(core.in_process.get(x._object_id) is not None
                         for x in flat)
            mine = rt.get(flat, timeout=RT_TIMEOUT)
            same = sum(isinstance(m, DTensor)
                       and m.placements == p.placements
                       and str(m.to_local().device) == "cuda:0"
                       and _bytes_equal(torch, m.to_local(), p.to_local())
                       for m, p in zip(mine, _leaves(placed)))
            del mine
            if states != {"DEVICE"} or stored or same != len(flat):
                raise AssertionError(
                    f"sharded (a): entry states {states}, {stored} in the "
                    f"in-process store, {same} of {len(flat)} owner gets "
                    "DTensors bit-equal with the same placements on cuda:0")
            _reset_counters(fa)
            owner_loss = _sharded_loss(torch, cfg, params)
            owner_k1 = fa.flash_forward.launches
            a = rt.get(consumer.run.remote(refs), timeout=RT_TIMEOUT)
            _check_consumer(a, owner_loss, "(a)")
            a.update(owner_loss=owner_loss, owner_k1=owner_k1,
                     mesh=MeshSpec.auto(1).axes,
                     placements=str(placed["embed"]["table"].placements))
            del refs, flat, placed
            gc.collect()
            _wait("sharded (a): the owner's registry emptied",
                  lambda: len(core.device_objects) == held0,
                  SHARDED_FREE_S, 0.01)
        finally:
            dist.destroy_process_group()
        a["seconds"] = time.perf_counter() - t0
        r["a"] = a
        print(f"sharded (a): gpt2_small float32 as DTensors on "
              f"{a['mesh']} (embed table {a['placements']}), put leaf by "
              f"leaf: {a['leaves']} DEVICE entries, none in the in-process "
              f"store, the owner's gets bit-equal DTensors on cuda:0; the "
              f"card consumer fetched {a['bytes'] / 1e6:.1f} MB whole in "
              f"{a['fetch_s']:.3f} s ({a['gb_s']:.3f} GB/s), every leaf "
              f"bit-equal to the seed's; loss {a['loss']!r} bit-equal to "
              f"the owner's on the unsharded tree (B{SHARDED_B} x "
              f"S{SHARDED_S}, K1 f32), K1 {a['launches']['flash_forward']} "
              f"in the consumer; {a['seconds']:.1f} s; {card}", flush=True)
        # ---- (b): a gloo world of 4 CPU actors on a 2x2 mesh
        t0 = time.perf_counter()
        rt.get(joined, timeout=RT_TIMEOUT)
        puts = rt.get([x.put_tree.remote() for x in ranks],
                      timeout=RT_TIMEOUT)
        ids = {tuple(x._object_id.hex() for x in _leaves(p["refs"]))
               for p in puts}
        if len(ids) != 1:
            raise AssertionError("sharded (b): the ranks' puts returned "
                                 "refs to different objects")
        b = rt.get(consumer.run.remote(puts[0]["refs"]), timeout=RT_TIMEOUT)
        _check_consumer(b, a["loss"], "(b)")
        b.update(put_s=max(p["put_s"] for p in puts),
                 sharded_leaves=puts[0]["sharded_leaves"])
        del puts
        gc.collect()
        t1 = time.perf_counter()
        rt.get([x.drop.remote() for x in ranks], timeout=RT_TIMEOUT)
        _wait("sharded (b): every holder's registry empty",
              lambda: rt.get([x.held.remote() for x in ranks],
                             timeout=RT_TIMEOUT) == [0] * SHARDED_WORLD,
              SHARDED_FREE_S, 0.05)
        b["free_s"] = time.perf_counter() - t1
        b["seconds"] = time.perf_counter() - t0
        r["b"] = b
        print(f"sharded (b): a gloo world of {SHARDED_WORLD} CPU actors "
              f"on a 2x2 ('fsdp', 'tp') mesh, {b['sharded_leaves']} of "
              f"{b['leaves']} leaves sharded by shard_params, every rank "
              f"put every leaf ({b['put_s']:.2f} s); the card consumer "
              f"assembled {b['bytes'] / 1e6:.1f} MB from the 4 holders in "
              f"{b['fetch_s']:.3f} s ({b['gb_s']:.3f} GB/s), every leaf "
              f"bit-equal to the seed's; loss {b['loss']!r} bit-equal to "
              f"(a)'s, K1 {b['launches']['flash_forward']}; every holder "
              f"empty {b['free_s']:.2f} s after the drop; "
              f"{b['seconds']:.1f} s; {card}", flush=True)
        del params
    finally:
        rt.shutdown()
        tmp.cleanup()
    _free(torch)
    r["k1"] = k1 = _k1_at_consumer_shape(torch)
    print(f"sharded K1: float32 at B{SHARDED_B} S{SHARDED_S} H12 D64 "
          f"causal, max |err| {k1['max_abs_err']:.3e} ({k1['gate_used']:.3g}"
          f" of the float32 gate), {k1['ms']:.4f} ms on the "
          f"{k1['route']} (plain {k1['plain_ms']:.4f}, sdpa "
          f"{k1['library_ms']:.4f}, bound {k1['bound_ms']:.4f} "
          f"{k1['bound_by']}, at the FMA peak {k1['fma_bound_ms']:.4f}); "
          f"{card}", flush=True)
    return r


def preflight_line() -> dict:
    """What the port's ``reap_all()`` swept before the run, and whether
    pyarrow, pandas and gymnasium import here (and their versions)."""
    from ray_tpu_torch._private.reaper import reap_all

    swept = reap_all()
    code = ("import importlib, json\nout = {}\n"
            "for m in ('pyarrow', 'pandas', 'gymnasium'):\n"
            "    try:\n"
            "        out[m] = importlib.import_module(m).__version__\n"
            "    except Exception as e:\n"
            "        out[m] = None\n"
            "print(json.dumps(out))\n")
    mods = json.loads(subprocess.run(
        [sys.executable, "-c", code], check=True, capture_output=True,
        text=True, timeout=300).stdout.strip().splitlines()[-1])
    r = {"reaped": swept, "modules": mods}
    print("preflight: reap_all() swept " + json.dumps(swept) + "; "
          + ", ".join(f"{m} {v}" if v else f"{m} absent"
                      for m, v in mods.items()), flush=True)
    return r


def cache_bytecode() -> None:
    """Write and read Python's bytecode under ``build/pycache``, here and
    in every process this script starts (they inherit the environment).
    Where ``PYTHONDONTWRITEBYTECODE`` is set and the installed packages
    carry no bytecode, each of the script's dozens of processes would
    otherwise compile torch's sources anew."""
    import os

    prefix = str(ROOT / "build" / "pycache")
    os.environ.pop("PYTHONDONTWRITEBYTECODE", None)
    os.environ["PYTHONPYCACHEPREFIX"] = prefix
    sys.dont_write_bytecode = False
    sys.pycache_prefix = prefix


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    if not (ROOT / "ray_tpu_torch" / "csrc" / "paged_attention.cu").exists():
        print("chip_smoke: run it from a checkout of the repository "
              "(ray_tpu_torch/ is missing)", file=sys.stderr)
        return 2
    cache_bytecode()
    sys.path.insert(0, str(ROOT))
    from ray_tpu_torch._private.device import resolve_device

    resolve_device()  # TF32 off
    t_start = time.perf_counter()
    phase_s = {}  # each phase's seconds on the host clock, for the budget

    def timed(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        phase_s[name] = time.perf_counter() - t0
        print(f"phase {name}: {phase_s[name]:.1f} s", flush=True)
        return out

    card = card_line()
    preflight = preflight_line()
    build = timed("build", build_phase)
    kern = timed("kernel", kernel_phase, torch)
    flash = timed("flash", flash_kernel_phase, torch)
    serve = timed("serve", serve_phase, torch)
    _free(torch)
    serve_cut = timed("serve_cut", serve_phase, torch, CUT_OVERRIDES)
    _free(torch)
    spec_serve = timed("spec_serve", spec_serve_phase, torch, card,
                       serve["texts"])
    _free(torch)
    lanes = timed("serve_lanes", serve_lanes_phase, torch,
                  serve_cut["texts"])
    _free(torch)
    runtime = timed("runtime", runtime_phase, torch, serve_cut)
    _free(torch)
    serve_app = timed("serve_app", serve_app_phase, torch, serve_cut,
                      runtime)
    parity = timed("parity", parity_phase, torch)
    train = timed("train", train_phase, torch)
    train_parity = timed("train_parity", train_parity_phase, torch)
    dp_train = timed("dp_train", dp_train_phase, torch, train,
                     serve_app["llama3_8b"]["push_weights"])
    pipeline = timed("pipeline", pipeline_phase, torch)
    tune_r = timed("tune", tune_phase, torch, train, dp_train)
    dag = timed("dag", dag_phase, torch, tune_r)
    _free(torch)
    autoscale = timed("autoscale", autoscale_phase, torch, card)
    _free(torch)
    data = timed("data", data_phase, torch, train, dp_train)
    _free(torch)
    rl = timed("rl", rl_phase, torch)
    rl_more = timed("rl_more", rl_more_phase, torch)
    _free(torch)
    mesh = timed("mesh", mesh_phase, torch, card)
    _free(torch)
    harness = timed("harness", harness_phase, torch, card)
    _free(torch)
    sharded = timed("sharded", sharded_phase, torch, card)
    print("phase seconds: " + json.dumps(
        {k: round(v, 1) for k, v in phase_s.items()}), flush=True)
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
    # in Tune's trial processes (phase 15 (a), all trials together) and in
    # the compiled graph's card actor (phase 16 (b))
    for suffix, counts in (("tune_trial", tune_r["asha"]["launches"]),
                           ("compiled_dag", dag["compiled"]["launches"])):
        for name in ("fwd", "dq", "dkv"):
            base = next(k for k in kernels["kernels"]
                        if k["name"] == f"flash_attention_{name}")
            kernels["kernels"].append(dict(
                base, name=f"flash_attention_{name}_{suffix}",
                launches=counts[{"fwd": "flash_forward", "dq": "flash_dq",
                                 "dkv": "flash_dkv"}[name]]))
    # K1 in the autoscaled node's processes (phase 17): the pool's two
    # scorers together, and the job's card task
    base = next(k for k in kernels["kernels"]
                if k["name"] == "flash_attention_fwd")
    for suffix, counts in (("actor_pool", autoscale["pool"]["launches"]),
                           ("job", autoscale["job"]["task"]["launches"])):
        kernels["kernels"].append(dict(
            base, name=f"flash_attention_fwd_{suffix}",
            launches=counts["flash_forward"]))
    # in this process fed by the streaming and exchange executors (phase
    # 18 (a)), and in TorchTrainer's worker fed by its dataset shard (b)
    for suffix, counts in (("data_feed", data["feed"]["launches"]),
                           ("data_ingest", data["ingest"]["launches"])):
        for name in ("fwd", "dq", "dkv"):
            base = next(k for k in kernels["kernels"]
                        if k["name"] == f"flash_attention_{name}")
            kernels["kernels"].append(dict(
                base, name=f"flash_attention_{name}_{suffix}",
                launches=counts[{"fwd": "flash_forward", "dq": "flash_dq",
                                 "dkv": "flash_dkv"}[name]]))
    # the mesh train step's (phase 21 (a)): gpt2_small through DTensor
    # params on a world-1 mesh
    for name in ("fwd", "dq", "dkv"):
        base = next(k for k in kernels["kernels"]
                    if k["name"] == f"flash_attention_{name}")
        kernels["kernels"].append(dict(
            base, name=f"flash_attention_{name}_mesh",
            launches=mesh["mesh"]["launches"][{
                "fwd": "flash_forward", "dq": "flash_dq",
                "dkv": "flash_dkv"}[name]]))
    # K4 through the harness scripts (phase 22): the paged-lane probe's
    # "cuda" arm at llama3_8b width in bf16 (c); in float32 (llama_debug,
    # timed at its own decode shape in the serve probe, D 16), the
    # microbenchmark's serve probe in this process (b) and the serve chaos
    # run's live replicas (d)
    kernels["kernels"].append(dict(
        kernels["kernels"][0], name="paged_attention_harness_paged_lane",
        launches=harness["paged"]["k4"]))
    case = kern["decode_d16_float32"]
    for suffix, n in (
            ("harness_serve_probe",
             harness["groups"]["groups"]["serve_group"]["k4"]),
            ("harness_serve_chaos", sum(harness["chaos"]["k4_launches"]))):
        kernels["kernels"].append(dict(
            kernels["kernels"][0], name=f"paged_attention_f32_{suffix}",
            launches=n, **{k: case[k] for k in (
                "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                "library_ms")}))
    # K1's float32 kernel in phase 23's card consumer, which ran
    # gpt2_small's forward on the tree it fetched through the object layer:
    # (a) from this process's world-1 mesh, (b) from the CPU world's 2x2
    k1 = sharded["k1"]
    kernels["kernels"].append({
        "name": "flash_attention_fwd_f32_sharded_objects",
        "route": "cuda",
        "source": "ray_tpu_torch/csrc/flash_attention.cu",
        "replaces": "ray_tpu/ops/flash_attention.py:103",
        "launches": sum(sharded[x]["launches"]["flash_forward"]
                        for x in ("a", "b")),
        **{k: k1[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                              "bound_by", "library_ms")}})
    # the float32 K1, K2 and K3 (FMA at D=16) that train parity's card runs
    # launch, timed at that shape; SDPA's backward is K2's and K3's
    # yardstick together
    small = flash["train_parity_shape_float32"]
    for key, line, err in (
            ("fwd", 103, small["o_max_abs_err"]),
            ("dq", 203, small["dq_max_abs_err"]),
            ("dkv", 239, max(small["dk_max_abs_err"],
                             small["dv_max_abs_err"]))):
        wrapper = {"fwd": "flash_forward", "dq": "flash_dq",
                   "dkv": "flash_dkv"}[key]
        kernels["kernels"].append({
            "name": f"flash_attention_{key}_f32_train_parity",
            "route": "cuda",
            "source": "ray_tpu_torch/csrc/flash_attention.cu",
            "replaces": f"ray_tpu/ops/flash_attention.py:{line}",
            "launches": sum(x["launches"][wrapper]
                            for x in train_parity.values()),
            "max_abs_err": err,
            **{k: small[f"{key}_{k}"] for k in (
                "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")}})
    detail = {"card": card, "preflight": preflight, "build": build,
              "kernel": kern, "flash": flash, "serve": serve,
              "serve_cut": serve_cut, "spec_serve": spec_serve,
              "serve_lanes": lanes, "runtime": runtime,
              "serve_app": serve_app, "parity": parity,
              "train": train,
              "train_parity": train_parity, "dp_train": dp_train,
              "pipeline": pipeline, "tune": tune_r, "dag": dag,
              "autoscale": autoscale, "data": data, "rl": rl,
              "rl_more": rl_more, "mesh": mesh, "harness": harness,
              "sharded": sharded,
              "phase_seconds": phase_s,
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
