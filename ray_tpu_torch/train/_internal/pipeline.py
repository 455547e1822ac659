"""MPMD pipeline-parallel training: interleaved 1F1B over channels.

Counterpart: ``ray_tpu/train/_internal/pipeline.py``. Reproduces the
topology of "Scaling Deep Learning Training with MPMD Pipeline
Parallelism" (arXiv:2412.14374) on this framework's channels: S stage
actors own model shards, forward activations and backward gradients flow
stage-to-stage through compiled-graph channels (``_private/channels.py``:
pin-backed seqlock slot rings, NOT the object store), and each stage's
long-running run loop executes an EAGER 1F1B microbatch schedule: backward
as soon as its gradient is committed (gradients still accumulate per chunk
in microbatch order, so numerics are deterministic), otherwise forwards
ahead bounded by the channel depth. Optional intra-stage data parallelism
rides the collective layer: dp replicas of every stage sync their
accumulated gradients with one ``allreduce_coalesced_async(op=MEAN)`` at
flush.

In PyTorch terms, a chunk's forward runs under ``torch.no_grad()`` and
stashes its INPUT; its backward runs the forward again with grad on and
calls ``torch.autograd.grad`` with the cotangent (full-remat 1F1B: the
stash is one input per in-flight microbatch), adding the param grads into
a float32 accumulator. A stage actor runs on its card when its
``stage_options`` entry gives it ``num_gpus >= 1`` (the default), on the
CPU only when that entry says ``num_gpus=0``; a stage that asked for a
card and sees none raises. Activations and cotangents cross the channels
as CPU tensors in ``cfg.dtype`` (bfloat16 as its bytes, never widened),
and the reader moves them onto its own device, so a stage on the CPU and
a stage on the card make one pipeline. ``fetch_params`` returns CPU
tensors.

Interleaved virtual stages (``virtual_stages=V`` > 1): each stage actor
owns V NON-CONTIGUOUS model chunks (stage s owns chunks s, s+S, s+2S, ...
of the S*V-chunk pipeline) and the channel plan grows per-chunk act/grad
edges between the SAME S actors. The 1F1B bubble scales as (S-1)/(V*M)
instead of (S-1)/M. V=1 executes the one-chunk schedule (same code path).

Fused in-bucket optimizer (``fused_flush``, default on, dp > 1): the
flush's coalesced-mean allreduce carries an ``on_bucket`` completion
callback, and each stage applies a per-bucket optimizer update (against
pre-split per-bucket optimizer state) the moment that bucket's reduce
lands, overlapped with the remaining buckets' rounds. Per-bucket apply is
exact for leafwise optimizers (sgd/adam families); pass
``fused_flush=False`` for optimizers with cross-leaf state (e.g. the
global-norm clip of ``models.training.AdamW``), which is also the
measured unfused baseline.

A steady flush issues ZERO control-plane RPCs per stage rank, proven via
``ray_tpu_rpc_client_calls_total`` deltas carried in each stage's
per-flush report. Channel depth defaults to ``max(2, min(S*V + 1, M))``.
Teardown or any participant's death closes every channel, blocked peers
raise ``ChannelClosedError`` instead of hanging, and the per-flush
gradient state is discarded: a broken pipeline can produce an error,
never a wrong loss.

``mode="tasks"`` runs the SAME chunk math as dynamic actor tasks through
the object store (per-microbatch per-chunk ``.remote()`` calls): the
baseline and a debugging aid, not a fallback.
"""

from __future__ import annotations

import dataclasses
import logging
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ray_tpu_torch._private import channels as _channels
from ray_tpu_torch._private import chaos, flight, serialization
from ray_tpu_torch._private.exceptions import ChannelClosedError
from ray_tpu_torch._private.metrics import Counter, Gauge, Histogram
from ray_tpu_torch.models.transformer import _leaves, map_params

logger = logging.getLogger(__name__)

# flight-recorder span ids (per-thread ring records, zero RPCs)
_F_FWD = flight.intern("pipe.fwd")
_F_BWD = flight.intern("pipe.bwd")
_F_FLUSH = flight.intern("pipe.flush")
_F_OPT = flight.intern("pipe.opt")
_F_DP = flight.intern("pipe.dp_allreduce")
_F_BUBBLE = flight.intern("pipe.bubble_bp")
_F_TPTAIL = flight.intern("pipe.tp_tail_wait")

_m_microbatches = Counter(
    "ray_tpu_pipeline_microbatches_total",
    "Pipeline chunk-microbatches processed (M per chunk per flush, so "
    "M*V per flush at virtual_stages=V), by stage rank")
_m_flushes = Counter(
    "ray_tpu_pipeline_flushes_total",
    "Pipeline flushes (optimizer steps) completed, by stage rank")
_m_stage_seconds = Histogram(
    "ray_tpu_pipeline_stage_step_seconds",
    "Per-stage wall seconds for one flush (M microbatches + optimizer)")
_m_bubble = Gauge(
    "ray_tpu_pipeline_bubble_fraction",
    "Fraction of the last flush a stage spent blocked on channel "
    "waits (the pipeline bubble, measured not estimated)")
_m_fused_applies = Counter(
    "ray_tpu_pipeline_fused_bucket_applies_total",
    "Fused in-bucket optimizer applies (one update per landed allreduce "
    "bucket, overlapped with the remaining buckets' rounds), by stage "
    "rank")


@dataclasses.dataclass
class StageSpec:
    """One pipeline chunk's model shard as pure, PICKLABLE callables
    (module-level functions / functools.partial: they ship to the stage
    actor). Chunks 0..C-2 define ``fwd``; the last chunk defines
    ``loss``.

      init()                  -> params tree of CPU tensors (this shard)
      fwd(params, x)          -> y activations (differentiable in both)
      loss(params, x, labels) -> scalar loss (differentiable in p and x)

    Tensor-parallel chunks (``tp`` > 1, e.g. from
    ``pipeline_stage_defs(cfg, S, tensor_parallel=tp)``) additionally
    accept ``init(tp_rank=...)`` (this rank's Megatron column/row shard)
    and ``fwd/loss(..., tp_ops=(g, f))``, the partial-sum reduce pair the
    trainer binds to this rank's per-(stage, dp) tp group. With
    ``tp_tail`` the fwd returns the last block's ``(u, mlp_partial)``
    pair instead of the finished activation; the run loop completes
    ``u + allreduce(mlp_partial)``, asynchronously when the next
    scheduled op allows overlap.
    """

    init: Callable[[], Any]
    fwd: Optional[Callable[[Any, Any], Any]] = None
    loss: Optional[Callable[[Any, Any, Any], Any]] = None
    tp: int = 1
    tp_tail: bool = False


def _as_stage_spec(obj) -> StageSpec:
    if isinstance(obj, StageSpec):
        return obj
    if isinstance(obj, dict):
        return StageSpec(init=obj["init"], fwd=obj.get("fwd"),
                         loss=obj.get("loss"), tp=int(obj.get("tp", 1)),
                         tp_tail=bool(obj.get("tp_tail", False)))
    raise TypeError(f"not a stage spec: {obj!r}")


@dataclasses.dataclass
class _StagePlan:
    """Wire-shippable channel plan for one stage actor's run loop. The
    act/grad entries are PER LOCAL CHUNK (index v, global chunk
    s + v*S): act_in[v] is None for global chunk 0 (which reads
    ``in_spec``), act_out[v]/grad_in[v] are None for the last global
    chunk (loss: nothing downstream), grad_out[v] is None for global
    chunk 0 (raw data upstream)."""

    in_spec: Optional[_channels.ChannelSpec]  # driver -> stage 0
    label_spec: Optional[_channels.ChannelSpec]  # driver -> last stage
    act_in: List[Optional[_channels.ChannelSpec]]  # chunk c-1 -> c
    act_out: List[Optional[_channels.ChannelSpec]]  # chunk c -> c+1
    grad_in: List[Optional[_channels.ChannelSpec]]  # chunk c+1 -> c
    grad_out: List[Optional[_channels.ChannelSpec]]  # chunk c -> c-1
    report: _channels.ChannelSpec  # stage s -> driver, one per flush


# ------------------------------------------------------------ wire values


def _to_wire(value):
    """A chunk's output or input gradient as it crosses a channel or the
    object store: a contiguous CPU tensor in its own dtype."""
    return value.detach().to("cpu").contiguous()


def _on_device(value, device: torch.device) -> torch.Tensor:
    """A received value (CPU tensor or numpy array) on ``device``."""
    if isinstance(value, np.ndarray):
        value = torch.from_numpy(np.array(value))
    return value.to(device)


def _copy_tree(value):
    """Copy array/tensor leaves out of the shared arena so the channel
    can be acked (and the writer may overwrite) while the value lives
    on."""
    if isinstance(value, np.ndarray):
        return np.array(value)
    if isinstance(value, torch.Tensor):
        return value.clone()
    if isinstance(value, dict):
        return {k: _copy_tree(v) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return type(value)(_copy_tree(v) for v in value)
    return value


def _host_params(tree):
    return map_params(lambda _p, t: t.detach().to("cpu", copy=True), tree)


# --------------------------------------------------------------- stage math


class _ChunkRuntime:
    """One model chunk's compute state: the shard params on the stage's
    device (leaves with ``requires_grad``), the forward, the backward
    (which runs the chunk forward again from the stashed INPUT: full-remat
    1F1B, so the stash is one input per in-flight microbatch) and the
    float32 gradient accumulator."""

    def __init__(self, spec: StageSpec, chunk: int, num_chunks: int,
                 tp_rank: int = 0, tp_ops=None, device="cpu"):
        import functools

        self.spec = spec
        self.chunk = int(chunk)
        self.first = self.chunk == 0
        self.last = self.chunk == int(num_chunks) - 1
        self.tp = int(getattr(spec, "tp", 1) or 1)
        self.device = torch.device(device)
        # tail chunks end on the last block's (u, mlp_partial) pair: the
        # run loop completes u + allreduce(mp) so the reduce can overlap
        # the NEXT microbatch's compute
        self.tail = bool(spec.tp_tail) and self.tp > 1 and not self.last
        if self.tp > 1:
            init_fn = functools.partial(spec.init, tp_rank=int(tp_rank))
            fwd_fn = (functools.partial(spec.fwd, tp_ops=tp_ops)
                      if spec.fwd is not None else None)
            loss_fn = (functools.partial(spec.loss, tp_ops=tp_ops)
                       if spec.loss is not None else None)
        else:
            init_fn, fwd_fn, loss_fn = spec.init, spec.fwd, spec.loss
        if self.last and loss_fn is None:
            raise ValueError(
                f"chunk {chunk} is the last of {num_chunks} and needs "
                f"a loss callable")
        if not self.last and fwd_fn is None:
            raise ValueError(f"chunk {chunk} needs a fwd callable")
        self._fwd, self._loss = fwd_fn, loss_fn
        self.params = map_params(
            lambda _p, t: t.detach().to(self.device).requires_grad_(True),
            init_fn())
        self.leaves = _leaves(self.params)
        self._stash: Dict[int, Any] = {}
        self.acc: Optional[List[torch.Tensor]] = None
        self.losses: List[float] = []

    def _accumulate(self, grads) -> None:
        grads = [torch.zeros_like(p) if g is None else g.float()
                 for g, p in zip(grads, self.leaves)]
        if self.acc is None:
            self.acc = grads
        else:
            torch._foreach_add_(self.acc, grads)

    def forward(self, m: int, x) -> Any:
        """Non-last chunks: y = fwd(params, x) without grad; stash x for
        the backward recompute."""
        with torch.no_grad():
            y = self._fwd(self.params, x)
        self._stash[m] = x
        return y

    def loss_backward(self, x, labels) -> Tuple[float, Any]:
        """Last chunk only: loss + grads (+ accumulation) in one pass
        (fwd and bwd of the last chunk are adjacent in 1F1B, so there is
        nothing to stash)."""
        xg = x.detach().requires_grad_(True)
        with torch.enable_grad():
            loss = self._loss(self.params, xg, labels)
            grads = torch.autograd.grad(loss, self.leaves + [xg],
                                        allow_unused=True)
        self._accumulate(grads[:-1])
        value = float(loss.detach())
        self.losses.append(value)
        return value, grads[-1]

    def backward(self, m: int, gy) -> Any:
        """Run this chunk's forward again from the stashed input, take the
        vjp with ``gy``, fold the param grads into the accumulator;
        returns the input gradient (None at chunk 0)."""
        x = self._stash.pop(m)
        xg = x if self.first else x.detach().requires_grad_(True)
        inputs = self.leaves if self.first else self.leaves + [xg]
        with torch.enable_grad():
            y = self._fwd(self.params, xg)
            # tail chunks emit (u, mp) with y = u + allreduce(mp): dy/du is
            # the identity and the allreduce is identity in its backward
            # (the g rule), so gy enters BOTH outputs
            outs, cots = ((y[0], y[1]), (gy, gy)) if self.tail else \
                ((y,), (gy,))
            grads = torch.autograd.grad(outs, inputs, cots,
                                        allow_unused=True)
        if self.first:
            self._accumulate(grads)
            return None
        self._accumulate(grads[:-1])
        return grads[-1]


def _make_optimizer(optimizer):
    """``("sgd", lr)`` -> ``models.training.SGD(lr)``; a callable is a
    factory of an object with ``init(params)`` and ``update(grads, state,
    params)`` applied in place (``models.training.AdamW``'s shape)."""
    if callable(optimizer):
        return optimizer()
    kind, lr = optimizer
    if kind != "sgd":
        raise ValueError(f"unknown optimizer {kind!r}")
    from ray_tpu_torch.models.training import SGD

    return SGD(lr)


def _grad_like(value, param: torch.Tensor) -> torch.Tensor:
    return _on_device(value, param.device).to(param.dtype)


def _place_tree(tree, device):
    """Tensors of a received state tree (dicts, lists, tuples,
    dataclasses) moved onto ``device``."""
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    if isinstance(tree, dict):
        return {k: _place_tree(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_place_tree(v, device) for v in tree)
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{
            f.name: _place_tree(getattr(tree, f.name), device)
            for f in dataclasses.fields(tree)})
    return tree


class _StageRuntime:
    """One stage actor's compute state: V chunk runtimes (local index v
    owns global chunk stage + v*S), the optimizer, and the flush."""

    def __init__(self, specs: Sequence[StageSpec], stage: int,
                 num_stages: int, virtual_stages: int,
                 num_microbatches: int, optimizer, dp: int, dp_rank: int,
                 group_name: str, fused_flush: bool = True,
                 flush_bucket_bytes: Optional[int] = None,
                 declarative_group: bool = False, tp: int = 1,
                 tp_rank: int = 0, tp_group: Optional[str] = None,
                 tp_tail_group: Optional[str] = None,
                 tp_overlap: bool = True, device="cpu"):
        from ray_tpu_torch._private.device import resolve_device

        self.stage = int(stage)
        self.S = int(num_stages)
        self.V = int(virtual_stages)
        self.M = int(num_microbatches)
        self.dp = int(dp)
        self.dp_rank = int(dp_rank)
        self.group_name = group_name
        if torch.device(device).type == "cuda" and \
                not torch.cuda.is_available():
            raise RuntimeError(
                f"pipeline stage {stage} asked for a card (num_gpus >= 1) "
                f"but this worker sees none; give it num_gpus=0 in "
                f"stage_options to run it on the CPU")
        self.device = resolve_device(device)
        # elastic trainers declare the dp group driver-side: members
        # resolve their rank lazily on the first op and re-rendezvous at
        # the new generation after a resize
        self._declarative = bool(declarative_group)
        self._group_ready = False
        # ---- tensor parallelism (tp x dp x pp): this rank holds each
        # chunk's 1/tp Megatron shard; the partial-sum reduces go through
        # the (g, f) pair bound here against the per-(stage, dp-rank) tp
        # group. The reduces carry no tags: EXECUTION ORDER IS THE MATCH,
        # which is why tp > 1 runs the deterministic static schedule
        # (run_flush_tp), never the timing-dependent ready()-probing loops
        self.tp = int(tp)
        self.tp_rank = int(tp_rank)
        self.tp_group = tp_group
        self.tp_tail_group = tp_tail_group
        self.tp_overlap = bool(tp_overlap)
        self._tp_reduce_calls = 0  # lifetime; reports carry deltas
        tp_ops = None
        if self.tp > 1:
            if not tp_group or not tp_tail_group:
                raise ValueError(
                    f"stage {stage}: tp={tp} needs tp_group and "
                    f"tp_tail_group collective group names")
            from ray_tpu_torch.util.collective.tp import make_tp_reduce_ops

            def _tp_reduce(arr):
                from ray_tpu_torch.util import collective as col
                from ray_tpu_torch.util.collective.types import ReduceOp

                self._tp_reduce_calls += 1
                return col.allreduce(arr, group_name=self.tp_group,
                                     op=ReduceOp.SUM)

            tp_ops = make_tp_reduce_ops(_tp_reduce)
        C = self.S * self.V
        self.chunks = [
            _ChunkRuntime(spec, self.stage + v * self.S, C,
                          tp_rank=self.tp_rank, tp_ops=tp_ops,
                          device=self.device)
            for v, spec in enumerate(specs)]
        self.first = self.chunks[0].first  # global chunk 0 lives here
        self.last = self.chunks[-1].last  # the loss chunk lives here
        self._optimizer = optimizer
        self._fused = bool(fused_flush)
        self._bucket_bytes = flush_bucket_bytes
        self._opt = None
        self._opt_state = None
        self._fused_buckets: Optional[Dict[tuple, dict]] = None
        self._fused_applies = 0  # lifetime count; reports carry deltas

    # -- per-microbatch (chunk-indexed); inputs arrive as CPU values

    def forward(self, v: int, m: int, x) -> Any:
        return self.chunks[v].forward(m, _on_device(x, self.device))

    def loss_backward(self, v: int, x, labels) -> Tuple[float, Any]:
        return self.chunks[v].loss_backward(_on_device(x, self.device),
                                            labels)

    def backward(self, v: int, m: int, gy) -> Any:
        return self.chunks[v].backward(m, _on_device(gy, self.device))

    def param_leaves(self) -> List[torch.Tensor]:
        return [p for ck in self.chunks for p in ck.leaves]

    # -- tail reduce (tp > 1): the last block's mlp partial sum rides a
    # SEPARATE collective group from the in-block reduces, so a pending
    # async tail reduce is never mis-paired with the next microbatch's
    # reduce sequence

    def tail_reduce_async(self, mp):
        """Start the tail partial's allreduce on the runner thread and
        return the CollectiveWork handle: the caller overlaps it with the
        next microbatch's forward compute."""
        from ray_tpu_torch.util import collective as col
        from ray_tpu_torch.util.collective.types import ReduceOp

        self._tp_reduce_calls += 1
        return col.allreduce_coalesced_async(
            [mp], group_name=self.tp_tail_group, op=ReduceOp.SUM)

    def tail_combine(self, u, work, timeout_ms: int = 120_000):
        """Finish y = u + allreduce(mp): wait for the tail reduce and
        add the (replicated-exact) sum onto the residual stream."""
        (reduced,) = work.wait(timeout_ms)
        return u + _on_device(reduced, u.device)

    # -- flush

    def _ensure_group(self) -> None:
        if self._declarative:
            # driver-declared group: ops resolve membership from the
            # declarative KV record (current generation) on demand
            return
        if self.dp > 1 and not self._group_ready:
            from ray_tpu_torch.util import collective as col

            col.init_collective_group(
                self.dp, self.dp_rank, backend="host",
                group_name=self.group_name)
            self._group_ready = True

    def _ensure_opt(self) -> None:
        if self._opt is not None:
            return
        self._opt = _make_optimizer(self._optimizer)
        self._opt_state = self._opt.init(
            [ck.params for ck in self.chunks])

    def _resolved_bucket_bytes(self) -> int:
        if self._bucket_bytes is not None:
            return int(self._bucket_bytes)
        from ray_tpu_torch.util.collective.collective import \
            _default_bucket_bytes

        return _default_bucket_bytes()

    def _ensure_fused_opt(self, grad_leaves: List[Any]) -> None:
        """Pre-split the optimizer per coalesced bucket: the layout is a
        pure function of the (fixed) gradient tree + bucket size, so this
        runs once: one optimizer + state per bucket, each over just that
        bucket's param leaves."""
        if self._fused_buckets is not None:
            return
        from ray_tpu_torch.util.collective.async_work import bucket_layout

        params_leaves = self.param_leaves()
        table: Dict[tuple, dict] = {}
        for bucket in bucket_layout(grad_leaves,
                                    self._resolved_bucket_bytes()):
            opt = _make_optimizer(self._optimizer)
            plist = [params_leaves[i] for i in bucket]
            table[tuple(bucket)] = {"opt": opt, "state": opt.init(plist)}
        self._fused_buckets = table

    def _fused_reduce_apply(self, leaves: List[Any],
                            timeout_ms: int) -> None:
        """dp allreduce with the optimizer FUSED into the buckets: the
        per-bucket completion callback hands each landed bucket to this
        thread, which applies that bucket's optimizer update while the
        runner reduces the remaining buckets. The handoff is a queue put,
        NOT the apply itself: the callback runs on the collective reducer
        thread, which is in lockstep with the peer ranks' rounds, and an
        apply there would sit in EVERY rank's reduce critical path."""
        import queue as _queue

        from ray_tpu_torch.util import collective as col
        from ray_tpu_torch.util.collective.types import ReduceOp

        self._ensure_fused_opt(leaves)
        params_leaves = self.param_leaves()
        table = self._fused_buckets
        stage_label = {"stage": str(self.stage)}
        handoff: "_queue.Queue" = _queue.Queue()

        def on_bucket(indices, arrays):
            # the runner's fresh per-bucket copies: safe across threads
            handoff.put((list(indices), list(arrays)))

        work = col.allreduce_coalesced_async(
            leaves, group_name=self.group_name, op=ReduceOp.MEAN,
            timeout_ms=timeout_ms,
            bucket_bytes=self._resolved_bucket_bytes(),
            on_bucket=on_bucket)
        deadline = time.monotonic() + timeout_ms / 1000.0
        applied: set = set()
        while len(applied) < len(table):
            try:
                indices, arrays = handoff.get(timeout=0.05)
            except _queue.Empty:
                if work.done() and work.exception() is not None:
                    raise work.exception()
                if time.monotonic() > deadline:
                    work.wait(0)  # surfaces the collective's own error
                    raise TimeoutError(
                        f"stage {self.stage}: fused flush timed out with "
                        f"{len(table) - len(applied)} buckets unapplied")
                continue
            entry = table[tuple(indices)]
            plist = [params_leaves[i] for i in indices]
            entry["opt"].update(
                [_grad_like(a, p) for a, p in zip(arrays, plist)],
                entry["state"], plist)
            applied.add(tuple(indices))
            self._fused_applies += 1
            _m_fused_applies.inc(labels=stage_label)
        work.wait(timeout_ms)  # instant: every bucket already landed
        if sum(len(k) for k in applied) != len(leaves):
            raise RuntimeError(
                "fused flush finished with unapplied buckets "
                "(bucket-layout mismatch between ranks?)")

    def flush(self, timeout_ms: int = 120_000) -> Dict[str, Any]:
        """Average the accumulated grads over M microbatches (and the dp
        replica group when dp > 1), apply the optimizer, reset."""
        applies_before = self._fused_applies
        for ck in self.chunks:
            if ck._stash:
                raise RuntimeError(
                    f"stage {self.stage} chunk {ck.chunk}: flush with "
                    f"{len(ck._stash)} unconsumed activation stashes "
                    f"(schedule bug)")
            if ck.acc is None:
                raise RuntimeError(
                    f"stage {self.stage} chunk {ck.chunk}: flush with "
                    f"no grads")
        grads = [g for ck in self.chunks for g in ck.acc]
        for ck in self.chunks:
            ck.acc = None
        torch._foreach_mul_(grads, 1.0 / self.M)
        if self.dp > 1:
            from ray_tpu_torch.util import collective as col
            from ray_tpu_torch.util.collective.types import ReduceOp

            self._ensure_group()
            t0 = flight.now()
            if self._fused:
                self._fused_reduce_apply(grads, timeout_ms)
                flight.span_since(_F_DP, t0)
                return self._flush_stats(applies_before)
            # same bucket granularity as the fused path, so the two
            # flush modes differ ONLY in where the optimizer runs
            work = col.allreduce_coalesced_async(
                grads, group_name=self.group_name, op=ReduceOp.MEAN,
                timeout_ms=timeout_ms,
                bucket_bytes=self._resolved_bucket_bytes())
            reduced = work.wait(timeout_ms)
            flight.span_since(_F_DP, t0)
            grads = [_grad_like(r, p)
                     for r, p in zip(reduced, self.param_leaves())]
        self._ensure_opt()
        self._opt.update(grads, self._opt_state,
                         [ck.params for ck in self.chunks])
        return self._flush_stats(applies_before)

    def _flush_stats(self, applies_before: int) -> Dict[str, Any]:
        losses: List[float] = []
        for ck in self.chunks:
            losses.extend(ck.losses)
            ck.losses = []
        return {"loss_sum": float(np.sum(losses)) if losses else 0.0,
                "microbatches": self.M,
                "fused_bucket_applies":
                    self._fused_applies - applies_before}

    # -- elastic membership (driver-orchestrated, between flushes)

    def reset_group(self, dp: int, dp_rank: int) -> None:
        """Adopt a resized dp group: the driver re-declared it at a new
        generation; drop this member's stale cached rendezvous so the
        next collective call joins the new world. The MEAN scale of the
        flush allreduce re-derives from the live world size."""
        from ray_tpu_torch.util.collective.resizable import \
            refresh_membership

        self.dp = int(dp)
        self.dp_rank = int(dp_rank)
        refresh_membership(self.group_name)

    def sync_state(self, src_rank: int, timeout_ms: int) -> str:
        """One leaf-wise param/optimizer broadcast over the (resized) dp
        group: ``src_rank`` sends its live tree, everyone else installs
        the received copy (the joiner's no-checkpoint rejoin path, and a
        re-anchor for survivors whose mid-flush state may have diverged
        on a torn round)."""
        from ray_tpu_torch.util.collective.resizable import sync_tree

        state = None
        if self.dp_rank == src_rank:
            state = {
                "params": [ck.params for ck in self.chunks],
                "opt": self._opt_state,
                "fused": (
                    {k: e["state"] for k, e in self._fused_buckets.items()}
                    if self._fused_buckets is not None else None),
            }
        synced = sync_tree(state, self.group_name, src_rank=src_rank,
                           timeout_ms=timeout_ms)
        if self.dp_rank != src_rank:
            self._install_state(synced)
        return "ok"

    @torch.no_grad()
    def _install_state(self, state: Dict[str, Any]) -> None:
        for ck, p in zip(self.chunks, state["params"]):
            for dst, src in zip(ck.leaves, _leaves(p)):
                dst.copy_(src)
        if state["opt"] is not None:
            self._ensure_opt()
            self._opt_state = _place_tree(state["opt"], self.device)
        if state["fused"] is not None:
            # the bucket layout is a pure function of the (identical)
            # param tree + bucket bytes, so the sender's keys match ours
            self._ensure_fused_opt(self.param_leaves())
            for key, st in state["fused"].items():
                if tuple(key) not in self._fused_buckets:
                    raise RuntimeError(
                        f"stage {self.stage}: synced fused-opt bucket "
                        f"{key!r} has no local counterpart (bucket-layout "
                        f"drift between dp ranks?)")
                self._fused_buckets[tuple(key)]["state"] = _place_tree(
                    st, self.device)


# ----------------------------------------------------- worker-side run loop


# version-addressed local-or-mirror channel writer, shared with the
# compiled-DAG layer (_private/channels.py)
_Writer = _channels.VersionedWriter


def _kernel_launches() -> Dict[str, int]:
    from ray_tpu_torch.ops import flash_attention as fa

    return {f.__name__: f.launches for f in fa.KERNELS}


def _simulate_tp_schedule(S: int, V: int, M: int, depth: int,
                          stage: int) -> List[Tuple[str, int, int]]:
    """Deterministic static 1F1B order for ONE stage of a tp > 1
    pipeline, as ``[("fwd" | "bwd", local_chunk_v, m), ...]``.

    Tensor parallelism forbids the dynamic schedulers: their
    ``ready()``-probing choices diverge with timing across tp peers, and
    the in-block reduces carry no tags, so a mismatched op sequence
    silently sums the WRONG microbatches (shapes match) or deadlocks.
    Every rank derives the same order from the same (S, V, M, depth,
    stage) inputs by simulating all S stages jointly with unit-time ops:

      - per tick each stage runs its deepest ready backward, else its
        shallowest ready forward;
      - the loss chunk is ONE fused fwd+bwd op (as in the real loop);
      - per-chunk in-flight stashes are bounded by min(M, depth) and
        each act/grad ring holds at most ``depth`` unread values
        (writes need space; reads ack immediately, like the run loop);
      - a value written at tick t is readable from t+1.

    The simulated global schedule is feasible under exactly the run
    loop's blocking-read/write semantics, so S loops each executing
    their own slice of it in order cannot deadlock.
    """
    C = S * V
    limit = max(1, min(M, depth))
    fwd_done = [0] * C
    bwd_done = [0] * C
    act_occ = [0] * max(C - 1, 0)   # chunk c -> c+1 values in flight
    grad_occ = [0] * max(C - 1, 0)  # chunk c+1 -> c values in flight
    act_tick: Dict[Tuple[int, int], int] = {}   # (edge c, m) -> write tick
    grad_tick: Dict[Tuple[int, int], int] = {}
    order: List[List[Tuple[str, int, int]]] = [[] for _ in range(S)]
    total = 2 * C * M
    tick = 0
    while sum(fwd_done) + sum(bwd_done) < total:
        progressed = False
        for s in range(S):
            chunks = [s + u * S for u in range(V)]
            op = None
            # deepest ready backward first: it frees a stash slot and
            # feeds upstream soonest (loss chunk has no separate bwd)
            for c in reversed(chunks):
                if c == C - 1 or bwd_done[c] >= fwd_done[c]:
                    continue
                m = bwd_done[c]
                if grad_tick.get((c, m), tick) >= tick:
                    continue  # grad not committed before this tick
                if c > 0 and grad_occ[c - 1] >= depth:
                    continue  # no ring space for our grad write
                op = ("bwd", c, m)
                break
            if op is None:
                # shallowest ready forward (fills downstream soonest)
                for c in chunks:
                    if fwd_done[c] >= M:
                        continue
                    m = fwd_done[c]
                    if c > 0 and act_tick.get((c - 1, m), tick) >= tick:
                        continue  # input act not committed yet
                    if c == C - 1:
                        # loss chunk: fused fwd+bwd, writes grad C-2
                        if grad_occ[c - 1] >= depth:
                            continue
                        op = ("loss", c, m)
                        break
                    if fwd_done[c] - bwd_done[c] >= limit:
                        continue  # stash bound
                    if act_occ[c] >= depth:
                        continue  # no ring space for our act write
                    op = ("fwd", c, m)
                    break
            if op is None:
                continue
            kind, c, m = op
            progressed = True
            if kind == "bwd":
                bwd_done[c] += 1
                grad_occ[c] -= 1  # read acks the grad we consumed
                if c > 0:
                    grad_occ[c - 1] += 1
                    grad_tick[(c - 1, m)] = tick
                order[s].append(("bwd", c // S, m))
            elif kind == "loss":
                fwd_done[c] += 1
                bwd_done[c] += 1
                act_occ[c - 1] -= 1
                grad_occ[c - 1] += 1
                grad_tick[(c - 1, m)] = tick
                order[s].append(("fwd", c // S, m))
            else:
                fwd_done[c] += 1
                if c > 0:
                    act_occ[c - 1] -= 1
                if c < C - 1:
                    act_occ[c] += 1
                    act_tick[(c, m)] = tick
                order[s].append(("fwd", c // S, m))
        if not progressed:
            raise RuntimeError(
                f"tp schedule simulation wedged at tick {tick} "
                f"(S={S} V={V} M={M} depth={depth}; "
                f"fwd={fwd_done} bwd={bwd_done}) — scheduler bug")
        tick += 1
    return order[int(stage)]


def _run_stage_loop(rt: _StageRuntime, plan: _StagePlan) -> dict:
    """The per-actor eager-1F1B run loop (occupies the stage actor until
    its channels close): per flush, run backwards the moment their
    gradients are committed and forwards ahead up to the channel-depth
    in-flight bound (interleaving across this stage's V chunks when
    virtual_stages > 1), then the optimizer flush and one report write.
    Steady flushes touch channels and local compute only: the per-flush
    report carries this rank's observed
    ``ray_tpu_rpc_client_calls_total`` delta as proof."""
    from ray_tpu_torch._private import api, rpc

    core = api._core
    if core is None:
        raise RuntimeError("pipeline stage loop outside a worker process")

    open_local, local, release_pins = _channels.open_local_factory(core)

    def open_reader(spec) -> Optional[_channels.LocalChannel]:
        return open_local(spec) if spec is not None else None

    remote_specs: List[_channels.ChannelSpec] = []

    def writer(spec) -> Optional[_Writer]:
        if spec is None:
            return None
        w = _Writer(core, spec, open_local)
        if w._mirror is not None:
            remote_specs.append(spec)
        return w

    s, S, M, V = rt.stage, rt.S, rt.M, rt.V
    stage_label = {"stage": str(s)}
    try:
        in_ch = open_reader(plan.in_spec)
        label_ch = open_reader(plan.label_spec)
        act_in = [open_reader(sp) for sp in plan.act_in]
        grad_in = [open_reader(sp) for sp in plan.grad_in]
        act_out = [writer(sp) for sp in plan.act_out]
        grad_out = [writer(sp) for sp in plan.grad_out]
        report_w = writer(plan.report)
    except BaseException:
        release_pins()
        raise

    def close_everything() -> None:
        _channels.close_channels_nowait(core, local.values(), remote_specs)

    wait_box = [0.0]
    first_read = [False]  # True while waiting on the flush's FIRST read
    t_box = [0.0]

    def read_value(ch: _channels.LocalChannel, version: int):
        t0 = time.perf_counter()
        view = ch.read(version)
        if first_read[0]:
            # the wait for a flush's first input spans the driver's
            # think-time between step() calls: idle, not pipeline
            # bubble; start the flush clock here instead
            first_read[0] = False
            t_box[0] = time.perf_counter()
        else:
            wait_box[0] += time.perf_counter() - t0
        value = _copy_tree(serialization.unpack(view))
        del view
        ch.ack(0, version)
        return value

    def write_value(w: _Writer, value, version: int) -> None:
        payload = serialization.pack(_to_wire(value))
        t0 = time.perf_counter()
        w.write(payload, version)
        wait_box[0] += time.perf_counter() - t0

    depth = (plan.act_out[0] or plan.grad_out[0] or plan.report).depth
    limit = max(1, min(M, depth))

    def run_flush_v1(vbase: int) -> None:
        """The one-chunk-per-stage eager 1F1B schedule (virtual_stages=1
        executes it and nothing else)."""
        fwd_m, bwd_m = [0], [0]
        a_in, g_in = act_in[0], grad_in[0]
        a_out, g_out = act_out[0], grad_out[0]

        def forward():
            t_mb = flight.now()
            m = fwd_m[0]
            fwd_m[0] += 1
            v = vbase + 2 * m
            x = read_value(in_ch if rt.first else a_in, v)
            if rt.last:
                labels = read_value(label_ch, v)
                _, gx = rt.loss_backward(0, x, labels)
                write_value(g_out, gx, v)
            else:
                write_value(a_out, rt.forward(0, m, x), v)
            _m_microbatches.inc(labels=stage_label)
            flight.span_since(_F_FWD, t_mb)

        def backward():
            m = bwd_m[0]
            bwd_m[0] += 1
            if rt.last:
                return  # folded into forward (fwd/bwd adjacent)
            t_mb = flight.now()
            v = vbase + 2 * m
            gy = read_value(g_in, v)
            gx = rt.backward(0, m, gy)
            if not rt.first:
                write_value(g_out, gx, v)
            flight.span_since(_F_BWD, t_mb)

        # Eager 1F1B: backward-first whenever the grad is already
        # committed (it frees a stash slot and feeds upstream), otherwise
        # forwards ahead up to the channel-depth in-flight bound;
        # backwards still run in microbatch order, so accumulation is
        # deterministic. When nothing is ready, block on the edge that
        # must deliver next.
        fwd_src = in_ch if rt.first else a_in
        while bwd_m[0] < M:
            progressed = False
            if fwd_m[0] < M and fwd_m[0] - bwd_m[0] < limit \
                    and fwd_src.ready(vbase + 2 * fwd_m[0]):
                forward()
                progressed = True
            if bwd_m[0] < fwd_m[0] and (
                    rt.last or g_in.ready(vbase + 2 * bwd_m[0])):
                backward()
                progressed = True
            if progressed:
                continue
            # nothing committed yet: park on the required edge
            if bwd_m[0] < fwd_m[0] and (
                    fwd_m[0] == M or fwd_m[0] - bwd_m[0] >= limit):
                backward()
            else:
                forward()

    def run_flush_interleaved(vbase: int) -> None:
        """The interleaved multi-chunk schedule (virtual_stages > 1):
        eager over this stage's V chunks: deepest ready backward first
        (it feeds upstream soonest), else SHALLOWEST ready forward
        (earliest chunks feed everything downstream), else an idle poll
        that IS the measured bubble. An op is "ready" only when its input
        is committed AND its local output slot is writable, so the actor
        never parks in one chunk's blocked write while another chunk has
        work (mirror edges can't be probed without an RPC and stay
        blocking)."""
        chs = rt.chunks
        fwd_m = [0] * V
        bwd_m = [0] * V

        def fwd_src(v):
            return in_ch if chs[v].first else act_in[v]

        def do_forward(v: int) -> None:
            t_mb = flight.now()
            m = fwd_m[v]
            fwd_m[v] += 1
            ver = vbase + 2 * m
            x = read_value(fwd_src(v), ver)
            if chs[v].last:
                labels = read_value(label_ch, ver)
                _, gx = rt.loss_backward(v, x, labels)
                write_value(grad_out[v], gx, ver)
                bwd_m[v] += 1  # fwd/bwd fused on the loss chunk
            else:
                write_value(act_out[v], rt.forward(v, m, x), ver)
            _m_microbatches.inc(labels=stage_label)
            flight.span_since(_F_FWD, t_mb)

        def do_backward(v: int) -> None:
            t_mb = flight.now()
            m = bwd_m[v]
            bwd_m[v] += 1
            ver = vbase + 2 * m
            gy = read_value(grad_in[v], ver)
            gx = rt.backward(v, m, gy)
            if not chs[v].first:
                write_value(grad_out[v], gx, ver)
            flight.span_since(_F_BWD, t_mb)

        def bwd_ready(v: int) -> bool:
            if chs[v].last or bwd_m[v] >= fwd_m[v]:
                return False
            ver = vbase + 2 * bwd_m[v]
            if not grad_in[v].ready(ver):
                return False
            w = grad_out[v]
            return w is None or w.writable(ver)

        def fwd_ready(v: int) -> bool:
            if fwd_m[v] >= M or fwd_m[v] - bwd_m[v] >= limit:
                return False
            ver = vbase + 2 * fwd_m[v]
            if not fwd_src(v).ready(ver):
                return False
            if chs[v].last:
                if not label_ch.ready(ver):
                    return False
                w = grad_out[v]
            else:
                w = act_out[v]
            return w is None or w.writable(ver)

        total = M * V
        idle = [0, 5e-5]  # spins, escalating delay (the _wait shape)
        while sum(bwd_m) < total:
            progressed = False
            for v in reversed(range(V)):
                if bwd_ready(v):
                    do_backward(v)
                    progressed = True
                    break
            if not progressed:
                for v in range(V):
                    if fwd_ready(v):
                        do_forward(v)
                        progressed = True
                        break
            if progressed:
                idle[0], idle[1] = 0, 5e-5
                continue
            # nothing ready on any chunk's edges: the pipeline bubble.
            # Poll with the channel-wait backoff; a close flips the probes
            # true (ready()/writable() return True on closed), so the
            # next pick raises instead of spinning forever.
            t0 = time.perf_counter()
            if idle[0] < 100:
                time.sleep(0)
            else:
                time.sleep(idle[1])
                idle[1] = min(idle[1] * 1.5, 0.002)
            idle[0] += 1
            if not first_read[0]:
                wait_box[0] += time.perf_counter() - t0

    # tp > 1: the deterministic static order every tp peer of this
    # (stage, dp-rank) slot executes identically, computed once
    tp_order = (_simulate_tp_schedule(S, V, M, depth, s)
                if rt.tp > 1 else None)

    def run_flush_tp(vbase: int) -> None:
        """The tp static schedule: execute this stage's simulated op
        order with blocking reads/writes. Tail chunks (Megatron swiglu
        last block) return (u, mlp_partial); when the IMMEDIATELY next op
        is the same chunk's next forward, the tail allreduce runs async
        on the ".tail" group and overlaps that forward's compute; any
        other successor may depend on the held act write, so the combine
        happens inline instead. At most one tail reduce is pending, and
        it is flushed before any other channel write (writes stay in
        version order)."""
        chs = rt.chunks
        pending = [None]  # (v, version, u, work)

        def flush_pending() -> None:
            v, ver, u, work = pending[0]
            pending[0] = None
            t0 = flight.now()
            y = rt.tail_combine(u, work)
            flight.span_since(_F_TPTAIL, t0)
            write_value(act_out[v], y, ver)

        n_ops = len(tp_order)
        for i, (kind, v, m) in enumerate(tp_order):
            ver = vbase + 2 * m
            if kind == "fwd":
                t_mb = flight.now()
                x = read_value(in_ch if chs[v].first else act_in[v], ver)
                if chs[v].last:
                    if pending[0] is not None:
                        flush_pending()
                    labels = read_value(label_ch, ver)
                    _, gx = rt.loss_backward(v, x, labels)
                    write_value(grad_out[v], gx, ver)
                elif chs[v].tail:
                    out = rt.forward(v, m, x)  # overlaps pending reduce
                    if pending[0] is not None:
                        flush_pending()  # version order on act_out[v]
                    u, mp = out
                    work = rt.tail_reduce_async(mp)
                    nxt = tp_order[i + 1] if i + 1 < n_ops else None
                    if rt.tp_overlap and nxt == ("fwd", v, m + 1):
                        pending[0] = (v, ver, u, work)
                    else:
                        t0 = flight.now()
                        y = rt.tail_combine(u, work)
                        flight.span_since(_F_TPTAIL, t0)
                        write_value(act_out[v], y, ver)
                else:
                    y = rt.forward(v, m, x)
                    if pending[0] is not None:
                        flush_pending()
                    write_value(act_out[v], y, ver)
                _m_microbatches.inc(labels=stage_label)
                flight.span_since(_F_FWD, t_mb)
            else:
                if pending[0] is not None:
                    flush_pending()
                t_mb = flight.now()
                gy = read_value(grad_in[v], ver)
                gx = rt.backward(v, m, gy)
                if not chs[v].first:
                    write_value(grad_out[v], gx, ver)
                flight.span_since(_F_BWD, t_mb)
        if pending[0] is not None:
            flush_pending()

    flush_idx = 0
    microbatches = 0
    try:
        while True:
            chaos.maybe_crash("worker.pipeline_step")
            t_fl = flight.now()
            t_box[0] = time.perf_counter()
            cpu0 = time.process_time()
            wait_box[0] = 0.0
            first_read[0] = True
            rpc_before = rpc._m_client_calls.total()
            tp_before = rt._tp_reduce_calls
            launches_before = _kernel_launches()
            vbase = 2 * (flush_idx * M + 1)

            if rt.tp > 1:
                run_flush_tp(vbase)
            elif V == 1:
                run_flush_v1(vbase)
            else:
                run_flush_interleaved(vbase)

            microbatches += M * V
            t_opt = flight.now()
            flush_stats = rt.flush()
            if rt.device.type == "cuda":
                torch.cuda.synchronize(rt.device)
            flight.span_since(_F_OPT, t_opt)
            total_s = time.perf_counter() - t_box[0]
            bubble = min(1.0, wait_box[0] / max(total_s, 1e-9))
            # per-flush bubble as a counter track (basis points)
            flight.counter(_F_BUBBLE, int(bubble * 10_000))
            _m_flushes.inc(labels=stage_label)
            _m_stage_seconds.observe(total_s, labels=stage_label)
            _m_bubble.set(bubble, labels=stage_label)
            report = {
                "stage": s,
                "flush": flush_idx,
                "loss_sum": flush_stats["loss_sum"],
                "microbatches": M,
                "virtual_stages": V,
                "fused_bucket_applies":
                    flush_stats["fused_bucket_applies"],
                "tp": rt.tp,
                "tp_rank": rt.tp_rank,
                "tp_reduce_calls": rt._tp_reduce_calls - tp_before,
                # this flush's launches of each flash attention kernel
                # (K1-K3) in this process: 0 on a CPU stage
                "kernel_launches": {
                    k: n - launches_before[k]
                    for k, n in _kernel_launches().items()},
                "rpc_calls": rpc._m_client_calls.total() - rpc_before,
                "wait_s": wait_box[0],
                "flush_s": total_s,
                "cpu_s": time.process_time() - cpu0,
                "bubble_fraction": bubble,
                "device": str(rt.device),
                # this rank's registry values ride along so tests (and
                # the driver) can assert the wiring without an RPC to the
                # worker's /metrics endpoint
                "metrics": {
                    "microbatches_total": _m_microbatches.value(
                        labels=stage_label),
                    "flushes_total": _m_flushes.value(labels=stage_label),
                    "stage_seconds_count":
                        _m_stage_seconds.count_total(),
                    "fused_bucket_applies_total": _m_fused_applies.value(
                        labels=stage_label),
                },
            }
            report_w.write(serialization.pack(report), 2 * (flush_idx + 1))
            flight.span_since(_F_FLUSH, t_fl)
            flush_idx += 1
    except ChannelClosedError:
        # normal exit: trainer teardown (or a peer's death) closed the
        # channels; a half-done flush's gradient state dies with us.
        # Close OUR channels too before leaving: a peer that poisoned
        # only its own edges (user exception on a still-alive actor)
        # relies on each stage propagating the close, or the driver's
        # untimed report read would hang.
        try:
            close_everything()
        except Exception:
            logger.exception("pipeline close-on-exit failed")
        return {"flushes": flush_idx, "microbatches": microbatches}
    except BaseException:
        # stage math raised: poison the pipeline so every peer (and the
        # driver) unwinds instead of hanging, surface through this task
        try:
            close_everything()
        except Exception:
            logger.exception("pipeline close-on-error failed")
        raise
    finally:
        release_pins()


# ------------------------------------------------------------- stage actor


def _make_runtime(spec_blobs, stage, num_stages, virtual_stages,
                  num_microbatches, optimizer, dp, dp_rank, group_name,
                  fused_flush, flush_bucket_bytes,
                  declarative_group=False, tp=1, tp_rank=0,
                  tp_group=None, tp_tail_group=None,
                  tp_overlap=True, device="cpu") -> _StageRuntime:
    return _StageRuntime(
        [_as_stage_spec(b) for b in spec_blobs], stage, num_stages,
        virtual_stages, num_microbatches, optimizer, dp, dp_rank,
        group_name, fused_flush, flush_bucket_bytes,
        declarative_group=declarative_group, tp=tp, tp_rank=tp_rank,
        tp_group=tp_group, tp_tail_group=tp_tail_group,
        tp_overlap=tp_overlap, device=device)


class _PipelineStageActorImpl:
    """Stage actor body (wrapped by ray_tpu_torch.remote at trainer build
    so importing this module never requires an initialized runtime)."""

    def __init__(self, spec_blobs, stage, num_stages, virtual_stages,
                 num_microbatches, optimizer, dp, dp_rank, group_name,
                 fused_flush, flush_bucket_bytes, declarative_group=False,
                 tp=1, tp_rank=0, tp_group=None, tp_tail_group=None,
                 tp_overlap=True, device="cpu"):
        self._rt = _make_runtime(spec_blobs, stage, num_stages,
                                 virtual_stages, num_microbatches,
                                 optimizer, dp, dp_rank, group_name,
                                 fused_flush, flush_bucket_bytes,
                                 declarative_group, tp, tp_rank,
                                 tp_group, tp_tail_group, tp_overlap,
                                 device)

    def ping(self):
        return "ok"

    def run_loop(self, plan: _StagePlan) -> dict:
        return _run_stage_loop(self._rt, plan)

    # -- elastic rejoin (driver-orchestrated between run loops)

    def elastic_reset_group(self, dp: int, dp_rank: int) -> str:
        self._rt.reset_group(dp, dp_rank)
        return "ok"

    def elastic_sync_state(self, src_rank: int, timeout_ms: int) -> str:
        return self._rt.sync_state(src_rank, timeout_ms)

    # -- dynamic task-per-stage path (the baseline; same math)

    def naive_fwd(self, v, m, x):
        return _to_wire(self._rt.forward(v, m, x))

    def naive_loss_bwd(self, v, m, x, labels):
        _, gx = self._rt.loss_backward(v, x, labels)
        return _to_wire(gx)

    def naive_bwd(self, v, m, gy):
        gx = self._rt.backward(v, m, gy)
        return None if gx is None else _to_wire(gx)

    def naive_flush(self):
        return self._rt.flush()

    # -- introspection (valid before the loop starts or after it exits)

    def fetch_params(self, chunk: Optional[int] = None):
        """This stage's chunk params as CPU tensors."""
        if chunk is not None:
            return _host_params(self._rt.chunks[chunk].params)
        if self._rt.V == 1:
            return _host_params(self._rt.chunks[0].params)
        return [_host_params(ck.params) for ck in self._rt.chunks]


_stage_actor_cls = None


def _stage_actor():
    global _stage_actor_cls
    if _stage_actor_cls is None:
        import ray_tpu_torch

        _stage_actor_cls = ray_tpu_torch.remote(_PipelineStageActorImpl)
    return _stage_actor_cls


# ------------------------------------------------------------------ trainer


class PipelineTrainer:
    """Train a model sharded over S pipeline stages with (interleaved)
    1F1B microbatch scheduling over compiled-graph channels (module
    docstring has the design; ``ray_tpu_torch.models.presets.
    pipeline_stage_defs`` partitions the transformer family into chunk
    specs).

        stages = presets.pipeline_stage_defs(cfg, num_stages=2)
        trainer = PipelineTrainer(
            stages, num_microbatches=4,
            stage_options=[{"num_gpus": 0}, {"num_gpus": 1}])
        for batch in data:                # {"tokens": [B, L] int}
            out = trainer.step(batch)    # {"loss": ..., "reports": [...]}
        trainer.shutdown()

    ``stages`` holds ``S * virtual_stages`` chunk specs in pipeline
    order; chunk c runs on stage actor ``c % S``. ``stage_options[s]``
    are stage s's actor options; a stage runs on its card unless its
    entry says ``num_gpus=0`` (the default is ``num_gpus=1``). ``dp``
    replicates every stage; replicas sync gradients at flush with one
    coalesced-mean allreduce per stage group: ``fused_flush`` (default)
    applies the optimizer per bucket as each reduce lands (leafwise
    optimizers only). ``optimizer`` is ``("sgd", lr)`` or a factory of an
    object with ``init``/``update`` (``models.training.AdamW``'s shape).
    ``mode="tasks"`` runs the same chunk math as dynamic actor tasks
    through the object store (the baseline).

    ``tensor_parallel=t`` (or ``RAY_TPU_TORCH_PIPELINE_TP``) composes a
    THIRD axis: every (dp-rank, stage) slot becomes t actors, each holding
    the stage chunks' 1/t Megatron shard (build the specs with
    ``pipeline_stage_defs(cfg, S, tensor_parallel=t)``). The partial-sum
    reduces ride per-(stage, dp-rank) tp collective groups, the dp flush
    reduces only each rank's 1/t shard, and tp ranks execute a
    deterministic STATIC 1F1B schedule.
    """

    def __init__(self, stages: Sequence[Any], *, num_microbatches: int,
                 dp: int = 1, mode: str = "channels",
                 optimizer: Any = ("sgd", 0.1),
                 virtual_stages: Optional[int] = None,
                 tensor_parallel: Optional[int] = None,
                 tp_overlap: bool = True,
                 fused_flush: bool = True,
                 flush_bucket_bytes: Optional[int] = None,
                 channel_depth: Optional[int] = None,
                 buffer_bytes: Optional[int] = None,
                 stage_options: Optional[Sequence[dict]] = None,
                 elastic: bool = False,
                 name: str = "pipeline"):
        from ray_tpu_torch._private import api

        if mode not in ("channels", "tasks"):
            raise ValueError(f"unknown mode {mode!r}")
        if elastic and (mode != "channels" or int(dp) < 2):
            raise ValueError(
                "elastic=True needs mode='channels' and dp >= 2: a lost "
                "replica's parameters are recovered from a surviving dp "
                "peer over collective.broadcast, so there must be one")
        self._specs = [_as_stage_spec(s) for s in stages]
        core = api._require_core()
        self._core = core
        # tensor parallel width: None takes the env knob; an explicit 0
        # (argument or env) RAISES instead of silently meaning 1
        if tensor_parallel is None:
            t = int(core.config.pipeline_tp)
            t_source = "RAY_TPU_TORCH_PIPELINE_TP"
        else:
            t = int(tensor_parallel)
            t_source = "tensor_parallel"
        if t < 1:
            raise ValueError(
                f"{t_source}={t} is invalid: tensor_parallel must be "
                f">= 1 (1 = no tensor parallelism; 0 does not mean "
                f"'default')")
        self._tp = t
        self._tp_overlap = bool(tp_overlap)
        spec_tps = {sp.tp for sp in self._specs}
        if spec_tps != {self._tp}:
            raise ValueError(
                f"tensor_parallel={self._tp} but the stage specs carry "
                f"tp={sorted(spec_tps)} — build them with "
                f"pipeline_stage_defs(cfg, S, tensor_parallel="
                f"{self._tp}) so the shard layout matches the trainer "
                f"grid")
        if self._tp > 1 and mode != "channels":
            raise ValueError(
                "tensor_parallel > 1 needs mode='channels': the tasks "
                "path runs one actor per (dp, stage) slot and cannot "
                "pair the tp reduces")
        if self._tp > 1 and elastic:
            raise ValueError(
                "tensor_parallel > 1 does not compose with elastic=True "
                "yet: a lost tp rank's shard has no replica inside its "
                "tp group to recover from")
        # interleaved virtual stages: None takes the env knob; an
        # explicit 0 (argument or env) RAISES instead of meaning 1
        if virtual_stages is None:
            v = int(core.config.pipeline_virtual_stages)
            v_source = "RAY_TPU_TORCH_PIPELINE_VIRTUAL_STAGES"
        else:
            v = int(virtual_stages)
            v_source = "virtual_stages"
        if v < 1:
            raise ValueError(
                f"{v_source}={v} is invalid: virtual_stages must be >= 1 "
                f"(1 = one chunk per stage; 0 does not mean 'default')")
        self._V = v
        n = len(self._specs)
        if n % self._V != 0:
            raise ValueError(
                f"{n} chunk specs do not divide into virtual_stages="
                f"{self._V} chunks per stage — build them with "
                f"pipeline_stage_defs(cfg, S, virtual_stages={self._V}) "
                f"so len(stages) == S * {self._V}")
        self._S = n // self._V
        if self._S < 2:
            raise ValueError(
                "PipelineTrainer needs >= 2 stages (single-stage training "
                "has no pipeline; use TorchTrainer / models.training)")
        self._M = int(num_microbatches)
        if self._M < 1:
            raise ValueError("num_microbatches must be >= 1")
        if flush_bucket_bytes is not None and int(flush_bucket_bytes) < 1:
            raise ValueError(
                f"flush_bucket_bytes={flush_bucket_bytes} is invalid: "
                f"pass None for the RAY_TPU_TORCH_COLLECTIVE_COALESCE_BYTES "
                f"default (0 does not mean 'default')")
        self._dp = int(dp)
        self._mode = mode
        self._name = name
        self._fused = bool(fused_flush)
        self._buffer = int(buffer_bytes or core.config.channel_buffer_bytes)
        cfg_depth = int(core.config.channel_depth or 1)
        # 1F1B wants room for the in-flight microbatch differential (S*V
        # chunks deep when interleaved); the config knob only wins when
        # the operator raised it higher
        self._depth = int(channel_depth) if channel_depth is not None \
            else max(2, min(self._S * self._V + 1, self._M), cfg_depth)
        if self._depth < 1:
            raise ValueError("channel_depth must be >= 1")
        self._flush = 0
        # channel-version flush counter: tracks self._flush except that
        # an elastic heal RESETS it (fresh channels + restarted loops
        # start at version 0 again while the step count keeps climbing)
        self._vflush = 0
        self._dead = False
        self._torn = False
        self._teardown_lock = threading.Lock()
        self._all_specs: List[_channels.ChannelSpec] = []
        self._local_channels: Dict[bytes, _channels.LocalChannel] = {}
        self._loop_refs: List[Any] = []
        self._actor_info: Dict[str, dict] = {}
        self._actor_subs: Dict[str, Any] = {}
        self._slot_of_hex: Dict[str, Tuple[int, int, int]] = {}

        # ---- elastic membership
        self._elastic = bool(elastic)
        self._optimizer = optimizer
        self._flush_bucket_bytes = flush_bucket_bytes
        self._note_lock = threading.Lock()
        self._lost_hexes: set = set()
        self._heal_pending = False
        self._heal_t0 = 0.0
        self._groups: List[Any] = []
        self._sup = None
        if self._elastic:
            from ray_tpu_torch._private.elastic import ElasticSupervisor

            self._sup = ElasticSupervisor(name=name)

        # ---- stage actors (dp x S x tp)
        import uuid

        # fold a per-trainer token into the collective group names: two
        # live trainers with the default name must not meet in
        # rendezvous (they would cross-average unrelated models)
        token = uuid.uuid4().hex[:8]
        self._token = token
        self._stage_opts = list(stage_options or [])

        # axis-aware placement (tp > 1): each (dp-rank, stage) slot's tp
        # group should land on ONE node while pipeline edges cross nodes.
        # Soft affinity: a full node falls back to the scheduler.
        self._placement_plan: Optional[List[List[str]]] = None
        if self._tp > 1 and mode == "channels":
            try:
                views = core._run(core.clients.get(
                    core.controller_addr).call("node_views"))
                self._placement_plan = _channels.plan_axis_placement(
                    views, num_stages=self._S, dp=self._dp)
            except Exception:
                logger.debug("axis placement planning failed; leaving "
                             "stage placement to the scheduler",
                             exc_info=True)

        self._actors: List[List[List[Any]]] = []
        try:
            for r in range(self._dp):
                row = []
                for s in range(self._S):
                    row.append([self._spawn_stage_actor(r, s, t)
                                for t in range(self._tp)])
                self._actors.append(row)
            for r in range(self._dp):
                for s in range(self._S):
                    for t in range(self._tp):
                        self._slot_of_hex[
                            self._actors[r][s][t]._actor_id.hex()] = \
                            (r, s, t)
            import ray_tpu_torch

            ray_tpu_torch.get([a.ping.remote()
                               for row in self._actors
                               for cell in row for a in cell], timeout=300)
        except BaseException:
            self._kill_actors()
            self._torn = True  # nothing left for shutdown() to release
            raise

        if self._tp > 1:
            # declare the per-(stage, dp-rank) tp groups (plus the
            # ".tail" twin for the async last-block partial sums):
            # members rendezvous lazily on their first reduce, so the
            # control RPCs land in flush 0 and steady flushes stay
            # RPC-free
            from ray_tpu_torch.util import collective as col

            ranks = list(range(self._tp))
            for r in range(self._dp):
                for s in range(self._S):
                    gname = self._tp_group_name(r, s)
                    col.create_collective_group(
                        self._actors[r][s], world_size=self._tp,
                        ranks=ranks, backend="host", group_name=gname)
                    col.create_collective_group(
                        self._actors[r][s], world_size=self._tp,
                        ranks=ranks, backend="host",
                        group_name=gname + ".tail")

        if self._elastic:
            # driver-declared (resizable) dp group per stage: members
            # rendezvous lazily at the current generation; a heal
            # re-declares at the next one
            from ray_tpu_torch.util.collective.resizable import \
                ResizableGroup

            self._groups = [
                ResizableGroup(
                    [self._actors[r][s][0] for r in range(self._dp)],
                    group_name=f"{name}.{token}.stage{s}", backend="host")
                for s in range(self._S)]

        if mode == "channels":
            try:
                self._build_channels()
            except BaseException:
                try:
                    self.shutdown()
                except Exception:
                    logger.debug("pipeline build unwind failed",
                                 exc_info=True)
                raise

    # -- properties

    @property
    def is_channel_backed(self) -> bool:
        return self._mode == "channels" and bool(self._all_specs)

    @property
    def channel_depth(self) -> int:
        return self._depth if self.is_channel_backed else 0

    @property
    def num_stages(self) -> int:
        return self._S

    @property
    def virtual_stages(self) -> int:
        return self._V

    @property
    def tensor_parallel(self) -> int:
        return self._tp

    # -- build

    def _dp_group_name(self, s: int, t: int) -> str:
        """Per-stage dp flush group. At tp > 1 each tp rank's dp group is
        DISJOINT: rank t's flush reduces only its own 1/tp shard."""
        base = f"{self._name}.{self._token}.stage{s}"
        return base if self._tp == 1 else f"{base}.tp{t}"

    def _tp_group_name(self, r: int, s: int) -> str:
        """Per-(stage, dp-rank) tp reduce group (the ".tail" twin rides
        the async last-block partial sums)."""
        return f"{self._name}.{self._token}.stage{s}.dp{r}.tp"

    def _stage_actor_options(self, r: int, s: int) -> dict:
        """Stage s's actor options: its ``stage_options`` entry, with
        ``num_gpus=1`` unless the entry names its own count."""
        opts = self._stage_opts[s] if s < len(self._stage_opts) else None
        if opts:
            return {"num_gpus": 1, **opts}
        opts = {"num_gpus": 1}
        if self._placement_plan is not None:
            from ray_tpu_torch.util.scheduling_strategies import (
                NodeAffinitySchedulingStrategy)

            opts["scheduling_strategy"] = NodeAffinitySchedulingStrategy(
                node_id_hex=self._placement_plan[r][s], soft=True)
        return opts

    def _spawn_stage_actor(self, r: int, s: int, t: int = 0):
        """Create the (r, s, t) stage actor: the build path and the
        elastic respawn path run the exact same spawn."""
        opts = self._stage_actor_options(r, s)
        device = "cuda" if (opts.get("num_gpus") or 0) >= 1 else "cpu"
        chunk_specs = [self._specs[s + u * self._S]
                       for u in range(self._V)]
        tp_group = self._tp_group_name(r, s) if self._tp > 1 else None
        return _stage_actor().options(**opts).remote(
            chunk_specs, s, self._S, self._V, self._M, self._optimizer,
            self._dp, r, self._dp_group_name(s, t),
            self._fused, self._flush_bucket_bytes, self._elastic,
            self._tp, t, tp_group,
            tp_group + ".tail" if tp_group else None, self._tp_overlap,
            device)

    def _create_channel(self, node_addr, n_readers, participants, *,
                        depth: Optional[int] = None,
                        buffer: Optional[int] = None
                        ) -> _channels.ChannelSpec:
        core = self._core
        spec = _channels.create_channel(
            core, node_addr, buffer or self._buffer,
            depth or self._depth, n_readers, participants)
        self._all_specs.append(spec)
        if tuple(node_addr) == tuple(core.supervisor_addr):
            self._local_channels[spec.key()] = _channels.LocalChannel(
                core.arena, spec)
        return spec

    def _build_channels(self) -> None:
        core = self._core
        driver_node = tuple(core.supervisor_addr)
        if core.arena is None:
            raise RuntimeError(
                "pipeline channels need a driver attached to a node arena")

        # resolve every stage actor's placement (one cluster-view
        # snapshot for the whole dp x S x tp pass) and verify the axis
        # plan's soft affinity landed when one exists
        views = core._run(core.clients.get(core.controller_addr).call(
            "node_views"))
        for row in self._actors:
            for cell in row:
                for a in cell:
                    hexid = a._actor_id.hex()
                    expect = None
                    if self._placement_plan is not None:
                        (r, s, _t) = self._slot_of_hex[hexid]
                        expect = self._placement_plan[r][s]
                    self._actor_info[hexid] = \
                        _channels.resolve_actor_placement(
                            core, a._actor_id, views,
                            expect_node_id_hex=expect)

        # ANY participant's death closes every channel of the trainer:
        # stages are serially dependent, dp replicas meet at the flush
        # allreduce, and tp ranks meet at every in-block reduce
        participants = {core._store_client_id}
        for info in self._actor_info.values():
            participants.add(info["worker_id_hex"])
            participants.add(f"node:{info['node_id_hex']}")

        def node_of(r, s, t):
            return self._actor_info[
                self._actors[r][s][t]._actor_id.hex()]["node_addr"]

        S, V, TP = self._S, self._V, self._tp
        C = S * V  # total pipeline chunks
        self._in_specs, self._label_specs = [], []
        self._report_readers: List[List[_channels.LocalChannel]] = []
        plans: List[List[_StagePlan]] = []  # flat (r * TP + t) -> [s]
        for r in range(self._dp):
            for t in range(TP):
                # each tp rank runs its own full act/grad ring chain:
                # activations are replicated across tp peers
                in_spec = self._create_channel(
                    node_of(r, 0, t), 1, participants)
                label_spec = self._create_channel(
                    node_of(r, S - 1, t), 1, participants)
                # per-chunk edges between the SAME S actors: chunk c runs
                # on actor c % S, so edge c -> c+1 lands on actor
                # (c+1) % S's node (channels live on the READER's node)
                act = [self._create_channel(
                    node_of(r, (c + 1) % S, t), 1, participants)
                    for c in range(C - 1)]
                grad = [self._create_channel(
                    node_of(r, c % S, t), 1, participants)
                    for c in range(C - 1)]
                # reports carry one small stats dict per flush, and the
                # driver acks flush f before scattering f+1: depth 1 and
                # a small buffer
                reports = [self._create_channel(
                    driver_node, 1, participants, depth=1,
                    buffer=64 * 1024) for _ in range(S)]
                self._in_specs.append(in_spec)
                self._label_specs.append(label_spec)
                self._report_readers.append(
                    [self._local_channels[sp.key()] for sp in reports])

                def stage_plan(s: int, in_spec=in_spec,
                               label_spec=label_spec, act=act,
                               grad=grad, reports=reports) -> _StagePlan:
                    cs = [s + u * S for u in range(V)]
                    return _StagePlan(
                        in_spec=in_spec if s == 0 else None,
                        label_spec=label_spec if s == S - 1 else None,
                        act_in=[act[c - 1] if c > 0 else None
                                for c in cs],
                        act_out=[act[c] if c < C - 1 else None
                                 for c in cs],
                        grad_in=[grad[c] if c < C - 1 else None
                                 for c in cs],
                        grad_out=[grad[c - 1] if c > 0 else None
                                  for c in cs],
                        report=reports[s],
                    )

                plans.append([stage_plan(s) for s in range(S)])

        # driver-side input writers (local write or mirror push)
        def driver_writer(spec):
            if tuple(spec.node_addr) == driver_node:
                return ("local", self._local_channels[spec.key()])
            return ("mirror", _channels.MirrorWriter(core, spec))

        self._in_writers = [driver_writer(sp) for sp in self._in_specs]
        self._label_writers = [driver_writer(sp) for sp in self._label_specs]

        # participant death -> close everything so nobody hangs; the
        # per-actor closure keeps WHICH actor died, which the elastic heal
        # needs to pick the respawn slots
        for hexid in self._actor_info:
            cb = self._make_actor_cb(hexid)
            self._actor_subs[hexid] = cb
            core.subscribe("actor:" + hexid, cb)

        # start the run loops (they dedicate the actors until teardown)
        for r in range(self._dp):
            for t in range(self._tp):
                for s in range(self._S):
                    self._loop_refs.append(
                        self._actors[r][s][t].run_loop.remote(
                            plans[r * self._tp + t][s]))

    # -- failure fan-out

    def _make_actor_cb(self, hexid: str):
        def cb(message) -> None:
            if self._torn or not isinstance(message, dict):
                return
            if message.get("state") in ("DEAD", "RESTARTING"):
                self._note_death(hexid)
        return cb

    def _note_death(self, hexid: str) -> None:
        if not self._elastic:
            if self._dead:
                return
            self._close_for_failure()
            return
        # elastic: remember the slot, mark a heal pending (the next
        # step() boundary runs it), and close the channels so every loop
        # unwinds to that boundary: nobody resumes a torn round,
        # survivors rejoin the next generation
        with self._note_lock:
            if not self._heal_pending:
                self._heal_pending = True
                self._heal_t0 = time.monotonic()
            self._lost_hexes.add(hexid)
        slot = self._slot_of_hex.get(hexid)
        if slot is not None and self._groups:
            try:
                self._groups[slot[1]].note_departure(hexid)
            except Exception:
                logger.debug("note_departure failed", exc_info=True)
        self._close_for_failure()

    def _close_for_failure(self) -> None:
        """Close the whole pipeline: used when a step failed partway
        through its microbatch scatter (some channels carry the version,
        others never will, so a retried step would train on a MIX of two
        batches)."""
        self._dead = True
        _channels.close_channels_nowait(
            self._core, self._local_channels.values(), self._all_specs)

    def _surface_failure(self, closed: ChannelClosedError):
        # a ChannelClosedError may wrap a TRANSPORT failure: close
        # everything first so no stage loop stays parked on a version
        # that will never be written
        self._close_for_failure()
        _channels.surface_loop_failure(self._core, self._loop_refs, closed)

    # -- elastic heal (runs at the step() boundary, never mid-flush)

    def _heal(self) -> None:
        """Re-form the world after noted departures: respawn the dead
        slots (budget/backoff via ElasticSupervisor), resize the affected
        stage dp groups to a fresh generation, broadcast params/opt state
        from a surviving replica to each replacement, rebuild the channel
        plan and restart the loops."""
        while True:
            with self._note_lock:
                if not self._heal_pending:
                    return
                self._heal_pending = False
                lost, self._lost_hexes = self._lost_hexes, set()
            self._heal_once(lost)

    def _heal_once(self, lost: set) -> None:
        import ray_tpu_torch

        core = self._core
        t0 = self._heal_t0
        dead_slots = sorted(self._slot_of_hex[h] for h in lost
                            if h in self._slot_of_hex)
        logger.info("pipeline %s: healing after loss of %s",
                    self._name, dead_slots or sorted(lost))

        # 1. drain the old world: loops exited on the channel close;
        # collect them, drop the old subscriptions, free the old specs
        for ch in self._local_channels.values():
            try:
                ch.close()
            except Exception:
                pass
        for ref in self._loop_refs:
            try:
                core.get([ref], timeout=self._sup.resize_timeout_s)
            except Exception:
                pass
        for hexid, cb in self._actor_subs.items():
            try:
                core.unsubscribe("actor:" + hexid, cb)
            except Exception:
                pass
        self._actor_subs.clear()
        try:
            _channels.free_and_unpin_specs(core, self._all_specs)
        except Exception:
            logger.debug("elastic spec free failed", exc_info=True)
        self._all_specs = []
        self._local_channels = {}
        self._loop_refs = []
        self._actor_info = {}

        # 2. respawn the dead slots (budget + backoff per slot); elastic
        # excludes tp > 1, so the tp axis is always rank 0
        for (r, s, _t) in dead_slots:
            old_hex = self._actors[r][s][0]._actor_id.hex()
            self._slot_of_hex.pop(old_hex, None)
            a = self._sup.respawn(
                ("dp", r, "stage", s),
                lambda r=r, s=s: self._spawn_stage_actor(r, s))
            self._actors[r][s][0] = a
            self._slot_of_hex[a._actor_id.hex()] = (r, s, 0)
        if dead_slots:
            ray_tpu_torch.get([self._actors[r][s][0].ping.remote()
                               for (r, s, _t) in dead_slots], timeout=300)

        # 3. reshard: re-declare each affected stage's dp group at the
        # next generation, then deliver params/opt state to the joiner
        # from the lowest-rank survivor (leaf-wise broadcast, no
        # checkpoint restore on this path)
        t_ms = self._sup.resize_timeout_ms
        for s in sorted({s for (_, s, _t) in dead_slots}):
            dead_rs = {r for (r, ss, _t) in dead_slots if ss == s}
            live = [r for r in range(self._dp) if r not in dead_rs]
            if not live:
                raise RuntimeError(
                    f"pipeline {self._name}: every dp replica of stage "
                    f"{s} died — parameters are unrecoverable without a "
                    f"checkpoint; treating the outage as terminal")
            row = [self._actors[r][s][0] for r in range(self._dp)]
            self._groups[s].resize(row)
            ray_tpu_torch.get(
                [row[r].elastic_reset_group.remote(self._dp, r)
                 for r in range(self._dp)], timeout=120)
            refs = [row[r].elastic_sync_state.remote(live[0], t_ms)
                    for r in range(self._dp)]
            ray_tpu_torch.get(refs, timeout=t_ms / 1000.0 + 30)

        # 4. restart the world: fresh channels + loops (versions restart
        # at 0: _vflush resets with them; the step count does not)
        self._vflush = 0
        try:
            self._build_channels()
        except BaseException:
            self._close_for_failure()
            raise
        with self._note_lock:
            if not self._heal_pending:
                self._dead = False
        self._sup.rejoin_span(t0)
        logger.info("pipeline %s: healed (%d respawn(s), epoch(s) %s)",
                    self._name, len(dead_slots),
                    [g.epoch for g in self._groups])

    # -- stepping

    def _split(self, batch) -> List[List[np.ndarray]]:
        if isinstance(batch, dict):
            extra = set(batch) - {"tokens"}
            if extra:
                # dropping keys silently (e.g. a loss_fn-style 'mask')
                # would train on different math than the user believes
                raise ValueError(
                    f"PipelineTrainer batches support only {{'tokens'}}; "
                    f"got extra keys {sorted(extra)} (masking is not "
                    f"threaded through the stage loss yet)")
            tokens = batch["tokens"]
        else:
            tokens = batch
        if isinstance(tokens, torch.Tensor):
            tokens = tokens.detach().cpu().numpy()
        tokens = np.asarray(tokens)
        B = tokens.shape[0]
        per = self._dp * self._M
        if B % per != 0:
            raise ValueError(
                f"batch size {B} not divisible by dp*num_microbatches "
                f"({self._dp}x{self._M})")
        mb = B // per
        return [[tokens[(r * self._M + m) * mb:(r * self._M + m + 1) * mb]
                 for m in range(self._M)] for r in range(self._dp)]

    def step(self, batch) -> Dict[str, Any]:
        """One optimizer step: scatter M microbatches per dp replica into
        the pipeline, collect every stage's flush report, return the mean
        loss. Steady-state cost: channel writes/reads only."""
        if self._mode == "tasks":
            return self._step_tasks(batch)
        if self._elastic and self._heal_pending and not self._torn:
            self._heal()
        if self._dead:
            raise ChannelClosedError("pipeline trainer was torn down")
        mbs = self._split(batch)
        vbase = 2 * (self._vflush * self._M + 1)
        wrote = False
        try:
            for r in range(self._dp):
                for m, mb in enumerate(mbs[r]):
                    payload = serialization.pack(np.ascontiguousarray(mb))
                    v = vbase + 2 * m
                    # every tp rank of the replica gets the SAME
                    # microbatch: activations are replicated across the
                    # tp axis, only params are sharded
                    for t in range(self._tp):
                        idx = r * self._tp + t
                        for kind, w in (self._in_writers[idx],
                                        self._label_writers[idx]):
                            if kind == "local":
                                w.write(payload, v)
                            else:
                                w.push(payload, v)
                            wrote = True
        except ChannelClosedError as e:
            self._surface_failure(e)
        except BaseException:
            if wrote:
                # a partial scatter is unrecoverable: stage 0 already
                # acked some of this flush's microbatches, so a retried
                # step() would mix two batches into one gradient
                self._close_for_failure()
            raise
        rv = 2 * (self._vflush + 1)
        reports: List[dict] = []
        try:
            for idx, readers in enumerate(self._report_readers):
                for ch in readers:
                    view = ch.read(rv)
                    rep = serialization.unpack(bytes(view))
                    del view
                    ch.ack(0, rv)
                    rep["dp_rank"] = idx // self._tp
                    reports.append(rep)
        except ChannelClosedError as e:
            self._surface_failure(e)
        self._flush += 1
        self._vflush += 1
        last = [rep for rep in reports if rep["stage"] == self._S - 1]
        loss = float(np.mean([rep["loss_sum"] / rep["microbatches"]
                              for rep in last]))
        return {"loss": loss, "step": self._flush, "reports": reports}

    # -- dynamic task-per-stage baseline (object-store data plane)

    def _step_tasks(self, batch) -> Dict[str, Any]:
        import ray_tpu_torch

        mbs = self._split(batch)
        S, V = self._S, self._V
        C = S * V
        barriers = []
        for r in range(self._dp):
            # tasks mode excludes tp > 1: the tp axis is rank 0
            row = [cell[0] for cell in self._actors[r]]
            for m, mb in enumerate(mbs[r]):
                # chunk c runs on actor c % S as local chunk c // S, the
                # same interleaved layout the channel loops execute
                ref = row[0].naive_fwd.remote(0, m, mb)
                for c in range(1, C - 1):
                    ref = row[c % S].naive_fwd.remote(c // S, m, ref)
                gref = row[(C - 1) % S].naive_loss_bwd.remote(
                    (C - 1) // S, m, ref, mb)
                for c in range(C - 2, -1, -1):
                    gref = row[c % S].naive_bwd.remote(c // S, m, gref)
                barriers.append(gref)
        ray_tpu_torch.get(barriers, timeout=600)
        stats = ray_tpu_torch.get(
            [cell[0].naive_flush.remote()
             for row in self._actors for cell in row],
            timeout=600)
        self._flush += 1
        last = stats[self._S - 1::self._S]
        loss = float(np.mean([st["loss_sum"] / st["microbatches"]
                              for st in last]))
        return {"loss": loss, "step": self._flush, "reports": stats}

    # -- introspection / teardown

    def fetch_params(self, stage: int, dp_rank: int = 0,
                     chunk: Optional[int] = None, tp_rank: int = 0):
        """Stage shard params as CPU tensors (tasks mode anytime;
        channels mode after shutdown: the run loop dedicates the actor).
        At virtual_stages=1 the stage's single chunk tree; at V > 1 a
        list of the stage's V chunk trees (or one tree with ``chunk=``
        the local index). At tensor_parallel > 1 the result is
        ``tp_rank``'s 1/tp shard: reassemble the fused tree with
        ``presets.reassemble_pipeline_params``."""
        import ray_tpu_torch

        return ray_tpu_torch.get(
            self._actors[dp_rank][stage][tp_rank]
                .fetch_params.remote(chunk),
            timeout=120)

    def _kill_actors(self) -> None:
        import ray_tpu_torch

        for row in self._actors:
            for cell in row:
                for a in cell:
                    try:
                        ray_tpu_torch.kill(a)
                    except Exception:
                        pass

    def shutdown(self, kill_actors: bool = True,
                 timeout: float = 30) -> Dict[str, Any]:
        """Close every channel, stop the stage loops, release the pins,
        (optionally) kill the stage actors. Idempotent."""
        self._dead = True
        # only the FIRST call may run the release: after it frees the
        # channel ranges they can be recycled to a NEWER trainer/graph,
        # and a repeat close would stamp the closed flag into live
        # channels that aren't ours anymore
        with self._teardown_lock:
            if self._torn:
                return {}
            self._torn = True
        core = self._core
        for ch in self._local_channels.values():
            try:
                ch.close()
            except Exception:
                pass
        for hexid, cb in self._actor_subs.items():
            try:
                core.unsubscribe("actor:" + hexid, cb)
            except Exception:
                pass
        self._actor_subs = {}

        _channels.close_specs(core, self._all_specs)
        stats: Dict[str, Any] = {"loops": []}
        for ref in self._loop_refs:
            try:
                stats["loops"].append(core.get([ref], timeout=timeout)[0])
            except Exception:
                stats["loops"].append(None)
        _channels.free_and_unpin_specs(core, self._all_specs)
        if kill_actors:
            self._kill_actors()
        return stats

    def __del__(self):
        try:
            if self._torn:
                return
            if threading.current_thread() is self._core._loop_thread:
                # collected on the runtime's io thread, which shutdown()'s
                # blocking calls need free: release from another thread
                threading.Thread(target=self.shutdown, daemon=True).start()
                return
            self.shutdown()
        except Exception:
            pass
