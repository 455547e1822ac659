"""Tensor-parallel reduce operators for sharded blocks.

Counterpart: ``ray_tpu/util/collective/tp.py``. Megatron-style tensor
parallelism (arXiv:1909.09756) threads two conjugate operators through
each sharded block:

  ``g``: partial-sum allreduce in the FORWARD pass, identity in the
  backward. Placed on every row-parallel output (attention proj,
  ffn-down) so each rank's partial sum over its local heads / ffn
  columns becomes the full activation.

  ``f``: identity in the forward, partial-sum allreduce in the
  BACKWARD. Placed on every column-parallel INPUT (the norm outputs
  feeding QKV / ffn-up) so the cotangent flowing back onto the
  replicated residual stream / norm params is the full cross-rank sum.

``reduce_ops(reduce)`` builds the pair as two
``torch.autograd.Function``s over any tensor reducer: the mesh's
``parallel/_spmd.py`` passes a ``torch.distributed`` all-reduce over the
``tp`` dim's group. ``make_tp_reduce_ops(reduce_cb)`` builds it over a
HOST reducer (the pipeline trainer passes ``collective.allreduce`` on a
per-(stage, dp-rank) tp group): a tensor goes to the host for the reduce
(a bfloat16 tensor widened to float32, the sum rounded once) and comes
back on its own device, in its own dtype. Every rank of a tp group must apply ``g``/``f`` in the same
order (the reduces carry no tags: order IS the match), which is why the
trainer runs a static schedule when tp > 1.

JAX's ``psum_tp_ops`` has no counterpart here: it is ``lax.psum`` over a
named ``jax.vmap`` axis, and ``torch.func.vmap`` has no named axis to
reduce over from inside the mapped function. The single-process
emulation instead runs the tp ranks on threads (``emulate_tp``, over a
``ThreadReducer``); each thread runs its backward under
``torch.autograd.set_multithreading_enabled(False)``, so a rank's ``f``
backward blocks its own thread and not the autograd engine's shared
device thread.
"""

from __future__ import annotations

import functools
import threading
from typing import Any, Callable, List, NamedTuple, Optional

import numpy as np
import torch


class TpOps(NamedTuple):
    """The conjugate (g, f) pair; both are unary tensor functions."""

    g: Callable  # reduce fwd / identity bwd (row-parallel outputs)
    f: Callable  # identity fwd / reduce bwd (column-parallel inputs)


def _host_reduce(reduce_cb, x: torch.Tensor) -> torch.Tensor:
    t = x.detach()
    a = (t.float() if t.dtype == torch.bfloat16 else t).cpu().numpy()
    r = np.array(reduce_cb(a), dtype=a.dtype, copy=True).reshape(a.shape)
    return torch.from_numpy(r).to(device=x.device, dtype=x.dtype)


class _G(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, reduce):
        return reduce(x)

    @staticmethod
    def backward(ctx, ct):
        return ct, None


class _F(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, reduce):
        ctx.reduce = reduce
        return x.view_as(x)

    @staticmethod
    def backward(ctx, ct):
        return ctx.reduce(ct), None


def reduce_ops(reduce: Callable[[torch.Tensor], torch.Tensor]) -> TpOps:
    """(g, f) over a tensor reducer: ``reduce(x)`` returns a new tensor,
    the tp group's SUM of ``x``, called once per ``g`` forward and per
    ``f`` backward, in program order."""
    return TpOps(g=lambda x: _G.apply(x, reduce),
                 f=lambda x: _F.apply(x, reduce))


def make_tp_reduce_ops(reduce_cb: Callable[[np.ndarray], np.ndarray]
                       ) -> TpOps:
    """(g, f) over a host partial-sum reducer. ``reduce_cb(arr) -> arr``
    must be the tp group's allreduce (SUM) of a numpy array."""
    return reduce_ops(functools.partial(_host_reduce, reduce_cb))


class ThreadReducer:
    """SUM allreduce across tp ranks that run as threads of one process,
    behind a barrier: the in-process stand-in for the host collective
    group (the twin of the JAX tests' ``_ThreadReducer``). The terms are
    folded in rank order, so every rank gets the same bits."""

    def __init__(self, tp: int, timeout: Optional[float] = 30.0):
        self.tp = tp
        self.bar = threading.Barrier(tp, timeout=timeout)
        self.slots: List[Optional[np.ndarray]] = [None] * tp
        self.out: Optional[np.ndarray] = None

    def make(self, rank: int) -> Callable[[np.ndarray], np.ndarray]:
        def reduce_cb(a):
            self.slots[rank] = np.asarray(a)
            self.bar.wait()
            if rank == 0:
                out = np.array(self.slots[0], copy=True)
                for s in self.slots[1:]:
                    np.add(out, s, out=out)
                self.out = out
            self.bar.wait()
            res = np.array(self.out, copy=True)
            self.bar.wait()
            return res
        return reduce_cb


def emulate_tp(tp: int, fn: Callable[[int, TpOps], Any],
               timeout: float = 600.0) -> List[Any]:
    """Run ``fn(rank, ops)`` for each of ``tp`` ranks on its own thread of
    this process, ``ops`` the (g, f) pair over one ``ThreadReducer``, and
    return the ranks' results in rank order (the single-process
    emulation of a tp group). Each thread runs with autograd's
    multithreading off, so a backward runs on its own thread: a rank's
    ``f`` backward waits at the barrier on that thread, never on the
    engine's one thread per device. A rank's error is raised here; a
    rank that never finishes (diverged reduce sequences) raises
    ``TimeoutError``."""
    red = ThreadReducer(tp, timeout=timeout)
    results: List[Any] = [None] * tp
    errors: List[Optional[BaseException]] = [None] * tp

    def run(rank: int) -> None:
        try:
            with torch.autograd.set_multithreading_enabled(False):
                results[rank] = fn(rank, make_tp_reduce_ops(red.make(rank)))
        except BaseException as e:  # noqa: BLE001 — raised below
            errors[rank] = e
            red.bar.abort()  # peers parked at the barrier raise too

    threads = [threading.Thread(target=run, args=(r,), daemon=True,
                                name=f"tp-rank-{r}") for r in range(tp)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout)
    if any(t.is_alive() for t in threads):
        red.bar.abort()
        raise TimeoutError(f"tp emulation: a rank did not finish in "
                           f"{timeout} s (the ranks' reduce sequences "
                           f"diverged?)")
    errs = [e for e in errors if e is not None]
    if errs:  # the root cause first, not a peer's broken barrier
        raise next((e for e in errs if not isinstance(
            e, threading.BrokenBarrierError)), errs[0])
    return results
