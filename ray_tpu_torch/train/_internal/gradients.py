"""Data-parallel gradient averaging for ``ray_tpu_torch.train`` worker loops.

Counterpart: ``ray_tpu/train/_internal/gradients.py``. A worker group's
ranks average their gradient trees over a host-backend collective group
(shm on one node, ring across nodes), as the JAX averager does, through the
async overlap API, so the host-side movement hides behind device compute:

    from ray_tpu_torch.train import GradientAverager

    def train_loop_per_worker():
        avg = GradientAverager()          # ranks/world from the session
        for batch in loader:
            value, _ = loss_fn(cfg, params, batch)
            grads = torch.autograd.grad(value, leaves)
            work = avg.begin(list(grads))  # returns immediately
            aux = other_device_work()      # overlaps the reduce
            grads = work.wait_tree()       # averaged, on the grads' device
            tx.update(grads, opt_state, params)

``average(grads)`` is the one-call form (begin + wait). A tree is a tensor
(or numpy array), or a dict, list or tuple of trees; it is flattened in one
fixed order on every rank (dicts by sorted key, lists and tuples in order),
and ``on_bucket`` indices follow that order. Buckets leave the card one
batched copy at a time in reverse-backward order, a MEAN is pre-scaled into
the staging copy, and the averager keeps persistent landing buffers (pinned
when the gradients are on a card), so a steady-state step allocates no host
memory. ``RAY_TPU_TORCH_COLLECTIVE_OVERLAP=0`` drops the whole path to the
synchronous coalesced reduce without any call-site change. (A loop that
averages on the card calls ``collective.allreduce_coalesced`` on an NCCL
group itself.)
"""

from __future__ import annotations

import logging
from typing import Any, List, Optional, Tuple

import numpy as np

from ray_tpu_torch.util.collective.types import host_dtype, is_tensor

logger = logging.getLogger(__name__)


# ------------------------------------------------------------------- trees


def tree_flatten(tree: Any) -> Tuple[List[Any], Any]:
    """``(leaves, treedef)``: dicts by sorted key, lists and tuples in
    order, anything else a leaf. The order is a function of the tree's
    structure alone, so every rank flattens alike."""
    leaves: List[Any] = []

    def walk(t):
        if isinstance(t, dict):
            keys = sorted(t)
            return ("dict", keys, [walk(t[k]) for k in keys])
        if isinstance(t, (list, tuple)):
            return (type(t).__name__, len(t), [walk(x) for x in t])
        leaves.append(t)
        return None

    return leaves, walk(tree)


def tree_unflatten(treedef: Any, leaves: List[Any]) -> Any:
    it = iter(leaves)

    def build(d):
        if d is None:
            return next(it)
        kind, keys, children = d
        if kind == "dict":
            return {k: build(c) for k, c in zip(keys, children)}
        out = [build(c) for c in children]
        return tuple(out) if kind == "tuple" else out

    return build(treedef)


def _like(x, like):
    """A landing buffer's averaged values as a new leaf like ``like``: a
    tensor of its dtype on its device, or a numpy array."""
    if not is_tensor(like):
        return np.array(x, copy=True)
    import torch

    return torch.as_tensor(x).to(device=like.device, dtype=like.dtype,
                                 copy=True)


class _TreeWork:
    """Wraps a CollectiveWork so callers get the tree back, not leaves."""

    def __init__(self, work, treedef, likes: Optional[List[Any]]):
        self._work = work
        self._treedef = treedef
        self._likes = likes  # None: the results are new leaves already

    def done(self) -> bool:
        return self._work.done()

    def wait_tree(self, timeout_ms: Optional[int] = None):
        leaves = self._work.wait(timeout_ms)
        if self._likes is not None:
            # copies: the landing buffers are reused next step
            leaves = [_like(x, like) for x, like in zip(leaves, self._likes)]
        return tree_unflatten(self._treedef, leaves)


class GradientAverager:
    """Per-worker handle on the training group's gradient collective.

    ``world_size``/``rank`` default to the train session's world rank
    (``ray_tpu_torch.train.get_context()``), so a ``train_loop_per_worker``
    needs no arguments; pass them explicitly to use the averager outside a
    session (tests, custom actor pools). The group is initialized
    imperatively and idempotently on first use: every rank constructs its
    own averager."""

    def __init__(self, group_name: str = "train_grads",
                 world_size: Optional[int] = None,
                 rank: Optional[int] = None,
                 timeout_ms: int = 60_000,
                 init_group: bool = True):
        """``init_group=False`` skips the imperative group init, for
        callers whose group membership is published some other way (a
        driver-declared group)."""
        if world_size is None or rank is None:
            from ray_tpu_torch.train._internal.session import get_session

            sess = get_session()
            if sess is None:
                raise RuntimeError(
                    "GradientAverager needs world_size/rank outside a "
                    "training worker session")
            world_size = sess.world_size if world_size is None else world_size
            rank = sess.world_rank if rank is None else rank
        self.group_name = group_name
        self.world_size = world_size
        self.rank = rank
        self.timeout_ms = timeout_ms
        self._out: Optional[List[Any]] = None
        self._sig: Optional[List[Any]] = None
        if world_size > 1 and init_group:
            from ray_tpu_torch.util import collective

            if not collective.is_group_initialized(group_name):
                collective.init_collective_group(
                    world_size, rank, backend="host", group_name=group_name)

    def _landing(self, flat: List[Any]) -> List[Any]:
        """Persistent landing buffers in the leaves' host dtypes: pinned
        CPU tensors when the gradients are on a card, numpy otherwise."""
        # (shape, dtype) signature, not leaf count: a same-arity tree
        # with one resized leaf must reallocate the landing buffers
        sig = [(tuple(f.shape), host_dtype(f)) for f in flat]
        if self._out is None or self._sig != sig:
            if any(is_tensor(f) and f.is_cuda for f in flat):
                import torch

                self._out = [torch.from_numpy(np.empty(0, d)).new_empty(
                    s, pin_memory=True) for s, d in sig]
            else:
                self._out = [np.empty(s, d) for s, d in sig]
            self._sig = sig
        return self._out

    def begin(self, grads: Any, on_bucket=None) -> _TreeWork:
        """Start the overlapped average of a gradient tree; returns a
        handle whose ``wait_tree()`` yields the averaged tree, its leaves
        new tensors on the gradients' device. CUDA leaves are handed to the
        runner untouched: their device-to-host copies are part of what
        overlaps. ``on_bucket(indices, arrays)`` (optional, flat-leaf
        indices in ``tree_flatten`` order) fires per coalesced bucket as
        its reduce lands, on the runner's reducer thread. NOTE: with
        on_bucket, the arrays are this averager's persistent landing
        buffers: consume them inside the callback, do not keep them past
        the next step."""
        from ray_tpu_torch.util import collective
        from ray_tpu_torch.util.collective import ReduceOp
        from ray_tpu_torch.util.collective.async_work import (
            _CompletedWork, fire_on_bucket, validate_on_bucket)
        from ray_tpu_torch.util.collective.collective import \
            _default_bucket_bytes

        validate_on_bucket(on_bucket)
        flat, tree = tree_flatten(grads)
        if self.world_size <= 1:
            # copies on the leaves' own devices: nothing aliases the
            # caller's gradients (the JAX averager copies to the host and
            # back; a copy on the card costs no transfer)
            leaves = [f.detach().clone() if is_tensor(f)
                      else np.array(f, copy=True) for f in flat]
            if on_bucket is not None and leaves:
                # the solo path still honors the per-bucket contract, so
                # callers keyed on bucket completion see the same sequence
                # at every world size
                fire_on_bucket(leaves, _default_bucket_bytes(), leaves,
                               on_bucket)
            return _TreeWork(_CompletedWork(self.group_name, leaves), tree,
                             likes=None)
        work = collective.allreduce_coalesced_async(
            flat, group_name=self.group_name, op=ReduceOp.MEAN,
            timeout_ms=self.timeout_ms, out=self._landing(flat),
            on_bucket=on_bucket)
        return _TreeWork(work, tree, likes=flat)

    def average(self, grads: Any) -> Any:
        """Synchronous convenience: ``begin(grads).wait_tree()``."""
        return self.begin(grads).wait_tree()

    def shutdown(self) -> None:
        """Destroy the group (fails any in-flight work cleanly)."""
        if self.world_size > 1:
            from ray_tpu_torch.util import collective

            collective.destroy_collective_group(self.group_name)
