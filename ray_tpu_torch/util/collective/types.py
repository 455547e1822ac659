"""Shared types for the collective API.

Analog of the reference's `python/ray/util/collective/types.py` (ReduceOp,
backend enums, option dataclasses): the fast backend is NCCL over NVLink
("nccl", a torch.distributed process group per collective group); the
slow/control backend ("host", the Gloo analog) moves host arrays over
shared-memory channels on one node and the peer-to-peer ring across nodes.
The host side of a collective is numpy: the helpers at the end turn torch
tensors into host arrays and back.
"""

from __future__ import annotations

import enum

import numpy as np


class Backend(str, enum.Enum):
    #: NCCL through torch.distributed: one ProcessGroupNCCL per group,
    #: over the worker's card (a CPU group, asked for, runs gloo).
    NCCL = "nccl"
    #: Controller-KV rendezvous over the control plane (gloo analog): works
    #: anywhere, sized for control-plane payloads (weights broadcast, metrics),
    #: not the tensor hot path.
    HOST = "host"

    @classmethod
    def parse(cls, v) -> "Backend":
        if isinstance(v, Backend):
            return v
        v = str(v).lower()
        if v in ("nccl", "cuda", "gpu"):
            return cls.NCCL
        if v in ("host", "cpu", "gloo", "kv"):
            return cls.HOST
        raise ValueError(f"unknown collective backend {v!r}; use 'nccl' or 'host'")


class ReduceOp(enum.Enum):
    SUM = "sum"
    PRODUCT = "prod"
    MAX = "max"
    MIN = "min"
    MEAN = "mean"


class CollectiveError(RuntimeError):
    """A collective failed cleanly (peer death, membership change, oversize
    payload) — never a silently wrong result."""


def reduce_ufunc(op: ReduceOp):
    """Elementwise pairwise accumulator for streaming reductions (ring
    segments, shared-memory chunk rounds). MEAN accumulates with add;
    callers divide by world_size once at the end."""
    import numpy as np

    return {
        ReduceOp.SUM: np.add,
        ReduceOp.MEAN: np.add,
        ReduceOp.PRODUCT: np.multiply,
        ReduceOp.MAX: np.maximum,
        ReduceOp.MIN: np.minimum,
    }[op]


def check_inplace_out(out, src) -> None:
    """Validate an impl-level ``out=`` result buffer (which may alias the
    input): it must be a C-contiguous ndarray of the input's dtype and
    byte size. A non-contiguous buffer would make ``out.reshape(-1)``
    a DETACHED copy — the reduce would land in a temp and the caller's
    array would stay silently stale."""
    import numpy as np

    if not isinstance(out, np.ndarray) or not out.flags.c_contiguous:
        raise ValueError(
            "collective out= buffer must be a C-contiguous ndarray")
    if out.dtype != src.dtype or out.nbytes != src.nbytes:
        raise ValueError(
            f"collective out= buffer is {out.dtype}/{out.nbytes}B but the "
            f"input is {src.dtype}/{src.nbytes}B")


def prescale_factor(op: ReduceOp, dtype, world_size: int):
    """The per-rank pre-scale that turns a MEAN into a plain SUM.

    A coalesced MEAN scales each contribution by ``1/world`` while packing
    it into the staging buffer (a multiply fused into a copy that happens
    anyway) and then reduces with SUM — so no post-reduce ``out / world``
    pass, which on a gradient tree was one full extra tree copy per step.
    Returns ``None`` when the op isn't MEAN or the dtype can't carry the
    scale (integer means fall back to SUM + one divide at unpack)."""
    import numpy as np

    if op is not ReduceOp.MEAN:
        return None
    if not np.issubdtype(np.dtype(dtype), np.inexact):
        return None
    return 1.0 / float(world_size)


# ------------------------------------------------------- tensors <-> host


def is_tensor(x) -> bool:
    """A torch tensor (without importing torch where no caller has)."""
    import sys

    torch = sys.modules.get("torch")
    return torch is not None and isinstance(x, torch.Tensor)


def numel(x) -> int:
    return int(x.numel()) if is_tensor(x) else int(np.asarray(x).size)


def host_dtype(x):
    """The numpy dtype ``x`` has in a host reduction: numpy's own, a
    tensor's numpy equivalent, float32 for a bfloat16 tensor (numpy has
    no bfloat16; the reduction runs in float32 and rounds once at the
    end)."""
    if is_tensor(x):
        import torch

        if x.dtype == torch.bfloat16:
            return np.dtype(np.float32)
        return torch.empty((), dtype=x.dtype).numpy().dtype
    return np.dtype(x.dtype)


def to_host(x, *, bits: bool = False) -> np.ndarray:
    """``x`` as a host numpy array. A tensor is copied off its device; a
    CPU tensor's array shares its memory. A bfloat16 tensor comes back
    widened to float32 for a reduction, or with ``bits`` as its int16
    bits (broadcast, gather, send: exact, half the bytes)."""
    if not is_tensor(x):
        return np.asarray(x)
    import torch

    t = x.detach()
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16) if bits else t.float()
    return t.cpu().numpy()


def from_host(arr, like):
    """A collective's host result in the caller's kind: with a tensor
    ``like``, a new tensor on ``like``'s device, in ``like``'s dtype (int16
    bits back to bfloat16; a float result of an integer MEAN stays
    float); otherwise ``arr`` as it is."""
    if not is_tensor(like):
        return arr
    import torch

    a = np.asarray(arr)
    t = torch.from_numpy(np.array(a, copy=True))
    if like.dtype == torch.bfloat16:
        t = t.view(torch.bfloat16) if a.dtype == np.int16 else \
            t.to(torch.bfloat16)
    return t.to(like.device)
