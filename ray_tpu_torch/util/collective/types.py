"""Shared types for the collective API.

Analog of the reference's `python/ray/util/collective/types.py` (ReduceOp,
backend enums, option dataclasses): the fast backend is NCCL over NVLink
("nccl", with data-parallel training, ROADMAP A5); the slow/control backend
is the peer-to-peer ring over the runtime's RPC ("host"), the Gloo analog.
"""

from __future__ import annotations

import enum


class Backend(str, enum.Enum):
    #: NCCL over NVLink through torch.distributed (not ported yet: A5).
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
