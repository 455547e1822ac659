"""Attention dispatcher for the models' training forward.

Counterpart: ``attention`` in ``ray_tpu/ops/attention.py``. ``"auto"``
means the flash kernels on a CUDA tensor and the plain attention on a CPU
tensor; ``"flash"`` forces the flash op (on the CPU it runs the kernels'
plain versions); ``"reference"`` is plain PyTorch attention. A bias forces
the reference path. The ring impl and the paged lane resolver are not
ported.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from ray_tpu_torch.ops.flash_attention import (flash_attention,
                                               reference_attention)

ATTN_IMPLS = ("auto", "flash", "reference")


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, sm_scale: Optional[float] = None,
              impl: str = "auto", bias: Optional[torch.Tensor] = None
              ) -> torch.Tensor:
    """Multi-head / grouped-query attention. q: [B, Sq, H, D]; k, v:
    [B, Sk, Hkv, D] with H a multiple of Hkv. Returns [B, Sq, H, D]."""
    if impl not in ATTN_IMPLS:
        # a typo must not quietly run another path than the one asked for
        raise ValueError(f"unknown attention impl {impl!r}; expected one of "
                         f"{list(ATTN_IMPLS)}")
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    if bias is not None:
        impl = "reference"
    if impl == "auto":
        impl = "flash" if q.device.type == "cuda" else "reference"
    if impl == "flash":
        return flash_attention(q, k, v, sm_scale, causal)
    return reference_attention(q, k, v, sm_scale, causal, bias=bias)
