"""Attention dispatcher for the models' training forward, and the serve
scheduler's paged-attention lane resolver.

Counterpart: ``attention`` and ``resolve_paged_attn_lane`` in
``ray_tpu/ops/attention.py``. ``"auto"`` means the flash kernels on a CUDA
tensor and the plain attention on a CPU tensor; ``"flash"`` forces the
flash op (on the CPU it runs the kernels' plain versions); ``"reference"``
is plain PyTorch attention. A bias forces the reference path. The ring
impl is not ported.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from ray_tpu_torch.ops.flash_attention import (flash_attention,
                                               reference_attention)

ATTN_IMPLS = ("auto", "flash", "reference")

# the paged programs' lanes (``models/decode.py``): "cuda" and "reference"
# are the in-place lanes, both through K4's wrapper (the kernel on a CUDA
# tensor, its plain PyTorch version on a CPU one); "reference" is the CPU's
# name for it and is refused on a CUDA device. "gather" is the
# gathered-view programs (the measured baseline, chosen explicitly, never a
# fallback). The scheduler's "auto" is "cuda" on a CUDA device and
# "reference" on the CPU. JAX's "pallas" lane is the TPU kernel: the port
# has none.
PAGED_ATTN_LANES = ("cuda", "reference", "gather")
PAGED_ATTN_CHOICES = ("auto",) + PAGED_ATTN_LANES


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


def check_paged_attn_lane(lane: str, device: torch.device) -> None:
    """Raise unless the paged programs may run ``lane`` on ``device``: an
    unknown lane, and ``"reference"`` on a CUDA device (a plain version
    never serves where the card is)."""
    if lane not in PAGED_ATTN_LANES:
        raise ValueError(
            f"unknown paged attention lane {lane!r}; expected one of "
            f"{list(PAGED_ATTN_CHOICES)}")
    if lane == "reference" and torch.device(device).type == "cuda":
        raise ValueError(
            "paged attention lane 'reference' is the kernel's plain version, "
            "which serves on the CPU only; on a CUDA device use 'cuda' (or "
            "'auto') or the 'gather' baseline")


def resolve_paged_attn_lane(choice: Optional[str],
                            device: torch.device) -> str:
    """The serve scheduler's paged-attention lane for ``device``, resolved
    once, at build: ``"cuda"``, ``"reference"`` or ``"gather"``. ``None``
    means ``"auto"`` (the JAX package reads its config flag there; the
    port has no config layer). An unknown or falsy value raises rather
    than picking a lane, and so does ``"reference"`` on a CUDA device
    (``check_paged_attn_lane``); the scheduler's ``"cuda"`` lane needs the
    card."""
    choice = "auto" if choice is None else choice
    on_card = torch.device(device).type == "cuda"
    if choice == "auto":
        return "cuda" if on_card else "reference"
    check_paged_attn_lane(choice, device)
    if choice == "cuda" and not on_card:
        raise ValueError(
            f"paged attention lane 'cuda' needs a CUDA device, got {device}")
    return choice
