"""Rotary position embeddings (RoPE), half-rotation layout (LLaMA/GPT-NeoX).
Counterpart: ``ray_tpu/ops/rotary.py``."""

from __future__ import annotations

from typing import Optional, Tuple

import torch


def rope_frequencies(head_dim: int, max_len: int, theta: float = 10000.0,
                     position_offset: int = 0
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(cos, sin) tables of shape [max_len, head_dim//2], float32, on the
    CPU. They are built once on the CPU and moved to the card by the
    caller, so the CPU and the card read the very same table values."""
    inv_freq = 1.0 / (theta ** (torch.arange(0, head_dim, 2,
                                             dtype=torch.float32)
                                / head_dim))
    pos = torch.arange(position_offset, position_offset + max_len,
                       dtype=torch.float32)
    angles = torch.outer(pos, inv_freq)
    return torch.cos(angles), torch.sin(angles)


def apply_rotary(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
                 positions: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Rotate q or k. x: [..., seq, heads, head_dim]; cos/sin: [max_len,
    hd//2]. ``positions``: optional [..., seq] integer gather indices."""
    if positions is not None:
        cos = cos[positions]
        sin = sin[positions]
    else:
        cos = cos[: x.shape[-3]]
        sin = sin[: x.shape[-3]]
    cos = cos.unsqueeze(-2)  # broadcast over heads: [..., seq, 1, hd//2]
    sin = sin.unsqueeze(-2)
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)
