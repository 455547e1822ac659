"""Normalization ops. Computed in float32 whatever the input dtype, then
cast back to it (counterpart: ``ray_tpu/ops/norms.py``)."""

from __future__ import annotations

import torch


def rms_norm(x: torch.Tensor, weight: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm (LLaMA-style): x * 1/sqrt(mean(x^2) + eps) * weight."""
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    out = xf * torch.reciprocal(torch.sqrt(var + eps))
    return (out * weight.float()).to(x.dtype)


def layer_norm(x: torch.Tensor, weight: torch.Tensor,
               bias: torch.Tensor | None, eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm (GPT-2-style)."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = (xf - mean).square().mean(dim=-1, keepdim=True)
    out = (xf - mean) * torch.reciprocal(torch.sqrt(var + eps))
    out = out * weight.float()
    if bias is not None:
        out = out + bias.float()
    return out.to(x.dtype)
