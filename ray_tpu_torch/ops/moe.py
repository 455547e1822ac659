"""Mixture-of-Experts layer: SwiGLU experts behind a top-k router with
per-expert capacity buckets (the GShard/Switch pattern), on one device.

Counterpart: ``init_moe_params`` and ``moe_layer`` of ``ray_tpu/ops/moe.py``.
The JAX layer dispatches through one-hot ``[N, E, C]`` tensors and einsums;
this one moves the same rows by index. Every (token, choice) row gets the
same bucket position, the same rows overflow and are dropped, each kept row
lands in its own (expert, position) slot, and a token's output is the sum
of its kept choices' expert outputs times their gates, so the result is the
JAX layer's. The expert-parallel sharding constraint is not ported: it does
nothing on one device.

Plain PyTorch; there is no kernel in this module.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Tuple

import torch
import torch.nn.functional as F


def init_moe_params(generator: torch.Generator, embed_dim: int,
                    hidden_dim: int, num_experts: int, *,
                    dtype: torch.dtype = torch.float32) -> Dict[str, Any]:
    """Router ``w_router [d, E]`` and per-expert SwiGLU weights ``w_gate`` and
    ``w_up [E, d, f]``, ``w_down [E, f, d]``, all normal(0.02) as in JAX,
    drawn in float32 from ``generator`` on its device and cast to ``dtype``."""
    def normal(shape):
        t = torch.randn(shape, generator=generator, device=generator.device,
                        dtype=torch.float32)
        return t.mul_(0.02).to(dtype)

    d, f, e = embed_dim, hidden_dim, num_experts
    return {"w_router": normal((d, e)), "w_gate": normal((e, d, f)),
            "w_up": normal((e, d, f)), "w_down": normal((e, f, d))}


def _top_k(probs: torch.Tensor, k: int):
    """The k largest entries of each row, ties broken towards the lower
    index as ``jax.lax.top_k`` breaks them (``torch.topk`` promises no
    order among equal values; a stable sort does)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[:, :k], idx[:, :k]


def moe_layer(p: Dict[str, Any], x: torch.Tensor, *, num_experts: int,
              top_k: int = 2, capacity_factor: float = 1.25,
              dtype: torch.dtype = torch.bfloat16
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: [B, S, d] -> (y: [B, S, d] in ``dtype``, aux_loss: float32 scalar).

    aux_loss is the Switch load-balancing loss
    ``E * sum_e fraction_tokens_e * mean_router_prob_e``, with the fraction
    counted over each token's first choice."""
    b, s, d = x.shape
    n, E, k = b * s, num_experts, top_k
    xt = x.reshape(n, d)
    logits = xt @ p["w_router"].to(dtype)
    probs = torch.softmax(logits.float(), dim=-1)                 # [N, E]

    # top-k gate weights, renormalised over the chosen experts
    gate_vals, gate_idx = _top_k(probs, k)                        # [N, k]
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True),
                                        min=1e-9)

    # top-k routing makes k*n assignments; capacity scales with k
    capacity = max(1, int(math.ceil(n * k / E * capacity_factor)))

    # bucket position of each (token, choice) row, token-major: the rows
    # before it that chose the same expert
    expert = gate_idx.reshape(n * k)
    one_hot = F.one_hot(expert, E)                                # [N*k, E]
    position = (one_hot.cumsum(0) - one_hot).gather(1, expert[:, None])[:, 0]
    keep = position < capacity
    # overflow rows are dropped: they go to a spare slot past the buckets,
    # which is never read back (JAX clamps their position to capacity - 1
    # and masks them out of the one-hot dispatch)
    slot = expert * capacity + torch.clamp(position, max=capacity - 1)
    slot = torch.where(keep, slot, torch.full_like(slot, E * capacity))

    # dispatch: each kept row's token into its own (expert, position) slot
    rows = xt.repeat_interleave(k, dim=0)
    expert_in = torch.zeros((E * capacity + 1, d), dtype=xt.dtype,
                            device=x.device).index_add(0, slot, rows)
    expert_in = expert_in[:-1].view(E, capacity, d).to(dtype)
    gate = torch.bmm(expert_in, p["w_gate"].to(dtype))
    up = torch.bmm(expert_in, p["w_up"].to(dtype))
    expert_out = torch.bmm(F.silu(gate) * up, p["w_down"].to(dtype))

    # combine: each token's kept choices times their gates, the gates in
    # ``dtype`` as JAX casts them, summed in float32 and rounded once as
    # the JAX combine product accumulates
    out_rows = torch.cat([expert_out.reshape(E * capacity, d),
                          expert_out.new_zeros((1, d))])[slot]
    g = gate_vals.reshape(n * k).to(dtype)
    y = (out_rows.float() * g.float()[:, None]).view(n, k, d).sum(1)

    # Switch aux loss: encourage uniform routing
    fraction = F.one_hot(gate_idx[:, 0], E).float().mean(0)
    aux = E * torch.sum(fraction * probs.mean(0))
    return y.to(dtype).reshape(b, s, d), aux
