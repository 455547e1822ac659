"""Mixture-of-Experts layer: SwiGLU experts behind a top-k router with
per-expert capacity buckets (the GShard/Switch pattern), on one device.

Counterpart: ``init_moe_params`` and ``moe_layer`` of ``ray_tpu/ops/moe.py``.
The JAX layer dispatches through one-hot ``[N, E, C]`` tensors and einsums;
this one moves the same rows by index. Every (token, choice) row gets the
same bucket position, the same rows overflow and are dropped, each kept row
lands in its own (expert, position) slot, and a token's output is the sum
of its kept choices' expert outputs times their gates, so the result is the
JAX layer's.

Under a mesh (``ep_mesh``) whose data axes (``dp``, ``fsdp``) split the
tokens or whose ``ep`` axis splits the experts, the layer keeps the JAX
program's global semantics, as GSPMD does: the tokens are gathered over
the data axes, so the capacity, the bucket positions and the routing loss
are those of the whole batch; each ``ep`` rank runs its experts' slice of
the ``[E, C, d]`` dispatch buffer (``_maybe_ep_constraint``: the buffer
pinned ``Shard(0)`` over ``ep``), the expert outputs are gathered over
``ep``, and each rank combines its own tokens. The collectives are
explicit (``parallel/_spmd.py``), since the index dispatch has no DTensor
strategy: the gathered tokens' grads are reduce-scattered over the data
axes, the expert inputs' grads summed over ``ep``. Expert weights come in
as this rank's ``ep`` shard (``w_gate [E/ep, d, f]``).

Plain PyTorch; there is no kernel in this module.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F


def init_moe_params(generator: torch.Generator, embed_dim: int,
                    hidden_dim: int, num_experts: int, *,
                    dtype: torch.dtype = torch.float32,
                    place: Optional[Callable] = None) -> Dict[str, Any]:
    """Router ``w_router [d, E]`` and per-expert SwiGLU weights ``w_gate`` and
    ``w_up [E, d, f]``, ``w_down [E, f, d]``, all normal(0.02) as in JAX,
    drawn in float32 from ``generator`` on its device and cast to ``dtype``.
    ``place(name, tensor)``, if given, places each one as it is drawn
    (e.g. keeps this rank's shard), before the next is drawn."""
    place = place or (lambda _name, t: t)

    def normal(name, shape):
        t = torch.randn(shape, generator=generator, device=generator.device,
                        dtype=torch.float32)
        return place(name, t.mul_(0.02).to(dtype))

    d, f, e = embed_dim, hidden_dim, num_experts
    return {"w_router": normal("w_router", (d, e)),
            "w_gate": normal("w_gate", (e, d, f)),
            "w_up": normal("w_up", (e, d, f)),
            "w_down": normal("w_down", (e, f, d))}


def moe_logical_axes() -> Dict[str, Tuple[Optional[str], ...]]:
    return {
        "w_router": ("embed", None),
        "w_gate": ("expert", "embed", "mlp"),
        "w_up": ("expert", "embed", "mlp"),
        "w_down": ("expert", "mlp", "embed"),
    }


BATCH_AXES = ("dp", "fsdp")


def _spmd_axes(mesh):
    """(data axes of size > 1, whether ``ep`` splits the experts)."""
    if mesh is None:
        return (), False
    from ray_tpu_torch.parallel._spmd import axis_size

    data = tuple(a for a in BATCH_AXES if axis_size(mesh, a) > 1)
    return data, axis_size(mesh, "ep") > 1


def _maybe_ep_constraint(arr: torch.Tensor, mesh, split: bool
                         ) -> torch.Tensor:
    """This rank's ``Shard(0)`` over ``ep`` of an ``[E, C, d]`` expert
    buffer (the whole buffer unless the experts are ``split``)."""
    from ray_tpu_torch.parallel._spmd import axis_index, axis_size

    if not split:
        return arr
    n = axis_size(mesh, "ep")
    per = arr.shape[0] // n
    return arr.narrow(0, axis_index(mesh, "ep") * per, per)


def _top_k(probs: torch.Tensor, k: int):
    """The k largest entries of each row, ties broken towards the lower
    index as ``jax.lax.top_k`` breaks them (``torch.topk`` promises no
    order among equal values; a stable sort does)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[:, :k], idx[:, :k]


def moe_layer(p: Dict[str, Any], x: torch.Tensor, *, num_experts: int,
              top_k: int = 2, capacity_factor: float = 1.25,
              dtype: torch.dtype = torch.bfloat16, ep_mesh=None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: [B, S, d] -> (y: [B, S, d] in ``dtype``, aux_loss: float32 scalar).

    aux_loss is the Switch load-balancing loss
    ``E * sum_e fraction_tokens_e * mean_router_prob_e``, with the fraction
    counted over each token's first choice (over the whole batch under a
    mesh, the same on every rank). ``ep_mesh``: the mesh whose axes split
    the tokens and the experts (none: one device); x is then this
    rank's batch shard."""
    mesh = ep_mesh
    data_axes, ep_split = _spmd_axes(mesh)
    # experts the rules left whole (a count ep does not divide) run whole
    ep_split = ep_split and p["w_gate"].shape[0] != num_experts
    b, s, d = x.shape
    E, k = num_experts, top_k
    xt = x.reshape(b * s, d)
    if data_axes:
        from ray_tpu_torch.parallel import _spmd

        # the whole batch's tokens, in the global batch order
        data_group = _spmd.axis_group(mesh, data_axes)
        first = _spmd.axis_index(mesh, data_axes) * b * s
        local_rows = slice(first, first + b * s)
        xt = _spmd.all_gather(xt, data_group, dim=0, grad="sum")
    n = xt.shape[0]
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
    x_experts = xt
    if ep_split:
        from ray_tpu_torch.parallel import _spmd

        # each ep rank feeds only its experts: the grads of the tokens are
        # summed over ep
        ep_group = _spmd.axis_group(mesh, "ep")
        x_experts = _spmd.psum_grad(xt, ep_group)
    rows = x_experts.repeat_interleave(k, dim=0)
    expert_in = torch.zeros((E * capacity + 1, d), dtype=xt.dtype,
                            device=x.device).index_add(0, slot, rows)
    expert_in = expert_in[:-1].view(E, capacity, d).to(dtype)
    expert_in = _maybe_ep_constraint(expert_in, mesh, ep_split)
    gate = torch.bmm(expert_in, p["w_gate"].to(dtype))
    up = torch.bmm(expert_in, p["w_up"].to(dtype))
    expert_out = torch.bmm(F.silu(gate) * up, p["w_down"].to(dtype))
    if ep_split:
        expert_out = _spmd.all_gather(expert_out, ep_group, dim=0,
                                      grad="slice")

    # combine: each token's kept choices times their gates, the gates in
    # ``dtype`` as JAX casts them, summed in float32 and rounded once as
    # the JAX combine product accumulates
    g = gate_vals.reshape(n * k).to(dtype)
    if data_axes:  # this rank combines its own tokens
        slot = slot.view(n, k)[local_rows].reshape(-1)
        g = g.view(n, k)[local_rows].reshape(-1)
    out_rows = torch.cat([expert_out.reshape(E * capacity, d),
                          expert_out.new_zeros((1, d))])[slot]
    y = (out_rows.float() * g.float()[:, None]).view(b * s, k, d).sum(1)

    # Switch aux loss: encourage uniform routing
    fraction = F.one_hot(gate_idx[:, 0], E).float().mean(0)
    aux = E * torch.sum(fraction * probs.mean(0))
    return y.to(dtype).reshape(b, s, d), aux
