"""Training step for the transformer family, on one device or on a mesh.

Counterpart: ``ray_tpu/models/training.py``. The optax chain of the JAX
package, ``clip_by_global_norm`` then ``adamw`` on a warmup-cosine
schedule, is written out here as plain tensor code:

  * clip: g <- g * (max / |g|) only when |g| >= max (no epsilon);
  * adam: mu <- (1 - b1) g + b1 mu, nu <- (1 - b2) g^2 + b2 nu, bias
    corrected at t = count + 1, update = mu_hat / (sqrt(nu_hat) + 1e-8);
  * weight decay on every leaf: update += wd * p;
  * the learning rate is the schedule at the count BEFORE this update, so
    the first step's rate is schedule(0) = 0 and it leaves the params as
    they were;
  * grad_norm is the norm of the raw, unclipped grads.

The port updates the params and the moments in place (``torch._foreach_*``)
and the step returns the same ``TrainState`` it was given; the JAX step
returns a new one. The count and the step live on the host, so the
schedule and the bias corrections are host scalars and the step never waits
for the card.

On a mesh (``parallel/mesh.py``'s ``DeviceMesh``) the params and both Adam
moments are DTensors placed by the rules of ``parallel/sharding.py`` (the
moments follow their params; the count and the step stay host scalars).
The step then runs as the JAX package's jitted program does, in SPMD form
on each rank:

  * the batch's dim 0 is split over the ``dp``/``fsdp`` dims present;
  * each param is gathered over every mesh dim but ``tp`` (and ``ep`` for
    the experts): ``redistribute``, whose backward reduce-scatters the
    grads over ``fsdp`` and all-reduces them over ``dp``. A block's params
    are gathered inside the block's call, so under remat the gather runs
    again in backward and one block's gathered params are held at a time
    (without remat autograd keeps them for the backward);
  * over ``tp`` the attention runs on this rank's heads and the dense MLP
    on its ffn columns (Megatron, ``transformer._spmd_block``) where the
    layout splits them; a replicated kv head set is narrowed to the kv
    heads of this rank's query heads;
  * the embedding table and the lm_head are gathered over ``tp`` as well:
    the fused cross-entropy then runs unchanged on the whole vocab (a
    vocab-parallel logsumexp would save the gather; at the widths tested
    the gather is small beside the step);
  * the kernels (flash attention, K1-K3) take each rank's local shards;
  * the loss is the global batch's mean: each rank's share is its tokens'
    sum over the global token count;
  * the clip's global norm sums each grad shard's squares once (a
    replicated shard on one rank only) and all-reduces them once, so it is
    the meshless norm; the AdamW update then runs on the local shards.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from ray_tpu_torch._private.device import resolve_device
from ray_tpu_torch.models.transformer import (TransformerConfig, _leaves,
                                              init_params, logical_axes,
                                              loss_fn, map_params)


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    learning_rate: float = 3e-4
    weight_decay: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    grad_clip: float = 1.0
    warmup_steps: int = 100
    decay_steps: int = 10000
    min_lr_ratio: float = 0.1


@dataclasses.dataclass
class AdamWState:
    """optax's ScaleByAdamState (count, mu, nu); the schedule's own count
    always equals ``count``. mu and nu are trees shaped like the params."""
    count: int
    mu: Any
    nu: Any


@dataclasses.dataclass
class TrainState:
    params: Any
    opt_state: AdamWState
    step: int


def _f32(x: float) -> float:
    return float(np.float32(x))


class AdamW:
    """``make_optimizer``'s chain: ``init(params)`` and ``update(grads,
    state, params)``, which applies the update to ``params`` in place."""

    eps = 1e-8

    def __init__(self, ocfg: OptimizerConfig):
        self.ocfg = ocfg
        self.decay_steps = max(ocfg.decay_steps, ocfg.warmup_steps + 1)

    def schedule(self, count: int) -> float:
        """optax.warmup_cosine_decay_schedule(0, peak, warmup, decay, end)
        in float32: linear from 0 to the peak over the warmup, then a
        cosine to peak * min_lr_ratio over decay - warmup steps."""
        o = self.ocfg
        peak = np.float32(o.learning_rate)
        if count < o.warmup_steps:
            frac = np.float32(1) - np.float32(count) / np.float32(
                o.warmup_steps)
            return float(-peak * frac + peak)
        steps = self.decay_steps - o.warmup_steps
        t = np.float32(min(count - o.warmup_steps, steps))
        alpha = np.float32(o.min_lr_ratio)
        cosine = np.float32(0.5) * (np.float32(1) + np.cos(
            np.float32(math.pi) * t / np.float32(steps), dtype=np.float32))
        return float(peak * ((np.float32(1) - alpha) * cosine + alpha))

    def init(self, params) -> AdamWState:
        def zeros(_path, p):
            return torch.zeros_like(p, requires_grad=False)

        return AdamWState(count=0, mu=map_params(zeros, params),
                          nu=map_params(zeros, params))

    @torch.no_grad()
    def update(self, grads: List[torch.Tensor], state: AdamWState,
               params) -> torch.Tensor:
        """One step over the leaves, in place; returns the raw grad norm."""
        g_norm = torch.linalg.vector_norm(
            torch.stack(torch._foreach_norm(grads)))
        self.update_leaves(grads, state, _leaves(params), _leaves(state.mu),
                           _leaves(state.nu), g_norm)
        return g_norm

    @torch.no_grad()
    def update_leaves(self, grads: List[torch.Tensor], state: AdamWState,
                      ps: List[torch.Tensor], mus: List[torch.Tensor],
                      nus: List[torch.Tensor], g_norm: torch.Tensor) -> None:
        """``update`` on leaf lists (a mesh's local shards), given the
        global grad norm."""
        o = self.ocfg
        # clip_by_global_norm: scale only when |g| >= max
        scale = torch.where(g_norm < o.grad_clip, 1.0,
                            o.grad_clip / g_norm)
        grads = torch._foreach_mul(grads, scale)
        b1, b2 = _f32(o.b1), _f32(o.b2)
        torch._foreach_mul_(mus, b1)
        torch._foreach_add_(mus, grads, alpha=_f32(1 - o.b1))
        torch._foreach_mul_(nus, b2)
        torch._foreach_addcmul_(nus, grads, grads, value=_f32(1 - o.b2))
        t = state.count + 1
        bc1 = _f32(1 - np.float32(o.b1) ** np.float32(t))
        bc2 = _f32(1 - np.float32(o.b2) ** np.float32(t))
        denom = torch._foreach_div(nus, bc2)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, self.eps)
        upd = torch._foreach_div(mus, bc1)
        torch._foreach_div_(upd, denom)
        if o.weight_decay:  # adam (no decay) skips a pass over the leaves
            torch._foreach_add_(upd, ps, alpha=_f32(o.weight_decay))
        torch._foreach_add_(ps, upd, alpha=-self.schedule(state.count))
        state.count = t


class SGD:
    """``optax.sgd(lr)`` without momentum, in the shape of ``AdamW``:
    ``init(params)`` (no state) and ``update(grads, state, params)``,
    which applies ``p + (-lr * g)`` to ``params`` in place (two roundings,
    as optax's scale then apply_updates)."""

    def __init__(self, learning_rate: float):
        self.learning_rate = float(learning_rate)

    def init(self, params) -> None:
        return None

    @torch.no_grad()
    def update(self, grads: List[torch.Tensor], state, params) -> None:
        self.update_leaves(grads, state, _leaves(params), None, None, None)

    @torch.no_grad()
    def update_leaves(self, grads, state, ps, mus, nus, g_norm) -> None:
        torch._foreach_add_(ps, torch._foreach_mul(grads, -self.learning_rate))


def make_optimizer(ocfg: OptimizerConfig) -> AdamW:
    return AdamW(ocfg)


def _mesh_device(mesh, device) -> torch.device:
    if device is not None:
        return resolve_device(device)
    if mesh.device_type == "cpu":
        return resolve_device("cpu")
    return resolve_device(None)


def _shard_placer(cfg: TransformerConfig, mesh, rules):
    """``place(path, tensor)``: the leaf at ``path`` as a DTensor placed by
    ``rules`` on its logical axes (``sharding.param_specs``'s spec)."""
    from ray_tpu_torch.parallel.sharding import (ShardingRules,
                                                 sanitize_spec, shard_tensor)

    rules = rules or ShardingRules()
    logical: Dict[str, Any] = {}
    map_params(logical.__setitem__, logical_axes(cfg))

    def place(path, t):
        spec = sanitize_spec(rules.spec(logical[path], mesh),
                             tuple(t.shape), mesh)
        return shard_tensor(t, spec, mesh)

    return place


def init_train_state(cfg: TransformerConfig, ocfg: OptimizerConfig,
                     seed: int = 0,
                     device: Optional[torch.device | str] = None,
                     params=None, mesh=None, rules=None):
    """(TrainState, tx): params in ``cfg.param_dtype`` from ``seed`` (or
    ``params``, e.g. converted from JAX), zero moments, step 0, on
    ``device`` (the card unless ``"cpu"`` is asked for).

    With ``mesh`` (a ``DeviceMesh``; ``device`` defaults to the mesh's),
    every leaf is a DTensor placed by ``rules`` (``ShardingRules()`` by
    default) on ``transformer.logical_axes(cfg)``, and the moments follow
    their params. Each rank draws the tree from the same seed and keeps
    its shard of each leaf before the next is drawn, so it never holds
    more than its shards and one whole leaf (given ``params``, the same on
    every rank, it keeps its shards of them); nothing is sent."""
    device = _mesh_device(mesh, device) if mesh is not None else \
        resolve_device(device)
    tx = make_optimizer(ocfg)
    place = None if mesh is None else _shard_placer(cfg, mesh, rules)
    if params is None:
        params = init_params(cfg, seed, device, param_dtype=cfg.param_dtype,
                             place=place)
    else:
        params = map_params(lambda _p, t: t.to(device, cfg.param_dtype),
                            params)
        if place is not None:
            params = map_params(place, params)
    params = map_params(lambda _p, t: t.detach().requires_grad_(True),
                        params)
    return TrainState(params=params, opt_state=tx.init(params), step=0), tx


def make_train_step(cfg: TransformerConfig, tx: AdamW, mesh=None,
                    rules=None, loss: Optional[Callable] = None,
                    log_grad_norm: bool = True, batch_sharding=None):
    """Returns ``step(state, batch) -> (state, metrics)``. batch:
    {'tokens': [B, S] int, optional 'mask': [B, S]}, moved to the params'
    device; metrics: 'loss', 'tokens' and (with ``log_grad_norm``)
    'grad_norm', as 0-dim tensors on that device.

    With ``mesh``, ``state`` is ``init_train_state(..., mesh=mesh)``'s and
    each batch leaf is the global batch (the same on every rank, or a
    DTensor), split by ``batch_sharding`` (``data_sharding(mesh)`` by
    default: dim 0 over the ``dp``/``fsdp`` dims present); the metrics come
    back the same on every rank. ``rules`` is accepted for the JAX
    signature: the state's own placements say the layout. A custom
    ``loss(params, batch) -> (value, metrics)`` on a mesh sees this rank's
    local params and batch shard and returns its shard's mean, weighted by
    ``metrics["tokens"]``; it passes the mesh to the ops that need one
    (``loss_fn``'s ``mesh``)."""
    if mesh is not None:
        from ray_tpu_torch.models import _mesh_step

        return _mesh_step.make_mesh_train_step(
            cfg, tx, mesh, loss=loss, log_grad_norm=log_grad_norm,
            batch_sharding=batch_sharding)
    loss = loss or (lambda p, b: loss_fn(cfg, p, b))

    def step(state: TrainState, batch: Dict[str, Any]):
        leaves = _leaves(state.params)
        device = leaves[0].device
        batch = {k: torch.as_tensor(v, device=device)
                 for k, v in batch.items()}
        value, metrics = loss(state.params, batch)
        grads = list(torch.autograd.grad(value, leaves))
        g_norm = tx.update(grads, state.opt_state, state.params)
        metrics = {k: v.detach() for k, v in metrics.items()}
        if log_grad_norm:
            metrics["grad_norm"] = g_norm
        state.step += 1
        return state, metrics

    return step
