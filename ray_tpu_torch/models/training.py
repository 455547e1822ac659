"""Training step for the transformer family.

Counterpart: ``ray_tpu/models/training.py`` without a mesh (one device).
The optax chain of the JAX package, ``clip_by_global_norm`` then ``adamw``
on a warmup-cosine schedule, is written out here as plain tensor code:

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
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from ray_tpu_torch._private.device import resolve_device
from ray_tpu_torch.models.transformer import (TransformerConfig, _leaves,
                                              init_params, loss_fn,
                                              map_params)


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
        o = self.ocfg
        ps, mus, nus = _leaves(params), _leaves(state.mu), _leaves(state.nu)
        g_norm = torch.linalg.vector_norm(
            torch.stack(torch._foreach_norm(grads)))
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
        return g_norm


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
        torch._foreach_add_(_leaves(params),
                            torch._foreach_mul(grads, -self.learning_rate))


def make_optimizer(ocfg: OptimizerConfig) -> AdamW:
    return AdamW(ocfg)


def init_train_state(cfg: TransformerConfig, ocfg: OptimizerConfig,
                     seed: int = 0,
                     device: Optional[torch.device | str] = None,
                     params=None):
    """(TrainState, tx): params in ``cfg.param_dtype`` from ``seed`` (or
    ``params``, e.g. converted from JAX), zero moments, step 0, on
    ``device`` (the card unless ``"cpu"`` is asked for)."""
    device = resolve_device(device)
    tx = make_optimizer(ocfg)
    if params is None:
        params = init_params(cfg, seed, device, param_dtype=cfg.param_dtype)
    else:
        params = map_params(lambda _p, t: t.to(device, cfg.param_dtype),
                            params)
    params = map_params(lambda _p, t: t.detach().requires_grad_(True),
                        params)
    return TrainState(params=params, opt_state=tx.init(params), step=0), tx


def make_train_step(cfg: TransformerConfig, tx: AdamW,
                    loss: Optional[Callable] = None,
                    log_grad_norm: bool = True):
    """Returns ``step(state, batch) -> (state, metrics)``. batch:
    {'tokens': [B, S] int, optional 'mask': [B, S]}, moved to the params'
    device; metrics: 'loss', 'tokens' and (with ``log_grad_norm``)
    'grad_norm', as 0-dim tensors on that device."""
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
