"""Advantage estimators: GAE and V-trace.

Counterpart: ``ray_tpu/rllib/utils/advantages.py``. JAX runs each as a
reversed ``lax.scan``; here each is a loop over T on tensors in the same
order, in float32, on the inputs' device (no host read: the loop's length
is the tensors' shape). Inputs may be tensors or numpy arrays.

All estimators run time-major [T, B]: T timesteps, B parallel env columns.
Episode boundaries inside a column are handled with per-step discounts
(0 where terminated) and advantage-chain resets (at terminated OR
truncated); truncated-but-not-terminated steps still bootstrap from the
recorded value of the next state.
"""

from __future__ import annotations

import numpy as np
import torch


def _t(x, device=None) -> torch.Tensor:
    if not isinstance(x, torch.Tensor):
        x = np.asarray(x)  # a read-only view (a channel slot) is copied
        x = torch.from_numpy(x if x.flags.writeable else x.copy())
    return x if device is None else x.to(device)


def _done(terminateds, truncateds, device) -> torch.Tensor:
    term = _t(terminateds, device).to(torch.float32)
    trunc = _t(truncateds, device).to(torch.float32)
    return torch.clamp(term + trunc, 0.0, 1.0)


def compute_gae(rewards, values, bootstrap_value, terminateds, truncateds,
                *, gamma: float = 0.99, lam: float = 0.95):
    """Generalized Advantage Estimation over [T, B] rollout columns.

    rewards/values/terminateds/truncateds: [T, B]; bootstrap_value: [B]
    (value of the observation after the last step of each column).
    Returns (advantages [T, B], value_targets [T, B]).

    Vector envs auto-reset, so ``values[t+1]`` at a boundary belongs to
    the NEXT episode: both the delta bootstrap and the GAE chain cut at
    terminated|truncated.
    """
    values = _t(values).to(torch.float32)
    device = values.device
    rewards = _t(rewards, device).to(torch.float32)
    boot = _t(bootstrap_value, device).to(torch.float32)
    done = _done(terminateds, truncateds, device)

    next_values = torch.cat([values[1:], boot[None]], dim=0)
    deltas = rewards + gamma * next_values * (1.0 - done) - values

    rev = []
    carry = torch.zeros_like(boot)
    for t in range(values.shape[0] - 1, -1, -1):
        carry = deltas[t] + gamma * lam * (1.0 - done[t]) * carry
        rev.append(carry)
    adv = torch.stack(rev[::-1])
    return adv, adv + values


def vtrace_returns(behaviour_logp, target_logp, rewards, values,
                   bootstrap_value, terminateds, truncateds, *,
                   gamma: float = 0.99, clip_rho: float = 1.0,
                   clip_c: float = 1.0):
    """V-trace corrected value targets + policy-gradient advantages
    (Espeholt et al. 2018). All inputs [T, B] except bootstrap_value [B].
    Returns (vs [T, B], pg_advantages [T, B]); callers detach them
    (targets, not differentiated paths)."""
    values = _t(values)
    device = values.device
    target_logp = _t(target_logp, device)
    rhos = torch.exp(target_logp - _t(behaviour_logp, device))
    clipped_rhos = torch.clamp(rhos, max=clip_rho)
    cs = torch.clamp(rhos, max=clip_c)
    done = _done(terminateds, truncateds, device)
    # auto-resetting envs: the in-rollout next value at a boundary belongs
    # to the next episode, so the discount is cut there
    discounts = gamma * (1.0 - done)
    rewards = _t(rewards, device)
    boot = _t(bootstrap_value, device)

    next_values = torch.cat([values[1:], boot[None]], dim=0)
    deltas = clipped_rhos * (rewards + discounts * next_values - values)

    rev = []
    acc = torch.zeros_like(boot, dtype=torch.float32)
    for t in range(values.shape[0] - 1, -1, -1):
        # acc carries vs_{t+1} - V(x_{t+1}); discounts[t] is already 0
        # across episode boundaries, so the recursion resets there
        acc = deltas[t] + discounts[t] * cs[t] * acc
        rev.append(acc)
    vs = values + torch.stack(rev[::-1])

    next_vs = torch.cat([vs[1:], boot[None]], dim=0)
    pg_advantages = clipped_rhos * (rewards + discounts * next_vs - values)
    return vs, pg_advantages
