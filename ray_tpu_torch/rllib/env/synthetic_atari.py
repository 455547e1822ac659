"""Atari-shaped synthetic env for throughput measurement.

Counterpart: ``ray_tpu/rllib/env/synthetic_atari.py``. ALE is not at hand;
what a "PPO-Atari env-steps/s" figure measures is the data path: 84x84x4
uint8 frames through a Nature-CNN policy with batched inference and
learner updates. This env reproduces that shape and cost with
deterministic dynamics (an index and a modulo), so a harness measures the
framework, not the emulator.

``frame_bank`` is the env's pre-generated frames (numpy, from a seed);
``torch_step``/``torch_reset`` are the vectorized mirror of the gym env's
step and auto-reset, on tensors on any device, with no host read: the
Anakin topology (``rllib/podracer.py``) steps the env on the card inside
its rollout. The gym env and its ``gym.register`` exist only when
gymnasium imports.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

try:
    import gymnasium as gym
except ImportError:  # pragma: no cover
    gym = None


def frame_bank(seed: int = 0, size: int = 32,
               shape: Tuple[int, ...] = (84, 84, 4)) -> np.ndarray:
    """The env's pre-generated frame bank (stepping = one index into it),
    so the tensor dynamics below and the gym env share bit-identical
    frames for a given seed."""
    rng = np.random.default_rng(seed)
    return rng.integers(0, 256, size=(size,) + tuple(shape), dtype=np.uint8)


# ------------------------------------------------------- tensor dynamics
#
# The gym env below is pure arithmetic (index + modulo), so it admits an
# exact vectorized mirror on tensors, which is what lets the env step run
# on the card inside the Anakin rollout.


def torch_step(frames: torch.Tensor, episode_len: int, t: torch.Tensor,
               action: torch.Tensor):
    """Vectorized mirror of ``SyntheticAtariEnv.step``: ``frames`` [N, H,
    W, C] uint8, ``t`` [B] int32 step counters, ``action`` [B] int ->
    (t_next [B] int32, obs [B, H, W, C] uint8, reward [B] float32,
    truncated [B] bool)."""
    action = action.to(torch.int32)
    t1 = t + 1
    idx = (t1 * 7 + action) % frames.shape[0]
    obs = torch.index_select(frames, 0, idx.to(torch.int64))
    reward = ((t1 + action) % 5 == 0).to(torch.float32)
    truncated = t1 >= episode_len
    return t1, obs, reward, truncated


def torch_reset(frames: torch.Tensor, t: torch.Tensor, obs: torch.Tensor,
                truncated: torch.Tensor):
    """Vectorized auto-reset (gym.vector semantics): truncated sub-envs
    restart at step 0 observing frame 0."""
    t = torch.where(truncated, torch.zeros_like(t), t)
    pad = (1,) * (obs.dim() - 1)
    obs = torch.where(truncated.reshape((-1,) + pad), frames[0][None], obs)
    return t, obs


if gym is not None:

    class SyntheticAtariEnv(gym.Env):
        metadata: Dict[str, Any] = {}

        def __init__(self, frame_skip: int = 1, episode_len: int = 1000,
                     seed: int = 0):
            self.observation_space = gym.spaces.Box(
                0, 255, shape=(84, 84, 4), dtype=np.uint8)
            self.action_space = gym.spaces.Discrete(6)
            self._episode_len = episode_len
            self._t = 0
            self._rng = np.random.default_rng(seed)
            # a small bank of pre-generated frames: stepping costs one
            # index + one reward draw, like a cheap emulator frame
            self._frames = frame_bank(seed)

        def reset(self, *, seed: Optional[int] = None,
                  options=None) -> Tuple[np.ndarray, Dict]:
            if seed is not None:
                self._rng = np.random.default_rng(seed)
            self._t = 0
            return self._frames[0], {}

        def step(self, action):
            self._t += 1
            obs = self._frames[(self._t * 7 + int(action)) % 32]
            reward = float((self._t + int(action)) % 5 == 0)
            terminated = False
            truncated = self._t >= self._episode_len
            return obs, reward, terminated, truncated, {}

    # one id for both packages: a process that imports both keeps the
    # first registration (the two classes step alike)
    if "SyntheticAtari-v0" not in gym.registry:
        gym.register(id="SyntheticAtari-v0",
                     entry_point=SyntheticAtariEnv,
                     max_episode_steps=None)
