"""EnvRunner: sampling actors.

Counterpart: ``ray_tpu/rllib/env/single_agent_env_runner.py``. Each runner
holds a gymnasium vector env (imported when a runner is built, as the JAX
package does) and the current module weights on its device (the card
unless the caller names the CPU); ``sample(num_steps)`` steps all sub-envs
with one batched forward per step and returns a columnar rollout batch of
host numpy arrays plus finished-episode returns. Weights arrive from the
learner group each iteration. Exploration draws from a ``torch.Generator``
on the runner's device seeded by ``seed``; the epsilon mask keeps the JAX
package's host numpy draws. A runner actor on a card asks the runtime for
``num_gpus=1``; one on the CPU for ``num_cpus=1``.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

import ray_tpu_torch
from ray_tpu_torch._private.device import resolve_device
from ray_tpu_torch.rllib.core.learner import (actor_device, actor_options,
                                              params_from_numpy, to_tensor)
from ray_tpu_torch.rllib.core.rl_module import RLModuleSpec, make_module


class SingleAgentEnvRunner:
    def __init__(self, env_name: str, spec: RLModuleSpec,
                 num_envs: int = 4, seed: int = 0,
                 explore: bool = True,
                 env_config: Optional[Dict[str, Any]] = None,
                 obs_connector=None, device=None):
        import gymnasium as gym

        # a card role in a process that sees no card raises here
        self.device = resolve_device(device)
        self._spec = spec
        self.module = make_module(spec)
        kwargs = env_config or {}
        self.envs = gym.vector.SyncVectorEnv(
            [lambda: gym.make(env_name, **kwargs)
             for _ in range(num_envs)])
        self.num_envs = num_envs
        self._obs, _ = self.envs.reset(seed=seed)
        self._gen = torch.Generator(device=self.device).manual_seed(seed)
        self.params = self.module.init_params(seed, self.device)
        self._episode_returns = np.zeros(num_envs)
        self._episode_lens = np.zeros(num_envs, dtype=np.int64)
        self._finished_returns: List[float] = []
        self._finished_lens: List[int] = []
        self._explore = explore
        # env-to-module connector (rllib/connectors.py): host-side obs
        # transform ahead of the forward
        self._obs_connector = obs_connector

    def set_weights(self, weights) -> bool:
        self.params = params_from_numpy(weights, self.device)
        return True

    def _prep_obs(self, obs):
        """uint8 image obs stay uint8 (the CNN stem normalizes by /255);
        everything else is float32 for the torso."""
        if self._obs_connector is not None:
            obs = np.asarray(self._obs_connector(obs))
        if len(self._spec.obs_shape) == 3 and obs.dtype == np.uint8:
            return obs
        return obs.astype(np.float32)

    def zero_batch(self, num_steps: int) -> Dict[str, np.ndarray]:
        """A zero-filled batch with exactly ``sample(num_steps)``'s shapes
        and dtypes, WITHOUT stepping the env or advancing the RNG — the
        podracer topology packs it once at build time to size the
        fixed-shape trajectory channels (pickle-5 out-of-band buffer size
        is content-independent, so the zeros measure the real payload).
        The boundary obs is prepped once and cached, exactly like
        sample()'s own path, so a stateful obs connector sees it once."""
        cur = getattr(self, "_boundary_prepped", None)
        if cur is None:
            cur = self._prep_obs(self._obs)
            self._boundary_prepped = cur
        T, B = num_steps, self.num_envs
        obs_shape = tuple(cur.shape[1:])
        return {
            "obs": np.zeros((T, B) + obs_shape, cur.dtype),
            "actions": np.zeros((T, B), np.int64),
            "logp": np.zeros((T, B), np.float32),
            "values": np.zeros((T, B), np.float32),
            "rewards": np.zeros((T, B), np.float32),
            "terminateds": np.zeros((T, B), np.bool_),
            "truncateds": np.zeros((T, B), np.bool_),
            "next_obs": np.zeros((T, B) + obs_shape, cur.dtype),
            "bootstrap_value": np.zeros(B, np.float32),
        }

    def sample(self, num_steps: int,
               epsilon: Optional[float] = None,
               greedy: bool = False) -> Dict[str, np.ndarray]:
        """Collect `num_steps` per sub-env. Returns a columnar batch with
        shape [T, B, ...] in time-major order so GAE can be computed per
        column downstream. ``greedy=True`` takes argmax actions (value-
        based algorithms); combine with ``epsilon`` for eps-greedy."""
        T, B = num_steps, self.num_envs
        # uint8 image envs keep raw (H, W, C) frames; anything else
        # (flat specs, float-valued image envs) buffers as float32.
        # With an obs connector, the batch stores the CONNECTED obs — the
        # learner must train on exactly what the module saw. The boundary
        # obs is prepped ONCE across sample() calls (cached): re-prepping
        # would double-count it in stateful connectors (NormalizeObs).
        cur_prepped = getattr(self, "_boundary_prepped", None)
        if cur_prepped is None:
            cur_prepped = self._prep_obs(self._obs)
        obs_shape = tuple(cur_prepped.shape[1:])
        obs_dtype = cur_prepped.dtype
        obs_buf = np.empty((T, B) + obs_shape, obs_dtype)
        act_buf = np.empty((T, B), np.int64)
        logp_buf = np.empty((T, B), np.float32)
        val_buf = np.empty((T, B), np.float32)
        rew_buf = np.empty((T, B), np.float32)
        term_buf = np.empty((T, B), np.bool_)
        trunc_buf = np.empty((T, B), np.bool_)
        next_obs_buf = np.empty((T, B) + obs_shape, obs_dtype)

        for t in range(T):
            if greedy:
                action = self._forward(cur_prepped, greedy=True)
                logp = np.zeros(B, np.float32)
                value = np.zeros(B, np.float32)
            else:
                action, logp, value = self._forward(cur_prepped)
            action = np.asarray(action)
            if epsilon is not None and epsilon > 0:
                rand_mask = np.random.random(B) < epsilon
                rand_actions = np.random.randint(
                    0, self._spec.num_actions, B)
                action = np.where(rand_mask, rand_actions, action)
            next_obs, reward, term, trunc, _info = self.envs.step(action)
            next_prepped = self._prep_obs(next_obs)
            obs_buf[t] = cur_prepped
            act_buf[t] = action
            logp_buf[t] = np.asarray(logp)
            val_buf[t] = np.asarray(value)
            rew_buf[t] = reward
            term_buf[t] = term
            trunc_buf[t] = trunc
            next_obs_buf[t] = next_prepped
            self._episode_returns += reward
            self._episode_lens += 1
            done = term | trunc
            for i in np.nonzero(done)[0]:
                self._finished_returns.append(float(
                    self._episode_returns[i]))
                self._finished_lens.append(int(self._episode_lens[i]))
                self._episode_returns[i] = 0.0
                self._episode_lens[i] = 0
            self._obs = next_obs
            cur_prepped = next_prepped
        self._boundary_prepped = cur_prepped

        # bootstrap value for the final observation of every column
        with torch.no_grad():
            _, last_val = self.module.forward_train(
                self.params, to_tensor(cur_prepped, self.device))
        return {
            "obs": obs_buf, "actions": act_buf, "logp": logp_buf,
            "values": val_buf, "rewards": rew_buf,
            "terminateds": term_buf, "truncateds": trunc_buf,
            "next_obs": next_obs_buf,
            "bootstrap_value": last_val.cpu().numpy(),
        }

    @torch.no_grad()
    def _forward(self, obs: np.ndarray, greedy: bool = False):
        """One batched forward on the runner's device: greedy argmax
        actions (taken on the host, as the JAX runner does), or sampled
        (action, logp, value), read back in one copy."""
        x = to_tensor(obs, self.device)
        if greedy:
            logits = self.module.forward_inference(self.params, x)
            return logits.cpu().numpy().argmax(-1)
        action, logp, value = self.module.forward_exploration(
            self.params, x, self._gen)
        out = torch.stack([action.to(torch.float32), logp, value]).cpu()
        return (out[0].numpy().astype(np.int64), out[1].numpy(),
                out[2].numpy())

    def get_metrics(self) -> Dict[str, Any]:
        out = {
            "episode_return_mean": (float(np.mean(self._finished_returns))
                                    if self._finished_returns else None),
            "episode_len_mean": (float(np.mean(self._finished_lens))
                                 if self._finished_lens else None),
            "num_episodes": len(self._finished_returns),
        }
        self._finished_returns = []
        self._finished_lens = []
        return out

    def stop(self) -> None:
        self.envs.close()


class EnvRunnerGroup:
    """Fan-out over runner actors (`rllib/env/env_runner_group.py`)."""

    def __init__(self, env_name: str, spec: RLModuleSpec,
                 num_env_runners: int = 0, num_envs_per_runner: int = 4,
                 seed: int = 0,
                 env_config: Optional[Dict[str, Any]] = None,
                 obs_connector=None, device=None):
        self._local: Optional[SingleAgentEnvRunner] = None
        self._actors: List[Any] = []
        if num_env_runners <= 0:
            self._local = SingleAgentEnvRunner(
                env_name, spec, num_envs_per_runner, seed,
                env_config=env_config, obs_connector=obs_connector,
                device=device)
        else:
            cls = ray_tpu_torch.remote(SingleAgentEnvRunner)
            self._actors = [
                cls.options(**actor_options(device)).remote(
                    env_name, spec, num_envs_per_runner, seed + 1000 * i,
                    env_config=env_config, obs_connector=obs_connector,
                    device=actor_device(device))
                for i in range(num_env_runners)
            ]

    def set_weights(self, weights) -> None:
        if self._local is not None:
            self._local.set_weights(weights)
        else:
            ray_tpu_torch.get([a.set_weights.remote(weights)
                         for a in self._actors])

    def sample(self, num_steps: int,
               epsilon: Optional[float] = None,
               greedy: bool = False) -> List[Dict[str, np.ndarray]]:
        if self._local is not None:
            return [self._local.sample(num_steps, epsilon, greedy)]
        return ray_tpu_torch.get([a.sample.remote(num_steps, epsilon, greedy)
                            for a in self._actors])

    def get_metrics(self) -> List[Dict[str, Any]]:
        if self._local is not None:
            return [self._local.get_metrics()]
        return ray_tpu_torch.get([a.get_metrics.remote() for a in self._actors])

    def stop(self) -> None:
        if self._local is not None:
            self._local.stop()
        for a in self._actors:
            try:
                ray_tpu_torch.kill(a)
            except Exception:
                pass
