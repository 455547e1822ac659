"""Multi-agent environments + sampling.

Counterpart: ``ray_tpu/rllib/env/multi_agent_env.py``: an env steps a
*dict* of agent actions and returns per-agent obs/reward/done dicts (with
the ``"__all__"`` episode-end convention); the runner maps agents onto
policies (``policy_mapping_fn``), batches each policy's agents into ONE
forward per step on the runner's device (the card unless the caller names
the CPU), and emits one single-agent-shaped rollout batch per policy, so
the PPO learner path is reused unchanged. Needs no gymnasium.

Scope (as in the JAX package): the agent set is fixed for the episode;
every agent in ``possible_agents`` acts every step.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

import ray_tpu_torch
from ray_tpu_torch._private.device import resolve_device
from ray_tpu_torch.rllib.core.learner import (actor_device, actor_options,
                                              params_from_numpy, to_tensor)
from ray_tpu_torch.rllib.core.rl_module import RLModuleSpec, make_module


class MultiAgentEnv:
    """Dict-in / dict-out environment (reference
    `rllib/env/multi_agent_env.py:MultiAgentEnv`)."""

    #: fixed agent ids, e.g. ["agent_0", "agent_1"]
    possible_agents: List[str] = []

    def reset(self, *, seed: Optional[int] = None
              ) -> Tuple[Dict[str, np.ndarray], Dict[str, Any]]:
        raise NotImplementedError

    def step(self, actions: Dict[str, int]) -> Tuple[
            Dict[str, np.ndarray], Dict[str, float], Dict[str, bool],
            Dict[str, bool], Dict[str, Any]]:
        """Returns (obs, rewards, terminateds, truncateds, infos); the
        terminateds/truncateds dicts carry the special key "__all__"."""
        raise NotImplementedError

    def close(self) -> None:
        pass


class TargetMatchEnv(MultiAgentEnv):
    """Test/benchmark env: each agent privately observes a one-hot target and
    is rewarded for matching it; agents have *different* target mappings so
    independent policies must specialize. Episode = `episode_len` steps."""

    def __init__(self, num_agents: int = 2, num_targets: int = 4,
                 episode_len: int = 16):
        self.possible_agents = [f"agent_{i}" for i in range(num_agents)]
        self.num_targets = num_targets
        self.episode_len = episode_len
        self._rng = np.random.default_rng(0)
        self._targets: Dict[str, int] = {}
        self._t = 0

    @property
    def obs_dim(self) -> int:
        return self.num_targets

    @property
    def num_actions(self) -> int:
        return self.num_targets

    def _obs(self) -> Dict[str, np.ndarray]:
        out = {}
        for a in self.possible_agents:
            o = np.zeros(self.num_targets, np.float32)
            o[self._targets[a]] = 1.0
            out[a] = o
        return out

    def reset(self, *, seed=None):
        if seed is not None:
            self._rng = np.random.default_rng(seed)
        self._t = 0
        self._targets = {a: int(self._rng.integers(self.num_targets))
                         for a in self.possible_agents}
        return self._obs(), {}

    def step(self, actions):
        # agent_i's correct action is (target + i) % n: forces per-agent
        # policies (a single shared mapping can't be right for both)
        rewards = {}
        for i, a in enumerate(self.possible_agents):
            want = (self._targets[a] + i) % self.num_targets
            rewards[a] = 1.0 if int(actions[a]) == want else 0.0
        self._t += 1
        self._targets = {a: int(self._rng.integers(self.num_targets))
                         for a in self.possible_agents}
        done = self._t >= self.episode_len
        term = {a: done for a in self.possible_agents}
        term["__all__"] = done
        trunc = {a: False for a in self.possible_agents}
        trunc["__all__"] = False
        return self._obs(), rewards, term, trunc, {}


class MultiAgentEnvRunner:
    """Samples `num_envs` copies of a MultiAgentEnv; one batched forward per
    policy per step (agents of a policy across all env copies form the
    batch)."""

    def __init__(self, env_maker: Callable[[], MultiAgentEnv],
                 specs: Dict[str, RLModuleSpec],
                 policy_mapping_fn: Callable[[str], str],
                 num_envs: int = 4, seed: int = 0, device=None):
        # a card role in a process that sees no card raises here
        self.device = resolve_device(device)
        self._specs = specs
        self.modules = {pid: make_module(spec)
                        for pid, spec in specs.items()}
        self.params = {
            pid: m.init_params(seed + j, self.device)
            for j, (pid, m) in enumerate(self.modules.items())}
        self.envs = [env_maker() for _ in range(num_envs)]
        self.num_envs = num_envs
        self.agents = list(self.envs[0].possible_agents)
        self.policy_of = {a: policy_mapping_fn(a) for a in self.agents}
        unknown = {p for p in self.policy_of.values() if p not in specs}
        if unknown:
            raise ValueError(f"policy_mapping_fn produced unknown policies "
                             f"{unknown}; specs has {sorted(specs)}")
        unmapped = set(specs) - set(self.policy_of.values())
        if unmapped:
            raise ValueError(
                f"policies {sorted(unmapped)} have no agents mapped to "
                f"them (policy_mapping_fn covers {sorted(set(self.policy_of.values()))})")
        # column layout per policy: [(env_idx, agent_id), ...]
        self.columns: Dict[str, List[Tuple[int, str]]] = {
            pid: [] for pid in specs}
        for e in range(num_envs):
            for a in self.agents:
                self.columns[self.policy_of[a]].append((e, a))
        self._gen = torch.Generator(device=self.device).manual_seed(seed)
        self._obs = []
        for e, env in enumerate(self.envs):
            obs, _ = env.reset(seed=seed + e)
            self._obs.append(obs)
        self._ep_return = np.zeros(num_envs)
        self._finished_returns: List[float] = []
        self._finished_lens: List[int] = []
        self._ep_len = np.zeros(num_envs, np.int64)

    def set_weights(self, weights: Dict[str, Any]) -> bool:
        for pid, w in weights.items():
            self.params[pid] = params_from_numpy(w, self.device)
        return True

    def _policy_obs(self, pid: str) -> np.ndarray:
        return np.stack([self._obs[e][a] for e, a in self.columns[pid]]
                        ).astype(np.float32)

    def sample(self, num_steps: int) -> Dict[str, Dict[str, np.ndarray]]:
        """Returns {policy_id: single-agent-shaped [T, B_pol] batch}."""
        T = num_steps
        bufs: Dict[str, Dict[str, np.ndarray]] = {}
        for pid, cols in self.columns.items():
            B = len(cols)
            d = self._specs[pid].obs_dim
            bufs[pid] = {
                "obs": np.empty((T, B, d), np.float32),
                "actions": np.empty((T, B), np.int64),
                "logp": np.empty((T, B), np.float32),
                "values": np.empty((T, B), np.float32),
                "rewards": np.empty((T, B), np.float32),
                "terminateds": np.empty((T, B), np.bool_),
                "truncateds": np.empty((T, B), np.bool_),
            }

        for t in range(T):
            actions_by_env: List[Dict[str, int]] = [
                {} for _ in range(self.num_envs)]
            for pid, cols in self.columns.items():
                obs = self._policy_obs(pid)
                act, logp, val = self._explore(pid, obs)
                bufs[pid]["obs"][t] = obs
                bufs[pid]["actions"][t] = act
                bufs[pid]["logp"][t] = logp
                bufs[pid]["values"][t] = val
                for j, (e, a) in enumerate(cols):
                    actions_by_env[e][a] = int(act[j])
            for e, env in enumerate(self.envs):
                obs, rew, term, trunc, _ = env.step(actions_by_env[e])
                self._obs[e] = obs
                self._ep_return[e] += sum(rew.values())
                self._ep_len[e] += 1
                done = bool(term.get("__all__")) or bool(
                    trunc.get("__all__"))
                for pid, cols in self.columns.items():
                    for j, (ee, a) in enumerate(cols):
                        if ee != e:
                            continue
                        bufs[pid]["rewards"][t, j] = rew.get(a, 0.0)
                        bufs[pid]["terminateds"][t, j] = bool(
                            term.get(a, False))
                        bufs[pid]["truncateds"][t, j] = bool(
                            trunc.get(a, False))
                if done:
                    self._finished_returns.append(float(self._ep_return[e]))
                    self._finished_lens.append(int(self._ep_len[e]))
                    self._ep_return[e] = 0.0
                    self._ep_len[e] = 0
                    self._obs[e], _ = env.reset()

        out = {}
        for pid, cols in self.columns.items():
            with torch.no_grad():
                _, boot = self.modules[pid].forward_train(
                    self.params[pid],
                    to_tensor(self._policy_obs(pid), self.device))
            b = bufs[pid]
            b["bootstrap_value"] = boot.cpu().numpy()
            out[pid] = b
        return out

    @torch.no_grad()
    def _explore(self, pid: str, obs: np.ndarray):
        """One policy's sampled (action, logp, value) for its columns,
        read back in one copy."""
        act, logp, val = self.modules[pid].forward_exploration(
            self.params[pid], to_tensor(obs, self.device), self._gen)
        out = torch.stack([act.to(torch.float32), logp, val]).cpu()
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
        for env in self.envs:
            env.close()


class MultiAgentEnvRunnerGroup:
    """Fan-out over MultiAgentEnvRunner actors (mirror of
    EnvRunnerGroup)."""

    def __init__(self, env_maker, specs, policy_mapping_fn,
                 num_env_runners: int = 0, num_envs_per_runner: int = 4,
                 seed: int = 0, device=None):
        self._local: Optional[MultiAgentEnvRunner] = None
        self._actors: List[Any] = []
        if num_env_runners <= 0:
            self._local = MultiAgentEnvRunner(
                env_maker, specs, policy_mapping_fn,
                num_envs_per_runner, seed, device=device)
        else:
            cls = ray_tpu_torch.remote(MultiAgentEnvRunner)
            self._actors = [
                cls.options(**actor_options(device)).remote(
                    env_maker, specs, policy_mapping_fn,
                    num_envs_per_runner, seed + 1000 * i,
                    device=actor_device(device))
                for i in range(num_env_runners)]

    def set_weights(self, weights) -> None:
        if self._local is not None:
            self._local.set_weights(weights)
        else:
            ray_tpu_torch.get([a.set_weights.remote(weights)
                         for a in self._actors])

    def sample(self, num_steps: int) -> List[Dict[str, Dict[str, Any]]]:
        if self._local is not None:
            return [self._local.sample(num_steps)]
        return ray_tpu_torch.get([a.sample.remote(num_steps)
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
