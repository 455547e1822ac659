"""SAC: Soft Actor-Critic for continuous control.

Counterpart: ``ray_tpu/rllib/algorithms/sac.py``: one params tree
(squashed-Gaussian actor, twin Q critics, the 0-d ``log_alpha``) trains
under ONE combined loss; detached copies route each term to its own
weights, and the actor's reparameterized sample rides normal noise drawn
on the host (numpy, in the JAX package's order) inside the batch, so the
Learner stays a pure (batch) -> (loss) machine. TD targets use
polyak-averaged target critics that the algorithm holds, computed on
the learners' device (the DQN pattern at ``dqn.py``).

The env runners hold a gymnasium vector env (imported where the JAX
package imports it); their warmup actions are numpy draws, their
exploration noise comes from a ``torch.Generator`` on the runner's
device. A config with no env (``env=None``, explicit ``observation_dim``
and ``num_actions``) builds no runners: the algorithm then learns from
what is added to ``replay``.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Optional

import numpy as np
import torch

import ray_tpu_torch
from ray_tpu_torch._private.device import resolve_device
from ray_tpu_torch.models.transformer import map_params
from ray_tpu_torch.rllib.algorithms.algorithm import Algorithm
from ray_tpu_torch.rllib.algorithms.algorithm_config import AlgorithmConfig
from ray_tpu_torch.rllib.core.learner import (LearnerGroup, actor_device,
                                              actor_options,
                                              params_from_numpy, to_tensor)
from ray_tpu_torch.rllib.core.rl_module import (RLModuleSpec, _init_linear,
                                                params_to)
from ray_tpu_torch.rllib.utils.replay_buffers import ReplayBuffer

LOG_STD_MIN, LOG_STD_MAX = -20.0, 2.0


def detached(tree):
    """The params tree with every leaf detached (``stop_gradient``)."""
    return map_params(lambda _p, t: t.detach(), tree)


def polyak(target, weights, tau: float):
    """``(1 - tau) * t + tau * w`` over two numpy trees of one shape, in
    numpy's arithmetic, as the JAX package's ``jax.tree.map`` does."""
    if isinstance(target, dict):
        return {k: polyak(v, weights[k], tau) for k, v in target.items()}
    if isinstance(target, list):
        return [polyak(t, w, tau) for t, w in zip(target, weights)]
    return (1 - tau) * target + tau * np.asarray(weights)


class SACModule:
    """Continuous actor-critic: tanh-squashed Gaussian policy +
    twin Q(s, a) heads. `spec.num_actions` is the action dimension."""

    def __init__(self, spec: RLModuleSpec):
        self.spec = spec

    # -------------------------------------------------------------- params

    @staticmethod
    def _mlp_params(gen, sizes):
        return [_init_linear(gen, sizes[i], sizes[i + 1],
                             scale=1.0 if i < len(sizes) - 2 else 0.01)
                for i in range(len(sizes) - 1)]

    def init_params(self, seed: int = 0, device=None) -> Dict[str, Any]:
        """Params drawn on the CPU from ``seed``, then moved to ``device``
        (the card unless the caller names the CPU)."""
        device = resolve_device(device)
        gen = torch.Generator().manual_seed(int(seed))
        d, a = self.spec.obs_dim, self.spec.num_actions
        h = list(self.spec.hiddens)
        return params_to({
            "actor": self._mlp_params(gen, [d] + h + [2 * a]),
            "q1": self._mlp_params(gen, [d + a] + h + [1]),
            "q2": self._mlp_params(gen, [d + a] + h + [1]),
            "log_alpha": torch.zeros(()),
        }, device)

    # ------------------------------------------------------------- forward

    @staticmethod
    def _mlp(layers, x):
        for i, lyr in enumerate(layers):
            x = x @ lyr["w"] + lyr["b"]
            if i < len(layers) - 1:
                x = torch.relu(x)
        return x

    def actor_dist(self, params, obs):
        out = self._mlp(params["actor"], obs)
        mean, log_std = torch.chunk(out, 2, dim=-1)
        return mean, torch.clamp(log_std, LOG_STD_MIN, LOG_STD_MAX)

    def sample_action(self, params, obs, noise):
        """Reparameterized tanh-Gaussian sample -> (action, logp)."""
        mean, log_std = self.actor_dist(params, obs)
        std = torch.exp(log_std)
        pre = mean + std * noise
        act = torch.tanh(pre)
        # N(pre; mean, std) log-density, then the tanh change of variables
        logp = (-0.5 * torch.square(noise) - log_std
                - 0.5 * math.log(2 * math.pi)).sum(-1)
        logp = logp - torch.log(1.0 - torch.square(act) + 1e-6).sum(-1)
        return act, logp

    def q_value(self, qlayers, obs, act):
        return self._mlp(qlayers, torch.cat([obs, act], -1))[:, 0]

    # Learner-surface parity shims (get_weights paths treat params opaquely)
    def forward_train(self, params, obs):  # pragma: no cover - parity only
        return self.actor_dist(params, obs)


class ContinuousEnvRunner:
    """Box-action env sampler (gymnasium vector env + SACModule policy);
    actions scaled from tanh's [-1, 1] to the env's bounds."""

    def __init__(self, env_name: str, spec: RLModuleSpec, num_envs: int = 1,
                 seed: int = 0, warmup_random_steps: int = 0,
                 env_config: Optional[Dict[str, Any]] = None, device=None):
        import gymnasium as gym

        # a card role in a process that sees no card raises here
        self.device = resolve_device(device)
        self._spec = spec
        self.module = SACModule(spec)
        self.envs = gym.vector.SyncVectorEnv(
            [lambda: gym.make(env_name, **(env_config or {}))
             for _ in range(num_envs)])
        self.num_envs = num_envs
        low = self.envs.single_action_space.low
        high = self.envs.single_action_space.high
        self._act_mid = (high + low) / 2.0
        self._act_half = (high - low) / 2.0
        self._obs, _ = self.envs.reset(seed=seed)
        self._gen = torch.Generator(device=self.device).manual_seed(seed)
        self.params = self.module.init_params(seed, self.device)
        self._steps = 0
        self._warmup = warmup_random_steps
        self._rng = np.random.default_rng(seed)
        self._ep_ret = np.zeros(num_envs)
        self._ep_len = np.zeros(num_envs, np.int64)
        self._finished_returns: List[float] = []
        self._finished_lens: List[int] = []

    def set_weights(self, weights) -> bool:
        self.params = params_from_numpy(weights, self.device)
        return True

    @torch.no_grad()
    def _act(self, noise) -> np.ndarray:
        obs = to_tensor(self._obs.astype(np.float32), self.device)
        act, _ = self.module.sample_action(self.params, obs, noise)
        return act.cpu().numpy()

    def sample(self, num_steps: int, epsilon=None,
               greedy: bool = False) -> Dict[str, np.ndarray]:
        """Row-flat batch: [T*B] transitions for the replay buffer.
        greedy=True (evaluation) acts with tanh(mean), no exploration."""
        a_dim = self._spec.num_actions
        rows = {k: [] for k in ("obs", "actions", "rewards", "next_obs",
                                "terminateds", "truncateds")}
        for _ in range(num_steps):
            if greedy:
                act = self._act(torch.zeros((self.num_envs, a_dim),
                                            device=self.device))
            elif self._steps < self._warmup:
                act = self._rng.uniform(-1, 1,
                                        (self.num_envs, a_dim)).astype(
                                            np.float32)
            else:
                act = self._act(torch.randn(
                    (self.num_envs, a_dim), generator=self._gen,
                    device=self.device))
            env_act = self._act_mid + act * self._act_half
            nxt, rew, term, trunc, _ = self.envs.step(
                env_act.astype(np.float32))
            rows["obs"].append(self._obs.astype(np.float32))
            rows["actions"].append(act.astype(np.float32))
            rows["rewards"].append(np.asarray(rew, np.float32))
            rows["next_obs"].append(nxt.astype(np.float32))
            rows["terminateds"].append(term)
            rows["truncateds"].append(trunc)
            self._ep_ret += rew
            self._ep_len += 1
            for i in np.nonzero(term | trunc)[0]:
                self._finished_returns.append(float(self._ep_ret[i]))
                self._finished_lens.append(int(self._ep_len[i]))
                self._ep_ret[i] = 0.0
                self._ep_len[i] = 0
            self._obs = nxt
            self._steps += self.num_envs
        return {k: (np.concatenate(v) if np.ndim(v[0]) > 1
                    else np.stack(v).reshape(-1))
                for k, v in rows.items()}

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


class _ContinuousRunnerGroup:
    def __init__(self, env_name, spec, num_env_runners=0,
                 num_envs_per_runner=1, seed=0, warmup=0, env_config=None,
                 device=None):
        self._local: Optional[ContinuousEnvRunner] = None
        self._actors: List[Any] = []
        if num_env_runners <= 0:
            self._local = ContinuousEnvRunner(
                env_name, spec, num_envs_per_runner, seed, warmup,
                env_config, device=device)
        else:
            cls = ray_tpu_torch.remote(ContinuousEnvRunner)
            self._actors = [cls.options(**actor_options(device)).remote(
                env_name, spec, num_envs_per_runner, seed + 1000 * i,
                warmup, env_config, device=actor_device(device))
                for i in range(num_env_runners)]

    def set_weights(self, w):
        if self._local is not None:
            self._local.set_weights(w)
        else:
            ray_tpu_torch.get([a.set_weights.remote(w) for a in self._actors])

    def sample(self, n, epsilon=None, greedy=False):
        if self._local is not None:
            return [self._local.sample(n, epsilon, greedy)]
        return ray_tpu_torch.get([a.sample.remote(n, epsilon, greedy)
                                  for a in self._actors])

    def get_metrics(self):
        if self._local is not None:
            return [self._local.get_metrics()]
        return ray_tpu_torch.get([a.get_metrics.remote()
                                  for a in self._actors])

    def stop(self):
        if self._local is not None:
            self._local.stop()
        for a in self._actors:
            try:
                ray_tpu_torch.kill(a)
            except Exception:
                pass


class _NoRunnerGroup:
    """No environment sampling: offline data, or a replay filled by the
    caller."""

    def set_weights(self, w) -> None:
        pass

    def sample(self, n, epsilon=None, greedy=False):
        return []

    def get_metrics(self):
        return []

    def stop(self) -> None:
        pass


class SACConfig(AlgorithmConfig):
    def __init__(self):
        super().__init__()
        self.tau: float = 0.005                   # polyak rate
        self.initial_alpha: float = 1.0
        self.target_entropy: Optional[float] = None  # None => -action_dim
        self.replay_buffer_capacity: int = 100_000
        self.num_steps_sampled_before_learning_starts: int = 1000
        self.warmup_random_steps: int = 1000
        self.train_batch_size: int = 256
        self.updates_per_iteration: int = 32
        self.lr = 3e-4
        self.rollout_fragment_length = 32
        self.num_envs_per_env_runner = 1

    def rl_module_spec(self) -> RLModuleSpec:
        obs_dim, act_dim = self.observation_dim, self.num_actions
        if obs_dim is None or act_dim is None:
            import gymnasium as gym

            probe = gym.make(self.env, **self.env_config)
            try:
                obs_dim = obs_dim or int(probe.observation_space.shape[0])
                act_dim = act_dim or int(probe.action_space.shape[0])
            finally:
                probe.close()
        return RLModuleSpec(
            obs_dim=obs_dim, num_actions=act_dim,
            hiddens=tuple(self.model.get("hiddens", (256, 256))),
            dist_type="gaussian", module_class=SACModule)


class SAC(Algorithm):
    def __init__(self, config: SACConfig):
        import time as _time

        # continuous env + custom module: bypass the discrete base wiring
        if (config.env_to_module_connector is not None
                or config.learner_connector is not None):
            raise ValueError(
                "connector pipelines are not wired into SAC's continuous "
                "runner/learner yet")
        self.config = config
        self.iteration = 0
        self._total_env_steps = 0
        self._start = _time.time()
        self.spec = config.rl_module_spec()
        self.learner_groups = None
        if config.env is None:
            self.env_runner_group = _NoRunnerGroup()
        else:
            self.env_runner_group = _ContinuousRunnerGroup(
                config.env, self.spec,
                num_env_runners=config.num_env_runners,
                num_envs_per_runner=config.num_envs_per_env_runner,
                seed=config.seed, warmup=config.warmup_random_steps,
                env_config=config.env_config,
                device=config.env_runner_device)
        self._init_learner(config)
        self._sync_weights()

    def _init_learner(self, config: SACConfig) -> None:
        """The learner group, replay, target critics and host rng (shared
        with CQL)."""
        self.learner_group = LearnerGroup(
            self.spec, type(self).loss_fn,
            optimizer_config={"lr": config.lr,
                              "grad_clip": config.grad_clip},
            num_learners=config.num_learners, seed=config.seed,
            device=config.learner_device)
        self.replay = ReplayBuffer(config.replay_buffer_capacity,
                                   seed=config.seed)
        self._target_q = self.learner_group.get_weights()
        # the target function runs where the learners do
        self._device = resolve_device(config.learner_device)
        self._module = SACModule(self.spec)
        self._rng = np.random.default_rng(config.seed)

    @classmethod
    def get_default_config(cls) -> SACConfig:
        return SACConfig()

    def _make_eval_runner_group(self):
        cfg = self.config
        return _ContinuousRunnerGroup(
            cfg.env, self.spec,
            num_env_runners=cfg.evaluation_num_env_runners,
            num_envs_per_runner=cfg.num_envs_per_env_runner,
            seed=cfg.seed + 77_777, warmup=0, env_config=cfg.env_config,
            device=cfg.env_runner_device)

    # ------------------------------------------------------------------ loss

    @staticmethod
    def loss_fn(module, params, batch, cfg):
        obs = batch["obs"]
        # critic: twin Q vs the algorithm's soft targets
        q1 = module.q_value(params["q1"], obs, batch["actions"])
        q2 = module.q_value(params["q2"], obs, batch["actions"])
        critic_loss = (torch.mean((q1 - batch["targets"]) ** 2)
                       + torch.mean((q2 - batch["targets"]) ** 2))

        # actor: fresh reparameterized action; Q params frozen here
        act, logp = module.sample_action(params, obs, batch["noise"])
        qp1 = detached(params["q1"])
        qp2 = detached(params["q2"])
        q_min = torch.minimum(module.q_value(qp1, obs, act),
                              module.q_value(qp2, obs, act))
        alpha = torch.exp(params["log_alpha"].detach())
        actor_loss = torch.mean(alpha * logp - q_min)

        # temperature: match target entropy
        alpha_loss = -torch.mean(
            params["log_alpha"]
            * (logp + cfg["target_entropy"]).detach())

        total = critic_loss + actor_loss + alpha_loss
        return total, {"critic_loss": critic_loss,
                       "actor_loss": actor_loss,
                       "alpha": alpha,
                       "mean_q": torch.mean(q_min),
                       "entropy": -torch.mean(logp)}

    # ------------------------------------------------------------- training

    @torch.no_grad()
    def _compute_targets(self, batch, weights):
        """Soft TD targets r + gamma (min target-Q(s', a') - alpha logp')."""
        noise = self._rng.standard_normal(
            (len(batch["rewards"]), self.spec.num_actions)).astype(
                np.float32)
        done = batch["terminateds"].astype(np.float32)
        dev, module = self._device, self._module
        tq = params_from_numpy(self._target_q, dev)
        actor_params = params_from_numpy(weights, dev)
        next_obs = to_tensor(batch["next_obs"], dev)
        act, logp = module.sample_action(actor_params, next_obs,
                                         to_tensor(noise, dev))
        tmin = torch.minimum(
            module.q_value(tq["q1"], next_obs, act),
            module.q_value(tq["q2"], next_obs, act))
        alpha = torch.exp(actor_params["log_alpha"])
        soft = tmin - alpha * logp
        rewards = to_tensor(batch["rewards"], dev)
        return (rewards + self.config.gamma * (1.0 - to_tensor(done, dev))
                * soft).cpu().numpy()

    def training_step(self) -> Dict[str, Any]:
        cfg: SACConfig = self.config
        for sample in self.env_runner_group.sample(
                cfg.rollout_fragment_length):
            n = len(sample["rewards"])
            self._total_env_steps += n
            self.replay.add(sample)

        metrics: Dict[str, Any] = {}
        if self._total_env_steps < (
                cfg.num_steps_sampled_before_learning_starts):
            self._sync_weights()
            return {"learning": False}

        target_entropy = (cfg.target_entropy
                          if cfg.target_entropy is not None
                          else -float(self.spec.num_actions))
        weights = self.learner_group.get_weights()
        for _ in range(cfg.updates_per_iteration):
            batch = self.replay.sample(cfg.train_batch_size)
            batch["targets"] = self._compute_targets(batch, weights)
            batch["noise"] = self._rng.standard_normal(
                (len(batch["rewards"]), self.spec.num_actions)).astype(
                    np.float32)
            metrics = self.learner_group.update_from_batch(
                batch, {"target_entropy": target_entropy})
            weights = self.learner_group.get_weights()
            # polyak target update
            self._target_q = polyak(self._target_q, weights, cfg.tau)
        self._sync_weights()
        return metrics

    def _extra_state(self):
        return {"target_q": self._target_q,
                "replay": self.replay.get_state()}

    def _set_extra_state(self, extra):
        if "target_q" in extra:
            self._target_q = extra["target_q"]
        if "replay" in extra:
            self.replay.set_state(extra["replay"])


SACConfig.algo_class = SAC
