"""DQN: deep Q-learning with replay + target network (double-DQN).

Counterpart: ``ray_tpu/rllib/algorithms/dqn.py``: eps-greedy env runners
fill a (optionally prioritized) replay buffer; the learner fits Huber TD
errors against a periodically-synced target network. TD targets are
computed on the driver, on the learners' device, from the target weights
it holds (so the generic Learner stays a pure (batch)->(loss) machine and
the learner group can still shard rows); the Q head reuses the module's
policy-logits head as Q(s, .).
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from ray_tpu_torch._private.device import resolve_device
from ray_tpu_torch.rllib.algorithms.algorithm import Algorithm
from ray_tpu_torch.rllib.algorithms.algorithm_config import AlgorithmConfig
from ray_tpu_torch.rllib.core.learner import params_from_numpy, to_tensor
from ray_tpu_torch.rllib.core.rl_module import make_module
from ray_tpu_torch.rllib.utils.replay_buffers import (PrioritizedReplayBuffer,
                                                      ReplayBuffer)


class DQNConfig(AlgorithmConfig):
    def __init__(self):
        super().__init__()
        self.replay_buffer_capacity: int = 50_000
        self.prioritized_replay: bool = False
        self.prioritized_replay_alpha: float = 0.6
        self.prioritized_replay_beta: float = 0.4
        self.num_steps_sampled_before_learning_starts: int = 1000
        self.target_network_update_freq: int = 500   # env steps
        self.train_batch_size: int = 64
        self.updates_per_iteration: int = 8
        self.double_q: bool = True
        self.epsilon_initial: float = 1.0
        self.epsilon_final: float = 0.05
        self.epsilon_decay_env_steps: int = 10_000
        self.lr = 1e-3
        self.rollout_fragment_length = 16


class DQN(Algorithm):
    def __init__(self, config: DQNConfig):
        super().__init__(config)
        if config.prioritized_replay:
            self.replay = PrioritizedReplayBuffer(
                config.replay_buffer_capacity,
                alpha=config.prioritized_replay_alpha, seed=config.seed)
        else:
            self.replay = ReplayBuffer(config.replay_buffer_capacity,
                                       seed=config.seed)
        self._target_weights = self.learner_group.get_weights()
        self._steps_since_target_sync = 0
        # the driver's Q forwards run where the learners do
        self._device = resolve_device(config.learner_device)
        self._module = make_module(self.spec)

    @classmethod
    def get_default_config(cls) -> DQNConfig:
        return DQNConfig()

    # ------------------------------------------------------------------ loss

    @staticmethod
    def loss_fn(module, params, batch, cfg):
        """Huber loss on TD error vs precomputed targets; per-row
        `weights` support importance sampling from prioritized replay."""
        q_all, _ = module.forward_train(params, batch["obs"])
        q = q_all.gather(-1, batch["actions"][:, None].long())[:, 0]
        td = q - batch["targets"]
        huber = torch.where(torch.abs(td) <= 1.0, 0.5 * td * td,
                            torch.abs(td) - 0.5)
        w = batch.get("weights")
        loss = torch.mean(huber * w) if w is not None else torch.mean(huber)
        return loss, {"mean_q": torch.mean(q),
                      "mean_td_error": torch.mean(torch.abs(td))}

    # ------------------------------------------------------------- targets

    @torch.no_grad()
    def _compute_targets(self, batch: Dict[str, np.ndarray]) -> np.ndarray:
        cfg: DQNConfig = self.config
        dev, module = self._device, self._module
        target_params = params_from_numpy(self._target_weights, dev)
        next_obs = to_tensor(batch["next_obs"], dev)
        q_next_t, _ = module.forward_train(target_params, next_obs)
        if cfg.double_q:
            online = params_from_numpy(self.learner_group.get_weights(), dev)
            q_next_o, _ = module.forward_train(online, next_obs)
            best = torch.argmax(q_next_o, dim=-1)
        else:
            best = torch.argmax(q_next_t, dim=-1)
        q_best = q_next_t.gather(-1, best[:, None])[:, 0]
        rewards = to_tensor(batch["rewards"], dev)
        dones = to_tensor(batch["dones"].astype(np.float32), dev)
        return (rewards + cfg.gamma * (1.0 - dones) * q_best).cpu().numpy()

    # -------------------------------------------------------------- stepping

    def _epsilon(self) -> float:
        cfg: DQNConfig = self.config
        frac = min(1.0, self._total_env_steps
                   / max(1, cfg.epsilon_decay_env_steps))
        return cfg.epsilon_initial + frac * (cfg.epsilon_final
                                             - cfg.epsilon_initial)

    def training_step(self) -> Dict[str, Any]:
        cfg: DQNConfig = self.config
        samples = self.env_runner_group.sample(
            cfg.rollout_fragment_length, epsilon=self._epsilon(),
            greedy=True)
        for s in samples:
            T, B = s["rewards"].shape
            self._total_env_steps += T * B
            self._steps_since_target_sync += T * B
            done = (s["terminateds"] | s["truncateds"])
            self.replay.add({
                "obs": s["obs"].reshape(
                    (T * B,) + s["obs"].shape[2:]),
                "actions": s["actions"].reshape(T * B),
                "rewards": s["rewards"].reshape(T * B).astype(np.float32),
                "next_obs": s["next_obs"].reshape(
                    (T * B,) + s["next_obs"].shape[2:]),
                "dones": done.reshape(T * B),
            })

        metrics: Dict[str, float] = {"epsilon": self._epsilon()}
        if (self._total_env_steps
                < cfg.num_steps_sampled_before_learning_starts):
            self._sync_weights()
            return metrics

        for _ in range(cfg.updates_per_iteration):
            if isinstance(self.replay, PrioritizedReplayBuffer):
                batch = self.replay.sample(
                    cfg.train_batch_size, beta=cfg.prioritized_replay_beta)
            else:
                batch = self.replay.sample(cfg.train_batch_size)
            idx = batch.pop("batch_indexes", None)
            targets = self._compute_targets(batch)
            # obs pass through at stored dtype: uint8 frames must reach the
            # conv stem un-cast so online Q and TD targets share the same
            # /255 normalization; flat obs are already float32
            learner_batch = {
                "obs": batch["obs"],
                "actions": batch["actions"],
                "targets": targets,
            }
            if "weights" in batch:
                learner_batch["weights"] = batch["weights"]
            metrics.update(self.learner_group.update_from_batch(
                learner_batch, {"_algo": "dqn"}))
            if idx is not None:
                # recompute |td| cheaply from reported mean is not per-row;
                # use target-vs-current q gap per row for priorities
                q_all, _ = self._q_values(learner_batch["obs"])
                q = np.take_along_axis(
                    q_all, batch["actions"][:, None], axis=-1)[:, 0]
                self.replay.update_priorities(idx, np.abs(q - targets))

        if self._steps_since_target_sync >= cfg.target_network_update_freq:
            self._target_weights = self.learner_group.get_weights()
            self._steps_since_target_sync = 0
        self._sync_weights()
        return metrics

    def _extra_state(self):
        return {"target_weights": self._target_weights,
                "steps_since_target_sync": self._steps_since_target_sync,
                "replay": self.replay.get_state()}

    def _set_extra_state(self, extra):
        if "target_weights" in extra:
            self._target_weights = extra["target_weights"]
        self._steps_since_target_sync = extra.get(
            "steps_since_target_sync", 0)
        if "replay" in extra:
            self.replay.set_state(extra["replay"])

    @torch.no_grad()
    def _q_values(self, obs: np.ndarray):
        params = params_from_numpy(self.learner_group.get_weights(),
                                   self._device)
        q, v = self._module.forward_train(params,
                                          to_tensor(obs, self._device))
        return q.cpu().numpy(), v.cpu().numpy()


DQNConfig.algo_class = DQN
