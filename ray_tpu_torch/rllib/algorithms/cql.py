"""CQL: Conservative Q-Learning (offline continuous control).

Counterpart: ``ray_tpu/rllib/algorithms/cql.py``: SAC's actor, critic and
temperature machinery trained purely from a logged transition dataset,
with the CQL(H) conservative penalty pushing Q down on out-of-distribution
actions and up on dataset actions:

    penalty = E_s[ logsumexp_a q(s, a) ] - E_(s,a)~D[ q(s, a) ]

where the logsumexp mixes uniform-random actions and fresh policy actions
at s and s' (each importance-corrected by its log density, the CQL(H)
estimator). All sampling noise is drawn on the host (numpy, in the JAX
package's order) into the batch, so the Learner stays a pure (batch) ->
(loss) machine. An initial ``bc_iters`` phase fits the actor by behavior
cloning (reference CQL's warm start) before switching to the SAC actor
objective; the loss branches on that flag in Python, once an update.

Offline input mirrors MARWIL's ``.offline_data(input_=...)`` surface: row
dicts {obs, action, reward, next_obs, done}, a
``ray_tpu_torch.data.Dataset`` of such rows, or a parquet path. The
learner and the target function run on ``config.learner_device`` (the
card unless the config names the CPU). Evaluation uses the SAC continuous
eval runner against ``.environment(env=...)`` when configured.
"""

from __future__ import annotations

import math
import time
from typing import Any, Dict

import numpy as np
import torch

from ray_tpu_torch.rllib.algorithms.marwil import read_offline_rows
from ray_tpu_torch.rllib.algorithms.sac import (SAC, SACConfig, SACModule,
                                                _NoRunnerGroup, detached,
                                                polyak)
from ray_tpu_torch.rllib.core.rl_module import RLModuleSpec


class CQLConfig(SACConfig):
    def __init__(self):
        super().__init__()
        self.cql_alpha: float = 5.0        # conservative penalty weight
        self.num_cql_actions: int = 4      # sampled actions per source
        self.bc_iters: int = 2             # BC warm-start iterations
        self.input_: Any = None            # rows / Dataset / parquet path
        self.updates_per_iteration = 8
        self.num_steps_sampled_before_learning_starts = 0
        self.warmup_random_steps = 0

    def offline_data(self, *, input_=None) -> "CQLConfig":
        return self._apply(dict(input_=input_))

    def build(self):
        assert self.input_ is not None, "call .offline_data(input_=...)"
        assert self.observation_dim and self.num_actions, (
            "CQL needs explicit observation_dim/num_actions "
            "(offline: there may be no env to probe)")
        return self.algo_class(self.copy())

    def rl_module_spec(self) -> RLModuleSpec:
        return RLModuleSpec(
            obs_dim=self.observation_dim, num_actions=self.num_actions,
            hiddens=tuple(self.model.get("hiddens", (256, 256))),
            dist_type="gaussian", module_class=SACModule)


def _load_offline_transitions(input_) -> Dict[str, np.ndarray]:
    """{obs, actions, rewards, next_obs, terminateds, truncateds} arrays
    from logged continuous-control rows."""
    rows = read_offline_rows(input_)
    n = len(rows)
    return {
        "obs": np.asarray([r["obs"] for r in rows], np.float32),
        "actions": np.asarray([r["action"] for r in rows], np.float32),
        "rewards": np.asarray([r["reward"] for r in rows], np.float32),
        "next_obs": np.asarray([r["next_obs"] for r in rows], np.float32),
        "terminateds": np.asarray([r.get("done", False) for r in rows],
                                  bool),
        "truncateds": np.zeros(n, bool),
    }


class CQL(SAC):
    def __init__(self, config: CQLConfig):
        self.config = config
        self.iteration = 0
        self._total_env_steps = 0
        self._start = time.time()
        self.spec = config.rl_module_spec()
        self.learner_groups = None
        self.env_runner_group = _NoRunnerGroup()
        self._init_learner(config)
        self.replay.add(_load_offline_transitions(config.input_))

    @classmethod
    def get_default_config(cls) -> CQLConfig:
        return CQLConfig()

    # ------------------------------------------------------------------ loss

    @staticmethod
    def loss_fn(module, params, batch, cfg):
        obs = batch["obs"]
        act_dim = batch["actions"].shape[-1]
        B = obs.shape[0]
        N = batch["cql_rand_actions"].shape[1]

        q1_data = module.q_value(params["q1"], obs, batch["actions"])
        q2_data = module.q_value(params["q2"], obs, batch["actions"])
        critic_loss = (torch.mean((q1_data - batch["targets"]) ** 2)
                       + torch.mean((q2_data - batch["targets"]) ** 2))

        # actor: BC warm start, then the SAC objective
        act, logp = module.sample_action(params, obs, batch["noise"])
        if cfg.get("bc"):
            # log-density of the DATA action under the tanh-Gaussian
            mean, log_std = module.actor_dist(params, obs)
            pre = torch.atanh(torch.clamp(batch["actions"], -1 + 1e-5,
                                          1 - 1e-5))
            z = (pre - mean) / torch.exp(log_std)
            data_logp = (-0.5 * torch.square(z) - log_std
                         - 0.5 * math.log(2 * math.pi)).sum(-1)
            data_logp = data_logp - torch.log(
                1.0 - torch.square(batch["actions"]) + 1e-6).sum(-1)
            actor_loss = -torch.mean(data_logp)
        else:
            q_min = torch.minimum(
                module.q_value(detached(params["q1"]), obs, act),
                module.q_value(detached(params["q2"]), obs, act))
            alpha = torch.exp(params["log_alpha"].detach())
            actor_loss = torch.mean(alpha * logp - q_min)

        alpha_loss = -torch.mean(
            params["log_alpha"] * (logp + cfg["target_entropy"]).detach())

        # -- CQL(H) conservative penalty (policy/next actions detached:
        #    the penalty shapes the CRITIC, not the actor)
        def repeat(o, n):  # [B, d] -> [B * n, d], each row n times
            return o[:, None, :].expand(B, n, o.shape[-1]).reshape(
                B * n, -1)

        def q_flat(qp, o, a_bn):  # [B,N,d] actions -> [B,N] q-values
            n = a_bn.shape[1]
            q = module.q_value(qp, repeat(o, n),
                               a_bn.reshape(B * n, act_dim))
            return q.reshape(B, n)

        rand_act = batch["cql_rand_actions"]            # uniform [-1, 1]
        rand_logp = torch.full((B, N), -act_dim * math.log(2.0),
                               device=obs.device)
        frozen = detached(params)

        def pol_actions(noise_bn, o):
            a, lp = module.sample_action(
                frozen, repeat(o, N), noise_bn.reshape(B * N, act_dim))
            return a.reshape(B, N, act_dim), lp.reshape(B, N)

        pol_act, pol_logp = pol_actions(batch["cql_noise"], obs)
        nxt_act, nxt_logp = pol_actions(batch["cql_noise_next"],
                                        batch["next_obs"])

        penalty = 0.0
        for qp, qd in ((params["q1"], q1_data), (params["q2"], q2_data)):
            cat = torch.cat([
                q_flat(qp, obs, rand_act) - rand_logp,
                q_flat(qp, obs, pol_act) - pol_logp.detach(),
                q_flat(qp, obs, nxt_act) - nxt_logp.detach(),
            ], dim=1)
            penalty = penalty + torch.mean(
                torch.logsumexp(cat, dim=1)) - torch.mean(qd)

        total = (critic_loss + actor_loss + alpha_loss
                 + cfg["cql_alpha"] * penalty)
        return total, {"critic_loss": critic_loss,
                       "actor_loss": actor_loss,
                       "cql_penalty": penalty,
                       "mean_q_data": torch.mean(q1_data),
                       "entropy": -torch.mean(logp)}

    # ------------------------------------------------------------- training

    def training_step(self) -> Dict[str, Any]:
        cfg: CQLConfig = self.config
        target_entropy = (cfg.target_entropy
                          if cfg.target_entropy is not None
                          else -float(self.spec.num_actions))
        weights = self.learner_group.get_weights()
        a_dim, N = self.spec.num_actions, cfg.num_cql_actions
        metrics: Dict[str, Any] = {}
        for _ in range(cfg.updates_per_iteration):
            batch = self.replay.sample(cfg.train_batch_size)
            B = len(batch["rewards"])
            batch["targets"] = self._compute_targets(batch, weights)
            batch["noise"] = self._rng.standard_normal(
                (B, a_dim)).astype(np.float32)
            batch["cql_rand_actions"] = self._rng.uniform(
                -1, 1, (B, N, a_dim)).astype(np.float32)
            batch["cql_noise"] = self._rng.standard_normal(
                (B, N, a_dim)).astype(np.float32)
            batch["cql_noise_next"] = self._rng.standard_normal(
                (B, N, a_dim)).astype(np.float32)
            metrics = self.learner_group.update_from_batch(
                batch, {"target_entropy": target_entropy,
                        "cql_alpha": cfg.cql_alpha,
                        "bc": self.iteration < cfg.bc_iters})
            weights = self.learner_group.get_weights()
            self._target_q = polyak(self._target_q, weights, cfg.tau)
        metrics["num_offline_transitions"] = len(self.replay)
        return metrics


CQLConfig.algo_class = CQL
