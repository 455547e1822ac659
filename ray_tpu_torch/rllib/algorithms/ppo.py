"""PPO: Proximal Policy Optimization (clipped surrogate), new API stack.

Counterpart: ``ray_tpu/rllib/algorithms/ppo.py``. GAE runs over the merged
host rollout (CPU tensors), the minibatch epochs shuffle on the host with
the JAX package's numpy permutations, and each minibatch is one learner
update on the learner's device. The adaptive-KL coefficient rides inside
the batch (a per-row column) as in JAX. Advantages are normalized by their
population std (``correction=0``, as ``jnp.std``).
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np

import torch

from ray_tpu_torch.rllib.algorithms.algorithm import Algorithm
from ray_tpu_torch.rllib.algorithms.algorithm_config import AlgorithmConfig
from ray_tpu_torch.rllib.utils.advantages import compute_gae


def prepare_train_batch(batch_tm: Dict[str, np.ndarray], *, gamma: float,
                        lam: float) -> Dict[str, np.ndarray]:
    """GAE over the merged [T, B] rollout, flattened to row-major train
    columns. Module-level so the Sebulba learner actors
    (rllib/podracer.py) run byte-identical batch prep to the dynamic
    loop — the learner-parity contract."""
    T, B = batch_tm["rewards"].shape
    adv, targets = compute_gae(
        batch_tm["rewards"], batch_tm["values"],
        batch_tm["bootstrap_value"], batch_tm["terminateds"],
        batch_tm["truncateds"], gamma=gamma, lam=lam)
    return {
        "obs": batch_tm["obs"].reshape(
            (T * B,) + batch_tm["obs"].shape[2:]),
        "actions": batch_tm["actions"].reshape(T * B),
        "logp": batch_tm["logp"].reshape(T * B),
        "values": batch_tm["values"].reshape(T * B),
        "advantages": adv.numpy().reshape(T * B),
        "value_targets": targets.numpy().reshape(T * B),
    }


class PPOConfig(AlgorithmConfig):
    def __init__(self):
        super().__init__()
        self.lam: float = 0.95
        self.clip_param: float = 0.2
        self.vf_clip_param: float = 10.0
        self.vf_loss_coeff: float = 0.5
        self.entropy_coeff: float = 0.0
        self.kl_coeff: float = 0.2       # initial; adapted toward kl_target
        self.kl_target: float = 0.01
        self.num_epochs: int = 8
        self.minibatch_size: int = 128
        self.lr = 3e-4


class PPO(Algorithm):
    def __init__(self, config: PPOConfig):
        super().__init__(config)
        if config.is_multi_agent:
            self._kl_coeffs = {pid: float(config.kl_coeff)
                               for pid in self.specs}
        self._kl_coeff = float(config.kl_coeff)

    @classmethod
    def get_default_config(cls) -> PPOConfig:
        return PPOConfig()

    @staticmethod
    def loss_fn(module, params, batch, cfg):
        """Clipped-surrogate loss (`ppo_torch_learner.py` parity)."""
        clip = cfg["clip_param"]
        vf_clip = cfg["vf_clip_param"]
        logits, value = module.forward_train(params, batch["obs"])
        logp_all = torch.log_softmax(logits, -1)
        logp = logp_all.gather(-1, batch["actions"][:, None].long())[:, 0]
        ratio = torch.exp(logp - batch["logp"])
        adv = batch["advantages"]
        adv = (adv - adv.mean()) / torch.clamp(adv.std(correction=0),
                                               min=1e-6)
        surrogate = torch.minimum(
            ratio * adv, torch.clamp(ratio, 1.0 - clip, 1.0 + clip) * adv)
        pi_loss = -torch.mean(surrogate)

        vf_err = (value - batch["value_targets"]) ** 2
        vf_clipped = batch["values"] + torch.clamp(
            value - batch["values"], -vf_clip, vf_clip)
        vf_err_clipped = (vf_clipped - batch["value_targets"]) ** 2
        vf_loss = 0.5 * torch.mean(torch.maximum(vf_err, vf_err_clipped))

        probs = torch.softmax(logits, -1)
        entropy = -torch.mean(torch.sum(probs * logp_all, dim=-1))
        # K3 estimator (Schulman): non-negative, low-variance
        kl = torch.mean(torch.exp(batch["logp"] - logp)
                        - (batch["logp"] - logp) - 1.0)
        kl_coeff = torch.mean(batch["kl_coeff"])

        total = (pi_loss + cfg["vf_loss_coeff"] * vf_loss
                 - cfg["entropy_coeff"] * entropy + kl_coeff * kl)
        return total, {"policy_loss": pi_loss, "vf_loss": vf_loss,
                       "entropy": entropy, "mean_kl": kl}

    def _podracer_program(self):
        """The Sebulba learner program for PPO: merge the iteration's
        runner batches, GAE, minibatch epochs with the dynamic loop's
        exact RNG stream, adaptive-KL state on the learner side. PPO is
        on-policy, so the topology pins broadcast_interval=1 — the param
        broadcast is the iteration barrier."""
        from ray_tpu_torch.rllib.podracer import PPOSebulbaProgram

        cfg: PPOConfig = self.config
        return PPOSebulbaProgram(
            spec=self.spec, loss_fn=type(self).loss_fn,
            loss_cfg={
                "clip_param": cfg.clip_param,
                "vf_clip_param": cfg.vf_clip_param,
                "vf_loss_coeff": cfg.vf_loss_coeff,
                "entropy_coeff": cfg.entropy_coeff,
            },
            opt_cfg={"lr": cfg.lr, "grad_clip": cfg.grad_clip},
            device=cfg.learner_device,
            gamma=cfg.gamma, lam=cfg.lam, seed=cfg.seed,
            num_epochs=cfg.num_epochs, minibatch_size=cfg.minibatch_size,
            kl_coeff=cfg.kl_coeff, kl_target=cfg.kl_target)

    def training_step(self) -> Dict[str, Any]:
        if self.config.is_multi_agent:
            return self._multi_agent_training_step()
        cfg: PPOConfig = self.config
        samples = self.env_runner_group.sample(cfg.rollout_fragment_length)
        batch_tm = self._merge_time_major(samples)
        T, B = batch_tm["rewards"].shape
        self._total_env_steps += T * B

        flat = prepare_train_batch(batch_tm, gamma=cfg.gamma, lam=cfg.lam)
        loss_cfg = {
            "clip_param": cfg.clip_param,
            "vf_clip_param": cfg.vf_clip_param,
            "vf_loss_coeff": cfg.vf_loss_coeff,
            "entropy_coeff": cfg.entropy_coeff,
        }

        n = T * B
        mb = min(cfg.minibatch_size, n)
        rng = np.random.default_rng(cfg.seed + self.iteration)
        last_metrics: Dict[str, float] = {}
        for _ in range(cfg.num_epochs):
            perm = rng.permutation(n)
            for lo in range(0, n - mb + 1, mb):
                idx = perm[lo:lo + mb]
                minibatch = {k: v[idx] for k, v in flat.items()}
                # per-row (not length-1) so LearnerGroup row-sharding
                # slices it like every other column
                minibatch["kl_coeff"] = np.full(len(idx), self._kl_coeff,
                                                np.float32)
                last_metrics = self.learner_group.update_from_batch(
                    minibatch, loss_cfg)
        # adaptive KL (reference: PPO.update_kl)
        kl = last_metrics.get("mean_kl", 0.0)
        if kl > 2.0 * cfg.kl_target:
            self._kl_coeff *= 1.5
        elif kl < 0.5 * cfg.kl_target:
            self._kl_coeff *= 0.5

        self._sync_weights()
        last_metrics["kl_coeff"] = self._kl_coeff
        return last_metrics

    def _multi_agent_training_step(self) -> Dict[str, Any]:
        """Per-policy GAE + clipped-surrogate epochs; each policy trains on
        the batch its agents produced (reference: `MultiAgentBatch` routed
        to per-module learners)."""
        cfg: PPOConfig = self.config
        samples = self.env_runner_group.sample(cfg.rollout_fragment_length)
        loss_cfg = {
            "clip_param": cfg.clip_param,
            "vf_clip_param": cfg.vf_clip_param,
            "vf_loss_coeff": cfg.vf_loss_coeff,
            "entropy_coeff": cfg.entropy_coeff,
        }
        rng = np.random.default_rng(cfg.seed + self.iteration)
        result: Dict[str, Any] = {}
        # env steps, not agent-steps: every env column appears once per
        # policy it feeds, so count envs x T directly
        self._total_env_steps += (cfg.rollout_fragment_length
                                  * cfg.num_envs_per_env_runner
                                  * max(1, cfg.num_env_runners))
        for pid, lg in self.learner_groups.items():
            batch_tm = self._merge_time_major([s[pid] for s in samples])
            T, B = batch_tm["rewards"].shape
            adv, targets = compute_gae(
                batch_tm["rewards"], batch_tm["values"],
                batch_tm["bootstrap_value"], batch_tm["terminateds"],
                batch_tm["truncateds"], gamma=cfg.gamma, lam=cfg.lam)
            flat = {
                "obs": batch_tm["obs"].reshape(
                    (T * B,) + batch_tm["obs"].shape[2:]),
                "actions": batch_tm["actions"].reshape(T * B),
                "logp": batch_tm["logp"].reshape(T * B),
                "values": batch_tm["values"].reshape(T * B),
                "advantages": adv.numpy().reshape(T * B),
                "value_targets": targets.numpy().reshape(T * B),
            }
            n = T * B
            mb = min(cfg.minibatch_size, n)
            last: Dict[str, float] = {}
            for _ in range(cfg.num_epochs):
                perm = rng.permutation(n)
                for lo in range(0, n - mb + 1, mb):
                    idx = perm[lo:lo + mb]
                    minibatch = {k: v[idx] for k, v in flat.items()}
                    minibatch["kl_coeff"] = np.full(
                        len(idx), self._kl_coeffs[pid], np.float32)
                    last = lg.update_from_batch(minibatch, loss_cfg)
            kl = last.get("mean_kl", 0.0)
            if kl > 2.0 * cfg.kl_target:
                self._kl_coeffs[pid] *= 1.5
            elif kl < 0.5 * cfg.kl_target:
                self._kl_coeffs[pid] *= 0.5
            for k, v in last.items():
                result[f"{pid}/{k}"] = v
        self._sync_weights()
        return result

    def _extra_state(self):
        if self.config.is_multi_agent:
            return {"kl_coeffs": dict(self._kl_coeffs)}
        return {"kl_coeff": self._kl_coeff}

    def _set_extra_state(self, extra):
        self._kl_coeff = float(extra.get("kl_coeff", self._kl_coeff))
        if self.config.is_multi_agent and "kl_coeffs" in extra:
            self._kl_coeffs.update(extra["kl_coeffs"])


PPOConfig.algo_class = PPO
