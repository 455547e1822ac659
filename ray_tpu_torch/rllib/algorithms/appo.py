"""APPO: asynchronous PPO (IMPALA architecture + clipped surrogate).

Counterpart: ``ray_tpu/rllib/algorithms/appo.py``: IMPALA's asynchronous
actor-learner loop and V-trace off-policy correction, with PPO's clipped
surrogate (the ratio against the behaviour policy that produced the
rollout) in place of the plain policy-gradient term, plus an optional KL
penalty toward the behaviour distribution. The behaviour ``logp`` carried
in the batch is the one anchor (no separate target network).
"""

from __future__ import annotations

from typing import Dict

import torch

from ray_tpu_torch.rllib.algorithms.impala import IMPALA, IMPALAConfig
from ray_tpu_torch.rllib.utils.advantages import vtrace_returns


class APPOConfig(IMPALAConfig):
    def __init__(self):
        super().__init__()
        self.clip_param: float = 0.2
        self.use_kl_loss: bool = False
        self.kl_coeff: float = 1.0
        self.kl_target: float = 0.01
        self.lr = 3e-4


class APPO(IMPALA):
    def __init__(self, config: APPOConfig):
        super().__init__(config)
        self._kl_coeff = float(config.kl_coeff)

    @classmethod
    def get_default_config(cls) -> APPOConfig:
        return APPOConfig()

    def training_step(self):
        metrics = super().training_step()
        # adaptive KL toward kl_target (reference APPO.update_kl), only
        # meaningful when the KL penalty is in the loss
        cfg: APPOConfig = self.config
        if cfg.use_kl_loss and metrics:
            # adapt only on iterations that actually measured KL — a step
            # with no learner update has no mean_kl, and reading it as 0
            # would spuriously decay the penalty toward zero
            kl = metrics.get("mean_kl")
            if kl is not None:
                if kl > 2.0 * cfg.kl_target:
                    self._kl_coeff *= 1.5
                elif kl < 0.5 * cfg.kl_target:
                    self._kl_coeff *= 0.5
            metrics["kl_coeff"] = self._kl_coeff
        return metrics

    def _extra_state(self):
        return {"kl_coeff": self._kl_coeff}

    def _set_extra_state(self, extra):
        self._kl_coeff = float(extra.get("kl_coeff", self._kl_coeff))

    @staticmethod
    def loss_fn(module, params, batch, cfg):
        """V-trace advantages under PPO's clipped surrogate
        (`appo_torch_learner.py` parity)."""
        obs = batch["obs"]                      # [B, T, D] or [B, T, H, W, C]
        B, T = obs.shape[0], obs.shape[1]
        # trailing obs dims kept, as IMPALA's loss keeps them: the JAX
        # package's APPO flattens them to rows here, which a conv module
        # cannot take
        logits, values = module.forward_train(
            params, obs.reshape((B * T,) + tuple(obs.shape[2:])))
        logp_all = torch.log_softmax(logits, -1)
        actions = batch["actions"].reshape(B * T)
        logp = logp_all.gather(-1, actions[:, None].long())[:, 0]

        tm = lambda x: x.reshape(B, T).T  # noqa: E731
        target_logp_tm = tm(logp)
        behavior_logp_tm = tm(batch["logp"])
        values_tm = tm(values)
        with torch.no_grad():  # targets, not differentiated paths
            _, bootstrap_value = module.forward_train(
                params, batch["bootstrap_obs"])
            vs, pg_adv = vtrace_returns(
                behavior_logp_tm, target_logp_tm,
                tm(batch["rewards"]).to(torch.float32), values_tm,
                bootstrap_value, tm(batch["terminateds"]),
                tm(batch["truncateds"]),
                gamma=cfg["gamma"], clip_rho=cfg["clip_rho"],
                clip_c=cfg["clip_c"])

        # PPO clipped surrogate with the behavior policy as the anchor
        ratio = torch.exp(target_logp_tm - behavior_logp_tm)
        clip = cfg["clip_param"]
        surrogate = torch.minimum(
            ratio * pg_adv,
            torch.clamp(ratio, 1.0 - clip, 1.0 + clip) * pg_adv)
        pi_loss = -torch.mean(surrogate)

        vf_loss = 0.5 * torch.mean((values_tm - vs) ** 2)
        probs = torch.softmax(logits, -1)
        entropy = -torch.mean(torch.sum(probs * logp_all, dim=-1))
        # K3 KL estimator vs the behavior policy
        kl = torch.mean(torch.exp(behavior_logp_tm - target_logp_tm)
                        - (behavior_logp_tm - target_logp_tm) - 1.0)
        total = (pi_loss + cfg["vf_loss_coeff"] * vf_loss
                 - cfg["entropy_coeff"] * entropy)
        if cfg["use_kl_loss"]:
            # the adaptive coefficient rides in the batch (PPO pattern)
            total = total + torch.mean(batch["kl_coeff"]) * kl
        return total, {"policy_loss": pi_loss, "vf_loss": vf_loss,
                       "entropy": entropy, "mean_kl": kl}

    def _loss_cfg(self) -> Dict[str, float]:
        cfg: APPOConfig = self.config
        out = super()._loss_cfg()
        out.update({"clip_param": cfg.clip_param,
                    "use_kl_loss": cfg.use_kl_loss})
        return out

    def _to_column_major(self, s):
        batch = super()._to_column_major(s)
        if self.config.use_kl_loss:
            import numpy as np

            batch["kl_coeff"] = np.full(
                batch["rewards"].shape[0], self._kl_coeff, np.float32)
        return batch


APPOConfig.algo_class = APPO
