"""Offline RL: BC (behavior cloning) and MARWIL.

Counterpart: ``ray_tpu/rllib/algorithms/marwil.py``: train a policy purely
from logged (obs, action[, return]) rows, with no environment
interaction. MARWIL weights the imitation term by exp(beta * advantage /
c) where advantage = return - V(s) and c is a running advantage scale
(the reference's moving-average normalizer); beta = 0 reduces exactly to
BC, which is how BCConfig is implemented. The learner runs on
``config.learner_device`` (the card unless the config names the CPU);
minibatch rows are numpy draws in the JAX package's order.

Offline input (``.offline_data(input_=...)``) accepts a list of row dicts,
a ``ray_tpu_torch.data.Dataset``, or a parquet path.
"""

from __future__ import annotations

import time
from typing import Any, Dict

import numpy as np
import torch

from ray_tpu_torch.rllib.algorithms.algorithm import Algorithm
from ray_tpu_torch.rllib.algorithms.algorithm_config import AlgorithmConfig
from ray_tpu_torch.rllib.core.learner import LearnerGroup


class MARWILConfig(AlgorithmConfig):
    def __init__(self):
        super().__init__()
        self.beta: float = 1.0               # exp-advantage temperature
        self.vf_coeff: float = 1.0
        self.input_: Any = None              # rows / Dataset / parquet path
        self.train_batch_size = 512
        self.updates_per_iteration: int = 16
        self.lr = 1e-3

    def offline_data(self, *, input_=None) -> "MARWILConfig":
        return self._apply(dict(input_=input_))

    def build(self):
        assert self.input_ is not None, "call .offline_data(input_=...)"
        assert self.observation_dim and self.num_actions, (
            "offline algorithms need explicit observation_dim/num_actions "
            "(there is no env to probe)")
        return self.algo_class(self.copy())


class BCConfig(MARWILConfig):
    """BC = MARWIL with beta=0 (pure imitation, no value fitting)."""

    def __init__(self):
        super().__init__()
        self.beta = 0.0
        self.vf_coeff = 0.0


def read_offline_rows(input_):
    """The rows of an offline input: a parquet path, a Dataset, or an
    iterable of row dicts."""
    if isinstance(input_, str):
        from ray_tpu_torch import data as rt_data

        return rt_data.read_parquet(input_).take_all()
    if hasattr(input_, "take_all"):          # ray_tpu_torch.data.Dataset
        return input_.take_all()
    return list(input_)


def _load_offline_rows(input_) -> Dict[str, np.ndarray]:
    """Normalize the offline input into {obs, actions[, returns]} arrays."""
    rows = read_offline_rows(input_)
    out = {
        "obs": np.asarray([r["obs"] for r in rows], np.float32),
        "actions": np.asarray([r["action"] for r in rows], np.int64),
    }
    if rows and "return" in rows[0]:
        out["returns"] = np.asarray([r["return"] for r in rows],
                                    np.float32)
    return out


class MARWIL(Algorithm):
    def __init__(self, config: MARWILConfig):
        # offline: no env runners at all
        if config.env_to_module_connector is not None:
            raise ValueError(
                "offline algorithms have no env runners; preprocess the "
                "offline rows instead of setting env_to_module_connector")
        self.config = config
        self.iteration = 0
        self._total_env_steps = 0
        self._start = time.time()
        self.spec = config.rl_module_spec()
        self.learner_groups = None
        self.env_runner_group = None
        self.learner_group = LearnerGroup(
            self.spec, type(self).loss_fn,
            optimizer_config={"lr": config.lr,
                              "grad_clip": config.grad_clip},
            num_learners=config.num_learners, seed=config.seed,
            batch_connector=config.learner_connector,
            device=config.learner_device)
        self._data = _load_offline_rows(config.input_)
        if config.beta != 0.0 and "returns" not in self._data:
            raise ValueError(
                "MARWIL (beta != 0) needs a 'return' column in the offline "
                "data; use BCConfig for return-free imitation")
        self._rng = np.random.default_rng(config.seed)
        self._adv_norm = 1.0   # running sqrt(E[adv^2]) (reference: c)

    @classmethod
    def get_default_config(cls) -> MARWILConfig:
        return MARWILConfig()

    # ------------------------------------------------------------------ loss

    @staticmethod
    def loss_fn(module, params, batch, cfg):
        logits, value = module.forward_train(params, batch["obs"])
        logp_all = torch.log_softmax(logits, -1)
        actions = batch["actions"].long()
        logp = logp_all.gather(-1, actions[:, None])[:, 0]
        accuracy = torch.mean(
            (torch.argmax(logits, -1) == actions).to(torch.float32))
        beta = cfg["beta"]
        if beta == 0.0:
            imitation = -torch.mean(logp)
            return imitation, {"policy_loss": imitation,
                               "accuracy": accuracy}
        adv = batch["returns"] - value
        w = torch.exp(beta * adv.detach()
                      / torch.clamp_min(batch["adv_norm"][0], 1e-8))
        w = torch.clamp_max(w, 20.0)  # reference caps the exp weight
        imitation = -torch.mean(w * logp)
        vf_loss = torch.mean(adv ** 2)
        total = imitation + cfg["vf_coeff"] * vf_loss
        return total, {"policy_loss": imitation, "vf_loss": vf_loss,
                       "mean_adv": torch.mean(adv),
                       "mean_sq_adv": torch.mean(adv ** 2),
                       "accuracy": accuracy}

    # ------------------------------------------------------------- training

    def training_step(self) -> Dict[str, Any]:
        cfg = self.config
        n = len(self._data["actions"])
        mb = min(cfg.train_batch_size, n)
        metrics: Dict[str, Any] = {}
        for _ in range(cfg.updates_per_iteration):
            idx = self._rng.integers(0, n, mb)
            batch = {k: v[idx] for k, v in self._data.items()}
            if cfg.beta != 0.0:
                batch["adv_norm"] = np.full(mb, self._adv_norm, np.float32)
            metrics = self.learner_group.update_from_batch(
                batch, {"beta": cfg.beta, "vf_coeff": cfg.vf_coeff})
            if cfg.beta != 0.0 and "mean_sq_adv" in metrics:
                # reference: c^2 <- c^2 + lr (E[adv^2] - c^2)
                self._adv_norm = float(np.sqrt(
                    0.99 * self._adv_norm ** 2
                    + 0.01 * max(metrics["mean_sq_adv"], 0.0)))
        return metrics

    def train(self) -> Dict[str, Any]:
        result = self.training_step()
        self.iteration += 1
        result.update({
            "training_iteration": self.iteration,
            "num_rows": len(self._data["actions"]),
            "time_total_s": time.time() - self._start,
        })
        return result

    def stop(self) -> None:
        self.learner_group.shutdown()

    def _sync_weights(self) -> None:  # no samplers to sync
        pass

    def get_weights(self):
        return self.learner_group.get_weights()


class BC(MARWIL):
    @classmethod
    def get_default_config(cls) -> BCConfig:
        return BCConfig()


MARWILConfig.algo_class = MARWIL
BCConfig.algo_class = BC
