"""IMPALA: importance-weighted actor-learner architecture.

Counterpart: ``ray_tpu/rllib/algorithms/impala.py``: env-runner actors
sample continuously and asynchronously (in-flight refs, ``wait`` on the
first ready), the learner consumes whatever arrived with V-trace
off-policy correction. V-trace runs inside the loss under ``no_grad`` (its
targets are detached, as JAX stops their gradients); batches are
column-major [B, T, ...] so the learner group can shard along env columns
without breaking the time recursion.
"""

from __future__ import annotations

from typing import Any, Dict, List

import numpy as np
import torch

import ray_tpu_torch
from ray_tpu_torch.rllib.algorithms.algorithm import Algorithm
from ray_tpu_torch.rllib.algorithms.algorithm_config import AlgorithmConfig
from ray_tpu_torch.rllib.utils.advantages import vtrace_returns


def to_column_major(s: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """[T, B, ...] rollout -> [B, T, ...] learner batch. Module-level so
    the Sebulba learner actors (rllib/podracer.py) run byte-identical
    batch prep to the dynamic loop — the learner-parity contract."""
    obs = np.swapaxes(s["obs"], 0, 1)
    return {
        "obs": np.ascontiguousarray(
            obs if obs.dtype == np.uint8 else obs.astype(np.float32)),
        "actions": np.swapaxes(s["actions"], 0, 1).copy(),
        "logp": np.swapaxes(s["logp"], 0, 1).copy(),
        "rewards": np.swapaxes(s["rewards"], 0, 1).copy(),
        "terminateds": np.swapaxes(s["terminateds"], 0, 1).copy(),
        "truncateds": np.swapaxes(s["truncateds"], 0, 1).copy(),
        "bootstrap_obs": np.asarray(s["next_obs"][-1]),
    }


class IMPALAConfig(AlgorithmConfig):
    def __init__(self):
        super().__init__()
        self.vtrace_clip_rho_threshold: float = 1.0
        self.vtrace_clip_c_threshold: float = 1.0
        self.vf_loss_coeff: float = 0.5
        self.entropy_coeff: float = 0.01
        self.max_requests_in_flight_per_env_runner: int = 2
        self.num_batches_per_iteration: int = 4
        self.broadcast_interval: int = 1
        self.lr = 5e-4
        self.rollout_fragment_length = 32


class IMPALA(Algorithm):
    def __init__(self, config: IMPALAConfig):
        super().__init__(config)
        self._inflight: Dict[Any, Any] = {}  # ref -> runner actor
        self._updates_since_broadcast = 0

    @classmethod
    def get_default_config(cls) -> IMPALAConfig:
        return IMPALAConfig()

    @staticmethod
    def loss_fn(module, params, batch, cfg):
        """V-trace actor-critic loss over [B, T, ...] columns."""
        obs = batch["obs"]                      # [B, T, D] or [B, T, H, W, C]
        B, T = obs.shape[0], obs.shape[1]
        # keep trailing obs dims: image observations must reach the conv
        # torso as [N, H, W, C], not flattened rows
        logits, values = module.forward_train(
            params, obs.reshape((B * T,) + tuple(obs.shape[2:])))
        logp_all = torch.log_softmax(logits, -1)
        actions = batch["actions"].reshape(B * T)
        logp = logp_all.gather(-1, actions[:, None].long())[:, 0]

        # time-major views for the v-trace recursion
        tm = lambda x: x.reshape(B, T).T  # noqa: E731
        target_logp_tm = tm(logp)
        values_tm = tm(values)
        with torch.no_grad():  # targets, not differentiated paths
            _, bootstrap_value = module.forward_train(
                params, batch["bootstrap_obs"])
            vs, pg_adv = vtrace_returns(
                tm(batch["logp"]), target_logp_tm,
                tm(batch["rewards"]).to(torch.float32), values_tm,
                bootstrap_value, tm(batch["terminateds"]),
                tm(batch["truncateds"]),
                gamma=cfg["gamma"], clip_rho=cfg["clip_rho"],
                clip_c=cfg["clip_c"])

        pi_loss = -torch.mean(target_logp_tm * pg_adv)
        vf_loss = 0.5 * torch.mean((values_tm - vs) ** 2)
        probs = torch.softmax(logits, -1)
        entropy = -torch.mean(torch.sum(probs * logp_all, dim=-1))
        total = (pi_loss + cfg["vf_loss_coeff"] * vf_loss
                 - cfg["entropy_coeff"] * entropy)
        return total, {"policy_loss": pi_loss, "vf_loss": vf_loss,
                       "entropy": entropy}

    # ------------------------------------------------------------- sampling

    def _to_column_major(self, s: Dict[str, np.ndarray]
                         ) -> Dict[str, np.ndarray]:
        return to_column_major(s)

    def _loss_cfg(self) -> Dict[str, float]:
        cfg: IMPALAConfig = self.config
        return {
            "gamma": cfg.gamma,
            "clip_rho": cfg.vtrace_clip_rho_threshold,
            "clip_c": cfg.vtrace_clip_c_threshold,
            "vf_loss_coeff": cfg.vf_loss_coeff,
            "entropy_coeff": cfg.entropy_coeff,
        }

    def _podracer_program(self):
        """The Sebulba learner program for IMPALA: one V-trace update per
        consumed runner batch, params broadcast every
        ``broadcast_interval`` updates (converted to the topology's
        iteration granularity of R/L updates), one train() consuming
        ``num_batches_per_iteration`` batches like the dynamic loop —
        the async off-policy shape; channel depth bounds how far runners
        sample ahead."""
        from ray_tpu_torch.rllib.podracer import ImpalaSebulbaProgram

        cfg: IMPALAConfig = self.config
        return ImpalaSebulbaProgram(
            spec=self.spec, loss_fn=type(self).loss_fn,
            loss_cfg=self._loss_cfg(),
            opt_cfg={"lr": cfg.lr, "grad_clip": cfg.grad_clip},
            device=cfg.learner_device,
            broadcast_interval=cfg.broadcast_interval,
            num_batches_per_iteration=cfg.num_batches_per_iteration)

    def _maybe_broadcast(self) -> None:
        cfg: IMPALAConfig = self.config
        self._updates_since_broadcast += 1
        if self._updates_since_broadcast >= cfg.broadcast_interval:
            self._sync_weights()
            self._updates_since_broadcast = 0

    def training_step(self) -> Dict[str, Any]:
        cfg: IMPALAConfig = self.config
        runners = self.env_runner_group._actors
        if not runners:
            return self._training_step_sync()

        # keep every runner saturated with in-flight sample requests
        per_runner = {id(a): 0 for a in runners}
        for ref, actor in self._inflight.items():
            per_runner[id(actor)] += 1
        for actor in runners:
            while (per_runner[id(actor)]
                   < cfg.max_requests_in_flight_per_env_runner):
                ref = actor.sample.remote(cfg.rollout_fragment_length)
                self._inflight[ref] = actor
                per_runner[id(actor)] += 1

        metrics: Dict[str, float] = {}
        for _ in range(cfg.num_batches_per_iteration):
            ready, _ = ray_tpu_torch.wait(list(self._inflight), num_returns=1,
                                    timeout=60.0)
            if not ready:
                break
            ref = ready[0]
            actor = self._inflight.pop(ref)
            sample = ray_tpu_torch.get(ref)
            batch = self._to_column_major(sample)
            T, B = sample["rewards"].shape
            self._total_env_steps += T * B
            metrics = self.learner_group.update_from_batch(
                batch, self._loss_cfg())
            # re-arm only the consumed runner: its set_weights is the
            # broadcast (fire-and-forget, ordered before the next sample
            # by actor-queue seqnos) — no global barrier in the async loop
            self._updates_since_broadcast += 1
            if self._updates_since_broadcast >= cfg.broadcast_interval:
                actor.set_weights.remote(self.learner_group.get_weights())
                self._updates_since_broadcast = 0
            new_ref = actor.sample.remote(cfg.rollout_fragment_length)
            self._inflight[new_ref] = actor
        return metrics

    def _training_step_sync(self) -> Dict[str, Any]:
        """Local-mode fallback: synchronous sample -> update."""
        cfg: IMPALAConfig = self.config
        metrics: Dict[str, float] = {}
        for _ in range(cfg.num_batches_per_iteration):
            samples = self.env_runner_group.sample(
                cfg.rollout_fragment_length)
            for s in samples:
                T, B = s["rewards"].shape
                self._total_env_steps += T * B
                metrics = self.learner_group.update_from_batch(
                    self._to_column_major(s), self._loss_cfg())
            self._maybe_broadcast()
        return metrics

IMPALAConfig.algo_class = IMPALA
