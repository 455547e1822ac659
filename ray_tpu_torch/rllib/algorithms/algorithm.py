"""Algorithm: the RL training driver.

Counterpart: ``ray_tpu/rllib/algorithms/algorithm.py``: owns an
EnvRunnerGroup (sampling actors) and a LearnerGroup (SGD actors), iterates
``training_step()`` per ``train()`` call, and checkpoints as a directory
(pickled learner state + config) through ``train/_checkpoint.py``, so it
slots under the Tune controller via ``AlgorithmConfig.to_trainable()``.
The learners run on ``config.learner_device`` and the env runners on
``config.env_runner_device`` (each the card unless it names the CPU).
Learner state is host numpy (``core/learner.py``), so a checkpoint loads
on either device.
"""

from __future__ import annotations

import os
import pickle

import cloudpickle  # configs may hold env factories / mapping lambdas
import tempfile
import time
import uuid
from typing import Any, Dict, List, Optional

import numpy as np

from ray_tpu_torch.rllib.algorithms.algorithm_config import AlgorithmConfig
from ray_tpu_torch.rllib.core.learner import LearnerGroup
from ray_tpu_torch.rllib.env.single_agent_env_runner import EnvRunnerGroup
from ray_tpu_torch.train._checkpoint import Checkpoint


def merge_time_major(samples: List[Dict[str, np.ndarray]]
                     ) -> Dict[str, np.ndarray]:
    """Concatenate per-runner [T, B, ...] batches along B. Module-level so
    the Sebulba learner actors merge exactly like the dynamic loop."""
    out: Dict[str, np.ndarray] = {}
    for k in samples[0]:
        axis = 0 if samples[0][k].ndim == 1 else 1  # bootstrap_value: [B]
        out[k] = (np.concatenate([s[k] for s in samples], axis=axis)
                  if len(samples) > 1 else samples[0][k])
    return out


class Algorithm:
    """Base driver; subclasses define `loss_fn` + `training_step`."""

    # class-level default: algorithms with bespoke __init__ (SAC, CQL,
    # DreamerV3) never touch the podracer path but still run the shared
    # train()/stop() which checks it
    _podracer = None

    def __init__(self, config: AlgorithmConfig):
        self.config = config
        self.iteration = 0
        self._total_env_steps = 0
        self._start = time.time()
        self._podracer = None
        opt_cfg = {"lr": config.lr, "grad_clip": config.grad_clip}
        if getattr(config, "topology", "dynamic") == "sebulba":
            # Podracer split actor/learner pods: rollouts stream through
            # compiled slot-ring channels, params broadcast back
            # device-to-device — no EnvRunnerGroup/LearnerGroup, no
            # per-iteration object-store traffic (rllib/podracer.py)
            if config.is_multi_agent:
                raise ValueError(
                    "topology='sebulba' supports single-agent configs")
            from ray_tpu_torch.rllib.podracer import SebulbaTopology

            self.spec = config.rl_module_spec()
            self.specs = None
            self.env_runner_group = None
            self.learner_group = None
            self.learner_groups = None
            self._podracer = SebulbaTopology(
                config, self._podracer_program(),
                elastic=bool(getattr(config, "elastic", False)))
            return
        if config.is_multi_agent:
            if (config.env_to_module_connector is not None
                    or config.learner_connector is not None):
                raise ValueError(
                    "connector pipelines are not wired into the "
                    "multi-agent runner yet; configure them per-policy "
                    "inside the env/module instead")
            # one module + learner group per policy; agents batch onto
            # policies inside the multi-agent runner
            from ray_tpu_torch.rllib.env.multi_agent_env import (
                MultiAgentEnvRunnerGroup)

            self.specs = config.multi_rl_module_specs()
            self.spec = None
            self.env_runner_group = MultiAgentEnvRunnerGroup(
                config.env, self.specs, config.policy_mapping_fn,
                num_env_runners=config.num_env_runners,
                num_envs_per_runner=config.num_envs_per_env_runner,
                seed=config.seed, device=config.env_runner_device)
            self.learner_groups = {
                pid: LearnerGroup(spec, type(self).loss_fn,
                                  optimizer_config=dict(opt_cfg),
                                  num_learners=config.num_learners,
                                  seed=config.seed + i,
                                  device=config.learner_device)
                for i, (pid, spec) in enumerate(self.specs.items())}
            self.learner_group = None
        else:
            self.spec = config.rl_module_spec()
            self.env_runner_group = EnvRunnerGroup(
                config.env, self.spec,
                num_env_runners=config.num_env_runners,
                num_envs_per_runner=config.num_envs_per_env_runner,
                seed=config.seed, env_config=config.env_config,
                obs_connector=config.env_to_module_connector,
                device=config.env_runner_device)
            self.learner_group = LearnerGroup(
                self.spec, type(self).loss_fn,
                optimizer_config=opt_cfg,
                num_learners=config.num_learners, seed=config.seed,
                batch_connector=config.learner_connector,
                device=config.learner_device)
            self.learner_groups = None
        self._sync_weights()

    # ------------------------------------------------------------ interface

    @staticmethod
    def loss_fn(module, params, batch, cfg):  # pragma: no cover - abstract
        raise NotImplementedError

    def training_step(self) -> Dict[str, Any]:
        raise NotImplementedError

    def _podracer_program(self):  # pragma: no cover - abstract-ish
        raise NotImplementedError(
            f"{type(self).__name__} is not wired onto the Sebulba "
            f"topology; topology='sebulba' supports PPO and IMPALA")

    # ------------------------------------------------------------- train()

    def train(self) -> Dict[str, Any]:
        """One iteration: run `training_step`, fold in sampler metrics."""
        if self._podracer is not None:
            return self._train_podracer()
        result = self.training_step()
        self.iteration += 1
        metrics = self.env_runner_group.get_metrics()
        returns = [m["episode_return_mean"] for m in metrics
                   if m.get("episode_return_mean") is not None]
        lens = [m["episode_len_mean"] for m in metrics
                if m.get("episode_len_mean") is not None]
        result.update({
            "training_iteration": self.iteration,
            "num_env_steps_sampled_lifetime": self._total_env_steps,
            "episode_return_mean": (float(np.mean(returns))
                                    if returns else None),
            "episode_len_mean": float(np.mean(lens)) if lens else None,
            "time_total_s": time.time() - self._start,
        })
        interval = getattr(self.config, "evaluation_interval", None)
        if interval and self.iteration % interval == 0:
            result["evaluation"] = self.evaluate()["evaluation"]
        return result

    def _train_podracer(self) -> Dict[str, Any]:
        """One Sebulba iteration: read every learner rank's report off its
        channel (the steady-state driver cost — shared-memory reads, zero
        control-plane RPCs) and fold the relayed sampler metrics in."""
        out = self._podracer.step()
        self.iteration += 1
        self._total_env_steps += out.pop("env_steps", 0)
        result = dict(out.pop("metrics", {}))
        result.update(out)
        result.update({
            "training_iteration": self.iteration,
            "num_env_steps_sampled_lifetime": self._total_env_steps,
            "time_total_s": time.time() - self._start,
        })
        return result

    # ------------------------------------------------------------ evaluation

    def _make_eval_runner_group(self):
        """Dedicated eval sampler group (overridden by continuous-control
        algorithms). Seeded away from the train runners so eval episodes
        are not correlated with training rollouts."""
        cfg = self.config
        if cfg.is_multi_agent:
            raise NotImplementedError(
                "evaluate() supports single-agent configs; sample the "
                "multi-agent runner group directly for eval")
        if self._podracer is not None:
            raise NotImplementedError(
                "evaluate() is not wired for topology='sebulba' (the "
                "learner ranks are dedicated by their run loops)")
        import copy as _copy

        return EnvRunnerGroup(
            cfg.env, self.spec,
            num_env_runners=cfg.evaluation_num_env_runners,
            num_envs_per_runner=cfg.num_envs_per_env_runner,
            seed=cfg.seed + 77_777, env_config=cfg.env_config,
            # a stateful connector (running obs stats) must not be shared
            # with the train runners — eval rollouts would mutate the
            # normalization applied to training batches
            obs_connector=_copy.deepcopy(cfg.env_to_module_connector),
            device=cfg.env_runner_device)

    def evaluate(self) -> Dict[str, Any]:
        """Run the current (greedy) policy on DEDICATED eval runners until
        `evaluation_duration` episodes/timesteps complete — eval metrics
        never mix with train-time sampling
        (≈ Algorithm.evaluate, rllib/algorithms/algorithm.py:954)."""
        cfg = self.config
        if getattr(self, "_eval_runner_group", None) is None:
            self._eval_runner_group = self._make_eval_runner_group()
        group = self._eval_runner_group
        group.set_weights(self.learner_group.get_weights())
        group.get_metrics()  # drain any stale episode stats

        duration = cfg.evaluation_duration
        by_steps = cfg.evaluation_duration_unit == "timesteps"
        chunk = cfg.rollout_fragment_length
        episodes, steps = 0, 0
        returns: List[float] = []
        lens: List[float] = []
        for _ in range(1000):  # hard cap: eval must terminate
            for batch in group.sample(chunk, greedy=True):
                steps += int(np.size(batch["rewards"]))
            for m in group.get_metrics():
                n = m.get("num_episodes", 0)
                episodes += n
                if n and m.get("episode_return_mean") is not None:
                    returns.extend([m["episode_return_mean"]] * n)
                    lens.extend([m["episode_len_mean"]] * n)
            if (steps if by_steps else episodes) >= duration:
                break
        return {"evaluation": {
            "episode_return_mean": (float(np.mean(returns))
                                    if returns else None),
            "episode_len_mean": float(np.mean(lens)) if lens else None,
            "num_episodes": episodes,
            "num_env_steps": steps,
        }}

    def stop(self) -> None:
        if self._podracer is not None:
            self._podracer.shutdown()
            return
        self.env_runner_group.stop()
        eval_group = getattr(self, "_eval_runner_group", None)
        if eval_group is not None:
            eval_group.stop()
        if self.learner_groups is not None:
            for lg in self.learner_groups.values():
                lg.shutdown()
        else:
            self.learner_group.shutdown()

    # ----------------------------------------------------------- weights

    def _sync_weights(self) -> None:
        if self.learner_groups is not None:
            self.env_runner_group.set_weights(
                {pid: lg.get_weights()
                 for pid, lg in self.learner_groups.items()})
        else:
            self.env_runner_group.set_weights(
                self.learner_group.get_weights())

    # -------------------------------------------------------- checkpointing

    def _extra_state(self) -> Dict[str, Any]:
        """Algorithm-specific mutable state (adaptive coefficients, target
        nets, replay buffers). Subclasses extend both directions."""
        return {}

    def _set_extra_state(self, extra: Dict[str, Any]) -> None:
        pass

    def get_state(self) -> Dict[str, Any]:
        if self._podracer is not None:
            # the learner ranks are dedicated by their run loops; weights
            # live device-side in the topology, not in a driver-reachable
            # LearnerGroup. Checkpoint from the dynamic topology instead.
            raise RuntimeError(
                "checkpointing is not supported under topology='sebulba'; "
                "train with topology='dynamic' to checkpoint")
        learner = (
            {pid: lg.get_state() for pid, lg in self.learner_groups.items()}
            if self.learner_groups is not None
            else self.learner_group.get_state())
        return {
            "learner": learner,
            "iteration": self.iteration,
            "total_env_steps": self._total_env_steps,
            "config": self.config.to_dict(),
            "algo_class": type(self).__name__,
            "extra": self._extra_state(),
        }

    def set_state(self, state: Dict[str, Any]) -> None:
        if self.learner_groups is not None:
            for pid, lg in self.learner_groups.items():
                lg.set_state(state["learner"][pid])
        else:
            self.learner_group.set_state(state["learner"])
        self.iteration = state["iteration"]
        self._total_env_steps = state["total_env_steps"]
        self._set_extra_state(state.get("extra", {}))
        self._sync_weights()

    def save_to_checkpoint(self, path: Optional[str] = None) -> Checkpoint:
        path = path or os.path.join(
            tempfile.gettempdir(), f"algo_ckpt_{uuid.uuid4().hex[:12]}")
        os.makedirs(path, exist_ok=True)
        with open(os.path.join(path, "algorithm_state.pkl"), "wb") as f:
            cloudpickle.dump(self.get_state(), f)
        return Checkpoint(path)

    # alias matching the reference's Trainable surface
    save = save_to_checkpoint

    def restore_from_checkpoint(self, checkpoint: Checkpoint) -> None:
        with checkpoint.as_directory() as d:
            with open(os.path.join(d, "algorithm_state.pkl"), "rb") as f:
                self.set_state(pickle.load(f))

    restore = restore_from_checkpoint

    @classmethod
    def from_checkpoint(cls, checkpoint) -> "Algorithm":
        if isinstance(checkpoint, str):
            checkpoint = Checkpoint(checkpoint)
        with checkpoint.as_directory() as d:
            with open(os.path.join(d, "algorithm_state.pkl"), "rb") as f:
                state = pickle.load(f)
        cfg_cls = cls.get_default_config()
        config = cfg_cls.update_from_dict(state["config"])
        algo = config.build()
        algo.set_state(state)
        return algo

    @classmethod
    def get_default_config(cls) -> AlgorithmConfig:
        raise NotImplementedError

    # --------------------------------------------------------------- helpers

    def _merge_time_major(
            self, samples: List[Dict[str, np.ndarray]]
    ) -> Dict[str, np.ndarray]:
        """Concatenate per-runner [T, B, ...] batches along B."""
        return merge_time_major(samples)
