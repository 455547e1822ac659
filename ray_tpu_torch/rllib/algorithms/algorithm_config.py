"""AlgorithmConfig: fluent builder for RL algorithms.

Counterpart: ``ray_tpu/rllib/algorithms/algorithm_config.py``:
``.environment() .env_runners() .training() .learners() .debugging()``
chained setters, ``.build()`` to get the Algorithm. Unknown kwargs raise.

Beside the JAX package's settings it carries where its roles run, the
counterpart of JAX's default backend: ``learner_device`` (set with
``.learners(device=...)``) and ``env_runner_device``
(``.env_runners(device=...)``). ``None``, the default, is the card; the
CPU runs only when a caller names it.
"""

from __future__ import annotations

import copy
from typing import Any, Dict, Optional, Type

from ray_tpu_torch.rllib.core.rl_module import RLModuleSpec


class AlgorithmConfig:
    algo_class: Optional[Type] = None  # set by subclasses

    def __init__(self):
        # environment
        self.env: Optional[str] = None
        self.env_config: Dict[str, Any] = {}
        self.observation_dim: Optional[int] = None  # inferred if None
        self.num_actions: Optional[int] = None
        # env runners
        self.num_env_runners: int = 0
        self.num_envs_per_env_runner: int = 4
        self.rollout_fragment_length: int = 64
        # where the env runners' forwards run: None is the card
        self.env_runner_device: Optional[str] = None
        # learners
        self.num_learners: int = 0
        # where the learners' params and updates live: None is the card
        self.learner_device: Optional[str] = None
        # execution topology (rllib/podracer.py):
        #   "dynamic" — the classic actor-learner loop (object-store
        #   rollout transfer, per-iteration weight puts); the measured
        #   baseline.
        #   "sebulba" — Podracer split actor/learner pods: runners stream
        #   fixed-shape trajectory batches into learner ranks through
        #   depth-k slot-ring channels; fresh params broadcast back
        #   device-to-device over a learner+runners collective group.
        self.topology: str = "dynamic"
        # trajectory-channel slot-ring depth (= the off-policy lag bound,
        # in rollout batches); None reads
        # RAY_TPU_TORCH_PODRACER_CHANNEL_DEPTH.
        # Explicit zeros are rejected, never silently defaulted.
        self.podracer_channel_depth: Optional[int] = None
        # elastic membership (sebulba only): a killed env-runner is
        # respawned under the RAY_TPU_TORCH_ELASTIC_* budget/backoff policy and
        # rejoins over the next param broadcast; learner loss stays a
        # clean terminal error (_private/elastic.py)
        self.elastic: bool = False
        # training
        self.gamma: float = 0.99
        self.lr: float = 5e-4
        self.grad_clip: float = 0.5
        self.train_batch_size: int = 256
        self.model: Dict[str, Any] = {"hiddens": (64, 64)}
        # debugging
        self.seed: int = 0
        # multi-agent (reference AlgorithmConfig.multi_agent()): policies
        # maps policy_id -> RLModuleSpec kwargs (obs_dim, num_actions,
        # hiddens); env must then be a MultiAgentEnv factory/class
        self.policies: Optional[Dict[str, Dict[str, Any]]] = None
        self.policy_mapping_fn: Optional[Any] = None
        # connector pipelines (rllib/connectors.py; ≈ ConnectorV2):
        # env_to_module runs on host obs before the forward in each
        # env runner; learner_connector transforms every train batch
        self.env_to_module_connector: Optional[Any] = None
        self.learner_connector: Optional[Any] = None
        # evaluation (≈ AlgorithmConfig.evaluation(), feeding
        # Algorithm.evaluate / rllib/algorithms/algorithm.py:954):
        # dedicated eval runners, greedy policy, metrics kept separate
        # from train-time sampling
        self.evaluation_interval: Optional[int] = None  # every N train()s
        self.evaluation_duration: int = 10
        self.evaluation_duration_unit: str = "episodes"  # or "timesteps"
        self.evaluation_num_env_runners: int = 0

    # ------------------------------------------------------- fluent setters

    def _apply(self, kwargs: Dict[str, Any]) -> "AlgorithmConfig":
        for k, v in kwargs.items():
            if v is None:
                continue
            if not hasattr(self, k):
                raise AttributeError(
                    f"{type(self).__name__} has no setting {k!r}")
            setattr(self, k, v)
        return self

    def environment(self, env: Optional[str] = None, *,
                    env_config: Optional[Dict[str, Any]] = None,
                    observation_dim: Optional[int] = None,
                    num_actions: Optional[int] = None) -> "AlgorithmConfig":
        return self._apply(dict(env=env, env_config=env_config,
                                observation_dim=observation_dim,
                                num_actions=num_actions))

    def env_runners(self, *, num_env_runners: Optional[int] = None,
                    num_envs_per_env_runner: Optional[int] = None,
                    rollout_fragment_length: Optional[int] = None,
                    env_to_module_connector: Optional[Any] = None,
                    device: Optional[str] = None
                    ) -> "AlgorithmConfig":
        return self._apply(dict(
            num_env_runners=num_env_runners,
            num_envs_per_env_runner=num_envs_per_env_runner,
            rollout_fragment_length=rollout_fragment_length,
            env_to_module_connector=env_to_module_connector,
            env_runner_device=device))

    def learners(self, *, num_learners: Optional[int] = None,
                 topology: Optional[str] = None,
                 podracer_channel_depth: Optional[int] = None,
                 elastic: Optional[bool] = None,
                 device: Optional[str] = None
                 ) -> "AlgorithmConfig":
        if topology not in (None, "dynamic", "sebulba"):
            raise ValueError(
                f"topology must be 'dynamic' or 'sebulba', got {topology!r}")
        if podracer_channel_depth is not None \
                and int(podracer_channel_depth) < 1:
            # an explicit zero must raise here,
            # not fall through a falsy-`or` chain to the env default
            raise ValueError(
                f"podracer_channel_depth must be >= 1, got "
                f"{podracer_channel_depth!r} (explicit zeros are rejected,"
                f" never silently defaulted)")
        return self._apply(dict(
            num_learners=num_learners, topology=topology,
            podracer_channel_depth=podracer_channel_depth,
            elastic=elastic, learner_device=device))

    def training(self, **kwargs) -> "AlgorithmConfig":
        return self._apply(kwargs)

    def debugging(self, *, seed: Optional[int] = None) -> "AlgorithmConfig":
        return self._apply(dict(seed=seed))

    def evaluation(self, *, evaluation_interval: Optional[int] = None,
                   evaluation_duration: Optional[int] = None,
                   evaluation_duration_unit: Optional[str] = None,
                   evaluation_num_env_runners: Optional[int] = None
                   ) -> "AlgorithmConfig":
        if evaluation_duration_unit not in (None, "episodes", "timesteps"):
            raise ValueError("evaluation_duration_unit must be "
                             "'episodes' or 'timesteps'")
        return self._apply(dict(
            evaluation_interval=evaluation_interval,
            evaluation_duration=evaluation_duration,
            evaluation_duration_unit=evaluation_duration_unit,
            evaluation_num_env_runners=evaluation_num_env_runners))

    def multi_agent(self, *, policies: Optional[Dict[str, Dict[str, Any]]]
                    = None, policy_mapping_fn=None) -> "AlgorithmConfig":
        """≈ reference `AlgorithmConfig.multi_agent()`. `policies` maps
        policy_id -> RLModuleSpec kwargs; `policy_mapping_fn(agent_id) ->
        policy_id`. The env (set via .environment) must be a MultiAgentEnv
        class or zero-arg factory."""
        return self._apply(dict(policies=policies,
                                policy_mapping_fn=policy_mapping_fn))

    @property
    def is_multi_agent(self) -> bool:
        return bool(self.policies)

    def multi_rl_module_specs(self) -> Dict[str, RLModuleSpec]:
        assert self.policies, "call .multi_agent(policies=...) first"
        return {pid: RLModuleSpec(**kw) for pid, kw in self.policies.items()}

    # ------------------------------------------------------------- building

    def copy(self) -> "AlgorithmConfig":
        return copy.deepcopy(self)

    def rl_module_spec(self) -> RLModuleSpec:
        obs_dim, num_actions = self.observation_dim, self.num_actions
        obs_shape: tuple = tuple(self.model.get("obs_shape", ()))
        if obs_dim is None or num_actions is None:
            import math

            import gymnasium as gym

            import ray_tpu_torch.rllib.env  # registers the synthetic envs

            probe = gym.make(self.env, **self.env_config)
            try:
                shape = probe.observation_space.shape
                if len(shape) == 3:
                    # image obs: Nature-CNN torso over the full shape
                    obs_shape = tuple(int(s) for s in shape)
                    obs_dim = obs_dim or int(math.prod(shape))
                else:
                    obs_dim = obs_dim or int(shape[0])
                num_actions = num_actions or int(probe.action_space.n)
            finally:
                probe.close()
        return RLModuleSpec(obs_dim=obs_dim, num_actions=num_actions,
                            hiddens=tuple(self.model.get("hiddens",
                                                         (64, 64))),
                            obs_shape=obs_shape)

    def build(self):
        assert self.algo_class is not None, "use a subclass (PPOConfig, …)"
        assert self.env is not None, "call .environment(env=...) first"
        return self.algo_class(self.copy())

    def to_dict(self) -> Dict[str, Any]:
        return {k: v for k, v in self.__dict__.items()}

    def update_from_dict(self, d: Dict[str, Any]) -> "AlgorithmConfig":
        return self._apply(dict(d))

    # ---------------------------------------------------------------- tune

    def to_trainable(self, *, checkpoint_every: int = 0):
        """A Tune function-trainable: builds the algo (with per-trial
        config overrides), loops `train()` and reports each iteration
        (reference: Algorithm IS-A Trainable; here Tune runs functions)."""
        base = self.copy()

        def trainable(config: Dict[str, Any]):
            from ray_tpu_torch.train._internal import session as session_mod

            cfg = base.copy().update_from_dict(config or {})
            algo = cfg.build()
            sess = session_mod.get_session()
            try:
                i = 0
                while True:
                    result = algo.train()
                    i += 1
                    ckpt = None
                    if checkpoint_every and i % checkpoint_every == 0:
                        ckpt = algo.save_to_checkpoint()
                    session_mod.report(result, checkpoint=ckpt)
            finally:
                algo.stop()

        return trainable
