"""ray_tpu_torch.rllib: RL training on the new-API-stack split.

Counterpart: ``ray_tpu/rllib``. RLModule (plain functions over a params
dict of tensors) + Learner/LearnerGroup (SGD actors) +
EnvRunner/EnvRunnerGroup (sampling actors) + Algorithm drivers (PPO,
IMPALA, APPO, DQN, SAC, CQL, MARWIL and BC, DreamerV3), and the Podracer
topologies (``AnakinTrainer``, whose env, rollout and update run on the
card, and ``SebulbaTopology``). Every role runs on the card unless its
caller names the CPU.
"""

from ray_tpu_torch.rllib.algorithms import (APPO, BC, DQN, IMPALA, MARWIL,
                                            PPO, SAC, APPOConfig, Algorithm,
                                            AlgorithmConfig, BCConfig,
                                            DQNConfig, DreamerV3,
                                            DreamerV3Config, IMPALAConfig,
                                            MARWILConfig, PPOConfig,
                                            SACConfig)
from ray_tpu_torch.rllib.connectors import (CastObs, ClipRewards, Connector,
                                            ConnectorPipeline, FlattenObs,
                                            NormalizeObs)
from ray_tpu_torch.rllib.core.learner import Learner, LearnerGroup
from ray_tpu_torch.rllib.core.rl_module import RLModule, RLModuleSpec
from ray_tpu_torch.rllib.env.multi_agent_env import (MultiAgentEnv,
                                                     MultiAgentEnvRunner,
                                                     MultiAgentEnvRunnerGroup)
from ray_tpu_torch.rllib.env.single_agent_env_runner import (
    EnvRunnerGroup, SingleAgentEnvRunner)
from ray_tpu_torch.rllib.podracer import AnakinTrainer, SebulbaTopology

__all__ = [
    "Algorithm",
    "AlgorithmConfig",
    "PPO",
    "PPOConfig",
    "IMPALA",
    "IMPALAConfig",
    "APPO",
    "APPOConfig",
    "DQN",
    "DQNConfig",
    "SAC",
    "SACConfig",
    "BC",
    "BCConfig",
    "MARWIL",
    "MARWILConfig",
    "Connector",
    "ConnectorPipeline",
    "NormalizeObs",
    "ClipRewards",
    "CastObs",
    "FlattenObs",
    "Learner",
    "LearnerGroup",
    "RLModule",
    "RLModuleSpec",
    "EnvRunnerGroup",
    "SingleAgentEnvRunner",
    "MultiAgentEnv",
    "MultiAgentEnvRunner",
    "MultiAgentEnvRunnerGroup",
    "AnakinTrainer",
    "SebulbaTopology",
]

from ray_tpu_torch._private.usage import record_library_usage as _rlu

_rlu("rllib")
del _rlu
