from ray_tpu_torch.rllib.algorithms.algorithm import Algorithm
from ray_tpu_torch.rllib.algorithms.algorithm_config import AlgorithmConfig
from ray_tpu_torch.rllib.algorithms.ppo import PPO, PPOConfig
from ray_tpu_torch.rllib.algorithms.impala import IMPALA, IMPALAConfig
from ray_tpu_torch.rllib.algorithms.appo import APPO, APPOConfig
from ray_tpu_torch.rllib.algorithms.dqn import DQN, DQNConfig
from ray_tpu_torch.rllib.algorithms.sac import SAC, SACConfig
from ray_tpu_torch.rllib.algorithms.marwil import (BC, BCConfig, MARWIL,
                                                   MARWILConfig)
from ray_tpu_torch.rllib.algorithms.cql import CQL, CQLConfig
from ray_tpu_torch.rllib.algorithms.dreamerv3 import (DreamerV3,
                                                      DreamerV3Config)

__all__ = [
    "DreamerV3",
    "DreamerV3Config",
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
    "CQL",
    "CQLConfig",
    "MARWIL",
    "MARWILConfig",
]
