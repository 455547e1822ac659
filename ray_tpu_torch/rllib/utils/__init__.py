from ray_tpu_torch.rllib.utils.advantages import compute_gae, vtrace_returns
from ray_tpu_torch.rllib.utils.replay_buffers import (PrioritizedReplayBuffer,
                                                      ReplayBuffer)

__all__ = [
    "compute_gae",
    "vtrace_returns",
    "ReplayBuffer",
    "PrioritizedReplayBuffer",
]
