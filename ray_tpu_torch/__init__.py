"""ray_tpu_torch: the PyTorch/CUDA port of ray_tpu, for NVIDIA Hopper.

A package of its own beside ``ray_tpu`` (the JAX reference it is held
against); it imports torch and numpy, never JAX and nothing of ``ray_tpu``.
It serves and trains:

  * ``LLMServerImpl`` runs a model through the continuous paged scheduler,
    whose attention is a hand-written CUDA kernel on the card;
  * ``init_train_state`` and ``make_train_step`` train a model, its
    attention forward and backward through hand-written flash-attention
    kernels on the card.
"""

from ray_tpu_torch._private import convert
from ray_tpu_torch.models import presets
from ray_tpu_torch.models.training import (OptimizerConfig, TrainState,
                                           init_train_state, make_optimizer,
                                           make_train_step)
from ray_tpu_torch.serve.llm import LLMServerImpl

__all__ = ["LLMServerImpl", "OptimizerConfig", "TrainState", "convert",
           "init_train_state", "make_optimizer", "make_train_step",
           "presets"]
