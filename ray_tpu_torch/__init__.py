"""ray_tpu_torch: the PyTorch/CUDA port of ray_tpu, for NVIDIA Hopper.

A package of its own beside ``ray_tpu`` (the JAX reference it is held
against); it imports torch and numpy, never JAX and nothing of ``ray_tpu``.
This slice serves: ``LLMServerImpl`` runs a model through the continuous
paged scheduler, whose attention is a hand-written CUDA kernel on the card.
"""

from ray_tpu_torch._private import convert
from ray_tpu_torch.models import presets
from ray_tpu_torch.serve.llm import LLMServerImpl

__all__ = ["LLMServerImpl", "convert", "presets"]
