"""The transformer family: configs, params, the training forward and step,
and the paged serving programs."""

from ray_tpu_torch.models.training import (OptimizerConfig, TrainState,
                                           init_train_state, make_optimizer,
                                           make_train_step)
from ray_tpu_torch.models.transformer import (TransformerConfig,
                                              count_params, forward,
                                              init_params, loss_fn)

__all__ = ["OptimizerConfig", "TrainState", "TransformerConfig",
           "count_params", "forward", "init_params", "init_train_state",
           "loss_fn", "make_optimizer", "make_train_step"]
