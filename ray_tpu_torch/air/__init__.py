"""Run, scaling, failure and checkpoint configs shared by the trainers.

Counterpart: ``ray_tpu/air/__init__.py``."""

from ray_tpu_torch.air.config import (  # noqa: F401
    CheckpointConfig,
    FailureConfig,
    RunConfig,
    ScalingConfig,
)

from ray_tpu_torch._private.usage import record_library_usage as _rlu

_rlu("air")
del _rlu
