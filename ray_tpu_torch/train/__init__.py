"""ray_tpu_torch.train: distributed training orchestration (Ray Train
analog).

Counterpart: ``ray_tpu/train/__init__.py``. Public surface mirrors
`ray.train` (`python/ray/train/__init__.py`): Checkpoint,
ScalingConfig/RunConfig/FailureConfig/CheckpointConfig,
report/get_checkpoint/get_context/get_dataset_shard, the data-parallel
trainers and the gradient averager. ``TorchConfig``/``TorchTrainer`` take
the place of ``JaxConfig``/``JaxTrainer``. The pipeline-parallel trainer
(``PipelineTrainer``, ``StageSpec``) is not ported yet (ROADMAP A6).
"""

from ray_tpu_torch.air.config import (  # noqa: F401
    CheckpointConfig,
    FailureConfig,
    RunConfig,
    ScalingConfig,
)
from ray_tpu_torch.train._checkpoint import Checkpoint  # noqa: F401
from ray_tpu_torch.train._internal.session import (  # noqa: F401
    TrainContext,
    get_checkpoint,
    get_context,
    get_dataset_shard,
    report,
)
from ray_tpu_torch.train._internal.gradients import (  # noqa: F401
    GradientAverager,
)
from ray_tpu_torch.train.backend import (  # noqa: F401
    Backend,
    BackendConfig,
    TorchConfig,
)
from ray_tpu_torch.train.trainer import (  # noqa: F401
    BaseTrainer,
    DataParallelTrainer,
    Result,
    TorchTrainer,
)

from ray_tpu_torch._private.usage import record_library_usage as _rlu

_rlu("train")
del _rlu
