"""ray_tpu_torch.tune: distributed hyperparameter search (Ray Tune analog,
`python/ray/tune/`). `tune.report` is the same session report used by
train (the reference unified them the same way).

Counterpart: ``ray_tpu/tune/__init__.py``, with the same exports."""

from ray_tpu_torch.train._internal.session import (  # noqa: F401
    get_checkpoint,
    get_context,
    report,
)
from ray_tpu_torch.tune.schedulers import (  # noqa: F401
    ASHAScheduler,
    AsyncHyperBandScheduler,
    FIFOScheduler,
    HyperBandScheduler,
    MedianStoppingRule,
    PB2,
    PopulationBasedTraining,
    TrialScheduler,
)
from ray_tpu_torch.tune.search import (  # noqa: F401
    BasicVariantGenerator,
    BOHBSearcher,
    Searcher,
    TPESearcher,
    choice,
    grid_search,
    loguniform,
    quniform,
    randint,
    randn,
    sample_from,
    uniform,
)
from ray_tpu_torch.tune.search_external import (  # noqa: F401
    AskTellSearcher,
    OptunaSearcher,
)
from ray_tpu_torch.tune.tuner import (  # noqa: F401
    ResultGrid,
    TuneConfig,
    Tuner,
    with_resources,
)

from ray_tpu_torch._private.usage import record_library_usage as _rlu

_rlu("tune")
del _rlu
