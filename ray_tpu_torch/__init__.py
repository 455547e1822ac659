"""ray_tpu_torch: the PyTorch/CUDA port of ray_tpu, for NVIDIA Hopper.

A package of its own beside ``ray_tpu`` (the JAX reference it is held
against); it imports torch and numpy, never JAX and nothing of ``ray_tpu``.
It runs, serves and trains:

  * the runtime (``init``, ``remote``, ``get``, ``put``, ...): a controller,
    a supervisor per node with a shared-memory object store, and worker
    processes that run tasks and actors; a ``GPU`` resource pins each
    worker to its cards, and a CUDA tensor put into the object store stays
    on its card;
  * ``LLMServerImpl`` runs a model through the continuous paged scheduler,
    whose attention is a hand-written CUDA kernel on the card, and
    ``ray_tpu_torch.serve`` deploys it (``serve.run`` of
    ``serve.llm.LLMServer``): a controller, replica actors behind a router
    with prefix affinity, handles, weights shared per node;
  * ``init_train_state`` and ``make_train_step`` train a model, its
    attention forward and backward through hand-written flash-attention
    kernels on the card; ``ray_tpu_torch.train`` (``TorchTrainer``,
    ``GradientAverager``) runs a data-parallel loop in the runtime's
    workers, over ``ray_tpu_torch.util.collective``'s host and NCCL
    groups, gang-placed by ``ray_tpu_torch.util.placement_group``;
  * ``ray_tpu_torch.tune`` (``Tuner``, schedulers, searchers) runs one
    trial process per configuration; ``.bind`` builds a DAG
    (``ray_tpu_torch.dag``), compiled onto shared-memory channels with
    ``experimental_compile``; ``ray_tpu_torch.workflow`` runs a DAG with
    its step results kept; ``init(address="client://...")`` drives a
    cluster from a process outside it (``ray_tpu_torch.util.client``);
  * ``ray_tpu_torch.util`` has ``ActorPool``, a distributed ``Queue``,
    the state API (``util.state``) and user metrics (``util.metrics``);
    ``ray_tpu_torch.autoscaler`` launches and retires nodes on demand
    (v1's ``StandardAutoscaler`` and v2's ``Reconciler``, over a
    ``NodeProvider``; a node type may count cards), and
    ``python -m ray_tpu_torch.scripts.jobs`` submits and follows jobs.

Importing the package imports the runtime only: its daemons start as
``python -m ray_tpu_torch._private...`` and never import torch. The model
and serving names load on first use.
"""

__version__ = "0.1.0"

from ray_tpu_torch._private.api import (  # noqa: F401
    ObjectRef,
    ObjectRefGenerator,
    available_resources,
    cancel,
    cluster_resources,
    get,
    get_actor,
    get_runtime_context,
    init,
    is_initialized,
    kill,
    method,
    nodes,
    put,
    remote,
    shutdown,
    wait,
)
from ray_tpu_torch._private.exceptions import (  # noqa: F401
    ActorDiedError,
    ActorUnavailableError,
    GetTimeoutError,
    ObjectLostError,
    RayTpuError,
    TaskCancelledError,
    TaskError,
    WorkerCrashedError,
)

# name -> module holding it; loaded on first access (PEP 562)
_LAZY = {
    "LLMServerImpl": "ray_tpu_torch.serve.llm",
    "OptimizerConfig": "ray_tpu_torch.models.training",
    "TrainState": "ray_tpu_torch.models.training",
    "init_train_state": "ray_tpu_torch.models.training",
    "make_optimizer": "ray_tpu_torch.models.training",
    "make_train_step": "ray_tpu_torch.models.training",
    "convert": "ray_tpu_torch._private.convert",
    "presets": "ray_tpu_torch.models.presets",
}


def __getattr__(name):
    target = _LAZY.get(name)
    if target is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    import importlib

    module = importlib.import_module(target)
    value = module if target.rsplit(".", 1)[-1] == name else getattr(
        module, name)
    globals()[name] = value
    return value


def __dir__():
    return sorted(set(globals()) | set(_LAZY))


__all__ = [
    "ActorDiedError", "ActorUnavailableError", "GetTimeoutError",
    "LLMServerImpl", "ObjectLostError", "ObjectRef", "ObjectRefGenerator",
    "OptimizerConfig", "RayTpuError", "TaskCancelledError", "TaskError",
    "TrainState", "WorkerCrashedError", "available_resources", "cancel",
    "cluster_resources", "convert", "get", "get_actor",
    "get_runtime_context", "init", "init_train_state", "is_initialized",
    "kill", "make_optimizer", "make_train_step", "method", "nodes", "put",
    "presets", "remote", "shutdown", "wait",
]
