"""The collectives' group API (``init_collective_group``, ``allreduce`` and
the rest) over two backends: "host" (shared-memory channels on one node,
the chunked peer-to-peer ring across nodes) and "nccl" (a torch.distributed
process group per collective group). Every worker registers the ring's
frame handler at start-up, so importing the package imports no torch:
the tensor-parallel ops and the elastic groups load on first use.

Counterpart: ``ray_tpu/util/collective/__init__.py``, with the
tensor-parallel reduce ops (``tp``: ``TpOps``, ``make_tp_reduce_ops``,
and ``ThreadReducer`` in place of JAX's vmap-only ``psum_tp_ops``) and the
elastic groups (``resizable``: ``ResizableGroup``, ``refresh_membership``,
``sync_tree``)."""

from ray_tpu_torch.util.collective.async_work import CollectiveWork  # noqa: F401
from ray_tpu_torch.util.collective.collective import (  # noqa: F401
    allgather,
    allreduce,
    allreduce_coalesced,
    allreduce_coalesced_async,
    barrier,
    broadcast,
    create_collective_group,
    destroy_collective_group,
    get_collective_group_size,
    get_rank,
    init_collective_group,
    is_group_initialized,
    recv,
    reduce,
    reducescatter,
    send,
    synchronize,
)
from ray_tpu_torch.util.collective.types import (  # noqa: F401
    Backend,
    CollectiveError,
    ReduceOp,
)

# name -> module holding it, loaded on first access (PEP 562): ``tp`` and
# ``resizable`` import torch, and every worker imports this package (the
# ring's frame handler) at start-up, CPU-only workers too
_LAZY = {
    "ThreadReducer": "tp", "emulate_tp": "tp", "TpOps": "tp",
    "make_tp_reduce_ops": "tp", "ResizableGroup": "resizable",
    "refresh_membership": "resizable", "sync_tree": "resizable",
}


def __getattr__(name):
    module = _LAZY.get(name)
    if module is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    import importlib

    value = getattr(importlib.import_module(f"{__name__}.{module}"), name)
    globals()[name] = value
    return value


def __dir__():
    return sorted(set(globals()) | set(_LAZY))
