"""The collectives' group API (``init_collective_group``, ``allreduce`` and
the rest) over two backends: "host" (shared-memory channels on one node,
the chunked peer-to-peer ring across nodes) and "nccl" (a torch.distributed
process group per collective group). Every worker registers the ring's
frame handler at start-up.

Counterpart: ``ray_tpu/util/collective/__init__.py``. Its tensor-parallel
reduce ops (``tp``: ``TpOps``, ``make_tp_reduce_ops``, ``psum_tp_ops``)
and elastic groups (``resizable``: ``ResizableGroup``,
``refresh_membership``, ``sync_tree``) belong with the pipeline and
tensor-parallel trainer and are not ported yet (ROADMAP A6)."""

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
