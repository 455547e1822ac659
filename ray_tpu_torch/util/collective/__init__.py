"""The collectives' transport: the point-to-point chunked ring
(``ring``), its types and its metrics. Every worker registers the ring's
frame handler at start-up. The group API (``init_collective_group``,
``allreduce`` and the rest) is not ported yet: it comes with data-parallel
training (ROADMAP A5)."""

from ray_tpu_torch.util.collective.types import (  # noqa: F401
    Backend,
    CollectiveError,
    ReduceOp,
)
