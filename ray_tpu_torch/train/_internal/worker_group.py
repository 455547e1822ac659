"""Actor-based worker group.

Counterpart: ``ray_tpu/train/_internal/worker_group.py``. Analog of
`ray.train._internal.worker_group.WorkerGroup`
(`python/ray/train/_internal/worker_group.py:102`): N long-lived actors,
gang-placed under one placement group, each able to run arbitrary
functions. Ranks are assigned by grouping workers on the same node
(node_rank / local_rank), matching the reference's rank assignment in
`backend_executor.py`. A bundle that holds ``GPU`` gives its worker whole
cards (``CUDA_VISIBLE_DEVICES`` set at spawn), whether the group made its
placement group itself or joined one made elsewhere (a Tune trial's gang,
``placement_group``/``bundle_offset`` or the ambient group). The JAX
worker's ``ping`` and ``set_env_vars`` are left out: nothing calls them.
"""

from __future__ import annotations

import logging
import os
from typing import Any, Callable, Dict, List, Optional

import ray_tpu_torch as rt
from ray_tpu_torch.util.placement_group import (PlacementGroup,
                                                placement_group,
                                                remove_placement_group)

logger = logging.getLogger(__name__)


class RayTrainWorker:
    """The actor body. Hosts a session and executes shipped functions."""

    def __init__(self):
        self._session = None

    def node_info(self) -> Dict[str, Any]:
        ctx = rt.get_runtime_context()
        return {"node_id": ctx.get_node_id(), "pid": os.getpid(),
                "visible": os.environ.get("CUDA_VISIBLE_DEVICES")}

    def execute_fn(self, fn: Callable, *args, **kwargs):
        return fn(*args, **kwargs)

    # -------------------------------------------------------------- session

    def start_session(self, session_kwargs: Dict[str, Any]) -> bool:
        from ray_tpu_torch.train._internal import session as session_mod

        session_kwargs = dict(session_kwargs)
        gang_pg = session_kwargs.pop("gang_pg", None)
        if gang_pg is not None:
            # this process hosts a Tune trial whose gang PG also covers
            # the trainer's workers (bundles 1..N)
            set_ambient_placement_group(gang_pg, bundle_offset=1)
        self._session = session_mod.init_session(**session_kwargs)
        self._session.start()
        return True

    def next_report(self, timeout: Optional[float] = None):
        assert self._session is not None, "session not started"
        return self._session.next_report(timeout=timeout)

    def end_session(self) -> None:
        from ray_tpu_torch.train._internal import session as session_mod

        session_mod.shutdown_session()
        set_ambient_placement_group(None)
        self._session = None


class WorkerMetadata:
    def __init__(self, actor, node_id: str, pid: int,
                 visible: Optional[str] = None):
        self.actor = actor
        self.node_id = node_id
        self.pid = pid
        self.visible = visible  # the worker's CUDA_VISIBLE_DEVICES
        self.world_rank = -1
        self.local_rank = -1
        self.node_rank = -1
        self.local_world_size = 1


# Ambient gang placement group: a Tune trial reserves ONE placement group
# covering the trial actor AND its trainer's whole worker gang (bundle 0 =
# trial actor, bundles 1..N = train workers); the trainer's WorkerGroup
# inside the trial joins that group instead of creating its own, so
# concurrent trials can never hold actors while starving each other's
# worker bundles (reference: tune/execution/placement_groups.py).
_ambient_pg: Optional[PlacementGroup] = None
_ambient_bundle_offset: int = 0


def set_ambient_placement_group(pg: Optional[PlacementGroup],
                                bundle_offset: int = 1) -> None:
    global _ambient_pg, _ambient_bundle_offset
    _ambient_pg = pg
    _ambient_bundle_offset = bundle_offset


class WorkerGroup:
    def __init__(
        self,
        num_workers: int,
        resources_per_worker: Optional[Dict[str, float]] = None,
        placement_strategy: str = "PACK",
        placement_group: Optional[PlacementGroup] = None,
        bundle_offset: int = 0,
    ):
        self._num_workers = num_workers
        self._resources = dict(resources_per_worker or {"CPU": 1.0})
        self._pg: Optional[PlacementGroup] = placement_group
        self._owns_pg = placement_group is None
        self._bundle_offset = bundle_offset
        self.workers: List[WorkerMetadata] = []
        self._placement_strategy = placement_strategy
        if self._pg is None and _ambient_pg is not None:
            self._pg = _ambient_pg
            self._bundle_offset = _ambient_bundle_offset
            self._owns_pg = False

    @property
    def num_gpus_per_worker(self) -> int:
        return int(self._resources.get("GPU", 0))

    def start(self, timeout: float = 60.0) -> None:
        if self._owns_pg:
            bundles = [dict(self._resources)
                       for _ in range(self._num_workers)]
            self._pg = placement_group(bundles,
                                       strategy=self._placement_strategy)
        if not self._pg.wait(timeout=timeout):
            if self._owns_pg:
                remove_placement_group(self._pg)
            raise TimeoutError(
                f"placement group for {self._num_workers} workers "
                f"({self._resources}) not ready in {timeout}s")

        worker_cls = rt.remote(RayTrainWorker)
        num_cpus = self._resources.get("CPU", 1.0)
        res = {k: v for k, v in self._resources.items()
               if k not in ("CPU", "GPU")}
        actors = [
            worker_cls.options(
                num_cpus=num_cpus,
                num_gpus=self.num_gpus_per_worker or None,
                resources=res or None,
                placement_group=self._pg,
                placement_group_bundle_index=self._bundle_offset + i,
            ).remote()
            for i in range(self._num_workers)
        ]
        infos = rt.get([a.node_info.remote() for a in actors],
                       timeout=timeout)
        self.workers = [
            WorkerMetadata(a, info["node_id"], info["pid"], info["visible"])
            for a, info in zip(actors, infos)
        ]
        self._assign_ranks()

    def _assign_ranks(self) -> None:
        """Stable sort by node so co-located workers get contiguous world
        ranks, then rank within node."""
        by_node: Dict[str, List[WorkerMetadata]] = {}
        for w in self.workers:
            by_node.setdefault(w.node_id, []).append(w)
        self.workers = [w for node in by_node.values() for w in node]
        for node_rank, node in enumerate(by_node.values()):
            for local_rank, w in enumerate(node):
                w.node_rank = node_rank
                w.local_rank = local_rank
                w.local_world_size = len(node)
        for world_rank, w in enumerate(self.workers):
            w.world_rank = world_rank

    def __len__(self) -> int:
        return len(self.workers)

    def execute(self, fn: Callable, *args, **kwargs) -> List[Any]:
        return rt.get(self.execute_async(fn, *args, **kwargs))

    def execute_async(self, fn: Callable, *args, **kwargs) -> List[Any]:
        return [
            w.actor.execute_fn.remote(fn, *args, **kwargs)
            for w in self.workers
        ]

    def execute_single(self, rank: int, fn: Callable, *args, **kwargs) -> Any:
        return rt.get(
            self.workers[rank].actor.execute_fn.remote(fn, *args, **kwargs))

    def shutdown(self) -> None:
        for w in self.workers:
            try:
                rt.kill(w.actor)
            except Exception:
                pass
        self.workers = []
        if self._pg is not None and self._owns_pg:
            try:
                remove_placement_group(self._pg)
            except Exception:
                pass
        self._pg = None
