"""Training backends.

Counterpart: ``ray_tpu/train/backend.py``. Analog of
`ray.train.backend.Backend/BackendConfig` plus the torch backend
(`python/ray/train/torch/config.py:150` `_TorchBackend.on_start`, which runs
`dist.init_process_group` on every worker). ``TorchConfig`` takes the place
of the JAX package's ``JaxConfig``: worker 0 picks a coordinator address
(as ``_find_coordinator`` does there) and every worker runs
``torch.distributed.init_process_group`` on it (the twin of
``_init_jax_distributed``) before the user loop runs. The default process
group is process-global: the collectives' ``NcclGroup`` never uses it, so
a loop can hold both.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Optional

logger = logging.getLogger(__name__)


@dataclasses.dataclass
class BackendConfig:
    @property
    def backend_cls(self):
        return Backend


class Backend:
    """Hooks called by the BackendExecutor around the worker group."""

    def on_start(self, worker_group, backend_config: BackendConfig) -> None:
        pass

    def on_training_start(self, worker_group,
                          backend_config: BackendConfig) -> None:
        pass

    def on_shutdown(self, worker_group, backend_config: BackendConfig) -> None:
        pass


# --------------------------------------------------------------- torch


@dataclasses.dataclass
class TorchConfig(BackendConfig):
    """Backend config for data-parallel PyTorch training.

    ``backend``: "nccl" (the workers' cards) or "gloo" (CPU tensors);
    ``None`` picks "nccl" when the workers are leased cards
    (``ScalingConfig(use_gpu=True)``), else "gloo". An "nccl" worker that
    sees no card raises: it never drops to gloo.
    ``distributed``: form the process group. ``None`` (default) turns it
    on when there is more than one worker; ``True`` forces it at world 1.
    ``init_timeout_s`` bounds the rendezvous and each collective of the
    group.
    """

    backend: Optional[str] = None
    distributed: Optional[bool] = None
    init_timeout_s: float = 300.0

    def __post_init__(self):
        if self.backend not in (None, "nccl", "gloo"):
            raise ValueError(
                f"TorchConfig.backend must be 'nccl' or 'gloo', got "
                f"{self.backend!r}")

    @property
    def backend_cls(self):
        return _TorchBackend


def _find_coordinator() -> str:
    """``host:port`` for the process group's store, on worker 0: the host
    its peers reach it at (its runtime RPC address) and a free port."""
    import socket

    from ray_tpu_torch._private.api import _require_core

    host = str(_require_core().address[0])
    s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    s.bind((host, 0))
    port = s.getsockname()[1]
    s.close()
    return f"{host}:{port}"


def _init_torch_distributed(backend: str, coordinator: str, world_size: int,
                            rank: int, timeout_s: float) -> dict:
    import datetime
    import os

    import torch
    import torch.distributed as dist

    if backend == "nccl":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"TorchConfig(backend='nccl'): worker {rank} sees no CUDA "
                f"card (CUDA_VISIBLE_DEVICES="
                f"{os.environ.get('CUDA_VISIBLE_DEVICES')!r}); ask for "
                f"ScalingConfig(use_gpu=True) or backend='gloo'")
        if not dist.is_nccl_available():
            raise RuntimeError(
                "TorchConfig(backend='nccl'): this torch has no NCCL")
        torch.cuda.set_device(0)  # the worker's first visible card
    if not dist.is_initialized():
        dist.init_process_group(
            backend, init_method=f"tcp://{coordinator}",
            world_size=world_size, rank=rank,
            timeout=datetime.timedelta(seconds=timeout_s))
    return {"backend": dist.get_backend(), "rank": dist.get_rank(),
            "world_size": dist.get_world_size()}


def _destroy_torch_distributed() -> bool:
    import torch.distributed as dist

    if dist.is_initialized():
        dist.destroy_process_group()
    return True


class _TorchBackend(Backend):
    def on_start(self, worker_group, backend_config: TorchConfig) -> None:
        import ray_tpu_torch as rt

        n = len(worker_group)
        distributed = backend_config.distributed
        if distributed is None:
            distributed = n > 1
        if not distributed:
            return
        backend = backend_config.backend or (
            "nccl" if worker_group.num_gpus_per_worker > 0 else "gloo")
        coordinator = worker_group.execute_single(0, _find_coordinator)
        logger.info("torch.distributed %s group at %s (%d processes)",
                    backend, coordinator, n)
        # every rank joins at once: rank 0's store waits for the others
        rt.get([
            w.actor.execute_fn.remote(
                _init_torch_distributed, backend, coordinator, n,
                w.world_rank, backend_config.init_timeout_s)
            for w in worker_group.workers
        ], timeout=backend_config.init_timeout_s + 60)

    def on_shutdown(self, worker_group, backend_config: TorchConfig) -> None:
        try:
            worker_group.execute(_destroy_torch_distributed)
        except Exception:
            pass
