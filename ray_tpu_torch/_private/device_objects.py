"""Device objects: CUDA tensors through the object layer without a host
round-trip at put time.

Answer to the reference's compiled-DAG mutable plasma channels
(`python/ray/experimental/channel.py:76`,
`src/ray/core_worker/experimental_mutable_object_manager.h:36`) and to
SURVEY §7 hard part 2, for tensors on one card. The reference moves tensors
between processes by copying them into mutable shared-memory buffers; a
CUDA tensor already lives in device memory, so the object layer *keeps* it
there:

- ``put()`` of a CUDA tensor parks a snapshot of it, taken on the card
  (``snapshot``), in the owner's process-local registry and records only
  metadata (shape, dtype, bytes): device memory stays with the worker,
  nothing is serialized. A torch tensor can be written in place, so the
  registry never holds the caller's own tensor: a write to it after
  ``put`` (or to a task's returned tensor after the return) never
  reaches the object, as on the host path.
- ``get()`` by the owner is a registry lookup that returns a private
  snapshot of the stored tensor: a device-to-device copy, zero host
  traffic, and a write to the result leaves the object intact.
- ``get()`` by another process streams the tensor's host staging buffer in
  bounded chunks and re-materializes it on the reader's current card (or
  on the CPU in a process that sees no card).
- Owner-based GC: when the ref count hits zero the registry entry drops
  and the caching allocator takes the memory back.

A tensor sharded over a mesh (the JAX package's ``NamedSharding`` half) has
no counterpart yet: it comes with the SPMD layer.
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Any, Dict, List, Optional, Tuple

# index key: ((start, stop) per dim) — the global slice a shard covers; a
# single-device tensor has one shard covering the whole shape
IndexKey = Tuple[Tuple[int, int], ...]


def is_device_array(value: Any) -> bool:
    """True for a torch.Tensor on a CUDA device, without importing torch
    for other values (the object layer must stay importable — and fast —
    in processes that never touch a device)."""
    mod = type(value).__module__ or ""
    if not mod.startswith("torch"):
        return False
    import torch

    return isinstance(value, torch.Tensor) and value.is_cuda


def snapshot(t):
    """A private copy of *t* on its own card, complete when this returns:
    what the registry stores at ``put`` (and at a large task return) and
    what the owner's ``get`` hands out. The stream is synchronized because
    remote reads stage the stored tensor from executor threads, which
    order their work on another stream than the caller's."""
    import torch

    out = t.detach().clone()
    if out.is_cuda:
        torch.cuda.current_stream(out.device).synchronize()
    return out


@dataclasses.dataclass
class DeviceArrayMeta:
    """Wire-serializable description of a device tensor's layout."""

    shape: Tuple[int, ...]
    dtype: str  # torch dtype name, e.g. "bfloat16"
    nbytes: int
    # per-shard global-slice indices + byte sizes: one, the whole tensor
    shards: List[Tuple[IndexKey, int]] = dataclasses.field(
        default_factory=list)


def _full_index(shape: Tuple[int, ...]) -> IndexKey:
    return tuple((0, int(d)) for d in shape)


def extract_meta(t) -> DeviceArrayMeta:
    shape = tuple(int(d) for d in t.shape)
    nbytes = t.numel() * t.element_size()
    return DeviceArrayMeta(shape=shape, dtype=str(t.dtype).split(".")[-1],
                           nbytes=nbytes,
                           shards=[(_full_index(shape), nbytes)])


def shard_host_bytes(t, index_key: IndexKey) -> bytes:
    """Host staging buffer for the shard at *index_key*: the whole
    tensor's bytes in row-major order."""
    import torch

    if tuple(index_key) != _full_index(tuple(t.shape)):
        raise KeyError(f"no shard at {index_key}")
    if t.numel() == 0:
        return b""
    flat = t.detach().contiguous().reshape(-1).view(torch.uint8)
    return flat.cpu().numpy().tobytes()


def assemble(meta: DeviceArrayMeta, shard_data: Dict[IndexKey, bytes]):
    """Re-materialize a device tensor from its host buffer, on this
    process's current CUDA device, or on the CPU where no card is
    visible (as ``jax.device_put`` uses the default device)."""
    import torch

    dtype = getattr(torch, meta.dtype)
    (key, _), = meta.shards
    data = shard_data[key]
    on_card = torch.cuda.is_available()
    if not data:
        flat = torch.empty(0, dtype=torch.uint8)
    elif on_card:
        # the host tensor is only read by the copy to the card, so it may
        # alias the immutable buffer
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", UserWarning)
            flat = torch.frombuffer(data, dtype=torch.uint8)
    else:
        flat = torch.frombuffer(bytearray(data), dtype=torch.uint8)
    t = flat.view(dtype).reshape(meta.shape)
    if on_card:
        t = t.to(torch.device("cuda", torch.cuda.current_device()))
    return t


class DeviceObjectRegistry:
    """Holder-side device-memory registry: oid -> live CUDA tensor (+ a
    tiny host staging cache for in-flight remote reads, so a multi-chunk
    transfer copies device->host once, not once per chunk).

    ``read`` runs on executor threads while ``put``/``drop`` run on the
    event loop — every mutation holds the lock."""

    _STAGE_CACHE = 2

    def __init__(self):
        import threading

        self._lock = threading.Lock()
        self._arrays: Dict[Any, Any] = {}
        self._meta: Dict[Any, DeviceArrayMeta] = {}
        self._stage: "Dict[Tuple[Any, IndexKey], bytes]" = {}

    def put(self, oid, arr) -> DeviceArrayMeta:
        meta = extract_meta(arr)
        with self._lock:
            self._arrays[oid] = arr
            self._meta[oid] = meta
        return meta

    def get(self, oid):
        with self._lock:
            return self._arrays.get(oid)

    def meta(self, oid) -> Optional[DeviceArrayMeta]:
        with self._lock:
            return self._meta.get(oid)

    def read(self, oid, index_key: IndexKey, offset: int,
             length: int) -> bytes:
        cache_key = (oid, index_key)
        with self._lock:
            buf = self._stage.get(cache_key)
            arr = self._arrays.get(oid)
        if buf is None:
            if arr is None:
                raise KeyError(f"device object {oid!r} released")
            # device->host staging outside the lock (can be many MB)
            buf = shard_host_bytes(arr, index_key)
            with self._lock:
                while len(self._stage) >= self._STAGE_CACHE:
                    self._stage.pop(next(iter(self._stage)), None)
                self._stage[cache_key] = buf
        chunk = buf[offset:offset + length]
        if offset + length >= len(buf):  # last chunk: staging done
            with self._lock:
                self._stage.pop(cache_key, None)
        return chunk

    def drop(self, oid) -> bool:
        """GC: releasing the registry reference frees the device memory."""
        with self._lock:
            self._meta.pop(oid, None)
            for k in [k for k in self._stage if k[0] == oid]:
                self._stage.pop(k, None)
            return self._arrays.pop(oid, None) is not None

    def __len__(self) -> int:
        with self._lock:
            return len(self._arrays)
