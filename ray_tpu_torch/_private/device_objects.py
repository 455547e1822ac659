"""Device objects: tensors on a card, and DTensors on a mesh, through the
object layer without a host round-trip at put time.

Answer to the reference's compiled-DAG mutable plasma channels
(`python/ray/experimental/channel.py:76`,
`src/ray/core_worker/experimental_mutable_object_manager.h:36`) and to
SURVEY §7 hard part 2. The reference moves tensors between processes by
copying them into mutable shared-memory buffers; a CUDA tensor already
lives in device memory, and a DTensor's shards already live with its
ranks, so the object layer *keeps* them there:

- ``put()`` of a CUDA tensor parks a snapshot of it, taken on the card
  (``snapshot``), in the owner's process-local registry and records only
  metadata (shape, dtype, bytes, one whole-tensor shard): device memory
  stays with the worker, nothing is serialized. A torch tensor can be
  written in place, so the registry never holds the caller's own tensor:
  a write to it after ``put`` (or to a task's returned tensor after the
  return) never reaches the object, as on the host path.
- ``put()`` of a DTensor (on the card or on the CPU) is collective: every
  rank of its mesh calls it, as every rank calls every DTensor op. Each
  rank parks a snapshot of its own local shard in its own registry; the
  mesh's coordinate-0 rank owns the object and counts the other ranks as
  borrowers. The metadata records the layout as JAX's ``NamedSharding``
  does (mesh axes and partition spec, ``sharded_meta``), plus, per
  distinct shard of the global tensor, the mesh coordinate that serves it
  (the lowest that holds it).
- ``get()`` by the owner, or by any rank that holds a shard, is a registry
  lookup that returns a private snapshot of what it holds (a DTensor over
  the same mesh for a sharded object): a copy in device memory, zero host
  traffic, no collective, and a write to the result leaves the object
  intact.
- ``get()`` by another process streams each shard it needs from its
  holder in bounded chunks and re-materializes the tensor (``assemble``).
  In a ``torch.distributed`` world whose size is the recorded mesh's, it
  needs only its own coordinate's shard and returns a DTensor with the
  same logical sharding over an equivalent mesh (built once, by every rank
  of that world: the get is collective there); anywhere else it returns
  the whole tensor on the current card, or on the CPU in a process that
  sees none.
- Owner-based GC: when the ref count hits zero every holder drops its
  registry entry and the memory goes back to the allocator.
"""

from __future__ import annotations

import dataclasses
import math
import threading
import warnings
from typing import Any, Dict, List, Optional, Tuple

# index key: ((start, stop) per dim) — the global slice a shard covers; a
# single-device tensor has one shard covering the whole shape
IndexKey = Tuple[Tuple[int, int], ...]


def is_sharded(value: Any) -> bool:
    """True for a DTensor, without importing torch for other values."""
    mod = type(value).__module__ or ""
    if not mod.startswith("torch"):
        return False
    from torch.distributed.tensor import DTensor

    return isinstance(value, DTensor)


def is_device_array(value: Any) -> bool:
    """True for a DTensor on any device (its layout is the point, as JAX's
    is true for a CPU-backed ``jax.Array``) and for a plain torch.Tensor on
    a CUDA device, without importing torch for other values (the object
    layer must stay importable — and fast — in processes that never touch
    a device)."""
    mod = type(value).__module__ or ""
    if not mod.startswith("torch"):
        return False
    import torch

    return isinstance(value, torch.Tensor) and (value.is_cuda
                                                or is_sharded(value))


def snapshot(t):
    """A private copy of *t* on its own device (for a DTensor, of its local
    shard, over the same mesh), complete when this returns: what the
    registry stores at ``put`` (and at a large task return) and what a
    holder's ``get`` hands out. The stream is synchronized because remote
    reads stage the stored tensor from executor threads, which order their
    work on another stream than the caller's."""
    import torch

    if is_sharded(t):
        from torch.distributed.tensor import DTensor

        local = snapshot(t.to_local())
        return DTensor.from_local(local, t.device_mesh, t.placements,
                                  run_check=False, shape=t.shape,
                                  stride=t.stride())
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
    # mesh axes as ((name, size), ...) — None for a tensor on one device
    mesh_axes: Optional[Tuple[Tuple[str, int], ...]] = None
    # partition spec entries: None, axis name, or tuple of axis names
    pspec: Optional[Tuple[Any, ...]] = None
    # the device type of the mesh the object was put from ("cuda", "cpu")
    device_type: str = "cuda"
    # per-shard global-slice indices + byte sizes, one per distinct shard
    shards: List[Tuple[IndexKey, int]] = dataclasses.field(
        default_factory=list)
    # shard i's holder: the flat mesh coordinate that serves it (the
    # lowest that holds it); empty means every shard is at coordinate 0
    holders: List[int] = dataclasses.field(default_factory=list)

    def holder_of(self, i: int) -> int:
        return self.holders[i] if self.holders else 0


def _full_index(shape: Tuple[int, ...]) -> IndexKey:
    return tuple((0, int(d)) for d in shape)


def _dtype_name(dtype) -> str:
    return str(dtype).split(".")[-1]


def _itemsize(dtype: str) -> int:
    import torch

    return torch.empty((), dtype=getattr(torch, dtype)).element_size()


def _shard_size_and_offset(size: int, n: int, i: int) -> Tuple[int, int]:
    """Chunk ``i`` of ``n`` of a dim of ``size``, as ``torch.chunk`` (and
    DTensor's ``Shard``) cut it: (its size, its offset in the dim)."""
    if size % n == 0:
        return size // n, size // n * i
    full = -(-size // n)
    start = full * i
    return max(0, min(size, start + full) - start), min(size, start)


def coordinate_key(shape, sizes, coord, placements) -> IndexKey:
    """The global slice that mesh coordinate ``coord`` holds of a tensor of
    ``shape`` with ``placements`` over a mesh of ``sizes``: the computation
    of ``torch.distributed.tensor._utils.compute_local_shape_and_global_
    offset``, mesh dims left to right, each ``Shard`` cutting what the
    dims before it left (an empty shard sits at the end of its dim), with
    no process group."""
    from torch.distributed.tensor import Shard

    local = [int(d) for d in shape]
    offset = [0] * len(local)
    for mesh_dim, p in enumerate(placements):
        if not isinstance(p, Shard):
            continue
        d = p.dim
        size, off = _shard_size_and_offset(local[d], sizes[mesh_dim],
                                           coord[mesh_dim])
        local[d] = size
        offset[d] = int(shape[d]) if size == 0 else offset[d] + off
    return tuple((o, o + n) for o, n in zip(offset, local))


def _coords(sizes):
    """Every mesh coordinate in row-major order (flat index order)."""
    out = [()]
    for s in sizes:
        out = [c + (i,) for c in out for i in range(s)]
    return out


def _placements(meta: DeviceArrayMeta):
    from ray_tpu_torch.parallel.mesh import MeshSpec
    from ray_tpu_torch.parallel.sharding import spec_to_placements

    return spec_to_placements(meta.pspec or (), MeshSpec(meta.mesh_axes))


def sharded_meta(global_shape, dtype, mesh_axes, placements,
                 device_type: str = "cuda") -> DeviceArrayMeta:
    """The metadata of a tensor of ``global_shape`` and ``dtype`` laid out
    with ``placements`` over a mesh of ``mesh_axes`` ((name, size), ...),
    without any communication: every distinct shard's slice and bytes, and
    the lowest mesh coordinate that holds it."""
    from ray_tpu_torch.parallel.mesh import MeshSpec
    from ray_tpu_torch.parallel.sharding import placements_to_spec

    shape = tuple(int(d) for d in global_shape)
    dtype = _dtype_name(dtype)
    axes = tuple((str(n), int(s)) for n, s in mesh_axes)
    sizes = tuple(s for _, s in axes)
    pspec = placements_to_spec(placements, MeshSpec(axes))
    item = _itemsize(dtype)
    seen: Dict[IndexKey, int] = {}
    for flat, coord in enumerate(_coords(sizes)):
        key = coordinate_key(shape, sizes, coord, placements)
        seen.setdefault(key, flat)
    return DeviceArrayMeta(
        shape=shape, dtype=dtype, nbytes=math.prod(shape) * item,
        mesh_axes=axes, pspec=pspec, device_type=device_type,
        shards=[(key, math.prod(b - a for a, b in key) * item)
                for key in seen],
        holders=list(seen.values()))


def extract_meta(t) -> DeviceArrayMeta:
    if is_sharded(t):
        from ray_tpu_torch.parallel.mesh import mesh_axes

        names, sizes = mesh_axes(t.device_mesh)
        return sharded_meta(t.shape, t.dtype, tuple(zip(names, sizes)),
                            t.placements, t.device_mesh.device_type)
    shape = tuple(int(d) for d in t.shape)
    nbytes = t.numel() * t.element_size()
    return DeviceArrayMeta(shape=shape, dtype=_dtype_name(t.dtype),
                           nbytes=nbytes, device_type=t.device.type,
                           shards=[(_full_index(shape), nbytes)])


def local_key(t) -> IndexKey:
    """The global slice this process holds of ``t``: its local shard's for
    a DTensor (its own mesh coordinate), the whole shape otherwise."""
    if not is_sharded(t):
        return _full_index(tuple(t.shape))
    mesh = t.device_mesh
    return coordinate_key(t.shape, tuple(mesh.mesh.shape),
                          tuple(mesh.get_coordinate()), t.placements)


def shard_host_bytes(t, index_key: IndexKey) -> bytes:
    """Host staging buffer for the shard at *index_key* in row-major order:
    the whole tensor's, or a DTensor's local shard (read where it lives:
    never a collective)."""
    import torch

    if tuple(index_key) != local_key(t):
        raise KeyError(f"no shard at {index_key}")
    if is_sharded(t):
        t = t.to_local()
    if t.numel() == 0:
        return b""
    flat = t.detach().contiguous().reshape(-1).view(torch.uint8)
    return flat.cpu().numpy().tobytes()


def mesh_group(mesh):
    """The process group over every rank of ``mesh``, for the put's object
    collectives: the default group where the mesh covers the whole world,
    the mesh's own group where it has one dim. A sub-mesh of several dims
    has no group of its own without a collective over the whole world."""
    import torch.distributed as dist

    if mesh.mesh.numel() == dist.get_world_size():
        return None
    if mesh.ndim == 1:
        return mesh.get_group()
    raise ValueError(
        f"put of a DTensor on a {mesh.ndim}-dim sub-mesh of the world "
        f"({mesh.mesh.numel()} of {dist.get_world_size()} ranks): put it "
        f"from a mesh over the whole world, or a 1-dim one")


# ---------------------------------------------------------------- assembly

_mesh_lock = threading.Lock()
_meshes: Dict[Any, Any] = {}


def _world_coordinate(meta: DeviceArrayMeta) -> Optional[Tuple[int, ...]]:
    """This process's coordinate in an equivalent mesh: where it is a rank
    of a ``torch.distributed`` default group as large as the recorded
    mesh (rank r at the row-major coordinate of r), else None."""
    if not meta.mesh_axes:
        return None
    try:
        import torch.distributed as dist
    except Exception:
        return None
    if not (dist.is_available() and dist.is_initialized()):
        return None
    sizes = tuple(s for _, s in meta.mesh_axes)
    if dist.get_world_size() != math.prod(sizes):
        return None
    return _coords(sizes)[dist.get_rank()]


def needed_shards(meta: DeviceArrayMeta) -> List[int]:
    """Which of ``meta.shards`` this process must read to assemble the
    object: its own coordinate's where it has an equivalent mesh, else
    all of them."""
    coord = _world_coordinate(meta)
    if coord is None:
        return list(range(len(meta.shards)))
    sizes = tuple(s for _, s in meta.mesh_axes)
    key = coordinate_key(meta.shape, sizes, coord, _placements(meta))
    return [next(i for i, (k, _) in enumerate(meta.shards)
                 if tuple(map(tuple, k)) == key)]


def _local_device(device_type: str):
    import torch

    if device_type == "cuda" and torch.cuda.is_available():
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def _equivalent_local_mesh(meta: DeviceArrayMeta):
    """A ``DeviceMesh`` with the recorded axis names and sizes over every
    rank of this process's default group, built once per group and layout
    (its sub-groups are made by every rank, so the first get of such an
    object is collective). Its device type is the group's: ``cuda`` under
    NCCL, ``cpu`` otherwise."""
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    backend = str(dist.get_backend())
    device_type = ("cuda" if "nccl" in backend and torch.cuda.is_available()
                   else "cpu")
    sizes = tuple(s for _, s in meta.mesh_axes)
    names = tuple(n for n, _ in meta.mesh_axes)
    key = (device_type, names, sizes)
    with _mesh_lock:
        if _meshes.get("world") is not dist.group.WORLD:
            # a new default group: the meshes of the last one are gone
            _meshes.clear()
            _meshes["world"] = dist.group.WORLD
        mesh = _meshes.get(key)
        if mesh is None:
            ranks = torch.arange(math.prod(sizes)).reshape(sizes)
            mesh = _meshes[key] = DeviceMesh(device_type, ranks,
                                             mesh_dim_names=names)
    return mesh


def _host_tensor(data: bytes, dtype: str, shape, device):
    import torch

    if not data:
        flat = torch.empty(0, dtype=torch.uint8)
    elif device.type == "cuda":
        # the host tensor is only read by the copy to the card, so it may
        # alias the immutable buffer
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", UserWarning)
            flat = torch.frombuffer(data, dtype=torch.uint8)
    else:
        flat = torch.frombuffer(bytearray(data), dtype=torch.uint8)
    return flat.view(getattr(torch, dtype)).reshape(shape).to(device)


def assemble(meta: DeviceArrayMeta, shard_data: Dict[IndexKey, bytes]):
    """Re-materialize a device object from its shards' host buffers (those
    ``needed_shards`` named). With an equivalent mesh it comes back as a
    DTensor with the SAME logical sharding (axis names, sizes, partition
    spec) over this process's world; otherwise as the whole tensor on this
    process's current card, or on the CPU where no card is visible (as
    ``jax.device_put`` uses the default device)."""
    import torch

    def shard(key, device):
        shape = tuple(b - a for a, b in key)
        return _host_tensor(shard_data[key], meta.dtype, shape, device)

    coord = _world_coordinate(meta)
    if coord is not None:
        from torch.distributed.tensor import DTensor

        mesh = _equivalent_local_mesh(meta)
        (i,) = needed_shards(meta)
        key = tuple(map(tuple, meta.shards[i][0]))
        local = shard(key, _local_device(mesh.device_type))
        stride = torch.empty(meta.shape, device="meta").stride()
        return DTensor.from_local(local, mesh, _placements(meta),
                                  run_check=False,
                                  shape=torch.Size(meta.shape), stride=stride)
    device = _local_device("cuda")
    keys = [tuple(map(tuple, k)) for k, _ in meta.shards]
    if len(keys) == 1 and keys[0] == _full_index(meta.shape):
        return shard(keys[0], device)
    # the recorded shards must tile the whole global shape (DTensor's
    # shards partition it, so element counts suffice): a partial set must
    # fail loudly, never return torch.empty() garbage
    covered = sum(math.prod(b - a for a, b in k) for k in keys)
    total = math.prod(meta.shape)
    if covered != total:
        raise ValueError(
            f"device object shards cover {covered}/{total} elements — "
            "the sender did not record the full tensor")
    out = torch.empty(meta.shape, dtype=getattr(torch, meta.dtype),
                      device=device)
    for key in keys:
        out[tuple(slice(a, b) for a, b in key)] = shard(key, device)
    return out


class DeviceObjectRegistry:
    """Holder-side device-memory registry: oid -> live tensor or DTensor
    (+ a tiny host staging cache for in-flight remote reads, so a
    multi-chunk transfer copies device->host once, not once per chunk).
    ``reads`` counts the chunks served.

    ``read`` runs on executor threads while ``put``/``drop`` run on the
    event loop or the caller's thread — every mutation holds the lock."""

    _STAGE_CACHE = 2

    def __init__(self):
        self._lock = threading.Lock()
        self._arrays: Dict[Any, Any] = {}
        self._meta: Dict[Any, DeviceArrayMeta] = {}
        self._stage: "Dict[Tuple[Any, IndexKey], bytes]" = {}
        self.reads = 0

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
            self.reads += 1
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
