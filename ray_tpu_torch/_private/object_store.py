"""Node-local shared-memory object store.

Analog of the reference's plasma store
(`src/ray/object_manager/plasma/store.h`, allocator `plasma_allocator.h` /
`dlmalloc.cc`, lifecycle `object_lifecycle_manager.h`): one immutable-object
arena per host, shared between the supervisor and every worker/driver process
on that host.

Design:
  * Backing is a single sparse file in /dev/shm, mmapped by every process that
    touches objects (`ArenaFile`). One mapping per process for its lifetime —
    no per-object mmap churn, no resource-tracker interference.
  * The supervisor owns allocation metadata (`NodeObjectStore`): a first-fit
    free-list allocator with coalescing (stand-in for the dlmalloc arena; the
    C++ allocator in src/ replaces it without changing the protocol).
  * Clients create (RPC → offset), write payload bytes directly into the
    mapping, then seal. Reads locate (RPC → offset,size, pin=True) and
    deserialize ZERO-COPY: out-of-band payload buffers become read-only
    views over the reader's own mapping, and the pin — tracked per client
    so a crashed reader's pins can be reclaimed — protects the range from
    spill/free until the last view is garbage-collected
    (≈ plasma's get/release pinning; see core_worker._read_shared).
  * Spilling under memory pressure moves sealed, unreferenced objects to disk
    (analog of `external_storage.py:185`), restored on demand.

Host RAM only: CUDA tensors put into the object layer never transit this
store — they stay on their card inside the owning process
(``device_objects``).
"""

from __future__ import annotations

import dataclasses
import mmap
import os
import time
from typing import Dict, List, Optional, Tuple

from ray_tpu_torch._private.ids import ObjectID

PAGE = 4096


def _align(n: int) -> int:
    return (n + PAGE - 1) // PAGE * PAGE


class ArenaFile:
    """A process-local mmap of the node's object arena."""

    def __init__(self, path: str, size: int, create: bool = False):
        self.path = path
        self.size = size
        flags = os.O_RDWR | (os.O_CREAT if create else 0)
        fd = os.open(path, flags, 0o600)
        try:
            if create:
                os.ftruncate(fd, size)
            self._mm = mmap.mmap(fd, size)
        finally:
            os.close(fd)

    def view(self, offset: int, length: int) -> memoryview:
        return memoryview(self._mm)[offset : offset + length]

    def write(self, offset: int, data) -> None:
        self._mm[offset : offset + len(data)] = data

    def close(self) -> None:
        try:
            self._mm.close()
        except Exception:
            pass

    def unlink(self) -> None:
        self.close()
        try:
            os.unlink(self.path)
        except OSError:
            pass


class OutOfMemoryError(Exception):
    pass


class _NativeFreeList:
    """ctypes binding of the C++ arena allocator (_native/allocator.cpp):
    O(log n) coalescing plus double-free/overlap validation. Selected by
    make_free_list() when the native lib builds; same surface as
    _FreeList."""

    def __init__(self, capacity: int, lib):
        import ctypes

        self.capacity = capacity
        self._lib = lib
        lib.rtpu_alloc_create.restype = ctypes.c_void_p
        lib.rtpu_alloc_create.argtypes = [ctypes.c_uint64, ctypes.c_uint64]
        lib.rtpu_alloc_alloc.restype = ctypes.c_int64
        lib.rtpu_alloc_alloc.argtypes = [ctypes.c_void_p, ctypes.c_uint64]
        lib.rtpu_alloc_free.restype = ctypes.c_int
        lib.rtpu_alloc_free.argtypes = [
            ctypes.c_void_p, ctypes.c_uint64, ctypes.c_uint64]
        lib.rtpu_alloc_free_bytes.restype = ctypes.c_uint64
        lib.rtpu_alloc_free_bytes.argtypes = [ctypes.c_void_p]
        lib.rtpu_alloc_destroy.argtypes = [ctypes.c_void_p]
        self._handle = lib.rtpu_alloc_create(capacity, PAGE)
        if not self._handle:
            raise MemoryError("native allocator init failed")

    def alloc(self, size: int) -> Optional[int]:
        off = self._lib.rtpu_alloc_alloc(self._handle, size)
        return None if off < 0 else off

    def free(self, offset: int, size: int) -> None:
        rc = self._lib.rtpu_alloc_free(self._handle, offset, size)
        if rc == -2:
            raise ValueError(
                f"double/overlapping free at offset={offset} size={size}")
        if rc != 0:
            raise ValueError(f"invalid free offset={offset} size={size}")

    def free_bytes(self) -> int:
        return self._lib.rtpu_alloc_free_bytes(self._handle)

    def __del__(self):
        try:
            self._lib.rtpu_alloc_destroy(self._handle)
        except Exception:
            pass


def make_free_list(capacity: int):
    """Native allocator when the toolchain allows, Python otherwise."""
    if os.environ.get("RAY_TPU_TORCH_DISABLE_NATIVE", "") not in ("1", "true"):
        try:
            from ray_tpu_torch._native import load_library

            lib = load_library("allocator")
            if lib is not None:
                return _NativeFreeList(capacity, lib)
        except Exception:
            import logging

            logging.getLogger(__name__).warning(
                "native allocator unavailable; using the Python free "
                "list (no double-free detection)", exc_info=True)
    return _FreeList(capacity)


class _FreeList:
    """First-fit free-list allocator over [0, capacity) with coalescing.
    Pure-Python fallback for make_free_list()."""

    def __init__(self, capacity: int):
        self.capacity = capacity
        # sorted list of (offset, size) free ranges
        self._free: List[Tuple[int, int]] = [(0, capacity)]

    def alloc(self, size: int) -> Optional[int]:
        size = _align(size)
        for i, (off, sz) in enumerate(self._free):
            if sz >= size:
                if sz == size:
                    self._free.pop(i)
                else:
                    self._free[i] = (off + size, sz - size)
                return off
        return None

    def free(self, offset: int, size: int) -> None:
        size = _align(size)
        # insert sorted, coalesce neighbors
        lo, hi = 0, len(self._free)
        while lo < hi:
            mid = (lo + hi) // 2
            if self._free[mid][0] < offset:
                lo = mid + 1
            else:
                hi = mid
        self._free.insert(lo, (offset, size))
        merged: List[Tuple[int, int]] = []
        for off, sz in self._free:
            if merged and merged[-1][0] + merged[-1][1] == off:
                merged[-1] = (merged[-1][0], merged[-1][1] + sz)
            else:
                merged.append((off, sz))
        self._free = merged

    def free_bytes(self) -> int:
        return sum(sz for _, sz in self._free)


IN_MEMORY = "IN_MEMORY"
SPILLED = "SPILLED"
CREATING = "CREATING"


@dataclasses.dataclass
class ObjectMeta:
    object_id: ObjectID
    size: int
    state: str = CREATING
    offset: int = -1
    spill_path: str = ""
    last_access: float = 0.0
    freed: bool = False  # owner released it; eligible for deletion
    pins: int = 0  # readers holding views over the arena; blocks spill/free
    # pin counts per client id (worker/driver/puller) so the pins of a
    # crashed client can be released instead of blocking spill forever
    pin_clients: Dict[str, int] = dataclasses.field(default_factory=dict)


class NodeObjectStore:
    """Supervisor-side object index + allocator (single-threaded: runs on the
    supervisor's event loop)."""

    def __init__(self, arena_path: str, capacity: int, spill_dir: str,
                 spill_storage=None):
        self.capacity = capacity
        self.arena = ArenaFile(arena_path, capacity, create=True)
        self._alloc = make_free_list(capacity)
        self._objects: Dict[ObjectID, ObjectMeta] = {}
        if spill_storage is None:
            from ray_tpu_torch._private.external_storage import FileSystemStorage

            spill_storage = FileSystemStorage(spill_dir)
        # pluggable spill target (≈ external_storage.py:496): local dir by
        # default, mock:// fake remote in tests, s3:// in deployments
        self.spill_storage = spill_storage
        self.num_spilled = 0
        self.num_restored = 0
        # reverse index: pin key -> object ids it currently pins (release
        # path for dead clients; see release_client_pins). Keys are the
        # client id suffixed with its incarnation epoch (plain id at
        # epoch 0): reusable client ids ("node:<hex>") bump their epoch
        # when a released client comes back, so a DELAYED bulk release
        # scheduled for the old incarnation can never reclaim pins the
        # new incarnation just took
        self._client_pins: Dict[str, set] = {}
        self._client_epoch: Dict[str, int] = {}

    # ---- creation ----

    def create(self, object_id: ObjectID, size: int) -> int:
        """Reserve space; returns arena offset. Spills/evicts under pressure."""
        if object_id in self._objects:
            meta = self._objects[object_id]
            if meta.state != CREATING:
                raise ValueError(f"object {object_id.hex()} already exists")
            return meta.offset
        offset = self._alloc_with_spill(size)
        if offset is None:
            raise OutOfMemoryError(
                f"object store full: need {size}, free {self._alloc.free_bytes()}"
            )
        self._objects[object_id] = ObjectMeta(
            object_id, size, CREATING, offset, last_access=time.monotonic()
        )
        return offset

    def create_channel(self, object_id: ObjectID, size: int,
                       client: str) -> int:
        """Allocate a compiled-graph channel range: create + seal + pin in
        ONE store op, so there is no window in which the freshly sealed
        range could be spilled (which would move its offset) before the
        pin lands. The pin is attributed to ``client`` (the compiling
        driver) exactly like a zero-copy read pin — release_client_pins
        reclaims it if the driver dies, and the channel object itself is
        freed through the normal deferred-free path once every
        participant's pin is gone."""
        offset = self.create(object_id, size)
        meta = self._objects[object_id]
        meta.state = IN_MEMORY
        meta.pins += 1
        key = self._pin_key(client)
        meta.pin_clients[key] = meta.pin_clients.get(key, 0) + 1
        self._client_pins.setdefault(key, set()).add(object_id)
        meta.last_access = time.monotonic()
        return offset

    # ---- incarnation-keyed pin accounting ----

    def _pin_key(self, client: str) -> str:
        """Effective accounting key for ``client``'s CURRENT incarnation
        (plain id at epoch 0 — the common never-bumped case)."""
        e = self._client_epoch.get(client, 0)
        return client if e == 0 else f"{client}#e{e}"

    @staticmethod
    def _pin_key_client(key: str) -> str:
        return key.rsplit("#e", 1)[0] if "#e" in key else key

    @staticmethod
    def _pin_key_epoch(key: str) -> int:
        if "#e" in key:
            tail = key.rsplit("#e", 1)[1]
            if tail.isdigit():
                return int(tail)
        return 0

    def client_epoch(self, client: str) -> int:
        return self._client_epoch.get(client, 0)

    def bump_client_epoch(self, client: str) -> int:
        """A previously-released client id is back (node flap, same
        ``node:<hex>`` id): start a fresh incarnation so its new pins are
        keyed apart from any still-pending bulk release of the old one."""
        e = self._client_epoch.get(client, 0) + 1
        self._client_epoch[client] = e
        return e

    def seal(self, object_id: ObjectID) -> None:
        meta = self._objects.get(object_id)
        if meta is None:
            raise KeyError(f"seal of unknown object {object_id.hex()}")
        meta.state = IN_MEMORY
        meta.last_access = time.monotonic()

    def abort(self, object_id: ObjectID) -> None:
        meta = self._objects.pop(object_id, None)
        if meta is not None and meta.offset >= 0:
            self._alloc.free(meta.offset, meta.size)

    # ---- reads ----

    def contains(self, object_id: ObjectID) -> bool:
        m = self._objects.get(object_id)
        return m is not None and m.state in (IN_MEMORY, SPILLED)

    def locate(self, object_id: ObjectID, pin: bool = False,
               client: str = "") -> Optional[Tuple[int, int]]:
        """Return (offset, size), restoring from spill if needed.

        With pin=True the range is protected from spill/free until unpin() —
        readers deserialize zero-copy views over their own mmap after the
        RPC returns, so the range must not be recycled while any view is
        alive (≈ plasma's get/release pinning). Pins are attributed to
        ``client`` so release_client_pins() can reclaim the pins of a
        crashed reader.
        """
        meta = self._objects.get(object_id)
        if meta is None or meta.state == CREATING:
            return None
        if meta.state == SPILLED:
            self._restore(meta)
        meta.last_access = time.monotonic()
        if pin:
            meta.pins += 1
            key = self._pin_key(client)
            meta.pin_clients[key] = meta.pin_clients.get(key, 0) + 1
            self._client_pins.setdefault(key, set()).add(object_id)
        return (meta.offset, meta.size)

    def pinned_clients(self) -> List[str]:
        """Client ids currently holding pins (liveness-sweep input) —
        raw ids, every incarnation folded together."""
        return sorted({self._pin_key_client(k) for k in self._client_pins})

    def unpin(self, object_id: ObjectID, client: str = "") -> bool:
        """Release one pin held by ``client``. An unpin with no matching
        pin is a protocol bug (double-unpin, or unpin of a never-pinned
        object) and raises — bulk reclamation for dead/departing clients
        goes through release_client_pins() instead."""
        meta = self._objects.get(object_id)
        key = None
        if meta is not None:
            # current incarnation first; a pin taken under an older
            # epoch (owner outlived a flap-back bump) still matches
            cur = self._pin_key(client)
            if meta.pin_clients.get(cur, 0) > 0:
                key = cur
            else:
                for k in meta.pin_clients:
                    if (self._pin_key_client(k) == client
                            and meta.pin_clients[k] > 0):
                        key = k
                        break
        if meta is None or meta.pins <= 0 or key is None:
            raise ValueError(
                f"unpin without matching pin: object="
                f"{object_id.hex()[:16]} client={client!r} "
                f"(double-unpin or unpin of a never-pinned object)")
        meta.pins -= 1
        remaining = meta.pin_clients[key] - 1
        if remaining > 0:
            meta.pin_clients[key] = remaining
        else:
            del meta.pin_clients[key]
            held = self._client_pins.get(key)
            if held is not None:
                held.discard(object_id)
                if not held:
                    self._client_pins.pop(key, None)
        if meta.freed and meta.pins == 0:
            self.free(object_id)
        return True

    def release_client_pins(self, client: str,
                            before_epoch: Optional[int] = None) -> int:
        """Drop every pin held by ``client`` (it died without unpinning).
        Returns the number of pins released; deferred frees fire for
        objects whose last pin this was.

        ``before_epoch`` bounds the release to incarnations BELOW that
        epoch: the dead-client sweep captures ``client_epoch() + 1`` when
        the death is observed, so a release that runs late — after the
        same client id re-registered and was epoch-bumped — reclaims
        only the dead incarnation's pins, never the pins the new
        incarnation just took. ``None`` releases every incarnation (the
        graceful departing-client path)."""
        released = 0
        keys = [k for k in self._client_pins
                if self._pin_key_client(k) == client
                and (before_epoch is None
                     or self._pin_key_epoch(k) < before_epoch)]
        for key in keys:
            for object_id in self._client_pins.pop(key, set()):
                meta = self._objects.get(object_id)
                if meta is None:
                    continue
                count = meta.pin_clients.pop(key, 0)
                meta.pins = max(0, meta.pins - count)
                released += count
                if meta.freed and meta.pins == 0:
                    self.free(object_id)
        return released

    def read_chunk(self, object_id: ObjectID, offset: int, length: int) -> bytes:
        loc = self.locate(object_id)
        if loc is None:
            raise KeyError(f"object {object_id.hex()} not in store")
        base, size = loc
        length = min(length, size - offset)
        return bytes(self.arena.view(base + offset, length))

    # ---- lifecycle ----

    def free(self, object_id: ObjectID) -> None:
        """Owner released the object: delete its data (deferred while pinned)."""
        meta = self._objects.get(object_id)
        if meta is None:
            return
        if meta.pins > 0:
            meta.freed = True
            return
        self._objects.pop(object_id, None)
        if meta.state == SPILLED and meta.spill_path:
            self.spill_storage.delete(meta.spill_path)
        elif meta.offset >= 0:
            self._alloc.free(meta.offset, meta.size)

    def _alloc_with_spill(self, need: int) -> Optional[int]:
        """Allocate `need` bytes, spilling least-recently-used sealed
        objects as required. Retries the allocation as objects spill:
        total free bytes are NOT enough — the allocator needs one
        CONTIGUOUS range, and a GiB-class restore into an arena dotted
        with small live objects only succeeds once the spills have
        coalesced a large-enough hole (the fragmentation case the old
        free_bytes()-threshold check missed)."""
        offset = self._alloc.alloc(need)
        if offset is not None:
            return offset
        candidates = sorted(
            (
                m
                for m in self._objects.values()
                if m.state == IN_MEMORY and m.pins == 0
            ),
            key=lambda m: m.last_access,
        )
        aligned = _align(need)
        for meta in candidates:
            self._spill(meta)
            if self._alloc.free_bytes() >= aligned:
                offset = self._alloc.alloc(need)
                if offset is not None:
                    return offset
        return self._alloc.alloc(need)

    def _spill(self, meta: ObjectMeta) -> None:
        # pass the arena view straight through (bytes-like): spilling
        # fires under memory pressure, so a full bytes copy of a multi-GB
        # object here would double transient memory at the worst moment
        uri = self.spill_storage.put(
            meta.object_id.hex(), self.arena.view(meta.offset, meta.size))
        self._alloc.free(meta.offset, meta.size)
        meta.offset = -1
        meta.spill_path = uri  # opaque backend URI, not a local path
        meta.state = SPILLED
        self.num_spilled += 1

    def _restore(self, meta: ObjectMeta) -> None:
        offset = self._alloc_with_spill(meta.size)
        if offset is None:
            raise OutOfMemoryError("cannot restore spilled object: store full")
        self.arena.write(offset, self.spill_storage.get(meta.spill_path))
        self.spill_storage.delete(meta.spill_path)
        meta.offset = offset
        meta.spill_path = ""
        meta.state = IN_MEMORY
        self.num_restored += 1

    def stats(self) -> Dict[str, float]:
        # snapshot first: stats() is read from metric/sync paths off the
        # store thread; iterating the live dict would race its mutations
        metas = list(self._objects.values())
        in_mem = sum(1 for m in metas if m.state == IN_MEMORY)
        spilled = sum(1 for m in metas if m.state == SPILLED)
        return {
            "capacity": self.capacity,
            "free_bytes": self._alloc.free_bytes(),
            "num_objects": len(self._objects),
            "num_in_memory": in_mem,
            "num_spilled_now": spilled,
            "total_spills": self.num_spilled,
            "total_restores": self.num_restored,
            "pinned_objects": sum(1 for m in metas if m.pins > 0),
            "pins_total": sum(m.pins for m in metas),
            # 1: the C++ free list (_native/allocator.cpp), 0: the Python one
            "native_allocator": float(isinstance(self._alloc,
                                                 _NativeFreeList)),
        }

    def shutdown(self) -> None:
        self.arena.unlink()


class InProcessStore:
    """Per-CoreWorker store for small objects and pending futures.

    Analog of the reference's in-process memory store
    (`core_worker/store_provider/memory_store/`): small task returns and puts
    live here in the owner process; remote readers fetch them from the owner
    over RPC.
    """

    def __init__(self):
        self._values: Dict[ObjectID, bytes] = {}  # packed payloads

    def put(self, object_id: ObjectID, packed: bytes) -> None:
        self._values[object_id] = packed

    def get(self, object_id: ObjectID) -> Optional[bytes]:
        return self._values.get(object_id)

    def contains(self, object_id: ObjectID) -> bool:
        return object_id in self._values

    def free(self, object_id: ObjectID) -> None:
        self._values.pop(object_id, None)

    def __len__(self) -> int:
        return len(self._values)
