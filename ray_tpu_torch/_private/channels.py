"""Mutable shared-memory channels for compiled-graph execution.

Analog of the reference's compiled-DAG channel layer
(`python/ray/experimental/channel/shared_memory_channel.py`): a channel is
ONE arena range allocated at compile time and reused for every step, so a
steady-state pipeline hop costs a buffer write + a version bump — not a
lease/push/put RPC round. Single writer, bounded readers, seqlock-style
version protocol over the node arena that every local process already
mmaps (`object_store.ArenaFile`):

  header (128 B):
    [magic u64][closed u64][version u64][length u64][n_readers u64]
    [reader_acks u64 x 8][depth u64][pad]
  payload: up to ``buffer_bytes`` of a pack()-serialized value.

Protocol (versions advance by 2 per step; step N commits version 2N):
  * writer: wait until every reader slot acked version-2 (flow control:
    capacity is exactly one in-flight step), set version to the odd
    version-1 (write in progress), copy payload, set version (even,
    committed);
  * reader: wait until version >= target (even), hand out a READ-ONLY
    view of payload[:length] — deserialization is zero-copy (pickle-5
    out-of-band buffers become read-only numpy views over the reader's
    own arena mmap; mutation raises), valid until the reader acks;
  * ack: reader slot <- version, releasing the writer for the next step.

Depth-k slot ring (``RAY_TPU_TORCH_CHANNEL_DEPTH`` / ``depth=`` at creation):
capacity grows to k in-flight steps — what 1F1B pipeline schedules need,
where a stage runs several microbatches ahead of its consumer. A depth-k
channel carries a slot directory after the main header (k entries of
[slot_version u64][slot_length u64]) followed by k payload slots; step N
(version 2N) lands in slot (N-1) mod k. The writer of version v waits
until every reader acked v - 2k (the slot's previous occupant is fully
consumed — each ack frees exactly ONE slot), stamps the SLOT version odd
while copying, then commits the slot and advances the header version to
the highest committed version (remote push dedup keys off it). Readers
wait on their target's slot version, so a committed step stays readable
while the writer fills other slots. depth=1 keeps today's layout and
protocol bit-for-bit: no slot directory, the header version doubles as
the single slot's, and the depth field stays zero.

The backing arena range is allocated once through the pin machinery
(`NodeObjectStore.create_channel`: create + seal + pin in one store op),
so it can never be spilled or recycled while the graph lives, and a dead
participant's pins are reclaimed by the supervisor's existing dead-client
paths — which also mark the channel CLOSED, raising ChannelClosedError at
every peer instead of hanging them.

Cross-node edges: the producer commits locally, then PUSHES the payload
to a mirror channel on each remote consumer node through the supervisor's
``channel_push`` / ``channel_write_chunk``+``channel_commit`` RPCs
(chunked with the bounded object transfer window for large payloads). The
push carries an absolute version, so chaos-retried frames converge; the
remote commit waits for the mirror's reader acks, carrying the writer's
flow control across the wire.

Everything here is synchronous: channels are touched from executor/user
threads (the per-actor run loop, the driver's execute/get), never from an
event loop — remote pushes hop onto the core worker's IO loop via
``core._run``.
"""

from __future__ import annotations

import dataclasses
import logging
import struct
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from ray_tpu_torch._private import chaos, flight, serialization
from ray_tpu_torch._private.exceptions import ChannelClosedError
from ray_tpu_torch._private.metrics import Counter

logger = logging.getLogger(__name__)

# flight-recorder span ids for the zero-RPC hot path (interned once; the
# record path is per-thread ring writes — no locks, no RPCs, so the
# steady-state zero-RPC proofs hold with the recorder on)
_F_WRITE_WAIT = flight.intern("chan.write_wait")
_F_READ_WAIT = flight.intern("chan.read_wait")
_F_ACK = flight.intern("chan.ack")
_F_PUSH = flight.intern("chan.push")

Address = Tuple[str, int]

MAGIC = 0x5254_5055_4348_414E  # "RTPUCHAN"
MAX_READERS = 8
HEADER_SIZE = 128
_OFF_MAGIC, _OFF_CLOSED, _OFF_VERSION, _OFF_LENGTH, _OFF_NREADERS = (
    0, 8, 16, 24, 32)
_OFF_ACKS = 40  # u64 x MAX_READERS
_OFF_DEPTH = 104  # u64 in the former pad; 0 reads as depth 1 (legacy)
SLOT_HEADER_SIZE = 16  # [slot_version u64][slot_length u64], depth > 1 only
_U64 = struct.Struct("<Q")

# the method name the driver submits to install a per-actor run loop;
# dispatched specially by the worker executor (never a user method)
CHANNEL_LOOP_METHOD = "__rtpu_channel_loop__"

_m_writes = Counter(
    "ray_tpu_channel_writes_total",
    "Compiled-graph channel commits (local writes + remote mirror pushes)")
_m_reads = Counter(
    "ray_tpu_channel_reads_total",
    "Compiled-graph channel reads (zero-copy views handed to consumers)")
_m_bytes = Counter(
    "ray_tpu_channel_bytes_total",
    "Compiled-graph channel payload bytes by op (write/read/push)")
_m_steps = Counter(
    "ray_tpu_compiled_steps_total",
    "Compiled-graph steps launched (CompiledDAG.execute calls)")


def total_size(buffer_bytes: int, depth: int = 1) -> int:
    """Arena bytes for a channel of ``depth`` slots of ``buffer_bytes``
    each. depth=1 is the legacy layout (no slot directory)."""
    depth = int(depth)
    if depth <= 1:
        return HEADER_SIZE + int(buffer_bytes)
    return HEADER_SIZE + depth * SLOT_HEADER_SIZE + depth * int(buffer_bytes)


def slot_capacity(size: int, depth: int) -> int:
    """Per-slot payload capacity of a channel of ``size`` total bytes."""
    depth = max(1, int(depth))
    if depth == 1:
        return int(size) - HEADER_SIZE
    return (int(size) - HEADER_SIZE - depth * SLOT_HEADER_SIZE) // depth


def _slot_of(version: int, depth: int) -> int:
    """Ring slot carrying even ``version`` (= 2N -> slot (N-1) mod k)."""
    return (version // 2 - 1) % depth


def _slot_header_off(slot: int) -> int:
    return HEADER_SIZE + slot * SLOT_HEADER_SIZE


def _slot_payload_off(slot: int, depth: int, size: int) -> int:
    return (HEADER_SIZE + depth * SLOT_HEADER_SIZE
            + slot * slot_capacity(size, depth))


def init_header(arena, offset: int, n_readers: int,
                depth: int = 1) -> None:
    """Zero + stamp a fresh channel header (runs supervisor-side on the
    store thread right after the range is allocated). depth=1 leaves the
    depth field zero — byte-identical to the pre-slot-ring header."""
    if not 0 <= int(n_readers) <= MAX_READERS:
        # a clamped count would silently drop flow control for the extra
        # readers (and their acks would land in the payload bytes)
        raise ValueError(
            f"channel needs {n_readers} reader slots; the header carries "
            f"at most {MAX_READERS}")
    if int(depth) < 1:
        raise ValueError(f"channel depth must be >= 1, got {depth}")
    view = arena.view(offset, HEADER_SIZE)
    view[:] = b"\x00" * HEADER_SIZE
    _U64.pack_into(view, _OFF_MAGIC, MAGIC)
    _U64.pack_into(view, _OFF_NREADERS, int(n_readers))
    if int(depth) > 1:
        _U64.pack_into(view, _OFF_DEPTH, int(depth))
        # zero the slot directory (the payload area needs no init)
        dir_view = arena.view(offset + HEADER_SIZE,
                              int(depth) * SLOT_HEADER_SIZE)
        dir_view[:] = b"\x00" * (int(depth) * SLOT_HEADER_SIZE)


def mark_closed(arena, offset: int) -> None:
    """Set the closed flag (any peer/supervisor may; one-way)."""
    arena.view(offset, HEADER_SIZE)[_OFF_CLOSED:_OFF_CLOSED + 8] = \
        _U64.pack(1)


def read_header(arena, offset: int) -> Tuple[bool, int, int]:
    """(closed, version, length) — supervisor-side peek for push/commit.
    ``version`` is the highest committed version at any depth."""
    view = arena.view(offset, HEADER_SIZE)
    return (
        _U64.unpack_from(view, _OFF_CLOSED)[0] != 0,
        _U64.unpack_from(view, _OFF_VERSION)[0],
        _U64.unpack_from(view, _OFF_LENGTH)[0],
    )


def read_depth(arena, offset: int) -> int:
    """Slot-ring depth stamped in the header (0 reads as legacy depth 1)."""
    view = arena.view(offset, HEADER_SIZE)
    return max(1, _U64.unpack_from(view, _OFF_DEPTH)[0])


def readers_ready(arena, offset: int, version: int) -> bool:
    """True when every reader slot acked ``version - 2*depth`` — the slot
    ``version`` lands in is free of its previous occupant, so the writer
    (local or a remote push landing via the supervisor) may overwrite."""
    view = arena.view(offset, HEADER_SIZE)
    return readers_ready_view(view, version)


def host_write_commit(arena, offset: int, size: int, payload,
                      version: int) -> None:
    """Supervisor-side mirror write: payload + length + commit in one shot
    (callers already waited for reader acks; chunked pushes write payload
    via host_write_chunk and commit via host_commit instead)."""
    depth = read_depth(arena, offset)
    if depth == 1:
        arena.write(offset + HEADER_SIZE, payload)
    else:
        slot = _slot_of(version, depth)
        arena.write(offset + _slot_payload_off(slot, depth, size), payload)
    host_commit(arena, offset, size, len(payload), version)


def host_commit(arena, offset: int, size: int, length: int,
                version: int) -> None:
    depth = read_depth(arena, offset)
    if depth > 1:
        slot = _slot_of(version, depth)
        sview = arena.view(offset + _slot_header_off(slot),
                           SLOT_HEADER_SIZE)
        _U64.pack_into(sview, 8, length)
        _U64.pack_into(sview, 0, version)
    view = arena.view(offset, HEADER_SIZE)
    _U64.pack_into(view, _OFF_LENGTH, length)
    _U64.pack_into(view, _OFF_VERSION, version)


def host_write_chunk(arena, offset: int, size: int, version: int,
                     chunk_offset: int, data) -> None:
    depth = read_depth(arena, offset)
    if depth == 1:
        arena.write(offset + HEADER_SIZE + chunk_offset, data)
    else:
        slot = _slot_of(version, depth)
        arena.write(
            offset + _slot_payload_off(slot, depth, size) + chunk_offset,
            data)


# --------------------------------------------------------------- descriptors


@dataclasses.dataclass
class ChannelSpec:
    """Wire-shippable address of one channel: which node's arena, where in
    it, and how many reader slots its header carries."""

    channel_id: bytes  # ObjectID binary of the backing arena object
    node_addr: Tuple[str, int]  # supervisor owning the arena range
    offset: int
    size: int  # total (header + slot directory + payload capacity)
    n_readers: int
    depth: int = 1  # slot-ring capacity (in-flight steps)

    def key(self) -> bytes:
        return self.channel_id


@dataclasses.dataclass
class StagePlan:
    """One actor-method invocation inside a per-actor run loop.

    ``args``/``kwargs`` entries are templates:
      ("const", value)            — baked at compile time
      ("chan", ChannelSpec, slot) — read this step's payload (slot = this
                                    stage's reader-ack slot in the header)
    """

    method_name: str
    args: List[tuple]
    kwargs: Dict[str, tuple]
    out_channel: Optional[ChannelSpec]  # local channel on this actor's node
    out_mirrors: List[ChannelSpec]  # remote mirrors push-committed per step


@dataclasses.dataclass
class ActorLoopPlan:
    """Everything one actor needs to run its compiled-execution loop."""

    node_addr: Tuple[str, int]  # the actor's node (sanity-checked on entry)
    stages: List[StagePlan]  # topological order


# ------------------------------------------------------------ local channels


class LocalChannel:
    """Reader/writer over a channel range in THIS process's arena mmap."""

    def __init__(self, arena, spec: ChannelSpec):
        self.spec = spec
        self._view = arena.view(spec.offset, spec.size)
        if _U64.unpack_from(self._view, _OFF_MAGIC)[0] != MAGIC:
            raise ValueError(
                f"not a channel at offset {spec.offset} (bad magic)")
        # the header is the source of truth for depth (the spec default
        # covers pre-ring wire records)
        self.depth = max(1, _U64.unpack_from(self._view, _OFF_DEPTH)[0])
        self.capacity = slot_capacity(spec.size, self.depth)

    # -- header accessors

    def _u64(self, off: int) -> int:
        return _U64.unpack_from(self._view, off)[0]

    def _set_u64(self, off: int, value: int) -> None:
        _U64.pack_into(self._view, off, value)

    @property
    def closed(self) -> bool:
        return self._u64(_OFF_CLOSED) != 0

    @property
    def version(self) -> int:
        return self._u64(_OFF_VERSION)

    def close(self) -> None:
        self._set_u64(_OFF_CLOSED, 1)

    # -- protocol

    def _wait(self, cond: Callable[[], bool], timeout: Optional[float],
              what: str) -> None:
        """Spin-then-sleep until cond() (shm polling IS the zero-RPC
        steady state: sub-ms for a busy pipeline, 1 ms granularity when
        idle). Closed beats waiting; cond is checked before closed so a
        committed final value is still delivered after a close."""
        deadline = None if timeout is None else time.monotonic() + timeout
        spins = 0
        delay = 5e-5
        while True:
            if cond():
                return
            if self.closed:
                raise ChannelClosedError(
                    f"channel {self.spec.channel_id.hex()[:12]} closed "
                    f"while waiting to {what}")
            if deadline is not None and time.monotonic() > deadline:
                raise TimeoutError(
                    f"channel {self.spec.channel_id.hex()[:12]}: {what} "
                    f"timed out after {timeout}s")
            spins += 1
            if spins < 100:
                # yield the GIL/CPU; catches a busy pipeline. Kept SHORT:
                # on a saturated host every yield is a sched_yield that
                # burns a scheduler pass, and a peer that hasn't
                # committed within ~100 yields won't within 500 either
                time.sleep(0)
            else:
                # escalate 50us -> 2ms: a hot pipeline wakes within one
                # short tick; an idle loop settles at 2ms polls (the
                # CPU-burn/latency tradeoff of a no-RPC wait)
                time.sleep(delay)
                delay = min(delay * 1.5, 0.002)

    def _slot_version(self, slot: int) -> int:
        return self._u64(_slot_header_off(slot))

    def write(self, payload, version: int,
              timeout: Optional[float] = None) -> None:
        """Commit ``payload`` as ``version`` (even). Blocks until every
        reader acked version - 2*depth — the ring slot this version lands
        in is free, which is the compiled-DAG backpressure (capacity is
        ``depth`` in-flight steps; one at the legacy depth 1)."""
        n = len(payload)
        if n > self.capacity:
            raise ValueError(
                f"channel payload of {n} bytes exceeds the channel buffer "
                f"({self.capacity}); recompile with "
                f"experimental_compile(buffer_size_bytes=...)")
        chaos.maybe_delay("channel.write")
        _t0 = flight.now()
        self._wait(lambda: readers_ready_view(self._view, version),
                   timeout, f"write v{version}")
        flight.span_since(_F_WRITE_WAIT, _t0)
        if self.depth == 1:
            self._set_u64(_OFF_VERSION, version - 1)  # odd: in progress
            self._view[HEADER_SIZE:HEADER_SIZE + n] = payload
            self._set_u64(_OFF_LENGTH, n)
            self._set_u64(_OFF_VERSION, version)
        else:
            slot = _slot_of(version, self.depth)
            shdr = _slot_header_off(slot)
            base = _slot_payload_off(slot, self.depth, self.spec.size)
            self._set_u64(shdr, version - 1)  # odd: slot write in progress
            self._view[base:base + n] = payload
            self._set_u64(shdr + 8, n)
            self._set_u64(shdr, version)
            # header version trails the newest commit (commits are
            # sequential from the single writer): remote push dedup and
            # read_header peeks key off it
            self._set_u64(_OFF_LENGTH, n)
            self._set_u64(_OFF_VERSION, version)
        _m_writes.inc()
        _m_bytes.inc(n, labels={"op": "write"})

    def read(self, version: int,
             timeout: Optional[float] = None) -> memoryview:
        """Read-only view of the payload once ``version`` is committed.
        The view aliases the shared arena: it is valid until this reader
        acks, after which the writer may overwrite it."""
        chaos.maybe_delay("channel.read")
        _t0 = flight.now()
        if self.depth == 1:
            self._wait(
                lambda: self.version >= version and self.version % 2 == 0,
                timeout, f"read v{version}")
            length = self._u64(_OFF_LENGTH)
            base = HEADER_SIZE
        else:
            # the writer cannot lap this reader (it blocks until our ack
            # of this slot's previous occupant), so slot_version can
            # never exceed the version we are waiting for
            slot = _slot_of(version, self.depth)
            shdr = _slot_header_off(slot)
            self._wait(
                lambda: (self._slot_version(slot) >= version
                         and self._slot_version(slot) % 2 == 0),
                timeout, f"read v{version}")
            length = self._u64(shdr + 8)
            base = _slot_payload_off(slot, self.depth, self.spec.size)
        flight.span_since(_F_READ_WAIT, _t0)
        _m_reads.inc()
        _m_bytes.inc(length, labels={"op": "read"})
        return self._view[base:base + length].toreadonly()

    def ready(self, version: int) -> bool:
        """Non-blocking probe: is ``version`` committed (readable now)?
        Returns True on a closed channel so the caller's blocking read
        observes the close and raises instead of spinning forever."""
        if self.closed:
            return True
        if self.depth == 1:
            v = self.version
        else:
            v = self._slot_version(_slot_of(version, self.depth))
        return v >= version and v % 2 == 0

    def writable(self, version: int) -> bool:
        """Non-blocking probe: would ``write(version)`` commit without
        blocking (every reader acked the slot's previous occupant)?
        True on a closed channel so the caller's write observes the
        close and raises instead of treating it as backpressure. What
        the interleaved 1F1B scheduler keys on: an actor multiplexing V
        chunks must never park in one chunk's blocked write while
        another chunk has ready work (single writer + monotonic acks, so
        a True can only stay True until this writer writes)."""
        return self.closed or readers_ready_view(self._view, version)

    def ack(self, slot: int, version: int) -> None:
        """Release the writer: this reader is done with ``version``."""
        if not 0 <= slot < MAX_READERS:
            # slot MAX_READERS would stamp the ack into payload byte 0
            raise ValueError(f"reader slot {slot} out of range")
        chaos.maybe_delay("channel.ack")
        self._set_u64(_OFF_ACKS + 8 * slot, version)
        flight.instant(_F_ACK, version)


def readers_ready_view(view: memoryview, version: int) -> bool:
    n = _U64.unpack_from(view, _OFF_NREADERS)[0]
    depth = max(1, _U64.unpack_from(view, _OFF_DEPTH)[0])
    floor = version - 2 * depth
    for slot in range(n):
        if _U64.unpack_from(view, _OFF_ACKS + 8 * slot)[0] < floor:
            return False
    return True


# ----------------------------------------------------------- remote mirrors


class MirrorWriter:
    """Per-step push of a committed payload to one remote mirror channel.

    The transport rides the established supervisor RPC clients (data
    plane, pre-connected at compile time): one ``channel_push`` frame for
    small payloads, a bounded window of ``channel_write_chunk`` frames +
    one ``channel_commit`` for large ones (the object transfer-window shape).
    Versions are absolute, so chaos-retried frames converge; any delivery
    failure means the remote peer is unreachable and surfaces as
    ChannelClosedError so the whole graph unwinds."""

    def __init__(self, core, spec: ChannelSpec):
        self._core = core
        self.spec = spec
        self._chunk = core.config.object_transfer_chunk_bytes
        self._window = max(1, core.config.object_transfer_window)
        self._timeout = core.config.channel_remote_timeout_s
        self.capacity = slot_capacity(spec.size, spec.depth)

    def push(self, payload, version: int) -> None:
        if len(payload) > self.capacity:
            # same contract as LocalChannel.write: at depth > 1 the
            # slots are contiguous, so an unchecked oversized stream
            # would silently overwrite the NEXT slot's committed payload
            # on the remote side (the supervisor handlers also reject,
            # as defense)
            raise ValueError(
                f"channel payload of {len(payload)} bytes exceeds the "
                f"channel buffer ({self.capacity}); recompile with "
                f"experimental_compile(buffer_size_bytes=...)")
        _t0 = flight.now()
        try:
            self._core._run(self._push_async(payload, version),
                            timeout=self._timeout + 10)
        except ChannelClosedError:
            raise
        except Exception as e:  # noqa: BLE001 — any transport/remote failure
            cause = getattr(e, "cause", None)
            if isinstance(cause, ChannelClosedError):
                raise ChannelClosedError(str(cause)) from e
            raise ChannelClosedError(
                f"push to mirror on {self.spec.node_addr} failed: {e!r}"
            ) from e
        flight.span_since(_F_PUSH, _t0)
        _m_writes.inc()
        _m_bytes.inc(len(payload), labels={"op": "push"})

    async def _push_async(self, payload, version: int) -> None:
        from ray_tpu_torch._private import rpc

        client = self._core.clients.get(tuple(self.spec.node_addr))
        cid = self.spec.channel_id
        if len(payload) <= self._chunk:
            await client.call(
                "channel_push",
                {"channel_id": cid, "version": version,
                 "payload": bytes(payload)},
                timeout=self._timeout)
            return
        await rpc.call_chunked(
            client, "channel_write_chunk",
            {"channel_id": cid, "version": version}, payload,
            chunk_bytes=self._chunk, window=self._window,
            timeout=self._timeout)
        await client.call(
            "channel_commit",
            {"channel_id": cid, "version": version,
             "length": len(payload)},
            timeout=self._timeout)


class VersionedWriter:
    """Version-addressed writer over one channel: a LocalChannel when the
    channel lives in this node's arena, a MirrorWriter push otherwise.
    Shared by the pipeline trainer's stage loops and the podracer RL
    topology so the local-vs-mirror dispatch lives in one place."""

    def __init__(self, core, spec: ChannelSpec,
                 open_local: Callable[[ChannelSpec], "LocalChannel"]):
        self.spec = spec
        if tuple(spec.node_addr) == tuple(core.supervisor_addr):
            self._local: Optional[LocalChannel] = open_local(spec)
            self._mirror = None
        else:
            self._local = None
            self._mirror = MirrorWriter(core, spec)

    @property
    def is_local(self) -> bool:
        return self._local is not None

    def write(self, payload, version: int) -> None:
        if self._local is not None:
            self._local.write(payload, version)
        else:
            self._mirror.push(payload, version)

    def writable(self, version: int) -> bool:
        """Non-blocking probe: may ``version`` be written now without
        blocking? Mirror writers answer True — remote reader acks are
        not observable without an RPC, and the push's remote commit
        carries the flow control instead (the interleaved scheduler
        treats a mirror edge as always eligible and accepts the bounded
        block, exactly like a one-slot chain does)."""
        if self._local is not None:
            return self._local.writable(version)
        return True


# ------------------------------------------------- driver-side shared plumbing


def create_channel(core, node_addr, buffer_bytes: int, depth: int,
                   n_readers: int, participants) -> ChannelSpec:
    """Mint + allocate one channel on ``node_addr`` (compile/build time).
    The creation pin belongs to this driver until teardown releases it.
    Shared by the compiled-DAG planner and the pipeline trainer so the
    channel_create contract lives in exactly one place."""
    from ray_tpu_torch._private.core_worker import _m_pins
    from ray_tpu_torch._private.ids import ObjectID

    oid = ObjectID.from_put()
    size = total_size(buffer_bytes, depth)
    r = core._run(core.clients.get(tuple(node_addr)).call(
        "channel_create",
        {"channel_id": oid.binary(), "size": size,
         "n_readers": n_readers, "depth": depth,
         "participants": sorted(participants),
         "client": core._store_client_id,
         "client_addr": core.address},
        timeout=60))
    _m_pins.inc()  # the creation pin is ours until teardown
    return ChannelSpec(
        channel_id=oid.binary(), node_addr=tuple(node_addr),
        offset=r["offset"], size=size, n_readers=n_readers, depth=depth)


def close_channels_nowait(core, local_channels, specs) -> None:
    """Fire-and-forget close of a channel set: flip the local closed
    flags immediately (unblocks any thread parked in read/write in THIS
    process), then fan channel_close out to every hosting node without
    blocking the caller. Shared by the compiled-DAG failure paths and
    the pipeline trainer — the close contract lives in one place."""
    for ch in local_channels:
        try:
            ch.close()
        except Exception:
            pass
    for spec in specs:
        core._run_nowait(core.clients.get(tuple(spec.node_addr)).call(
            "channel_close", {"channel_id": spec.channel_id},
            timeout=10))


def open_local_factory(core):
    """(open_local, local_dict, release_pins) triple over this process's
    arena — the pin/open bookkeeping every channel run loop needs (stage
    loops, podracer runners/learners, streaming data stages), shared so
    the pin contract lives in one place."""
    local: Dict[bytes, "LocalChannel"] = {}

    def open_local(spec: "ChannelSpec") -> "LocalChannel":
        ch = local.get(spec.key())
        if ch is None:
            _pin_local_channel(core, spec)
            ch = LocalChannel(core.arena, spec)
            local[spec.key()] = ch
        return ch

    def release_pins() -> None:
        from ray_tpu_torch._private.ids import ObjectID

        for key in local:
            core._schedule_unpin(ObjectID(key))

    return open_local, local, release_pins


def close_specs(core, specs, timeout: float = 30) -> None:
    """Blocking teardown-path close fan-out: one channel_close per spec,
    per-spec failures logged and swallowed (a dead node's channels are
    already closed by its supervisor's death paths). Shared by the
    pipeline trainer, the sebulba topology and the streaming data
    executor so the shutdown contract lives in one place."""

    async def close_all():
        for spec in specs:
            try:
                await core.clients.get(tuple(spec.node_addr)).call(
                    "channel_close",
                    {"channel_id": spec.channel_id}, timeout=10)
            except Exception:
                logger.debug("channel_close failed", exc_info=True)

    if specs:
        try:
            core._run(close_all(), timeout=timeout)
        except Exception:
            logger.debug("channel close fan-out failed", exc_info=True)


def free_and_unpin_specs(core, specs, timeout: float = 60) -> None:
    """Blocking teardown-path release fan-out: store_free + the driver's
    creation-pin store_unpin per spec. Failures are logged and left to
    the supervisor's dead-client sweep (the departing-driver fallback)."""
    from ray_tpu_torch._private.core_worker import _m_pins

    async def release_all():
        for spec in specs:
            client = core.clients.get(tuple(spec.node_addr))
            try:
                await client.call(
                    "store_free",
                    {"object_ids": [spec.channel_id]}, timeout=10)
                await client.call(
                    "store_unpin",
                    {"object_id": spec.channel_id,
                     "client": core._store_client_id}, timeout=10)
                _m_pins.dec()
            except Exception:
                logger.debug(
                    "channel pin release failed (reclaimed by the "
                    "supervisor's dead-client sweep)", exc_info=True)

    if specs:
        try:
            core._run(release_all(), timeout=timeout)
        except Exception:
            logger.debug("channel release fan-out failed", exc_info=True)


def plan_axis_placement(views, *, num_stages: int, dp: int = 1
                        ) -> "list[list[str]]":
    """Per-axis device model for a tp x dp x pp trainer: node_id_hex per
    (dp replica, pipeline stage) slot. Every tp rank of a (r, s) slot
    shares ONE node — the node-as-pseudo-pod whose collective auto rule
    picks the shared-memory fast path — while consecutive stages (and dp
    replicas) round-robin across nodes so the pp/dp edges are the ones
    that cross hosts. Nodes are taken alive-first in sorted-id order, so
    the plan is deterministic for a given cluster view."""
    nodes = sorted(v["node_id_hex"] for v in views if v.get("alive", True))
    if not nodes:
        nodes = sorted(v["node_id_hex"] for v in views)
    if not nodes:
        raise RuntimeError("plan_axis_placement: empty cluster view")
    return [[nodes[(r * num_stages + s) % len(nodes)]
             for s in range(num_stages)] for r in range(dp)]


def plan_mesh_placement(views, *, num_producers: int, num_consumers: int
                        ) -> "tuple[list[str], list[str]]":
    """Node model for an R x C exchange mesh: (producer node_id_hex
    list, consumer node_id_hex list). Producers and consumers each
    round-robin across live nodes INDEPENDENTLY, so on a multi-node
    cluster both roles spread (every node hosts producers and
    consumers) and the R x C channel mesh splits its edges between
    same-node seqlock hops and cross-node mirror pushes instead of
    funneling every bucket through one host. Nodes are taken
    alive-first in sorted-id order — deterministic for a given view."""
    nodes = sorted(v["node_id_hex"] for v in views if v.get("alive", True))
    if not nodes:
        nodes = sorted(v["node_id_hex"] for v in views)
    if not nodes:
        raise RuntimeError("plan_mesh_placement: empty cluster view")
    return ([nodes[r % len(nodes)] for r in range(num_producers)],
            [nodes[c % len(nodes)] for c in range(num_consumers)])


def resolve_actor_placement(core, actor_id, views=None, *,
                            expect_node_id_hex=None) -> dict:
    """Wait (bounded) for the actor to be ALIVE, then snapshot its
    worker/node identity. Channel placement pins to this incarnation:
    if the actor later restarts elsewhere, its run loop dies with the
    old worker and the graph/pipeline closes — compiled topologies do
    not migrate; rebuild against the restarted actor. ``views`` lets a
    caller resolve a whole actor set against one node_views snapshot
    (refreshed once here if the actor's node joined after it).

    ``expect_node_id_hex``: the node an axis-aware plan
    (plan_axis_placement) asked for. Soft scheduling may land the actor
    elsewhere — correctness holds (ring transport crosses nodes), only
    the shm fast path is lost — so a mismatch warns and is recorded as
    ``planned_node_ok=False`` rather than raising."""
    ctrl = core.clients.get(core.controller_addr)
    deadline = time.monotonic() + 60
    while True:
        rec = core._run(ctrl.call(
            "actor_get", {"actor_id_hex": actor_id.hex()}))
        if rec is None or rec["state"] == "DEAD":
            raise RuntimeError(
                f"cannot place channels: actor {actor_id.hex()[:12]} is "
                f"{'unknown' if rec is None else 'dead'}")
        if rec["state"] == "ALIVE" and rec.get("address") \
                and rec.get("node_id_hex"):
            break
        if time.monotonic() > deadline:
            raise RuntimeError(
                f"cannot place channels: actor {actor_id.hex()[:12]} "
                f"not alive within 60s")
        time.sleep(0.05)
    caller_views = views is not None
    if views is None:
        views = core._run(ctrl.call("node_views"))

    def find(vs):
        for v in vs:
            if v["node_id_hex"] == rec["node_id_hex"]:
                return tuple(v["address"])
        return None

    node_addr = find(views)
    if node_addr is None and caller_views:
        node_addr = find(core._run(ctrl.call("node_views")))
    if node_addr is None:
        raise RuntimeError(
            f"actor {actor_id.hex()[:12]}'s node "
            f"{rec['node_id_hex'][:12]} not in the cluster view")
    info = {"actor_id": actor_id, "node_addr": node_addr,
            "node_id_hex": rec["node_id_hex"],
            "worker_id_hex": rec["worker_id_hex"]}
    if expect_node_id_hex is not None:
        ok = rec["node_id_hex"] == expect_node_id_hex
        info["planned_node_ok"] = ok
        if not ok:
            logger.warning(
                "actor %s landed on node %s, not the planned node %s — "
                "its tp group falls back to the cross-node ring "
                "transport", actor_id.hex()[:12],
                rec["node_id_hex"][:12], expect_node_id_hex[:12])
    return info


def surface_loop_failure(core, loop_refs, closed: "ChannelClosedError"):
    """A closed channel usually has a root cause parked in a run-loop
    task's error report (user method raised, actor died) — raise that
    instead of the bare close when one is available."""
    from ray_tpu_torch._private.exceptions import ActorDiedError, TaskError

    for ref in loop_refs:
        try:
            core.get([ref], timeout=1.0)
        except (TaskError, ActorDiedError) as e:
            raise e from closed
        except Exception:
            continue
    raise closed


# ----------------------------------------------------- worker-side run loop


def _pin_local_channel(core, spec: ChannelSpec) -> None:
    """Take this process's own pin on a channel range (released through
    the standard unpin batcher on loop exit; reclaimed by the supervisor
    if this worker dies). Pinning also verifies the offset is still the
    one the driver allocated — it must be, since the creation pin blocks
    spill, so a mismatch is a protocol bug worth failing loudly on."""
    from ray_tpu_torch._private.core_worker import _m_pins

    loc = core._run(core.clients.get(core.supervisor_addr).call(
        "store_locate",
        {"object_id": spec.channel_id, "pin": True,
         "client": core._store_client_id, "client_addr": core.address},
        timeout=60))
    if loc is None:
        raise ChannelClosedError(
            f"channel {spec.channel_id.hex()[:12]} no longer in the local "
            f"store (graph torn down before the loop started)")
    _m_pins.inc()
    if loc["offset"] != spec.offset:
        raise RuntimeError(
            f"channel {spec.channel_id.hex()[:12]} moved "
            f"({loc['offset']} != {spec.offset}) despite the creation pin")


def run_actor_loop(core, instance, plan: ActorLoopPlan) -> dict:
    """The per-actor compiled-execution loop (installed as a long-running
    actor task): read input channels -> run methods in topo order ->
    write/push output channels -> ack inputs. Exits when the channels
    close (teardown or participant death); any user-method exception
    closes the graph and surfaces through this task's error report."""
    from ray_tpu_torch._private.ids import ObjectID

    if tuple(plan.node_addr) != tuple(core.supervisor_addr):
        raise RuntimeError(
            f"channel loop planned for node {plan.node_addr} but this "
            f"worker sits on {core.supervisor_addr}")

    # open + pin every local channel this loop touches (one setup pass of
    # control RPCs; the steady-state loop below does none)
    local: Dict[bytes, LocalChannel] = {}

    def open_local(spec: ChannelSpec) -> LocalChannel:
        ch = local.get(spec.key())
        if ch is None:
            _pin_local_channel(core, spec)
            ch = LocalChannel(core.arena, spec)
            local[spec.key()] = ch
        return ch

    def release_pins() -> None:
        for key in local:
            core._schedule_unpin(ObjectID(key))

    bound: List[tuple] = []  # (method, arg templates, out ch, mirrors)
    try:
        for stage in plan.stages:
            method = getattr(instance, stage.method_name)
            for entry in list(stage.args) + list(stage.kwargs.values()):
                if entry[0] == "chan":
                    open_local(entry[1])
            out = (open_local(stage.out_channel)
                   if stage.out_channel else None)
            mirrors = [MirrorWriter(core, m) for m in stage.out_mirrors]
            bound.append((method, stage, out, mirrors))
    except BaseException:
        # partial setup (e.g. the graph torn down mid-install): hand back
        # the pins already taken instead of stranding them until this
        # worker dies
        release_pins()
        raise

    def close_everything() -> None:
        for ch in local.values():
            ch.close()
        for _, stage, _, _ in bound:
            for m in stage.out_mirrors:
                core._run_nowait(core.clients.get(tuple(m.node_addr)).call(
                    "channel_close", {"channel_id": m.channel_id},
                    timeout=10))

    steps = 0
    async_loop = None  # created once, on the first async method
    try:
        while True:
            version = 2 * (steps + 1)
            chaos.maybe_crash("worker.channel_step")
            for method, stage, out, mirrors in bound:
                views: List[Tuple[LocalChannel, int]] = []

                def resolve(entry):
                    if entry[0] == "const":
                        return entry[1]
                    _, spec, slot = entry
                    ch = local[spec.key()]
                    view = ch.read(version)
                    views.append((ch, slot))
                    # zero-copy deserialization: out-of-band buffers
                    # become read-only numpy views over the arena range,
                    # valid until the ack below
                    return serialization.unpack(view)

                args = [resolve(a) for a in stage.args]
                kwargs = {k: resolve(v) for k, v in stage.kwargs.items()}
                result = method(*args, **kwargs)
                if hasattr(result, "__await__"):
                    # async-actor method from the sync loop: drive it
                    # here, on an event loop kept for the run's lifetime
                    # (per-step create/close is syscall churn on the
                    # hot path this subsystem exists to strip bare)
                    if async_loop is None:
                        import asyncio

                        async_loop = asyncio.new_event_loop()
                    result = async_loop.run_until_complete(result)
                payload = serialization.pack(result)
                del result
                if out is not None:
                    out.write(payload, version)
                for mirror in mirrors:
                    mirror.push(payload, version)
                del payload, args, kwargs
                # inputs consumed (the output no longer references them):
                # release the upstream writers
                for ch, slot in views:
                    ch.ack(slot, version)
            steps += 1
    except ChannelClosedError:
        # normal exit: teardown (or a peer's death) closed the channels.
        # Re-fan the close over OUR channels before leaving: a peer that
        # poisoned only its own edges (user exception on a still-alive
        # actor — no supervisor death fan-out) relies on each loop
        # propagating the close, or a driver parked on an untouched
        # output channel would hang forever. Safe on the teardown path:
        # our pins (released in the finally below) keep the ranges
        # alive, and the driver frees them only after collecting this
        # loop's result.
        try:
            close_everything()
        except Exception:
            logger.exception("channel close-on-exit failed")
        return {"steps": steps}
    except BaseException:
        # user method raised (or this worker is wedged): poison the graph
        # so every peer unwinds instead of hanging, then surface the real
        # error through this loop task's report
        try:
            close_everything()
        except Exception:
            logger.exception("channel close-on-error failed")
        raise
    finally:
        if async_loop is not None:
            async_loop.close()
        release_pins()
