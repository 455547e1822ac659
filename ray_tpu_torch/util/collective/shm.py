"""Same-node collectives over pin-backed shared-memory channels.

Counterpart: ``ray_tpu/util/collective/shm.py``, over the port's
``_private/channels.py``; it moves numpy arrays (the host group turns
tensors into them first).

The zero-control-plane data path of the "host" backend: when every rank
of a group sits on one node, each rank allocates ONE mutable channel in
the node arena at group-setup time (`channel_create`: create + seal +
pin in one store op, the compiled-DAG pattern from
`_private/channels.py`) and publishes its ``ChannelSpec`` through the
controller KV. After that one-time rendezvous, a steady-state collective
is seqlock rounds over the shared mmap — **zero RPCs**, proven by the
``ray_tpu_rpc_client_calls_total`` counter exactly as the compiled-DAG
suite proves its steady step.

Wire protocol per channel (single writer = the owning rank, world-1
reader slots): every collective posts a tiny packed header round
(dtype/shape/nbytes — validated, so a shape mismatch is a clean error,
never a silent wrong sum), then streams the tensor through the channel
in capacity-sized chunk rounds. Rounds interleave across ranks
(write-mine / read-everyone / ack), so flow control is the channel's own
one-in-flight-step seqlock and memory stays bounded at
``collective_channel_bytes`` per rank regardless of tensor size.

Failure semantics ride the channel machinery: a dead participant's
supervisor closes every channel it touched (its creation pin is
reclaimed through the standard dead-client paths), so blocked peers
raise instead of hanging, and no pin outlives the group.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Dict, List, Optional

import numpy as np

from ray_tpu_torch._private import channels as _channels
from ray_tpu_torch._private import serialization
from ray_tpu_torch._private.exceptions import ChannelClosedError
from ray_tpu_torch._private.ids import ObjectID
from ray_tpu_torch.util.collective import _metrics
from ray_tpu_torch.util.collective import ring as _ring
from ray_tpu_torch.util.collective.types import (
    CollectiveError, ReduceOp, check_inplace_out as _check_out, reduce_ufunc)

logger = logging.getLogger(__name__)


class ShmGroup:
    """Same-node collectives: all-to-all over per-rank arena channels."""

    algo = "shm"

    def __init__(self, core, world_size: int, rank: int, wire_name: str,
                 peers: Dict[int, dict], setup_timeout_ms: int):
        self.world_size = world_size
        self.rank = rank
        self._wire = wire_name
        self._core = core
        self._peers = peers
        self._setup_timeout_ms = setup_timeout_ms
        # explicit p2p (send/recv) rides the chunked worker↔worker
        # transport — the controller is not a mailbox either
        self._t = _ring.P2PTransport(core, wire_name, rank, peers, self.algo)
        # the channel stage builds LAZILY on the first COLLECTIVE: it needs
        # every rank to publish a channel spec, which bystander ranks only
        # do when they reach this point themselves — pairwise send/recv
        # must not block on it (it uses the transport, not the channels)
        self._my_oid: Optional[ObjectID] = None
        self._channels_ready = False
        self._setup_lock = threading.Lock()

    def _ensure_channels(self) -> None:
        if self._channels_ready:
            return
        with self._setup_lock:
            if self._channels_ready:
                return
            self._setup_channels()
            self._channels_ready = True

    def _setup_channels(self) -> None:
        from ray_tpu_torch._private import internal_kv

        core = self._core
        world_size, rank, wire_name = self.world_size, self.rank, self._wire
        cap = max(64, int(core.config.collective_channel_bytes))
        size = _channels.total_size(cap)
        oid = ObjectID.from_put()
        participants = sorted({p["client"] for p in self._peers.values()})
        r = core._run(core.clients.get(core.supervisor_addr).call(
            "channel_create",
            {"channel_id": oid.binary(), "size": size,
             "n_readers": world_size - 1, "participants": participants,
             "client": core._store_client_id,
             "client_addr": core.address},
            timeout=60))
        self._my_oid = oid
        my_spec = _channels.ChannelSpec(
            channel_id=oid.binary(), node_addr=tuple(core.supervisor_addr),
            offset=r["offset"], size=size, n_readers=world_size - 1)
        try:
            internal_kv.kv_put(
                f"{wire_name}:ch:{rank}",
                {"channel_id": my_spec.channel_id, "offset": my_spec.offset,
                 "size": my_spec.size, "n_readers": my_spec.n_readers,
                 "node": core.node_id_hex},
                ns="collective")
            deadline = time.monotonic() + self._setup_timeout_ms / 1000.0
            self._chans: Dict[int, _channels.LocalChannel] = {
                rank: _channels.LocalChannel(core.arena, my_spec)}
            for p in range(world_size):
                if p == rank:
                    continue
                rec = internal_kv.kv_wait(
                    f"{wire_name}:ch:{p}",
                    timeout=max(0.1, deadline - time.monotonic()),
                    ns="collective")
                if rec["node"] != core.node_id_hex:
                    raise CollectiveError(
                        f"collective group {wire_name!r}: rank {p} "
                        f"published a channel on another node — shm algo "
                        f"needs one node")
                spec = _channels.ChannelSpec(
                    channel_id=rec["channel_id"],
                    node_addr=tuple(core.supervisor_addr),
                    offset=rec["offset"], size=rec["size"],
                    n_readers=rec["n_readers"])
                if spec.size != size:
                    raise CollectiveError(
                        f"collective group {wire_name!r}: rank {p} "
                        f"allocated a {spec.size}-byte channel but this "
                        f"rank uses {size} — set "
                        f"RAY_TPU_TORCH_COLLECTIVE_CHANNEL_BYTES uniformly")
                self._chans[p] = _channels.LocalChannel(core.arena, spec)
        except BaseException:
            # half-built group: hand back the creation pin + close + drop
            # the published spec instead of leaking a pinned arena range
            # per failed setup
            self._release_own_channel()
            self._my_oid = None
            raise
        self.capacity = cap
        # per-channel seqlock versions: own advances on write, peers' on
        # read; consistent because every rank runs the same op sequence
        self._wver = 0
        self._rver = {p: 0 for p in self._peers if p != rank}

    # ------------------------------------------------------ round helpers

    def _slot_in(self, p: int) -> int:
        """This rank's reader-ack slot in rank ``p``'s channel header."""
        return self.rank - (1 if self.rank > p else 0)

    def _write(self, payload, deadline: float) -> None:
        self._wver += 2
        try:
            self._chans[self.rank].write(
                payload, self._wver,
                timeout=max(0.05, deadline - time.monotonic()))
        except ChannelClosedError as e:
            raise CollectiveError(
                f"collective group {self._wire!r}: channel closed "
                f"(participant died or group destroyed): {e}") from e
        _metrics.chunks_total.inc(labels=_metrics.labels(self.algo))
        _metrics.bytes_total.inc(len(payload), labels=_metrics.labels(self.algo))

    def _read(self, p: int, deadline: float):
        """One committed round from rank ``p``'s channel; caller must
        ``_ack`` when done with the returned view."""
        self._rver[p] += 2
        try:
            return self._chans[p].read(
                self._rver[p],
                timeout=max(0.05, deadline - time.monotonic()))
        except ChannelClosedError as e:
            raise CollectiveError(
                f"collective group {self._wire!r}: channel of rank {p} "
                f"closed (participant died or group destroyed): {e}") from e

    def _ack(self, p: int) -> None:
        self._chans[p].ack(self._slot_in(p), self._rver[p])

    def _post_header(self, arr: np.ndarray, deadline: float) -> None:
        self._write(serialization.pack(
            (arr.dtype.str, tuple(arr.shape), int(arr.nbytes))), deadline)

    def _read_header(self, p: int, deadline: float) -> tuple:
        view = self._read(p, deadline)
        meta = serialization.unpack(view)  # tiny tuple: copies, safe to ack
        self._ack(p)
        return meta

    def _elems_per_round(self, itemsize: int) -> int:
        return max(1, self.capacity // max(1, itemsize))

    def _others(self) -> List[int]:
        return [p for p in range(self.world_size) if p != self.rank]

    # ------------------------------------------------------------ ops

    def allreduce(self, arr, op: ReduceOp, timeout_ms: int,
                  out: Optional[np.ndarray] = None) -> np.ndarray:
        """``out=`` is the result buffer and MAY alias ``arr`` (the
        donated/in-place form). Every rank folds the contributions in
        rank order, ((x0 + x1) + x2) + ..., so every rank gets the same
        bits, and those of the JAX package's rank 0. A chunk starts as
        rank 0's contribution; where ``out`` aliases the source, a rank
        other than 0 keeps its own chunk in a scratch copy made before
        the chunk is overwritten (one buffer per call)."""
        self._ensure_channels()
        arr = np.asarray(arr)
        deadline = time.monotonic() + timeout_ms / 1000.0
        src = np.ascontiguousarray(arr)
        if out is None:
            out = src.copy()
        else:
            _check_out(out, src)
            if out is not src:
                np.copyto(out.reshape(-1), src.reshape(-1))
        fold = reduce_ufunc(op)
        aliased = self.rank != 0 and np.shares_memory(out, src)
        with _metrics.round_timer(self.algo):
            self._post_header(src, deadline)
            for p in self._others():
                pd, ps, pn = self._read_header(p, deadline)
                if (pd != src.dtype.str or int(pn) != int(src.nbytes)
                        or tuple(ps) != tuple(src.shape)):
                    raise CollectiveError(
                        f"collective group {self._wire!r}: rank {p} "
                        f"contributed dtype={pd} shape={tuple(ps)}, this "
                        f"rank dtype={src.dtype.str} "
                        f"shape={tuple(src.shape)}")
            src_flat = src.reshape(-1)
            out_flat = out.reshape(-1)
            epr = self._elems_per_round(src.itemsize)
            scratch = (np.empty(min(epr, src_flat.size), src.dtype)
                       if aliased else None)
            for start in range(0, src_flat.size, epr):
                stop = min(start + epr, src_flat.size)
                mine = src_flat[start:stop]
                if scratch is not None:
                    mine = scratch[:stop - start]
                    np.copyto(mine, src_flat[start:stop])
                self._write(memoryview(mine).cast("B"), deadline)
                seg = out_flat[start:stop]
                for p in range(self.world_size):
                    if p == self.rank:
                        if p:
                            fold(seg, mine, out=seg)
                        continue  # rank 0's chunk is already in seg
                    view = self._read(p, deadline)
                    peer = np.frombuffer(view, dtype=src.dtype)
                    if p == 0:
                        np.copyto(seg, peer)
                    else:
                        fold(seg, peer, out=seg)
                    self._ack(p)
        _metrics.ops_total.inc(labels=_metrics.labels(self.algo))
        if op is ReduceOp.MEAN:
            if np.issubdtype(out.dtype, np.inexact):
                np.divide(out, self.world_size, out=out)
                return out
            return out / self.world_size  # integer mean widens to float
        return out

    def reduce(self, arr, op: ReduceOp, root_rank: int, timeout_ms: int):
        out = self.allreduce(arr, op, timeout_ms)
        return out if self.rank == root_rank else np.asarray(arr)

    def broadcast(self, arr, root_rank: int, timeout_ms: int) -> np.ndarray:
        self._ensure_channels()
        deadline = time.monotonic() + timeout_ms / 1000.0
        with _metrics.round_timer(self.algo):
            if self.rank == root_rank:
                src = np.ascontiguousarray(np.asarray(arr))
                self._post_header(src, deadline)
                flat = src.reshape(-1)
                epr = self._elems_per_round(src.itemsize)
                for start in range(0, flat.size, epr):
                    stop = min(start + epr, flat.size)
                    self._write(
                        memoryview(flat[start:stop]).cast("B"), deadline)
                out = np.asarray(arr)
            else:
                dt, shape, total = self._read_header(root_rank, deadline)
                out = np.empty(shape, dtype=np.dtype(dt))
                raw = memoryview(out.reshape(-1)).cast("B")
                epr = self._elems_per_round(out.itemsize)
                chunk_bytes = epr * out.itemsize
                for pos in range(0, int(total), chunk_bytes):
                    view = self._read(root_rank, deadline)
                    raw[pos:pos + len(view)] = view
                    self._ack(root_rank)
        _metrics.ops_total.inc(labels=_metrics.labels(self.algo))
        return out

    def allgather(self, arr, timeout_ms: int) -> List[np.ndarray]:
        self._ensure_channels()
        deadline = time.monotonic() + timeout_ms / 1000.0
        src = np.ascontiguousarray(np.asarray(arr))
        results: List[Optional[np.ndarray]] = [None] * self.world_size
        results[self.rank] = np.asarray(arr)
        with _metrics.round_timer(self.algo):
            self._post_header(src, deadline)
            metas = {p: self._read_header(p, deadline)
                     for p in self._others()}
            outs: Dict[int, np.ndarray] = {}
            raws: Dict[int, memoryview] = {}
            rounds = 0
            for p, (dt, shape, total) in metas.items():
                outs[p] = np.empty(shape, dtype=np.dtype(dt))
                raws[p] = memoryview(outs[p].reshape(-1)).cast("B")
                epr = self._elems_per_round(outs[p].itemsize)
                rounds = max(rounds,
                             -(-int(total) // (epr * outs[p].itemsize)))
            flat = src.reshape(-1)
            epr = self._elems_per_round(src.itemsize)
            my_rounds = -(-flat.size // epr) if flat.size else 0
            rounds = max(rounds, my_rounds)
            pos: Dict[int, int] = {p: 0 for p in self._others()}
            # interleaved rounds (ragged-tolerant): write my chunk k, read
            # every peer still streaming — all-write-then-read would
            # deadlock on the one-step channel backpressure
            for k in range(rounds):
                if k < my_rounds:
                    start = k * epr
                    stop = min(start + epr, flat.size)
                    self._write(
                        memoryview(flat[start:stop]).cast("B"), deadline)
                for p in self._others():
                    if pos[p] >= len(raws[p]) and len(raws[p]) > 0:
                        continue
                    if len(raws[p]) == 0:
                        continue
                    view = self._read(p, deadline)
                    raws[p][pos[p]:pos[p] + len(view)] = view
                    pos[p] += len(view)
                    self._ack(p)
            for p in self._others():
                results[p] = outs[p]
        _metrics.ops_total.inc(labels=_metrics.labels(self.algo))
        return list(results)

    def reducescatter(self, arr, op: ReduceOp, timeout_ms: int) -> np.ndarray:
        """Each rank folds ONLY its own axis-0 split while streaming
        peers' rounds (reads outside the split are acked untouched) —
        O(N/world) copy+compute per rank instead of reduce-everything."""
        self._ensure_channels()
        arr = np.asarray(arr)
        deadline = time.monotonic() + timeout_ms / 1000.0
        src = np.ascontiguousarray(arr)
        fold = reduce_ufunc(op)
        # my split in flat element space (axis-0 splits of a contiguous
        # array are contiguous flat ranges)
        splits = np.array_split(src, self.world_size, axis=0)
        row_elems = int(np.prod(src.shape[1:], dtype=np.int64)) \
            if src.ndim > 1 else 1
        rows_before = sum(s.shape[0] for s in splits[:self.rank])
        seg_lo = rows_before * row_elems
        seg_hi = seg_lo + splits[self.rank].size
        mine = splits[self.rank].copy()
        mine_flat = mine.reshape(-1)
        with _metrics.round_timer(self.algo):
            self._post_header(src, deadline)
            for p in self._others():
                pd, ps, pn = self._read_header(p, deadline)
                if (pd != src.dtype.str or int(pn) != int(src.nbytes)
                        or tuple(ps) != tuple(src.shape)):
                    raise CollectiveError(
                        f"collective group {self._wire!r}: rank {p} "
                        f"reducescatter mismatch: dtype={pd} "
                        f"shape={tuple(ps)} vs dtype={src.dtype.str} "
                        f"shape={tuple(src.shape)}")
            src_flat = src.reshape(-1)
            epr = self._elems_per_round(src.itemsize)
            for start in range(0, src_flat.size, epr):
                stop = min(start + epr, src_flat.size)
                self._write(
                    memoryview(src_flat[start:stop]).cast("B"), deadline)
                lo = max(start, seg_lo)
                hi = min(stop, seg_hi)
                for p in self._others():
                    view = self._read(p, deadline)
                    if lo < hi:
                        peer = np.frombuffer(view, dtype=src.dtype)
                        seg = mine_flat[lo - seg_lo:hi - seg_lo]
                        fold(seg, peer[lo - start:hi - start], out=seg)
                    self._ack(p)
        _metrics.ops_total.inc(labels=_metrics.labels(self.algo))
        if op is ReduceOp.MEAN:
            return mine / self.world_size
        return mine

    def barrier(self, timeout_ms: int) -> None:
        self.allreduce(np.zeros((1,), np.float32), ReduceOp.SUM, timeout_ms)

    def send(self, arr, dst_rank: int, timeout_ms: int) -> None:
        self._t.send(dst_rank, np.asarray(arr),
                     time.monotonic() + timeout_ms / 1000.0)

    def recv(self, src_rank: int, timeout_ms: int) -> np.ndarray:
        return self._t.recv(src_rank,
                            time.monotonic() + timeout_ms / 1000.0)

    def _release_own_channel(self) -> None:
        """Best-effort close + unpin + unpublish of this rank's channel
        (both the destroy path and the half-built-setup unwind)."""
        from ray_tpu_torch._private import internal_kv

        core = self._core
        try:
            core._run(core.clients.get(core.supervisor_addr).call(
                "channel_close", {"channel_id": self._my_oid.binary()},
                timeout=10))
        except Exception:
            pass
        try:
            # hand back the creation pin so the channel range can be freed
            core._run(core.clients.get(core.supervisor_addr).call(
                "store_unpin",
                {"object_id": self._my_oid.binary(),
                 "client": core._store_client_id}, timeout=10))
        except Exception:
            pass
        try:
            internal_kv.kv_del(f"{self._wire}:ch:{self.rank}",
                               ns="collective")
        except Exception:
            pass

    def destroy(self) -> None:
        if self._my_oid is not None:
            self._release_own_channel()
        self._t.close()
