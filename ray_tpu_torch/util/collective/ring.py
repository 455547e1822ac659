"""Peer-to-peer chunked collective transport + ring algorithms.

The cross-node data path of the "host" backend: after a one-time
controller-KV rendezvous (addresses only — the controller never carries
tensor bytes), ranks exchange tensor segments over DIRECT worker↔worker
RPCs. Each logical message streams as chunked, bounded-window frames
(`rpc.call_chunked`, the `RAY_TPU_TORCH_OBJECT_TRANSFER_WINDOW` shape from the
object data plane), so tensors larger than the RPC `MAX_FRAME` work and
a slow link never buffers a whole tensor.

Allreduce is the classic ring: a reduce-scatter phase (world-1 rounds,
each rank sends one segment to its right neighbor and folds the segment
arriving from its left) followed by an allgather phase passing the fully
reduced segments around. Per-link traffic is O(2·N·(W-1)/W) ≈ O(N) —
independent of world size — versus the old controller-KV rounds moving
O(N·W) through one pickled control-plane socket.

Frames are idempotent (absolute byte offsets into a per-message buffer),
so the RPC layer's transparent drop/dup/retry handling converges without
a replay cache; a mid-ring participant death surfaces as a clean
``TimeoutError`` / ``CollectiveError`` (node deaths fail fast through the
core worker's node-death fan-out), never a wrong sum.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from ray_tpu_torch.util.collective import _metrics
from ray_tpu_torch.util.collective.types import (CollectiveError, ReduceOp,
                                           check_inplace_out as _check_out,
                                           reduce_ufunc)

logger = logging.getLogger(__name__)


# ------------------------------------------------------------------ inbox


class _Inbox:
    """Per-process landing zone for ``collective_chunk`` frames.

    Messages are keyed ``(group, src_rank, seq)`` where ``seq`` counts
    messages per directed (src → this process) pair — both endpoints
    advance the counter in lockstep because collective call order is the
    same on every rank (the standard requirement). Chunks land at
    absolute offsets; duplicates (chaos dup, transparent RPC retries) are
    dropped by offset, and frames at or below the per-pair completion
    watermark (a late duplicate of an already-consumed message) are
    dropped entirely so they can never strand a stale buffer.
    """

    def __init__(self):
        self._cond = threading.Condition()
        self._msgs: Dict[tuple, dict] = {}
        self._watermark: Dict[tuple, int] = {}
        self._dead_nodes: set = set()
        # wire names of destroyed groups (insertion-ordered dict used as
        # a bounded set: a process that churns thousands of groups must
        # not grow this forever — evicting the OLDEST tombstone is safe,
        # its straggler frames have long since stopped arriving)
        self._closed: Dict[str, bool] = {}

    # runs on the core IO loop (sync RPC handler): dict updates + one
    # bounded memcpy per frame
    def deliver(self, body: dict) -> None:
        key = (body["group"], body["src"], body["seq"])
        with self._cond:
            if body["group"] in self._closed:
                return  # late frame for a destroyed group: drop, don't buffer
            if body["seq"] <= self._watermark.get(key[:2], -1):
                return
            ent = self._msgs.get(key)
            if ent is None:
                ent = {
                    "buf": bytearray(body["total"]),
                    "got": set(),
                    "remaining": body["total"],
                    "dtype": body["dtype"],
                    "shape": tuple(body["shape"]),
                }
                self._msgs[key] = ent
            off = body["offset"]
            if off in ent["got"]:
                return
            data = body["data"]
            ent["buf"][off:off + len(data)] = data
            ent["got"].add(off)
            ent["remaining"] -= len(data)
            if ent["remaining"] <= 0:
                self._cond.notify_all()

    def wait(self, group: str, src: int, seq: int, deadline: float,
             peer_node: str = "") -> np.ndarray:
        key = (group, src, seq)
        with self._cond:
            while True:
                if group in self._closed:
                    # a destroy with work in flight must unpark blocked
                    # waiters NOW, not after the full collective timeout
                    raise CollectiveError(
                        f"collective group {group!r} was destroyed while "
                        f"waiting for message {seq} from rank {src}")
                ent = self._msgs.get(key)
                if ent is not None and ent["remaining"] <= 0:
                    del self._msgs[key]
                    self._watermark[(group, src)] = seq
                    arr = np.frombuffer(
                        ent["buf"], dtype=np.dtype(ent["dtype"]))
                    return arr.reshape(ent["shape"])
                if peer_node and peer_node in self._dead_nodes:
                    raise CollectiveError(
                        f"collective group {group!r}: peer rank {src} is "
                        f"on dead node {peer_node[:12]}")
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    raise TimeoutError(
                        f"collective group {group!r}: timed out waiting "
                        f"for message {seq} from rank {src}")
                self._cond.wait(min(remaining, 0.5))

    def mark_node_dead(self, node_id_hex: str) -> None:
        with self._cond:
            self._dead_nodes.add(node_id_hex)
            self._cond.notify_all()

    def forget(self, group: str) -> None:
        """Drop this group's message state and tombstone the wire name so
        parked waiters raise instead of burning their full timeout (wire
        names are incarnation-suffixed — a re-created group never
        collides with its predecessor's tombstone)."""
        with self._cond:
            for key in [k for k in self._msgs if k[0] == group]:
                del self._msgs[key]
            for key in [k for k in self._watermark if k[0] == group]:
                del self._watermark[key]
            self._closed[group] = True
            while len(self._closed) > 256:
                self._closed.pop(next(iter(self._closed)))
            self._cond.notify_all()


_REGISTER_LOCK = threading.Lock()


def ensure_registered(core) -> _Inbox:
    """Install the p2p collective transport on this process's core worker
    (idempotent; safe under concurrent group inits from user threads —
    without the lock two racing callers could each build an _Inbox and
    one group would wait forever on the instance the handler never feeds).
    Workers do this at startup (`default_worker.main`); driver processes
    that join a group do it lazily at group init — a rank only publishes
    its address AFTER this ran, so no frame can ever arrive unroutable."""
    inbox = getattr(core, "_collective_inbox", None)
    if inbox is not None:
        return inbox
    with _REGISTER_LOCK:
        inbox = getattr(core, "_collective_inbox", None)
        if inbox is not None:
            return inbox
        inbox = _Inbox()

        def _collective_chunk(body):
            inbox.deliver(body)
            return True

        _collective_chunk._rpc_idempotent = True  # offset-keyed: dup safe
        core.server.register("collective_chunk", _collective_chunk)
        # a dead NODE fails ring waits immediately instead of burning the
        # full collective timeout (worker-level deaths still time out)
        core.node_death_hooks.append(
            lambda node_hex, addr: inbox.mark_node_dead(node_hex))
        core._collective_inbox = inbox
    return inbox


# -------------------------------------------------------------- transport


class P2PTransport:
    """Directed tensor messaging between the ranks of one group."""

    def __init__(self, core, wire_name: str, rank: int,
                 peers: Dict[int, dict], algo: str):
        self._core = core
        self._wire = wire_name
        self._rank = rank
        self._peers = peers
        self._algo = algo
        self._send_seq: Dict[int, int] = {}
        self._recv_seq: Dict[int, int] = {}
        self._inbox = ensure_registered(core)

    def send(self, dst: int, arr: np.ndarray, deadline: float) -> None:
        from ray_tpu_torch._private import rpc

        arr = np.ascontiguousarray(arr)
        data = memoryview(arr.reshape(-1)).cast("B")
        seq = self._send_seq.get(dst, 0)
        self._send_seq[dst] = seq + 1
        timeout = deadline - time.monotonic()
        if timeout <= 0:
            raise TimeoutError(
                f"collective group {self._wire!r}: send to rank {dst} "
                f"has no time budget left")
        cfg = self._core.config
        base = {"group": self._wire, "src": self._rank, "seq": seq,
                "total": data.nbytes, "dtype": arr.dtype.str,
                "shape": tuple(arr.shape)}
        client = self._core.clients.get(tuple(self._peers[dst]["addr"]))
        try:
            frames = self._core._run(
                rpc.call_chunked(
                    client, "collective_chunk", base, data,
                    chunk_bytes=cfg.collective_chunk_bytes,
                    window=cfg.collective_window, timeout=timeout),
                timeout=timeout + 10)
        except (TimeoutError, CollectiveError):
            raise
        except Exception as e:  # noqa: BLE001 — transport failure = peer gone
            raise CollectiveError(
                f"collective group {self._wire!r}: peer rank {dst} at "
                f"{tuple(self._peers[dst]['addr'])} unreachable: {e!r}"
            ) from e
        _metrics.chunks_total.inc(frames, labels=_metrics.labels(self._algo))
        _metrics.bytes_total.inc(data.nbytes, labels=_metrics.labels(self._algo))

    def recv(self, src: int, deadline: float) -> np.ndarray:
        seq = self._recv_seq.get(src, 0)
        self._recv_seq[src] = seq + 1
        return self._inbox.wait(
            self._wire, src, seq, deadline,
            peer_node=self._peers[src].get("node", ""))

    def close(self) -> None:
        self._inbox.forget(self._wire)


# ------------------------------------------------------------- ring group


def _seg_slices(n: int, world: int) -> List[slice]:
    """np.array_split boundaries over ``n`` flat elements."""
    base, extra = divmod(n, world)
    out, pos = [], 0
    for i in range(world):
        size = base + (1 if i < extra else 0)
        out.append(slice(pos, pos + size))
        pos += size
    return out


class RingGroup:
    """Cross-node collectives: ring reduce-scatter + allgather over the
    chunked p2p transport. The controller carried the rendezvous and
    nothing else — every tensor byte moves worker↔worker."""

    algo = "ring"

    def __init__(self, core, world_size: int, rank: int, wire_name: str,
                 peers: Dict[int, dict]):
        self.world_size = world_size
        self.rank = rank
        self._wire = wire_name
        self._t = P2PTransport(core, wire_name, rank, peers, self.algo)

    # neighbors
    @property
    def _right(self) -> int:
        return (self.rank + 1) % self.world_size

    @property
    def _left(self) -> int:
        return (self.rank - 1) % self.world_size

    def _deadline(self, timeout_ms: int) -> float:
        return time.monotonic() + timeout_ms / 1000.0

    def _check_incoming(self, incoming: np.ndarray, expect_size: int,
                        dtype, what: str) -> np.ndarray:
        """A mis-sized peer segment must be a clean error: numpy would
        happily BROADCAST a size-1 segment across a fold (a silently
        wrong sum), and silently cast a dtype mismatch."""
        if incoming.size != expect_size or incoming.dtype != dtype:
            raise CollectiveError(
                f"collective group {self._wire!r}: {what} from rank "
                f"{self._left} has size={incoming.size} "
                f"dtype={incoming.dtype}, expected size={expect_size} "
                f"dtype={dtype} — all ranks must pass same-shape, "
                f"same-dtype tensors")
        return incoming

    def allreduce(self, arr, op: ReduceOp, timeout_ms: int,
                  out: Optional[np.ndarray] = None) -> np.ndarray:
        """``out=`` is the result buffer and MAY alias ``arr`` (the ring
        already reduces in place over its working copy; donating the
        input just skips that copy)."""
        arr = np.asarray(arr)
        w, r = self.world_size, self.rank
        deadline = self._deadline(timeout_ms)
        src = np.ascontiguousarray(arr)
        if out is None:
            out = src.copy()
        else:
            _check_out(out, src)
            if out is not src:
                np.copyto(out.reshape(-1), src.reshape(-1))
        flat = out.reshape(-1)
        segs = _seg_slices(flat.size, w)
        fold = reduce_ufunc(op)
        with _metrics.round_timer(self.algo):
            # phase 1: reduce-scatter — after w-1 rounds rank r fully owns
            # segment (r+1) % w
            for t in range(w - 1):
                send_i = (r - t) % w
                recv_i = (r - t - 1) % w
                self._t.send(self._right, flat[segs[send_i]], deadline)
                incoming = self._check_incoming(
                    self._t.recv(self._left, deadline),
                    segs[recv_i].stop - segs[recv_i].start, out.dtype,
                    "reduce-scatter segment")
                seg = flat[segs[recv_i]]
                fold(seg, incoming, out=seg)
            # phase 2: allgather the reduced segments
            for t in range(w - 1):
                send_i = (r + 1 - t) % w
                recv_i = (r - t) % w
                self._t.send(self._right, flat[segs[send_i]], deadline)
                flat[segs[recv_i]] = self._check_incoming(
                    self._t.recv(self._left, deadline),
                    segs[recv_i].stop - segs[recv_i].start, out.dtype,
                    "allgather segment").reshape(-1)
        _metrics.ops_total.inc(labels=_metrics.labels(self.algo))
        if op is ReduceOp.MEAN:
            if np.issubdtype(out.dtype, np.inexact):
                np.divide(out, w, out=out)
                return out
            return (out / w).reshape(arr.shape)  # integer mean widens
        return out

    def reduce(self, arr, op: ReduceOp, root_rank: int, timeout_ms: int):
        out = self.allreduce(arr, op, timeout_ms)
        return out if self.rank == root_rank else np.asarray(arr)

    def broadcast(self, arr, root_rank: int, timeout_ms: int) -> np.ndarray:
        w, r = self.world_size, self.rank
        deadline = self._deadline(timeout_ms)
        with _metrics.round_timer(self.algo):
            if r == root_rank:
                out = np.asarray(arr)
                if w > 1:
                    self._t.send(self._right, out, deadline)
            else:
                # relay around the ring; the frame carries dtype/shape, so
                # non-root ranks need no local template tensor
                out = self._t.recv(self._left, deadline)
                if self._right != root_rank:
                    self._t.send(self._right, out, deadline)
        _metrics.ops_total.inc(labels=_metrics.labels(self.algo))
        return out

    def allgather(self, arr, timeout_ms: int) -> List[np.ndarray]:
        w, r = self.world_size, self.rank
        deadline = self._deadline(timeout_ms)
        pieces: List[Optional[np.ndarray]] = [None] * w
        pieces[r] = np.asarray(arr)
        with _metrics.round_timer(self.algo):
            for t in range(w - 1):
                self._t.send(self._right, pieces[(r - t) % w], deadline)
                pieces[(r - t - 1) % w] = self._t.recv(self._left, deadline)
        _metrics.ops_total.inc(labels=_metrics.labels(self.algo))
        return list(pieces)

    def reducescatter(self, arr, op: ReduceOp, timeout_ms: int) -> np.ndarray:
        """Real reduce-scatter: ONLY the reduce-scatter phase plus one
        hop to land each rank's own axis-0 split — O(N) per link, no
        full-tensor allgather tail."""
        w, r = self.world_size, self.rank
        if w == 1:
            return np.asarray(arr)
        deadline = self._deadline(timeout_ms)
        acc = np.ascontiguousarray(np.asarray(arr)).copy()
        segs = np.array_split(acc, w, axis=0)  # views into acc
        fold = reduce_ufunc(op)
        with _metrics.round_timer(self.algo):
            for t in range(w - 1):
                send_i = (r - t) % w
                recv_i = (r - t - 1) % w
                self._t.send(self._right, segs[send_i], deadline)
                incoming = self._check_incoming(
                    self._t.recv(self._left, deadline),
                    segs[recv_i].size, acc.dtype, "reducescatter segment")
                fold(segs[recv_i], incoming.reshape(segs[recv_i].shape),
                     out=segs[recv_i])
            # rank r now owns fully reduced segment (r+1) % w; its own
            # split (index r) is owned by its left neighbor — one hop
            self._t.send(self._right, segs[(r + 1) % w], deadline)
            mine = self._check_incoming(
                self._t.recv(self._left, deadline), segs[r].size,
                acc.dtype, "reducescatter result").reshape(segs[r].shape)
        _metrics.ops_total.inc(labels=_metrics.labels(self.algo))
        if op is ReduceOp.MEAN:
            return mine / w
        return mine

    def barrier(self, timeout_ms: int) -> None:
        self.allreduce(np.zeros((1,), np.float32), ReduceOp.SUM, timeout_ms)

    def send(self, arr, dst_rank: int, timeout_ms: int) -> None:
        self._t.send(dst_rank, np.asarray(arr), self._deadline(timeout_ms))

    def recv(self, src_rank: int, timeout_ms: int) -> np.ndarray:
        return self._t.recv(src_rank, self._deadline(timeout_ms))

    def destroy(self) -> None:
        self._t.close()
