"""Collective communication API between tasks/actors.

Counterpart: ``ray_tpu/util/collective/collective.py``. API shaped like the
reference's `ray.util.collective.collective`
(`python/ray/util/collective/collective.py:120-655`: init_collective_group,
create_collective_group, allreduce :258, reduce :311, broadcast :373,
allgather :423, reducescatter :472, send :531, recv :594, barrier):

  * backend "nccl": one torch.distributed ``ProcessGroupNCCL`` per
    collective group (``NcclGroup``), over a ``PrefixStore`` of a
    ``TCPStore`` that rank 0 opens and publishes in the controller KV. It
    takes and returns tensors on the worker's card; a group made with
    ``device="cpu"`` runs ``ProcessGroupGloo`` instead (only when asked:
    without a card or NCCL an "nccl" group raises). ``send``/``recv`` go
    over the host side-channel.
  * backend "host" (the reference's Gloo group): the controller is used
    for **group rendezvous only**; host arrays move peer-to-peer. Same-node
    groups reduce through pin-backed shared-memory channels
    (`collective/shm.py`: a steady-state allreduce issues ZERO
    control-plane RPCs), cross-node groups run ring reduce-scatter +
    allgather over direct worker-to-worker chunked RPCs
    (`collective/ring.py`). The controller-KV rounds survive as the
    explicit ``algo="kv"`` baseline. It takes numpy arrays and tensors on
    any device: a tensor comes back as a tensor of its dtype on its device,
    an array as an array (a bfloat16 tensor reduces in float32, and moves
    as its int16 bits where nothing is reduced; ``recv`` returns the host
    array).

Both imperative (`init_collective_group` inside each worker) and declarative
(`create_collective_group` from the driver over actor handles) setup are
supported, mirroring collective.py:120/:151.
"""

from __future__ import annotations

import logging
import os
import threading
import time
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from ray_tpu_torch.util.collective.types import (Backend, CollectiveError,
                                                 ReduceOp, check_inplace_out,
                                                 from_host, is_tensor,
                                                 to_host)

logger = logging.getLogger(__name__)

_KV_NS = "collective"


def _kv():
    from ray_tpu_torch._private import internal_kv

    return internal_kv


def _sweep_group_keys(group_name: str) -> None:
    """Best-effort delete of every wire key under ``{group_name}:`` (group
    teardown; the controller may already be gone at shutdown)."""
    kv = _kv()
    try:
        for k in kv.kv_keys(group_name + ":", ns=_KV_NS):
            kv.kv_del(k, ns=_KV_NS)
    except Exception:
        pass


def _node_ip() -> str:
    """This worker's address as its peers reach it: the host of its
    runtime RPC address (the ring dials the same one)."""
    from ray_tpu_torch._private.api import _require_core

    return str(_require_core().address[0])


def _default_bucket_bytes() -> int:
    try:
        from ray_tpu_torch._private.api import _require_core

        return _require_core().config.collective_coalesce_bytes
    except Exception:
        return 32 * 1024**2


def _overlap_enabled() -> bool:
    """The RAY_TPU_TORCH_COLLECTIVE_OVERLAP knob (config-backed; default
    on)."""
    try:
        from ray_tpu_torch._private.api import _require_core

        return bool(_require_core().config.collective_overlap)
    except Exception:
        from ray_tpu_torch._private.config import global_config

        return bool(global_config().collective_overlap)


# --------------------------------------------------------------------- groups


class BaseGroup:
    def __init__(self, world_size: int, rank: int, group_name: str):
        if not (0 <= rank < world_size):
            raise ValueError(f"rank {rank} out of range for world_size {world_size}")
        self.world_size = world_size
        self.rank = rank
        self.group_name = group_name
        self._public_name = group_name
        self._decl_gen = None  # set when created from declarative KV metadata

    def destroy(self) -> None:
        pass

    def allreduce_coalesced(
        self,
        tensors: Sequence[Any],
        op: ReduceOp,
        timeout_ms: int,
        bucket_bytes: Optional[int] = None,
        out: Optional[Sequence[Any]] = None,
    ) -> List[np.ndarray]:
        """Allreduce a LIST of tensors in same-dtype buckets: adjacent
        tensors pack into one flat vector per bucket (bounded by
        ``collective_coalesce_bytes``), so a gradient tree costs one
        collective round per bucket — not one per leaf, and not one
        monolithic ``np.concatenate`` copy of the whole tree either.
        The bucket reduces IN PLACE over its staging vector, a MEAN
        pre-scales into the pack copy (no post-reduce divide pass), and
        ``out=`` (persistent arrays, input shapes/dtypes) lands results
        without allocating. Returns reduced arrays with the input
        shapes, in input order: numpy arrays, the ``out=`` buffers, or
        (tensor inputs, no ``out=``) tensors like the inputs."""
        from ray_tpu_torch.util.collective.async_work import (bucket_layout,
                                                              host_out,
                                                              validate_out)
        from ray_tpu_torch.util.collective.types import prescale_factor

        likes = list(tensors)
        arrs = [to_host(t) for t in likes]
        if not arrs:
            return []
        out_objs, out = out, host_out(out)
        validate_out(arrs, op, out, self.world_size)
        if bucket_bytes is None:
            bucket_bytes = _default_bucket_bytes()
        results: List[Optional[np.ndarray]] = [None] * len(arrs)
        for bucket in bucket_layout(arrs, bucket_bytes):
            dtype = arrs[bucket[0]].dtype
            total = sum(arrs[i].size for i in bucket)
            vec = np.empty(total, dtype)
            scale = prescale_factor(op, dtype, self.world_size)
            off = 0
            for i in bucket:
                flat = np.ascontiguousarray(arrs[i]).reshape(-1)
                seg = vec[off:off + arrs[i].size]
                if scale is None:
                    seg[...] = flat
                else:
                    np.multiply(flat, scale, out=seg)
                off += arrs[i].size
            round_op = ReduceOp.SUM if op is ReduceOp.MEAN else op
            red = np.asarray(
                self.allreduce(vec, round_op, timeout_ms, out=vec))
            if op is ReduceOp.MEAN and scale is None:
                red = red / self.world_size  # integer mean fallback
            off = 0
            for i in bucket:
                seg = red[off:off + arrs[i].size].reshape(arrs[i].shape)
                if out is not None:
                    np.copyto(out[i], seg)
                    results[i] = out_objs[i]
                else:
                    results[i] = from_host(seg, likes[i])
                off += arrs[i].size
        return results  # type: ignore[return-value]

    def allreduce_coalesced_async(
        self,
        tensors: Sequence[Any],
        op: ReduceOp,
        timeout_ms: int,
        bucket_bytes: Optional[int] = None,
        out: Optional[Sequence[Any]] = None,
        overlap: Optional[bool] = None,
        on_bucket=None,
    ):
        """Async-handle form of :meth:`allreduce_coalesced`. The base
        implementation (nccl backend, and the explicit
        ``RAY_TPU_TORCH_COLLECTIVE_OVERLAP=0`` fallback on the host backend)
        runs synchronously and returns an already-completed handle —
        callers write one code path and the knob decides. ``on_bucket``
        (when given) still fires exactly once per bucket, on the
        caller's thread, in the runner's reverse-flatten order — the
        per-bucket contract holds on every path, only the overlap is
        lost."""
        from ray_tpu_torch.util.collective.async_work import (_CompletedWork,
                                                        fire_on_bucket,
                                                        validate_on_bucket)

        validate_on_bucket(on_bucket)
        results = self.allreduce_coalesced(tensors, op, timeout_ms,
                                           bucket_bytes, out=out)
        if on_bucket is not None and len(results):
            leaves = [t if is_tensor(t) or isinstance(t, np.ndarray)
                      else np.asarray(t) for t in tensors]
            fire_on_bucket(
                leaves,
                bucket_bytes if bucket_bytes is not None
                else _default_bucket_bytes(),
                results, on_bucket)
        return _CompletedWork(self._public_name, results)

    def _raise_if_stale(self) -> None:
        """After a timeout/peer failure on a declaratively-created group,
        distinguish 'the driver destroyed/re-created this group' from a
        plain peer problem. This runs ONLY on the failure path — the
        steady state never re-validates membership, so a healthy
        collective issues no control-plane RPCs for it."""
        if self._decl_gen is None:
            return
        meta = _kv().kv_get(f"decl:{self._public_name}", ns=_KV_NS)
        if meta is None or meta["gen"] != self._decl_gen:
            _manager.destroy(self._public_name)
            raise RuntimeError(
                f"collective group {self._public_name!r} was destroyed or "
                f"re-created by the driver while this rank was using it; "
                f"retry the collective to join the new generation")


def _reduce_fn(op: ReduceOp):
    return {
        ReduceOp.SUM: lambda a: a.sum(axis=0),
        ReduceOp.MEAN: lambda a: a.mean(axis=0),
        ReduceOp.PRODUCT: lambda a: a.prod(axis=0),
        ReduceOp.MAX: lambda a: a.max(axis=0),
        ReduceOp.MIN: lambda a: a.min(axis=0),
    }[op]


class _SoloGroup:
    """world_size == 1: every collective is the identity, locally."""

    algo = "solo"

    def allreduce(self, arr, op, timeout_ms, out=None):
        if out is not None:
            src = np.asarray(arr)
            check_inplace_out(out, src)
            if out is not src:
                np.copyto(out.reshape(src.shape), src)
            return out
        return np.array(arr, copy=True)

    def reduce(self, arr, op, root_rank, timeout_ms):
        return np.array(arr, copy=True)

    def broadcast(self, arr, root_rank, timeout_ms):
        return np.asarray(arr)

    def allgather(self, arr, timeout_ms):
        return [np.asarray(arr)]

    def reducescatter(self, arr, op, timeout_ms):
        return np.array_split(np.asarray(arr), 1, axis=0)[0]

    def barrier(self, timeout_ms):
        pass

    def send(self, arr, dst_rank, timeout_ms):
        raise RuntimeError("send/recv needs world_size > 1")

    def recv(self, src_rank, timeout_ms):
        raise RuntimeError("send/recv needs world_size > 1")

    def destroy(self):
        pass


class KvGroup:
    """Legacy control-plane collectives over the controller KV.

    Kept as the explicit ``algo="kv"`` baseline (the `collective_speedup`
    microbench probe compares the p2p data plane against it) and as the
    fallback when no peer data plane is possible. Every rank's full
    tensor transits the controller — O(N·world) through one socket; the
    payload cap (`RAY_TPU_TORCH_KV_MAX_VALUE_BYTES`) bounds the damage.

    Protocol: every collective call gets a per-group sequence number (all
    ranks call collectives in the same order — the standard requirement).
    Ranks post contributions under ``{group}:{seq}:c:{rank}``; rank 0
    reduces and posts ``{group}:{seq}:r``; ranks poll for the result.
    Rank 0 deletes the previous call's result right before posting the
    next one — safe, because holding every contribution of call N implies
    every rank has read the result of call N-1. The FINAL round's result
    key is reaped by a deferred sweep (one timer per group) once the
    call's timeout window has passed, so a long-lived idle group leaks
    nothing even without ``destroy()``.
    """

    algo = "kv"

    def __init__(self, world_size: int, rank: int, group_name: str):
        self.world_size = world_size
        self.rank = rank
        self.group_name = group_name
        self._seq = 0
        self._p2p_seq: Dict[tuple, int] = {}
        self._sweeper: Optional[threading.Timer] = None
        self._destroyed = False

    # ----- kv plumbing

    def _key(self, seq: int, kind: str, rank: Optional[int] = None) -> str:
        k = f"{self.group_name}:{seq}:{kind}"
        return k if rank is None else f"{k}:{rank}"

    def _poll(self, key: str, timeout_ms: int, delete: bool = False):
        kv = _kv()
        deadline = time.monotonic() + timeout_ms / 1000.0
        pause = 0.001
        while True:
            val = kv.kv_get(key, ns=_KV_NS)
            if val is not None:
                if delete:
                    kv.kv_del(key, ns=_KV_NS)
                return val
            if time.monotonic() > deadline:
                raise TimeoutError(
                    f"collective group {self.group_name!r} rank {self.rank}: "
                    f"timed out waiting for {key!r}"
                )
            time.sleep(pause)
            pause = min(pause * 1.5, 0.05)

    def _schedule_sweep(self, seq: int, timeout_ms: int) -> None:
        """Rank 0 only: reap ``{seq}:r`` after the call's timeout window
        if no newer round superseded it (at that point every other rank
        has either read the result or timed out — deleting is safe)."""
        if self._sweeper is not None:
            self._sweeper.cancel()

        def sweep() -> None:
            if self._destroyed or self._seq != seq + 1:
                return
            try:
                _kv().kv_del(self._key(seq, "r"), ns=_KV_NS)
            except Exception:
                pass  # controller may be gone at shutdown

        t = threading.Timer(max(1.0, timeout_ms / 1000.0), sweep)
        t.daemon = True
        t.start()
        self._sweeper = t

    def _round(self, payload, combine, timeout_ms: int):
        """One gather-to-root + broadcast round; returns the combined result."""
        kv = _kv()
        seq, self._seq = self._seq, self._seq + 1
        if self.rank == 0:
            # rank 0 is the reducer: its own contribution never needs to
            # transit the controller — use the local payload in place.
            parts = [
                payload if r == 0 else
                self._poll(self._key(seq, "c", r), timeout_ms, delete=True)
                for r in range(self.world_size)
            ]
            result = combine(parts)
            if seq > 0:
                kv.kv_del(self._key(seq - 1, "r"), ns=_KV_NS)
            kv.kv_put(self._key(seq, "r"), result, ns=_KV_NS)
            self._schedule_sweep(seq, timeout_ms)
            return result
        kv.kv_put(self._key(seq, "c", self.rank), payload, ns=_KV_NS)
        return self._poll(self._key(seq, "r"), timeout_ms)

    # ----- ops

    def allreduce(self, arr: np.ndarray, op: ReduceOp, timeout_ms: int,
                  out: Optional[np.ndarray] = None) -> np.ndarray:
        from ray_tpu_torch.util.collective import _metrics

        fn = _reduce_fn(op)
        with _metrics.round_timer(self.algo):
            red = self._round(
                np.asarray(arr), lambda parts: fn(np.stack(parts)), timeout_ms
            )
        _metrics.ops_total.inc(labels=_metrics.labels(self.algo))
        _metrics.bytes_total.inc(np.asarray(arr).nbytes,
                                 labels=_metrics.labels(self.algo))
        if out is not None:
            red = np.asarray(red)
            check_inplace_out(out, red)
            np.copyto(out.reshape(red.shape), red)
            return out
        return red

    def reduce(self, arr, op: ReduceOp, root_rank: int, timeout_ms: int):
        out = self.allreduce(arr, op, timeout_ms)
        return out if self.rank == root_rank else np.asarray(arr)

    def broadcast(self, arr, root_rank: int, timeout_ms: int):
        # Non-root ranks post a tiny marker instead of their full tensor: only
        # root's contribution is used, and the marker still upholds the
        # deletion-protocol barrier.
        payload = np.asarray(arr) if self.rank == root_rank else 0
        return self._round(payload, lambda parts: parts[root_rank], timeout_ms)

    def allgather(self, arr, timeout_ms: int) -> List[np.ndarray]:
        return self._round(np.asarray(arr), lambda parts: list(parts), timeout_ms)

    def reducescatter(self, arr, op: ReduceOp, timeout_ms: int) -> np.ndarray:
        full = self.allreduce(arr, op, timeout_ms)
        return np.array_split(full, self.world_size, axis=0)[self.rank]

    def barrier(self, timeout_ms: int) -> None:
        self._round(0, lambda parts: 0, timeout_ms)

    def send(self, arr, dst_rank: int, timeout_ms: int) -> None:
        key = (self.rank, dst_rank)
        seq = self._p2p_seq.get(key, 0)
        self._p2p_seq[key] = seq + 1
        _kv().kv_put(
            f"{self.group_name}:p2p:{self.rank}>{dst_rank}:{seq}",
            np.asarray(arr),
            ns=_KV_NS,
        )

    def recv(self, src_rank: int, timeout_ms: int) -> np.ndarray:
        key = (src_rank, self.rank)
        seq = self._p2p_seq.get(key, 0)
        self._p2p_seq[key] = seq + 1
        return self._poll(
            f"{self.group_name}:p2p:{src_rank}>{self.rank}:{seq}",
            timeout_ms,
            delete=True,
        )

    def destroy(self) -> None:
        self._destroyed = True
        if self._sweeper is not None:
            self._sweeper.cancel()
        _sweep_group_keys(self.group_name)


class HostGroup(BaseGroup):
    """Host-backend facade: one controller-KV rendezvous, then a
    peer-to-peer data plane.

    The data-path algorithm resolves lazily on the first collective call
    (by then every rank has initialized, so the rendezvous completes):

      * ``shm``  — every rank on one node: pin-backed shared-memory
        channel rounds, zero steady-state control-plane RPCs;
      * ``ring`` — ranks span nodes: ring reduce-scatter + allgather over
        chunked direct worker↔worker RPCs;
      * ``kv``   — the legacy controller-KV rounds (explicit opt-in /
        comparison baseline);
      * ``auto`` (default) — shm when possible, else ring.

    Force one via ``RAY_TPU_TORCH_COLLECTIVE_ALGO`` or the ``algo=`` argument
    of ``init_collective_group``.
    """

    def __init__(self, world_size: int, rank: int, group_name: str,
                 *, algo: Optional[str] = None):
        super().__init__(world_size, rank, group_name)
        self._algo_override = algo
        self._impl = None
        self._impl_lock = threading.Lock()
        self._poisoned: Optional[str] = None
        self._runner = None  # async overlap runner, built on first use
        # publish this rank's rendezvous record EAGERLY (best-effort): a
        # peer's send/recv must be able to reach a rank that initialized
        # the group but has not yet issued a collective of its own —
        # otherwise pairwise p2p would hang waiting on bystander ranks
        if world_size > 1 and (algo or "").lower() != "kv":
            try:
                self._publish_rendezvous()
            except Exception:
                logger.debug("eager collective rendezvous publish failed "
                             "(will retry on first use)", exc_info=True)

    def _publish_rendezvous(self) -> dict:
        from ray_tpu_torch._private.api import _require_core
        from ray_tpu_torch.util.collective import ring as _ring_mod

        core = _require_core()
        # handlers register BEFORE the address goes public, so no peer
        # frame can ever arrive unroutable
        _ring_mod.ensure_registered(core)
        me = {"addr": list(core.address), "node": core.node_id_hex,
              "client": core._store_client_id}
        if self.rank == 0:
            # Rank 0 mints a per-incarnation token that every rank folds
            # into the transport wire name: a destroy + re-init of the SAME
            # imperative group name gets fresh inbox keys and fresh shm
            # channel-spec KV keys, so a chaos-delayed duplicate frame (or
            # a stale channel record) from the previous incarnation can
            # never be mistaken for this one's data. (Declarative groups
            # already get this from their gen-suffixed wire name.)
            if not hasattr(self, "_rv_token"):
                self._rv_token = os.urandom(8).hex()
            me["token"] = self._rv_token
        _kv().kv_put(f"{self.group_name}:rv:{self.rank}", me, ns=_KV_NS)
        return me

    @property
    def algo(self) -> str:
        """Resolved data-path algorithm ('' until the first collective)."""
        return self._impl.algo if self._impl is not None else ""

    def _impl_for(self, timeout_ms: int):
        if self._impl is not None:
            return self._impl
        with self._impl_lock:
            if self._impl is None:
                self._impl = self._resolve_impl(timeout_ms)
        return self._impl

    def _resolve_impl(self, timeout_ms: int):
        from ray_tpu_torch._private.api import _require_core
        from ray_tpu_torch.util.collective import ring as _ring_mod
        from ray_tpu_torch.util.collective import shm as _shm_mod

        if self.world_size == 1:
            return _SoloGroup()
        core = _require_core()
        algo = (self._algo_override or core.config.collective_algo
                or "auto").lower()
        if algo == "kv":
            return KvGroup(self.world_size, self.rank, self.group_name)
        if algo not in ("auto", "shm", "ring"):
            raise ValueError(
                f"unknown collective algo {algo!r}; use auto/shm/ring/kv")
        # rendezvous: (re-)publish this rank's worker RPC address + node
        # identity; the controller carries these few hundred bytes and
        # never a tensor.
        me = self._publish_rendezvous()
        deadline = time.monotonic() + max(1.0, timeout_ms / 1000.0)
        peers: Dict[int, dict] = {self.rank: me}
        for p in range(self.world_size):
            if p == self.rank:
                continue
            peers[p] = _kv().kv_wait(
                f"{self.group_name}:rv:{p}",
                timeout=max(0.1, deadline - time.monotonic()),
                ns=_KV_NS)
        same_node = bool(core.node_id_hex) and all(
            peers[p]["node"] == core.node_id_hex for p in peers)
        # rank 0's incarnation token keys the data plane (see
        # _publish_rendezvous); every rank read the same rv:0 record, so
        # every rank derives the same wire name
        wire = f"{self.group_name}#{peers[0].get('token', '')}"
        if algo == "auto":
            from ray_tpu_torch._private.channels import MAX_READERS

            shm_ok = (same_node and core.arena is not None
                      and self.world_size - 1 <= MAX_READERS)
            algo = "shm" if shm_ok else "ring"
        if algo == "shm":
            if not same_node:
                raise CollectiveError(
                    f"collective group {self.group_name!r}: algo 'shm' "
                    f"forced but ranks span nodes — use 'ring' or 'auto'")
            if core.arena is None:
                raise CollectiveError(
                    f"collective group {self.group_name!r}: algo 'shm' "
                    f"forced but this process has no node arena mapping — "
                    f"use 'ring' or 'auto'")
            # no silent ring fallback on a setup failure: the algo choice
            # above is a pure function of the rendezvous records, so every
            # rank picks the same one — a per-rank fallback would leave
            # this rank ringing while its peers sit on channels (mutual
            # timeout at best, and the failure deserves to be loud anyway)
            return _shm_mod.ShmGroup(
                core, self.world_size, self.rank, wire, peers, timeout_ms)
        return _ring_mod.RingGroup(
            core, self.world_size, self.rank, wire, peers)

    # ----- async overlap runner

    def _ensure_runner(self):
        from ray_tpu_torch.util.collective.async_work import AsyncRunner

        if self._runner is not None:
            # fast path OUTSIDE the lock: the reducer thread holds
            # _impl_lock for the whole first rendezvous — a submit during
            # that round must still return immediately
            return self._runner
        with self._impl_lock:
            if self._runner is None:
                self._runner = AsyncRunner(self)
        return self._runner

    def allreduce_coalesced_async(
        self,
        tensors: Sequence[Any],
        op: ReduceOp,
        timeout_ms: int,
        bucket_bytes: Optional[int] = None,
        out: Optional[Sequence[Any]] = None,
        overlap: Optional[bool] = None,
        on_bucket=None,
    ):
        """Overlapped coalesced allreduce: returns a ``CollectiveWork``
        immediately; the group's runner pipelines per-bucket device->host
        transfers against shm/ring reduce rounds. ``on_bucket(indices,
        arrays)`` fires on the runner's reducer thread the moment each
        bucket's reduce lands — per-bucket downstream work (e.g. a
        fused optimizer apply) overlaps the remaining buckets' rounds.
        ``overlap=False`` (or ``RAY_TPU_TORCH_COLLECTIVE_OVERLAP=0``) takes
        the synchronous path and returns an already-completed handle."""
        if overlap is None:
            overlap = _overlap_enabled()
        if not overlap or self.world_size == 1:
            return super().allreduce_coalesced_async(
                tensors, op, timeout_ms, bucket_bytes, out=out,
                on_bucket=on_bucket)
        from ray_tpu_torch.util.collective.async_work import validate_on_bucket

        validate_on_bucket(on_bucket)
        if self._poisoned is not None:
            # same staleness-first remedy as the sync path: a driver
            # re-create of this declarative group drops the cached member
            self._raise_if_stale()
            raise CollectiveError(
                f"collective group {self._public_name!r} is poisoned by an "
                f"earlier failure ({self._poisoned}); destroy and re-create "
                f"the group")
        if bucket_bytes is None:
            bucket_bytes = _default_bucket_bytes()
        return self._ensure_runner().submit(
            tensors, op, timeout_ms, bucket_bytes, out, on_bucket=on_bucket)

    # ----- delegated ops (stale-generation check on the failure path)

    def _delegate(self, timeout_ms: int, fn):
        if self._runner is not None:
            # sync ops order AFTER in-flight async work on every rank —
            # the transport must see one identical op sequence everywhere
            self._runner.flush(max(1.0, timeout_ms / 1000.0))
        if self._poisoned is not None:
            # staleness first: if the driver already destroyed and
            # re-created this declarative group (the documented remedy for
            # a poisoned group), _raise_if_stale drops the cached member so
            # the next call joins the new generation instead of raising
            # 'poisoned' forever
            self._raise_if_stale()
            raise CollectiveError(
                f"collective group {self._public_name!r} is poisoned by an "
                f"earlier failure ({self._poisoned}); destroy and re-create "
                f"the group")
        impl = self._impl_for(timeout_ms)
        try:
            return fn(impl)
        except (TimeoutError, CollectiveError) as e:
            # A mid-collective failure can leave per-pair sequence counters
            # (ring inbox) or seqlock versions (shm channels) out of step
            # with what peers actually committed; a RETRIED collective could
            # then consume a stale round as fresh data. Poison the group so
            # every later call fails clean — never a silently wrong sum.
            self._poisoned = f"{type(e).__name__}: {e}"
            self._raise_if_stale()
            raise
        except Exception as e:  # noqa: BLE001 — e.g. a shape ValueError
            # ANY exception escaping mid-op may have advanced transport
            # state already (segments sent, versions bumped) — same poison,
            # same reason
            self._poisoned = f"{type(e).__name__}: {e}"
            raise

    def allreduce(self, arr, op: ReduceOp, timeout_ms: int,
                  out: Optional[np.ndarray] = None):
        src = to_host(arr)
        return from_host(self._delegate(
            timeout_ms, lambda g: g.allreduce(src, op, timeout_ms, out=out)),
            arr)

    def reduce(self, arr, op: ReduceOp, root_rank: int, timeout_ms: int):
        src = to_host(arr)
        return from_host(self._delegate(
            timeout_ms, lambda g: g.reduce(src, op, root_rank, timeout_ms)),
            arr)

    def broadcast(self, arr, root_rank: int, timeout_ms: int):
        src = to_host(arr, bits=True)
        return from_host(self._delegate(
            timeout_ms, lambda g: g.broadcast(src, root_rank, timeout_ms)),
            arr)

    def allgather(self, arr, timeout_ms: int) -> List[Any]:
        src = to_host(arr, bits=True)
        return [from_host(x, arr) for x in self._delegate(
            timeout_ms, lambda g: g.allgather(src, timeout_ms))]

    def reducescatter(self, arr, op: ReduceOp, timeout_ms: int):
        src = to_host(arr)
        return from_host(self._delegate(
            timeout_ms, lambda g: g.reducescatter(src, op, timeout_ms)), arr)

    def barrier(self, timeout_ms: int) -> None:
        self._delegate(timeout_ms, lambda g: g.barrier(timeout_ms))

    def send(self, arr, dst_rank: int, timeout_ms: int) -> None:
        src = to_host(arr, bits=True)
        self._delegate(
            timeout_ms, lambda g: g.send(src, dst_rank, timeout_ms))

    def recv(self, src_rank: int, timeout_ms: int) -> np.ndarray:
        return self._delegate(
            timeout_ms, lambda g: g.recv(src_rank, timeout_ms))

    def destroy(self) -> None:
        if self._runner is not None:
            # fail in-flight handles FIRST; the transport teardown below
            # is what unblocks a reducer parked mid-round
            try:
                self._runner.shutdown()
            except Exception:
                logger.debug("collective runner shutdown failed",
                             exc_info=True)
        if self._impl is not None:
            try:
                self._impl.destroy()
            except Exception:
                logger.debug("collective impl destroy failed", exc_info=True)
        _sweep_group_keys(self.group_name)


class NcclGroup(BaseGroup):
    """Device-plane collectives: one torch.distributed process group per
    collective group, in place of the JAX package's ``XlaGroup``.

    Rank 0 opens a ``TCPStore`` and publishes its address in the
    controller KV under ``{group}:coordinator`` (as ``XlaGroup`` publishes
    its coordinator); every rank builds its own ``ProcessGroupNCCL`` over a
    ``PrefixStore(group_name, store)``. The process-global default group
    (``init_process_group``) is never touched, so two groups in one worker
    (``train_grads`` beside ``TorchConfig``'s process group) do not
    collide. Tensors in and out live on the worker's card (numpy arrays
    are moved there first). ``device="cpu"`` builds ``ProcessGroupGloo``
    over CPU tensors instead; it is used only when asked for: a group on
    the card without a card or without NCCL raises, it never drops to
    gloo. ``send``/``recv`` go over a host group side-channel, as
    ``XlaGroup``'s do. A timeout is the group's (``timeout_ms`` at
    creation), not a call's."""

    def __init__(
        self,
        world_size: int,
        rank: int,
        group_name: str,
        *,
        device: Optional[str] = None,
        timeout_ms: int = 300_000,
    ):
        super().__init__(world_size, rank, group_name)
        import datetime

        import torch
        import torch.distributed as dist

        if device is not None and str(device) == "cpu":
            self.device = torch.device("cpu")
            self.backend = "gloo"
        else:
            if not torch.cuda.is_available():
                raise CollectiveError(
                    f"collective group {group_name!r}: backend 'nccl' needs "
                    f"a CUDA card and this process sees none "
                    f"(CUDA_VISIBLE_DEVICES="
                    f"{os.environ.get('CUDA_VISIBLE_DEVICES')!r}); lease "
                    f"the worker with num_gpus=1, or ask for device='cpu'")
            if not (dist.is_available() and dist.is_nccl_available()):
                raise CollectiveError(
                    f"collective group {group_name!r}: this torch has no "
                    f"NCCL (torch.distributed.is_nccl_available() is "
                    f"False)")
            self.device = torch.device(
                device if device is not None else
                f"cuda:{torch.cuda.current_device()}")
            self.backend = "nccl"
        timeout = datetime.timedelta(milliseconds=timeout_ms)
        coord_key = f"{group_name}:coordinator"
        if rank == 0:
            self._store = dist.TCPStore(
                _node_ip(), 0, world_size, True, timeout=timeout,
                wait_for_workers=False)
            _kv().kv_put(coord_key, f"{_node_ip()}:{self._store.port}",
                         ns=_KV_NS)
        else:
            addr = _kv().kv_wait(coord_key, timeout=timeout_ms / 1000.0,
                                 ns=_KV_NS)
            host, port = addr.rsplit(":", 1)
            self._store = dist.TCPStore(host, int(port), world_size, False,
                                        timeout=timeout)
        store = dist.PrefixStore(group_name, self._store)
        if self.backend == "nccl":
            opts = dist.ProcessGroupNCCL.Options()
            opts._timeout = timeout
            self._pg = dist.ProcessGroupNCCL(store, rank, world_size, opts)
        else:
            self._pg = dist.ProcessGroupGloo(store, rank, world_size,
                                             timeout)
        self._dist = dist
        self._host = (HostGroup(world_size, rank, group_name + ":p2p")
                      if world_size > 1 else None)

    # ----- tensors

    def _tensor(self, arr):
        import torch

        return torch.as_tensor(arr).to(self.device)

    def _op(self, op: ReduceOp):
        R = self._dist.ReduceOp
        if op is ReduceOp.MEAN:
            # NCCL averages itself (one pre-scaled sum); gloo sums and the
            # caller divides
            return R.AVG if self.backend == "nccl" else R.SUM
        return {ReduceOp.SUM: R.SUM, ReduceOp.PRODUCT: R.PRODUCT,
                ReduceOp.MAX: R.MAX, ReduceOp.MIN: R.MIN}[op]

    def _allreduce_(self, t, op: ReduceOp):
        """In place on ``t``; returns ``t`` (a float copy for an integer
        MEAN, which widens as the host group's does)."""
        opts = self._dist.AllreduceOptions()
        opts.reduceOp = self._op(op)
        if op is ReduceOp.MEAN and not t.is_floating_point():
            opts.reduceOp = self._dist.ReduceOp.SUM
            self._pg.allreduce([t], opts).wait()
            return t.double() / self.world_size
        self._pg.allreduce([t], opts).wait()
        if op is ReduceOp.MEAN and self.backend != "nccl":
            t.div_(self.world_size)
        return t

    # ----- ops

    def allreduce(self, arr, op: ReduceOp, timeout_ms: int,
                  out: Optional[Any] = None):
        red = self._allreduce_(self._tensor(arr).clone(), op)
        if out is not None:
            out.copy_(red.reshape(out.shape))
            return out
        return red

    def allreduce_coalesced(
        self,
        tensors: Sequence[Any],
        op: ReduceOp,
        timeout_ms: int,
        bucket_bytes: Optional[int] = None,
        out: Optional[Sequence[Any]] = None,
    ) -> List[Any]:
        """On the card: adjacent same-dtype tensors ``cat`` into one flat
        bucket (bounded by ``bucket_bytes``), one allreduce per bucket, the
        results views of the reduced bucket (or copied into ``out=``)."""
        import torch

        from ray_tpu_torch.util.collective.async_work import bucket_layout

        ts = [self._tensor(t) for t in tensors]
        if not ts:
            return []
        if out is not None and len(out) != len(ts):
            raise ValueError(
                f"out has {len(out)} tensors for {len(ts)} tensors")
        if bucket_bytes is None:
            bucket_bytes = _default_bucket_bytes()
        results: List[Any] = [None] * len(ts)
        for bucket in bucket_layout(ts, bucket_bytes,
                                    dtype_of=lambda t: t.dtype):
            flat = torch.cat([ts[i].reshape(-1) for i in bucket])
            red = self._allreduce_(flat, op)
            off = 0
            for i in bucket:
                n = ts[i].numel()
                seg = red[off:off + n].view(ts[i].shape)
                if out is not None:
                    out[i].copy_(seg)
                    results[i] = out[i]
                else:
                    results[i] = seg
                off += n
        return results

    def reduce(self, arr, op: ReduceOp, root_rank: int, timeout_ms: int):
        red = self.allreduce(arr, op, timeout_ms)
        return red if self.rank == root_rank else self._tensor(arr)

    def broadcast(self, arr, root_rank: int, timeout_ms: int):
        """Every rank passes a tensor of the root's shape and dtype (NCCL
        moves bytes into buffers it is given)."""
        t = self._tensor(arr).clone()
        opts = self._dist.BroadcastOptions()
        opts.rootRank = root_rank
        self._pg.broadcast([t], opts).wait()
        return t

    def allgather(self, arr, timeout_ms: int) -> List[Any]:
        import torch

        t = self._tensor(arr).contiguous()
        outs = [torch.empty_like(t) for _ in range(self.world_size)]
        self._pg.allgather([outs], [t]).wait()
        return outs

    def reducescatter(self, arr, op: ReduceOp, timeout_ms: int):
        """Axis-0 ``tensor_split`` of the allreduce, this rank's part (as
        ``XlaGroup`` computes it; splits may be uneven)."""
        full = self.allreduce(arr, op, timeout_ms)
        return full.tensor_split(self.world_size, dim=0)[self.rank].clone()

    def barrier(self, timeout_ms: int) -> None:
        import torch

        self._allreduce_(torch.zeros(1, device=self.device), ReduceOp.SUM)

    def send(self, arr, dst_rank: int, timeout_ms: int) -> None:
        if self._host is None:
            raise RuntimeError("send/recv needs world_size > 1")
        self._host.send(arr, dst_rank, timeout_ms)

    def recv(self, src_rank: int, timeout_ms: int):
        if self._host is None:
            raise RuntimeError("send/recv needs world_size > 1")
        return self._tensor(self._host.recv(src_rank, timeout_ms))

    def destroy(self) -> None:
        if self._host is not None:
            self._host.destroy()
        shutdown = getattr(self._pg, "shutdown", None)
        if shutdown is not None:
            try:
                shutdown()
            except Exception:
                logger.debug("process group shutdown failed", exc_info=True)
        self._pg = None
        self._store = None
        try:
            _kv().kv_del(f"{self.group_name}:coordinator", ns=_KV_NS)
        except Exception:
            pass


# ------------------------------------------------------------- group manager


class GroupManager:
    def __init__(self):
        self._groups: Dict[str, BaseGroup] = {}
        self._lock = threading.Lock()

    def create(
        self,
        backend: Backend,
        world_size: int,
        rank: int,
        name: str,
        *,
        public_name: Optional[str] = None,
        algo: Optional[str] = None,
        device: Optional[str] = None,
    ) -> BaseGroup:
        """`name` keys the wire protocol (KV keys); `public_name` (default:
        same) keys the local registry callers look groups up by. ``algo``
        is the host backend's, ``device`` the nccl backend's."""
        with self._lock:
            key = public_name or name
            if key in self._groups:
                raise RuntimeError(f"collective group {key!r} already initialized")
            if backend is Backend.HOST:
                group: BaseGroup = HostGroup(world_size, rank, name,
                                             algo=algo)
            else:
                group = NcclGroup(world_size, rank, name, device=device)
            group._public_name = key
            self._groups[key] = group
            return group

    def get(self, name: str) -> Optional[BaseGroup]:
        with self._lock:
            return self._groups.get(name)

    def destroy(self, name: str) -> None:
        with self._lock:
            group = self._groups.pop(name, None)
        if group is not None:
            group.destroy()


_manager = GroupManager()


def _resolve_group(group_name: str) -> BaseGroup:
    group = _manager.get(group_name)
    if group is not None:
        # Steady state: trust the cached group — no per-call KV round-trip
        # (a stale declarative generation surfaces as a timeout whose
        # failure path re-validates via BaseGroup._raise_if_stale; wire
        # keys are generation-suffixed, so cross-generation traffic can
        # never silently mix).
        return group
    # Declarative path (≈ collective.py:151): the driver stored group metadata
    # in the controller KV keyed by group name; resolve our rank by actor id.
    meta = _kv().kv_get(f"decl:{group_name}", ns=_KV_NS)
    if meta is None:
        raise RuntimeError(
            f"collective group {group_name!r} is not initialized in this "
            "process; call init_collective_group or create_collective_group"
        )
    from ray_tpu_torch._private.api import get_runtime_context

    my_actor = get_runtime_context().actor_id
    if my_actor is None or my_actor not in meta["actor_ids"]:
        raise RuntimeError(
            f"this process is not a member of collective group {group_name!r}"
        )
    rank = meta["ranks"][meta["actor_ids"].index(my_actor)]
    group = _manager.create(
        Backend.parse(meta["backend"]),
        meta["world_size"],
        rank,
        # Key the wire protocol by generation so a stale member erring out is
        # a timeout, never a silent cross-generation mix.
        f"{group_name}@{meta['gen']}",
        public_name=group_name,
    )
    group._decl_gen = meta["gen"]
    return group


# ------------------------------------------------------------- public API


def init_collective_group(
    world_size: int,
    rank: int,
    backend: str = "host",
    group_name: str = "default",
    *,
    algo: Optional[str] = None,
    device: Optional[str] = None,
) -> None:
    """Imperative init, called inside each participating task/actor
    (≈ collective.py:120). ``algo`` (host backend only) forces the data
    path: auto/shm/ring/kv — default ``RAY_TPU_TORCH_COLLECTIVE_ALGO``.
    ``device`` (nccl backend only): the worker's card by default;
    ``"cpu"`` runs the group's process group on gloo over CPU tensors."""
    _manager.create(Backend.parse(backend), world_size, rank, group_name,
                    algo=algo, device=device)


def create_collective_group(
    actors: Sequence[Any],
    world_size: int,
    ranks: Sequence[int],
    backend: str = "host",
    group_name: str = "default",
) -> None:
    """Declarative init from the driver over actor handles
    (≈ collective.py:151): stores membership in the controller KV; each actor
    resolves its rank lazily on its first collective call."""
    if len(actors) != len(ranks) or len(actors) != world_size:
        raise ValueError("need exactly world_size actors and ranks")
    if sorted(ranks) != list(range(world_size)):
        raise ValueError(f"ranks must be a permutation of 0..{world_size - 1}")
    actor_ids = [a._actor_id.hex() for a in actors]
    # The generation counter lives under its own key that destroy_* never
    # deletes: re-creating a destroyed group must still advance the gen, or
    # stale members (and their leftover wire keys from the old generation)
    # would silently mix into the new group.
    prev_gen = _kv().kv_get(f"declgen:{group_name}", ns=_KV_NS)
    gen = (prev_gen + 1) if prev_gen is not None else 0
    _kv().kv_put(f"declgen:{group_name}", gen, ns=_KV_NS)
    _kv().kv_put(
        f"decl:{group_name}",
        {
            "world_size": world_size,
            "ranks": list(ranks),
            "backend": str(Backend.parse(backend).value),
            "actor_ids": actor_ids,
            "gen": gen,
        },
        ns=_KV_NS,
    )


def is_group_initialized(group_name: str = "default") -> bool:
    return _manager.get(group_name) is not None


def destroy_collective_group(group_name: str = "default") -> None:
    _manager.destroy(group_name)
    try:
        _kv().kv_del(f"decl:{group_name}", ns=_KV_NS)
    except Exception:
        pass


def get_rank(group_name: str = "default") -> int:
    return _resolve_group(group_name).rank


def get_collective_group_size(group_name: str = "default") -> int:
    return _resolve_group(group_name).world_size


DEFAULT_TIMEOUT_MS = 30000


def allreduce(
    tensor,
    group_name: str = "default",
    op: ReduceOp = ReduceOp.SUM,
    timeout_ms: int = DEFAULT_TIMEOUT_MS,
):
    """Allreduce across the group (returns the reduced array; ≈ collective.py:258)."""
    return _resolve_group(group_name).allreduce(tensor, op, timeout_ms)


def allreduce_coalesced(
    tensors: Sequence[Any],
    group_name: str = "default",
    op: ReduceOp = ReduceOp.SUM,
    timeout_ms: int = DEFAULT_TIMEOUT_MS,
    bucket_bytes: Optional[int] = None,
    out: Optional[Sequence[Any]] = None,
) -> List[np.ndarray]:
    """Allreduce a list of tensors in same-dtype buckets (one collective
    round per bucket). The bucketed twin of torch's
    ``allreduce_coalesced`` — what ``GradientAverager`` rides for a
    gradient tree instead of one monolithic concatenate. ``out=``
    (persistent arrays matching the input shapes/dtypes) makes a
    steady-state call allocation-free; ``op=ReduceOp.MEAN`` pre-scales
    into the pack copy, so no per-leaf divide pass exists."""
    return _resolve_group(group_name).allreduce_coalesced(
        tensors, op, timeout_ms, bucket_bytes, out=out)


def allreduce_coalesced_async(
    tensors: Sequence[Any],
    group_name: str = "default",
    op: ReduceOp = ReduceOp.SUM,
    timeout_ms: int = DEFAULT_TIMEOUT_MS,
    bucket_bytes: Optional[int] = None,
    out: Optional[Sequence[Any]] = None,
    overlap: Optional[bool] = None,
    on_bucket=None,
):
    """Overlapped coalesced allreduce — returns a ``CollectiveWork``
    handle (``.wait()``/``.done()``) immediately and hides the host-side
    gradient movement behind device compute: the group's runner
    copies buckets to the host (one batched device-to-host copy each,
    reverse-backward order) and pipelines their shm/ring reduce rounds.
    CUDA tensors are accepted directly: do NOT move the leaves to the host
    first, that would serialize the copies this API exists to overlap. ``on_bucket(indices, arrays)`` (optional) fires exactly
    once per coalesced bucket THE MOMENT its reduce lands — on the
    runner's reducer thread — with the input indices of the bucket's
    tensors and their reduced arrays, so per-bucket downstream work
    (a fused optimizer apply) overlaps the
    remaining buckets' rounds; a callback exception poisons the group
    like any mid-round failure. ``overlap`` forces the path (None = the
    ``RAY_TPU_TORCH_COLLECTIVE_OVERLAP`` knob); the sync fallback returns an
    already-completed handle and still fires ``on_bucket`` per bucket
    on the caller's thread, so call sites stay identical."""
    from ray_tpu_torch.util.collective.async_work import validate_on_bucket

    # misuse fails HERE, before group resolution: a bad callback must
    # raise at the call site, not poison the group from the runner
    validate_on_bucket(on_bucket)
    return _resolve_group(group_name).allreduce_coalesced_async(
        tensors, op, timeout_ms, bucket_bytes, out=out, overlap=overlap,
        on_bucket=on_bucket)


def reduce(
    tensor,
    dst_rank: int = 0,
    group_name: str = "default",
    op: ReduceOp = ReduceOp.SUM,
    timeout_ms: int = DEFAULT_TIMEOUT_MS,
):
    return _resolve_group(group_name).reduce(tensor, op, dst_rank, timeout_ms)


def broadcast(
    tensor,
    src_rank: int = 0,
    group_name: str = "default",
    timeout_ms: int = DEFAULT_TIMEOUT_MS,
):
    return _resolve_group(group_name).broadcast(tensor, src_rank, timeout_ms)


def allgather(
    tensor, group_name: str = "default", timeout_ms: int = DEFAULT_TIMEOUT_MS
) -> List[np.ndarray]:
    return _resolve_group(group_name).allgather(tensor, timeout_ms)


def reducescatter(
    tensor,
    group_name: str = "default",
    op: ReduceOp = ReduceOp.SUM,
    timeout_ms: int = DEFAULT_TIMEOUT_MS,
):
    return _resolve_group(group_name).reducescatter(tensor, op, timeout_ms)


def send(
    tensor, dst_rank: int, group_name: str = "default", timeout_ms: int = DEFAULT_TIMEOUT_MS
) -> None:
    _resolve_group(group_name).send(tensor, dst_rank, timeout_ms)


def recv(
    src_rank: int, group_name: str = "default", timeout_ms: int = DEFAULT_TIMEOUT_MS
) -> np.ndarray:
    """Receive from src_rank. (The reference mutates a passed-in tensor;
    this returns what arrived, as the JAX package's does: a host array on
    the host group, a tensor on the card on an NCCL group.)"""
    return _resolve_group(group_name).recv(src_rank, timeout_ms)


def barrier(group_name: str = "default", timeout_ms: int = DEFAULT_TIMEOUT_MS) -> None:
    _resolve_group(group_name).barrier(timeout_ms)


def synchronize(group_name: str = "default") -> None:
    """Block until all queued work on this process's card is done
    (≈ cuda synchronize; nothing to wait for without a card)."""
    import sys

    torch = sys.modules.get("torch")
    if torch is not None and torch.cuda.is_available():
        torch.cuda.synchronize()
