"""Elastic world membership for declarative collective groups.

Counterpart: ``ray_tpu/util/collective/resizable.py``. A
``ResizableGroup`` is the driver-side wrapper that turns worker loss from
a terminal event into a *resharding* event (the Podracer preemption
model, arXiv:2104.06272): between operations (never mid-round; a poisoned
round stays poisoned) the group is atomically re-declared at the live
membership via a fresh rendezvous generation:

  * ``create_collective_group`` advances a never-deleted generation
    counter (``declgen:{name}``) and folds it into every wire key
    (``{name}@{gen}``), the monotonic epoch. Straggler frames from the
    old world carry the old generation's keys and never fold into the
    new world's rounds.
  * A survivor whose member object was poisoned by the departure (or is
    merely stale) recovers through ``BaseGroup._raise_if_stale`` /
    :func:`refresh_membership`: the cached member is destroyed and the
    next collective call re-rendezvouses at the new generation.
  * Joiners receive the current param/optimizer tree leaf by leaf over
    ``collective.broadcast`` from a live rank (:func:`sync_tree`), with
    no checkpoint restore on the rejoin path.

Driver-side state machine: ``ready`` --(death fan-out)-->
``resize_pending`` --(:meth:`ResizableGroup.resize` at the next flush /
step boundary)--> ``ready`` at the new world size. The workload
(``train.PipelineTrainer``) owns *when* the boundary is; this module owns
the membership bookkeeping and the rendezvous mechanics.
"""

from __future__ import annotations

import io
import pickle
import threading
from typing import Any, List, Optional, Sequence

import numpy as np
import torch

from ray_tpu_torch._private import flight
from ray_tpu_torch.util.collective.collective import (
    _KV_NS,
    _kv,
    _manager,
    broadcast,
    create_collective_group,
    get_rank,
)

_F_RESIZE = flight.intern("elastic.resize")


def _actor_hex(actor_or_hex: Any) -> str:
    if isinstance(actor_or_hex, str):
        return actor_or_hex
    return actor_or_hex._actor_id.hex()


class ResizableGroup:
    """Declarative collective group whose world size can change between
    operations.

    The driver constructs it with the initial rank-ordered actor roster;
    the death fan-out calls :meth:`note_departure`, which marks the group
    ``resize_pending``; at the next operation boundary the workload calls
    :meth:`resize` with the healed roster and every survivor
    re-rendezvouses at the new generation on its next collective call.
    Rank assignment is positional in the new roster, so a gradient MEAN
    re-scales to the live world by construction.
    """

    def __init__(self, actors: Sequence[Any], *, group_name: str,
                 backend: str = "host"):
        if not actors:
            raise ValueError("ResizableGroup needs at least one actor")
        self.name = group_name
        self._backend = backend
        self._lock = threading.Lock()
        self._actors: List[Any] = list(actors)
        self._departed: set = set()
        self._resize_pending = False
        self._epoch = -1
        self._declare_locked()

    # -- introspection

    @property
    def world_size(self) -> int:
        return len(self._actors)

    @property
    def epoch(self) -> int:
        """The declarative generation the current world rendezvouses
        under: folded into every wire key, monotonic across resizes."""
        return self._epoch

    @property
    def resize_pending(self) -> bool:
        return self._resize_pending

    def actors(self) -> List[Any]:
        return list(self._actors)

    def survivors(self) -> List[Any]:
        return [a for a in self._actors
                if a._actor_id.hex() not in self._departed]

    # -- membership transitions

    def note_departure(self, actor_or_hex: Any) -> bool:
        """A member died (node/actor death fan-out): mark the group
        ``resize_pending``. The old generation's wire state may be
        poisoned mid-round, and that is required: survivors recover by
        joining the next generation, never by resuming the torn round.
        Returns True if the id was a live member."""
        hexid = _actor_hex(actor_or_hex)
        with self._lock:
            known = any(a._actor_id.hex() == hexid for a in self._actors)
            if known and hexid not in self._departed:
                self._departed.add(hexid)
                self._resize_pending = True
                from ray_tpu_torch._private.elastic import m_departures

                m_departures.inc(labels={"group": self.name})
                return True
        return False

    def resize(self, actors: Optional[Sequence[Any]] = None) -> int:
        """Atomically re-form the group at the new membership.

        Call this only between operations (flush/step boundary: no
        member may be inside a round). ``actors`` is the new rank-ordered
        roster; None means "the survivors of the noted departures"
        (shrink). Re-declares the group at a fresh generation and returns
        the new epoch; survivors (and joiners) rendezvous lazily on their
        next collective call after dropping stale members via
        :func:`refresh_membership` / ``_raise_if_stale``.
        """
        t0 = flight.now()
        with self._lock:
            roster = (list(actors) if actors is not None
                      else [a for a in self._actors
                            if a._actor_id.hex() not in self._departed])
            if not roster:
                raise RuntimeError(
                    f"resizable group {self.name!r} has no survivors to "
                    f"resize to")
            self._actors = roster
            self._departed.clear()
            self._resize_pending = False
            self._declare_locked()
        from ray_tpu_torch._private.elastic import m_reshards

        m_reshards.inc(labels={"group": self.name})
        flight.span_since(_F_RESIZE, t0)
        return self._epoch

    def _declare_locked(self) -> None:
        n = len(self._actors)
        create_collective_group(
            self._actors, n, list(range(n)), backend=self._backend,
            group_name=self.name)
        meta = _kv().kv_get(f"decl:{self.name}", ns=_KV_NS)
        self._epoch = int(meta["gen"])


# ---------------------------------------------------------- member helpers


def refresh_membership(group_name: str) -> bool:
    """Member-side half of a resize: drop this process's cached group
    member if the driver re-declared the group at a newer generation, so
    the NEXT collective call re-rendezvouses in the new world instead of
    timing out against the old one (the success-path twin of
    ``BaseGroup._raise_if_stale``). A member poisoned by a mid-round
    departure is covered too: destroying it clears the poison with the
    stale wire state. Returns True if a stale member was dropped.
    """
    group = _manager.get(group_name)
    if group is None:
        return False
    gen = getattr(group, "_decl_gen", None)
    if gen is None:
        # imperative member: generations don't apply, the caller must
        # destroy/re-init explicitly
        return False
    meta = _kv().kv_get(f"decl:{group_name}", ns=_KV_NS)
    if meta is not None and meta["gen"] == gen:
        return False
    _manager.destroy(group_name)
    return True


class _LeafPickler(pickle.Pickler):
    """Pickles a tree with every tensor and ndarray replaced by a leaf
    reference (its index and kind): dicts, lists, tuples, dataclasses
    and scalars travel in the pickle, the leaves by broadcast."""

    def __init__(self, buf):
        super().__init__(buf, protocol=pickle.HIGHEST_PROTOCOL)
        self.leaves: List[Any] = []

    def persistent_id(self, obj):
        if isinstance(obj, torch.Tensor):
            self.leaves.append(obj.detach())
            return ("tensor", len(self.leaves) - 1, str(obj.dtype))
        if isinstance(obj, np.ndarray):
            self.leaves.append(obj)
            return ("array", len(self.leaves) - 1, None)
        return None


class _LeafUnpickler(pickle.Unpickler):
    def __init__(self, buf, leaves):
        super().__init__(buf)
        self._leaves = leaves

    def persistent_load(self, pid):
        kind, i, dtype = pid
        leaf = np.ascontiguousarray(self._leaves[i])
        if kind == "array":
            return leaf
        t = torch.from_numpy(np.array(leaf, copy=True))
        return t.view(torch.bfloat16) if dtype == "torch.bfloat16" else t


def sync_tree(tree: Optional[Any], group_name: str, *, src_rank: int = 0,
              timeout_ms: int = 120_000):
    """Leaf-wise tree delivery over ``collective.broadcast`` on an
    EXISTING group: the joiner's rejoin path. The source rank passes its
    live tree (dicts, lists, tuples, dataclasses; tensors on any device,
    numpy arrays and scalars as leaves), every other rank passes ``None``
    and receives the same tree, its tensors on the CPU (the caller places
    them). No checkpoint restore: the tree's structure travels as a
    pickled uint8 header broadcast, then one broadcast per leaf; a
    bfloat16 leaf crosses the group as its int16 bits. The source gets
    its own tree back."""
    rank = get_rank(group_name)
    if rank == src_rank:
        if tree is None:
            raise ValueError("sync_tree source rank must pass the tree")
        buf = io.BytesIO()
        pk = _LeafPickler(buf)
        pk.dump(tree)
        spec = pickle.dumps((len(pk.leaves), buf.getvalue()))
        broadcast(np.frombuffer(spec, np.uint8), src_rank=src_rank,
                  group_name=group_name, timeout_ms=timeout_ms)
        for leaf in pk.leaves:
            if isinstance(leaf, np.ndarray):
                leaf = np.ascontiguousarray(leaf)
            broadcast(leaf, src_rank=src_rank, group_name=group_name,
                      timeout_ms=timeout_ms)
        return tree
    spec = broadcast(np.empty(0, np.uint8), src_rank=src_rank,
                     group_name=group_name, timeout_ms=timeout_ms)
    n, body = pickle.loads(bytes(np.asarray(spec)))
    leaves = [np.asarray(broadcast(np.empty(0, np.uint8),
                                   src_rank=src_rank,
                                   group_name=group_name,
                                   timeout_ms=timeout_ms))
              for _ in range(n)]
    return _LeafUnpickler(io.BytesIO(body), leaves).load()
