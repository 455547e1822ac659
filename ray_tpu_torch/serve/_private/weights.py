"""One-copy-per-node shared model weights for serve replicas.

Counterpart: ``ray_tpu/serve/_private/weights.py``. The FIRST replica on a
node publishes the host params into the node's shared-memory object arena
and registers the resulting ObjectRef in the controller KV under a
(weights-key, node) entry; every LATER replica on that node ``get``s the
ref and rebuilds the tree over pinned READ-ONLY views of its own mmap of
the same arena range: zero additional arena bytes per replica, only pins.
A replica that dies without unpinning has its pins reclaimed by the
supervisor's dead-client sweep, so replica churn never leaks the range.

The port's param tree holds torch tensors, and numpy has no bf16, so a
tree is published as each leaf's raw bytes (a ``uint8`` array) beside a
skeleton of the tree that names each leaf's dtype, shape and index; the
reader rebuilds every leaf with ``torch.frombuffer`` over its view, bit for
bit. A rebuilt leaf aliases the shared arena range: a caller places it on
its device with a copy (``place_params`` copies on the CPU as well), and
never writes to it.

``broadcast_params`` (new-node delivery over ``collective.broadcast``)
needs the collective group API, which is ROADMAP A5; until then it raises.
"""

from __future__ import annotations

import logging
import time
import warnings
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np

logger = logging.getLogger(__name__)

_KV_NS = "serve_weights"

# key -> (ObjectRef, views): holds the ref (so the owner never frees the
# object) and the views (so this process's pins persist) for the process
# lifetime. Replica death releases both through normal dead-client sweeps.
_HELD: Dict[str, Tuple[Any, Any]] = {}


def _tree_to_host(params) -> Dict[str, Any]:
    """The port's param tree -> its arena-publishable form: ``leaves``, each
    leaf's bytes as a host ``uint8`` array, and ``skeleton``, the tree with
    each tensor replaced by ``(dtype name, shape, leaf index)``."""
    import torch

    from ray_tpu_torch.models.transformer import map_params

    leaves = []

    def pack(_path, t):
        t = t.detach().contiguous()
        raw = t.reshape(-1).view(torch.uint8).cpu().numpy()
        leaves.append(raw)
        return (str(t.dtype).split(".")[-1], tuple(t.shape), len(leaves) - 1)

    return {"skeleton": map_params(pack, params), "leaves": leaves}


def tree_from_host(host: Dict[str, Any]):
    """Inverse of ``_tree_to_host``: CPU tensors over the leaves' buffers
    (no copy; over arena views they alias the shared range)."""
    import torch

    from ray_tpu_torch.models.transformer import map_params

    def leaf(_path, spec):
        dtype_name, shape, i = spec
        raw = host["leaves"][i]
        dtype = getattr(torch, dtype_name)
        if raw.nbytes == 0:
            return torch.empty(shape, dtype=dtype)
        with warnings.catch_warnings():
            # the arena views are read-only; torch has no read-only tensors
            # and warns. Nothing writes to these leaves (see the docstring)
            warnings.simplefilter("ignore", UserWarning)
            flat = torch.frombuffer(raw, dtype=torch.uint8)
        return flat.view(dtype).reshape(shape)

    return map_params(leaf, host["skeleton"])


def tree_nbytes(host: Dict[str, Any]) -> int:
    """Bytes of a published tree's leaves."""
    return sum(int(a.nbytes) for a in host["leaves"])


def _pack_ref(ref) -> Dict[str, Any]:
    return {"oid": ref._object_id.binary(), "owner": list(ref._owner_addr)}


def _unpack_ref(d):
    from ray_tpu_torch._private.api import ObjectRef
    from ray_tpu_torch._private.ids import ObjectID

    # skip_ref_counting: the publisher holds the canonical local ref in
    # _HELD; readers only pin via their views
    return ObjectRef(ObjectID(bytes(d["oid"])), tuple(d["owner"]),
                     skip_ref_counting=True)


def _cluster_ready() -> bool:
    from ray_tpu_torch._private import api

    core = api._core
    return (core is not None and core.supervisor_addr is not None
            and core.arena is not None)


def get_or_publish(key: str, loader: Callable[[], Any], *,
                   timeout_s: float = 180.0) -> Tuple[Any, Dict[str, Any]]:
    """Return ``(params, info)`` with one arena copy per node.

    The first caller per node wins a KV claim, builds the params via
    ``loader()`` (or pulls another node's published copy through the
    chunked cross-node path), publishes them into the node arena, and
    registers the ref; every other caller on the node blocks on the ref
    key and attaches zero-copy. ``params`` is the port's param tree of CPU
    tensors over READ-ONLY arena views for every caller, the publisher
    included (callers place it once on their device, with a copy).

    Falls back to a plain local ``loader()`` (``info["mode"] == "local"``)
    when no cluster or arena is reachable, so direct instantiation outside
    a cluster keeps working. ``info["seconds"]`` is this call's wall time;
    a publisher's ``info["load_seconds"]`` and ``info["put_seconds"]``
    split off the loader (with the copy to the host) and the arena put.
    """
    t_start = time.perf_counter()
    if not _cluster_ready():
        params = loader()
        return params, {"mode": "local", "shared": False}

    import ray_tpu_torch as rt
    from ray_tpu_torch._private import api
    from ray_tpu_torch._private import internal_kv as kv

    core = api._core
    node = core.node_id_hex or "local"
    me = core._store_client_id
    ref_key = f"ref:{key}@{node}"
    claim_key = f"claim:{key}@{node}"
    global_key = f"ref:{key}@global"

    for attempt in range(2):
        packed = kv.kv_get(ref_key, ns=_KV_NS)
        published = False
        source = "arena"
        if packed is None:
            if kv.kv_put(claim_key, me, ns=_KV_NS, overwrite=False):
                # we are this node's publisher
                try:
                    host, source = _materialize(global_key, loader,
                                                timeout_s)
                    t_put = time.perf_counter()
                    load_s = t_put - t_start
                    ref = rt.put(host)
                    put_s = time.perf_counter() - t_put
                    del host  # the loader copy dies; the arena copy stays
                    packed = _pack_ref(ref)
                    kv.kv_put(ref_key, packed, ns=_KV_NS)
                    kv.kv_put(global_key, packed, ns=_KV_NS,
                              overwrite=False)
                    _HELD[ref_key] = (ref, None)
                    published = True
                except BaseException:
                    # release the claim so another replica can retry the
                    # election instead of deadlocking on kv_wait
                    try:
                        kv.kv_del(claim_key, ns=_KV_NS)
                    except Exception:
                        pass
                    raise
            else:
                try:
                    packed = kv.kv_wait(ref_key, timeout=timeout_s,
                                        ns=_KV_NS)
                except TimeoutError:
                    # claimed but never published (claimant died mid-load):
                    # clear the claim and re-run the election
                    try:
                        kv.kv_del(claim_key, ns=_KV_NS)
                    except Exception:
                        pass
                    continue
        ref = _unpack_ref(packed) if not published else _HELD[ref_key][0]
        try:
            views = rt.get(ref, timeout=timeout_s)
        except Exception:
            if published:
                raise
            # stale registration (the arena copy is gone, e.g. the whole
            # node restarted under the same KV): drop it and re-elect
            logger.warning("shared-weights ref %s is stale; re-electing",
                           ref_key, exc_info=True)
            for k in (ref_key, claim_key):
                try:
                    kv.kv_del(k, ns=_KV_NS)
                except Exception:
                    pass
            if attempt == 0:
                continue
            raise
        _HELD[ref_key] = (ref, views)
        info = {
            "mode": "published" if published else "attached",
            "shared": True,
            "source": source if published else "arena",
            "key": key,
            "node": node,
            "ref": ref.hex(),
            "nbytes": tree_nbytes(views),
        }
        if published:
            info.update(load_seconds=load_s, put_seconds=put_s)
        params = tree_from_host(views)
        info["seconds"] = time.perf_counter() - t_start
        return params, info
    raise RuntimeError(
        f"could not obtain shared weights for {key!r} within {timeout_s}s")


def _materialize(global_key: str, loader, timeout_s: float):
    """Publisher-side parameter source, in publishable form: prefer pulling
    another node's published copy (chunked cross-node arena transfer, no
    loader cost) over running the loader."""
    import ray_tpu_torch as rt
    from ray_tpu_torch._private import internal_kv as kv

    packed = kv.kv_get(global_key, ns=_KV_NS)
    if packed is not None:
        try:
            pulled = rt.get(_unpack_ref(packed), timeout=timeout_s)
            # private host copies: the put below must not alias the pull
            return {"skeleton": pulled["skeleton"],
                    "leaves": [np.array(a) for a in pulled["leaves"]]}, "pull"
        except Exception:
            logger.warning("global weights ref is stale; running loader",
                           exc_info=True)
    params = loader()
    host = _tree_to_host(params)
    del params
    return host, "loader"


def release(key: str) -> None:
    """Drop this process's hold (views + ref) on a shared-weights entry,
    for tests and explicit teardown; normal replica death releases through
    the dead-client pin sweep. The caller's own tensors over the views keep
    them (and their pins) until they are gone too."""
    node = ""
    try:
        from ray_tpu_torch._private import api

        node = api._core.node_id_hex if api._core is not None else ""
    except Exception:
        pass
    _HELD.pop(f"ref:{key}@{node or 'local'}", None)


def broadcast_params(params: Optional[Any], group_name: str,
                     world_size: int, rank: int, *, root: int = 0,
                     timeout_ms: int = 120_000):
    """New-node delivery of a params tree over ``collective.broadcast``:
    not ported yet."""
    raise NotImplementedError(
        "serve weights broadcast needs the collective group API "
        "(init_collective_group, broadcast), which is not ported yet "
        "(ROADMAP A5)")
