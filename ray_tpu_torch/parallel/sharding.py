"""Logical-axis sharding rules (flax-style) for model state.

Counterpart: ``ray_tpu/parallel/sharding.py``. Parameters carry logical
axis names; a rule table maps them to mesh axes, which gives a JAX-style
partition spec per tensor (one entry per tensor dim: a mesh axis name, a
tuple of them, or None). ``spec_to_placements`` turns such a spec into the
DTensor form, one placement per mesh dim: ``Shard(d)`` for the tensor dim
the mesh dim splits, else ``Replicate()``. ``shard_params`` places a params
tree with ``distribute_tensor``.

``ShardingRules.spec``, ``sanitize_spec`` and ``param_specs`` read only a
mesh's axis names and sizes, so they take a ``MeshSpec`` as well as a
``DeviceMesh``, and layouts need no process group.

Trees are the port's: dicts and lists, whose leaves are tensors (params) or
tuples of axis names (logical axes, specs).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, Optional, Sequence, Tuple, Union

from ray_tpu_torch.parallel.mesh import mesh_axes

LogicalAxes = Tuple[Optional[str], ...]
Spec = Tuple[Optional[Union[str, Tuple[str, ...]]], ...]


# Default rule table: logical axis name -> mesh axis (or None = replicate).
DEFAULT_RULES: Dict[str, Optional[Union[str, Tuple[str, ...]]]] = {
    # activations
    "batch": ("dp", "fsdp"),
    "seq": "sp",
    # params
    "embed": "fsdp",  # ZeRO-shard the embed dim of params over fsdp
    "embed_notp": "fsdp",  # embed-sized vectors (norm scales): fsdp only
    "vocab": "tp",
    "mlp": "tp",
    "heads": "tp",
    "kv": "tp",
    "head_dim": None,
    "layers": None,
    "expert": "ep",
}


def _is_axes(x) -> bool:
    return isinstance(x, tuple) and all(
        a is None or isinstance(a, (str, tuple)) for a in x)


def tree_map(fn: Callable, tree, *rest, is_leaf=None):
    """``fn`` over the leaves of a tree of dicts and lists (and of trees of
    the same structure in ``rest``); a tuple of axis names is a leaf."""
    if is_leaf is not None and is_leaf(tree):
        return fn(tree, *rest)
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest), is_leaf=is_leaf)
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_map(fn, v, *(r[i] for r in rest), is_leaf=is_leaf)
                for i, v in enumerate(tree)]
    return fn(tree, *rest)


@dataclasses.dataclass
class ShardingRules:
    rules: Dict[str, Optional[Union[str, Tuple[str, ...]]]] = dataclasses.field(
        default_factory=lambda: dict(DEFAULT_RULES)
    )

    def with_overrides(self, **overrides) -> "ShardingRules":
        new = dict(self.rules)
        new.update(overrides)
        return ShardingRules(new)

    def spec(self, logical: Sequence[Optional[str]], mesh) -> Spec:
        """Partition spec for one array's logical axes, dropping mesh axes
        the mesh doesn't have (so the same model runs on any mesh). A mesh
        axis shards at most one tensor dim."""
        names, _ = mesh_axes(mesh)
        out = []
        used = set()
        for name in logical:
            target = self.rules.get(name) if name else None
            if target is None:
                out.append(None)
                continue
            targets = (target,) if isinstance(target, str) else tuple(target)
            present = tuple(
                t for t in targets if t in names and t not in used
            )
            used.update(present)
            if not present:
                out.append(None)
            elif len(present) == 1:
                out.append(present[0])
            else:
                out.append(present)
        return tuple(out)


def logical_to_spec(rules: ShardingRules, logical_tree, mesh):
    """Map a tree of logical-axis tuples to a tree of partition specs."""
    return tree_map(lambda ax: rules.spec(ax, mesh), logical_tree,
                    is_leaf=_is_axes)


def infer_logical_axes(params) -> Any:
    """Heuristic logical axes for a params tree when the model doesn't
    annotate: the largest dim of a 2D+ weight shards ('embed'), 1D
    replicate. The port's models annotate explicitly instead."""
    def leaf_axes(x):
        shape = tuple(getattr(x, "shape", ()))
        if len(shape) <= 1:
            return (None,) * len(shape)
        axes: list = [None] * len(shape)
        axes[max(range(len(shape)), key=lambda i: (shape[i], -i))] = "embed"
        return tuple(axes)

    return tree_map(leaf_axes, params)


def sanitize_spec(spec: Spec, shape, mesh) -> Spec:
    """Drop mesh axes from a spec on dims they don't divide evenly (e.g. 2
    kv heads can't split over tp=8: replicate instead). DTensor would shard
    such a dim unevenly; the JAX package replicates it, and so does this."""
    names, sizes = mesh_axes(mesh)
    size_of = dict(zip(names, sizes))
    out = []
    for i, entry in enumerate(spec):
        if entry is None or i >= len(shape):
            out.append(entry)
            continue
        axes = (entry,) if isinstance(entry, str) else tuple(entry)
        size = math.prod(size_of[a] for a in axes)
        if size and shape[i] % size == 0:
            out.append(entry)
        else:
            out.append(None)
    return tuple(out)


def param_specs(params, mesh, rules: Optional[ShardingRules] = None,
                logical=None):
    """Shape-checked partition-spec tree for a params tree."""
    rules = rules or ShardingRules()
    if logical is None:
        logical = infer_logical_axes(params)
    specs = logical_to_spec(rules, logical, mesh)
    return tree_map(
        lambda x, s: sanitize_spec(s, tuple(getattr(x, "shape", ())), mesh),
        params, specs)


def spec_to_placements(spec: Spec, mesh) -> tuple:
    """A JAX-style spec -> one DTensor placement per mesh dim. A tensor dim
    split over several mesh axes, e.g. the batch over ("dp", "fsdp"), is
    ``Shard(d)`` on each of them; JAX splits it major-to-minor in the
    entry's order and DTensor in mesh-dim order, so the entry must list its
    axes in mesh order (the rules do: both follow ``AXIS_ORDER``)."""
    from torch.distributed.tensor import Replicate, Shard

    names, _ = mesh_axes(mesh)
    placements = [Replicate()] * len(names)
    for dim, entry in enumerate(spec):
        if entry is None:
            continue
        axes = (entry,) if isinstance(entry, str) else tuple(entry)
        pos = [names.index(a) for a in axes if a in names]
        if pos != sorted(pos):
            raise ValueError(
                f"spec entry {entry!r} lists mesh axes out of mesh order "
                f"{names}; DTensor splits a dim major-to-minor in mesh order")
        for p in pos:
            if placements[p] != Replicate():
                raise ValueError(f"mesh axis {names[p]!r} shards two "
                                 f"tensor dims in spec {spec!r}")
            placements[p] = Shard(dim)
    return tuple(placements)


def shard_params(params, mesh, rules: Optional[ShardingRules] = None,
                 logical=None, specs=None):
    """Place a params tree onto the mesh per the rules (ZeRO/fsdp aware):
    each leaf a DTensor with the placements of its spec. Every rank holds
    the whole tree (drawn from one seed or loaded), so each keeps its own
    shard and nothing is sent (``src_data_rank=None``)."""
    if specs is None:
        specs = param_specs(params, mesh, rules, logical)
    return tree_map(lambda x, s: shard_tensor(x, s, mesh), params, specs)


def shard_tensor(x, spec: Spec, mesh):
    """One tensor, the same on every rank, as a DTensor with the
    placements of ``spec``: each rank keeps a copy of its own shard and
    nothing is sent."""
    from torch.distributed.tensor import distribute_tensor

    return distribute_tensor(x.detach(), mesh, spec_to_placements(spec, mesh),
                             src_data_rank=None)
