"""Differentiable collectives over the dims of a ``DeviceMesh``: what
``shard_map`` gives the JAX package's SPMD code (``lax.ppermute``,
``lax.psum``, ``lax.axis_index``), for the port's ring attention,
pipelines, tensor-parallel blocks and expert-parallel MoE.

Code that calls these runs on every rank of the mesh on its local shards,
and its loss is read in one of two ways per mesh axis:

  * the ranks along the axis compute the SAME loss (a replicated output,
    as after ``psum``; tensor-parallel and expert-parallel axes, a
    pipeline's stages). A collective's backward then must not sum the
    replicas' cotangents again: ``psum``'s backward is the identity and
    ``all_gather(grad="slice")``'s takes this rank's piece. This is JAX's
    transpose of a ``shard_map`` whose output is replicated (it scales the
    cotangent by 1/axis size before psum's transpose);
    ``torch.distributed.nn.functional.all_reduce`` instead sums the
    cotangents, which would multiply such grads by the axis size;
  * the ranks hold different parts of one summed loss (data axes, the
    sequence axis): each backward is the exact transpose, e.g.
    ``all_gather(grad="sum")``'s reduce-scatter.

``ppermute``'s backward sends the cotangent by the inverse permutation,
which is its transpose under either reading.
"""

from __future__ import annotations

import functools
from typing import List, Sequence, Tuple, Union

import torch
import torch.distributed as dist

from ray_tpu_torch.parallel.mesh import mesh_axes
from ray_tpu_torch.util.collective.tp import TpOps, reduce_ops

Axes = Union[str, Sequence[str]]


def _axes(axes: Axes) -> Tuple[str, ...]:
    return (axes,) if isinstance(axes, str) else tuple(axes)


def axis_size(mesh, axes: Axes) -> int:
    names, sizes = mesh_axes(mesh)
    out = 1
    for a in _axes(axes):
        out *= sizes[names.index(a)] if a in names else 1
    return out


def axis_index(mesh, axes: Axes) -> int:
    """This rank's index along ``axes`` (major-to-minor in the given
    order), as ``lax.axis_index`` over those axes."""
    names, sizes = mesh_axes(mesh)
    coord = mesh.get_coordinate()
    idx = 0
    for a in _axes(axes):
        if a in names:
            i = names.index(a)
            idx = idx * sizes[i] + coord[i]
    return idx


def _group_ranks(mesh, axes: Tuple[str, ...]) -> List[List[int]]:
    """Every group of ranks that differ only along ``axes``, each listed
    in ``axis_index`` order."""
    names, sizes = mesh_axes(mesh)
    grid = mesh.mesh
    dims = [names.index(a) for a in axes]
    rest = [i for i in range(len(names)) if i not in dims]
    grid = grid.permute(*rest, *dims).reshape(-1, axis_size(mesh, axes))
    return [row.tolist() for row in grid]


def axis_group(mesh, axes: Axes):
    """The process group of this rank's ranks along ``axes``. Every rank
    must ask for the same groups in the same order (making a group is a
    collective); each is made once and kept on the mesh, so it lives as
    long as the mesh does."""
    axes = tuple(a for a in _axes(axes) if a in mesh_axes(mesh)[0])
    groups = mesh.__dict__.setdefault("_spmd_groups", {})
    if axes not in groups:
        if len(axes) == 1:
            group = mesh.get_group(axes[0])
        else:
            lists = _group_ranks(mesh, axes)
            for ranks in lists:
                if ranks != sorted(ranks):
                    raise NotImplementedError(
                        f"ranks along {axes} are not in rank order")
            group, _ = dist.new_subgroups_by_enumeration(lists)
        groups[axes] = group
    return groups[axes]


def _peers(perm, me: int):
    dst = [d for s, d in perm if s == me]
    src = [s for s, d in perm if d == me]
    return (dst[0] if dst else None), (src[0] if src else None)


def _permute(x: torch.Tensor, perm, group) -> torch.Tensor:
    me = dist.get_rank(group)
    dst, src = _peers(perm, me)
    if dst == me and src == me:
        return x.clone()
    x = x.contiguous()
    out = torch.zeros_like(x)
    ops = []
    if dst is not None:
        ops.append(dist.P2POp(dist.isend, x,
                              dist.get_global_rank(group, dst), group))
    if src is not None:
        ops.append(dist.P2POp(dist.irecv, out,
                              dist.get_global_rank(group, src), group))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return out


class _PPermute(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, perm, group):
        ctx.perm, ctx.group = perm, group
        return _permute(x, perm, group)

    @staticmethod
    def backward(ctx, g):
        inverse = [(d, s) for s, d in ctx.perm]
        return _permute(g, inverse, ctx.group), None, None


def ppermute(x: torch.Tensor, perm: Sequence[Tuple[int, int]], group
             ) -> torch.Tensor:
    """Send ``x`` from group rank s to d for each (s, d) in ``perm``; a
    rank no pair sends to gets zeros (``lax.ppermute``)."""
    return _PPermute.apply(x, [tuple(p) for p in perm], group)


def _all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    x = x.clone(memory_format=torch.contiguous_format)
    if dist.get_world_size(group) > 1:
        dist.all_reduce(x, group=group)
    return x


def tp_ops(group) -> TpOps:
    """Megatron's conjugate (g, f) pair (``util/collective/tp.py``) over
    the group's all-reduce: g is ``psum``, f is ``psum_grad``."""
    return reduce_ops(functools.partial(_all_reduce, group=group))


def psum(x: torch.Tensor, group) -> torch.Tensor:
    """Sum over the group, the result replicated; the backward passes the
    (replicated) cotangent through (Megatron's g)."""
    return tp_ops(group).g(x)


def psum_grad(x: torch.Tensor, group) -> torch.Tensor:
    """Identity forward, cotangents summed over the group in the backward
    (Megatron's f): the input of a sharded computation whose output is
    replicated again."""
    return tp_ops(group).f(x)


def _gather(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    n = dist.get_world_size(group)
    if n == 1:
        return x.clone()
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(n)]
    dist.all_gather(parts, x, group=group)
    return torch.cat(parts, dim=dim)


class _AllGather(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, group, dim, grad):
        ctx.group, ctx.dim, ctx.grad, ctx.n = group, dim, grad, x.shape[dim]
        return _gather(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        me = dist.get_rank(ctx.group)
        if ctx.grad == "sum":
            g = _all_reduce(g, ctx.group)
        piece = g.narrow(ctx.dim, me * ctx.n, ctx.n).contiguous()
        return piece, None, None, None


def all_gather(x: torch.Tensor, group, dim: int = 0, grad: str = "sum"
               ) -> torch.Tensor:
    """Concatenate the group's ``x`` along ``dim`` in group-rank order.
    ``grad="sum"``: the backward is the reduce-scatter (the ranks feed
    different loss terms); ``"slice"``: it takes this rank's piece of the
    cotangent (the ranks compute the same loss)."""
    if grad not in ("sum", "slice"):
        raise ValueError(f"grad must be 'sum' or 'slice', got {grad!r}")
    return _AllGather.apply(x, group, dim, grad)
