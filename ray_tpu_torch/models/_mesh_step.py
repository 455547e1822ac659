"""The mesh train step: ``training.make_train_step(..., mesh=)``.

Counterpart: the ``mesh`` branch of ``ray_tpu/models/training.py``'s
``make_train_step``, which jits the step with the state's shardings and
lets GSPMD insert the collectives. Here every rank runs the step on its
local shards with the collectives written out (``parallel/_spmd.py``,
DTensor's ``redistribute``); ``models/training.py``'s docstring lists
what each mesh axis does.
"""

from __future__ import annotations

import functools
from typing import Any, Callable, Dict, List, Optional

import torch

from ray_tpu_torch.models.transformer import (TransformerConfig, _leaves,
                                              _spmd_block, loss_fn,
                                              map_params)
from ray_tpu_torch.parallel import _spmd
from ray_tpu_torch.parallel.mesh import data_sharding, mesh_axes

_EXPERT = ("w_gate", "w_up", "w_down")


def _tp_flags(cfg: TransformerConfig, block, names) -> Dict[str, bool]:
    """Whether this block's attention and MLP run tensor-parallel: their
    weights must split heads / ffn columns over ``tp`` (a layout the rules
    leave replicated, e.g. heads that do not divide, runs whole)."""
    from torch.distributed.tensor import Shard

    if "tp" not in names:
        return {"attn_tp": False, "mlp_tp": False}
    tp = names.index("tp")

    def on(leaf, dim):
        return leaf.placements[tp] == Shard(dim)

    a, m = block["attn"], block["mlp"]
    attn_tp = on(a["wq"], 1) and on(a["wo"], 0)
    if cfg.mlp == "swiglu":
        mlp_tp = on(m["w_gate"], 1) and on(m["w_up"], 1) and on(m["w_down"], 0)
    elif cfg.mlp == "gelu":
        mlp_tp = on(m["w_in"], 1) and on(m["b_in"], 0) and on(m["w_out"], 0)
    else:
        mlp_tp = False  # experts: gathered over tp, split over ep
    return {"attn_tp": attn_tp, "mlp_tp": mlp_tp}


def _kv_narrow(cfg: TransformerConfig, mesh):
    """(start, count) of the kv heads this tp rank's query heads read, for
    a kv head set replicated over ``tp``."""
    tp = _spmd.axis_size(mesh, "tp")
    h_local = cfg.num_heads // tp
    group = cfg.num_heads // cfg.kv_heads
    if h_local % group and group % h_local:
        raise ValueError(f"{h_local} query heads per tp rank do not tile "
                         f"GQA groups of {group}")
    start = _spmd.axis_index(mesh, "tp") * h_local // group
    return start, max(1, h_local // group)


def _gatherer(cfg, mesh, names, batch_axes, flags):
    """``gather(path, leaf)``: a param as this rank computes with it:
    gathered over every mesh dim but ``tp`` in a tensor-parallel sublayer
    and ``ep`` for the experts, then its local tensor, whose grad comes
    back ``Partial`` over the batch axes (and over ``tp`` for a narrowed
    kv set)."""
    from torch.distributed.tensor import Partial, Replicate, Shard

    sizes = mesh_axes(mesh)[1]

    def gather(path, leaf):
        parts = path.split(".")
        in_block = parts[0] == "blocks"
        f = flags if in_block else {"attn_tp": False, "mlp_tp": False}
        is_attn = in_block and parts[2] == "attn"
        is_mlp = in_block and parts[2] == "mlp"
        keep_tp = (is_attn and f["attn_tp"]) or (is_mlp and f["mlp_tp"])
        is_expert = is_mlp and cfg.mlp == "moe" and parts[3] in _EXPERT
        comp, grad = [], []
        narrow = False
        for name, size, pl in zip(names, sizes, leaf.placements):
            keep = (name == "tp" and keep_tp) or (name == "ep" and is_expert)
            c = pl if keep else Replicate()
            comp.append(c)
            if name in batch_axes and size > 1:
                grad.append(Partial())
            elif isinstance(c, Shard):
                grad.append(c)
            elif (name == "tp" and keep_tp and is_attn
                  and parts[3] in ("wk", "wv")):
                grad.append(Partial())  # each rank feeds only its kv heads
                narrow = True
            else:
                grad.append(Replicate())
        local = leaf.redistribute(mesh, comp).to_local(grad_placements=grad)
        if narrow:
            start, count = _kv_narrow(cfg, mesh)
            local = local.narrow(1, start, count)
        return local

    return gather


def _gathered_block(gather, block):
    """``block`` over its params gathered inside the call: under remat the
    checkpoint keeps the sharded params and the gather runs again in
    backward, so one block's gathered params are held at a time."""
    def run(cfg, p, x, rope, positions, kv_cache=None, sp_axis=None,
            mesh=None):
        local = map_params(gather, p, "blocks.0")
        return block(cfg, local, x, rope, positions, kv_cache, sp_axis,
                     mesh)

    return run


def _local_batch(batch, mesh, placements, device):
    from torch.distributed.tensor import DTensor, distribute_tensor

    out = {}
    for k, v in batch.items():
        if isinstance(v, DTensor):
            out[k] = v.redistribute(mesh, placements).to_local()
        else:
            t = torch.as_tensor(v, device=device)
            out[k] = distribute_tensor(t, mesh, placements,
                                       src_data_rank=None).to_local()
    return out


def _global_norm(grads: List, mesh) -> torch.Tensor:
    """The norm of the whole gradient tree: each leaf's local squared norm,
    counted on one rank of each replica set, summed over the mesh once.
    On a one-rank mesh it is the meshless formula, bit for bit."""
    from torch.distributed.tensor import Replicate

    coord = mesh.get_coordinate()
    locals_ = [g.to_local() for g in grads]
    norms = torch.stack(torch._foreach_norm(locals_))
    first = torch.tensor(
        [all(c == 0 for c, p in zip(coord, g.placements) if p == Replicate())
         for g in grads], device=norms.device)
    sq = torch.where(first, norms * norms, torch.zeros_like(norms))
    if mesh.size() > 1:
        names, _ = mesh_axes(mesh)
        torch.distributed.all_reduce(sq, group=_spmd.axis_group(mesh, names))
    return torch.linalg.vector_norm(torch.sqrt(sq))


def make_mesh_train_step(cfg: TransformerConfig, tx, mesh, *,
                         loss: Optional[Callable] = None,
                         log_grad_norm: bool = True, batch_sharding=None):
    names, _ = mesh_axes(mesh)
    if batch_sharding is None:
        batch_sharding = data_sharding(mesh)
    spec = batch_sharding.spec
    entry = spec[0] if spec else None
    batch_axes = tuple(a for a in ((entry,) if isinstance(entry, str)
                                   else entry or ()) if a in names)
    batch_placements = batch_sharding.placements
    n_data = _spmd.axis_size(mesh, batch_axes) if batch_axes else 1
    data_group = _spmd.axis_group(mesh, batch_axes) if batch_axes else None
    tp_group = _spmd.axis_group(mesh, "tp") if "tp" in names else None

    def reduce_data(x):
        if data_group is None or n_data == 1:
            return x
        x = x.clone()
        torch.distributed.all_reduce(x, group=data_group)
        return x

    def step(state, batch: Dict[str, Any]):
        leaves = _leaves(state.params)
        device = leaves[0].to_local().device
        local_batch = _local_batch(batch, mesh, batch_placements, device)
        flags = _tp_flags(cfg, state.params["blocks"][0], names)
        gather = _gatherer(cfg, mesh, names, batch_axes, flags)
        if loss is not None:
            value, metrics = loss(map_params(gather, state.params),
                                  local_batch)
            ce = value
        else:
            # the blocks' params stay sharded until their block runs
            params = {k: v if k == "blocks" else map_params(gather, v, k)
                      for k, v in state.params.items()}
            g, f = _spmd.tp_ops(tp_group) if tp_group else (None, None)
            block = _gathered_block(gather, functools.partial(
                _spmd_block, g=g, f=f, **flags))
            value, metrics = loss_fn(cfg, params, local_batch, mesh=mesh,
                                     block=block)
            ce = metrics["loss"]
        n_local = metrics.get("tokens")
        if n_local is None:  # a custom loss without a token count
            share = torch.tensor(1.0 / n_data, device=device)
            n_global = None
        else:
            n_global = reduce_data(_raw_count(local_batch, n_local))
            share = (n_local.detach().float()
                     / torch.clamp(n_global, min=1.0))
        # this rank's share of the global mean; the MoE routing loss is
        # the whole batch's on every rank, so each data rank adds 1/D
        total = ce * share
        if value is not ce:
            total = total + (value - ce) / n_data
        grads = list(torch.autograd.grad(total, leaves))
        with torch.no_grad():
            g_norm = _global_norm(grads, mesh)
            opt = state.opt_state
            mus = nus = None
            if opt is not None:  # SGD keeps no state
                mus = [m.to_local() for m in _leaves(opt.mu)]
                nus = [v.to_local() for v in _leaves(opt.nu)]
            tx.update_leaves([g.to_local() for g in grads], opt,
                             [p.to_local() for p in leaves], mus, nus,
                             g_norm)
            out = {k: v.detach() for k, v in metrics.items()}
            out["loss"] = reduce_data((ce * share).detach())
            if n_global is not None:
                out["tokens"] = torch.clamp(n_global, min=1.0)
            if log_grad_norm:
                out["grad_norm"] = g_norm
        state.step += 1
        return state, out

    return step


def _raw_count(batch, n_local) -> torch.Tensor:
    """This shard's unclamped token count (the loss clamps a shard's count
    at 1; the global count is the sum of the raw ones)."""
    mask = batch.get("mask")
    if mask is None:
        return n_local.detach().float().clone()
    return mask[:, 1:].float().sum()
