"""Pipeline parallelism over the ``pp`` mesh axis, SPMD.

Counterpart: ``ray_tpu/parallel/pipeline.py``. Every rank of the ``pp``
axis holds ONE stage's parameters (a stacked stage tree split ``Shard(0)``
over ``pp``), microbatches enter at stage 0, and activations rotate
stage-to-stage with a P2P ``ppermute`` each step. The port runs the JAX
package's schedules step for step, in a Python loop where JAX has a
``lax.scan``:

  * ``pipeline_apply``: M + S - 1 steps of one forward each (GPipe's 1F
    schedule); autograd through the steps and the ppermutes yields the
    backward pipeline, so the same function trains under ``backward()``.
    The bubble is (S-1)/(M+S-1).
  * ``pipeline_1f1b``: M + 2S - 2 steps, each one forward and one backward
    (1F1B), with at most 2S boundary activations kept per stage; the stage
    forward is recomputed from its stored input at backward time and the
    cotangents travel the reverse ring.

Every rank runs every step, bubble steps included, so each ppermute has
its partner on every rank, in the forward and in the backward.
"""

from __future__ import annotations

from typing import Any, Callable, List

import torch

from ray_tpu_torch.parallel import _spmd
from ray_tpu_torch.parallel.sharding import tree_map


def stack_stage_params(per_stage_params) -> Any:
    """[stage0_tree, stage1_tree, ...] -> one tree with leading stage axis
    (split this axis over ``pp`` with ``stage_param_sharding``)."""
    return tree_map(lambda *xs: torch.stack([torch.as_tensor(x) for x in xs]),
                    *per_stage_params)


def stage_param_sharding(stacked, mesh, axis: str = "pp"):
    """``NamedSharding``s placing each stacked leaf's leading axis on
    ``axis``; ``distribute_tensor(x, mesh, s.placements)`` places a
    leaf."""
    from ray_tpu_torch.parallel.mesh import NamedSharding

    return tree_map(
        lambda x: NamedSharding(mesh, (axis,) + (None,) * (x.dim() - 1)),
        stacked)


def _leaves(tree) -> List:
    out: List = []
    tree_map(out.append, tree)
    return out


def _unflatten(tree, leaves):
    it = iter(leaves)
    return tree_map(lambda _x: next(it), tree)


def _my_stage(stacked, mesh, axis: str, stage: int):
    """This rank's stage slice of each stacked leaf (leading axis dropped),
    differentiable: a DTensor's local shard (its grad split over ``axis``
    like the leaf), or row ``stage`` of a full tensor."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    names = mesh.mesh_dim_names

    def local(x):
        if isinstance(x, DTensor):
            grad_pl = [Shard(0) if n == axis else Replicate() for n in names]
            loc = x.to_local(grad_placements=grad_pl)
            if loc.shape[0] != 1:
                raise ValueError(f"stacked leaf of shape {tuple(x.shape)} "
                                 f"is not one stage per {axis!r} rank")
            return loc[0]
        return x[stage]

    return tree_map(local, stacked)


def _stage_info(mesh, axis: str, num_stages_of: Any):
    stages = _spmd.axis_size(mesh, axis)
    if num_stages_of is not None and num_stages_of != stages:
        raise ValueError(f"{num_stages_of} stacked stages over a {axis!r} "
                         f"axis of size {stages}")
    return stages, _spmd.axis_index(mesh, axis), _spmd.axis_group(mesh, axis)


def pipeline_apply(stage_fn: Callable[[Any, Any], Any], stacked_params,
                   x: torch.Tensor, *, mesh, axis: str = "pp") -> torch.Tensor:
    """Run ``stage_fn`` as a pipeline over ``axis``.

    stage_fn(stage_params, act) -> act : one stage's computation; every
        stage maps activations of the same shape/dtype (uniform width).
    stacked_params: tree with leading stage axis (``stack_stage_params``),
        DTensors split over ``axis`` or full tensors on every rank.
    x: [num_microbatches, microbatch, ...] activations entering stage 0,
        the same on every rank.

    Returns [num_microbatches, microbatch, ...] outputs of the last stage,
    the same on every rank. Differentiable end to end; a loss computed
    from the output on every rank gives each rank its stage's grads (the
    final sum's backward passes the replicated cotangent through)."""
    first_leaf = _leaves(stacked_params)[0]
    num_stages, stage, group = _stage_info(mesh, axis, first_leaf.shape[0])
    num_micro = x.shape[0]
    steps = num_micro + num_stages - 1
    my_params = _my_stage(stacked_params, mesh, axis, stage)
    is_first = torch.tensor(stage == 0, device=x.device)
    is_last = torch.tensor(stage == num_stages - 1, device=x.device)
    perm = [(i, (i + 1) % num_stages) for i in range(num_stages)]

    buf = torch.zeros_like(x[0])
    acts = []
    for t in range(steps):
        feed = x[min(t, num_micro - 1)]
        act_in = torch.where(is_first, feed.to(buf.dtype), buf)
        act_out = stage_fn(my_params, act_in)
        acts.append(act_out)
        if t + 1 < steps:  # the last step's rotation is never read
            buf = _spmd.ppermute(act_out, perm, group)
    # the last stage's outputs at steps S-1 .. S-1+M-1 are microbatches
    # 0..M-1; everyone else contributes zeros and a psum replicates
    outs = torch.stack(acts[num_stages - 1:num_stages - 1 + num_micro])
    outs = torch.where(is_last, outs, torch.zeros_like(outs))
    return _spmd.psum(outs, group)


def pipeline_1f1b(stage_fn: Callable[[Any, Any], Any],
                  loss_fn: Callable[[Any], Any],
                  stacked_params, x: torch.Tensor, *, mesh,
                  axis: str = "pp"):
    """Train-step pipeline with the 1F1B (one-forward-one-backward)
    microbatch schedule.

    Schedule (steps t = 0 .. M + 2S - 3, stage s):
      forward  of microbatch f = t - s            (when 0 <= f < M)
      backward of microbatch b = t - (2S - 2 - s) (when 0 <= b < M)
    so the last stage runs loss+backward in the same step as its forward,
    cotangents ride the reverse ring, and in steady state every rank does
    one forward and one backward per step. Each stage keeps at most 2S
    boundary inputs, whatever the microbatch count.

    stage_fn(stage_params, act) -> act : uniform-width stage.
    loss_fn(act) -> scalar : per-microbatch loss on the LAST stage's
        output (the mean over microbatches is returned).
    x: [M, microbatch, ...] inputs, the same on every rank.

    Returns (loss, stage_grads): the loss on every rank, and grads shaped
    as ``stacked_params`` (a leading stage axis of this rank's one stage:
    DTensors split over ``axis`` for DTensor params, else [1, ...]
    tensors). Cotangents carry the activations' dtype; grads accumulate
    in float32."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    leaves = _leaves(stacked_params)
    num_stages, stage, group = _stage_info(mesh, axis, leaves[0].shape[0])
    num_micro = x.shape[0]
    steps = num_micro + 2 * num_stages - 2
    buf_slots = 2 * num_stages
    is_first = stage == 0
    is_last = stage == num_stages - 1
    fwd_perm = [(i, (i + 1) % num_stages) for i in range(num_stages)]
    bwd_perm = [((i + 1) % num_stages, i) for i in range(num_stages)]
    with torch.no_grad():
        my_params = _leaves(_my_stage(stacked_params, mesh, axis, stage))
    my_params = [p.detach() for p in my_params]

    def fwd(params, act):
        return stage_fn(_unflatten(stacked_params, params), act)

    mb = x[0]
    fwd_buf = torch.zeros_like(mb)
    bwd_buf = torch.zeros_like(mb)
    act_store = torch.zeros((buf_slots,) + tuple(mb.shape), dtype=mb.dtype,
                            device=mb.device)
    grad_acc = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                for p in my_params]
    loss_acc = torch.zeros((), dtype=torch.float32, device=mb.device)

    for t in range(steps):
        # ---- forward slot: microbatch f = t - stage
        f = t - stage
        f_active = 0 <= f < num_micro
        act_in = x[min(max(f, 0), num_micro - 1)] if is_first else fwd_buf
        if f_active:
            with torch.no_grad():
                act_out = fwd(my_params, act_in)
            # park the boundary input for this microbatch's backward
            act_store[f % buf_slots] = act_in
        else:  # a bubble: what is sent here is never read
            act_out = torch.zeros_like(mb)

        # ---- backward slot: microbatch b = t - (2S - 2 - stage)
        b = t - (2 * num_stages - 2 - stage)
        b_active = 0 <= b < num_micro
        if b_active:
            # at the last stage b == f, so this step's fresh boundary
            # input serves its own backward; other stages read the parked
            # input of microbatch b
            act_in_b = act_in if is_last else act_store[b % buf_slots]
            with torch.enable_grad():
                ps = [p.detach().requires_grad_(True) for p in my_params]
                a = act_in_b.detach().requires_grad_(True)
                out_b = fwd(ps, a)  # recompute-forward at the boundary input
                if is_last:
                    loss_val = loss_fn(out_b)
                    root = loss_val
                else:
                    # the cotangent from stage+1 enters as a factor, so the
                    # vjp's seed is exactly it
                    root = (out_b * bwd_buf.to(out_b.dtype)).sum()
                grads = torch.autograd.grad(root, ps + [a],
                                            allow_unused=True)
            for acc, g in zip(grad_acc, grads[:-1]):
                if g is not None:
                    acc.add_(g.float())
            g_act = grads[-1] if grads[-1] is not None else torch.zeros_like(a)
            if is_last:
                loss_acc = loss_acc + loss_val.detach().float()
            g_send = g_act.to(mb.dtype)
        else:
            g_send = torch.zeros_like(mb)

        fwd_buf = _spmd._permute(act_out.to(mb.dtype), fwd_perm, group)
        bwd_buf = _spmd._permute(g_send, bwd_perm, group)

    # every stage's loss_acc is zero except the last; replicate it
    loss = _spmd._all_reduce(loss_acc, group) / num_micro
    names = mesh.mesh_dim_names
    placements = [Shard(0) if n == axis else Replicate() for n in names]
    out = []
    for leaf, acc in zip(leaves, grad_acc):
        g = (acc / num_micro)[None]
        if isinstance(leaf, DTensor):
            g = DTensor.from_local(g, mesh, placements, run_check=False)
        out.append(g)
    return loss, _unflatten(stacked_params, out)
