"""Ring attention: exact attention over sequences split on the ``sp`` mesh
axis.

Counterpart: ``ray_tpu/ops/ring_attention.py``. Each rank holds a
contiguous sequence chunk of q/k/v; the kv chunks rotate around the ring
(``parallel/_spmd.ppermute``, P2P send/recv to the neighbour) while each
rank merges online-softmax partial results against its local q. After
``sp`` steps every q block has seen every kv block, with memory O(S_local).

The JAX package computes this in plain XLA, outside any Pallas kernel;
this is plain PyTorch, in float32 with the same -1e30 masking. Layout:
``[B, S, H, D]`` queries, ``[B, S, Hkv, D]`` keys and values (GQA: query
head h reads kv head h // (H // Hkv)).
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from ray_tpu_torch.parallel import _spmd

NEG_INF = -1e30


def _partial_attn(q, k, v, q_off: int, k_off: int, causal: bool,
                  sm_scale: float):
    """Unnormalized blockwise attention of local q against one kv chunk.

    q: [B, Sq, H, D], k/v: [B, Sk, Hkv, D]. Offsets are global sequence
    positions of element 0. Returns (num [B,Sq,H,D] f32, m, l [B,Sq,H,1]
    f32)."""
    b, sq, h, d = q.shape
    _, sk, hkv, _ = k.shape
    group = h // hkv
    qg = q.reshape(b, sq, hkv, group, d)
    s = torch.einsum("bqhgd,bkhd->bqhgk", qg.float(), k.float()) * sm_scale
    if causal:
        qpos = q_off + torch.arange(sq, device=q.device)
        kpos = k_off + torch.arange(sk, device=q.device)
        mask = qpos[:, None] >= kpos[None, :]          # [Sq, Sk]
        s = torch.where(mask[None, :, None, None, :], s, NEG_INF)
    m = torch.amax(s, dim=-1, keepdim=True)            # [b,q,hkv,g,1]
    m = torch.clamp(m, min=NEG_INF)                    # fully-masked rows stay finite
    p = torch.exp(s - m)
    p = torch.where(s <= NEG_INF, 0.0, p)              # kill masked contributions
    l = p.sum(dim=-1, keepdim=True)
    num = torch.einsum("bqhgk,bkhd->bqhgd", p, v.float())
    return (num.reshape(b, sq, h, d), m.reshape(b, sq, h, 1),
            l.reshape(b, sq, h, 1))


def ring_attention_local(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         axis: str, *, mesh, causal: bool = True,
                         sm_scale: Optional[float] = None) -> torch.Tensor:
    """q/k/v are this rank's local [B, S_local, (H|Hkv), D] shards of
    sequences split over axis ``axis`` of ``mesh`` (JAX reads the axis
    from its ``shard_map``; here the mesh is an argument, so a block that
    remat runs again in backward sees it on any thread). Differentiable:
    the kv cotangents travel the reverse ring."""
    if mesh is None:
        raise ValueError("ring attention needs the mesh of its axis")
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    n = _spmd.axis_size(mesh, axis)
    me = _spmd.axis_index(mesh, axis)
    group = _spmd.axis_group(mesh, axis)
    sq, sk = q.shape[1], k.shape[1]
    perm = [(i, (i + 1) % n) for i in range(n)]
    b, _, h, d = q.shape
    acc = torch.zeros((b, sq, h, d), dtype=torch.float32, device=q.device)
    m_run = torch.full((b, sq, h, 1), NEG_INF, dtype=torch.float32,
                       device=q.device)
    l_run = torch.zeros((b, sq, h, 1), dtype=torch.float32, device=q.device)
    k_cur, v_cur = k, v
    for i in range(n):
        src = (me - i) % n                      # global chunk index k_cur holds
        num, m_blk, l_blk = _partial_attn(q, k_cur, v_cur, me * sq, src * sk,
                                          causal, sm_scale)
        m_new = torch.maximum(m_run, m_blk)
        alpha = torch.exp(m_run - m_new)
        beta = torch.exp(m_blk - m_new)
        acc = acc * alpha + num * beta
        l_run = l_run * alpha + l_blk * beta
        m_run = m_new
        if i + 1 < n:  # the last rotation would bring back what is unused
            k_cur = _spmd.ppermute(k_cur, perm, group)
            v_cur = _spmd.ppermute(v_cur, perm, group)
    l_run = torch.where(l_run == 0.0, 1.0, l_run)
    return (acc / l_run).to(q.dtype)


def _seq_placements(mesh, axis: str):
    from torch.distributed.tensor import Replicate, Shard

    names = mesh.mesh_dim_names
    return [Shard(1) if name == axis else Replicate() for name in names]


def _local_seq_shard(t, mesh, placements):
    from torch.distributed.tensor import DTensor, Replicate

    if not isinstance(t, DTensor):
        t = DTensor.from_local(t, mesh, [Replicate()] * len(placements),
                               run_check=False)
    return t.redistribute(mesh, placements).to_local()


def ring_attention(q, k, v, mesh, *, axis: str = "sp", causal: bool = True,
                   sm_scale: Optional[float] = None):
    """Whole-array entry: q/k/v [B, S, H, D] (plain tensors, the same on
    every rank, or DTensors) are split over ``axis`` on their seq dim and
    run through the ring. Returns a DTensor split ``Shard(1)`` over
    ``axis`` (replicated over the mesh's other dims). S must divide evenly
    by the axis size."""
    from torch.distributed.tensor import DTensor

    placements = _seq_placements(mesh, axis)
    ql, kl, vl = (_local_seq_shard(t, mesh, placements) for t in (q, k, v))
    out = ring_attention_local(ql, kl, vl, axis, causal=causal,
                               sm_scale=sm_scale, mesh=mesh)
    return DTensor.from_local(out, mesh, placements, run_check=False)
