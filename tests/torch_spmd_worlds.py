"""Gloo worlds on the CPU for the port's SPMD tests.

``run_world(fn, n, tmp_path, **kw)`` spawns ``n`` processes, each running
``fn(rank, n, **kw)`` in a ``torch.distributed`` gloo group that meets
through a ``FileStore`` under ``tmp_path`` (so parallel test workers never
share a port), with one thread each, and is stopped if it has not ended
after ``WORLD_TIMEOUT_S``. Each process's return value is
pickled to ``tmp_path``; ``run_world`` returns them by rank and raises if a
process failed. ``start_world`` returns at once with a handle whose
``join()`` does the rest, so a test computes JAX's side while the world
runs. This module imports no JAX and no module of the JAX
package: the worlds run the port alone, and the tests hold their results
against JAX in the test process.
"""

from __future__ import annotations

import collections
import dataclasses
import datetime
import os
import pickle
import threading
import time
import traceback
from typing import Any

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

# a world that has not ended by then is stopped and fails its test; each
# collective gives up after COLLECTIVE_TIMEOUT_S
WORLD_TIMEOUT_S = 300
COLLECTIVE_TIMEOUT_S = 120

# a JAX TrainState's shape without JAX: ``convert`` finds the optax states
# by their field names
ScaleByAdamState = collections.namedtuple("ScaleByAdamState",
                                          ["count", "mu", "nu"])
ScaleByScheduleState = collections.namedtuple("ScaleByScheduleState",
                                              ["count"])


@dataclasses.dataclass
class StateLike:
    params: Any
    opt_state: Any
    step: Any


def _entry(rank, fn, n, root):
    torch.set_num_threads(1)
    torch.backends.cuda.matmul.allow_tf32 = False
    out_path = os.path.join(root, f"rank{rank}.pkl")
    try:
        with open(os.path.join(root, "kw.pkl"), "rb") as f:
            kw = pickle.load(f)
        store = dist.FileStore(os.path.join(root, "store"), n)
        dist.init_process_group(
            "gloo", store=store, rank=rank, world_size=n,
            timeout=datetime.timedelta(seconds=COLLECTIVE_TIMEOUT_S))
        try:
            result = fn(rank, n, **kw)
        finally:
            dist.destroy_process_group()
        with open(out_path, "wb") as f:
            pickle.dump(("ok", result), f)
    except BaseException:
        with open(out_path, "wb") as f:
            pickle.dump(("error", traceback.format_exc()), f)
        raise


class World:

    def __init__(self, ctx, root: str, n: int):
        self.ctx, self.root, self.n = ctx, root, n

    def join(self):
        return _join(self.ctx, self.root, self.n)


def start_world(fn, n: int, tmp_path, **kw) -> World:
    root = os.path.join(str(tmp_path), f"world_{fn.__name__}")
    os.makedirs(root, exist_ok=True)
    # the arguments go through a file: spawn pipes each child its pickled
    # arguments, and a write past the pipe's buffer waits until that child
    # has imported torch, which starts the children one after another
    with open(os.path.join(root, "kw.pkl"), "wb") as f:
        pickle.dump(kw, f)
    ctx = mp.start_processes(_entry, args=(fn, n, root), nprocs=n,
                             join=False, start_method="spawn")
    return World(ctx, root, n)


def run_world(fn, n: int, tmp_path, **kw):
    return start_world(fn, n, tmp_path, **kw).join()


def _join(ctx, root: str, n: int):
    deadline = time.monotonic() + WORLD_TIMEOUT_S
    try:
        while not ctx.join(timeout=1.0):
            if time.monotonic() > deadline:
                for p in ctx.processes:
                    if p.is_alive():
                        p.kill()
                raise TimeoutError(f"the world of {n} did not end within "
                                   f"{WORLD_TIMEOUT_S} s")
    except Exception as e:
        errors = []
        for r in range(n):
            p = os.path.join(root, f"rank{r}.pkl")
            if os.path.exists(p):
                with open(p, "rb") as f:
                    status, val = pickle.load(f)
                if status == "error":
                    errors.append(f"rank {r}:\n{val}")
        raise RuntimeError("\n".join(errors) or str(e)) from e
    results = []
    for r in range(n):
        with open(os.path.join(root, f"rank{r}.pkl"), "rb") as f:
            status, val = pickle.load(f)
        if status != "ok":
            raise RuntimeError(f"rank {r}:\n{val}")
        results.append(val)
    return results


# ------------------------------------------------------------------ helpers


def full(t):
    """A DTensor's (or tensor's) whole value as float64 numpy; for a DTensor
    a collective every rank calls."""
    from torch.distributed.tensor import DTensor

    if isinstance(t, DTensor):
        t = t.full_tensor()
    return t.detach().to(torch.float64).numpy()


def _params_from_npz(path):
    import numpy as np

    from ray_tpu_torch._private import convert

    with np.load(path) as data:
        flat = {k: data[k] for k in data.files}
    tree = {}
    for key, arr in flat.items():
        node = tree
        parts = key.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = arr
    return convert.from_jax(tree)


def save_tree(path, tree):
    """A nested dict of numpy arrays to an npz (keys joined with '/')."""
    import numpy as np

    flat = {}

    def walk(t, prefix):
        for k, v in t.items():
            if isinstance(v, dict):
                walk(v, f"{prefix}{k}/")
            else:
                flat[f"{prefix}{k}"] = np.asarray(v)

    walk(tree, "")
    np.savez(path, **flat)


def train_world(rank, n, params_npz, tokens, steps, mesh_sizes, lrs,
                meshless_lr, state_like):
    """The fsdp x tp mesh step from the converted JAX params, ``steps``
    steps on ``tokens`` at each learning rate of ``lrs``; at
    ``meshless_lr`` rank 0 also runs the port's meshless step from the
    same params. ``state_like`` (a JAX TrainState's shape) goes through
    ``convert`` onto the mesh and back."""
    from ray_tpu_torch._private import convert
    from ray_tpu_torch.models import presets, training
    from ray_tpu_torch.models.transformer import logical_axes
    from ray_tpu_torch.parallel.mesh import MeshSpec, build_mesh
    from ray_tpu_torch.parallel.sharding import param_specs

    cfg = presets.llama_debug()
    mesh = build_mesh(MeshSpec.of(**mesh_sizes), device_type="cpu")
    specs = param_specs(convert.from_jax(state_like.params), mesh,
                        logical=logical_axes(cfg))
    meshed = convert.train_state_from_jax(state_like, device="cpu",
                                          mesh=mesh, specs=specs)
    out = {"round_trip": convert.train_state_to_jax(meshed, like=state_like),
           "round_trip_placements": {
               tree: tuple(t["blocks"][0]["mlp"]["w_gate"].placements)
               for tree, t in (("params", meshed.params),
                               ("mu", meshed.opt_state.mu),
                               ("nu", meshed.opt_state.nu))},
           "round_trip_counts": (meshed.step, meshed.opt_state.count)}
    for lr in lrs:
        ocfg = training.OptimizerConfig(learning_rate=lr, warmup_steps=1,
                                        decay_steps=100)
        state, tx = training.init_train_state(
            cfg, ocfg, device="cpu", params=_params_from_npz(params_npz),
            mesh=mesh)
        placements = {
            name: tuple(state.params["blocks"][0]["mlp"][name].placements)
            for name in ("w_gate", "w_down")}
        step = training.make_train_step(cfg, tx, mesh)
        metrics = []
        for _ in range(steps):
            state, m = step(state, {"tokens": tokens})
            metrics.append({k: float(v) for k, v in m.items()})
        run = {"mesh": metrics, "step": state.step,
               "count": state.opt_state.count, "placements": placements,
               # gathered whole: every rank calls
               "final": convert.to_jax(state.params),
               "mu": convert.to_jax(state.opt_state.mu),
               "nu": convert.to_jax(state.opt_state.nu)}
        if rank != 0:
            run = {k: run[k] for k in ("mesh", "placements")}
        elif lr == meshless_lr:
            ref, rtx = training.init_train_state(
                cfg, ocfg, device="cpu", params=_params_from_npz(params_npz))
            rstep = training.make_train_step(cfg, rtx)
            meshless = []
            for _ in range(steps):
                ref, m = rstep(ref, {"tokens": torch.as_tensor(tokens)})
                meshless.append({k: float(v) for k, v in m.items()})
            run.update(meshless=meshless,
                       meshless_final=convert.to_jax(ref.params))
        out[lr] = run
    return out


def spmd_world(rank, n, cases, params_npz, moe_npz):
    """Ring attention (sp 4), the two pipelines (pp 4, and pp 2 x dp 2),
    the pipelined transformer blocks, the ring model and the expert-
    parallel MoE forward (dp 2 x ep 2), on the inputs in ``cases``."""
    import numpy as np
    from torch.distributed.tensor import DTensor, distribute_tensor

    from ray_tpu_torch.models import presets, transformer
    from ray_tpu_torch.ops.ring_attention import (_seq_placements,
                                                  ring_attention)
    from ray_tpu_torch.parallel import _spmd, pipeline
    from ray_tpu_torch.parallel.mesh import MeshSpec, build_mesh
    from ray_tpu_torch.parallel.sharding import shard_params

    def mesh(**sizes):
        return build_mesh(MeshSpec.of(**sizes), device_type="cpu")

    def t(a, grad=False):
        return torch.tensor(np.asarray(a)).requires_grad_(grad)

    out = {}
    sp4, pp4, pp2 = mesh(sp=4), mesh(pp=4), mesh(pp=2, dp=2)
    from ray_tpu_torch.parallel.mesh import local_mesh

    lm = local_mesh(device_type="cpu", fsdp=2, tp=2)
    out["local_mesh"] = (lm.mesh_dim_names, tuple(lm.mesh.shape),
                         lm.get_coordinate())

    # ---- ring attention, forward and grads
    for name, c in cases["ring"].items():
        q, k, v = (t(c[x], grad=True) for x in "qkv")
        o = ring_attention(q, k, v, sp4, causal=c["causal"])
        assert isinstance(o, DTensor)
        local = o.to_local()
        cot = t(c["cot"]).chunk(4, dim=1)[_spmd.axis_index(sp4, "sp")]
        (local * cot).sum().backward()  # this rank's share of the loss
        grads = [full_grad(x) for x in (q, k, v)]
        out[f"ring/{name}"] = {"out": full(o), "placements": o.placements,
                               "dq": grads[0], "dk": grads[1],
                               "dv": grads[2]}

    # ---- pipeline_apply: linear stages over pp 4 (stacked DTensors)
    c = cases["linear"]
    stacked = pipeline.stack_stage_params(
        [{"w": torch.tensor(w), "b": torch.tensor(b)}
         for w, b in zip(c["w"], c["b"])])
    shard = pipeline.stage_param_sharding(stacked, pp4)
    placed = {k: distribute_tensor(v, pp4, shard[k].placements,
                                   src_data_rank=None).requires_grad_(True)
              for k, v in stacked.items()}
    y = pipeline.pipeline_apply(lambda p, x: x * p["w"] + p["b"], placed,
                                t(c["x"]), mesh=pp4)
    (y ** 2).sum().backward()
    out["linear"] = {"y": y.detach().numpy(),
                     "gw": full(placed["w"].grad),
                     "gb": full(placed["b"].grad)}

    # ---- pipeline_apply grads over pp 2 (the tanh probe), plain params
    w = torch.tensor([1.5, 0.5], requires_grad=True)
    y = pipeline.pipeline_apply(lambda p, x: torch.tanh(x * p["w"]),
                                {"w": w}, torch.ones(4, 3), mesh=pp2)
    (y ** 2).sum().backward()
    out["tanh"] = {"grad": w.grad.numpy(),
                   "stage": _spmd.axis_index(pp2, "pp")}

    # ---- 1F1B over pp 4: float32, bf16 microbatches, 32 microbatches
    for name, c in cases["1f1b"].items():
        dtype = getattr(torch, c["dtype"])
        stacked = {k: torch.tensor(np.asarray(v)).to(dtype)
                   for k, v in c["params"].items()}
        shard = pipeline.stage_param_sharding(stacked, pp4)
        placed = {k: distribute_tensor(v, pp4, shard[k].placements,
                                       src_data_rank=None)
                  for k, v in stacked.items()}
        fn = {"affine": lambda p, x: torch.tanh(x @ p["w"] + p["b"]),
              "matmul": lambda p, x: torch.tanh(x @ p["w"]),
              "scale": lambda p, x: x * p["w"]}[c["stage"]]
        loss, grads = pipeline.pipeline_1f1b(
            fn, lambda a: (a.float() ** 2).mean(), placed,
            torch.tensor(np.asarray(c["x"])).to(dtype), mesh=pp4)
        out[f"1f1b/{name}"] = {"loss": float(loss),
                               "grads": {k: full(g) for k, g in grads.items()}}

    # ---- pipelined transformer blocks: llama_debug, 4 blocks, 2 x 2
    cfg = presets.llama_debug(num_layers=4, remat=False)
    params = _params_from_npz(params_npz)
    tokens = torch.tensor(cases["tokens"]).long()
    x = params["embed"]["table"][tokens]
    rope = transformer._rope_tables(cfg.head_dim, cfg.max_seq_len,
                                    cfg.rope_theta, x.device)

    def stage_fn(stage_params, h):
        for p in stage_params:
            h, _ = transformer._block(cfg, p, h, rope, None)
        return h

    stacked = pipeline.stack_stage_params(
        [params["blocks"][0:2], params["blocks"][2:4]])
    h = pipeline.pipeline_apply(stage_fn, stacked,
                                x.reshape(2, 2, *x.shape[1:]), mesh=pp2)
    h = h.reshape(4, *h.shape[2:])
    out["blocks"] = transformer._head(cfg, params, h).detach().numpy()

    # ---- the ring branch of the model: llama_debug over sp 4
    cfg = presets.llama_debug(num_layers=4, attn_impl="ring")
    me = _spmd.axis_index(sp4, "sp")
    s_local = tokens.shape[1] // 4
    tokens_sp = tokens[:, me * s_local:(me + 1) * s_local]
    positions_sp = torch.arange(me * s_local, (me + 1) * s_local)
    logits = transformer.forward(cfg, params, tokens_sp,
                                 positions=positions_sp, sp_axis="sp",
                                 mesh=sp4)
    out["ring_model"] = full(DTensor.from_local(
        logits, sp4, _seq_placements(sp4, "sp"), run_check=False))

    # ---- expert-parallel MoE forward: moe_debug over dp 2 x ep 2
    from ray_tpu_torch.parallel.sharding import param_specs

    cfg = presets.moe_debug()
    ep = mesh(dp=2, ep=2)
    mparams = _params_from_npz(moe_npz)
    specs = param_specs(mparams, ep, logical=transformer.logical_axes(cfg))
    placed = shard_params(mparams, ep, specs=specs)
    local = transformer.map_params(lambda _p, d: d.to_local(), placed)
    tokens = torch.tensor(cases["moe_tokens"]).long()
    b = tokens.shape[0] // 2
    dp = _spmd.axis_index(ep, "dp")
    logits = transformer.forward(cfg, local, tokens[dp * b:(dp + 1) * b],
                                 mesh=ep)
    parts = [torch.empty_like(logits) for _ in range(2)]
    torch.distributed.all_gather(parts, logits,
                                 group=_spmd.axis_group(ep, "dp"))
    out["moe"] = {"logits": torch.cat(parts).detach().numpy(),
                  "w_gate_local": tuple(local["blocks"][0]["mlp"]
                                        ["w_gate"].shape),
                  "w_gate_placements": placed["blocks"][0]["mlp"]
                  ["w_gate"].placements}

    # ---- remat on, the backward on another thread (as on the card, where
    # autograd runs it on its device thread): the ring branch over sp 4 and
    # the MoE layer over dp 2 x ep 2 recompute their blocks there, with the
    # mesh each block was given; grads against remat off on this thread
    out["remat_thread"] = {}
    rng = np.random.RandomState(7)
    for name, cfg, m, tree, toks in (
            ("ring_sp4", presets.llama_debug(num_layers=4, attn_impl="ring"),
             sp4, params, tokens_sp),
            ("moe_dp2_ep2", presets.moe_debug(), ep, local,
             tokens[dp * b:(dp + 1) * b])):
        kw = dict(mesh=m)
        if name == "ring_sp4":
            kw.update(sp_axis="sp", positions=positions_sp)
        cot = None
        grads = {}
        for remat in (False, True):
            leaves = transformer.map_params(
                lambda _p, t: t.detach().clone().requires_grad_(True), tree)
            y = transformer.forward(dataclasses.replace(cfg, remat=remat),
                                    leaves, toks, **kw)
            if cot is None:
                cot = torch.tensor(rng.randn(*y.shape).astype(np.float32))
            loss = (y * cot).sum()
            flat = transformer._leaves(leaves)
            grads[remat] = (_grad_on_thread(loss, flat) if remat else
                            torch.autograd.grad(loss, flat))
        out["remat_thread"][name] = [
            float((a - b_).abs().max()) for a, b_ in zip(grads[True],
                                                         grads[False])]

    # ---- the mesh train step against the meshless one: llama_debug at
    # tp 4 (2 kv heads do not split four ways: each rank narrows them to
    # its query head's) and moe_debug at dp 2 x ep 2 (whole-batch routing,
    # each ep rank its experts)
    from ray_tpu_torch._private import convert
    from ray_tpu_torch.models import training

    out["train"] = {}
    for name, cfg, sizes, npz in (
            ("tp4_kv_narrowed", presets.llama_debug(num_layers=4),
             dict(tp=4), params_npz),
            ("dp2_ep2_moe", presets.moe_debug(), dict(dp=2, ep=2), moe_npz)):
        ocfg = training.OptimizerConfig(learning_rate=3e-4, warmup_steps=1,
                                        decay_steps=100)
        tokens = cases["train_tokens"]
        m = mesh(**sizes)
        state, tx = training.init_train_state(
            cfg, ocfg, device="cpu", params=_params_from_npz(npz), mesh=m)
        step = training.make_train_step(cfg, tx, m)
        got = []
        for _ in range(cases["train_steps"]):
            state, metrics = step(state, {"tokens": tokens})
            got.append({k: float(v) for k, v in metrics.items()})
        run = {"mesh": got, "final": convert.to_jax(state.params),
               "mu": convert.to_jax(state.opt_state.mu),
               "nu": convert.to_jax(state.opt_state.nu),
               "wk_placements": state.params["blocks"][0]["attn"]["wk"]
               .placements}
        if rank == 0:
            ref, rtx = training.init_train_state(
                cfg, ocfg, device="cpu", params=_params_from_npz(npz))
            rstep = training.make_train_step(cfg, rtx)
            want = []
            for _ in range(cases["train_steps"]):
                ref, metrics = rstep(ref, {"tokens": torch.tensor(tokens)})
                want.append({k: float(v) for k, v in metrics.items()})
            run.update(meshless=want,
                       meshless_final=convert.to_jax(ref.params),
                       meshless_mu=convert.to_jax(ref.opt_state.mu),
                       meshless_nu=convert.to_jax(ref.opt_state.nu))
        out["train"][name] = run
    return out


def _grad_on_thread(loss, leaves):
    """``torch.autograd.grad(loss, leaves)`` run on a new thread, which
    starts with none of this thread's context."""
    out = {}

    def run():
        try:
            out["grads"] = torch.autograd.grad(loss, leaves)
        except BaseException as e:  # raised on the calling thread
            out["error"] = e

    t = threading.Thread(target=run)
    t.start()
    t.join()
    if "error" in out:
        raise out["error"]
    return out["grads"]


def full_grad(x):
    """A replicated input's grad. Each rank's backward covers its own
    share of the loss; the ring brings every kv shard's cotangents home and
    the sequence split's backward gathers the shards, so every rank holds
    the whole grad."""
    return x.grad.to(torch.float64).numpy()
