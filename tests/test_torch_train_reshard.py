"""Kill and resharded restore of the mesh train step, the twin of
``tests/test_train_8b_reshard.py``: ``TorchTrainer`` with 4 gloo CPU
workers trains llama_debug on a fsdp2 x tp2 ``DeviceMesh``, checkpoints
after step 2 and dies; the retry resumes from the checkpoint on a fsdp4
mesh (every shard boundary moves: the tp-split heads, ffn columns and vocab
come back whole, the embed dims split four ways), and the post-restore
losses equal an uninterrupted fsdp2 x tp2 run's within ``METRIC_TOL``
(2e-5 abs, 2e-4 rel). The checkpoint holds every leaf whole (gathered with
``full_tensor``, written by rank 0); the restore places each leaf on the
new mesh with its new placements. JAX's test uses one worker over 8
virtual devices and llama3_8b's widths; the port's world is 4 processes at
llama_debug's (the CPU tests run narrow). This module imports no JAX: the
workers import it to run the loop.
"""

import os
import tempfile

import numpy as np
import pytest
import torch

import ray_tpu_torch as rt
from ray_tpu_torch import train
from ray_tpu_torch.train import (Checkpoint, FailureConfig, RunConfig,
                                 ScalingConfig, TorchConfig, TorchTrainer)

METRIC_TOL = dict(atol=2e-5, rtol=2e-4)
TOTAL_STEPS = 4
KILL_AFTER = 2  # checkpoint after step index 1, die before step 2
BATCH, SEQ = 4, 32
WORKERS = 4


@pytest.fixture(scope="module")
def cluster():
    from tests.test_torch_runtime_cluster import retire_leftover_jax_runtime

    retire_leftover_jax_runtime()
    rt.init(num_cpus=8, num_gpus=0, object_store_memory=128 * 1024 * 1024)
    yield
    rt.shutdown()


def _save(path, state):
    """Every leaf whole: ``to_jax`` gathers each DTensor (a collective every
    rank calls); rank 0 writes."""
    from ray_tpu_torch._private import convert

    trees = {"params": convert.to_jax(state.params),
             "mu": convert.to_jax(state.opt_state.mu),
             "nu": convert.to_jax(state.opt_state.nu)}
    flat = {"count": np.asarray(state.opt_state.count),
            "step": np.asarray(state.step)}

    def walk(t, prefix):
        for k, v in t.items():
            if isinstance(v, dict):
                walk(v, f"{prefix}{k}/")
            else:
                flat[prefix + k] = v

    walk(trees, "")
    if train.get_context().get_world_rank() == 0:
        np.savez(path, **flat)


def _restore(path, cfg, mesh):
    """The checkpoint's whole leaves placed on ``mesh`` by the rules."""
    from ray_tpu_torch._private import convert
    from ray_tpu_torch.models.training import AdamWState, TrainState
    from ray_tpu_torch.models.transformer import logical_axes, map_params
    from ray_tpu_torch.parallel.sharding import param_specs, shard_params

    with np.load(path) as data:
        flat = {k: data[k] for k in data.files}
    trees = {}
    for key, arr in flat.items():
        node = trees
        parts = key.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = arr
    placed = {}
    for name in ("params", "mu", "nu"):
        tree = convert.from_jax(trees[name])
        specs = param_specs(tree, mesh, logical=logical_axes(cfg))
        placed[name] = shard_params(tree, mesh, specs=specs)
    params = map_params(lambda _p, t: t.requires_grad_(True),
                        placed["params"])
    return TrainState(params=params,
                      opt_state=AdamWState(count=int(trees["count"]),
                                           mu=placed["mu"],
                                           nu=placed["nu"]),
                      step=int(trees["step"]))


def _loop(config):
    import torch.distributed as dist

    from ray_tpu_torch.models import presets
    from ray_tpu_torch.models.training import (OptimizerConfig,
                                               init_train_state,
                                               make_train_step)
    from ray_tpu_torch.parallel.mesh import MeshSpec, build_mesh

    torch.set_num_threads(1)
    die = (config.get("die_after") is not None
           and not os.path.exists(config["marker"]))
    ckpt_in = train.get_checkpoint()
    sizes = config["mesh_resume"] if ckpt_in is not None \
        else config["mesh_fresh"]
    mesh = build_mesh(MeshSpec.of(**sizes), device_type="cpu")
    cfg = presets.llama_debug(max_seq_len=SEQ)
    ocfg = OptimizerConfig(warmup_steps=1, decay_steps=50)
    state, tx = init_train_state(cfg, ocfg, seed=0, device="cpu", mesh=mesh)
    if ckpt_in is not None:
        with ckpt_in.as_directory() as d:
            state = _restore(os.path.join(d, "state.npz"), cfg, mesh)
    placements = str(state.params["blocks"][0]["mlp"]["w_gate"].placements)
    step_fn = make_train_step(cfg, tx, mesh, log_grad_norm=False)
    for step in range(state.step, config["total_steps"]):
        toks = np.random.RandomState(1234 + step).randint(
            0, cfg.vocab_size, (BATCH, SEQ))
        state, m = step_fn(state, {"tokens": toks})
        metrics = {"step": step, "loss": float(m["loss"]),
                   "mesh": str(sizes), "placements": placements}
        if config.get("ckpt_at") == step + 1:
            with tempfile.TemporaryDirectory() as d:
                _save(os.path.join(d, "state.npz"), state)
                train.report(metrics, checkpoint=Checkpoint.from_directory(d))
        else:
            train.report(metrics)
        if die and config["die_after"] == step + 1:
            dist.barrier()
            if dist.get_rank() == 0:
                open(config["marker"], "w").close()
            dist.barrier()
            os._exit(1)


def _losses_by_step(result):
    out = {}
    for m in result.metrics_history:
        out[m["step"]] = m  # later incarnations overwrite
    return out


def test_mesh_kill_restore_reshard(cluster, tmp_path):
    storage = str(tmp_path / "results")
    marker = str(tmp_path / "killed-once")
    base = dict(total_steps=TOTAL_STEPS, mesh_fresh={"fsdp": 2, "tp": 2},
                mesh_resume={"fsdp": 4})

    def fit(name, **extra):
        return TorchTrainer(
            _loop, train_loop_config=dict(base, **extra),
            scaling_config=ScalingConfig(num_workers=WORKERS),
            torch_config=TorchConfig(backend="gloo"),
            run_config=RunConfig(storage_path=storage, name=name,
                                 failure_config=FailureConfig(
                                     max_failures=2))).fit()

    # uninterrupted reference trajectory (the same mesh throughout)
    ref = fit("straight", mesh_resume=base["mesh_fresh"])
    assert ref.error is None, ref.error
    ref_m = _losses_by_step(ref)
    assert sorted(ref_m) == list(range(TOTAL_STEPS))

    res = fit("reshard", ckpt_at=KILL_AFTER, die_after=KILL_AFTER,
              marker=marker)
    assert res.error is None, res.error
    assert os.path.exists(marker)  # the kill really happened
    got = _losses_by_step(res)
    assert sorted(got) == list(range(TOTAL_STEPS))
    for step in range(TOTAL_STEPS):
        resumed = step >= KILL_AFTER
        assert got[step]["mesh"] == str(
            base["mesh_resume"] if resumed else base["mesh_fresh"])
        np.testing.assert_allclose(
            got[step]["loss"], ref_m[step]["loss"], **METRIC_TOL,
            err_msg=f"loss diverged at step {step} after resharded restore")
    # the restore moved every shard boundary: w_gate went from fsdp on
    # embed and tp on mlp to fsdp alone on embed
    assert got[0]["placements"] == "(Shard(dim=0), Shard(dim=1))"
    assert got[KILL_AFTER]["placements"] == "(Shard(dim=0),)"
