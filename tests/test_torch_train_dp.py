"""The port's Train (``ray_tpu_torch.train``) on the CPU: the worker group,
``DataParallelTrainer`` (fit, loop config, checkpointing, resume, a user
error surfacing, a failure retry that resumes from a checkpoint: the twins
of ``tests/test_train.py``'s), ``TorchConfig``, the ``GradientAverager``
(the twin of ``tests/test_collective.py``'s ``grad_average``, its world-1
path and its ``on_bucket`` order) and data-parallel parity.

DP parity: ``TorchTrainer`` with 2 CPU workers (``TorchConfig(backend=
"gloo")``, the host ``GradientAverager``) trains a tiny GPT-2 and
llama_debug in float32 for 5 steps, each rank on its half of each batch,
from a JAX state carried over with ``convert.train_state_from_jax``. Held
against JAX's ``loss_fn`` + ``jax.value_and_grad`` on the same halves, the
grads averaged, with optax's update; and against JAX's ``make_train_step``
on the full batch. Tolerances are ``tests/test_torch_train.py``'s: losses
and grad norms rtol 1e-5, params and Adam moments atol 1e-6 + rtol 1e-4.
Both ranks end with the same params, bit for bit. Every ``get`` and fit
waits at most ``TIMEOUT`` seconds.
"""

import json
import os
import tempfile
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import ray_tpu_torch as rt
from ray_tpu.models import training as jtraining
from ray_tpu.models import transformer as jtransformer
from ray_tpu_torch import train
from ray_tpu_torch._private import convert
from ray_tpu_torch.models import training
from ray_tpu_torch.train import (Checkpoint, DataParallelTrainer,
                                 FailureConfig, GradientAverager, RunConfig,
                                 ScalingConfig, TorchConfig, TorchTrainer)
from ray_tpu_torch.train._internal.gradients import (tree_flatten,
                                                     tree_unflatten)
from ray_tpu_torch.train._internal.worker_group import WorkerGroup
from tests.test_torch_train import MODELS, _np

os.environ.setdefault("RAY_TPU_TORCH_LOG_LEVEL", "WARNING")

TIMEOUT = 120
LOSS_RTOL = 1e-5
STATE_TOL = dict(atol=1e-6, rtol=1e-4)
STEPS = 5


@pytest.fixture(scope="module")
def cluster():
    rt.init(num_cpus=16, num_gpus=0, object_store_memory=256 * 1024 * 1024)
    yield
    rt.shutdown()


@pytest.fixture
def storage(tmp_path):
    return str(tmp_path / "results")


# ------------------------------------------------ worker group and trainer


def test_worker_group_start_execute_shutdown(cluster):
    wg = WorkerGroup(num_workers=2, resources_per_worker={"CPU": 1})
    wg.start()
    try:
        assert len(wg) == 2
        outs = wg.execute(os.getpid)
        assert len(outs) == 2 and len(set(outs)) == 2
        assert sorted(w.world_rank for w in wg.workers) == [0, 1]
        assert sorted(w.local_rank for w in wg.workers) == [0, 1]
        assert all(w.node_rank == 0 for w in wg.workers)
        assert all(w.visible == "" for w in wg.workers)  # no card asked
    finally:
        wg.shutdown()


def test_basic_fit(cluster, storage):
    def loop():
        ctx = train.get_context()
        for step in range(3):
            train.report({"step": step, "rank": ctx.get_world_rank(),
                          "world_size": ctx.get_world_size()})

    res = DataParallelTrainer(
        loop, scaling_config=ScalingConfig(num_workers=2),
        run_config=RunConfig(storage_path=storage, name="basic")).fit()
    assert res.error is None
    assert res.metrics == {"step": 2, "rank": 0, "world_size": 2}
    assert len(res.metrics_history) == 3


def test_train_loop_config(cluster, storage):
    def loop(config):
        train.report({"doubled": config["x"] * 2})

    res = DataParallelTrainer(
        loop, train_loop_config={"x": 21},
        scaling_config=ScalingConfig(num_workers=1),
        run_config=RunConfig(storage_path=storage)).fit()
    assert res.metrics["doubled"] == 42


def test_checkpointing(cluster, storage):
    def loop():
        ctx = train.get_context()
        for step in range(3):
            with tempfile.TemporaryDirectory() as d:
                ckpt = None
                if ctx.get_world_rank() == 0:
                    with open(os.path.join(d, "state.json"), "w") as f:
                        json.dump({"step": step}, f)
                    ckpt = Checkpoint.from_directory(d)
                train.report({"step": step}, checkpoint=ckpt)

    res = DataParallelTrainer(
        loop, scaling_config=ScalingConfig(num_workers=2),
        run_config=RunConfig(storage_path=storage, name="ckpt")).fit()
    assert res.error is None and res.checkpoint is not None
    with res.checkpoint.as_directory() as d:
        with open(os.path.join(d, "state.json")) as f:
            assert json.load(f)["step"] == 2
    assert res.checkpoint.path.startswith(res.path)


def test_resume_from_checkpoint(cluster, storage, tmp_path):
    src = tmp_path / "init_ckpt"
    src.mkdir()
    (src / "marker.txt").write_text("hello")

    def loop():
        ckpt = train.get_checkpoint()
        assert ckpt is not None
        with ckpt.as_directory() as d:
            with open(os.path.join(d, "marker.txt")) as f:
                train.report({"content": f.read()})

    res = DataParallelTrainer(
        loop, scaling_config=ScalingConfig(num_workers=1),
        run_config=RunConfig(storage_path=storage),
        resume_from_checkpoint=Checkpoint.from_directory(str(src))).fit()
    assert res.metrics["content"] == "hello"


def test_user_error_surfaces(cluster, storage):
    def loop():
        train.report({"ok": 1})
        raise ValueError("boom")

    res = DataParallelTrainer(
        loop, scaling_config=ScalingConfig(num_workers=1),
        run_config=RunConfig(storage_path=storage)).fit()
    assert res.error is not None and "boom" in str(res.error)


def test_failure_retry_resumes_from_checkpoint(cluster, storage):
    marker = os.path.join(storage, "attempt_count")

    def loop():
        os.makedirs(storage, exist_ok=True)
        attempts = 0
        if os.path.exists(marker):
            with open(marker) as f:
                attempts = int(f.read())
        with open(marker, "w") as f:
            f.write(str(attempts + 1))
        ckpt = train.get_checkpoint()
        start = 0
        if ckpt is not None:
            with ckpt.as_directory() as d:
                with open(os.path.join(d, "state.json")) as f:
                    start = json.load(f)["step"] + 1
        for step in range(start, 4):
            with tempfile.TemporaryDirectory() as d:
                with open(os.path.join(d, "state.json"), "w") as f:
                    json.dump({"step": step}, f)
                train.report({"step": step, "attempt": attempts},
                             checkpoint=Checkpoint.from_directory(d))
            if attempts == 0 and step == 1:
                raise RuntimeError("injected failure")

    res = DataParallelTrainer(
        loop, scaling_config=ScalingConfig(num_workers=1),
        run_config=RunConfig(storage_path=storage, name="retry",
                             failure_config=FailureConfig(max_failures=2)),
    ).fit()
    assert res.error is None
    assert res.metrics["step"] == 3 and res.metrics["attempt"] == 1
    # resumed from step 2, not from scratch
    assert [m["step"] for m in res.metrics_history].count(0) == 1


def test_torch_config_process_group(cluster, storage):
    """``distributed=None`` forms the process group at world 2 and not at
    world 1; ``distributed=True`` forces it at world 1."""
    def loop():
        import torch.distributed as dist

        on = dist.is_initialized()
        x = torch.tensor([float(train.get_context().get_world_rank() + 1)])
        if on:
            dist.all_reduce(x)
        train.report({"on": on, "backend": dist.get_backend() if on else "",
                      "sum": x.item()})

    for n, distributed, want in ((2, None, (True, "gloo", 3.0)),
                                 (1, None, (False, "", 1.0)),
                                 (1, True, (True, "gloo", 1.0))):
        res = TorchTrainer(
            loop, scaling_config=ScalingConfig(num_workers=n),
            torch_config=TorchConfig(distributed=distributed),
            run_config=RunConfig(storage_path=storage)).fit()
        assert res.error is None, res.error
        assert (res.metrics["on"], res.metrics["backend"],
                res.metrics["sum"]) == want


def test_torch_config_nccl_without_a_card_raises(cluster, storage):
    """An "nccl" process group on workers without a card fails the fit
    before the loop runs; it does not drop to gloo."""
    trainer = TorchTrainer(
        lambda: train.report({"ran": True}),
        scaling_config=ScalingConfig(num_workers=1),
        torch_config=TorchConfig(backend="nccl", distributed=True),
        run_config=RunConfig(storage_path=storage))
    with pytest.raises(rt.TaskError, match="no CUDA card"):
        trainer.fit()
    with pytest.raises(ValueError, match="nccl"):
        TorchConfig(backend="mpi")


# ------------------------------------------------------- gradient averager


@rt.remote
class AvgRank:
    def average(self, name, world, rank, value):
        """The twin of tests/test_collective.py's grad_average, over a
        tree of tensors (explicit ranks, no session)."""
        avg = GradientAverager(group_name=name, world_size=world, rank=rank)
        tree = {"w": torch.full((8, 4), float(value)),
                "b": [torch.full((4,), float(value) * 2),
                      torch.full((3,), float(value) * 3).bfloat16()]}
        seen = []
        got = avg.begin(tree, on_bucket=lambda i, a: seen.append(i)
                        ).wait_tree()
        avg.shutdown()
        return (got["w"][0, 0].item(), got["b"][0][0].item(),
                got["b"][1][0].item(), str(got["b"][1].dtype), seen)


def test_grad_average(cluster):
    actors = [AvgRank.remote() for _ in range(2)]
    got = rt.get([a.average.remote("ga", 2, r, v)
                  for r, (a, v) in enumerate(zip(actors, (1.0, 3.0)))],
                 timeout=TIMEOUT)
    for w, b0, b1, dt, seen in got:
        assert (w, b0, b1, dt) == (2.0, 4.0, 6.0, "torch.bfloat16")
        # flatten order: b[0], b[1], w (dicts by sorted key); one bucket
        assert seen == [[0, 1, 2]]
    for a in actors:
        rt.kill(a)


def test_world_one_average_copies():
    """World 1: the average is a copy of each leaf on its own device (no
    group, nothing aliased), and on_bucket still fires once per bucket."""
    avg = GradientAverager(world_size=1, rank=0)
    tree = {"a": torch.ones(3), "b": (np.arange(4.0), torch.zeros(2))}
    seen = []
    got = avg.begin(tree, on_bucket=lambda i, a: seen.append(i)).wait_tree()
    # leaves a, b[0], b[1]: the float64 array parts the float32 tensors
    # into three buckets, fired last first
    assert isinstance(got["b"], tuple) and seen == [[2], [1], [0]]
    assert torch.equal(got["a"], tree["a"])
    assert got["a"].data_ptr() != tree["a"].data_ptr()
    assert np.array_equal(got["b"][0], tree["b"][0])
    assert got["b"][0] is not tree["b"][0]


def test_tree_flatten_order():
    tree = {"z": [1, (2, 3)], "a": {"y": 4, "b": 5}}
    leaves, d = tree_flatten(tree)
    assert leaves == [5, 4, 1, 2, 3]
    assert tree_unflatten(d, leaves) == tree


# ------------------------------------------------------------- DP parity


def _dp_loop(config):
    """Each rank: loss and grads on its half of each batch, the host
    GradientAverager, the port's AdamW; rank 0 reports both ranks' losses
    (gathered over the averager's group) and the grad norm; at the end each
    rank writes its state into the checkpoint."""
    import torch.distributed as dist

    from ray_tpu_torch.models.training import AdamW
    from ray_tpu_torch.models.transformer import _leaves, loss_fn
    from ray_tpu_torch.util import collective

    ctx = train.get_context()
    r, n = ctx.get_world_rank(), ctx.get_world_size()
    cfg, state = config["cfg"], config["state"]
    # the state arrives through the object store as plain tensors
    for t in _leaves(state.params):
        t.requires_grad_(True)
    tx = AdamW(config["ocfg"])
    avg = GradientAverager()
    for i, batch in enumerate(config["batches"]):
        rows = batch["tokens"].shape[0] // n
        half = {"tokens": torch.tensor(
            batch["tokens"][r * rows:(r + 1) * rows])}
        leaves = _leaves(state.params)
        value, m = loss_fn(cfg, state.params, half)
        grads = torch.autograd.grad(value, leaves)
        grads = avg.average(list(grads))
        g_norm = tx.update(grads, state.opt_state, state.params)
        state.step += 1
        losses = collective.allgather(m["loss"].detach().reshape(1),
                                      group_name=avg.group_name)
        with tempfile.TemporaryDirectory() as d:
            ckpt = None
            if i == len(config["batches"]) - 1:
                torch.save({"params": [t.detach() for t in leaves],
                            "mu": _leaves(state.opt_state.mu),
                            "nu": _leaves(state.opt_state.nu),
                            "count": state.opt_state.count},
                           os.path.join(d, f"rank{r}.pt"))
                ckpt = Checkpoint.from_directory(d)
            train.report({"losses": [x.item() for x in losses],
                          "grad_norm": g_norm.item(),
                          "world": dist.get_world_size()}, checkpoint=ckpt)


def _jax_runs(jcfg, jstate, jtx, batches):
    """JAX on the same halves (grads averaged, optax's update) and on the
    full batch: per step (half losses, norm) and (loss, norm), and the
    final states."""
    vg = jax.value_and_grad(partial(jtransformer.loss_fn, jcfg), has_aux=True)

    @jax.jit
    def halves(state, b0, b1):
        (_, m0), g0 = vg(state.params, b0)
        (_, m1), g1 = vg(state.params, b1)
        # the port pre-scales each rank's grads by 1/2 and sums
        g = jax.tree.map(lambda a, b: a * 0.5 + b * 0.5, g0, g1)
        updates, opt = jtx.update(g, state.opt_state, state.params)
        return (jtraining.TrainState(
            params=optax.apply_updates(state.params, updates),
            opt_state=opt, step=state.step + 1),
            (m0["loss"], m1["loss"], optax.global_norm(g)))

    full_step = jtraining.make_train_step(jcfg, jtx, donate=False)
    hs, fs = jstate, jstate
    half_m, full_m = [], []
    for b in batches:
        t = jnp.asarray(b["tokens"])
        rows = t.shape[0] // 2
        hs, m = halves(hs, {"tokens": t[:rows]}, {"tokens": t[rows:]})
        half_m.append([float(x) for x in m])
        fs, m = full_step(fs, {"tokens": t})
        full_m.append((float(m["loss"]), float(m["grad_norm"])))
    return half_m, full_m, hs, fs


@pytest.mark.parametrize("name", sorted(MODELS))
def test_dp_parity_with_jax(cluster, storage, name):
    jcfg_fn, cfg_fn = MODELS[name]
    jcfg, cfg = jcfg_fn(ce_chunk=8), cfg_fn(ce_chunk=8)
    jocfg = jtraining.OptimizerConfig(learning_rate=1e-2, warmup_steps=2,
                                      decay_steps=6)
    jstate, jtx = jtraining.init_train_state(jcfg, jocfg,
                                             jax.random.PRNGKey(0))
    rng = np.random.default_rng(7)
    batches = [{"tokens": rng.integers(0, cfg.vocab_size, (4, 12)).astype(
        np.int64)} for _ in range(STEPS)]
    res = TorchTrainer(
        _dp_loop,
        train_loop_config={
            "cfg": cfg, "batches": batches,
            "state": convert.train_state_from_jax(_np(jstate), device="cpu"),
            "ocfg": training.OptimizerConfig(**jocfg.__dict__)},
        scaling_config=ScalingConfig(num_workers=2),
        torch_config=TorchConfig(backend="gloo"),
        run_config=RunConfig(storage_path=storage, name=f"dp-{name}")).fit()
    assert res.error is None, res.error
    assert len(res.metrics_history) == STEPS
    half_m, full_m, hs, fs = _jax_runs(jcfg, jstate, jtx, batches)
    for i, (m, (l0, l1, gn), (fl, fgn)) in enumerate(zip(
            res.metrics_history, half_m, full_m)):
        assert m["world"] == 2
        np.testing.assert_allclose(m["losses"], [l0, l1], rtol=LOSS_RTOL,
                                   err_msg=f"half losses, step {i}")
        np.testing.assert_allclose(m["grad_norm"], gn, rtol=LOSS_RTOL,
                                   err_msg=f"grad norm, step {i}")
        # equal token counts: the mean of the halves is the full batch's
        np.testing.assert_allclose(np.mean(m["losses"]), fl, rtol=LOSS_RTOL,
                                   err_msg=f"full-batch loss, step {i}")
        np.testing.assert_allclose(m["grad_norm"], fgn, rtol=LOSS_RTOL,
                                   err_msg=f"full-batch grad norm, step {i}")
    with res.checkpoint.as_directory() as d:
        ranks = [torch.load(os.path.join(d, f"rank{r}.pt")) for r in (0, 1)]
    for key in ("params", "mu", "nu"):
        for a, b in zip(ranks[0][key], ranks[1][key]):
            assert torch.equal(a, b), f"{key} differs between the ranks"
    assert ranks[0]["count"] == STEPS
    for want_state in (hs, fs):
        want = convert.train_state_from_jax(_np(want_state), device="cpu")
        for key, tree in (("params", want.params), ("mu", want.opt_state.mu),
                          ("nu", want.opt_state.nu)):
            for a, b in zip(ranks[0][key], tree_leaves(tree)):
                np.testing.assert_allclose(a.numpy(), b.detach().numpy(),
                                           **STATE_TOL, err_msg=key)


def tree_leaves(tree):
    from ray_tpu_torch.models.transformer import _leaves

    return _leaves(tree)
