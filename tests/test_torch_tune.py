"""The port's Tune (``ray_tpu_torch.tune``) on a CPU cluster: the twins of
``tests/test_tune.py`` (``TestTuner``, ``TestSchedulers``,
``TestTrainerInTuner``), of ``tests/test_tune_search.py``'s Tuner cases
(TPE, HyperBand, PB2 end to end) and of the ``AskTellSearcher`` case that
drives real trials, plus one parity case.

Parity: a llama_debug float32 function trainable under ASHA, one trial
process per learning rate, starts from JAX's ``init_params`` carried over
with ``_private/convert.py``; each trial's first-iteration loss (taken
before its first update, so it does not depend on the learning rate) is
held within rtol 1e-5 of JAX's ``loss_fn`` on the same weights and batch,
and the later losses within the same tolerance of JAX's
``make_train_step`` at that trial's learning rate. Every fit waits at
most ``TIMEOUT`` seconds per trial start.
"""

import json
import os
import sys
import tempfile
from functools import partial

import cloudpickle
import jax
import jax.numpy as jnp
import numpy as np
import pytest

import ray_tpu_torch as rt
from ray_tpu.models import training as jtraining
from ray_tpu.models import transformer as jtransformer
from ray_tpu_torch import train, tune
from ray_tpu_torch.air.config import FailureConfig, RunConfig
from ray_tpu_torch.train import Checkpoint
from ray_tpu_torch.tune import (ASHAScheduler, HyperBandScheduler, PB2,
                                PopulationBasedTraining, TPESearcher,
                                TuneConfig, Tuner)
from tests.test_torch_train import MODELS, _np
from tests.test_torch_runtime_cluster import \
    retire_leftover_jax_runtime_for_later_files

os.environ.setdefault("RAY_TPU_TORCH_LOG_LEVEL", "WARNING")
# the trainables ship by value: a trial process then never imports this
# module, and with it JAX
cloudpickle.register_pickle_by_value(sys.modules[__name__])

LOSS_RTOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def _no_leftover_jax_runtime():
    """A JAX runtime that an earlier test file left up in this worker (JAX's
    serve router threads restart a shut one) is shut down after this file,
    so the next JAX file in the worker does not meet it (ROADMAP §C)."""
    yield
    retire_leftover_jax_runtime_for_later_files()


@pytest.fixture(scope="module")
def cluster():
    rt.init(num_cpus=32, num_gpus=0, object_store_memory=256 * 1024 * 1024)
    yield
    rt.shutdown()


def _objective(config):
    for step in range(3):
        tune.report({"score": config["x"] * 10 + step})


# ----------------------------------------------------------------- Tuner


class TestTuner:
    def test_grid_fit(self, cluster, tmp_path):
        grid = Tuner(
            _objective,
            param_space={"x": tune.grid_search([1, 2, 3])},
            tune_config=TuneConfig(metric="score", mode="max"),
            run_config=RunConfig(storage_path=str(tmp_path)),
        ).fit()
        assert len(grid) == 3
        assert grid.num_errors == 0
        best = grid.get_best_result()
        assert best.metrics["score"] == 32
        assert best.config["x"] == 3

    def test_min_mode(self, cluster, tmp_path):
        best = Tuner(
            _objective,
            param_space={"x": tune.grid_search([1, 2])},
            tune_config=TuneConfig(metric="score", mode="min"),
            run_config=RunConfig(storage_path=str(tmp_path)),
        ).fit().get_best_result()
        assert best.config["x"] == 1

    def test_num_samples(self, cluster, tmp_path):
        grid = Tuner(
            _objective,
            param_space={"x": tune.randint(0, 5)},
            tune_config=TuneConfig(metric="score", mode="max", num_samples=4,
                                   search_seed=3),
            run_config=RunConfig(storage_path=str(tmp_path)),
        ).fit()
        assert len(grid) == 4
        # the variants are the generator's for that seed
        want = tune.BasicVariantGenerator(3).generate(
            {"x": tune.randint(0, 5)}, 4)
        assert [r.config for r in grid] == want

    def test_trial_error_captured(self, cluster, tmp_path):
        def bad(config):
            if config["x"] == 1:
                raise ValueError("nope")
            tune.report({"score": 1})

        grid = Tuner(
            bad, param_space={"x": tune.grid_search([0, 1])},
            tune_config=TuneConfig(metric="score", mode="max"),
            run_config=RunConfig(storage_path=str(tmp_path)),
        ).fit()
        assert grid.num_errors == 1
        assert "nope" in str(grid.errors[0])
        assert grid.get_best_result().metrics["score"] == 1

    def test_stop_criteria(self, cluster, tmp_path):
        def forever(config):
            step = 0
            while True:
                tune.report({"v": step})
                step += 1

        grid = Tuner(
            forever, param_space={},
            tune_config=TuneConfig(metric="v", mode="max"),
            run_config=RunConfig(storage_path=str(tmp_path),
                                 stop={"training_iteration": 5}),
        ).fit()
        assert grid.num_errors == 0
        assert grid[0].metrics["training_iteration"] == 5

    def test_checkpoint_and_retry(self, cluster, tmp_path):
        marker = str(tmp_path / "died")

        def flaky(config):
            start = 0
            ckpt = tune.get_checkpoint()
            if ckpt is not None:
                with ckpt.as_directory() as d:
                    with open(os.path.join(d, "s.json")) as f:
                        start = json.load(f)["i"] + 1
            for i in range(start, 4):
                with tempfile.TemporaryDirectory() as d:
                    with open(os.path.join(d, "s.json"), "w") as f:
                        json.dump({"i": i}, f)
                    tune.report({"i": i},
                                checkpoint=Checkpoint.from_directory(d))
                if i == 1 and not os.path.exists(marker):
                    open(marker, "w").close()
                    raise RuntimeError("crash")

        grid = Tuner(
            flaky, param_space={},
            tune_config=TuneConfig(metric="i", mode="max"),
            run_config=RunConfig(
                storage_path=str(tmp_path),
                failure_config=FailureConfig(max_failures=1)),
        ).fit()
        assert grid.num_errors == 0
        assert grid.get_best_result().metrics["i"] == 3
        # the retry resumed from i=1's checkpoint: i=2, 3 after the crash
        assert [m["i"] for m in grid[0].metrics_history] == [0, 1, 2, 3]

    def test_restore(self, cluster, tmp_path):
        grid = Tuner(
            _objective,
            param_space={"x": tune.grid_search([1, 2])},
            tune_config=TuneConfig(metric="score", mode="max"),
            run_config=RunConfig(storage_path=str(tmp_path), name="resume"),
        ).fit()
        assert len(grid) == 2
        with open(tmp_path / "resume" / "tuner_state.json") as f:
            state = json.load(f)
        assert state["metric"] == "score" and len(state["trials"]) == 2
        # restore: finished trials stay finished
        grid2 = Tuner.restore(str(tmp_path / "resume"), _objective).fit()
        assert len(grid2) == 2
        assert grid2.num_errors == 0
        assert sorted(r.metrics["score"] for r in grid2) == [12, 22]

    def test_dataframe(self, cluster, tmp_path):
        grid = Tuner(
            _objective,
            param_space={"x": tune.grid_search([1, 2])},
            tune_config=TuneConfig(metric="score", mode="max"),
            run_config=RunConfig(storage_path=str(tmp_path)),
        ).fit()
        df = grid.get_dataframe()
        assert len(df) == 2
        assert "config/x" in df.columns


# ------------------------------------------------------------ schedulers


class TestSchedulers:
    def test_asha_stops_bad_trials(self, cluster, tmp_path):
        def objective(config):
            for step in range(16):
                tune.report({"acc": config["q"] + step * 0.01})

        grid = Tuner(
            objective,
            param_space={"q": tune.grid_search([0.1, 0.2, 0.8, 0.9])},
            tune_config=TuneConfig(
                metric="acc", mode="max", max_concurrent_trials=4,
                scheduler=ASHAScheduler(grace_period=2, reduction_factor=2,
                                        max_t=16)),
            run_config=RunConfig(storage_path=str(tmp_path)),
        ).fit()
        iters = sorted(len(r.metrics_history) for r in grid)
        assert grid.get_best_result().config["q"] == pytest.approx(0.9)
        assert iters[0] < 16  # at least one trial early-stopped

    def test_pbt_exploits(self, cluster, tmp_path):
        def objective(config):
            # linear growth at rate lr; PBT propagates high-lr configs
            score = 0.0
            ckpt = tune.get_checkpoint()
            if ckpt is not None:
                with ckpt.as_directory() as d:
                    with open(os.path.join(d, "s.json")) as f:
                        score = json.load(f)["score"]
            for _ in range(20):
                score += config["lr"]
                with tempfile.TemporaryDirectory() as d:
                    with open(os.path.join(d, "s.json"), "w") as f:
                        json.dump({"score": score}, f)
                    tune.report({"score": score, "lr": config["lr"]},
                                checkpoint=Checkpoint.from_directory(d))

        pbt = PopulationBasedTraining(
            perturbation_interval=5,
            hyperparam_mutations={"lr": tune.uniform(0.1, 1.0)}, seed=0)
        grid = Tuner(
            objective,
            param_space={"lr": tune.grid_search([0.1, 1.0])},
            tune_config=TuneConfig(metric="score", mode="max",
                                   max_concurrent_trials=2, scheduler=pbt),
            run_config=RunConfig(storage_path=str(tmp_path)),
        ).fit()
        assert grid.num_errors == 0
        # the low-lr trial was exploited at least once (its config.lr
        # changed from 0.1, or it inherited a checkpoint)
        final = {r.config["lr"] for r in grid}
        assert final != {0.1, 1.0} or all(
            r.metrics["score"] > 2.0 for r in grid)

    def test_hyperband_halving_and_termination(self, cluster, tmp_path):
        """9 trials, eta=3, max_t=9: the bracket pauses everyone at the
        first rung, resumes the top third, and the losers stop early."""

        def objective(config):
            start = 0
            ckpt = tune.get_checkpoint()
            if ckpt:
                with open(os.path.join(ckpt.path, "s.json")) as f:
                    start = json.load(f)["step"]
            for step in range(start + 1, 10):
                d = tempfile.mkdtemp()
                with open(os.path.join(d, "s.json"), "w") as f:
                    json.dump({"step": step}, f)
                tune.report({"score": config["q"] * step,
                             "training_iteration": step},
                            checkpoint=Checkpoint(d))

        grid = Tuner(
            objective,
            param_space={"q": tune.grid_search(list(range(1, 10)))},
            tune_config=TuneConfig(
                metric="score", mode="max",
                scheduler=HyperBandScheduler(max_t=9, reduction_factor=3)),
            run_config=RunConfig(storage_path=str(tmp_path)),
        ).fit()
        assert len(grid) == 9
        assert grid.num_errors == 0
        assert grid.get_best_result().config["q"] == 9
        iters = [r.metrics.get("training_iteration", 0) for r in grid]
        assert sum(1 for i in iters if i >= 9) <= 4

    def test_hyperband_short_supply_resolves(self, cluster, tmp_path):
        """Fewer trials than the bracket capacity must not deadlock."""

        def objective(config):
            for step in range(1, 5):
                tune.report({"score": config["q"] * step,
                             "training_iteration": step})

        grid = Tuner(
            objective,
            param_space={"q": tune.grid_search([1, 2])},
            tune_config=TuneConfig(
                metric="score", mode="max",
                scheduler=HyperBandScheduler(max_t=27, reduction_factor=3)),
            run_config=RunConfig(storage_path=str(tmp_path)),
        ).fit()  # must return, not hang
        assert len(grid) == 2

    def test_pb2_end_to_end(self, cluster, tmp_path):
        def objective(config):
            for step in range(1, 7):
                tune.report({"score": -abs(config["lr"] - 0.05) + step,
                             "training_iteration": step})

        grid = Tuner(
            objective,
            param_space={"lr": tune.uniform(0.001, 0.1)},
            tune_config=TuneConfig(
                metric="score", mode="max", num_samples=4,
                scheduler=PB2(perturbation_interval=2,
                              hyperparam_bounds={"lr": [0.001, 0.1]},
                              seed=2)),
            run_config=RunConfig(storage_path=str(tmp_path)),
        ).fit()
        assert len(grid) == 4
        assert grid.num_errors == 0
        assert all(0.001 <= r.config["lr"] <= 0.1 for r in grid)


# ------------------------------------------------------------- searchers


class TestSearchers:
    def test_tpe_tuner_integration(self, cluster, tmp_path):
        def objective(config):
            for step in range(3):
                tune.report({"score": -(config["x"] - 0.5) ** 2 + step})

        grid = Tuner(
            objective,
            param_space={"x": tune.uniform(0.0, 1.0)},
            tune_config=TuneConfig(metric="score", mode="max", num_samples=8,
                                   search_alg=TPESearcher(n_initial=4,
                                                          seed=1)),
            run_config=RunConfig(storage_path=str(tmp_path)),
        ).fit()
        assert len(grid) == 8
        assert grid.num_errors == 0
        assert all(0.0 <= r.config["x"] <= 1.0 for r in grid)

    def test_ask_tell_drives_real_trials(self, cluster, tmp_path):
        from tests.test_torch_tune_search import FakeAskTellOptimizer

        opt = FakeAskTellOptimizer([0.1, 0.5, 0.9])

        def objective(config):
            tune.report({"score": 1.0 - (config["x"] - 0.5) ** 2})

        grid = Tuner(
            objective,
            param_space={"x": tune.uniform(0, 1), "const": 7},
            tune_config=TuneConfig(
                metric="score", mode="max", num_samples=3,
                search_alg=tune.AskTellSearcher(opt.ask, opt.tell)),
            run_config=RunConfig(storage_path=str(tmp_path)),
        ).fit()
        assert len(grid) == 3
        assert sorted(x for x, _ in opt.told) == [0.1, 0.5, 0.9]
        for x, score in opt.told:
            assert score == pytest.approx(1.0 - (x - 0.5) ** 2)
        best = grid.get_best_result()
        assert best.config["const"] == 7
        assert best.config["x"] == 0.5


# -------------------------------------------------------- trainer trials


class TestTrainerInTuner:
    def test_tune_over_trainer(self, cluster, tmp_path):
        from ray_tpu_torch.train import DataParallelTrainer, ScalingConfig

        def loop(config):
            train.report({"out": config["mul"] * 3,
                          "base": config["base"]})

        trainer = DataParallelTrainer(
            loop, train_loop_config={"mul": 0, "base": 11},
            scaling_config=ScalingConfig(num_workers=1),
            run_config=RunConfig(storage_path=str(tmp_path / "inner")))
        grid = Tuner(
            trainer,
            param_space={"train_loop_config": {
                "mul": tune.grid_search([2, 5])}},
            tune_config=TuneConfig(metric="out", mode="max",
                                   max_concurrent_trials=1),
            run_config=RunConfig(storage_path=str(tmp_path), name="outer"),
        ).fit()
        assert grid.num_errors == 0, [str(e) for e in grid.errors]
        best = grid.get_best_result()
        assert best.metrics["out"] == 15
        # the trial's override merged into the trainer's loop config
        assert best.metrics["base"] == 11
        # the trainer's own experiment nests under the trial's directory
        assert os.path.isdir(os.path.join(best.path, "inner"))


# ---------------------------------------------------------------- parity


def _parity_trainable(config, *, cfg, ocfg, state_np, batches):
    """One trial: llama_debug from the converted JAX state, AdamW at the
    trial's learning rate, one step and one report per iteration; the
    reported loss is the step's, taken before its update."""
    import dataclasses

    import torch

    from ray_tpu_torch._private import convert
    from ray_tpu_torch.models import training

    torch.backends.cuda.matmul.allow_tf32 = False
    state = convert.train_state_from_jax(state_np, device="cpu")
    ocfg = dataclasses.replace(ocfg, learning_rate=config["lr"])
    step = training.make_train_step(cfg, training.make_optimizer(ocfg))
    for b in batches:
        state, m = step(state, {"tokens": torch.tensor(b)})
        tune.report({"loss": float(m["loss"]),
                     "grad_norm": float(m["grad_norm"])})


def test_llama_debug_asha_parity_with_jax(cluster, tmp_path):
    jcfg_fn, cfg_fn = MODELS["llama_debug"]
    jcfg, cfg = jcfg_fn(ce_chunk=8), cfg_fn(ce_chunk=8)
    jocfg = jtraining.OptimizerConfig(learning_rate=1e-3, warmup_steps=1,
                                      decay_steps=8)
    jstate, _ = jtraining.init_train_state(jcfg, jocfg,
                                           jax.random.PRNGKey(0))
    rng = np.random.default_rng(5)
    batches = [rng.integers(0, cfg.vocab_size, (2, 12)).astype(np.int64)
               for _ in range(6)]
    lrs = [1e-4, 1e-3, 3e-3, 1e-2]
    from ray_tpu_torch.models import training

    fn = tune.with_resources(
        partial(_parity_trainable, cfg=cfg,
                ocfg=training.OptimizerConfig(**jocfg.__dict__),
                state_np=_np(jstate), batches=batches), {"CPU": 1})
    grid = Tuner(
        fn,
        param_space={"lr": tune.grid_search(lrs)},
        tune_config=TuneConfig(
            metric="loss", mode="min", max_concurrent_trials=4,
            scheduler=ASHAScheduler(grace_period=2, reduction_factor=2,
                                    max_t=6)),
        run_config=RunConfig(storage_path=str(tmp_path)),
    ).fit()
    assert grid.num_errors == 0, [str(e) for e in grid.errors]
    # the first loss: JAX's loss_fn on the same weights and batch
    want0 = float(jtransformer.loss_fn(
        jcfg, jstate.params, {"tokens": jnp.asarray(batches[0])})[1]["loss"])
    for r in grid:
        hist = r.metrics_history
        np.testing.assert_allclose(hist[0]["loss"], want0, rtol=LOSS_RTOL)
        # the later losses: JAX's make_train_step at the trial's lr
        jtx_state, jtx = jtraining.init_train_state(
            jcfg, jtraining.OptimizerConfig(
                **{**jocfg.__dict__, "learning_rate": r.config["lr"]}),
            jax.random.PRNGKey(0))
        jstep = jtraining.make_train_step(jcfg, jtx, donate=False)
        for i, m in enumerate(hist):
            jtx_state, jm = jstep(jtx_state,
                                  {"tokens": jnp.asarray(batches[i])})
            np.testing.assert_allclose(
                m["loss"], float(jm["loss"]), rtol=LOSS_RTOL,
                err_msg=f"lr {r.config['lr']}, step {i}")
    iters = sorted(len(r.metrics_history) for r in grid)
    # the schedule's first step has lr 0, so the rung at 2 ties; the rung
    # at 4 sees the learning rates apart and ASHA stops one early
    assert iters[-1] == 6 and iters[0] < 6
