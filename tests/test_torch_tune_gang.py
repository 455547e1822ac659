"""The port's Tune gang scheduling on constrained clusters (its own module,
as ``tests/test_tune_gang.py`` is: each test owns its cluster's
lifecycle).

The twin of ``test_concurrent_trainer_trials_no_deadlock``, and the
one-card rule on a node that declares one GPU (no card is needed: the
runtime only sets ``CUDA_VISIBLE_DEVICES``): a trainer trial's gang is
``[{"CPU": 1}, {"CPU": 1, "GPU": 1}]`` and its inner worker sees card
"0" exactly as a worker with its own group does, while the trial's own
process sees none; function trials that each ask for ``GPU: 1`` run one
after another with ``max_concurrent_trials=1``, each seeing card "0".
"""

import os
import sys

import cloudpickle
import pytest

import ray_tpu_torch as rt
from ray_tpu_torch import tune
from ray_tpu_torch.air.config import RunConfig
from ray_tpu_torch.cluster_utils import Cluster
from ray_tpu_torch.tune import TuneConfig, Tuner
from tests.test_torch_runtime_cluster import \
    retire_leftover_jax_runtime_for_later_files

os.environ.setdefault("RAY_TPU_TORCH_LOG_LEVEL", "WARNING")
cloudpickle.register_pickle_by_value(sys.modules[__name__])


@pytest.fixture(scope="module", autouse=True)
def _no_leftover_jax_runtime():
    """A JAX runtime that an earlier test file left up in this worker (JAX's
    serve router threads restart a shut one) is shut down after this file,
    so the next JAX file in the worker does not meet it (ROADMAP §C)."""
    yield
    retire_leftover_jax_runtime_for_later_files()


@pytest.fixture
def cluster():
    c = Cluster()
    yield c
    if rt.is_initialized():
        rt.shutdown()
    c.shutdown()


def test_concurrent_trainer_trials_no_deadlock(cluster, tmp_path):
    """Tune over a trainer on a constrained cluster: each trial
    gang-reserves its own process AND its train workers in ONE placement
    group, so trial processes can never occupy every CPU and starve each
    other's worker groups. Without gang groups this configuration
    deadlocks: 3 trial processes claim 3 of 4 CPUs and each inner
    2-worker group waits forever."""
    cluster.add_node(num_cpus=4)
    cluster.wait_for_nodes(1)
    rt.init(address=cluster.address)

    from ray_tpu_torch.train import DataParallelTrainer, ScalingConfig
    from ray_tpu_torch.train._internal.session import get_session

    def loop(config):
        get_session().report({"score": config["x"] * 10})

    trainer = DataParallelTrainer(
        loop, train_loop_config={"x": 0},
        scaling_config=ScalingConfig(num_workers=2),
        run_config=RunConfig(storage_path=str(tmp_path / "inner")))
    grid = Tuner(
        trainer,
        param_space={"train_loop_config": {"x": tune.grid_search([1, 2, 3])}},
        tune_config=TuneConfig(metric="score", mode="max",
                               max_concurrent_trials=3),
        run_config=RunConfig(name="gang", storage_path=str(tmp_path / "exp")),
    ).fit()
    assert grid.num_errors == 0, [str(e) for e in grid.errors]
    assert len(grid) == 3
    assert grid.get_best_result().metrics["score"] == 30


def _visible():
    return os.environ.get("CUDA_VISIBLE_DEVICES")


def test_trainer_trials_on_one_card(cluster, tmp_path):
    """``ScalingConfig(num_workers=1, use_gpu=True)``: the gang holds the
    card in bundle 1; the inner worker sees it, the trial process does
    not, and two trials take the card in turn."""
    cluster.add_node(num_cpus=4, num_gpus=1)
    cluster.wait_for_nodes(1)
    rt.init(address=cluster.address)

    from ray_tpu_torch.train import DataParallelTrainer, ScalingConfig

    def loop(config):
        from ray_tpu_torch import train

        train.report({"score": config["lr"], "worker_visible": _visible(),
                      "pid": os.getpid()})

    trainer = DataParallelTrainer(
        loop, train_loop_config={"lr": 0.0},
        scaling_config=ScalingConfig(num_workers=1, use_gpu=True),
        run_config=RunConfig(storage_path=str(tmp_path / "inner")))

    def outer(config):
        # what the trial's own process sees, reported beside the trainer's
        from ray_tpu_torch.train._internal import session as session_mod
        from ray_tpu_torch.tune.tuner import _trainer_to_fn

        real_report = session_mod.report

        def report(metrics, checkpoint=None):
            metrics = dict(metrics, trial_visible=_visible())
            real_report(metrics, checkpoint=checkpoint)

        session_mod.report = report
        try:
            _trainer_to_fn(trainer)(config)
        finally:
            session_mod.report = real_report

    tuner = Tuner(
        trainer,
        param_space={"train_loop_config": {
            "lr": tune.grid_search([0.1, 0.2])}},
        tune_config=TuneConfig(metric="score", mode="max",
                               max_concurrent_trials=1),
        run_config=RunConfig(storage_path=str(tmp_path / "exp")))
    _, trial_bundle, gang = tuner._resolve_trainable()
    assert trial_bundle == {"CPU": 1.0}
    assert gang == [{"CPU": 1.0}, {"CPU": 1.0, "GPU": 1.0}]
    grid = tuner.fit()
    assert grid.num_errors == 0, [str(e) for e in grid.errors]
    assert [r.metrics["worker_visible"] for r in grid] == ["0", "0"]
    assert grid.get_best_result().config == {
        "train_loop_config": {"lr": 0.2}}

    # the same trainer under a trial whose own process reports what it
    # sees: no card there, the card in its worker (whose group is its own)
    grid = Tuner(
        tune.with_resources(outer, {"CPU": 1}),
        param_space={"train_loop_config": {"lr": tune.grid_search([0.3])}},
        tune_config=TuneConfig(metric="score", mode="max",
                               max_concurrent_trials=1),
        run_config=RunConfig(storage_path=str(tmp_path / "exp2")),
    ).fit()
    assert grid.num_errors == 0, [str(e) for e in grid.errors]
    m = grid[0].metrics
    assert m["trial_visible"] == "" and m["worker_visible"] == "0"


def test_function_trials_take_the_card_in_turn(cluster, tmp_path):
    """``with_resources(fn, {"CPU": 1, "GPU": 1})`` on a one-card node with
    ``max_concurrent_trials=1``: every trial runs, one at a time, and
    each trial's process sees card "0"."""
    cluster.add_node(num_cpus=4, num_gpus=1)
    cluster.wait_for_nodes(1)
    rt.init(address=cluster.address)

    def fn(config):
        import time

        t0 = time.time()
        for i in range(2):
            tune.report({"score": config["x"] + i, "visible": _visible(),
                         "t0": t0, "t1": time.time()})

    grid = Tuner(
        tune.with_resources(fn, {"CPU": 1, "GPU": 1}),
        param_space={"x": tune.grid_search([1, 2, 3])},
        tune_config=TuneConfig(metric="score", mode="max",
                               max_concurrent_trials=1),
        run_config=RunConfig(storage_path=str(tmp_path)),
    ).fit()
    assert grid.num_errors == 0, [str(e) for e in grid.errors]
    assert [r.metrics["visible"] for r in grid] == ["0", "0", "0"]
    spans = sorted((r.metrics["t0"], r.metrics["t1"]) for r in grid)
    for (_, end), (start, _) in zip(spans, spans[1:]):
        assert start >= end  # never two trials on the card at once
