"""The port's Tune search and schedulers (``ray_tpu_torch.tune``) against
the JAX package's (``ray_tpu.tune``), in this process, with no cluster.

The draws are numpy's in both packages, seeded the same way, so the same
seed and the same feedback must give the same values bit for bit:
``BasicVariantGenerator`` variants (grid cross products, sampled domains,
nested spaces), ``TPESearcher`` suggestions, PBT's and PB2's mutations.
One synthetic result stream, made from a seed, drives the port's and the
JAX package's ASHA, HyperBand (with ``on_no_more_trials``), the median
stopping rule, PBT and PB2 through a small controller loop, and every
decision (continue, stop, pause, the actions popped for paused trials,
each exploit's source and new config) must match one for one. Also the
twins of ``tests/test_tune_search.py``'s ``TestTPESearcher`` and
``TestPB2`` unit cases and of ``tests/test_warehouse_external.py``'s
``AskTellSearcher`` cases that need no cluster (the fake study).
"""

import sys
import types

import numpy as np
import pytest

from ray_tpu import tune as jtune
from ray_tpu.tune import schedulers as jsched
from ray_tpu.tune import search_external as jext
from ray_tpu_torch import tune
from ray_tpu_torch.tune import schedulers as sched
from ray_tpu_torch.tune import search_external as ext
from tests.test_torch_runtime_cluster import \
    retire_leftover_jax_runtime_for_later_files

PACKAGES = {"jax": jtune, "port": tune}


@pytest.fixture(scope="module", autouse=True)
def _no_leftover_jax_runtime():
    """A JAX runtime that an earlier test file left up in this worker (JAX's
    serve router threads restart a shut one) is shut down after this file,
    so the next JAX file in the worker does not meet it (ROADMAP §C)."""
    yield
    retire_leftover_jax_runtime_for_later_files()


# ------------------------------------------------------------ variants


def _spaces(t):
    """The same search spaces built from either package's constructors."""
    return {
        "grid": ({"a": t.grid_search([1, 2]), "b": t.grid_search(["x", "y"]),
                  "c": 7}, 1),
        "domains": ({"lr": t.loguniform(1e-5, 1e-1),
                     "bs": t.choice([16, 32]), "n": t.randint(1, 10),
                     "u": t.uniform(-1, 1), "q": t.quniform(0, 10, 0.5),
                     "z": t.randn(0.0, 2.0)}, 20),
        "nested": ({"opt": {"lr": t.uniform(0, 1),
                            "beta": {"b1": t.choice([0.8, 0.9])}},
                    "k": t.grid_search([1, 2, 3])}, 3),
    }


@pytest.mark.parametrize("seed", [0, 1, 17])
@pytest.mark.parametrize("space", ["grid", "domains", "nested"])
def test_variants_equal_jax(space, seed):
    jspace, n = _spaces(jtune)[space]
    pspace, _ = _spaces(tune)[space]
    jv = jtune.BasicVariantGenerator(seed).generate(jspace, n)
    pv = tune.BasicVariantGenerator(seed).generate(pspace, n)
    assert pv == jv
    assert len(pv) == len(jv) > 0


def test_grid_cross_product():
    variants = tune.BasicVariantGenerator(seed=0).generate(
        {"a": tune.grid_search([1, 2]), "b": tune.grid_search(["x", "y"]),
         "c": 7})
    assert len(variants) == 4
    assert all(v["c"] == 7 for v in variants)
    assert {(v["a"], v["b"]) for v in variants} == {
        (1, "x"), (1, "y"), (2, "x"), (2, "y")}


def test_domains_sampled():
    variants = tune.BasicVariantGenerator(seed=0).generate(
        {"lr": tune.loguniform(1e-5, 1e-1), "bs": tune.choice([16, 32]),
         "n": tune.randint(1, 10)}, num_samples=20)
    assert len(variants) == 20
    assert all(1e-5 <= v["lr"] <= 1e-1 for v in variants)
    assert all(v["bs"] in (16, 32) for v in variants)
    assert len({v["lr"] for v in variants}) > 1


def test_nested_space():
    variants = tune.BasicVariantGenerator(seed=1).generate(
        {"opt": {"lr": tune.uniform(0, 1)}, "k": tune.grid_search([1, 2])})
    assert len(variants) == 2
    assert 0 <= variants[0]["opt"]["lr"] <= 1


# ----------------------------------------------------------------- TPE


def _tpe_run(t, seed, space_fn, objective, mode, n=30, n_initial=6):
    s = t.TPESearcher(n_initial=n_initial, seed=seed)
    s.set_objective("score", mode)
    s.set_search_space(space_fn(t))
    cfgs = []
    for i in range(n):
        cfg = s.suggest(f"t{i}")
        cfgs.append(cfg)
        s.on_trial_complete(f"t{i}", {"score": objective(cfg)})
    return cfgs


def _quad_space(t):
    return {"x": t.uniform(0.0, 1.0)}


def _mixed_space(t):
    return {"lr": t.loguniform(1e-5, 1e-1), "opt": t.choice(["adam", "sgd"]),
            "n": t.randint(1, 8), "w": {"q": t.quniform(0, 4, 0.25)},
            "fixed": "const"}


def _mixed_objective(cfg):
    return (abs(np.log10(cfg["lr"]) + 4) + (0 if cfg["opt"] == "adam" else 1)
            + 0.1 * cfg["n"] + abs(cfg["w"]["q"] - 1.5))


@pytest.mark.parametrize("seed", [0, 3])
@pytest.mark.parametrize("case", ["quadratic", "mixed"])
def test_tpe_suggestions_equal_jax(case, seed):
    if case == "quadratic":
        args = (_quad_space, lambda c: -(c["x"] - 0.73) ** 2, "max")
    else:
        args = (_mixed_space, _mixed_objective, "min")
    jc = _tpe_run(jtune, seed, *args)
    pc = _tpe_run(tune, seed, *args)
    assert pc == jc


def test_tpe_concentrates_on_quadratic():
    """TPE's late suggestions cluster near the optimum of
    f(x) = -(x-0.73)^2, far tighter than uniform sampling (whose mean
    squared distance from 0.73 is ~0.136)."""

    def late_spread(seed):
        xs = [c["x"] for c in _tpe_run(
            tune, seed, _quad_space, lambda c: -(c["x"] - 0.73) ** 2,
            "max", n=40, n_initial=8)]
        return float(np.mean((np.array(xs[20:]) - 0.73) ** 2))

    spreads = [late_spread(s) for s in range(5)]
    assert np.mean(spreads) < 0.034, spreads


def test_tpe_loguniform_and_choice():
    for cfg in _tpe_run(tune, 0, _mixed_space, _mixed_objective, "min",
                        n=20, n_initial=4):
        assert 1e-5 <= cfg["lr"] <= 1e-1
        assert cfg["opt"] in ("adam", "sgd")
        assert 1 <= cfg["n"] < 8
        assert cfg["fixed"] == "const"


def test_tpe_grid_rejected():
    s = tune.TPESearcher()
    s.set_objective("v", "max")
    with pytest.raises(ValueError, match="grid_search"):
        s.set_search_space({"a": tune.grid_search([1, 2])})


# ----------------------------------------------------------------- PB2


def _pb2_mutations(t_sched, seed):
    pb2 = t_sched.PB2(perturbation_interval=2,
                      hyperparam_bounds={"lr": [1e-4, 1e-1], "wd": [0, 1]},
                      seed=seed)
    pb2.set_objective("score", "max")
    for i in range(10):
        trial = types.SimpleNamespace(
            trial_id=f"t{i % 4}",
            config={"lr": 10 ** (-1 - 3 * i / 10), "wd": (i % 3) / 3})
        pb2.on_trial_result(trial, {"score": float(i) + 0.1 * (i % 4),
                                    "training_iteration": 1})
    return [pb2._mutate({"lr": 1e-2, "wd": 0.5}) for _ in range(5)]


@pytest.mark.parametrize("seed", [0, 5])
def test_pb2_mutations_equal_jax_and_stay_in_bounds(seed):
    jm = _pb2_mutations(jsched, seed)
    pm = _pb2_mutations(sched, seed)
    assert pm == jm
    for out in pm:
        assert 1e-4 <= out["lr"] <= 1e-1 and 0 <= out["wd"] <= 1


def test_pb2_mutation_within_bounds():
    pb2 = tune.PB2(perturbation_interval=2,
                   hyperparam_bounds={"lr": [1e-4, 1e-1]}, seed=0)
    pb2.set_objective("score", "max")
    for i in range(10):
        trial = types.SimpleNamespace(trial_id=f"t{i}",
                                      config={"lr": 10 ** (-1 - 3 * i / 10)})
        pb2.on_trial_result(trial, {"score": float(i),
                                    "training_iteration": 1})
    out = pb2._mutate({"lr": 1e-2})
    assert 1e-4 <= out["lr"] <= 1e-1


# --------------------------------------------- schedulers on one stream


def _schedulers(t, sm):
    return {
        "asha": lambda: t.ASHAScheduler(grace_period=2, reduction_factor=2,
                                        max_t=12),
        "hyperband": lambda: t.HyperBandScheduler(max_t=9,
                                                  reduction_factor=3),
        "median": lambda: t.MedianStoppingRule(grace_period=2,
                                               min_samples_required=2),
        "pbt": lambda: t.PopulationBasedTraining(
            perturbation_interval=3, quantile_fraction=0.34,
            hyperparam_mutations={"lr": t.uniform(0.001, 0.1),
                                  "mom": [0.8, 0.9, 0.99]},
            resample_probability=0.4, seed=11),
        "pb2": lambda: t.PB2(perturbation_interval=2,
                             hyperparam_bounds={"lr": [0.001, 0.1]},
                             seed=4),
    }


def _run_stream(t, sm, name, n_trials=7, max_iter=12, seed=123):
    """A small controller loop: trials report round-robin, their scores a
    seeded function of config and step; STOP finishes a trial, PAUSE parks
    it until the scheduler's actions resume or stop it, an exploit adopts
    its source's step and the new config. When nothing is runnable,
    ``on_no_more_trials`` resolves part-filled rungs, as the controller
    does. Returns the decision log."""
    s = _schedulers(t, sm)[name]()
    s.set_objective("score", "max")
    rng = np.random.default_rng(seed)
    noise = rng.normal(0, 0.05, (n_trials, 4 * max_iter))
    trials = [types.SimpleNamespace(
        trial_id=f"t{i}", config={"lr": float(0.01 * (i + 1)), "mom": 0.9})
        for i in range(n_trials)]
    step = {tr.trial_id: 0 for tr in trials}
    k = {tr.trial_id: 0 for tr in trials}
    status = {tr.trial_id: "RUNNING" for tr in trials}
    log = []

    def complete(tr):
        status[tr.trial_id] = "DONE"
        s.on_trial_complete(tr, {"score": 0.0})

    def apply_actions():
        pop = getattr(s, "pop_actions", None)
        acts = pop() if pop is not None else {}
        if acts:
            log.append(("actions", sorted(acts.items())))
        for tid, act in acts.items():
            tr = trials[int(tid[1:])]
            if status[tid] != "PAUSED":
                continue
            if act == "RESUME":
                status[tid] = "RUNNING"
            else:
                complete(tr)

    for _ in range(200):
        running = [tr for tr in trials if status[tr.trial_id] == "RUNNING"]
        if not running:
            paused = {tid for tid, st in status.items() if st == "PAUSED"}
            if not paused:
                break
            if hasattr(s, "on_no_more_trials"):
                s.on_no_more_trials(paused)
                apply_actions()
            if not any(st == "RUNNING" for st in status.values()):
                for tid in paused:
                    if status[tid] == "PAUSED":
                        complete(trials[int(tid[1:])])
            continue
        for tr in running:
            tid = tr.trial_id
            step[tid] += 1
            k[tid] += 1
            score = (tr.config["lr"] * 10 * np.log1p(step[tid])
                     + float(noise[int(tid[1:]), k[tid] % noise.shape[1]]))
            d = s.on_trial_result(
                tr, {"score": score, "training_iteration": step[tid]})
            log.append(("decision", tid, step[tid], d))
            exploit = getattr(s, "pending_exploits", {}).pop(tid, None)
            if exploit is not None:
                log.append(("exploit", tid, exploit.source_trial_id,
                            sorted(exploit.new_config.items())))
                tr.config = dict(exploit.new_config)
                step[tid] = step[exploit.source_trial_id]
            elif d == "STOP" or step[tid] >= max_iter:
                complete(tr)
            elif d == "PAUSE":
                status[tid] = "PAUSED"
            apply_actions()
    return log


@pytest.mark.parametrize("name", ["asha", "hyperband", "median", "pbt",
                                  "pb2"])
def test_scheduler_decisions_equal_jax(name):
    jlog = _run_stream(jtune, jsched, name)
    plog = _run_stream(tune, sched, name)
    assert len(plog) == len(jlog)
    for i, (p, j) in enumerate(zip(plog, jlog)):
        assert p == j, f"event {i}: port {p} != jax {j}"
    kinds = {e[0] for e in plog}
    decisions = {e[3] for e in plog if e[0] == "decision"}
    # each stream exercises what its scheduler decides
    if name in ("asha", "median"):
        assert "STOP" in decisions
    if name == "hyperband":
        assert "PAUSE" in decisions and "actions" in kinds
    if name in ("pbt", "pb2"):
        assert "exploit" in kinds


def test_hyperband_short_supply_resolves_through_on_no_more_trials():
    """Fewer trials than the bracket's capacity: every trial pauses at the
    first rung and only ``on_no_more_trials`` resolves it, in both
    packages alike."""
    logs = []
    for t in (jtune, tune):
        s = t.HyperBandScheduler(max_t=27, reduction_factor=3)
        s.set_objective("score", "max")
        trials = [types.SimpleNamespace(trial_id=f"t{i}", config={})
                  for i in range(2)]
        log = []
        for step in range(1, 3):
            for i, tr in enumerate(trials):
                log.append(s.on_trial_result(
                    tr, {"score": float(i + 1) * step,
                         "training_iteration": step}))
        log.append(sorted(s.pop_actions().items()))
        s.on_no_more_trials({"t0", "t1"})
        log.append(sorted(s.pop_actions().items()))
        logs.append(log)
    assert logs[1] == logs[0]
    assert logs[1][-1] == [("t0", "STOP"), ("t1", "RESUME")]


# ------------------------------------------------------ ask/tell searcher


class FakeAskTellOptimizer:
    """Stands in for optuna/ax/nevergrad: proposes points, records
    observations."""

    def __init__(self, xs):
        self.queue = list(xs)
        self.told = []

    def ask(self):
        if not self.queue:
            return None
        x = self.queue.pop(0)
        return ({"x": x}, {"x": x})  # (token, values)

    def tell(self, token, value):
        self.told.append((token["x"], value))


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_ask_tell_assembles_configs_and_tells(pkg):
    t = PACKAGES[pkg]
    opt = FakeAskTellOptimizer([0.1, 0.5, 0.9])
    s = t.AskTellSearcher(opt.ask, opt.tell)
    s.set_objective("score", "max")
    s.set_search_space({"x": t.uniform(0, 1), "const": 7,
                        "nest": {"x2": 3}})
    cfgs = []
    for i in range(3):
        cfg = s.suggest(f"t{i}")
        cfgs.append(cfg)
        s.on_trial_complete(f"t{i}", {"score": 1.0 - (cfg["x"] - 0.5) ** 2})
    assert s.suggest("t3") is None  # the optimizer ran dry
    assert [c["x"] for c in cfgs] == [0.1, 0.5, 0.9]
    assert all(c["const"] == 7 and c["nest"] == {"x2": 3} for c in cfgs)
    assert [x for x, _ in opt.told] == [0.1, 0.5, 0.9]
    for x, score in opt.told:
        assert score == pytest.approx(1.0 - (x - 0.5) ** 2)


def test_ask_tell_unset_leaf_fails_loudly():
    s = tune.AskTellSearcher(lambda: ({"wrong": 1}, {"wrong": 1}),
                             lambda *_: None)
    s.set_objective("score", "max")
    s.set_search_space({"x": tune.uniform(0, 1)})
    with pytest.raises(KeyError, match="x"):
        s.suggest("t1")


@pytest.mark.parametrize("mod", [jext, ext], ids=["jax", "port"])
def test_optuna_domain_translation(mod):
    """The optuna searcher's domain translation and study driving, through
    a fake study honoring ask(distributions)/tell (optuna itself is not
    installed: the real path stays gated on it, as in the JAX package)."""
    t = jtune if mod is jext else tune
    fake = types.ModuleType("optuna")
    fake.distributions = types.SimpleNamespace(
        FloatDistribution=lambda lo, hi, log=False, step=None: (
            "float", lo, hi, log, step),
        IntDistribution=lambda lo, hi: ("int", lo, hi),
        CategoricalDistribution=lambda cats: ("cat", tuple(cats)),
    )
    fake.trial = types.SimpleNamespace(
        TrialState=types.SimpleNamespace(FAIL="FAIL"))

    class FakeTrial:
        def __init__(self, params):
            self.params = params

    class FakeStudy:
        def __init__(self):
            self.told = []
            self.i = 0

        def ask(self, distributions):
            self.i += 1
            assert distributions["lr"][0] == "float"
            assert distributions["lr"][3] is True  # log
            assert distributions["layers"] == ("int", 1, 3)
            assert distributions["act"][0] == "cat"
            return FakeTrial({"lr": 10 ** -self.i, "layers": 2,
                              "act": "relu"})

        def tell(self, trial, value, state=None):
            self.told.append((trial.params["lr"], value, state))

    study = FakeStudy()
    fake.create_study = lambda direction: study
    sys.modules["optuna"] = fake
    try:
        s = mod.OptunaSearcher(study_factory=lambda direction: study)
        s.set_objective("loss", "min")
        s.set_search_space({
            "lr": t.loguniform(1e-5, 1e-1),
            "layers": t.randint(1, 4),
            "act": t.choice(["relu", "gelu"]),
            "fixed": "adam",
        })
        cfg = s.suggest("t1")
        assert cfg["lr"] == 0.1 and cfg["layers"] == 2
        assert cfg["act"] == "relu" and cfg["fixed"] == "adam"
        s.on_trial_complete("t1", {"loss": 0.25})
        assert study.told in ([(0.1, 0.25, None)], [(0.1, 0.25)])
    finally:
        del sys.modules["optuna"]


def test_optuna_gated_on_its_import():
    """Without optuna the searcher fails at its first use of optuna (the
    search space's translation), as the JAX package's does; optuna is made
    unimportable here whether or not it is installed."""
    saved = sys.modules.get("optuna")
    sys.modules["optuna"] = None
    try:
        for mod, t in ((jext, jtune), (ext, tune)):
            s = mod.OptunaSearcher()
            s.set_objective("loss", "min")
            with pytest.raises(ImportError):
                s.set_search_space({"x": t.uniform(0, 1)})
    finally:
        if saved is None:
            del sys.modules["optuna"]
        else:
            sys.modules["optuna"] = saved
