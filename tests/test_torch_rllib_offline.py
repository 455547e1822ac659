"""The port's offline algorithms (``ray_tpu_torch/rllib/algorithms/
marwil.py``: MARWIL and BC; ``cql.py``: CQL) against the JAX package's on
the CPU (``device="cpu"`` for the learners, one torch thread), float32:

  * ``MARWIL.loss_fn`` at beta 0 (BC) and beta 2: loss, metrics and the
    grads of every leaf against ``jax.value_and_grad`` on weights
    converted from JAX's ``init_params`` (``LOSS_TOL``, ``GRAD_TOL``);
  * ``CQL.loss_fn`` in both actor branches (the BC warm start and the SAC
    objective): loss, the conservative penalty, metrics and grads;
  * whole ``train()`` iterations from JAX's initial learner state: two of
    MARWIL's and two of BC's (metrics, ``_adv_norm``, weights), and two of
    CQL's with ``bc_iters=1``, one warm-start iteration and one CQL
    iteration (metrics, weights and the polyak target tree). The numpy
    draws (minibatch rows, replay rows, noise) are the same on both sides
    (``METRIC_TOL``, ``WEIGHT_TOL``);
  * the twins of JAX's behaviour tests (``tests/test_rllib_sac_offline.py``
    ``TestBC``/``TestMARWIL`` and ``tests/test_rllib_eval_cql.py::
    TestCQL``), the Dataset input through the port's own ``data``
    library on the port's runtime.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ray_tpu_torch as rt
from ray_tpu_torch._private import convert
from ray_tpu_torch.models.transformer import _leaves, map_params
from ray_tpu_torch.rllib.core.learner import params_from_numpy
from tests.test_rllib_eval_cql import _quadratic_bandit_rows
from tests.test_rllib_sac_offline import _make_offline_rows
from tests.test_torch_runtime_cluster import \
    retire_leftover_jax_runtime_for_later_files

CPU = "cpu"
LOSS_TOL = dict(atol=1e-5, rtol=1e-5)
GRAD_TOL = dict(atol=1e-5, rtol=1e-4)
METRIC_TOL = dict(atol=2e-5, rtol=2e-4)
WEIGHT_TOL = dict(atol=2e-5, rtol=2e-4)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The CPU's intra-op pool costs more than it saves at these sizes, so
    the file runs on one thread and gives the rest back."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", autouse=True)
def _no_leftover_jax_runtime():
    yield
    retire_leftover_jax_runtime_for_later_files()


def _close_tree(port_tree, jax_tree, tol, what=""):
    got = jax.tree_util.tree_flatten_with_path(
        convert.rl_params_to_jax(port_tree))[0]
    want = dict(jax.tree_util.tree_flatten_with_path(
        jax.tree.map(np.asarray, jax_tree))[0])
    assert len(got) == len(want)
    for path, g in got:
        assert g.shape == want[path].shape, (what, path)
        np.testing.assert_allclose(g, want[path], **tol,
                                   err_msg=f"{what} {path}")


def _grads_close(loss, pp, jgrads, what):
    grads = iter(torch.autograd.grad(loss, _leaves(pp), allow_unused=True))
    gtree = map_params(
        lambda _p, t: (lambda g: torch.zeros_like(t) if g is None else g)(
            next(grads)), pp)
    _close_tree(gtree, jgrads, GRAD_TOL, what)


def _metrics_close(got, want, tol, what=""):
    assert set(got) == set(want), (what, set(got) ^ set(want))
    for k in got:
        if want[k] is None:  # no episodes offline
            assert got[k] is None, (what, k)
            continue
        np.testing.assert_allclose(got[k], want[k], **tol,
                                   err_msg=f"{what} {k}")


def _start_from_jax(jalgo, palgo):
    palgo.learner_group.set_state(convert.rl_learner_state_from_jax(
        jax.tree.map(np.asarray, jalgo.learner_group.get_state())))


# ------------------------------------------------------------ MARWIL, BC


def _marwil_pair():
    from ray_tpu.rllib.core.rl_module import RLModule as JModule
    from ray_tpu.rllib.core.rl_module import RLModuleSpec as JSpec

    from ray_tpu_torch.rllib import RLModule, RLModuleSpec

    kw = dict(obs_dim=6, num_actions=4, hiddens=(64,))
    jm = JModule(JSpec(**kw))
    jp = jax.tree.map(np.asarray, jm.init_params(jax.random.PRNGKey(0)))
    # a value head and a policy head that are not near zero
    jp["pi"]["w"] = jp["pi"]["w"] * 100.0
    jp["vf"]["b"] = np.full_like(jp["vf"]["b"], 0.3)
    pm = RLModule(RLModuleSpec(**kw))
    pp = params_from_numpy(convert.rl_params_from_jax(jp),
                           torch.device(CPU), True)
    return jm, jp, pm, pp


@pytest.mark.parametrize("beta", [0.0, 2.0])
def test_marwil_loss_and_grads_match_jax(beta):
    from ray_tpu.rllib.algorithms.marwil import MARWIL as JMARWIL

    from ray_tpu_torch.rllib import MARWIL

    jm, jp, pm, pp = _marwil_pair()
    rows = _make_offline_rows(n=48, with_return=True, noise_frac=0.5,
                              biased_noise=True)
    batch = {"obs": np.stack([r["obs"] for r in rows]),
             "actions": np.array([r["action"] for r in rows], np.int64),
             "returns": np.array([r["return"] for r in rows], np.float32),
             "adv_norm": np.full(48, 0.7, np.float32)}
    cfg = {"beta": beta, "vf_coeff": 1.0}
    (jloss, jmet), jgrads = jax.jit(jax.value_and_grad(
        lambda p, b: JMARWIL.loss_fn(jm, p, b, cfg), has_aux=True))(
            jax.tree.map(jnp.asarray, jp),
            {k: jnp.asarray(v) for k, v in batch.items()})
    loss, met = MARWIL.loss_fn(pm, pp, {k: torch.from_numpy(v)
                                        for k, v in batch.items()}, cfg)
    np.testing.assert_allclose(float(loss.detach()), float(jloss),
                               **LOSS_TOL)
    _metrics_close({k: float(v) for k, v in met.items()},
                   {k: float(v) for k, v in jmet.items()}, LOSS_TOL)
    _grads_close(loss, pp, jgrads, f"beta {beta}")


def _imitation(cls, rows, seed=1, beta=None, updates=24):
    cfg = (cls().environment(observation_dim=6, num_actions=4)
           .offline_data(input_=rows)
           .training(lr=3e-3, updates_per_iteration=updates,
                     model={"hiddens": (64,)})
           .debugging(seed=seed))
    return cfg if beta is None else cfg.training(beta=beta)


@pytest.mark.parametrize("algo", ["marwil", "bc"])
def test_train_iterations_match_jax(algo):
    """Two whole ``train()`` iterations of 24 updates each (JAX's config)
    from JAX's initial learner state: the same minibatch rows, so the same
    metrics, running advantage scale and weights."""
    from ray_tpu.rllib.algorithms.marwil import BCConfig as JBCConfig
    from ray_tpu.rllib.algorithms.marwil import \
        MARWILConfig as JMARWILConfig

    from ray_tpu_torch.rllib import BCConfig, MARWILConfig

    rows = _make_offline_rows(n=600, with_return=True, noise_frac=0.5,
                              biased_noise=True)
    jcls, pcls, beta = ((JMARWILConfig, MARWILConfig, 2.0)
                        if algo == "marwil" else (JBCConfig, BCConfig, None))
    jalgo = _imitation(jcls, rows, beta=beta, updates=24).build()
    palgo = _imitation(pcls, rows, beta=beta, updates=24).learners(
        device=CPU).build()
    try:
        _start_from_jax(jalgo, palgo)
        for _ in range(2):
            jm, pm = jalgo.train(), palgo.train()
            jm.pop("time_total_s"), pm.pop("time_total_s")
            _metrics_close(pm, jm, METRIC_TOL, algo)
            np.testing.assert_allclose(palgo._adv_norm, jalgo._adv_norm,
                                       **METRIC_TOL)
        assert (palgo._adv_norm != 1.0) == (algo == "marwil")
        _close_tree(palgo.get_weights(), jalgo.get_weights(), WEIGHT_TOL,
                    algo)
    finally:
        jalgo.stop()
        palgo.stop()


def _optimal_accuracy(algo, n=512, obs_dim=6, n_act=4, seed=99):
    """Greedy accuracy against the TRUE optimal action on held-out
    states, as JAX's helper measures it."""
    from ray_tpu_torch.rllib import RLModule

    rng = np.random.default_rng(seed)
    obs = rng.normal(size=(n, obs_dim)).astype(np.float32)
    best = np.argmax(obs[:, :n_act], axis=1)
    params = params_from_numpy(algo.get_weights(), torch.device(CPU))
    with torch.no_grad():
        logits = RLModule(algo.spec).forward_inference(
            params, torch.from_numpy(obs))
    return float(np.mean(np.argmax(logits.numpy(), -1) == best))


def test_learns_mapping():
    from ray_tpu_torch.rllib import BCConfig

    algo = (BCConfig()
            .environment(observation_dim=6, num_actions=4)
            .offline_data(input_=_make_offline_rows())
            .training(lr=3e-3, updates_per_iteration=24,
                      model={"hiddens": (64,)})
            .learners(device=CPU)
            .debugging(seed=0)).build()
    acc = 0.0
    for _ in range(12):
        acc = algo.train().get("accuracy", 0.0)
        if acc > 0.95:
            break
    algo.stop()
    assert acc > 0.9, acc


def test_dataset_input():
    """BC fed through a port ``Dataset`` (on the port's runtime)."""
    from ray_tpu_torch import data
    from ray_tpu_torch.rllib import BCConfig

    rt.init(num_cpus=4, num_gpus=0, object_store_memory=128 * 1024 * 1024)
    try:
        ds = data.from_items(_make_offline_rows(n=200))
        algo = (BCConfig()
                .environment(observation_dim=6, num_actions=4)
                .offline_data(input_=ds)
                .training(model={"hiddens": (32,)})
                .learners(device=CPU)).build()
        r = algo.train()
        assert r["num_rows"] == 200
        assert np.isfinite(r["policy_loss"])
        algo.stop()
    finally:
        rt.shutdown()


def test_beats_bc_on_mixed_data():
    """Half the logged actions are systematically wrong: BC splits the
    conflicted label mass, MARWIL's exp-advantage weighting recovers the
    optimal mapping (JAX's bars)."""
    from ray_tpu_torch.rllib import BCConfig, MARWILConfig

    rows = _make_offline_rows(n=3000, with_return=True, noise_frac=0.5,
                              biased_noise=True)

    def train_and_eval(cls, beta):
        algo = _imitation(cls, rows, beta=beta).learners(device=CPU).build()
        for _ in range(15):
            algo.train()
        acc = _optimal_accuracy(algo)
        algo.stop()
        return acc

    marwil_acc = train_and_eval(MARWILConfig, 2.0)
    bc_acc = train_and_eval(BCConfig, None)
    assert marwil_acc > 0.85, (marwil_acc, bc_acc)
    assert marwil_acc > bc_acc + 0.15, (marwil_acc, bc_acc)


def test_requires_returns():
    from ray_tpu_torch.rllib import MARWILConfig

    config = (MARWILConfig()
              .environment(observation_dim=6, num_actions=4)
              .offline_data(input_=_make_offline_rows(n=50))
              .learners(device=CPU))
    with pytest.raises(ValueError, match="return"):
        config.build()


def test_offline_learner_raises_without_a_card():
    """No device named and no card: the offline algorithms raise rather
    than train on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present; the rule is for a machine without")
    from ray_tpu_torch.rllib import BCConfig
    from ray_tpu_torch.rllib.algorithms import CQLConfig

    for cfg in (BCConfig().offline_data(input_=_make_offline_rows(n=20)),
                CQLConfig().offline_data(input_=_quadratic_bandit_rows(20))):
        cfg = cfg.environment(
            observation_dim=6 if isinstance(cfg, BCConfig) else 2,
            num_actions=4 if isinstance(cfg, BCConfig) else 1)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            cfg.build()


# ------------------------------------------------------------------- CQL


def _cql_pair(log_alpha=-0.3):
    from ray_tpu.rllib.algorithms.sac import SACModule as JModule
    from ray_tpu.rllib.core.rl_module import RLModuleSpec as JSpec

    from ray_tpu_torch.rllib.algorithms.sac import SACModule
    from ray_tpu_torch.rllib.core.rl_module import RLModuleSpec

    kw = dict(obs_dim=2, num_actions=1, hiddens=(32, 32),
              dist_type="gaussian")
    jm = JModule(JSpec(**kw))
    jp = jax.tree.map(np.asarray, jm.init_params(jax.random.PRNGKey(0)))
    jp["log_alpha"] = np.asarray(log_alpha, np.float32)
    pm = SACModule(RLModuleSpec(**kw))
    pp = params_from_numpy(convert.rl_params_from_jax(jp),
                           torch.device(CPU), True)
    return jm, jp, pm, pp


def _cql_batch(B=32, N=4, seed=0):
    rng = np.random.default_rng(seed)
    rows = _quadratic_bandit_rows(B, seed=seed)
    return {"obs": np.stack([r["obs"] for r in rows]),
            "actions": np.stack([r["action"] for r in rows]),
            "next_obs": np.stack([r["next_obs"] for r in rows]),
            "targets": np.array([r["reward"] for r in rows], np.float32),
            "noise": rng.standard_normal((B, 1)).astype(np.float32),
            "cql_rand_actions": rng.uniform(-1, 1, (B, N, 1)).astype(
                np.float32),
            "cql_noise": rng.standard_normal((B, N, 1)).astype(np.float32),
            "cql_noise_next": rng.standard_normal((B, N, 1)).astype(
                np.float32)}


@pytest.mark.parametrize("bc", [True, False])
def test_cql_loss_and_grads_match_jax(bc):
    from ray_tpu.rllib.algorithms.cql import CQL as JCQL

    from ray_tpu_torch.rllib.algorithms import CQL

    jm, jp, pm, pp = _cql_pair()
    batch = _cql_batch()
    cfg = {"target_entropy": -1.0, "cql_alpha": 5.0, "bc": bc}
    (jloss, jmet), jgrads = jax.jit(jax.value_and_grad(
        lambda p, b: JCQL.loss_fn(jm, p, b, cfg), has_aux=True))(
            jax.tree.map(jnp.asarray, jp),
            {k: jnp.asarray(v) for k, v in batch.items()})
    loss, met = CQL.loss_fn(pm, pp, {k: torch.from_numpy(v)
                                     for k, v in batch.items()}, cfg)
    np.testing.assert_allclose(float(loss.detach()), float(jloss),
                               **LOSS_TOL)
    _metrics_close({k: float(v) for k, v in met.items()},
                   {k: float(v) for k, v in jmet.items()}, LOSS_TOL)
    assert float(met["cql_penalty"]) != 0.0
    _grads_close(loss, pp, jgrads, f"bc={bc}")


def _cql_config(cls, **training):
    kw = dict(lr=3e-3, train_batch_size=256, updates_per_iteration=16,
              cql_alpha=1.0, num_cql_actions=4, bc_iters=1, gamma=0.0,
              model={"hiddens": (32, 32)})
    kw.update(training)
    return (cls()
            .environment(observation_dim=2, num_actions=1)
            .offline_data(input_=_quadratic_bandit_rows())
            .training(**kw)
            .debugging(seed=0))


def test_cql_train_iterations_match_jax():
    """Two ``train()`` iterations at ``bc_iters=1`` (the warm start, then
    CQL) of 4 updates each, discounted (gamma 0.9, so the targets read
    the polyak tree), from JAX's initial state and targets."""
    from ray_tpu.rllib.algorithms.cql import CQLConfig as JCQLConfig

    from ray_tpu_torch.rllib.algorithms import CQLConfig

    kw = dict(updates_per_iteration=4, train_batch_size=64, gamma=0.9)
    jalgo = _cql_config(JCQLConfig, **kw).build()
    palgo = _cql_config(CQLConfig, **kw).learners(device=CPU).build()
    try:
        _start_from_jax(jalgo, palgo)
        palgo._target_q = convert.rl_params_from_jax(jalgo._target_q)
        for i in range(2):
            jm, pm = jalgo.train(), palgo.train()
            for m in (jm, pm):
                m.pop("time_total_s")
            _metrics_close(pm, jm, METRIC_TOL, f"iteration {i}")
        _close_tree(palgo.learner_group.get_weights(),
                    jalgo.learner_group.get_weights(), WEIGHT_TOL, "weights")
        _close_tree(palgo._target_q, jalgo._target_q, WEIGHT_TOL,
                    "targets")
    finally:
        jalgo.stop()
        palgo.stop()


def test_cql_learns_offline():
    """Pure offline training moves the greedy action toward the dataset's
    optimum (a=0.5) without ever touching an env."""
    from ray_tpu_torch.rllib.algorithms import CQLConfig
    from ray_tpu_torch.rllib.algorithms.sac import SACModule

    algo = _cql_config(CQLConfig).learners(device=CPU).build()
    try:
        for _ in range(12):
            metrics = algo.train()
        assert np.isfinite(metrics["critic_loss"])
        assert np.isfinite(metrics["cql_penalty"])
        assert metrics["num_offline_transitions"] == 2000
        params = params_from_numpy(algo.learner_group.get_weights(),
                                   torch.device(CPU))
        with torch.no_grad():
            greedy, _ = SACModule(algo.spec).sample_action(
                params, torch.zeros((8, 2)), torch.zeros((8, 1)))
        mean_act = float(greedy.mean())
        assert abs(mean_act - 0.5) < 0.25, mean_act
    finally:
        algo.stop()


def test_cql_penalty_suppresses_ood_q():
    """The conservative penalty keeps Q on random (OOD) actions below Q on
    dataset-covered actions near the optimum."""
    from ray_tpu_torch.rllib.algorithms import CQLConfig
    from ray_tpu_torch.rllib.algorithms.sac import SACModule

    algo = _cql_config(CQLConfig, cql_alpha=5.0, bc_iters=0).debugging(
        seed=1).learners(device=CPU).build()
    try:
        for _ in range(8):
            algo.train()
        params = params_from_numpy(algo.learner_group.get_weights(),
                                   torch.device(CPU))
        module = SACModule(algo.spec)
        obs = torch.zeros((64, 2))
        with torch.no_grad():
            q_good = float(module.q_value(params["q1"], obs,
                                          torch.full((64, 1), 0.5)).mean())
            q_bad = float(module.q_value(params["q1"], obs,
                                         torch.full((64, 1), -0.9)).mean())
        assert q_good > q_bad, (q_good, q_bad)
    finally:
        algo.stop()


def test_cql_requires_offline_input():
    from ray_tpu_torch.rllib.algorithms import CQLConfig

    with pytest.raises(AssertionError, match="offline_data"):
        (CQLConfig()
         .environment(observation_dim=2, num_actions=1)
         .build())
