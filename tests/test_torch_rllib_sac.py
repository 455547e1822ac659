"""The port's SAC (``ray_tpu_torch/rllib/algorithms/sac.py``) against the
JAX package's on the CPU (``device="cpu"`` for every role, one torch
thread), float32:

  * ``SACModule``'s ``actor_dist``, ``sample_action`` and ``q_value`` on
    weights converted from JAX's ``init_params`` and the same numpy noise
    (``FWD_TOL``; the log-prob ``METRIC_TOL``: its ``log(1 - tanh^2)``
    term magnifies the last bit of an action near the squash's edge);
  * ``SAC.loss_fn``: the loss, its metrics and the grads of every leaf,
    ``log_alpha`` included, against ``jax.value_and_grad``
    (``LOSS_TOL``, ``GRAD_TOL``);
  * ``_compute_targets`` from converted online and target weights, with
    the same numpy rng (``LOSS_TOL``);
  * the learner side of two ``training_step``s from JAX's initial learner
    state and targets, fed JAX's own recorded Pendulum samples: each
    step's metrics (``METRIC_TOL``), then the weights and the polyak
    targets (``WEIGHT_TOL``: a few Adam steps magnify a gradient's last
    bits where the moments are small);
  * SAC's tree (``actor``, ``q1``, ``q2``, the 0-d ``log_alpha``) and its
    learner state through ``_private/convert.py`` and back, bit for bit;
  * the twins of JAX's behaviour tests (``tests/test_rllib_sac_offline.py``
    ``TestSACModule``/``TestSACPendulum``, ``tests/test_rllib_eval_cql.py::
    test_sac_evaluate_continuous``). The Pendulum learning twin takes
    longer than the tier-1 budget allows and is marked ``slow``: the
    per-update parity above already holds SAC to JAX.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu_torch._private import convert
from ray_tpu_torch.models.transformer import _leaves, map_params
from ray_tpu_torch.rllib.core.learner import params_from_numpy
from tests.test_torch_runtime_cluster import \
    retire_leftover_jax_runtime_for_later_files

CPU = "cpu"
FWD_TOL = dict(atol=1e-5, rtol=1e-5)
LOSS_TOL = dict(atol=1e-5, rtol=1e-5)
GRAD_TOL = dict(atol=1e-5, rtol=1e-4)
METRIC_TOL = dict(atol=2e-5, rtol=2e-4)
WEIGHT_TOL = dict(atol=2e-5, rtol=2e-4)
SPECS = {"h16": dict(obs_dim=3, num_actions=2, hiddens=(16,)),
         "h32x2": dict(obs_dim=5, num_actions=3, hiddens=(32, 32))}


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


def _pair(name, seed=0, log_alpha=0.0):
    """(JAX module, JAX numpy params, port module, port params on the CPU
    for autograd) from JAX's init_params; ``log_alpha`` set on both."""
    from ray_tpu.rllib.algorithms.sac import SACModule as JModule
    from ray_tpu.rllib.core.rl_module import RLModuleSpec as JSpec

    from ray_tpu_torch.rllib.algorithms.sac import SACModule
    from ray_tpu_torch.rllib.core.rl_module import RLModuleSpec

    jm = JModule(JSpec(**SPECS[name], dist_type="gaussian"))
    jp = jax.tree.map(np.asarray, jm.init_params(jax.random.PRNGKey(seed)))
    jp["log_alpha"] = np.asarray(log_alpha, np.float32)
    pm = SACModule(RLModuleSpec(**SPECS[name], dist_type="gaussian"))
    pp = params_from_numpy(convert.rl_params_from_jax(jp),
                           torch.device(CPU), True)
    return jm, jp, pm, pp


def _batch(name, n=24, seed=0):
    rng = np.random.default_rng(seed)
    d, a = SPECS[name]["obs_dim"], SPECS[name]["num_actions"]
    return {"obs": rng.normal(size=(n, d)).astype(np.float32),
            "actions": rng.uniform(-1, 1, (n, a)).astype(np.float32),
            "targets": rng.normal(size=n).astype(np.float32),
            "noise": rng.standard_normal((n, a)).astype(np.float32)}


# ------------------------------------------------------------- the module


@pytest.mark.parametrize("name", sorted(SPECS))
def test_module_matches_jax(name):
    jm, jp, pm, pp = _pair(name)
    b = _batch(name, 9)
    obs, act, noise = b["obs"], b["actions"], b["noise"] * 1.5
    with torch.no_grad():
        mean, log_std = pm.actor_dist(pp, torch.from_numpy(obs))
        a, logp = pm.sample_action(pp, torch.from_numpy(obs),
                                   torch.from_numpy(noise))
        q1 = pm.q_value(pp["q1"], torch.from_numpy(obs),
                        torch.from_numpy(act))
        q2 = pm.q_value(pp["q2"], torch.from_numpy(obs),
                        torch.from_numpy(act))
    jmean, jlog_std = jax.jit(jm.actor_dist)(jp, obs)
    ja, jlogp = jax.jit(jm.sample_action)(jp, obs, noise)
    for got, want, tol in ((mean, jmean, FWD_TOL),
                           (log_std, jlog_std, FWD_TOL), (a, ja, FWD_TOL),
                           (logp, jlogp, METRIC_TOL),
                           (q1, jm.q_value(jp["q1"], obs, act), FWD_TOL),
                           (q2, jm.q_value(jp["q2"], obs, act), FWD_TOL)):
        assert got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **tol)


def test_tanh_gaussian_logp():
    """Twin of JAX's: shapes, the squash, finite log-probs, and the mode's
    log-prob above a far tail's."""
    from ray_tpu_torch.rllib.algorithms.sac import SACModule
    from ray_tpu_torch.rllib.core.rl_module import RLModuleSpec

    m = SACModule(RLModuleSpec(obs_dim=3, num_actions=2, hiddens=(16,)))
    params = m.init_params(0, CPU)
    obs = torch.ones((5, 3))
    noise = torch.randn((5, 2), generator=torch.Generator().manual_seed(1))
    act, logp = m.sample_action(params, obs, noise)
    assert act.shape == (5, 2)
    assert float(torch.max(torch.abs(act))) <= 1.0
    assert torch.isfinite(logp).all()
    _, logp0 = m.sample_action(params, obs, torch.zeros((5, 2)))
    _, logp_far = m.sample_action(params, obs, 5.0 * torch.ones((5, 2)))
    assert float(torch.mean(logp0)) > float(torch.mean(logp_far))


def test_q_heads_differ():
    from ray_tpu_torch.rllib.algorithms.sac import SACModule
    from ray_tpu_torch.rllib.core.rl_module import RLModuleSpec

    m = SACModule(RLModuleSpec(obs_dim=3, num_actions=2, hiddens=(16,)))
    params = m.init_params(0, CPU)
    obs, act = torch.ones((4, 3)), torch.zeros((4, 2))
    q1 = m.q_value(params["q1"], obs, act)
    q2 = m.q_value(params["q2"], obs, act)
    assert q1.shape == (4,)
    assert not torch.allclose(q1, q2)


def test_init_is_seeded_on_the_cpu_then_moved():
    """The same seed gives the same params; log_alpha is 0-d and 0."""
    from ray_tpu_torch.rllib.algorithms.sac import SACModule
    from ray_tpu_torch.rllib.core.rl_module import RLModuleSpec

    m = SACModule(RLModuleSpec(**SPECS["h32x2"]))
    a, b, c = (m.init_params(s, CPU) for s in (0, 0, 1))
    for x, y in zip(_leaves(a), _leaves(b)):
        assert torch.equal(x, y)
    assert not torch.equal(a["q1"][0]["w"], c["q1"][0]["w"])
    assert a["log_alpha"].shape == () and float(a["log_alpha"]) == 0.0
    assert [layer["w"].shape for layer in a["actor"]] == [
        (5, 32), (32, 32), (32, 6)]
    assert a["q2"][0]["w"].shape == (8, 32)


# ------------------------------------------------------------ the loss


@pytest.mark.parametrize("name", sorted(SPECS))
def test_loss_and_grads_match_jax(name):
    """Every leaf's grad, ``log_alpha`` included, at a nonzero
    temperature."""
    from ray_tpu.rllib.algorithms.sac import SAC as JSAC

    from ray_tpu_torch.rllib.algorithms.sac import SAC

    jm, jp, pm, pp = _pair(name, log_alpha=-0.4)
    batch = _batch(name)
    cfg = {"target_entropy": -float(SPECS[name]["num_actions"])}
    (jloss, jmet), jgrads = jax.jit(jax.value_and_grad(
        lambda p, b: JSAC.loss_fn(jm, p, b, cfg), has_aux=True))(
            jax.tree.map(jnp.asarray, jp),
            {k: jnp.asarray(v) for k, v in batch.items()})
    loss, met = SAC.loss_fn(pm, pp, {k: torch.from_numpy(v)
                                     for k, v in batch.items()}, cfg)
    np.testing.assert_allclose(float(loss.detach()), float(jloss),
                               **LOSS_TOL)
    assert set(met) == set(jmet)
    for k in met:
        np.testing.assert_allclose(float(met[k]), float(jmet[k]),
                                   **LOSS_TOL, err_msg=k)
    grads = iter(torch.autograd.grad(loss, _leaves(pp)))
    gtree = map_params(lambda _p, _t: next(grads), pp)
    assert gtree["log_alpha"].shape == ()
    assert float(gtree["log_alpha"]) != 0.0
    _close_tree(gtree, jgrads, GRAD_TOL, name)


def test_targets_match_jax():
    """The soft TD targets from converted online and target weights: the
    same numpy noise draws, the same arithmetic."""
    from ray_tpu.rllib.algorithms.sac import SAC as JSAC
    from ray_tpu.rllib.core.rl_module import RLModuleSpec as JSpec

    from ray_tpu_torch.rllib.algorithms.sac import SAC, SACModule
    from ray_tpu_torch.rllib.core.rl_module import RLModuleSpec

    name = "h32x2"
    _, jw, _, _ = _pair(name, seed=0, log_alpha=0.25)
    _, jt, _, _ = _pair(name, seed=1)
    rng = np.random.default_rng(4)
    n = 40
    batch = {"next_obs": rng.normal(size=(n, 5)).astype(np.float32),
             "rewards": rng.normal(size=n).astype(np.float32),
             "terminateds": rng.random(n) < 0.3}
    cfg = type("C", (), {"gamma": 0.97})()
    j = JSAC.__new__(JSAC)
    j.config, j._target_fn, j._target_q = cfg, None, jt
    j.spec = JSpec(**SPECS[name], dist_type="gaussian")
    j._rng = np.random.default_rng(9)
    p = SAC.__new__(SAC)
    p.config, p._device = cfg, torch.device(CPU)
    p.spec = RLModuleSpec(**SPECS[name], dist_type="gaussian")
    p._module = SACModule(p.spec)
    p._target_q = convert.rl_params_from_jax(jt)
    p._rng = np.random.default_rng(9)
    for _ in range(2):  # the second call draws the rng's next noise
        want = j._compute_targets(batch, jw)
        got = p._compute_targets(batch, convert.rl_params_from_jax(jw))
        assert got.dtype == np.float32 and got.shape == (n,)
        np.testing.assert_allclose(got, want, **LOSS_TOL)


def test_sac_tree_round_trips_exactly():
    """SAC's params (the 0-d ``log_alpha`` kept 0-d) and a JAX learner's
    state, JAX -> port -> JAX, bit for bit."""
    from ray_tpu.rllib.algorithms.sac import SAC as JSAC
    from ray_tpu.rllib.algorithms.sac import SACModule as JModule
    from ray_tpu.rllib.core.learner import Learner as JLearner
    from ray_tpu.rllib.core.rl_module import RLModuleSpec as JSpec

    spec = JSpec(**SPECS["h16"], dist_type="gaussian", module_class=JModule)
    jl = JLearner(spec, JSAC.loss_fn, {"lr": 1e-3, "grad_clip": 0.5})
    batch = _batch("h16", 8)
    jl.update_from_batch(batch, {"target_entropy": -2.0})
    st = jax.tree.map(np.asarray, jl.get_state())
    port = convert.rl_learner_state_from_jax(st)
    assert port["params"]["log_alpha"].shape == ()
    assert port["opt_state"]["mu"]["log_alpha"].shape == ()
    back = convert.rl_learner_state_to_jax(port, st)
    a, ta = jax.tree.flatten(back)
    b, tb = jax.tree.flatten(st)
    assert ta == tb
    for x, y in zip(a, b):
        assert np.asarray(x).shape == np.asarray(y).shape
        np.testing.assert_array_equal(x, y)


# ---------------------------------------------------- the training step


def _record(runner_group):
    calls = []
    real = runner_group.sample

    def sample(*a, **k):
        out = real(*a, **k)
        calls.append(out)
        return out

    runner_group.sample = sample
    return calls


def _replay(runner_group, calls):
    it = iter(calls)
    runner_group.sample = lambda *a, **k: next(it)


def _pendulum(cls, **training):
    kw = dict(warmup_random_steps=16,
              num_steps_sampled_before_learning_starts=32,
              updates_per_iteration=4, train_batch_size=32,
              model={"hiddens": (32, 32)})
    kw.update(training)
    return (cls().environment(env="Pendulum-v1")
            .env_runners(num_envs_per_env_runner=2,
                         rollout_fragment_length=16)
            .training(**kw).debugging(seed=0))


def _on_cpu(cfg):
    return cfg.env_runners(device=CPU).learners(device=CPU)


def test_training_step_on_jax_samples_matches_jax():
    """Two training steps (the first one learns from 32 sampled steps):
    the port's learner starts from JAX's state and targets, samples what
    JAX's runner sampled, and draws JAX's replay rows and numpy noise."""
    from ray_tpu.rllib.algorithms.sac import SACConfig as JSACConfig

    from ray_tpu_torch.rllib import SACConfig

    jalgo = _pendulum(JSACConfig).build()
    palgo = _on_cpu(_pendulum(SACConfig)).build()
    try:
        palgo.learner_group.set_state(convert.rl_learner_state_from_jax(
            jax.tree.map(np.asarray, jalgo.learner_group.get_state())))
        palgo._target_q = convert.rl_params_from_jax(jalgo._target_q)
        _replay(palgo.env_runner_group, _record(jalgo.env_runner_group))
        for _ in range(2):
            jm = jalgo.training_step()
            pm = palgo.training_step()
            assert set(pm) == set(jm) and "critic_loss" in pm
            for k in pm:
                np.testing.assert_allclose(pm[k], jm[k], **METRIC_TOL,
                                           err_msg=k)
        _close_tree(palgo.learner_group.get_weights(),
                    jalgo.learner_group.get_weights(), WEIGHT_TOL,
                    "weights")
        _close_tree(palgo._target_q, jalgo._target_q, WEIGHT_TOL,
                    "targets")
        assert palgo._total_env_steps == jalgo._total_env_steps == 64
        assert len(palgo.replay) == len(jalgo.replay) == 64
    finally:
        jalgo.stop()
        palgo.stop()


def test_learns_from_a_filled_replay_without_an_env():
    """With no env the port's SAC builds no runners and learns from what
    is added to its replay."""
    from ray_tpu_torch.rllib import SAC, SACConfig

    cfg = _on_cpu(SACConfig().environment(observation_dim=3, num_actions=1)
                  .training(num_steps_sampled_before_learning_starts=0,
                            updates_per_iteration=3, train_batch_size=16,
                            model={"hiddens": (8,)}))
    algo = SAC(cfg)
    rng = np.random.default_rng(0)
    algo.replay.add({
        "obs": rng.normal(size=(64, 3)).astype(np.float32),
        "actions": rng.uniform(-1, 1, (64, 1)).astype(np.float32),
        "rewards": rng.normal(size=64).astype(np.float32),
        "next_obs": rng.normal(size=(64, 3)).astype(np.float32),
        "terminateds": np.zeros(64, bool),
        "truncateds": np.zeros(64, bool)})
    before = algo.learner_group.get_weights()
    r = algo.train()
    assert np.isfinite(r["critic_loss"]) and r["training_iteration"] == 1
    after = algo.learner_group.get_weights()
    assert not np.array_equal(after["q1"][0]["w"], before["q1"][0]["w"])
    algo.stop()


# ------------------------------------------------------- behaviour twins


def test_checkpoint_roundtrip(tmp_path):
    from ray_tpu_torch.rllib import SACConfig

    config = _on_cpu(
        SACConfig()
        .environment(env="Pendulum-v1")
        .env_runners(num_envs_per_env_runner=2, rollout_fragment_length=8)
        .training(warmup_random_steps=0,
                  num_steps_sampled_before_learning_starts=8,
                  updates_per_iteration=2, train_batch_size=16,
                  model={"hiddens": (8,)})
        .debugging(seed=0))
    algo = config.build()
    algo.train()
    state = algo.get_state()
    ckpt = algo.save_to_checkpoint(str(tmp_path / "sac"))
    algo.stop()

    algo2 = config.build()
    algo2.restore_from_checkpoint(ckpt)
    for a, b in zip(jax.tree.leaves(state["learner"]["params"]),
                    jax.tree.leaves(algo2.get_state()["learner"]["params"])):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(jax.tree.leaves(state["extra"]["target_q"]),
                    jax.tree.leaves(algo2._target_q)):
        np.testing.assert_array_equal(a, b)
    algo2.stop()


def test_sac_evaluate_continuous():
    """SAC's dedicated eval group samples greedily on Pendulum."""
    from ray_tpu_torch.rllib import SACConfig

    config = _on_cpu(
        SACConfig()
        .environment(env="Pendulum-v1")
        .env_runners(num_envs_per_env_runner=2, rollout_fragment_length=8)
        .training(warmup_random_steps=0,
                  num_steps_sampled_before_learning_starts=1000,
                  model={"hiddens": (8,)})
        .evaluation(evaluation_duration=2)
        .debugging(seed=0))
    algo = config.build()
    try:
        out = algo.evaluate()["evaluation"]
        assert out["num_episodes"] >= 2
        assert out["episode_return_mean"] is not None
    finally:
        algo.stop()


@pytest.mark.slow
def test_learns_pendulum():
    """Twin of JAX's at its config: a random policy sits near
    -1200..-1600; -400 is clearly learned."""
    from ray_tpu_torch.rllib import SACConfig

    config = _on_cpu(
        SACConfig()
        .environment(env="Pendulum-v1")
        .env_runners(num_envs_per_env_runner=8, rollout_fragment_length=32)
        .training(lr=7e-4, train_batch_size=256, updates_per_iteration=128,
                  warmup_random_steps=512,
                  num_steps_sampled_before_learning_starts=512, tau=0.005,
                  model={"hiddens": (64, 64)})
        .debugging(seed=0))
    algo = config.build()
    best = -np.inf
    for _ in range(55):
        ret = algo.train().get("episode_return_mean")
        if ret is not None:
            best = max(best, ret)
        if best >= -400:
            break
    algo.stop()
    assert best >= -400, best
