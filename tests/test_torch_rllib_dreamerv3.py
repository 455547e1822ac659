"""The port's DreamerV3 (``ray_tpu_torch/rllib/algorithms/dreamerv3.py``)
against the JAX package's on the CPU (``learner_device="cpu"``, one torch
thread), float32, at JAX's ``_tiny_config`` (``tests/
test_rllib_dreamerv3.py``), on params converted from JAX's:

  * ``symlog``/``symexp`` and the GRU (not ``torch.nn.GRUCell``) within
    ``FWD_TOL``;
  * categorical draws: JAX's ``jax.random.categorical(key, lg)`` is
    ``argmax(lg + jax.random.gumbel(key, lg.shape))``, so the tests rebuild
    JAX's Gumbel noise by replaying its key chain (``key, k = split(key)``
    a world-model step, ``key, k1, k2 = split(key, 3)`` an imagined step)
    and hand it to the port: ``obs_step``'s and ``img_step``'s one-hots and
    every draw of the losses equal JAX's exactly, deter and logits within
    ``FWD_TOL``;
  * the straight-through gradient of JAX's RSSM test loss, the world-model
    loss and the imagination actor-critic loss with every leaf's grad, on
    a batch that both packages' ``_sample_batch`` draw from the same
    warmup episodes (random actions from the shared numpy rng), within
    ``LOSS_TOL``/``GRAD_TOL``;
  * one ``training_step`` (4 world-model and 4 actor-critic Adam updates)
    from JAX's params and optimizer states, fed JAX's noise: the metrics
    (``METRIC_TOL``), the params and Adam moments (``WEIGHT_TOL``);
  * ``dreamer_state_from_jax``/``dreamer_state_to_jax`` bit for bit;
  * the twins of ``test_world_model_loss_decreases`` and
    ``test_train_iterations_end_to_end`` on CartPole.
"""

import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu_torch._private import convert
from ray_tpu_torch.models.transformer import _leaves, map_params
from ray_tpu_torch.rllib.core.learner import params_from_numpy
from tests.test_rllib_dreamerv3 import _tiny_config
from tests.test_torch_runtime_cluster import \
    retire_leftover_jax_runtime_for_later_files

CPU = torch.device("cpu")
FWD_TOL = dict(atol=1e-5, rtol=1e-5)
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


def _port_config(jcfg):
    from ray_tpu_torch.rllib.algorithms import DreamerV3Config

    cfg = DreamerV3Config()
    cfg.__dict__.update(jcfg.__dict__)
    cfg.learner_device = "cpu"
    return cfg


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


def _grad_tree(loss, tree):
    """Grads shaped as ``tree``; a leaf the loss never reads gets zeros, as
    under ``jax.grad``."""
    grads = iter(torch.autograd.grad(loss, _leaves(tree), allow_unused=True))
    return map_params(
        lambda _p, t: (lambda g: torch.zeros_like(t) if g is None else g)(
            next(grads)), tree)


def _wm_noise(key, T, shape):
    """The Gumbel noise of JAX's world-model scan from ``key``: [T, ...]."""
    out = []
    for _ in range(T):
        key, k = jax.random.split(key)
        out.append(np.asarray(jax.random.gumbel(k, shape)))
    return torch.from_numpy(np.stack(out))


def _img_noise(key, H, n_act_shape, prior_shape):
    """The actor's and the prior's Gumbel noise of JAX's imagination scan
    from ``key``: ([H, N, n_act], [H, N, groups, classes])."""
    act, prior = [], []
    for _ in range(H):
        key, k1, k2 = jax.random.split(key, 3)
        act.append(np.asarray(jax.random.gumbel(k1, n_act_shape)))
        prior.append(np.asarray(jax.random.gumbel(k2, prior_shape)))
    return torch.from_numpy(np.stack(act)), torch.from_numpy(np.stack(prior))


def _draws(stoch, cfg):
    s = stoch.detach().numpy() if isinstance(stoch, torch.Tensor) \
        else np.asarray(stoch)
    return s.reshape(s.shape[:-1] + (cfg.stoch_groups, cfg.stoch_classes)
                     ).argmax(-1)


# ------------------------------------------------------------- pieces


def test_symlog_symexp_and_gru_match_jax():
    from ray_tpu.rllib.algorithms import dreamerv3 as jd

    from ray_tpu_torch.rllib.algorithms import dreamerv3 as pd

    x = np.asarray([-100.0, -1.0, 0.0, 0.5, 1000.0], np.float32)
    np.testing.assert_allclose(pd.symexp(pd.symlog(torch.from_numpy(x))),
                               x, rtol=1e-5)
    for f in ("symlog", "symexp"):
        y = np.linspace(-6, 6, 41).astype(np.float32)
        np.testing.assert_allclose(
            getattr(pd, f)(torch.from_numpy(y)).numpy(),
            np.asarray(getattr(jd, f)(jnp.asarray(y))), **FWD_TOL)
    rng = np.random.default_rng(0)
    p = jax.tree.map(np.asarray, jd._gru_init(jax.random.PRNGKey(3), 10, 16))
    p["b"] = rng.normal(size=48).astype(np.float32)
    x = rng.normal(size=(5, 10)).astype(np.float32)
    h = rng.normal(size=(5, 16)).astype(np.float32)
    got = pd._gru({k: torch.from_numpy(v) for k, v in p.items()},
                  torch.from_numpy(x), torch.from_numpy(h))
    np.testing.assert_allclose(got.numpy(), np.asarray(jd._gru(p, x, h)),
                               **FWD_TOL)
    # not torch's GRU cell on the same weights
    cell = torch.nn.GRUCell(10, 16)
    with torch.no_grad():
        cell.weight_ih.copy_(torch.from_numpy(p["wi"]).T)
        cell.weight_hh.copy_(torch.from_numpy(p["wh"]).T)
        cell.bias_ih.copy_(torch.from_numpy(p["b"]))
        cell.bias_hh.zero_()
        other = cell(torch.from_numpy(x), torch.from_numpy(h))
    assert not torch.allclose(other, got, atol=1e-3)


def test_gumbel_max_is_jax_categorical():
    """The identity the port's draws rest on, in JAX itself."""
    key = jax.random.PRNGKey(11)
    lg = jax.random.normal(jax.random.PRNGKey(2), (64, 4, 4)) * 3.0
    want = jax.random.categorical(key, lg)
    got = jnp.argmax(lg + jax.random.gumbel(key, lg.shape), -1)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def _wm_pair(cfg, obs_dim=4, n_act=2):
    from ray_tpu.rllib.algorithms.dreamerv3 import WorldModel as JWM

    from ray_tpu_torch.rllib.algorithms.dreamerv3 import WorldModel

    jwm = JWM(cfg, obs_dim=obs_dim, n_act=n_act)
    jp = jax.tree.map(np.asarray,
                      jax.jit(jwm.init_params)(jax.random.PRNGKey(0)))
    pwm = WorldModel(_port_config(cfg), obs_dim=obs_dim, n_act=n_act)
    pp = params_from_numpy(convert.rl_params_from_jax(jp), CPU, True)
    return jwm, jp, pwm, pp


def test_obs_and_img_steps_match_jax():
    """One posterior step (the posterior and the prior drawing with one
    key) and one prior step from a nonzero state: the same one-hots,
    deter and unimix logits."""
    cfg = _tiny_config()
    jwm, jp, pwm, pp = _wm_pair(cfg)
    rng = np.random.default_rng(0)
    deter = rng.normal(size=(6, cfg.deter_dim)).astype(np.float32)
    stoch = np.eye(cfg.stoch_classes, dtype=np.float32)[
        rng.integers(0, cfg.stoch_classes, (6, cfg.stoch_groups))
    ].reshape(6, -1)
    a1h = np.eye(2, dtype=np.float32)[rng.integers(0, 2, 6)]
    obs = (rng.normal(size=(6, 4)) * 3).astype(np.float32)
    key = jax.random.PRNGKey(1)
    shape = (6, cfg.stoch_groups, cfg.stoch_classes)
    noise = torch.from_numpy(np.asarray(jax.random.gumbel(key, shape)))
    want = jax.jit(jwm.obs_step)(jp, deter, stoch, a1h, obs, key)
    with torch.no_grad():
        got = pwm.obs_step(pp, torch.from_numpy(deter),
                           torch.from_numpy(stoch), torch.from_numpy(a1h),
                           torch.from_numpy(obs), noise)
    np.testing.assert_array_equal(_draws(got[1], cfg), _draws(want[1], cfg))
    for i in (0, 2, 3):
        np.testing.assert_allclose(got[i].numpy(), np.asarray(want[i]),
                                   **FWD_TOL)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]),
                               atol=1e-6)
    jd, js = jax.jit(jwm.img_step)(jp, deter, stoch, a1h, key)
    with torch.no_grad():
        pd, ps = pwm.img_step(pp, torch.from_numpy(deter),
                              torch.from_numpy(stoch),
                              torch.from_numpy(a1h), noise)
    np.testing.assert_array_equal(_draws(ps, cfg), _draws(js, cfg))
    np.testing.assert_allclose(pd.numpy(), np.asarray(jd), **FWD_TOL)


def test_rssm_shapes_and_straight_through():
    """JAX's RSSM test: shapes, unimix rows summing to 1, and the
    straight-through gradient of ``sum(s ** 2)`` against ``jax.grad``
    for every world-model leaf."""
    cfg = _tiny_config()
    jwm, jp, pwm, pp = _wm_pair(cfg)
    deter = jnp.zeros((3, cfg.deter_dim))
    stoch = jnp.zeros((3, jwm.stoch_dim))
    a1h = jnp.zeros((3, 2))
    obs = jnp.ones((3, 4))
    key = jax.random.PRNGKey(1)
    noise = torch.from_numpy(np.asarray(jax.random.gumbel(
        key, (3, cfg.stoch_groups, cfg.stoch_classes))))
    d2, s2, post_lg, _ = pwm.obs_step(
        pp, torch.zeros((3, cfg.deter_dim)), torch.zeros((3, pwm.stoch_dim)),
        torch.zeros((3, 2)), torch.ones((3, 4)), noise)
    assert d2.shape == (3, cfg.deter_dim)
    assert s2.shape == (3, pwm.stoch_dim)
    assert post_lg.shape == (3, cfg.stoch_groups, cfg.stoch_classes)
    sums = s2.detach().reshape(3, cfg.stoch_groups, -1).sum(-1)
    np.testing.assert_allclose(sums.numpy(), 1.0, atol=1e-5)

    loss = torch.sum(s2 ** 2)
    grads = _grad_tree(loss, pp)
    assert sum(float(layer["w"].abs().sum())
               for layer in grads["encoder"]) > 0

    def jloss(p):
        _, s, _, _ = jwm.obs_step(p, deter, stoch, a1h, obs, key)
        return jnp.sum(s ** 2)

    jgrads = jax.jit(jax.grad(jloss))(jax.tree.map(jnp.asarray, jp))
    # leaves the loss does not reach are zero on both sides
    _close_tree(grads, jgrads, GRAD_TOL, "straight-through")
    np.testing.assert_allclose(float(loss), float(jax.jit(jloss)(jp)),
                               **LOSS_TOL)


# ----------------------------------------------------- losses, updates


def _algo_pair(warmup_steps=600, sample=300):
    """JAX's and the port's DreamerV3 at the tiny config, the port's on
    JAX's params and optimizer states, both having sampled ``sample``
    warmup steps of CartPole (random actions from the same numpy rng)."""
    from ray_tpu.rllib.algorithms.dreamerv3 import DreamerV3 as JD

    from ray_tpu_torch.rllib.algorithms import DreamerV3

    jcfg = _tiny_config()
    jcfg.warmup_steps = warmup_steps
    jalgo, palgo = JD(jcfg), DreamerV3(_port_config(jcfg))
    palgo.set_state(convert.dreamer_state_from_jax(
        jax.tree.map(np.asarray, jalgo.params),
        jax.tree.map(np.asarray, jalgo._opt_state)))
    jalgo._sample_steps(sample)
    palgo._sample_steps(sample)
    assert len(palgo._episodes) == len(jalgo._episodes) > 2
    for je, pe in zip(jalgo._episodes, palgo._episodes):
        for k in je:
            np.testing.assert_array_equal(pe[k], je[k])
    return jcfg, jalgo, palgo


def _same_batch(jalgo, palgo):
    jb, pb = jalgo._sample_batch(), palgo._sample_batch()
    for k in jb:
        np.testing.assert_array_equal(pb[k], jb[k])
    return ({k: jnp.asarray(v) for k, v in jb.items()},
            {k: torch.from_numpy(v) for k, v in pb.items()})


def test_world_model_and_actor_critic_losses_match_jax():
    """The world-model loss and its grads on a replayed batch, then the
    imagination actor-critic loss and its grads from JAX's posterior
    starts, on JAX's noise: every categorical draw the same."""
    cfg, jalgo, palgo = _algo_pair()
    try:
        jb, pb = _same_batch(jalgo, palgo)
        B, T, H = cfg.batch_size_B, cfg.batch_length_T, cfg.horizon_H
        G, C = cfg.stoch_groups, cfg.stoch_classes
        wm_loss = inspect.getclosurevars(
            jalgo._make_wm_update()).nonlocals["wm_loss"]
        key = jax.random.PRNGKey(7)
        (jl, jaux), jg = jax.jit(jax.value_and_grad(
            wm_loss, has_aux=True))(jalgo.params["wm"], jb, key)
        loss, aux = palgo.wm_loss(palgo.params["wm"], pb,
                                  _wm_noise(key, T, (B, G, C)))
        np.testing.assert_allclose(float(loss.detach()), float(jl),
                                   **LOSS_TOL)
        for k in ("wm_loss", "recon_loss", "kl_loss"):
            np.testing.assert_allclose(float(aux[k].detach()),
                                       float(jaux[k]), **LOSS_TOL,
                                       err_msg=k)
        np.testing.assert_array_equal(_draws(aux["starts"][1], cfg),
                                      _draws(jaux["starts"][1], cfg))
        np.testing.assert_allclose(aux["starts"][0].numpy(),
                                   np.asarray(jaux["starts"][0]), **FWD_TOL)
        _close_tree(_grad_tree(loss, palgo.params["wm"]), jg, GRAD_TOL,
                    "wm")

        # the actor and critic on imagination from JAX's starts
        ac_loss = inspect.getclosurevars(
            jalgo._make_ac_update()).nonlocals["ac_loss"]
        jstarts = jaux["starts"]
        key2 = jax.random.PRNGKey(8)
        jac = {"actor": jalgo.params["actor"],
               "critic": jalgo.params["critic"]}
        (jl2, jaux2), jg2 = jax.jit(jax.value_and_grad(
            ac_loss, has_aux=True))(jac, jalgo.params["wm"], jstarts, key2)
        starts = tuple(torch.from_numpy(np.asarray(s)) for s in jstarts)
        act_noise, prior_noise = _img_noise(key2, H, (T * B, 2),
                                            (T * B, G, C))
        pac = {"actor": palgo.params["actor"],
               "critic": palgo.params["critic"]}
        loss2, aux2 = palgo.ac_loss(pac, palgo.params["wm"], starts,
                                    act_noise, prior_noise)
        np.testing.assert_allclose(float(loss2.detach()), float(jl2),
                                   **LOSS_TOL)
        assert set(aux2) == set(jaux2)
        for k in aux2:
            np.testing.assert_allclose(float(aux2[k].detach()),
                                       float(jaux2[k]), **LOSS_TOL,
                                       err_msg=k)
        _close_tree(_grad_tree(loss2, pac), jg2, GRAD_TOL, "ac")
        # the imagined draws: JAX's scan run outside its loss, same keys
        imagine = inspect.getclosurevars(
            ac_loss).nonlocals["imagine"]
        _, _, _, _, jst = jax.jit(imagine)(
            {"actor": jac["actor"], "wm": jalgo.params["wm"]}, jstarts, key2)
        with torch.no_grad():
            *_, pst, actions = palgo.imagine(
                {"actor": pac["actor"], "wm": palgo.params["wm"]}, starts,
                act_noise, prior_noise)
        np.testing.assert_array_equal(_draws(pst, cfg), _draws(jst, cfg))
        assert actions.shape == (H, T * B)
    finally:
        jalgo.stop()
        palgo.stop()


def test_training_step_matches_jax():
    """One ``training_step`` of 4 updates after 200 more warmup steps:
    the keys JAX's updates took become the port's noise; the last
    update's metrics, the params and the three Adam states agree."""
    cfg, jalgo, palgo = _algo_pair(sample=100)
    B, T, H = cfg.batch_size_B, cfg.batch_length_T, cfg.horizon_H
    G, C = cfg.stoch_groups, cfg.stoch_classes
    keys = []
    wm_update, ac_update = jalgo._wm_update, jalgo._ac_update

    def wm_rec(p, o, b, k):
        keys.append(("wm", k))
        return wm_update(p, o, b, k)

    def ac_rec(p, o, s, k):
        keys.append(("ac", k))
        return ac_update(p, o, s, k)

    jalgo._wm_update, jalgo._ac_update = wm_rec, ac_rec
    try:
        jr = jalgo.training_step()
        assert [k for k, _ in keys] == ["wm", "ac"] * 4
        noise = iter([
            (_wm_noise(keys[i][1], T, (B, G, C)),
             *_img_noise(keys[i + 1][1], H, (T * B, 2), (T * B, G, C)))
            for i in range(0, 8, 2)])
        palgo._update_noise = lambda: next(noise)
        pr = palgo.training_step()
        jm, pm = jr["learner"]["default_policy"], pr["learner"][
            "default_policy"]
        assert set(pm) == set(jm) == {
            "wm_loss", "recon_loss", "kl_loss", "actor_loss",
            "critic_loss", "imagined_return_mean"}
        for k in pm:
            np.testing.assert_allclose(pm[k], jm[k], **METRIC_TOL,
                                       err_msg=k)
        st = palgo.get_state()
        jst = convert.dreamer_state_from_jax(
            jax.tree.map(np.asarray, jalgo.params),
            jax.tree.map(np.asarray, jalgo._opt_state))
        _close_tree(st["params"], jalgo.params, WEIGHT_TOL, "params")
        for name in ("wm", "actor", "critic"):
            assert st["opt_state"][name]["count"] == 4
            assert jst["opt_state"][name]["count"] == 4
            for m in ("mu", "nu"):
                for a, b in zip(jax.tree.leaves(st["opt_state"][name][m]),
                                jax.tree.leaves(jst["opt_state"][name][m])):
                    np.testing.assert_allclose(a, b, atol=1e-7, rtol=1e-4,
                                               err_msg=f"{name} {m}")
    finally:
        jalgo.stop()
        palgo.stop()


def test_dreamer_state_round_trips_exactly():
    from ray_tpu.rllib.algorithms.dreamerv3 import DreamerV3 as JD

    jcfg = _tiny_config()
    jalgo = JD(jcfg)
    try:
        params = jax.tree.map(np.asarray, jalgo.params)
        opt = jax.tree.map(np.asarray, jalgo._opt_state)
        st = convert.dreamer_state_from_jax(params, opt)
        assert set(st["params"]["wm"]["gru"]) == {"wi", "wh", "b"}
        bp, bo = convert.dreamer_state_to_jax(st, opt)
        for got, want in ((bp, params), (bo, opt)):
            a, ta = jax.tree.flatten(got)
            b, tb = jax.tree.flatten(want)
            assert ta == tb
            for x, y in zip(a, b):
                np.testing.assert_array_equal(x, y)
    finally:
        jalgo.stop()


# ------------------------------------------------------- behaviour twins


def _port_algo(**over):
    from ray_tpu_torch.rllib.algorithms import DreamerV3

    jcfg = _tiny_config()
    jcfg.__dict__.update(over)
    return DreamerV3(_port_config(jcfg))


def test_world_model_loss_decreases():
    """A few updates on a fixed batch must drive the WM loss down."""
    algo = _port_algo()
    try:
        algo._sample_steps(300)
        batch = {k: torch.from_numpy(v)
                 for k, v in algo._sample_batch().items()}
        cfg = algo.config
        gen = torch.Generator().manual_seed(7)
        losses = []
        for _ in range(30):
            noise = -torch.log(-torch.log(torch.rand(
                (cfg.batch_length_T, cfg.batch_size_B, cfg.stoch_groups,
                 cfg.stoch_classes), generator=gen).clamp_min(1e-38)))
            losses.append(float(algo._wm_update(batch, noise)["wm_loss"]))
        assert losses[-1] < losses[0] * 0.9, losses[:3] + losses[-3:]
    finally:
        algo.stop()


def test_train_iterations_end_to_end():
    """Full loop: sample -> world model -> imagination actor-critic.
    Metrics come back finite and env steps accumulate."""
    algo = _port_algo()
    try:
        result = None
        for _ in range(3):
            result = algo.train()
        assert result["training_iteration"] == 3
        assert result["num_env_steps_sampled_lifetime"] >= 3 * 200
        learner = result["learner"].get("default_policy", {})
        assert learner, f"no learner metrics: {result}"
        for k in ("wm_loss", "actor_loss", "critic_loss",
                  "imagined_return_mean"):
            assert np.isfinite(learner[k]), (k, learner)
        assert result["episode_return_mean"] is not None
    finally:
        algo.stop()


def test_builds_without_an_env_and_needs_a_device():
    """With no env the port builds its model and updates from the config's
    dims; with no device named and no card it raises."""
    from ray_tpu_torch.rllib.algorithms import DreamerV3, DreamerV3Config

    cfg = DreamerV3Config()
    cfg.observation_dim, cfg.num_actions = 4, 2
    cfg.deter_dim, cfg.hidden, cfg.horizon_H = 16, 16, 3
    cfg.batch_size_B, cfg.batch_length_T = 2, 4
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            DreamerV3(cfg)
    cfg.learner_device = "cpu"
    algo = DreamerV3(cfg)
    rng = np.random.default_rng(0)
    batch = {"obs": torch.from_numpy(rng.normal(size=(2, 4, 4)).astype(
                 np.float32)),
             "action": torch.from_numpy(rng.integers(0, 2, (2, 4)).astype(
                 np.int32)),
             "reward": torch.ones((2, 4)), "cont": torch.ones((2, 4))}
    wm_noise, act_noise, prior_noise = algo._update_noise()
    aux = algo._wm_update(batch, wm_noise)
    out = algo._ac_update(aux.pop("starts"), act_noise, prior_noise)
    assert all(torch.isfinite(v) for v in {**aux, **out}.values())
    assert all(st.count == 1 for st in algo._opt_state.values())
    algo.stop()
