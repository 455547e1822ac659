"""The port's RLlib core (``ray_tpu_torch.rllib``) against the JAX package
on the CPU, float32, TF32 off: the RLModule's forwards, GAE and V-trace,
every loss and its grads (PPO, IMPALA on conv obs, APPO, DQN), the
learner's optimizer over several updates on both sides of the clip
threshold, a learner resumed from JAX's state, connectors, replay buffers,
the synthetic Atari env's tensor mirror, weight and state conversion, and
the device rule (no card, no device named: every entry point raises).

Inputs are seeded numpy; the port's weights are JAX's ``init_params``
converted with ``_private/convert.py``. Tolerances (absolute + relative):
  * forwards: ``FWD_TOL`` (MLP), ``CONV_TOL`` (the Nature-CNN stem, a
    longer accumulation in another order);
  * GAE and V-trace: ``ADV_TOL``;
  * losses and grads: ``LOSS_TOL`` and ``GRAD_TOL``;
  * learner updates (5 steps of Adam, whose normalization magnifies a
    gradient's last bits where the moments are small): metrics
    ``LOSS_TOL``, params ``PARAM_TOL``;
  * the env mirror, replay buffers, connectors and conversions: exact.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu_torch._private import convert
from ray_tpu_torch.rllib.core.learner import (Learner, params_from_numpy,
                                              to_numpy_tree)
from ray_tpu_torch.rllib.core.rl_module import RLModule, RLModuleSpec

CPU = torch.device("cpu")
FWD_TOL = dict(atol=1e-5, rtol=1e-5)
CONV_TOL = dict(atol=1e-4, rtol=1e-4)
ADV_TOL = dict(atol=1e-5, rtol=1e-5)
LOSS_TOL = dict(atol=1e-5, rtol=1e-5)
GRAD_TOL = dict(atol=1e-5, rtol=1e-4)
PARAM_TOL = dict(atol=1e-5, rtol=1e-4)

SPECS = {
    "mlp_separate": dict(obs_dim=6, num_actions=3, hiddens=(16, 16)),
    "mlp_shared": dict(obs_dim=6, num_actions=3, hiddens=(16, 16),
                       vf_share_layers=True),
    "conv_separate": dict(obs_dim=20 * 20 * 4, num_actions=4,
                          hiddens=(32,), obs_shape=(20, 20, 4),
                          conv_filters=((8, 4, 2), (16, 3, 1))),
    "conv_shared": dict(obs_dim=20 * 20 * 4, num_actions=4, hiddens=(32,),
                        obs_shape=(20, 20, 4),
                        conv_filters=((8, 4, 2), (16, 3, 1)),
                        vf_share_layers=True),
}


@functools.lru_cache(maxsize=None)
def _jax_module(name, seed):
    from ray_tpu.rllib.core.rl_module import RLModule as JModule
    from ray_tpu.rllib.core.rl_module import RLModuleSpec as JSpec

    jm = JModule(JSpec(**SPECS[name]))
    return jm, jax.tree.map(np.asarray, jax.jit(jm.init_params)(
        jax.random.PRNGKey(seed)))


def _pair(name, seed=0):
    """(JAX module, JAX numpy params, port module, port params on the
    CPU) from JAX's init_params."""
    jm, jp = _jax_module(name, seed)
    jp = jax.tree.map(np.copy, jp)
    pm = RLModule(RLModuleSpec(**SPECS[name]))
    pp = params_from_numpy(convert.rl_params_from_jax(jp), CPU, True)
    return jm, jp, pm, pp


def _obs(name, n, seed=0):
    rng = np.random.default_rng(seed)
    spec = SPECS[name]
    if spec.get("obs_shape"):
        return rng.integers(0, 256, (n,) + spec["obs_shape"]).astype(
            np.uint8)
    return rng.normal(size=(n, spec["obs_dim"])).astype(np.float32)


def _tol(name):
    return CONV_TOL if name.startswith("conv") else FWD_TOL


def _np(t):
    return t.detach().numpy()


def _close_tree(port_tree, jax_tree, tol, what=""):
    """A port params-shaped tree (tensors or numpy, OIHW) against a JAX one
    (numpy, HWIO)."""
    got = convert.rl_params_to_jax(port_tree)
    flat_g = jax.tree_util.tree_flatten_with_path(got)[0]
    flat_w = dict(jax.tree_util.tree_flatten_with_path(
        jax.tree.map(np.asarray, jax_tree))[0])
    assert len(flat_g) == len(flat_w)
    for path, g in flat_g:
        np.testing.assert_allclose(g, flat_w[path], **tol,
                                   err_msg=f"{what} {path}")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The CPU's intra-op pool costs more than it saves at these sizes
    (a [8, 2] ``log_softmax`` takes about 250x longer on 8 threads than
    on 1), so the file runs on one thread and gives the rest back."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ------------------------------------------------------------- the module


@pytest.mark.parametrize("name", sorted(SPECS))
def test_forwards_match_jax(name):
    jm, jp, pm, pp = _pair(name)
    obs = _obs(name, 7)
    with torch.no_grad():
        logits, value = pm.forward_train(pp, torch.from_numpy(obs))
        inf = pm.forward_inference(pp, torch.from_numpy(obs))
    jl, jv = jax.jit(jm.forward_train)(jp, jnp.asarray(obs))
    np.testing.assert_allclose(_np(logits), np.asarray(jl), **_tol(name))
    np.testing.assert_allclose(_np(value), np.asarray(jv), **_tol(name))
    np.testing.assert_array_equal(_np(inf), _np(logits))
    # exploration: the port draws its own actions (another stream than
    # JAX's); its logp at those actions and its value are JAX's
    gen = torch.Generator().manual_seed(3)
    with torch.no_grad():
        act, logp, val = pm.forward_exploration(pp, torch.from_numpy(obs),
                                                gen)
    assert act.dtype == torch.int64 and act.shape == (7,)
    assert int(act.min()) >= 0 and int(act.max()) < pm.spec.num_actions
    jlogp = np.asarray(jax.nn.log_softmax(jl))[np.arange(7), _np(act)]
    np.testing.assert_allclose(_np(logp), jlogp, **_tol(name))
    np.testing.assert_allclose(_np(val), np.asarray(jv), **_tol(name))


def test_exploration_draws_follow_the_generator():
    _, _, pm, pp = _pair("mlp_separate")
    obs = torch.from_numpy(_obs("mlp_separate", 4096))
    draws = [pm.forward_exploration(pp, obs, torch.Generator()
                                    .manual_seed(s))[0] for s in (5, 5, 6)]
    assert torch.equal(draws[0], draws[1])
    assert not torch.equal(draws[0], draws[2])
    # Gumbel-max draws follow softmax(logits): frequencies near the probs
    from ray_tpu_torch.rllib.core.rl_module import sample_categorical

    logits = torch.tensor([[0.0, 1.0, -1.0]]).repeat(20000, 1)
    a = sample_categorical(logits, torch.Generator().manual_seed(0))
    freq = torch.bincount(a, minlength=3).float() / 20000
    np.testing.assert_allclose(freq.numpy(),
                               torch.softmax(logits[0], -1).numpy(),
                               atol=0.015)


def test_init_is_seeded_and_shaped_like_jax():
    for name in SPECS:
        _, jp, pm, _ = _pair(name)
        a = to_numpy_tree(pm.init_params(0, "cpu"))
        b = to_numpy_tree(pm.init_params(0, "cpu"))
        c = to_numpy_tree(pm.init_params(1, "cpu"))
        ja = convert.rl_params_to_jax(a)
        assert (jax.tree.map(np.shape, ja)
                == jax.tree.map(np.shape, jp)), name
        for x, y in zip(jax.tree.leaves(convert.rl_params_to_jax(b)),
                        jax.tree.leaves(ja)):
            np.testing.assert_array_equal(x, y)
        assert any(not np.array_equal(x, y) for x, y in zip(
            jax.tree.leaves(convert.rl_params_to_jax(c)),
            jax.tree.leaves(ja)))


def test_conv_too_small_raises():
    spec = RLModuleSpec(obs_dim=16, num_actions=2, obs_shape=(4, 4, 1))
    with pytest.raises(ValueError, match="too small"):
        RLModule(spec).init_params(0, "cpu")


def test_rl_params_round_trip_exact():
    for name in SPECS:
        _, jp, _, _ = _pair(name)
        back = convert.rl_params_to_jax(convert.rl_params_from_jax(jp))
        for x, y in zip(jax.tree.leaves(back), jax.tree.leaves(jp)):
            np.testing.assert_array_equal(x, y)


# ------------------------------------------------------------- advantages


def _rollout_arrays(T=12, B=3, seed=0):
    rng = np.random.default_rng(seed)
    return dict(
        rewards=rng.normal(size=(T, B)).astype(np.float32),
        values=rng.normal(size=(T, B)).astype(np.float32),
        boot=rng.normal(size=(B,)).astype(np.float32),
        term=rng.random((T, B)) < 0.15,
        trunc=rng.random((T, B)) < 0.1,
        blogp=rng.normal(size=(T, B)).astype(np.float32) - 1.0,
        tlogp=rng.normal(size=(T, B)).astype(np.float32) - 1.0)


@pytest.mark.parametrize("gamma,lam", [(0.99, 0.95), (0.97, 0.9)])
def test_gae_matches_jax(gamma, lam):
    from ray_tpu.rllib.utils import compute_gae as jgae

    from ray_tpu_torch.rllib.utils import compute_gae

    a = _rollout_arrays()
    assert a["term"].any() and a["trunc"].any()
    adv, tgt = compute_gae(a["rewards"], a["values"], a["boot"], a["term"],
                           a["trunc"], gamma=gamma, lam=lam)
    jadv, jtgt = jgae(a["rewards"], a["values"], a["boot"], a["term"],
                      a["trunc"], gamma=gamma, lam=lam)
    assert adv.dtype == torch.float32
    np.testing.assert_allclose(_np(adv), np.asarray(jadv), **ADV_TOL)
    np.testing.assert_allclose(_np(tgt), np.asarray(jtgt), **ADV_TOL)


@pytest.mark.parametrize("clip", [(1.0, 1.0), (0.8, 0.5)])
def test_vtrace_matches_jax(clip):
    from ray_tpu.rllib.utils import vtrace_returns as jvtrace

    from ray_tpu_torch.rllib.utils import vtrace_returns

    a = _rollout_arrays(seed=1)
    args = (a["blogp"], a["tlogp"], a["rewards"], a["values"], a["boot"],
            a["term"], a["trunc"])
    vs, pg = vtrace_returns(*args, gamma=0.95, clip_rho=clip[0],
                            clip_c=clip[1])
    jvs, jpg = jvtrace(*args, gamma=0.95, clip_rho=clip[0], clip_c=clip[1])
    np.testing.assert_allclose(_np(vs), np.asarray(jvs), **ADV_TOL)
    np.testing.assert_allclose(_np(pg), np.asarray(jpg), **ADV_TOL)


def test_gae_matches_numpy():
    """Twin of JAX's ``TestAdvantages.test_gae_matches_numpy``."""
    from ray_tpu_torch.rllib.utils import compute_gae

    rng = np.random.default_rng(0)
    T, B = 12, 3
    gamma, lam = 0.97, 0.9
    rewards = rng.normal(size=(T, B)).astype(np.float32)
    values = rng.normal(size=(T, B)).astype(np.float32)
    boot = rng.normal(size=(B,)).astype(np.float32)
    term = rng.random((T, B)) < 0.1
    trunc = rng.random((T, B)) < 0.05
    adv, tgt = compute_gae(rewards, values, boot, term, trunc,
                           gamma=gamma, lam=lam)
    done = term | trunc
    expect = np.zeros((T, B))
    carry = np.zeros(B)
    nv = np.concatenate([values[1:], boot[None]], axis=0)
    for t in reversed(range(T)):
        nd = 1.0 - done[t].astype(np.float64)
        delta = rewards[t] + gamma * nv[t] * nd - values[t]
        carry = delta + gamma * lam * nd * carry
        expect[t] = carry
    np.testing.assert_allclose(_np(adv), expect, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(_np(tgt), expect + values, rtol=1e-4,
                               atol=1e-4)


def test_vtrace_on_policy_is_td_lambda1():
    from ray_tpu_torch.rllib.utils import vtrace_returns

    rng = np.random.default_rng(1)
    T, B = 10, 2
    gamma = 0.95
    logp = rng.normal(size=(T, B)).astype(np.float32)
    rewards = rng.normal(size=(T, B)).astype(np.float32)
    values = rng.normal(size=(T, B)).astype(np.float32)
    boot = rng.normal(size=(B,)).astype(np.float32)
    zeros = np.zeros((T, B), bool)
    vs, _ = vtrace_returns(logp, logp, rewards, values, boot, zeros, zeros,
                           gamma=gamma)
    ret = boot.astype(np.float64)
    expect = np.zeros((T, B))
    for t in reversed(range(T)):
        ret = rewards[t] + gamma * ret
        expect[t] = ret
    np.testing.assert_allclose(_np(vs), expect, rtol=1e-3, atol=1e-3)


def test_vtrace_clips_offpolicy_ratios():
    from ray_tpu_torch.rllib.utils import vtrace_returns

    T, B = 6, 1
    behaviour = np.full((T, B), -5.0, np.float32)
    target = np.zeros((T, B), np.float32)
    rewards = np.ones((T, B), np.float32)
    values = np.zeros((T, B), np.float32)
    boot = np.zeros((B,), np.float32)
    zeros = np.zeros((T, B), bool)
    vs, _ = vtrace_returns(behaviour, target, rewards, values, boot, zeros,
                           zeros, gamma=0.9, clip_rho=1.0, clip_c=1.0)
    vs2, _ = vtrace_returns(target, target, rewards, values, boot, zeros,
                            zeros, gamma=0.9)
    np.testing.assert_allclose(_np(vs), _np(vs2), rtol=1e-4)


# ---------------------------------------------------------- losses, grads


def _ppo_batch(name, n=32, seed=0):
    rng = np.random.default_rng(seed)
    k = SPECS[name]["num_actions"]
    return {
        "obs": _obs(name, n, seed),
        "actions": rng.integers(0, k, n).astype(np.int64),
        "logp": (rng.normal(size=n) * 0.3 - 1.2).astype(np.float32),
        "values": rng.normal(size=n).astype(np.float32),
        "advantages": rng.normal(size=n).astype(np.float32),
        "value_targets": rng.normal(size=n).astype(np.float32),
        "kl_coeff": np.full(n, 0.3, np.float32),
    }


def _cm_batch(name, B=3, T=5, seed=0, kl=False):
    """An IMPALA/APPO column-major batch with episode ends inside."""
    rng = np.random.default_rng(seed)
    k = SPECS[name]["num_actions"]
    obs = _obs(name, B * T + B, seed)
    out = {
        "obs": obs[:B * T].reshape((B, T) + obs.shape[1:]),
        "actions": rng.integers(0, k, (B, T)).astype(np.int64),
        "logp": (rng.normal(size=(B, T)) * 0.3 - 1.2).astype(np.float32),
        "rewards": rng.normal(size=(B, T)).astype(np.float32),
        "terminateds": rng.random((B, T)) < 0.2,
        "truncateds": rng.random((B, T)) < 0.15,
        "bootstrap_obs": obs[B * T:],
    }
    if kl:
        out["kl_coeff"] = np.full(B, 0.7, np.float32)
    return out


def _dqn_batch(name, n=32, seed=0, weights=False):
    rng = np.random.default_rng(seed)
    k = SPECS[name]["num_actions"]
    out = {"obs": _obs(name, n, seed),
           "actions": rng.integers(0, k, n).astype(np.int64),
           # TD errors on both sides of the Huber knee
           "targets": (rng.normal(size=n) * 2.0).astype(np.float32)}
    if weights:
        out["weights"] = rng.uniform(0.1, 1.0, n).astype(np.float32)
    return out


PPO_CFG = {"clip_param": 0.2, "vf_clip_param": 0.5, "vf_loss_coeff": 0.5,
           "entropy_coeff": 0.01}
IMPALA_CFG = {"gamma": 0.95, "clip_rho": 1.0, "clip_c": 1.0,
              "vf_loss_coeff": 0.5, "entropy_coeff": 0.01}
APPO_CFG = dict(IMPALA_CFG, clip_param=0.2, use_kl_loss=True)


def _loss_case(algo):
    from ray_tpu.rllib import algorithms as jalg

    from ray_tpu_torch.rllib import algorithms as palg

    return {
        "ppo_mlp": (jalg.PPO, palg.PPO, "mlp_separate", PPO_CFG,
                    lambda n: _ppo_batch(n)),
        "ppo_conv": (jalg.PPO, palg.PPO, "conv_shared", PPO_CFG,
                     lambda n: _ppo_batch(n, 16)),
        "impala_conv": (jalg.IMPALA, palg.IMPALA, "conv_separate",
                        IMPALA_CFG, lambda n: _cm_batch(n)),
        "impala_mlp": (jalg.IMPALA, palg.IMPALA, "mlp_shared", IMPALA_CFG,
                       lambda n: _cm_batch(n)),
        "appo_mlp": (jalg.APPO, palg.APPO, "mlp_separate", APPO_CFG,
                     lambda n: _cm_batch(n, kl=True)),
        "dqn": (jalg.DQN, palg.DQN, "mlp_separate", {"_algo": "dqn"},
                lambda n: _dqn_batch(n)),
        "dqn_is_weights": (jalg.DQN, palg.DQN, "mlp_shared",
                           {"_algo": "dqn"},
                           lambda n: _dqn_batch(n, weights=True)),
    }[algo]


@pytest.mark.parametrize("algo", ["ppo_mlp", "ppo_conv", "impala_conv",
                                  "impala_mlp", "appo_mlp", "dqn",
                                  "dqn_is_weights"])
def test_loss_and_grads_match_jax(algo):
    jcls, pcls, name, cfg, make = _loss_case(algo)
    jm, jp, pm, pp = _pair(name)
    batch = make(name)
    (jloss, jmet), jgrads = jax.jit(jax.value_and_grad(
        lambda p, b: jcls.loss_fn(jm, p, b, cfg), has_aux=True))(
            jax.tree.map(jnp.asarray, jp),
            {k: jnp.asarray(v) for k, v in batch.items()})
    loss, met = pcls.loss_fn(pm, pp, {k: torch.from_numpy(v)
                                      for k, v in batch.items()}, cfg)
    tol = CONV_TOL if name.startswith("conv") else LOSS_TOL
    np.testing.assert_allclose(float(loss.detach()), float(jloss), **tol)
    assert set(met) == set(jmet)
    for k in met:
        np.testing.assert_allclose(float(met[k]), float(jmet[k]), **tol,
                                   err_msg=k)
    from ray_tpu_torch.models.transformer import _leaves, map_params

    grads = torch.autograd.grad(loss, _leaves(pp), allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(_leaves(pp), grads)]
    it = iter(grads)
    gtree = map_params(lambda _p, _t: next(it), pp)
    _close_tree(gtree, jgrads,
                CONV_TOL if name.startswith("conv") else GRAD_TOL, algo)


@pytest.mark.parametrize("double_q", [True, False])
def test_dqn_targets_match_jax(double_q):
    """The driver-side TD targets, double Q on and off, from converted
    online and target weights."""
    from ray_tpu.rllib.algorithms.dqn import DQN as JDQN

    from ray_tpu_torch.rllib.algorithms.dqn import DQN

    jm, jp, pm, pp = _pair("mlp_separate")
    _, jt, _, _ = _pair("mlp_separate", seed=1)
    rng = np.random.default_rng(4)
    batch = {"next_obs": _obs("mlp_separate", 24, 4),
             "rewards": rng.normal(size=24).astype(np.float32),
             "dones": rng.random(24) < 0.3}
    cfg = type("C", (), {"double_q": double_q, "gamma": 0.97})()

    class LG:  # the learner group's weights, as each driver reads them
        def __init__(self, w):
            self.w, self.is_local = w, False

        def get_weights(self):
            return self.w

    j = JDQN.__new__(JDQN)
    j.config, j._target_fn, j._target_weights = cfg, None, jt
    j.learner_group = LG(jp)
    j.spec = jm.spec
    want = j._compute_targets(batch)
    p = DQN.__new__(DQN)
    p.config, p._device, p._module = cfg, CPU, pm
    p._target_weights = convert.rl_params_from_jax(jt)
    p.learner_group = LG(convert.rl_params_from_jax(jp))
    got = p._compute_targets(batch)
    np.testing.assert_allclose(got, want, **LOSS_TOL)


def test_appo_takes_conv_obs():
    """The port's APPO keeps image obs as [N, H, W, C] (JAX's flattens
    them to rows, which its conv stem refuses: ``TypeError``). Held
    against JAX's APPO loss through a module that folds the rows back."""
    from ray_tpu.rllib.algorithms.appo import APPO as JAPPO

    from ray_tpu_torch.rllib import APPO

    jm, jp, pm, pp = _pair("conv_separate")
    batch = _cm_batch("conv_separate", kl=True)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    with pytest.raises(TypeError):
        JAPPO.loss_fn(jm, jp, jbatch, APPO_CFG)

    class Rows:  # JAX's module, given the rows JAX's APPO makes
        def forward_train(self, p, obs):
            return jm.forward_train(
                p, obs.reshape((-1,) + jm.spec.obs_shape))

    jloss, jmet = JAPPO.loss_fn(Rows(), jp, jbatch, APPO_CFG)
    loss, met = APPO.loss_fn(pm, pp, {k: torch.from_numpy(v)
                                      for k, v in batch.items()}, APPO_CFG)
    np.testing.assert_allclose(float(loss.detach()), float(jloss),
                               **CONV_TOL)
    for k in jmet:
        np.testing.assert_allclose(float(met[k].detach()), float(jmet[k]),
                                   **CONV_TOL, err_msg=k)


def test_appo_clip_anchors_update():
    """Twin of JAX's ``TestAPPO.test_clip_anchors_update``."""
    from ray_tpu_torch.rllib import APPO

    spec = RLModuleSpec(obs_dim=4, num_actions=2, hiddens=(8,))
    module = RLModule(spec)
    params = module.init_params(0, "cpu")
    B, T = 2, 4
    rng = np.random.default_rng(0)
    batch = {
        "obs": rng.normal(size=(B, T, 4)).astype(np.float32),
        "actions": rng.integers(0, 2, (B, T)),
        "logp": np.full((B, T), -10.0, np.float32),
        "rewards": np.ones((B, T), np.float32),
        "terminateds": np.zeros((B, T), bool),
        "truncateds": np.zeros((B, T), bool),
        "bootstrap_obs": rng.normal(size=(B, 4)).astype(np.float32),
    }
    cfg = {"gamma": 0.99, "clip_rho": 1.0, "clip_c": 1.0,
           "vf_loss_coeff": 0.5, "entropy_coeff": 0.0,
           "clip_param": 0.2, "use_kl_loss": False, "kl_coeff": 1.0}
    loss, metrics = APPO.loss_fn(module, params,
                                 {k: torch.as_tensor(v)
                                  for k, v in batch.items()}, cfg)
    assert np.isfinite(float(loss))
    assert float(metrics["mean_kl"]) >= 0.0


# --------------------------------------------------------------- learner


def _jax_learner(name, loss_fn, lr, clip, seed=0):
    from ray_tpu.rllib.core.learner import Learner as JLearner
    from ray_tpu.rllib.core.rl_module import RLModuleSpec as JSpec

    return JLearner(JSpec(**SPECS[name]), loss_fn,
                    {"lr": lr, "grad_clip": clip}, seed=seed)


def _port_learner_from(jl, name, loss_fn, lr, clip):
    pl = Learner(RLModuleSpec(**SPECS[name]), loss_fn,
                 {"lr": lr, "grad_clip": clip}, seed=0, device="cpu")
    pl.set_state(convert.rl_learner_state_from_jax(jl.get_state()))
    return pl


@pytest.mark.parametrize("name,clip", [("mlp_separate", 4.0),
                                       ("conv_shared", 12.0)])
def test_learner_updates_match_jax(name, clip):
    """5 PPO updates through ``update_from_batch``: batches 0, 2, 4 with
    targets and advantages that push the grad norm above the clip, 1 and
    3 below it.
    Metrics after each update and the params and Adam moments after all
    five."""
    from ray_tpu.rllib.algorithms.ppo import PPO as JPPO

    from ray_tpu_torch.rllib import PPO

    jl = _jax_learner(name, JPPO.loss_fn, 3e-3, clip)
    pl = _port_learner_from(jl, name, PPO.loss_fn, 3e-3, clip)
    above = 0
    for i in range(5):
        b = _ppo_batch(name, 24, seed=10 + i)
        scale = 30.0 if i % 2 == 0 else 0.01
        b["value_targets"] *= scale
        b["advantages"] *= scale
        _, _, grads = pl.compute_grads(b, PPO_CFG)
        norm = float(torch.linalg.vector_norm(
            torch.stack([g.norm() for g in grads])))
        above += norm >= clip
        assert (norm >= clip) == (i % 2 == 0), (i, norm)
        jm = jl.update_from_batch(b, PPO_CFG)
        pm = pl.update_from_batch(b, PPO_CFG)
        assert set(pm) == set(jm)
        for k in pm:
            np.testing.assert_allclose(pm[k], jm[k], **LOSS_TOL,
                                       err_msg=f"{i} {k}")
    assert above == 3
    _close_tree(pl.get_weights(), jl.get_state()["params"], PARAM_TOL,
                "params")
    st = pl.get_state()
    jst = convert.rl_learner_state_from_jax(jl.get_state())
    assert st["opt_state"]["count"] == jst["opt_state"]["count"] == 5
    for key in ("mu", "nu"):
        for a, b in zip(jax.tree.leaves(st["opt_state"][key]),
                        jax.tree.leaves(jst["opt_state"][key])):
            np.testing.assert_allclose(a, b, atol=1e-7, rtol=1e-4,
                                       err_msg=key)


def test_learner_resumed_from_jax_state_takes_jax_next_step():
    """JAX trains 3 steps; its state carried into a fresh port learner
    (params, mu, nu, count) takes JAX's 4th step."""
    from ray_tpu.rllib.algorithms.impala import IMPALA as JIMPALA

    from ray_tpu_torch.rllib import IMPALA

    name = "mlp_separate"
    jl = _jax_learner(name, JIMPALA.loss_fn, 1e-2, 0.5, seed=3)
    for i in range(3):
        jl.update_from_batch(_cm_batch(name, seed=20 + i), IMPALA_CFG)
    pl = _port_learner_from(jl, name, IMPALA.loss_fn, 1e-2, 0.5)
    assert pl.opt_state.count == 3
    b = _cm_batch(name, seed=30)
    jm = jl.update_from_batch(b, IMPALA_CFG)
    pm = pl.update_from_batch(b, IMPALA_CFG)
    for k in jm:
        np.testing.assert_allclose(pm[k], jm[k], **LOSS_TOL, err_msg=k)
    _close_tree(pl.get_weights(), jl.get_state()["params"], PARAM_TOL)
    # and back: the port's state into a JAX learner gives the same bytes
    back = convert.rl_learner_state_to_jax(pl.get_state(), jl.get_state())
    for a, b2 in zip(jax.tree.leaves(back["params"]),
                     jax.tree.leaves(convert.rl_params_to_jax(
                         pl.get_weights()))):
        np.testing.assert_array_equal(a, b2)


def test_learner_state_round_trip_is_exact():
    from ray_tpu_torch.rllib import PPO

    pl = Learner(RLModuleSpec(**SPECS["conv_separate"]), PPO.loss_fn,
                 {"lr": 1e-3}, device="cpu")
    pl.update_from_batch(_ppo_batch("conv_separate", 8), PPO_CFG)
    st = pl.get_state()
    other = Learner(RLModuleSpec(**SPECS["conv_separate"]), PPO.loss_fn,
                    {"lr": 1e-3}, seed=5, device="cpu")
    other.set_state(st)
    st2 = other.get_state()
    assert st2["opt_state"]["count"] == 1
    for a, b in zip(jax.tree.leaves(st), jax.tree.leaves(st2)):
        np.testing.assert_array_equal(a, b)
    # get_weights is a copy: a later update leaves it as it was
    w = pl.get_weights()
    before = [x.copy() for x in jax.tree.leaves(w)]
    pl.update_from_batch(_ppo_batch("conv_separate", 8, 1), PPO_CFG)
    for a, b in zip(jax.tree.leaves(w), before):
        np.testing.assert_array_equal(a, b)


def test_optimizer_is_optax_clip_then_adam():
    """The port's chain against ``optax.chain(clip_by_global_norm,
    adam)`` on the same grads, 4 steps alternating above and below the
    clip."""
    import optax

    from ray_tpu_torch.rllib.core.learner import make_optimizer

    rng = np.random.default_rng(0)
    p0 = {"a": rng.normal(size=(5, 3)).astype(np.float32),
          "b": [rng.normal(size=4).astype(np.float32)]}
    tx = optax.chain(optax.clip_by_global_norm(0.5), optax.adam(1e-2))
    jp = jax.tree.map(jnp.asarray, p0)
    js = tx.init(jp)
    opt = make_optimizer(1e-2, 0.5)
    pp = {"a": torch.from_numpy(p0["a"].copy()),
          "b": [torch.from_numpy(p0["b"][0].copy())]}
    st = opt.init(pp)
    for i in range(4):
        scale = 3.0 if i % 2 == 0 else 0.01
        g = {"a": (rng.normal(size=(5, 3)) * scale).astype(np.float32),
             "b": [(rng.normal(size=4) * scale).astype(np.float32)]}
        upd, js = tx.update(jax.tree.map(jnp.asarray, g), js, jp)
        jp = optax.apply_updates(jp, upd)
        opt.update([torch.from_numpy(g["a"]), torch.from_numpy(g["b"][0])],
                   st, pp)
    np.testing.assert_allclose(pp["a"].numpy(), np.asarray(jp["a"]),
                               atol=1e-6, rtol=1e-5)
    np.testing.assert_allclose(pp["b"][0].numpy(), np.asarray(jp["b"][0]),
                               atol=1e-6, rtol=1e-5)


# ------------------------------------------------- connectors, replay


def test_connectors_match_jax():
    from ray_tpu.rllib import connectors as jc

    from ray_tpu_torch.rllib import connectors as pc

    rng = np.random.default_rng(0)
    batches = [rng.normal(size=(6, 3)).astype(np.float32) * (i + 1)
               for i in range(4)]
    jn, pn = jc.NormalizeObs(clip=2.0), pc.NormalizeObs(clip=2.0)
    for b in batches:
        np.testing.assert_array_equal(pn(b), jn(b))
    rb = {"rewards": rng.normal(size=10).astype(np.float32) * 3}
    for kw in ({}, {"sign": True}, {"limit": 0.5}):
        np.testing.assert_array_equal(
            pc.ClipRewards(**kw)(dict(rb))["rewards"],
            jc.ClipRewards(**kw)(dict(rb))["rewards"])
    img = rng.integers(0, 255, (2, 3, 4, 4, 2)).astype(np.uint8)
    for keep in (1, 2):
        np.testing.assert_array_equal(pc.FlattenObs(keep)(img),
                                      jc.FlattenObs(keep)(img))
    np.testing.assert_array_equal(pc.CastObs(np.float32, 1 / 255)(img),
                                  jc.CastObs(np.float32, 1 / 255)(img))
    pipe = pc.ConnectorPipeline([pc.CastObs(np.float32)]).append(
        lambda x: x * 2).prepend(pc.FlattenObs())
    jpipe = jc.ConnectorPipeline([jc.CastObs(np.float32)]).append(
        lambda x: x * 2).prepend(jc.FlattenObs())
    assert len(pipe) == 3
    np.testing.assert_array_equal(pipe(img[0]), jpipe(img[0]))


def test_replay_buffers_match_jax():
    """FIFO wrap-around, prioritized weights and indices after priority
    updates, and the state round trip: the same draws as JAX's."""
    from ray_tpu.rllib.utils import replay_buffers as jr

    from ray_tpu_torch.rllib.utils import replay_buffers as pr

    for cls in ("ReplayBuffer", "PrioritizedReplayBuffer"):
        a, b = getattr(pr, cls)(10, seed=3), getattr(jr, cls)(10, seed=3)
        for lo, hi in ((0, 8), (8, 14), (14, 40)):
            rows = {"x": np.arange(lo, hi), "y": np.arange(lo, hi) * 2.0}
            a.add(rows)
            b.add(rows)
        assert len(a) == len(b) == 10
        if cls == "PrioritizedReplayBuffer":
            for buf in (a, b):
                buf.update_priorities(np.array([1, 4]),
                                      np.array([5.0, -0.5]))
            sa, sb = a.sample(32, beta=0.7), b.sample(32, beta=0.7)
        else:
            sa, sb = a.sample(32), b.sample(32)
        assert set(sa) == set(sb)
        for k in sa:
            np.testing.assert_array_equal(sa[k], sb[k])
        st = a.get_state()
        c = getattr(pr, cls)(10, seed=4)
        c.set_state(st)
        jst = b.get_state()
        for k in st["store"]:
            np.testing.assert_array_equal(st["store"][k], jst["store"][k])
        assert (st["next"], st["size"]) == (jst["next"], jst["size"])
        assert len(c) == 10 and set(c.sample(20)["x"]) <= set(range(30, 40))


def test_fifo_wraparound():
    from ray_tpu_torch.rllib.utils import ReplayBuffer

    buf = ReplayBuffer(capacity=10, seed=0)
    buf.add({"x": np.arange(8), "y": np.arange(8) * 2.0})
    assert len(buf) == 8
    buf.add({"x": np.arange(8, 14), "y": np.arange(8, 14) * 2.0})
    assert len(buf) == 10
    batch = buf.sample(64)
    np.testing.assert_allclose(batch["y"], batch["x"] * 2.0)
    assert batch["x"].min() >= 4


def test_prioritized_bias_and_weights():
    from ray_tpu_torch.rllib.utils import PrioritizedReplayBuffer

    buf = PrioritizedReplayBuffer(capacity=100, alpha=1.0, seed=0)
    buf.add({"x": np.arange(100)})
    buf.update_priorities(np.array([7]), np.array([1000.0]))
    batch = buf.sample(500, beta=1.0)
    counts = np.bincount(batch["x"], minlength=100)
    assert counts[7] > 300
    assert batch["weights"].min() > 0
    assert batch["weights"].max() <= 1.0 + 1e-6
    assert (batch["weights"][batch["x"] == 7].mean()
            < batch["weights"][batch["x"] != 7].mean())


# ------------------------------------------------------- the env mirror


def test_torch_env_mirror_matches_jax_and_gym_bit_for_bit():
    """3 episodes of random actions, 4 sub-envs on staggered clocks:
    ``torch_step``/``torch_reset`` against ``jax_step``/``jax_reset`` and
    against the gym env (sub-env 0), obs, rewards, truncations and step
    counters bit for bit."""
    import gymnasium as gym

    from ray_tpu.rllib.env import synthetic_atari as jsa

    from ray_tpu_torch.rllib.env import synthetic_atari as sa

    episode_len = 7
    frames_np = sa.frame_bank(0)
    np.testing.assert_array_equal(frames_np, jsa.frame_bank(0))
    frames = torch.from_numpy(frames_np)
    env = gym.make("SyntheticAtari-v0", episode_len=episode_len)
    gobs, _ = env.reset(seed=0)
    t = torch.tensor([0, 2, 4, 6], dtype=torch.int32)
    jt = jnp.asarray(t.numpy())
    rng = np.random.default_rng(3)
    for i in range(3 * episode_len):
        a = rng.integers(0, 6, 4).astype(np.int32)
        t1, obs, rew, trunc = sa.torch_step(frames, episode_len, t,
                                            torch.from_numpy(a))
        jt1, jobs, jrew, jtrunc = jsa.jax_step(jnp.asarray(frames_np),
                                               episode_len, jt,
                                               jnp.asarray(a))
        assert obs.dtype == torch.uint8 and rew.dtype == torch.float32
        np.testing.assert_array_equal(obs.numpy(), np.asarray(jobs))
        np.testing.assert_array_equal(rew.numpy(), np.asarray(jrew))
        np.testing.assert_array_equal(trunc.numpy(), np.asarray(jtrunc))
        g_obs, g_rew, _, g_trunc, _ = env.step(int(a[0]))
        np.testing.assert_array_equal(obs[0].numpy(), g_obs)
        assert float(rew[0]) == g_rew and bool(trunc[0]) == g_trunc
        t, obs = sa.torch_reset(frames, t1, obs, trunc)
        jt, jobs = jsa.jax_reset(jnp.asarray(frames_np), jt1, jobs, jtrunc)
        np.testing.assert_array_equal(t.numpy(), np.asarray(jt))
        np.testing.assert_array_equal(obs.numpy(), np.asarray(jobs))
        if g_trunc:
            g_obs, _ = env.reset()
            assert int(t[0]) == 0
            np.testing.assert_array_equal(obs[0].numpy(), g_obs)


# ----------------------------------------------------------- device rule


def test_every_entry_point_raises_without_a_card():
    """No card here: each role built with no device raises, naming the
    CPU as the way to ask for it; none carries on on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present; the rule is for a machine without")
    from ray_tpu_torch.rllib import (AnakinTrainer, Learner, PPO,
                                     MultiAgentEnvRunner, PPOConfig,
                                     SingleAgentEnvRunner)
    from ray_tpu_torch.rllib.env.multi_agent_env import TargetMatchEnv

    spec = RLModuleSpec(obs_dim=4, num_actions=2)
    makers = [
        lambda: Learner(spec, PPO.loss_fn),
        lambda: SingleAgentEnvRunner("CartPole-v1", spec, num_envs=1),
        lambda: MultiAgentEnvRunner(
            lambda: TargetMatchEnv(), {"p0": RLModuleSpec(4, 4)},
            lambda aid: "p0", num_envs=1),
        lambda: AnakinTrainer(num_envs=2, rollout=2),
        lambda: RLModule(spec).init_params(0),
        lambda: PPOConfig().environment("CartPole-v1").build(),
        lambda: PPOConfig().environment("CartPole-v1").env_runners(
            device="cpu").build(),
    ]
    for make in makers:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make()
