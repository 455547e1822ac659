"""The port's Podracer topologies (``ray_tpu_torch.rllib.podracer``) on the
CPU, the twins of ``tests/test_rllib_podracer.py`` and of
``tests/test_elastic.py``'s Sebulba cases, plus Anakin against JAX:

  * Anakin's loss and grads on one recorded trajectory (the port's own
    rollout on the CPU) against a JAX computation of the same formula
    (``ray_tpu/rllib/podracer.py:1187-1208``) on the same params,
    converted, within ``LOSS_TOL``/``GRAD_TOL``, and one ``learn`` step
    against ``optax.chain(clip_by_global_norm, adam)`` on JAX's grads
    within ``PARAM_TOL``; the rollout's env steps replayed through the
    tensor mirror give its obs, rewards and truncations bit for bit;
  * Sebulba's learner parity with the dynamic loop (same seeds,
    ``broadcast_interval=1``), zero control-plane RPCs in steady
    iterations (``perf``), teardown returning every pin, a runner's death
    surfacing cleanly, the elastic heal after a runner's death, a
    learner's death terminal, and the knobs refusing zeros. The
    multi-learner cases keep JAX's ``slow`` mark.

Every role runs with ``device="cpu"`` (the config's ``env_runner_device``
and ``learner_device``); the card runs Anakin in ``chip_smoke.py``.
"""

import os
import sys
import time

import cloudpickle
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ray_tpu_torch as rt
from ray_tpu_torch._private import convert
from ray_tpu_torch._private.exceptions import (ActorDiedError,
                                               ChannelClosedError)
from tests.test_torch_runtime_cluster import \
    retire_leftover_jax_runtime_for_later_files

os.environ.setdefault("RAY_TPU_TORCH_LOG_LEVEL", "WARNING")
cloudpickle.register_pickle_by_value(sys.modules[__name__])

CPU = "cpu"
LOSS_TOL = dict(atol=1e-5, rtol=1e-5)
GRAD_TOL = dict(atol=1e-5, rtol=1e-4)
CONV_TOL = dict(atol=1e-4, rtol=1e-4)
PARAM_TOL = dict(atol=1e-6, rtol=1e-5)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Small tensors: one intra-op thread (see test_torch_rllib_core)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", autouse=True)
def _no_leftover_jax_runtime():
    yield
    retire_leftover_jax_runtime_for_later_files()


@pytest.fixture(scope="module")
def cluster():
    rt.init(num_cpus=16, num_gpus=0, object_store_memory=256 * 1024 * 1024)
    yield
    rt.shutdown()


def _ppo_cfg(topology, runners, seed=0):
    from ray_tpu_torch.rllib import PPOConfig

    return (PPOConfig()
            .environment("CartPole-v1")
            .env_runners(num_env_runners=runners,
                         num_envs_per_env_runner=4,
                         rollout_fragment_length=32, device=CPU)
            .training(num_epochs=2, minibatch_size=64, entropy_coeff=0.01)
            .learners(topology=topology, device=CPU)
            .debugging(seed=seed))


def _impala_cfg(topology, runners, seed=0, interval=1, rollout=16):
    from ray_tpu_torch.rllib import IMPALAConfig

    return (IMPALAConfig()
            .environment("CartPole-v1")
            .env_runners(num_env_runners=runners,
                         num_envs_per_env_runner=4,
                         rollout_fragment_length=rollout, device=CPU)
            .training(num_batches_per_iteration=1,
                      broadcast_interval=interval)
            .learners(topology=topology, device=CPU)
            .debugging(seed=seed))


def _store_pins(core):
    stats = core._run(core.clients.get(core.supervisor_addr).call(
        "store_stats"))
    return stats["pins_total"]


# ----------------------------------------------------------------- Anakin


ANAKIN = {
    "conv": dict(shape=(20, 20, 4), spec=dict(
        obs_dim=1600, num_actions=6, hiddens=(32,), obs_shape=(20, 20, 4),
        conv_filters=((8, 4, 2), (16, 3, 1)))),
    "mlp": dict(shape=(4, 4, 1), spec=dict(obs_dim=16, num_actions=6,
                                           hiddens=(16,))),
}


def _anakin(kind, seed=0, **kw):
    from ray_tpu_torch.rllib import AnakinTrainer, RLModuleSpec
    from ray_tpu_torch.rllib.env import synthetic_atari as sa

    frames = sa.frame_bank(0, shape=ANAKIN[kind]["shape"])
    return AnakinTrainer(num_envs=4, rollout=8, episode_len=5,
                         frames=frames,
                         module_spec=RLModuleSpec(**ANAKIN[kind]["spec"]),
                         seed=seed, device=CPU, **kw)


def _jax_anakin_loss(jm, conv, uint8, rollout, num_envs, gamma=0.99,
                     vf_loss_coeff=0.5, entropy_coeff=0.01):
    """The loss of ``ray_tpu/rllib/podracer.py::AnakinTrainer`` (its inner
    ``loss_fn``, :1187-1208) over a recorded trajectory."""
    from ray_tpu.rllib.utils.advantages import vtrace_returns

    def prep(obs):
        if conv:
            return obs
        x = obs.reshape(obs.shape[0], -1).astype(jnp.float32)
        return x / 255.0 if uint8 else x

    def loss_fn(p, obs_seq, actions, logp_b, rewards, truncs, obs1):
        N = rollout * num_envs
        flat = prep(obs_seq.reshape((N,) + obs_seq.shape[2:]))
        logits, values = jm.forward_train(p, flat)
        logp_all = jax.nn.log_softmax(logits)
        tlogp = jnp.take_along_axis(
            logp_all, actions.reshape(N)[:, None], axis=-1)[:, 0]
        tm = lambda x: x.reshape(rollout, num_envs)  # noqa: E731
        _, boot = jm.forward_train(p, prep(obs1))
        vs, pg_adv = vtrace_returns(
            logp_b, tm(tlogp), rewards, tm(values), boot,
            jnp.zeros_like(truncs), truncs, gamma=gamma)
        vs = jax.lax.stop_gradient(vs)
        pg_adv = jax.lax.stop_gradient(pg_adv)
        pi_loss = -jnp.mean(tm(tlogp) * pg_adv)
        vf_loss = 0.5 * jnp.mean((tm(values) - vs) ** 2)
        probs = jax.nn.softmax(logits)
        entropy = -jnp.mean(jnp.sum(probs * logp_all, axis=-1))
        total = (pi_loss + vf_loss_coeff * vf_loss
                 - entropy_coeff * entropy)
        return total, {"policy_loss": pi_loss, "vf_loss": vf_loss,
                       "entropy": entropy}

    return loss_fn


@pytest.mark.parametrize("kind", ["conv", "mlp"])
def test_anakin_loss_grads_and_step_match_jax(kind):
    import optax

    from ray_tpu.rllib.core.rl_module import RLModule as JModule
    from ray_tpu.rllib.core.rl_module import RLModuleSpec as JSpec

    from ray_tpu_torch.models.transformer import _leaves, map_params
    from ray_tpu_torch.rllib.core.learner import params_from_numpy
    from ray_tpu_torch.rllib.env import synthetic_atari as sa

    jm = JModule(JSpec(**ANAKIN[kind]["spec"]))
    jp = jax.tree.map(np.asarray,
                      jax.jit(jm.init_params)(jax.random.PRNGKey(4)))
    tr = _anakin(kind)
    tr.params = params_from_numpy(convert.rl_params_from_jax(jp), tr.device,
                                  True)
    tr.opt_state = tr._opt.init(tr.params)
    tr.collect()  # past the first episode end: truncations in the next
    t, obs = tr._t.clone(), tr._obs.clone()
    traj = tr.collect()
    assert bool(traj["truncs"].any())
    # the rollout's env steps, replayed through the mirror from its start
    frames = torch.from_numpy(sa.frame_bank(0, shape=ANAKIN[kind]["shape"]))
    for i in range(8):
        np.testing.assert_array_equal(obs.numpy(), traj["obs"][i].numpy())
        t, o1, r, tc = sa.torch_step(frames, 5, t, traj["actions"][i])
        np.testing.assert_array_equal(r.numpy(), traj["rewards"][i].numpy())
        np.testing.assert_array_equal(tc.numpy(), traj["truncs"][i].numpy())
        t, obs = sa.torch_reset(frames, t, o1, tc)
    np.testing.assert_array_equal(obs.numpy(), traj["last_obs"].numpy())
    loss, met = tr.loss(tr.params, traj)
    grads = torch.autograd.grad(loss, _leaves(tr.params))
    np_traj = {k: v.numpy() for k, v in traj.items()}
    jloss_fn = _jax_anakin_loss(jm, kind == "conv", True, 8, 4)
    args = (np_traj["obs"], np_traj["actions"].astype(np.int32),
            np_traj["logp"], np_traj["rewards"], np_traj["truncs"],
            np_traj["last_obs"])
    (jloss, jmet), jgrads = jax.jit(jax.value_and_grad(
        jloss_fn, has_aux=True))(jax.tree.map(jnp.asarray, jp), *args)
    tol = CONV_TOL if kind == "conv" else LOSS_TOL
    np.testing.assert_allclose(float(loss.detach()), float(jloss), **tol)
    for k in jmet:
        np.testing.assert_allclose(float(met[k].detach()), float(jmet[k]),
                                   **tol, err_msg=k)
    it = iter(grads)
    got = jax.tree.leaves(convert.rl_params_to_jax(
        map_params(lambda _p, _t: next(it), tr.params)))
    for g, w in zip(got, jax.tree.leaves(jgrads)):
        np.testing.assert_allclose(g, np.asarray(w),
                                   **(CONV_TOL if kind == "conv"
                                      else GRAD_TOL))
    # one learn step against optax on JAX's grads
    tx = optax.chain(optax.clip_by_global_norm(0.5), optax.adam(3e-4))
    jparams = jax.tree.map(jnp.asarray, jp)

    @jax.jit
    def step(p, g):
        upd, _ = tx.update(g, tx.init(p), p)
        return optax.apply_updates(p, upd)

    want = jax.tree.leaves(step(jparams, jgrads))
    tr.learn(traj)
    got = jax.tree.leaves(convert.rl_params_to_jax(tr.params))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, np.asarray(w), **PARAM_TOL)


def test_anakin_env_mirror_matches_gym_env():
    """Twin of JAX's ``test_jax_env_matches_gym_env``: the tensor step is
    the gym env, step for step, over three episodes."""
    import gymnasium as gym

    from ray_tpu_torch.rllib.env import synthetic_atari as sa

    episode_len = 7
    env = gym.make("SyntheticAtari-v0", episode_len=episode_len)
    env.reset(seed=0)
    frames = torch.from_numpy(sa.frame_bank(0))
    t = torch.zeros(1, dtype=torch.int32)
    rng = np.random.default_rng(3)
    for i in range(3 * episode_len):
        a = int(rng.integers(0, 6))
        gobs, grew, _, gtrunc, _ = env.step(a)
        t1, obs, rew, trunc = sa.torch_step(
            frames, episode_len, t, torch.tensor([a], dtype=torch.int32))
        assert np.array_equal(obs[0].numpy(), gobs), i
        assert float(rew[0]) == grew, i
        assert bool(trunc[0]) == gtrunc, i
        t, _obs = sa.torch_reset(frames, t1, obs, trunc)
        if gtrunc:
            gobs, _ = env.reset()
            assert int(t[0]) == 0
            np.testing.assert_array_equal(frames[0].numpy(), gobs)


def test_anakin_trains_and_counts():
    trainer = _anakin("mlp")
    out = trainer.train(5)
    assert np.isfinite(out["total_loss"])
    assert out["env_steps"] == 5 * 8 * 4
    assert out["env_steps_per_sec"] > 0
    out2 = trainer.train(5)
    assert out2["num_env_steps_sampled_lifetime"] == 10 * 8 * 4
    assert {"policy_loss", "vf_loss", "entropy",
            "reward_mean"} <= set(out2)
    assert str(trainer._obs.device) == "cpu"


def test_anakin_deterministic_given_seed():
    a = _anakin("mlp", seed=7).train(3)
    b = _anakin("mlp", seed=7).train(3)
    assert a["total_loss"] == b["total_loss"]


def test_anakin_rejects_zero_knobs():
    from ray_tpu_torch.rllib import AnakinTrainer

    with pytest.raises(ValueError, match="num_envs"):
        AnakinTrainer(num_envs=0, device=CPU)
    with pytest.raises(ValueError, match="rollout"):
        AnakinTrainer(num_envs=2, rollout=0, device=CPU)


# ----------------------------------------------------------------- parity


class TestSebulbaParity:
    def test_ppo_matches_dynamic_loop(self, cluster):
        dyn = _ppo_cfg("dynamic", 0).build()
        try:
            ref = [dyn.train() for _ in range(3)]
        finally:
            dyn.stop()
        seb = _ppo_cfg("sebulba", 1).build()
        try:
            assert seb._podracer.is_channel_backed
            got = [seb.train() for _ in range(3)]
        finally:
            seb.stop()
        for a, b in zip(ref, got):
            for k in ("total_loss", "policy_loss", "vf_loss", "kl_coeff"):
                assert abs(a[k] - b[k]) < 1e-5, (k, a[k], b[k])

    def test_impala_matches_dynamic_loop(self, cluster):
        dyn = _impala_cfg("dynamic", 0).build()
        try:
            ref = [dyn.train()["total_loss"] for _ in range(4)]
        finally:
            dyn.stop()
        seb = _impala_cfg("sebulba", 1).build()
        try:
            got = [seb.train()["total_loss"] for _ in range(4)]
        finally:
            seb.stop()
        assert np.allclose(ref, got, atol=1e-5), (ref, got)


# -------------------------------------------------------------- contracts


class TestSebulbaContracts:
    @pytest.mark.perf
    def test_steady_iteration_is_zero_control_rpcs(self, cluster):
        from ray_tpu_torch._private.rpc import _m_client_calls

        seb = _impala_cfg("sebulba", 2).build()
        try:
            topo = seb._podracer
            assert topo.is_channel_backed
            assert topo.channel_depth >= 1
            seb.train()
            seb.train()
            driver_before = _m_client_calls.total()
            for _ in range(3):
                out = seb.train()
                for rep in out["reports"]:
                    assert rep["rpc_calls"] == 0, rep
                    assert rep["runner_rpc_calls"] == 0, rep
            assert _m_client_calls.total() == driver_before
            assert out["num_env_steps_sampled_lifetime"] == 5 * 2 * 16 * 4
            assert out["reports"][0]["iterations_total"] >= 5
        finally:
            seb.stop()

    @pytest.mark.slow
    def test_multi_learner_offpolicy_trains(self, cluster):
        cfg = _impala_cfg("sebulba", 2, interval=2).learners(
            topology="sebulba", num_learners=2, podracer_channel_depth=3)
        seb = cfg.build()
        try:
            assert seb._podracer.channel_depth == 3
            losses = [seb.train()["total_loss"] for _ in range(4)]
            assert all(np.isfinite(x) for x in losses)
        finally:
            seb.stop()

    @pytest.mark.slow
    def test_ppo_multi_learner_kl_stays_synced(self, cluster):
        cfg = _ppo_cfg("sebulba", 2).learners(topology="sebulba",
                                              num_learners=2)
        seb = cfg.build()
        try:
            for _ in range(3):
                out = seb.train()
                coeffs = {rep["metrics"]["kl_coeff"]
                          for rep in out["reports"]}
                assert len(coeffs) == 1, coeffs
        finally:
            seb.stop()

    def test_teardown_releases_pins_and_channels(self, cluster):
        import gc

        from ray_tpu_torch._private import api

        core = api._core
        gc.collect()
        time.sleep(0.3)
        pins_before = _store_pins(core)
        seb = _impala_cfg("sebulba", 1).build()
        seb.train()
        assert _store_pins(core) > pins_before
        seb.stop()
        deadline = time.monotonic() + 20
        while time.monotonic() < deadline:
            if _store_pins(core) == pins_before:
                break
            time.sleep(0.2)
        assert _store_pins(core) == pins_before, "sebulba leaked pins"
        with pytest.raises(ChannelClosedError):
            seb.train()

    def test_runner_death_surfaces_cleanly(self, cluster):
        seb = _impala_cfg("sebulba", 1).build()
        try:
            seb.train()
            rt.kill(seb._podracer._runners[0])
            with pytest.raises((ChannelClosedError, ActorDiedError)):
                deadline = time.monotonic() + 30
                while time.monotonic() < deadline:
                    seb.train()
        finally:
            seb.stop()

    def test_num_batches_per_iteration_honored(self, cluster):
        seb = _impala_cfg("sebulba", 1, rollout=8).training(
            num_batches_per_iteration=3).build()
        try:
            out = seb.train()
            assert out["num_env_steps_sampled_lifetime"] == 3 * 8 * 4
            assert len(out["reports"]) == 3
        finally:
            seb.stop()

    def test_checkpoint_and_evaluate_raise_cleanly(self, cluster):
        seb = _impala_cfg("sebulba", 1).build()
        try:
            with pytest.raises(RuntimeError, match="sebulba"):
                seb.get_state()
            with pytest.raises(NotImplementedError):
                seb.evaluate()
        finally:
            seb.stop()


class TestSebulbaElastic:
    """Twins of ``tests/test_elastic.py``'s Sebulba cases."""

    def test_runner_respawns_and_rejoins(self, cluster):
        from ray_tpu_torch._private import api
        from ray_tpu_torch._private.elastic import m_joins, m_rejoin_seconds

        core = api._require_core()
        pins0 = _store_pins(core)
        joins0, rejoins0 = m_joins.total(), m_rejoin_seconds.count_total()
        cfg = _impala_cfg("sebulba", 2).learners(topology="sebulba",
                                                 elastic=True, device=CPU)
        algo = cfg.build()
        topo = algo._podracer
        try:
            r1 = algo.train()
            assert np.isfinite(r1["total_loss"])
            rt.kill(topo._runners[1])
            deadline = time.monotonic() + 30
            while not topo._heal_pending and time.monotonic() < deadline:
                time.sleep(0.05)
            assert topo._heal_pending
            r2 = algo.train()
            r3 = algo.train()
            assert topo._epoch == 1
            assert np.isfinite(r2["total_loss"])
            assert np.isfinite(r3["total_loss"])
        finally:
            algo.stop()
        assert m_joins.total() >= joins0 + 1
        assert m_rejoin_seconds.count_total() >= rejoins0 + 1
        deadline = time.monotonic() + 30
        while _store_pins(core) != pins0 and time.monotonic() < deadline:
            time.sleep(0.1)
        assert _store_pins(core) == pins0

    def test_learner_death_is_terminal(self, cluster):
        cfg = _impala_cfg("sebulba", 1).learners(topology="sebulba",
                                                 elastic=True, device=CPU)
        algo = cfg.build()
        topo = algo._podracer
        try:
            algo.train()
            rt.kill(topo._learners[0])
            deadline = time.monotonic() + 30
            while not topo._heal_pending and time.monotonic() < deadline:
                time.sleep(0.05)
            with pytest.raises(Exception, match="learner|dead|closed"):
                for _ in range(3):
                    algo.train()
        finally:
            algo.stop()


# ------------------------------------------------------------------ knobs


class TestPodracerKnobs:
    def test_config_rejects_zero_depth(self):
        from ray_tpu_torch.rllib import PPOConfig

        with pytest.raises(ValueError, match="podracer_channel_depth"):
            PPOConfig().learners(topology="sebulba",
                                 podracer_channel_depth=0)

    def test_unknown_topology_rejected(self):
        from ray_tpu_torch.rllib import PPOConfig

        with pytest.raises(ValueError, match="topology"):
            PPOConfig().learners(topology="anakin-but-typod")

    def test_env_knob_zero_rejected(self, cluster):
        from ray_tpu_torch._private import api

        core = api._core
        old = core.config.podracer_channel_depth
        core.config.podracer_channel_depth = 0
        try:
            with pytest.raises(ValueError, match="podracer_channel_depth"):
                _impala_cfg("sebulba", 1).build()
        finally:
            core.config.podracer_channel_depth = old

    def test_require_positive_contract(self):
        from ray_tpu_torch.rllib.podracer import require_positive

        assert require_positive("x", 3) == 3
        assert require_positive("x", 1.5, kind=float) == 1.5
        for bad in (0, -1, None):
            with pytest.raises(ValueError):
                require_positive("x", bad)

    def test_sebulba_requires_runner_actors(self, cluster):
        with pytest.raises(ValueError, match="num_env_runners"):
            _impala_cfg("sebulba", 0).build()

    def test_runner_count_must_divide_learners(self, cluster):
        with pytest.raises(ValueError, match="divide"):
            _impala_cfg("sebulba", 3).learners(
                topology="sebulba", num_learners=2).build()

    def test_card_roles_ask_for_a_card(self):
        """A role on the card asks the runtime for a whole card; a CPU
        role keeps JAX's one CPU."""
        from ray_tpu_torch.rllib.core.learner import (actor_device,
                                                      actor_options)

        assert actor_options(None) == {"num_gpus": 1}
        assert actor_options("cuda:0") == {"num_gpus": 1}
        assert actor_options(CPU) == {"num_cpus": 1}
        assert actor_device("cuda") is None and actor_device(CPU) == CPU
