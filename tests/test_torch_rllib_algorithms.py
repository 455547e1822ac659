"""The port's RLlib algorithms, env runners and drivers on the CPU
(``device="cpu"`` for every role), against the JAX package:

  * on weights converted from JAX, ``SingleAgentEnvRunner.sample(
    greedy=True)`` and ``Algorithm.evaluate()`` on CartPole give JAX's
    obs, actions, rewards, episode ends and returns exactly, and an
    eps-greedy sample takes JAX's numpy-drawn random actions;
  * PPO's and IMPALA's learner side of one ``training_step``, fed JAX's
    own recorded rollout from JAX's initial learner state, gives JAX's
    metrics (``METRIC_TOL``) and weights (``WEIGHT_TOL``: a few Adam steps
    magnify the gradients' last bits where the moments are small);
  * the twins of JAX's behaviour tests (``tests/test_rllib.py``,
    ``test_rllib_multiagent.py``, ``test_rllib_eval_cql.py``' evaluation
    cases): PPO solves CartPole, IMPALA, APPO and DQN learn, async IMPALA
    over runner actors, multi-agent PPO reaches 28, checkpoints round
    trip, Tune runs ``to_trainable``, learner actors at world 2 agree bit
    for bit, config validation.

Sampling draws from torch generators, another stream than JAX's keys, so
no test here compares sampled actions across frameworks; parity goes
through greedy rollouts and recorded batches.
"""

import os
import sys

import cloudpickle
import jax
import numpy as np
import pytest
import torch

import ray_tpu_torch as rt
from ray_tpu_torch._private import convert
from tests.test_torch_runtime_cluster import \
    retire_leftover_jax_runtime_for_later_files

os.environ.setdefault("RAY_TPU_TORCH_LOG_LEVEL", "WARNING")
# lambdas and configs ship by value: a worker never imports this module,
# and with it JAX
cloudpickle.register_pickle_by_value(sys.modules[__name__])

METRIC_TOL = dict(atol=2e-5, rtol=2e-4)
WEIGHT_TOL = dict(atol=2e-5, rtol=2e-4)
CPU = "cpu"


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The CPU's intra-op pool costs more than it saves at these sizes
    (a [8, 2] ``log_softmax`` takes about 250x longer on 8 threads than
    on 1), so the file runs on one thread and gives the rest back."""
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


def _on_cpu(cfg):
    return cfg.env_runners(device=CPU).learners(device=CPU)


def _close_tree(port_tree, jax_tree, tol, what=""):
    got = jax.tree.leaves(convert.rl_params_to_jax(port_tree))
    want = jax.tree.leaves(jax.tree.map(np.asarray, jax_tree))
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_allclose(g, w, **tol, err_msg=f"{what} leaf {i}")


def _port_weights(jax_weights):
    return convert.rl_params_from_jax(jax.tree.map(np.asarray, jax_weights))


# -------------------------------------------------- greedy rollouts, eval


def test_greedy_sample_equals_jax_exactly():
    from ray_tpu.rllib.core.rl_module import RLModuleSpec as JSpec
    from ray_tpu.rllib.env.single_agent_env_runner import \
        SingleAgentEnvRunner as JRunner

    from ray_tpu_torch.rllib import RLModuleSpec, SingleAgentEnvRunner

    kw = dict(obs_dim=4, num_actions=2, hiddens=(32, 32))
    jr = JRunner("CartPole-v1", JSpec(**kw), num_envs=4, seed=3)
    pr = SingleAgentEnvRunner("CartPole-v1", RLModuleSpec(**kw), num_envs=4,
                              seed=3, device=CPU)
    # weights that act: a policy head scaled up from JAX's 0.01 init
    w = jax.tree.map(np.asarray, jr.params)
    w["pi"]["w"] = w["pi"]["w"] * 300.0
    jr.set_weights(w)
    pr.set_weights(_port_weights(w))
    for _ in range(3):
        jb = jr.sample(64, greedy=True)
        pb = pr.sample(64, greedy=True)
        assert set(pb) == set(jb)
        for k in ("obs", "actions", "rewards", "terminateds",
                  "truncateds", "next_obs"):
            assert pb[k].dtype == jb[k].dtype, k
            np.testing.assert_array_equal(pb[k], jb[k], err_msg=k)
        np.testing.assert_allclose(pb["bootstrap_value"],
                                   jb["bootstrap_value"], atol=1e-5,
                                   rtol=1e-5)
    jm, pm = jr.get_metrics(), pr.get_metrics()
    assert jm["num_episodes"] > 0
    assert pm == jm
    # eps-greedy: the random actions are JAX's host numpy draws
    np.random.seed(11)
    jb = jr.sample(32, epsilon=0.5, greedy=True)
    np.random.seed(11)
    pb = pr.sample(32, epsilon=0.5, greedy=True)
    np.testing.assert_array_equal(pb["actions"], jb["actions"])
    np.testing.assert_array_equal(pb["obs"], jb["obs"])
    pr.stop()
    jr.stop()


def _eval_cfgs():
    from ray_tpu.rllib.algorithms.ppo import PPOConfig as JPPOConfig

    from ray_tpu_torch.rllib import PPOConfig

    def make(cls):
        return (cls().environment(env="CartPole-v1")
                .env_runners(num_envs_per_env_runner=2,
                             rollout_fragment_length=32)
                .training(train_batch_size=64, num_epochs=1,
                          model={"hiddens": (16,)})
                .evaluation(evaluation_interval=2, evaluation_duration=3)
                .debugging(seed=0))

    return make(JPPOConfig), _on_cpu(make(PPOConfig))


def test_evaluate_equals_jax_exactly():
    """``Algorithm.evaluate()`` (greedy, its own eval runners) on JAX's
    weights, converted: the same episodes, steps and returns."""
    jcfg, pcfg = _eval_cfgs()
    jalgo, palgo = jcfg.build(), pcfg.build()
    try:
        w = jax.tree.map(np.asarray, jalgo.learner_group.get_weights())
        w["pi"]["w"] = w["pi"]["w"] * 300.0
        jalgo.learner_group._local.set_weights(w)
        palgo.learner_group._local.set_weights(_port_weights(w))
        je, pe = jalgo.evaluate(), palgo.evaluate()
        assert je["evaluation"]["num_episodes"] >= 3
        assert pe == je
    finally:
        jalgo.stop()
        palgo.stop()


# --------------------------------------- the learner side of training_step


def _record(runner_group):
    """Replace a runner group's ``sample`` with one that records what the
    real one returns."""
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


def _from_jax_start(jalgo, palgo):
    state = convert.rl_learner_state_from_jax(
        jalgo.learner_group.get_state())
    palgo.learner_group.set_state(state)


@pytest.mark.parametrize("algo", ["ppo", "impala"])
def test_training_step_on_jax_rollout_matches_jax(algo):
    from ray_tpu.rllib import IMPALAConfig as JIMPALAConfig
    from ray_tpu.rllib import PPOConfig as JPPOConfig

    from ray_tpu_torch.rllib import IMPALAConfig, PPOConfig

    def make(ppo, impala):
        if algo == "ppo":
            return (ppo().environment("CartPole-v1")
                    .env_runners(num_envs_per_env_runner=4,
                                 rollout_fragment_length=32)
                    .training(num_epochs=2, minibatch_size=64,
                              entropy_coeff=0.01)
                    .debugging(seed=0))
        return (impala().environment("CartPole-v1")
                .env_runners(num_envs_per_env_runner=4,
                             rollout_fragment_length=16)
                .training(num_batches_per_iteration=3)
                .debugging(seed=0))

    jalgo = make(JPPOConfig, JIMPALAConfig).build()
    palgo = _on_cpu(make(PPOConfig, IMPALAConfig)).build()
    try:
        _from_jax_start(jalgo, palgo)
        calls = _record(jalgo.env_runner_group)
        _replay(palgo.env_runner_group, calls)
        for _ in range(2):
            jm = jalgo.training_step()
            pm = palgo.training_step()
            assert set(pm) == set(jm)
            for k in pm:
                np.testing.assert_allclose(pm[k], jm[k], **METRIC_TOL,
                                           err_msg=k)
        _close_tree(palgo.learner_group.get_weights(),
                    jalgo.learner_group.get_weights(), WEIGHT_TOL, algo)
        assert (palgo._total_env_steps == jalgo._total_env_steps > 0)
    finally:
        jalgo.stop()
        palgo.stop()


# ------------------------------------------------------- behaviour twins


def _ppo_config(**training):
    from ray_tpu_torch.rllib import PPOConfig

    kw = dict(num_epochs=8, minibatch_size=256, lr=3e-4,
              entropy_coeff=0.01)
    kw.update(training)
    return _on_cpu(PPOConfig()
                   .environment("CartPole-v1")
                   .env_runners(num_env_runners=0,
                                num_envs_per_env_runner=8,
                                rollout_fragment_length=128)
                   .training(**kw)
                   .debugging(seed=0))


def _best(algo, iters, bar):
    best = 0.0
    r = {}
    for _ in range(iters):
        r = algo.train()
        ret = r.get("episode_return_mean")
        if ret is not None:
            best = max(best, ret)
        if best >= bar:
            break
    return best, r


def test_ppo_solves_cartpole():
    """Twin of JAX's bar: reward >= 450, local mode."""
    algo = _ppo_config().build()
    try:
        best, _ = _best(algo, 120, 450)
        assert best >= 450, f"best return {best}"
        assert str(algo.learner_group._local.device) == "cpu"
    finally:
        algo.stop()


def test_ppo_checkpoint_roundtrip(tmp_path):
    from ray_tpu_torch.rllib import PPO

    algo = _ppo_config(num_epochs=1).build()
    try:
        algo.train()
        ckpt = algo.save_to_checkpoint(str(tmp_path / "ck"))
        w0 = algo.learner_group.get_weights()
        s0 = algo.learner_group.get_state()
        it0 = algo.iteration
    finally:
        algo.stop()
    algo2 = PPO.from_checkpoint(ckpt)
    try:
        assert algo2.iteration == it0
        assert algo2.config.learner_device == CPU
        for a, b in zip(jax.tree.leaves(w0),
                        jax.tree.leaves(algo2.learner_group.get_weights())):
            np.testing.assert_array_equal(a, b)
        s1 = algo2.learner_group.get_state()
        assert s1["opt_state"]["count"] == s0["opt_state"]["count"] > 0
        for a, b in zip(jax.tree.leaves(s0), jax.tree.leaves(s1)):
            np.testing.assert_array_equal(a, b)
        algo2.train()
    finally:
        algo2.stop()


def _impala_like(cls):
    return _on_cpu(cls()
                   .environment("CartPole-v1")
                   .env_runners(num_env_runners=0,
                                num_envs_per_env_runner=8,
                                rollout_fragment_length=64)
                   .training(num_batches_per_iteration=8,
                             entropy_coeff=0.005)
                   .debugging(seed=0))


def test_impala_learns_cartpole_local():
    from ray_tpu_torch.rllib import IMPALAConfig

    algo = _impala_like(IMPALAConfig).build()
    try:
        best, _ = _best(algo, 60, 150)
        assert best >= 150, f"best return {best}"
    finally:
        algo.stop()


def test_appo_learns_cartpole_local():
    from ray_tpu_torch.rllib import APPOConfig

    algo = _impala_like(APPOConfig).build()
    try:
        best, r = _best(algo, 60, 150)
        assert best >= 150, f"best return {best}"
        assert "mean_kl" in r
    finally:
        algo.stop()


def test_dqn_learns_cartpole():
    from ray_tpu_torch.rllib import DQNConfig

    algo = _on_cpu(DQNConfig()
                   .environment("CartPole-v1")
                   .env_runners(num_env_runners=0,
                                num_envs_per_env_runner=4,
                                rollout_fragment_length=16)
                   .training(prioritized_replay=True)
                   .debugging(seed=0)).build()
    try:
        best, _ = _best(algo, 250, 130)
        assert best >= 130, f"best return {best}"
    finally:
        algo.stop()


def test_impala_async_over_runner_actors(cluster):
    from ray_tpu_torch.rllib import IMPALAConfig

    algo = _on_cpu(IMPALAConfig()
                   .environment("CartPole-v1")
                   .env_runners(num_env_runners=2,
                                num_envs_per_env_runner=2,
                                rollout_fragment_length=16)
                   .training(num_batches_per_iteration=4)
                   .debugging(seed=0)).build()
    try:
        r1 = algo.train()
        r2 = algo.train()
        assert r2["num_env_steps_sampled_lifetime"] > \
            r1["num_env_steps_sampled_lifetime"] > 0
        assert np.isfinite(r2["policy_loss"])
        assert len(algo._inflight) >= 2
    finally:
        algo.stop()


def test_learner_actors_at_world_two_agree(cluster):
    """Two learner actors over the host group: each takes half of every
    batch, the averaged grads make their params equal bit for bit, and
    they match one local learner on the whole batch."""
    from ray_tpu_torch.rllib import PPO, LearnerGroup, RLModuleSpec

    spec = RLModuleSpec(obs_dim=4, num_actions=2, hiddens=(16,))
    group = LearnerGroup(spec, PPO.loss_fn, {"lr": 1e-2}, num_learners=2,
                         device=CPU)
    try:
        rng = np.random.default_rng(0)
        cfg = {"clip_param": 0.2, "vf_clip_param": 10.0,
               "vf_loss_coeff": 0.5, "entropy_coeff": 0.01}
        for i in range(3):
            n = 32
            batch = {
                "obs": rng.normal(size=(n, 4)).astype(np.float32),
                "actions": rng.integers(0, 2, n),
                "logp": np.full(n, -0.7, np.float32),
                "values": rng.normal(size=n).astype(np.float32),
                "advantages": rng.normal(size=n).astype(np.float32),
                "value_targets": rng.normal(size=n).astype(np.float32),
                "kl_coeff": np.full(n, 0.2, np.float32),
            }
            m = group.update_from_batch(batch, cfg)
            assert np.isfinite(m["total_loss"])
        ws = rt.get([a.get_weights.remote() for a in group._actors])
        for a, b in zip(jax.tree.leaves(ws[0]), jax.tree.leaves(ws[1])):
            np.testing.assert_array_equal(a, b)
        devs = rt.get([a.device_name.remote() for a in group._actors])
        assert devs == ["cpu", "cpu"]
    finally:
        group.shutdown()


def test_ppo_under_tuner(cluster, tmp_path):
    from ray_tpu_torch.air.config import RunConfig
    from ray_tpu_torch.tune import TuneConfig, Tuner

    trainable = _ppo_config(num_epochs=1).training(
        model={"hiddens": (16,)}).to_trainable(checkpoint_every=2)
    tuner = Tuner(
        trainable,
        tune_config=TuneConfig(metric="episode_return_mean", mode="max"),
        run_config=RunConfig(name="ppo_tune", storage_path=str(tmp_path),
                             stop={"training_iteration": 3}))
    results = tuner.fit()
    assert results.errors == []
    best = results.get_best_result()
    assert best.metrics["training_iteration"] >= 3
    assert best.checkpoint is not None


# ------------------------------------------------------------ multi-agent


def _ma_config(**training):
    from ray_tpu_torch.rllib.algorithms.ppo import PPOConfig
    from ray_tpu_torch.rllib.env.multi_agent_env import TargetMatchEnv

    spec_kw = {"obs_dim": 4, "num_actions": 4, "hiddens": (32, 32)}
    kw = dict(lr=3e-3, num_epochs=4, minibatch_size=256,
              entropy_coeff=0.01)
    kw.update(training)
    return _on_cpu(
        PPOConfig()
        .environment(env=lambda: TargetMatchEnv(
            num_agents=2, num_targets=4, episode_len=16))
        .multi_agent(
            policies={"p0": dict(spec_kw), "p1": dict(spec_kw)},
            policy_mapping_fn=lambda aid: ("p0" if aid == "agent_0"
                                           else "p1"))
        .env_runners(num_envs_per_env_runner=8, rollout_fragment_length=64)
        .training(**kw)
        .debugging(seed=0))


def test_multi_agent_ppo_reaches_28():
    """Twin of JAX's ``test_independent_policies_learn``: both policies
    learn their own mapping, total return approaching 2 x 16 = 32."""
    algo = _ma_config().build()
    try:
        best, result = _best(algo, 25, 28.0)
        assert best >= 28.0, f"multi-agent PPO failed to learn: {best}"
        assert any(k.startswith("p0/") for k in result)
        assert any(k.startswith("p1/") for k in result)
    finally:
        algo.stop()


def test_multi_agent_checkpoint_roundtrip(tmp_path):
    config = _ma_config(num_epochs=1).env_runners(
        num_envs_per_env_runner=2, rollout_fragment_length=16)
    algo = config.build()
    algo.train()
    ckpt = algo.save_to_checkpoint(str(tmp_path / "ma_ckpt"))
    state = algo.get_state()
    algo.stop()
    algo2 = config.build()
    algo2.restore_from_checkpoint(ckpt)
    s2 = algo2.get_state()
    assert s2["iteration"] == state["iteration"]
    for pid in ("p0", "p1"):
        for a, b in zip(jax.tree.leaves(state["learner"][pid]),
                        jax.tree.leaves(s2["learner"][pid])):
            np.testing.assert_array_equal(a, b)
    assert s2["extra"]["kl_coeffs"] == state["extra"]["kl_coeffs"]
    algo2.stop()


def test_multi_agent_runner_batches_and_protocol():
    """Twins of JAX's ``TestTargetMatchEnv`` and ``TestMultiAgentRunner``:
    the env protocol, the per-agent reward mapping, per-policy batches and
    an unknown policy refused."""
    from ray_tpu.rllib.env.multi_agent_env import \
        TargetMatchEnv as JTargetMatchEnv

    from ray_tpu_torch.rllib import MultiAgentEnvRunner, RLModuleSpec
    from ray_tpu_torch.rllib.env.multi_agent_env import TargetMatchEnv

    env, jenv = TargetMatchEnv(2, 4, 100), JTargetMatchEnv(2, 4, 100)
    obs, _ = env.reset(seed=1)
    jobs, _ = jenv.reset(seed=1)
    hits = {a: 0 for a in env.possible_agents}
    for _ in range(50):
        actions = {a: (int(np.argmax(obs[a])) + i) % 4
                   for i, a in enumerate(env.possible_agents)}
        obs, rew, term, trunc, _ = env.step(actions)
        jobs, jrew, jterm, _, _ = jenv.step(actions)
        assert rew == jrew and term == jterm
        for a in env.possible_agents:
            np.testing.assert_array_equal(obs[a], jobs[a])
            hits[a] += rew[a]
    assert all(h == 50 for h in hits.values()), hits

    specs = {p: RLModuleSpec(obs_dim=4, num_actions=4, hiddens=(16,))
             for p in ("p0", "p1")}
    runner = MultiAgentEnvRunner(
        lambda: TargetMatchEnv(num_agents=2, num_targets=4, episode_len=8),
        specs, lambda aid: "p0" if aid == "agent_0" else "p1",
        num_envs=3, seed=0, device=CPU)
    out = runner.sample(10)
    assert set(out) == {"p0", "p1"}
    for pid in ("p0", "p1"):
        b = out[pid]
        assert b["obs"].shape == (10, 3, 4)
        assert b["rewards"].shape == (10, 3)
        assert b["actions"].dtype == np.int64
        assert b["bootstrap_value"].shape == (3,)
    assert runner.get_metrics()["num_episodes"] >= 2
    runner.stop()
    with pytest.raises(ValueError, match="unknown"):
        MultiAgentEnvRunner(
            lambda: TargetMatchEnv(), {"p0": RLModuleSpec(4, 4)},
            lambda aid: "nope", num_envs=1, device=CPU)


# -------------------------------------------------------- config, eval


def test_config_validation():
    from ray_tpu_torch.rllib import PPOConfig

    with pytest.raises(AttributeError):
        PPOConfig().training(lr_schedule=[1, 2])
    with pytest.raises(AssertionError):
        PPOConfig().build()
    with pytest.raises(ValueError, match="duration_unit"):
        PPOConfig().evaluation(evaluation_duration_unit="hours")
    cfg = PPOConfig().env_runners(device=CPU).learners(device="cuda:0")
    assert (cfg.env_runner_device, cfg.learner_device) == (CPU, "cuda:0")
    assert PPOConfig().learner_device is None  # the card by default


def test_cnn_module_spec_inferred():
    from ray_tpu_torch.rllib.algorithms.ppo import PPOConfig

    spec = PPOConfig().environment(env="SyntheticAtari-v0").rl_module_spec()
    assert spec.obs_shape == (84, 84, 4)
    assert spec.num_actions == 6


def test_evaluate_distinct_from_training():
    """Twin of JAX's ``test_ppo_evaluate_distinct_from_training`` and
    ``test_evaluate_by_timesteps``."""
    _, pcfg = _eval_cfgs()
    algo = pcfg.build()
    try:
        r1 = algo.train()
        assert "evaluation" not in r1
        r2 = algo.train()
        ev = r2["evaluation"]
        assert ev["num_episodes"] >= 3
        assert ev["episode_return_mean"] is not None
        assert ev["num_env_steps"] > 0
        assert r2["num_env_steps_sampled_lifetime"] == 2 * 2 * 32
    finally:
        algo.stop()
    algo = pcfg.copy().evaluation(
        evaluation_duration=100,
        evaluation_duration_unit="timesteps").build()
    try:
        assert algo.evaluate()["evaluation"]["num_env_steps"] >= 100
    finally:
        algo.stop()
