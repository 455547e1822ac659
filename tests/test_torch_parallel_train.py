"""The port's mesh train step against JAX's, the twin of
``tests/test_models.py::TestShardedTraining``.

JAX runs llama_debug's ``make_train_step(cfg, tx, mesh)`` on a fsdp4 x tp2
mesh of conftest's 8 virtual CPU devices, 8 steps on JAX's batch
(``PRNGKey(1)`` tokens). The port runs the same steps in a gloo world of 8
CPU processes (which import no JAX, ``tests/torch_spmd_worlds.py``) on a
fsdp4 x tp2 ``DeviceMesh``, from JAX's initial params converted, float32.
Tolerances: ``METRIC_TOL`` and ``WEIGHT_TOL``, 2e-5 abs and 2e-4 rel, those
of the port's RL parity tests.

Two learning rates. At JAX's test's 1e-2 every loss and grad norm is held
against JAX's. The params are held at 1e-4 (losses, grad norms, final
params and both Adam moments, against JAX and against the port's meshless
step): Adam's update g/(|g| + 1e-8) turns a grad of |g| ~ 1e-8 (a dozen
of llama_debug's weights at step one) into a move that a reduction-order
difference of 1e-10 in g shifts by a percent of the learning rate, so the
elementwise drift of the params grows with the learning rate and is the
optimizer's, not the step's. ``tests/torch_parallel_drift.py`` measures
it: after the 8 steps JAX's own 8-device and one-device steps end
1.071e-04 apart at 1e-2, the port's mesh step 5.621e-04 from JAX's mesh
step at 1e-2, 2.278e-05 at 3e-4 and 7.598e-06 at 1e-4 (float32, CPU).
The part above JAX's own drift is the two frameworks' one-device steps',
not the mesh's: at 1e-2 the port's meshless step ends 3.602e-04 from
JAX's one-device step, while the port's mesh step ends 9.482e-05 from
its meshless step, as far as JAX's mesh step from JAX's one-device step;
every drift falls with the learning rate (3.602e-04, 1.460e-05 and
4.869e-06 meshless at 1e-2, 3e-4 and 1e-4). The ``w_gate``
placements are fsdp on embed and tp on mlp, as JAX's ``P(None, 'fsdp',
tp')`` less its layer axis. A JAX-shaped train state goes through
``convert.train_state_from_jax(..., mesh=)`` and ``train_state_to_jax``
on the mesh and back, bit for bit.
"""

import jax
import numpy as np
import pytest
from torch.distributed.tensor import Shard

from ray_tpu.models import presets as jpresets
from ray_tpu.models import training as jtraining
from ray_tpu.parallel.mesh import MeshSpec, build_mesh
from tests.torch_spmd_worlds import (ScaleByAdamState, ScaleByScheduleState,
                                     StateLike, save_tree, start_world,
                                     train_world)

METRIC_TOL = dict(atol=2e-5, rtol=2e-4)
WEIGHT_TOL = dict(atol=2e-5, rtol=2e-4)
STEPS = 8
JAX_LR = 1e-2     # tests/test_models.py::TestShardedTraining's
WEIGHT_LR = 1e-4  # where the elementwise comparison of params is posed
MESH = dict(fsdp=4, tp=2)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


def _adam(opt_state):
    if hasattr(opt_state, "_fields") and "mu" in opt_state._fields:
        return opt_state
    for sub in opt_state:
        if isinstance(sub, tuple):
            found = _adam(sub)
            if found is not None:
                return found
    return None


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("parallel_train")
    cfg = jpresets.llama_debug()
    mesh = build_mesh(MeshSpec.of(**MESH))
    tokens = np.asarray(jax.random.randint(jax.random.PRNGKey(1), (8, 32),
                                           0, 256))
    jax_runs = {}
    world = None
    for lr in (JAX_LR, WEIGHT_LR):
        ocfg = jtraining.OptimizerConfig(learning_rate=lr, warmup_steps=1,
                                         decay_steps=100)
        state, tx = jtraining.init_train_state(
            cfg, ocfg, jax.random.PRNGKey(0), mesh)
        if world is None:  # the port's world runs while JAX steps
            spec = state.params["blocks"]["mlp"]["w_gate"].sharding.spec
            params0 = jax.tree.map(np.asarray, state.params)
            save_tree(str(tmp / "params.npz"), params0)
            like = _state_like(params0)
            world = start_world(
                train_world, 8, tmp, params_npz=str(tmp / "params.npz"),
                tokens=tokens, steps=STEPS, mesh_sizes=MESH,
                lrs=(JAX_LR, WEIGHT_LR), meshless_lr=WEIGHT_LR,
                state_like=like)
        step = jtraining.make_train_step(cfg, tx, mesh)
        metrics = []
        for _ in range(STEPS):
            state, m = step(state, {"tokens": tokens})
            metrics.append({k: float(v) for k, v in m.items()})
        jax_runs[lr] = {"metrics": metrics,
                        "state": jax.tree.map(np.asarray, state)}
    return {"jax": jax_runs, "spec": spec, "port": world.join(),
            "state_like": like}


def _state_like(params):
    """A JAX TrainState's shape (params, optax's Adam and schedule states,
    the step) over JAX's params, with moments drawn from a seed."""
    rng = np.random.RandomState(5)
    mu = jax.tree.map(lambda a: rng.randn(*a.shape).astype(np.float32), params)
    nu = jax.tree.map(lambda a: rng.rand(*a.shape).astype(np.float32), params)
    count = np.asarray(3, np.int32)
    return StateLike(params=params,
                     opt_state=(ScaleByAdamState(count, mu, nu),
                                ScaleByScheduleState(count)),
                     step=np.asarray(3, np.int32))


@pytest.mark.parametrize("lr", [JAX_LR, WEIGHT_LR])
def test_mesh_losses_match_jax_mesh_step(runs, lr):
    port = runs["port"][0][lr]["mesh"]
    assert len(port) == STEPS
    for r in runs["port"]:  # the metrics come back the same on every rank
        assert r[lr]["mesh"] == port
    for j, p in zip(runs["jax"][lr]["metrics"], port):
        np.testing.assert_allclose(p["loss"], j["loss"], **METRIC_TOL)
        np.testing.assert_allclose(p["grad_norm"], j["grad_norm"],
                                   **METRIC_TOL)
        assert p["tokens"] == j["tokens"] == 8 * 31
    if lr == JAX_LR:
        assert port[-1]["loss"] < port[0]["loss"] * 0.9  # JAX's own check


def test_mesh_final_params_and_moments_match_jax(runs):
    r0 = runs["port"][0][WEIGHT_LR]
    jstate = runs["jax"][WEIGHT_LR]["state"]
    adam = _adam(jstate.opt_state)
    for name, want_tree in (("final", jstate.params), ("mu", adam.mu),
                            ("nu", adam.nu)):
        want, got = _flat(want_tree), _flat(r0[name])
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_allclose(got[k], want[k], err_msg=f"{name} {k}",
                                       **WEIGHT_TOL)
    assert r0["step"] == int(jstate.step) == STEPS
    assert r0["count"] == int(adam.count) == STEPS


def test_mesh_step_equals_meshless_step(runs):
    r0 = runs["port"][0][WEIGHT_LR]
    for m, ref in zip(r0["mesh"], r0["meshless"]):
        np.testing.assert_allclose(m["loss"], ref["loss"], **METRIC_TOL)
        np.testing.assert_allclose(m["grad_norm"], ref["grad_norm"],
                                   **METRIC_TOL)
    ref = _flat(r0["meshless_final"])
    for k, v in _flat(r0["final"]).items():
        np.testing.assert_allclose(v, ref[k], err_msg=k, **WEIGHT_TOL)


def test_param_placements_match_jax_spec(runs):
    # JAX: (layers, embed, mlp) -> (None, fsdp, tp)
    assert tuple(runs["spec"]) == (None, "fsdp", "tp")
    for r in runs["port"]:
        assert r[JAX_LR]["placements"]["w_gate"] == (Shard(0), Shard(1))
        assert r[JAX_LR]["placements"]["w_down"] == (Shard(1), Shard(0))


def test_meshed_train_state_round_trips_through_convert(runs):
    """``train_state_from_jax(..., mesh=, specs=)`` places the params and
    both moments as DTensors by the rules; ``train_state_to_jax`` gathers
    them back into JAX's shape, every leaf bit for bit."""
    like = runs["state_like"]
    for r in runs["port"]:
        assert r["round_trip_counts"] == (3, 3)
        for tree in ("params", "mu", "nu"):
            assert r["round_trip_placements"][tree] == (Shard(0), Shard(1))
    back = runs["port"][0]["round_trip"]
    assert type(back) is type(like)
    assert int(back.step) == 3
    for got_s, want_s in zip(back.opt_state, like.opt_state):
        assert type(got_s) is type(want_s)
        assert int(got_s.count) == 3
    for name, got, want in (("params", back.params, like.params),
                            ("mu", back.opt_state[0].mu,
                             like.opt_state[0].mu),
                            ("nu", back.opt_state[0].nu,
                             like.opt_state[0].nu)):
        got, want = _flat(got), _flat(want)
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k].dtype == want[k].dtype
            assert np.array_equal(got[k], want[k]), (name, k)
