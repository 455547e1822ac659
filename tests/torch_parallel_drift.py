"""How far apart 8 llama_debug steps on a fsdp4 x tp2 mesh leave the params,
JAX against the port, at three learning rates: the measurement behind
``tests/test_torch_parallel_train.py``'s choice to hold params elementwise
at 1e-4 and not at JAX's test's 1e-2.

Runs JAX's mesh step (8 virtual CPU devices) and its one-device step, and
the port's mesh step (a gloo world of 8 CPU processes) and its meshless
step, from the same JAX initial params, and prints, for each learning rate
and each pair of runs, the largest elementwise difference of the final
params and the count of elements outside 2e-5 abs + 2e-4 rel. Usage, from
the root of a checkout (about a minute):

    JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8 \\
        python -m tests.torch_parallel_drift
"""

import os
import tempfile


def main():
    import itertools

    import jax
    import numpy as np

    from ray_tpu.models import presets as jpresets
    from ray_tpu.models import training as jtraining
    from ray_tpu.parallel.mesh import MeshSpec, build_mesh
    from tests.test_torch_parallel_train import MESH, STEPS, _flat
    from tests.torch_spmd_worlds import (ScaleByAdamState,
                                         ScaleByScheduleState, StateLike,
                                         run_world, save_tree, train_world)

    cfg = jpresets.llama_debug()
    mesh = build_mesh(MeshSpec.of(**MESH))
    tokens = np.asarray(jax.random.randint(jax.random.PRNGKey(1), (8, 32),
                                           0, 256))
    lrs = (1e-2, 3e-4, 1e-4)
    with tempfile.TemporaryDirectory() as tmp:
        finals = {lr: {} for lr in lrs}
        for lr, (name, m) in itertools.product(
                lrs, (("jax_mesh", mesh), ("jax_one_device", None))):
            ocfg = jtraining.OptimizerConfig(learning_rate=lr,
                                             warmup_steps=1, decay_steps=100)
            state, tx = jtraining.init_train_state(
                cfg, ocfg, jax.random.PRNGKey(0), m)
            params0 = jax.tree.map(np.asarray, state.params)
            step = jtraining.make_train_step(cfg, tx, m)
            for _ in range(STEPS):
                state, _ = step(state, {"tokens": tokens})
            finals[lr][name] = _flat(jax.tree.map(np.asarray, state.params))
        save_tree(os.path.join(tmp, "params.npz"), params0)
        count = np.asarray(0, np.int32)
        zeros = jax.tree.map(np.zeros_like, params0)
        like = StateLike(params0, (ScaleByAdamState(count, zeros, zeros),
                                   ScaleByScheduleState(count)), count)
        for lr in lrs:
            port = run_world(train_world, 8, os.path.join(tmp, str(lr)),
                             params_npz=os.path.join(tmp, "params.npz"),
                             tokens=tokens, steps=STEPS, mesh_sizes=MESH,
                             lrs=(lr,), meshless_lr=lr, state_like=like)
            finals[lr]["port_mesh"] = _flat(port[0][lr]["final"])
            finals[lr]["port_meshless"] = _flat(port[0][lr]["meshless_final"])
    for lr in lrs:
        runs = finals[lr]
        for a, b in itertools.combinations(sorted(runs), 2):
            diff = max(float(np.abs(runs[a][k] - runs[b][k]).max())
                       for k in runs[a])
            outside = sum(int((~np.isclose(runs[a][k], runs[b][k],
                                           atol=2e-5, rtol=2e-4)).sum())
                          for k in runs[a])
            print(f"lr {lr:g}: {a} vs {b}: max |diff| {diff:.3e}, "
                  f"{outside} elements outside 2e-5 + 2e-4 rel")


if __name__ == "__main__":
    # before JAX is imported: the CPU, as 8 virtual devices
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    if "--xla_force_host_platform_device_count" not in os.environ.get(
            "XLA_FLAGS", ""):
        os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "") +
                                   " --xla_force_host_platform_device_count=8")
    main()
