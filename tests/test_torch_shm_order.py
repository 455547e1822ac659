"""The shared-memory allreduce folds in rank order (the port's
``util/collective/shm.py::ShmGroup.allreduce``).

Every rank of a host group with ``algo="shm"`` folds the contributions
0..W-1 in rank order, so at world 3 and 4 every rank gets the same bits:
float32 ``allreduce`` SUM and MEAN, bfloat16 SUM, ``allreduce_coalesced``
MEAN (sync, and async over the overlap runner) and the in-place form whose
``out=`` aliases the input. In float32 those bits equal the JAX package's
rank 0 on the same inputs (its rank 0 folds in rank order too; its other
ranks start from their own term). The channels here hold 4 KiB, so each
3000-element float32 array crosses in three chunk rounds and the aliased
form keeps its own chunk in the scratch buffer over several rounds.
Exact comparisons only; every ``get`` waits at most ``TIMEOUT`` seconds.
"""

import os

import numpy as np
import pytest
import torch

import ray_tpu_torch as rt
from ray_tpu_torch.util.collective import ReduceOp

os.environ.setdefault("RAY_TPU_TORCH_LOG_LEVEL", "WARNING")

TIMEOUT = 90
N = 3000
CHANNEL_BYTES = 4096


def _inputs(rank: int):
    rng = np.random.default_rng(100 + rank)
    # mixed magnitudes: the fold order shows in the low bits
    return (rng.standard_normal(N) * 10.0 ** rng.integers(-3, 4, N)).astype(
        np.float32)


def _port_ops(name: str, rank: int) -> dict:
    from ray_tpu_torch.util import collective as col

    x = _inputs(rank)
    f = torch.from_numpy(x.copy())
    out = {"sum": col.allreduce(f, name).numpy(),
           "mean": col.allreduce(f, name, op=ReduceOp.MEAN).numpy(),
           "bf16_sum": col.allreduce(f.bfloat16(), name).view(
               torch.int16).numpy()}
    out["coalesced"] = [t.numpy() for t in col.allreduce_coalesced(
        [f, f * 3, f[:700]], name, op=ReduceOp.MEAN)]
    work = col.allreduce_coalesced_async([f, f * 3], name,
                                         op=ReduceOp.MEAN, overlap=True)
    out["coalesced_async"] = [t.numpy() for t in work.wait(TIMEOUT * 1000)]
    inplace = x.copy()
    group = col.collective._manager.get(name)
    got = group.allreduce(inplace, ReduceOp.SUM, TIMEOUT * 1000,
                          out=inplace)
    out["inplace_is_out"] = got is inplace
    out["inplace"] = inplace
    return out


@rt.remote
class PortRank:
    def run(self, world, rank, name):
        from ray_tpu_torch.util import collective as col

        col.init_collective_group(world, rank, "host", name, algo="shm")
        try:
            return _port_ops(name, rank)
        finally:
            col.destroy_collective_group(name)


def _jax_rank0(world: int) -> dict:
    """The JAX package's float32 results on rank 0 of a shm group of
    ``world`` actors, on the same inputs."""
    import ray_tpu

    from tests.test_torch_runtime_cluster import \
        retire_leftover_jax_runtime

    @ray_tpu.remote
    class JaxRank:
        def run(self, world, rank, name):
            from ray_tpu.util import collective as col
            from ray_tpu.util.collective import ReduceOp as JOp

            col.init_collective_group(world, rank, "host", name, algo="shm")
            x = _inputs(rank)
            out = {"sum": np.asarray(col.allreduce(x, name)),
                   "mean": np.asarray(col.allreduce(x, name, op=JOp.MEAN)),
                   "coalesced": [np.asarray(a) for a in
                                 col.allreduce_coalesced(
                                     [x, x * 3, x[:700]], name,
                                     op=JOp.MEAN)]}
            col.destroy_collective_group(name)
            return out

    retire_leftover_jax_runtime()
    ray_tpu.init(num_cpus=8, object_store_memory=128 * 1024 * 1024)
    try:
        outs = ray_tpu.get([JaxRank.remote().run.remote(world, r, "jx")
                            for r in range(world)], timeout=TIMEOUT)
    finally:
        ray_tpu.shutdown()
        retire_leftover_jax_runtime()
    return outs[0]


@pytest.fixture(scope="module")
def port_results():
    rt.init(num_cpus=8, num_gpus=0, object_store_memory=128 * 1024 * 1024,
            _system_config={"collective_channel_bytes": CHANNEL_BYTES})
    try:
        actors = [PortRank.remote() for _ in range(4)]
        yield {world: rt.get([a.run.remote(world, r, f"order{world}")
                              for r, a in enumerate(actors[:world])],
                             timeout=TIMEOUT)
               for world in (3, 4)}
    finally:
        rt.shutdown()


def _leaves(out: dict, keys):
    for k in keys:
        v = out[k]
        for i, a in enumerate(v if isinstance(v, list) else [v]):
            yield f"{k}[{i}]", a


KEYS = ("sum", "mean", "bf16_sum", "coalesced", "coalesced_async",
        "inplace")


@pytest.mark.parametrize("world", [3, 4])
def test_every_rank_gets_the_same_bits(port_results, world):
    outs = port_results[world]
    for r, out in enumerate(outs):
        assert out["inplace_is_out"], r
        for (k, a), (_, b) in zip(_leaves(out, KEYS),
                                  _leaves(outs[0], KEYS)):
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), (
                f"world {world}: rank {r}'s {k} differs from rank 0's in "
                f"{int(np.sum(a != b))} of {a.size} elements")


@pytest.mark.parametrize("world", [3, 4])
def test_rank_order_matches_the_jax_rank_0(port_results, world):
    """float32: the port's bits are the JAX package's rank 0's, and the
    in-place sum is the sync sum."""
    port = port_results[world][0]
    jax0 = _jax_rank0(world)
    for k in ("sum", "mean", "coalesced"):
        for (name, a), (_, b) in zip(_leaves(port, (k,)),
                                     _leaves(jax0, (k,))):
            assert a.dtype == b.dtype == np.float32, name
            assert a.tobytes() == b.tobytes(), (
                f"world {world}: {name} differs from JAX's rank 0 in "
                f"{int(np.sum(a != b))} of {a.size} elements")
    assert port["inplace"].tobytes() == port["sum"].tobytes()
    # the rank order itself: ((x0 + x1) + x2) + ... in float32
    want = _inputs(0).copy()
    for r in range(1, world):
        np.add(want, _inputs(r), out=want)
    assert port["sum"].tobytes() == want.tobytes()
