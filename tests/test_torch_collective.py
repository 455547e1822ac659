"""The port's collectives' group API (``ray_tpu_torch.util.collective``) on
the CPU, across actors of the port's runtime.

The host group with algo shm, ring and kv across 2 and 3 actors: every op
on seeded numpy inputs given as torch tensors (float32, and bfloat16 where
an op reduces or moves it), against numpy; ``allreduce_coalesced`` over a
mixed-dtype list, its async form with ``out=`` and the ``on_bucket`` order;
``create_collective_group`` (the declarative setup). ``NcclGroup`` with
``device="cpu"`` (its process group on gloo) against numpy. ``destroy`` with
work in flight ends in ``CollectiveError``, not a hang. One case holds the
port's host group against the JAX package's on the same inputs, both
runtimes in this process.

Tolerances: float32 sums and means of 2-3 terms rtol 1e-6 (ranks fold the
terms in their own order); bfloat16 reductions run in float32 and round
once, so they equal numpy's float32 result rounded to bfloat16, exactly;
max, min, broadcast, gather, send/recv and integer ops are exact. The port
against JAX: float32 to the same rtol 1e-6 (each folds in its own order),
the rest exact. Every ``get`` waits at most ``TIMEOUT`` seconds.
"""

import os
import time

import numpy as np
import pytest
import torch

import ray_tpu_torch as rt
from ray_tpu_torch.util.collective import CollectiveError, ReduceOp

os.environ.setdefault("RAY_TPU_TORCH_LOG_LEVEL", "WARNING")

TIMEOUT = 60
RTOL = 1e-6
SHAPE = (5, 3)


def _inputs(seed: int, rank: int):
    rng = np.random.default_rng(seed * 100 + rank)
    return {"f32": rng.standard_normal(SHAPE).astype(np.float32),
            "i64": rng.integers(-50, 50, SHAPE).astype(np.int64)}


def _bf16(a: np.ndarray) -> np.ndarray:
    """float32 rounded to bfloat16 and back (the value a bf16 tensor
    holds)."""
    return torch.from_numpy(a).bfloat16().float().numpy()


@rt.remote
class Rank:
    def __init__(self):
        self.rank = None

    def init(self, world, rank, name, backend="host", algo=None,
             device=None):
        from ray_tpu_torch.util import collective as col

        col.init_collective_group(world, rank, backend=backend,
                                  group_name=name, algo=algo, device=device)
        self.rank = rank
        return rank

    def ops(self, name, seed, world, sized=False):
        """Every op of the group on this rank's seeded inputs, as numpy
        (``sized``: broadcast receivers pass a tensor of the root's
        shape)."""
        from ray_tpu_torch.util import collective as col

        x = _inputs(seed, self.rank)
        f = torch.from_numpy(x["f32"])
        b = f.bfloat16()
        i = torch.from_numpy(x["i64"])
        out = {}
        for op in ReduceOp:
            out[f"f32_{op.value}"] = col.allreduce(f, name, op=op).numpy()
        out["bf16_sum"] = col.allreduce(b, name).float().numpy()
        out["bf16_dtype"] = str(col.allreduce(b, name).dtype)
        out["i64_sum"] = col.allreduce(i, name).numpy()
        out["i64_max"] = col.allreduce(i, name, op=ReduceOp.MAX).numpy()
        out["reduce"] = col.reduce(f, 1, name).numpy()
        # the host group sizes a receiver's result from the root's
        # header; an NCCL group moves bytes into a tensor of the root's
        # shape that every rank passes
        empty = torch.zeros_like if sized else (
            lambda t: torch.empty(0, dtype=t.dtype))
        out["bcast_f32"] = col.broadcast(
            f if self.rank == 0 else empty(f), 0, name).numpy()
        got = col.broadcast(b if self.rank == world - 1 else empty(b),
                            world - 1, name)
        out["bcast_bf16"] = got.float().numpy()
        out["bcast_bf16_dtype"] = str(got.dtype)
        out["gather"] = [t.numpy() for t in col.allgather(f, name)]
        out["gather_bf16"] = [t.float().numpy()
                              for t in col.allgather(b, name)]
        out["rs"] = col.reducescatter(f, name).numpy()
        nxt, prv = (self.rank + 1) % world, (self.rank - 1) % world
        if self.rank % 2 == 0:
            col.send(f, nxt, name)
            out["recv"] = np.asarray(col.recv(prv, name))
        else:
            out["recv"] = np.asarray(col.recv(prv, name))
            col.send(f, nxt, name)
        col.barrier(name)
        out["rank"] = col.get_rank(name)
        out["size"] = col.get_collective_group_size(name)
        return out

    def coalesced(self, name, seed):
        """``allreduce_coalesced`` (MEAN over float32, bfloat16 and int64
        tensors) and its async form with ``out=`` and ``on_bucket``."""
        from ray_tpu_torch.util import collective as col

        x = _inputs(seed, self.rank)
        f = torch.from_numpy(x["f32"])
        ts = [f, f.bfloat16(), torch.from_numpy(x["i64"]), f * 2]
        res = col.allreduce_coalesced(ts, name, op=ReduceOp.MEAN)
        out = {"sync": [(str(r.dtype), r.double().numpy()) for r in res]}
        land = [np.empty(SHAPE, np.float32), torch.empty(SHAPE),
                np.empty(SHAPE, np.float32)]
        seen = []
        work = col.allreduce_coalesced_async(
            [f, f * 2, f * 3], name, op=ReduceOp.SUM, out=land,
            bucket_bytes=f.numel() * 4, overlap=True,
            on_bucket=lambda idx, arrs: seen.append(idx))
        got = work.wait(TIMEOUT * 1000)
        out["async_is_out"] = all(g is o for g, o in zip(got, land))
        out["async"] = [np.asarray(g).copy() for g in got]
        out["on_bucket"] = seen
        out["overlapped"] = work.overlapped
        work = col.allreduce_coalesced_async([f, f.bfloat16()], name,
                                             op=ReduceOp.MAX, overlap=True)
        out["async_tensors"] = [(str(t.dtype), t.float().numpy())
                                for t in work.wait(TIMEOUT * 1000)]
        return out

    def allreduce(self, name, seed):
        from ray_tpu_torch.util import collective as col

        return col.allreduce(torch.from_numpy(_inputs(seed, self.rank)
                                              ["f32"]), name).numpy()

    def in_flight_destroy(self, name):
        """This rank's async round parks waiting for a peer that never
        joins; destroying the group must fail the handle cleanly."""
        from ray_tpu_torch.util import collective as col

        work = col.allreduce_coalesced_async(
            [torch.ones(1000)], group_name=name, timeout_ms=30_000,
            overlap=True)
        time.sleep(0.3)
        t0 = time.monotonic()
        col.destroy_collective_group(name)
        try:
            work.wait(90_000)
            return "NO-ERROR", 0.0
        except CollectiveError as e:
            return f"CollectiveError: {e}", time.monotonic() - t0

    def destroy(self, name):
        from ray_tpu_torch.util import collective as col

        col.destroy_collective_group(name)
        return True

    def bcast_params(self, name, world, rank, tree):
        from ray_tpu_torch.serve._private import weights

        return weights.broadcast_params(tree, name, world, rank)


@pytest.fixture(scope="class")
def ranks():
    rt.init(num_cpus=16, num_gpus=0, object_store_memory=256 * 1024 * 1024)
    actors = [Rank.remote() for _ in range(3)]
    yield actors
    rt.shutdown()


def _group(actors, world, name, **kw):
    rt.get([a.init.remote(world, r, name, **kw)
            for r, a in enumerate(actors[:world])], timeout=TIMEOUT)


def _destroy(actors, world, name):
    rt.get([a.destroy.remote(name) for a in actors[:world]], timeout=TIMEOUT)


def _want(seed, world):
    xs = [_inputs(seed, r) for r in range(world)]
    f = np.stack([x["f32"] for x in xs])
    i = np.stack([x["i64"] for x in xs])
    b = np.stack([_bf16(x["f32"]) for x in xs])
    f64 = f.astype(np.float64)
    return {"f32_sum": f64.sum(0), "f32_mean": f64.mean(0),
            "f32_prod": f64.prod(0), "f32_max": f.max(0), "f32_min": f.min(0),
            "bf16_sum": _bf16(b.sum(0, dtype=np.float32)),
            "i64_sum": i.sum(0), "i64_max": i.max(0),
            "bcast_f32": f[0], "bcast_bf16": b[world - 1],
            "gather": list(f), "gather_bf16": list(b),
            "rs": np.array_split(f64.sum(0), world, axis=0), "f": f, "b": b,
            "i": i}


EXACT = ("f32_max", "f32_min", "bf16_sum", "i64_sum", "i64_max",
         "bcast_f32", "bcast_bf16")


def _param_tree():
    g = torch.Generator().manual_seed(9)
    return {"embed": torch.randn(7, 5, generator=g).bfloat16(),
            "blocks": [{"w": torch.randn(5, 5, generator=g),
                        "ids": torch.arange(6)},
                       {"w": torch.randn(5, 5, generator=g).bfloat16(),
                        "ids": torch.arange(0)}],
            "norm": {"scale": torch.ones(5)}}


class TestOneNode:
    """Three actors on one node (the port's cluster for the class)."""



    @pytest.mark.parametrize("world", [2, 3])
    @pytest.mark.parametrize("algo", ["shm", "ring", "kv"])
    def test_host_group_ops_match_numpy(self, ranks, algo, world):
        name = f"ops-{algo}-{world}"
        _group(ranks, world, name, algo=algo)
        try:
            got = rt.get([a.ops.remote(name, 1, world)
                          for a in ranks[:world]], timeout=TIMEOUT)
        finally:
            _destroy(ranks, world, name)
        want = _want(1, world)
        for r, g in enumerate(got):
            assert g["rank"] == r and g["size"] == world
            for k in ("f32_sum", "f32_mean", "f32_prod"):
                np.testing.assert_allclose(g[k], want[k], rtol=RTOL, atol=RTOL,
                                           err_msg=f"{k} rank {r}")
            for k in EXACT:
                np.testing.assert_array_equal(g[k], want[k], err_msg=k)
            assert g["bf16_dtype"] == g["bcast_bf16_dtype"] == "torch.bfloat16"
            np.testing.assert_allclose(g["reduce"], want["f32_sum"] if r == 1
                                       else want["f"][r], rtol=RTOL, atol=RTOL)
            for a, b in zip(g["gather"], want["gather"]):
                np.testing.assert_array_equal(a, b)
            for a, b in zip(g["gather_bf16"], want["gather_bf16"]):
                np.testing.assert_array_equal(a, b)
            np.testing.assert_allclose(g["rs"], want["rs"][r], rtol=RTOL,
                                       atol=RTOL)
            np.testing.assert_array_equal(g["recv"],
                                          want["f"][(r - 1) % world])


    @pytest.mark.parametrize("world", [2, 3])
    @pytest.mark.parametrize("algo", ["shm", "ring", "kv"])
    def test_coalesced_and_async_match_numpy(self, ranks, algo, world):
        """Sync MEAN over a mixed-dtype list (each result in its input's dtype;
        the integer MEAN widens to float64, as the JAX group's does); async SUM
        into ``out=`` buffers with one bucket per tensor, fired in reverse
        flatten order; async MAX back as tensors of the inputs' dtypes."""
        name = f"coal-{algo}-{world}"
        _group(ranks, world, name, algo=algo)
        try:
            got = rt.get([a.coalesced.remote(name, 2) for a in ranks[:world]],
                         timeout=TIMEOUT)
        finally:
            _destroy(ranks, world, name)
        w = _want(2, world)
        f64 = w["f"].astype(np.float64)
        for g in got:
            dts = [d for d, _ in g["sync"]]
            assert dts == ["torch.float32", "torch.bfloat16", "torch.float64",
                           "torch.float32"]
            np.testing.assert_allclose(g["sync"][0][1], f64.mean(0), rtol=RTOL,
                                       atol=RTOL)
            np.testing.assert_array_equal(
                g["sync"][1][1], _bf16((w["b"] * np.float32(1 / world)).sum(
                    0, dtype=np.float32)))
            np.testing.assert_array_equal(g["sync"][2][1], w["i"].mean(0))
            np.testing.assert_allclose(g["sync"][3][1], 2 * f64.mean(0),
                                       rtol=RTOL, atol=RTOL)
            assert g["async_is_out"] and g["overlapped"]
            assert g["on_bucket"] == [[2], [1], [0]]
            for k, a in enumerate(g["async"]):
                np.testing.assert_allclose(a, (k + 1) * f64.sum(0), rtol=RTOL,
                                           atol=RTOL)
            (d0, m0), (d1, m1) = g["async_tensors"]
            assert (d0, d1) == ("torch.float32", "torch.bfloat16")
            np.testing.assert_array_equal(m0, w["f"].max(0))
            np.testing.assert_array_equal(m1, w["b"].max(0))


    def test_declarative_group(self, ranks):
        """``create_collective_group`` from the driver: the actors resolve
        their ranks on their first collective, with no init of their own."""
        from ray_tpu_torch.util import collective as col

        col.create_collective_group(ranks, 3, [2, 0, 1], backend="host",
                                    group_name="decl")
        got = rt.get([a.allreduce.remote("decl", 3) for a in ranks],
                     timeout=TIMEOUT)
        want = _want(3, 3)
        # the actors' ranks are 2, 0, 1: each sums the same three inputs
        for g in got:
            np.testing.assert_allclose(g, want["f32_sum"], rtol=RTOL,
                                       atol=RTOL)
        col.destroy_collective_group("decl")
        _destroy(ranks, 3, "decl")


    @pytest.mark.parametrize("world", [2, 3])
    def test_nccl_group_on_cpu_matches_numpy(self, ranks, world):
        """``backend="nccl", device="cpu"``: the NcclGroup's own process group
        on gloo over CPU tensors (float32; send/recv over its host
        side-channel)."""
        name = f"gloo-{world}"
        _group(ranks, world, name, backend="nccl", device="cpu")
        try:
            got = rt.get([a.ops.remote(name, 4, world, sized=True)
                          for a in ranks[:world]], timeout=TIMEOUT)
        finally:
            _destroy(ranks, world, name)
        want = _want(4, world)
        for r, g in enumerate(got):
            for k in ("f32_sum", "f32_mean", "f32_prod"):
                np.testing.assert_allclose(g[k], want[k], rtol=RTOL, atol=RTOL,
                                           err_msg=k)
            for k in ("f32_max", "f32_min", "i64_sum", "i64_max", "bcast_f32",
                      "bcast_bf16"):
                np.testing.assert_array_equal(g[k], want[k], err_msg=k)
            # gloo sums the bfloat16 tensor in bfloat16
            np.testing.assert_allclose(g["bf16_sum"], want["bf16_sum"],
                                       rtol=2 ** -7, atol=2 ** -7)
            for a, b in zip(g["gather"], want["gather"]):
                np.testing.assert_array_equal(a, b)
            np.testing.assert_allclose(g["rs"], want["rs"][r], rtol=RTOL,
                                       atol=RTOL)
            np.testing.assert_array_equal(g["recv"],
                                          want["f"][(r - 1) % world])


    def test_nccl_group_refuses_without_a_card(self, ranks):
        """An "nccl" group on the card, in a process that sees none, raises:
        it never drops to gloo."""
        with pytest.raises(rt.TaskError, match="needs a CUDA card"):
            rt.get(ranks[0].init.remote(1, 0, "no-card", backend="nccl"),
                   timeout=TIMEOUT)


    def test_destroy_with_work_in_flight_fails_cleanly(self, ranks):
        _group(ranks, 2, "inflight", algo="shm")
        msg, dt = rt.get(ranks[0].in_flight_destroy.remote("inflight"),
                         timeout=TIMEOUT)
        rt.get(ranks[1].destroy.remote("inflight"), timeout=TIMEOUT)
        assert msg.startswith("CollectiveError"), msg
        assert "in flight" in msg and dt < 20


    def test_host_group_matches_the_jax_group(self, ranks):
        """The same seeded float32 inputs through the port's host group and
        the JAX package's, 3 ranks each, shm: allreduce SUM/MEAN/MAX,
        broadcast, allgather, reducescatter and a coalesced MEAN."""
        import ray_tpu

        from tests.test_torch_runtime_cluster import \
            retire_leftover_jax_runtime

        @ray_tpu.remote
        class JaxRank:
            def run(self, world, rank, seed):
                from ray_tpu.util import collective as col
                from ray_tpu.util.collective import ReduceOp as JOp

                col.init_collective_group(world, rank, "host", "jx",
                                          algo="shm")
                f = _inputs(seed, rank)["f32"]
                out = [np.asarray(col.allreduce(f, "jx", op=op))
                       for op in (JOp.SUM, JOp.MEAN, JOp.MAX)]
                out.append(np.asarray(col.broadcast(f, 1, "jx")))
                out += [np.asarray(g) for g in col.allgather(f, "jx")]
                out.append(np.asarray(col.reducescatter(f, "jx")))
                out += [np.asarray(x) for x in col.allreduce_coalesced(
                    [f, f * 2], "jx", op=JOp.MEAN)]
                col.destroy_collective_group("jx")
                return out

        @rt.remote
        class PortRank:
            def run(self, world, rank, seed):
                from ray_tpu_torch.util import collective as col

                col.init_collective_group(world, rank, "host", "px",
                                          algo="shm")
                f = torch.from_numpy(_inputs(seed, rank)["f32"])
                out = [col.allreduce(f, "px", op=op).numpy()
                       for op in (ReduceOp.SUM, ReduceOp.MEAN, ReduceOp.MAX)]
                out.append(col.broadcast(f, 1, "px").numpy())
                out += [g.numpy() for g in col.allgather(f, "px")]
                out.append(col.reducescatter(f, "px").numpy())
                out += [x.numpy() for x in col.allreduce_coalesced(
                    [f, f * 2], "px", op=ReduceOp.MEAN)]
                col.destroy_collective_group("px")
                return out

        retire_leftover_jax_runtime()
        ray_tpu.init(num_cpus=8, object_store_memory=128 * 1024 * 1024)
        try:
            jax_out = ray_tpu.get([JaxRank.remote().run.remote(3, r, 5)
                                   for r in range(3)], timeout=TIMEOUT)
            port_out = rt.get([PortRank.remote().run.remote(3, r, 5)
                               for r in range(3)], timeout=TIMEOUT)
        finally:
            ray_tpu.shutdown()
            retire_leftover_jax_runtime()
        for j, p in zip(jax_out, port_out):
            assert len(j) == len(p)
            for k, (a, b) in enumerate(zip(j, p)):
                if k in (2, 3, 4, 5, 6):  # max, broadcast, gather: exact
                    np.testing.assert_array_equal(b, a)
                else:
                    np.testing.assert_allclose(b, a, rtol=RTOL, atol=RTOL)



    def test_broadcast_params_across_three_actors(self, ranks):
        """``serve/_private/weights.py::broadcast_params``: the root's tree
        (bf16, float32, int64 and an empty leaf) arrives on the two receivers
        bit for bit, with its dtypes and shapes."""
        tree = _param_tree()
        got = rt.get([a.bcast_params.remote("wb", 3, r,
                                            tree if r == 0 else None)
                      for r, a in enumerate(ranks)], timeout=TIMEOUT)
        from ray_tpu_torch.models.transformer import map_params

        want = []
        map_params(lambda p, t: want.append((p, t)), tree)
        for g in got:
            have = []
            map_params(lambda p, t: have.append((p, t)), g)
            assert [p for p, _ in have] == [p for p, _ in want]
            for (_, a), (_, b) in zip(have, want):
                assert a.dtype == b.dtype and a.shape == b.shape
                assert torch.equal(a, b)


@rt.remote
class NodeRank:
    def run(self, world, rank, n):
        """The twin of tests/test_collective_cluster.py's cross-node ring
        case, one rank: a 200k float32 allreduce, the algo, a broadcast."""
        from ray_tpu_torch.util import collective as col

        col.init_collective_group(world, rank, "host", "xnode")
        out = col.allreduce(torch.full((n,), float(rank + 1)), "xnode")
        algo = col.collective._manager.get("xnode").algo
        b = col.broadcast(torch.tensor([3.0 + rank]), 1, "xnode")
        col.destroy_collective_group("xnode")
        return out[0].item(), out[-1].item(), tuple(out.shape), algo, b.item()


def test_ring_across_nodes_chunked():
    """4 ranks over 2 supervisor processes, 64 KiB chunks, so every ring
    segment of a 200k float32 allreduce streams as ~7 frames (the port's
    twin of ``tests/test_collective_cluster.py::TestCrossNodeRing::
    test_ring_across_nodes_chunked``)."""
    from ray_tpu_torch._private.config import Config
    from ray_tpu_torch.cluster_utils import Cluster

    cfg = Config.from_env()
    cfg.collective_chunk_bytes = 64 * 1024
    c = Cluster(cfg)
    try:
        c.add_node(num_cpus=4, resources={"nodeA": 10})
        c.add_node(num_cpus=4, resources={"nodeB": 10})
        c.wait_for_nodes(2)
        rt.init(address=c.address)
        workers = [NodeRank.options(resources={
            ("nodeA" if i % 2 == 0 else "nodeB"): 1}).remote()
            for i in range(4)]
        outs = rt.get([w.run.remote(4, i, 200_000)
                       for i, w in enumerate(workers)], timeout=TIMEOUT * 2)
        for first, last, shape, algo, b in outs:
            assert (first, last, shape) == (10.0, 10.0, (200_000,))
            assert algo == "ring" and b == 4.0
    finally:
        if rt.is_initialized():
            rt.shutdown()
        c.shutdown()
