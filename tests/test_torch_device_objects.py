"""Sharded device objects: a DTensor through the port's ``put``/``get``
with its mesh and placements, held against the JAX package's
``NamedSharding`` objects (``ray_tpu/_private/device_objects.py``).

- The metadata: ``sharded_meta`` against JAX's ``extract_meta`` on
  conftest's 8 virtual devices, with no process group (mesh axes, partition
  spec, every distinct shard's slice and bytes), and each coordinate's
  slice against torch's own ``compute_local_shape_and_global_offset``.
- A world-1 gloo mesh in this process: the round trip (put records the
  layout and parks the shard, the owner's get is a private DTensor copy, a
  plain task gets the whole tensor, GC frees it).
- Gloo worlds of runtime actors: four producers put one seeded array on a
  2x2 ("x", "y") mesh, each rank calling ``put``; the same array goes
  through JAX's ``put``/``get`` over a 2x2 ``NamedSharding``. This
  process's get is the whole tensor, a consumer world of four gets DTensors whose
  local shards are JAX's addressable shards, a plain task gets the ref as
  an argument, shards larger than a transfer chunk stream in chunks, each
  rank's own get reads nothing from any holder, dropping every ref empties
  every holder's registry, an uneven ``Shard`` reassembles, a world-1
  actor returns a DTensor and a world-2 return raises, and a killed holder
  gives ``ObjectLostError``.
"""

import gc
import os
import sys
import tempfile
import time

import cloudpickle
import numpy as np
import pytest
import torch
import torch.distributed as dist

import ray_tpu_torch as rt
from ray_tpu_torch._private import api as rt_api
from ray_tpu_torch._private import device_objects
from ray_tpu_torch._private.exceptions import ObjectLostError
from ray_tpu_torch.parallel.mesh import MeshSpec
from ray_tpu_torch.parallel.sharding import spec_to_placements
from tests.test_torch_runtime_cluster import (
    retire_leftover_jax_runtime, retire_leftover_jax_runtime_for_later_files)

os.environ.setdefault("RAY_TPU_TORCH_LOG_LEVEL", "WARNING")
# the actor classes ship by value: a worker never imports this module (and
# with it JAX)
cloudpickle.register_pickle_by_value(sys.modules[__name__])

WORLD = 4
SIZES = (2, 2)
NAMES = ("x", "y")
CHUNK = 64 * 1024  # this process's transfer chunk: the big shards take 8


def _seeded(shape, seed):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _trim(spec):
    """A spec without its trailing Nones (JAX keeps what its caller wrote;
    the port writes none)."""
    spec = tuple(tuple(e) if isinstance(e, (list, tuple)) else e
                 for e in spec)
    while spec and spec[-1] is None:
        spec = spec[:-1]
    return spec


def _gone(pid) -> bool:
    """The process has exited (a zombie that its parent has not reaped yet
    counts as gone)."""
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().rsplit(")", 1)[1].split()[0] == "Z"
    except FileNotFoundError:
        return True


def _wait(cond, timeout=5.0):
    deadline = time.monotonic() + timeout
    while not cond() and time.monotonic() < deadline:
        time.sleep(0.05)
    return cond()


# ----------------------------------------------------------- no world


JAX_LAYOUTS = {
    "xy": ((2, 4), ("x", "y")),
    "none_y": ((2, 4), (None, "y")),
    "x_and_y": ((2, 4), (("x", "y"),)),
    "replicated": ((2, 4), ()),
    "x8": ((8,), ("x",)),
}


@pytest.mark.parametrize("layout", sorted(JAX_LAYOUTS))
def test_sharded_meta_matches_jax(layout):
    import jax
    from jax.sharding import Mesh, NamedSharding, PartitionSpec

    from ray_tpu._private import device_objects as jdo

    sizes, spec = JAX_LAYOUTS[layout]
    names = NAMES[:len(sizes)]
    mesh = Mesh(np.array(jax.devices()[:8]).reshape(sizes), names)
    arr = jax.device_put(_seeded((16, 8), 0),
                         NamedSharding(mesh, PartitionSpec(*spec)))
    want = jdo.extract_meta(arr)
    axes = tuple(zip(names, sizes))
    got = device_objects.sharded_meta(
        (16, 8), torch.float32, axes,
        spec_to_placements(spec, MeshSpec(axes)), "cpu")
    assert got.mesh_axes == want.mesh_axes
    assert _trim(got.pspec) == _trim(want.pspec)
    assert dict(got.shards) == dict(want.shards)
    assert len(got.shards) == len(want.shards)
    assert (got.shape, got.dtype, got.nbytes) == (want.shape, want.dtype,
                                                  want.nbytes)
    # each distinct shard is served by the lowest coordinate that holds it
    # (JAX's device i sits at flat coordinate i of the same mesh)
    first = {}
    for i, dev in enumerate(mesh.devices.flat):
        first.setdefault(jdo._norm_index(
            arr.sharding.devices_indices_map(arr.shape)[dev], arr.shape), i)
    assert {k: got.holder_of(i) for i, (k, _) in enumerate(got.shards)} \
        == first


@pytest.mark.parametrize("shape,sizes,placements", [
    ((6, 4), (2, 2), ("S0", "S0")),
    ((6, 3), (4,), ("S0",)),
    ((5, 7), (2, 2), ("S1", "S0")),
    ((3, 5), (2, 2), ("R", "S1")),
    ((1, 9), (2, 4), ("S0", "S1")),
])
def test_coordinate_key_matches_torch(shape, sizes, placements):
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor._utils import (
        _compute_local_shape_and_global_offset)

    pls = [Replicate() if p == "R" else Shard(int(p[1])) for p in placements]
    for coord in device_objects._coords(sizes):
        local, offset = _compute_local_shape_and_global_offset(
            shape, sizes, list(coord), pls)
        want = tuple((o, o + n) for o, n in zip(offset, local))
        assert device_objects.coordinate_key(shape, sizes, coord,
                                             pls) == want


def test_assemble_refuses_shards_that_do_not_tile():
    axes = (("x", 2), ("y", 2))
    meta = device_objects.sharded_meta(
        (4, 4), torch.float32, axes,
        spec_to_placements(("x", "y"), MeshSpec(axes)), "cpu")
    src = torch.arange(16, dtype=torch.float32).reshape(4, 4)
    data = {k: src[tuple(slice(a, b) for a, b in k)].contiguous().numpy()
            .tobytes() for k, _ in meta.shards}
    assert torch.equal(device_objects.assemble(meta, data), src)
    meta.shards = meta.shards[:3]
    with pytest.raises(ValueError, match="cover 12/16"):
        device_objects.assemble(meta, data)


# ------------------------------------------------------------- clusters


@pytest.fixture(scope="module", autouse=True)
def _no_leftover_jax_runtime():
    yield
    retire_leftover_jax_runtime_for_later_files()


def _jax_addressable(boxed):
    """A JAX consumer's get: each addressable shard's slice and values."""
    import ray_tpu

    from ray_tpu._private import device_objects as jdo

    arr = ray_tpu.get(boxed[0])
    return {jdo._norm_index(sh.index, arr.shape): np.asarray(sh.data)
            for sh in arr.addressable_shards}


@pytest.fixture(scope="module")
def jax_ref():
    """One seeded array through JAX's put and get over a 2x2 NamedSharding
    of ``jax.devices()[:4]``: the owner's get and another process's, on a
    JAX cluster shut down before the port's starts."""
    import jax
    import ray_tpu
    from jax.sharding import Mesh, NamedSharding, PartitionSpec

    retire_leftover_jax_runtime()
    mesh = Mesh(np.array(jax.devices()[:WORLD]).reshape(SIZES), NAMES)
    src = _seeded((8, 6), 1)
    arr = jax.device_put(src, NamedSharding(mesh, PartitionSpec(*NAMES)))
    ray_tpu.init(num_cpus=4, object_store_memory=64 * 1024 * 1024)
    try:
        ref = ray_tpu.put(arr)
        whole = np.asarray(ray_tpu.get(ref))
        shards = ray_tpu.get(ray_tpu.remote(_jax_addressable).remote([ref]),
                             timeout=120)
    finally:
        ray_tpu.shutdown()
    return {"src": src, "whole": whole, "shards": shards}


@pytest.fixture(scope="module")
def cluster(jax_ref):
    retire_leftover_jax_runtime()
    info = rt.init(num_cpus=16, num_gpus=0,
                   object_store_memory=128 * 1024 * 1024,
                   _system_config={"object_transfer_chunk_bytes": CHUNK})
    yield info
    rt.shutdown()


@rt.remote
class _Rank:
    """One rank of a gloo world in a runtime actor."""

    def __init__(self):
        self.refs = []
        self.meshes = {}

    def join(self, rank, n, store):
        import datetime

        torch.set_num_threads(1)
        dist.init_process_group(
            "gloo", store=dist.FileStore(store, n), rank=rank, world_size=n,
            timeout=datetime.timedelta(seconds=60))
        self.meshes = {}
        return os.getpid()

    def leave(self):
        dist.destroy_process_group()
        self.meshes = {}

    def _mesh(self, names, sizes):
        from torch.distributed.device_mesh import DeviceMesh

        if (names, sizes) not in self.meshes:
            self.meshes[names, sizes] = DeviceMesh(
                "cpu", torch.arange(dist.get_world_size()).reshape(sizes),
                mesh_dim_names=names)
        return self.meshes[names, sizes]

    def _dtensor(self, arr, names, sizes, spec):
        from torch.distributed.tensor import distribute_tensor

        mesh = self._mesh(names, sizes)
        return distribute_tensor(torch.from_numpy(arr), mesh,
                                 spec_to_placements(spec, mesh),
                                 src_data_rank=None)

    def put(self, arr, names, sizes, spec):
        """Every rank puts its DTensor of ``arr``, then gets it back."""
        from torch.distributed.tensor import DTensor
        from torch.distributed.tensor._utils import (
            compute_local_shape_and_global_offset)

        core = rt_api._core
        dt = self._dtensor(arr, names, sizes, spec)
        ref = rt.put(dt)
        self.refs.append(ref)
        reads = core.device_objects.reads
        mine = rt.get(ref, timeout=60)
        local, offset = compute_local_shape_and_global_offset(
            dt.shape, dt.device_mesh, dt.placements)
        return {"boxed": [ref], "oid": ref.hex(), "owner": ref._owner_addr,
                "dtensor": isinstance(mine, DTensor),
                "placements": tuple(mine.placements),
                "equal": torch.equal(mine.to_local(), dt.to_local()),
                "own_get_reads": core.device_objects.reads - reads,
                "in_process": core.in_process.get(ref._object_id) is not None,
                "key": device_objects.local_key(dt),
                "torch_key": tuple((o, o + s)
                                   for o, s in zip(offset, local))}

    def get(self, boxed):
        """A consumer's get of ``boxed[0]``."""
        from torch.distributed.tensor import DTensor

        out = rt.get(boxed[0], timeout=60)
        r = {"dtensor": isinstance(out, DTensor)}
        if r["dtensor"]:
            r.update(placements=tuple(out.placements),
                     names=out.device_mesh.mesh_dim_names,
                     coord=tuple(out.device_mesh.get_coordinate()),
                     key=device_objects.local_key(out),
                     local=out.to_local().numpy(),
                     whole=out.full_tensor().numpy())
        else:
            r["whole"] = out.numpy()
        return r

    def reads(self):
        return rt_api._core.device_objects.reads

    def pid(self):
        return os.getpid()

    def held(self):
        return len(rt_api._core.device_objects)

    def drop(self):
        self.refs.clear()
        gc.collect()

    def give(self, arr, names, sizes, spec):
        """Return a DTensor of ``arr`` (a task return, not a put)."""
        return self._dtensor(arr, names, sizes, spec)


@rt.remote
def _whole(x):
    return type(x).__name__, x.numpy()


def _world(n, tmp):
    actors = [_Rank.remote() for _ in range(n)]
    rt.get([a.join.remote(r, n, os.path.join(tmp, "store"))
            for r, a in enumerate(actors)], timeout=120)
    return actors


@pytest.fixture(scope="module")
def producers(cluster):
    with tempfile.TemporaryDirectory() as tmp:
        actors = _world(WORLD, tmp)
        yield actors
    for a in actors:
        try:
            rt.kill(a)
        except Exception:
            pass  # the holder that a test killed


@pytest.fixture(scope="module")
def consumers(cluster):
    with tempfile.TemporaryDirectory() as tmp:
        actors = _world(WORLD, tmp)
        yield actors
    for a in actors:
        rt.kill(a)


def _put(ranks, arr, names=NAMES, sizes=SIZES, spec=NAMES):
    return rt.get([a.put.remote(arr, names, sizes, spec) for a in ranks],
                  timeout=120)


def _jax_shard(jax_ref, key):
    return jax_ref["shards"][tuple(map(tuple, key))]


def test_dtensor_put_round_trips(cluster, tmp_path):
    """A world-1 ("x", "y") mesh in this process: put records the layout
    and stores no host bytes, the owner's get is a DTensor over the same
    mesh and a private copy, a plain task gets the whole tensor, and GC
    frees the shard."""
    from torch.distributed.device_mesh import DeviceMesh
    from torch.distributed.tensor import DTensor, Shard, distribute_tensor

    dist.init_process_group(
        "gloo", store=dist.FileStore(str(tmp_path / "store"), 1), rank=0,
        world_size=1)
    try:
        mesh = DeviceMesh("cpu", torch.arange(1).reshape(1, 1),
                          mesh_dim_names=NAMES)
        src = torch.from_numpy(_seeded((4, 4), 2))
        dt = distribute_tensor(src, mesh, [Shard(0), Shard(1)])
        ref = rt.put(dt)
        meta = device_objects.extract_meta(dt)
        assert meta.mesh_axes == (("x", 1), ("y", 1))
        assert meta.pspec == ("x", "y") and meta.device_type == "cpu"
        assert meta.shards == [(((0, 4), (0, 4)), 64)]
        assert device_objects.is_device_array(dt)
        assert not device_objects.is_device_array(src)
        core = rt_api._core
        entry = core.objects[ref._object_id]
        assert entry.state == "DEVICE"
        assert core.in_process.get(ref._object_id) is None
        out = rt.get(ref, timeout=60)
        assert isinstance(out, DTensor) and out.device_mesh is mesh
        assert tuple(out.placements) == (Shard(0), Shard(1))
        assert torch.equal(out.to_local(), src)
        out.to_local().zero_()  # the owner's result is private
        dt.to_local().add_(1)  # and so is the put's source
        assert torch.equal(rt.get(ref, timeout=60).to_local(), src)
        name, whole = rt.get(_whole.remote(ref), timeout=60)
        assert name == "Tensor" and np.array_equal(whole, src.numpy())
        oid = ref._object_id
        del ref, out
        gc.collect()
        assert _wait(lambda: core.device_objects.get(oid) is None)
    finally:
        dist.destroy_process_group()


def test_world_put_is_one_object_and_own_gets_read_nothing(
        jax_ref, producers):
    got = _put(producers, jax_ref["src"])
    assert len({(r["oid"], tuple(r["owner"])) for r in got}) == 1
    core = rt_api._core
    assert all(r["dtensor"] and r["equal"] for r in got)
    assert all(r["own_get_reads"] == 0 and not r["in_process"] for r in got)
    assert rt.get([a.reads.remote() for a in producers]) == [0] * WORLD
    # each rank's slice is torch's own
    assert [r["key"] for r in got] == [r["torch_key"] for r in got]
    # this process's get: the whole tensor, JAX's whole array
    reads = rt.get([a.reads.remote() for a in producers])
    whole = rt.get(got[0]["boxed"][0], timeout=60)
    assert isinstance(whole, torch.Tensor) and whole.device.type == "cpu"
    assert np.array_equal(whole.numpy(), jax_ref["whole"])
    assert np.array_equal(whole.numpy(), jax_ref["src"])
    after = rt.get([a.reads.remote() for a in producers])
    # every rank holds a distinct shard, read in one chunk each
    assert [b - a for a, b in zip(reads, after)] == [1] * WORLD
    assert core.in_process.get(got[0]["boxed"][0]._object_id) is None
    for a in producers:
        a.drop.remote()


def test_consumer_world_gets_jax_shards(jax_ref, producers, consumers):
    got = _put(producers, jax_ref["src"])
    boxed = got[0]["boxed"]
    out = rt.get([c.get.remote(boxed) for c in consumers], timeout=120)
    want_placements = tuple(spec_to_placements(NAMES, MeshSpec(
        tuple(zip(NAMES, SIZES)))))
    for rank, r in enumerate(out):
        assert r["dtensor"] and r["names"] == NAMES
        assert r["placements"] == want_placements
        assert r["coord"] == device_objects._coords(SIZES)[rank]
        assert np.array_equal(r["local"], _jax_shard(jax_ref, r["key"]))
        assert np.array_equal(r["whole"], jax_ref["whole"])
    assert len({r["key"] for r in out}) == WORLD
    # a plain task gets the ref as an argument: the whole tensor
    name, whole = rt.get(_whole.remote(boxed[0]), timeout=60)
    assert name == "Tensor" and np.array_equal(whole, jax_ref["whole"])
    for a in producers:
        a.drop.remote()


def test_chunked_shards_and_free_empties_every_holder(producers):
    gc.collect()
    assert _wait(lambda: rt.get([a.held.remote() for a in producers])
                 == [0] * WORLD)
    src = _seeded((1024, 512), 3)  # 512 KiB a shard: 8 chunks each
    got = _put(producers, src)
    ref = got[0]["boxed"][0]
    del got
    before = rt.get([a.reads.remote() for a in producers])
    assert rt.get([a.held.remote() for a in producers]) == [1] * WORLD
    whole = rt.get(ref, timeout=60)
    assert np.array_equal(whole.numpy(), src)
    after = rt.get([a.reads.remote() for a in producers])
    assert [b - a for a, b in zip(before, after)] == [
        src.nbytes // WORLD // CHUNK] * WORLD
    # drop this process's ref and every rank's: every holder lets go
    del ref, whole
    gc.collect()
    rt.get([a.drop.remote() for a in producers])
    assert _wait(lambda: rt.get([a.held.remote() for a in producers])
                 == [0] * WORLD)


def test_uneven_shard_reassembles(producers, consumers):
    """A dim of 6 over a 1-dim mesh of 4: shards of 2, 2, 2 and 0 rows."""
    src = _seeded((6, 3), 4)
    got = _put(producers, src, ("w",), (WORLD,), ("w",))
    assert [r["key"][0] for r in got] == [(0, 2), (2, 4), (4, 6), (6, 6)]
    assert [r["key"] for r in got] == [r["torch_key"] for r in got]
    boxed = got[0]["boxed"]
    whole = rt.get(boxed[0], timeout=60)
    assert np.array_equal(whole.numpy(), src)
    out = rt.get([c.get.remote(boxed) for c in consumers], timeout=120)
    for r, g in zip(out, got):
        assert r["key"] == g["key"]
        assert np.array_equal(r["local"], src[slice(*g["key"][0])])
        assert np.array_equal(r["whole"], src)
    for a in producers:
        a.drop.remote()


def test_task_returns(consumers, tmp_path):
    """A world-1 actor returns a DTensor: a one-holder sharded object that
    this process gets whole. A world-2 return raises, naming put."""
    rt.get([c.leave.remote() for c in consumers])
    rt.get(consumers[0].join.remote(0, 1, str(tmp_path / "one")))
    rt.get([c.join.remote(r, 2, str(tmp_path / "two"))
            for r, c in enumerate(consumers[1:3])])
    src = _seeded((64, 48), 5)  # small: a DTensor return is never inline
    ref = consumers[0].give.remote(src, NAMES, (1, 1), NAMES)
    whole = rt.get(ref, timeout=60)
    assert np.array_equal(whole.numpy(), src)
    entry = rt_api._core.objects[ref._object_id]
    assert entry.state == "DEVICE" and entry.location is not None
    two = [c.give.remote(src, ("x",), (2,), ("x",)) for c in consumers[1:3]]
    for r in two:
        with pytest.raises(Exception, match=r"mesh of 2 ranks.*put"):
            rt.get(r, timeout=60)
    del ref
    assert _wait(lambda: rt.get(consumers[0].held.remote()) == 0)
    rt.get([c.leave.remote() for c in consumers[:3]])


def test_killed_holder_is_object_lost(producers):
    got = _put(producers, _seeded((8, 6), 6))
    ref = got[0]["boxed"][0]
    del got
    pid = rt.get(producers[3].pid.remote())
    rt.kill(producers[3])
    assert _wait(lambda: _gone(pid), timeout=30)
    with pytest.raises(ObjectLostError):
        rt.get(ref, timeout=60)
