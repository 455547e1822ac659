"""The port's runtime (``ray_tpu_torch``'s copy of ``ray_tpu/_private``) on
one local cluster: the cases of ``tests/test_core.py`` run against it, torch
tensors through ``put``/``get`` and as task arguments and returns, the
device-object path's host half, and the control-plane daemons' import
hygiene (they never import torch)."""

import os
import subprocess
import sys
import tempfile
import textwrap
import time

import numpy as np
import pytest
import torch

import ray_tpu_torch as rt
from ray_tpu_torch._private import api as rt_api
from ray_tpu_torch._private import device_objects, serialization

# the copy reads only RAY_TPU_TORCH_* variables: quiet daemons, fast
# failure detection (as tests/conftest.py sets for the JAX runtime)
os.environ.setdefault("RAY_TPU_TORCH_LOG_LEVEL", "WARNING")


@pytest.fixture(scope="module")
def cluster():
    info = rt.init(num_cpus=32, num_gpus=0,
                   object_store_memory=256 * 1024 * 1024)
    yield info
    rt.shutdown()


@rt.remote
def add(a, b):
    return a + b


@rt.remote
def echo(x):
    return x


@rt.remote
def fail():
    raise ValueError("intentional")


@rt.remote
def nested(x):
    ref = echo.remote(x * 2)
    return rt.get(ref) + 1


@rt.remote
class Counter:
    def __init__(self, start=0):
        self.value = start

    def incr(self, by=1):
        self.value += by
        return self.value

    def get(self):
        return self.value


class TestTasks:
    def test_simple_task(self, cluster):
        assert rt.get(add.remote(1, 2), timeout=60) == 3

    def test_many_tasks(self, cluster):
        refs = [add.remote(i, i) for i in range(50)]
        assert rt.get(refs, timeout=60) == [2 * i for i in range(50)]

    def test_kwargs(self, cluster):
        assert rt.get(add.remote(a=10, b=5), timeout=60) == 15

    def test_large_object_through_store(self, cluster):
        arr = np.random.default_rng(0).standard_normal(500_000).astype(
            np.float32)
        out = rt.get(echo.remote(arr), timeout=60)
        np.testing.assert_array_equal(arr, out)

    def test_task_error_propagates(self, cluster):
        with pytest.raises(rt.TaskError) as ei:
            rt.get(fail.remote(), timeout=60)
        assert "intentional" in str(ei.value)
        assert isinstance(ei.value.cause, ValueError)

    def test_ref_as_arg(self, cluster):
        ref = add.remote(1, 1)
        assert rt.get(add.remote(ref, 10), timeout=60) == 12

    def test_nested_submission(self, cluster):
        assert rt.get(nested.remote(5), timeout=60) == 11

    def test_num_returns(self, cluster):
        @rt.remote(num_returns=3)
        def three():
            return 1, 2, 3

        a, b, c = three.remote()
        assert rt.get([a, b, c], timeout=60) == [1, 2, 3]

    def test_options_override(self, cluster):
        ref = add.options(num_cpus=2).remote(3, 4)
        assert rt.get(ref, timeout=60) == 7


class TestPutGetWait:
    def test_put_get_small(self, cluster):
        ref = rt.put({"k": 1})
        assert rt.get(ref, timeout=60) == {"k": 1}

    def test_put_get_large(self, cluster):
        arr = np.ones((1000, 500), dtype=np.float64)
        np.testing.assert_array_equal(rt.get(rt.put(arr), timeout=60), arr)

    def test_get_timeout(self, cluster):
        @rt.remote
        def slow():
            time.sleep(5)

        ref = slow.remote()
        with pytest.raises(rt.GetTimeoutError):
            rt.get(ref, timeout=0.5)

    def test_wait(self, cluster):
        @rt.remote
        def sleepy(t):
            time.sleep(t)
            return t

        fast = sleepy.remote(0.01)
        slow = sleepy.remote(5)
        done, pending = rt.wait([fast, slow], num_returns=1, timeout=10)
        assert done == [fast]
        assert pending == [slow]


class TestActors:
    def test_actor_roundtrip(self, cluster):
        c = Counter.remote(10)
        assert rt.get(c.incr.remote(), timeout=60) == 11
        assert rt.get(c.incr.remote(5), timeout=60) == 16
        assert rt.get(c.get.remote(), timeout=60) == 16

    def test_actor_ordering(self, cluster):
        c = Counter.remote()
        refs = [c.incr.remote() for _ in range(20)]
        assert rt.get(refs, timeout=60) == list(range(1, 21))

    def test_actor_init_error(self, cluster):
        @rt.remote
        class Broken:
            def __init__(self):
                raise RuntimeError("bad init")

            def ping(self):
                return "pong"

        b = Broken.remote()
        with pytest.raises((rt.TaskError, rt.ActorDiedError)):
            rt.get(b.ping.remote(), timeout=30)

    def test_named_actor(self, cluster):
        Counter.options(name="global_counter").remote(100)
        time.sleep(0.2)
        h = rt.get_actor("global_counter")
        assert rt.get(h.get.remote(), timeout=60) == 100

    def test_kill_actor(self, cluster):
        c = Counter.remote()
        assert rt.get(c.get.remote(), timeout=60) == 0
        rt.kill(c)
        with pytest.raises(rt.ActorDiedError):
            rt.get(c.get.remote(), timeout=30)

    def test_actor_handle_passing(self, cluster):
        c = Counter.remote()

        @rt.remote
        def use_handle(handle):
            return rt.get(handle.incr.remote(7))

        assert rt.get(use_handle.remote(c), timeout=60) == 7
        assert rt.get(c.get.remote(), timeout=60) == 7

    def test_async_actor(self, cluster):
        @rt.remote
        class AsyncWorker:
            async def work(self, x):
                import asyncio

                await asyncio.sleep(0.01)
                return x * 2

        w = AsyncWorker.remote()
        refs = [w.work.remote(i) for i in range(5)]
        assert rt.get(refs, timeout=60) == [0, 2, 4, 6, 8]

    def test_temporary_put_ref_as_actor_argument(self, cluster):
        """A ref the caller drops at once (Cls.remote(put(x))) stays
        readable until the actor's __init__ has resolved it."""
        c = Counter.remote(rt.put(np.arange(50_000.0)))
        assert rt.get(c.get.remote(), timeout=60).sum() == np.arange(
            50_000.0).sum()

    def test_actor_order_from_fresh_handle_burst(self, cluster):
        """Calls on a handle deserialized inside a task run in submission
        order, though the first waits on the actor-state lookup."""
        @rt.remote
        class Log:
            def __init__(self):
                self.seen = []

            def add(self, v):
                self.seen.append(v)
                return v

            def get_seen(self):
                return list(self.seen)

        @rt.remote
        def burst(handle):
            rt.get([handle.add.remote(i) for i in range(20)])
            return rt.get(handle.get_seen.remote())

        a = Log.remote()
        assert rt.get(burst.remote(a), timeout=60) == list(range(20))
        rt.kill(a)


class TestClusterInfo:
    def test_nodes_and_resources(self, cluster):
        assert len(rt.nodes()) >= 1
        res = rt.cluster_resources()
        assert res.get("CPU", 0) >= 4
        assert "GPU" not in res and "TPU" not in res

    def test_runtime_context(self, cluster):
        assert rt.get_runtime_context().job_id

        @rt.remote
        def whoami():
            c = rt.get_runtime_context()
            return (c.worker_id, c.node_id, c.get_gpu_ids(),
                    os.environ.get("CUDA_VISIBLE_DEVICES"))

        wid, nid, gpus, visible = rt.get(whoami.remote(), timeout=60)
        assert wid and nid
        # a worker that asked for no GPU sees none
        assert gpus == [] and visible == ""

    def test_fractional_gpus_refused(self, cluster):
        with pytest.raises(ValueError, match="whole GPUs"):
            add.options(num_gpus=0.5).remote(1, 2)

    def test_unported_branches_raise(self, cluster):
        with pytest.raises(NotImplementedError, match="A4"):
            add.bind(1, 2)
        with pytest.raises(NotImplementedError, match="A4"):
            Counter.remote().incr.bind()

    def test_placement_group_option_raises(self, cluster):
        with pytest.raises(NotImplementedError, match="A8"):
            add.options(placement_group=object()).remote(1, 2)


# --- torch tensors through the object store ------------------------------

def _tensor(kind: str) -> torch.Tensor:
    g = torch.Generator().manual_seed(0)
    if kind == "float32":  # past the inline limit: through the arena
        return torch.randn(300_000, generator=g)
    if kind == "bfloat16":
        return torch.randn(257, 129, generator=g).to(torch.bfloat16)
    if kind == "view":  # a non-contiguous view of a larger tensor
        return torch.randn(64, 96, generator=g)[::2, 3:80].t()
    if kind == "scalar":
        return torch.tensor(3.25, dtype=torch.float64)
    raise ValueError(kind)


def _same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    def raw(t):
        return t.contiguous().reshape(-1).view(torch.uint8)

    return (a.dtype == b.dtype and a.shape == b.shape
            and torch.equal(raw(a), raw(b)))


@rt.remote
def _tensor_stats(t):
    return (str(t.dtype), tuple(t.shape), t.is_contiguous(),
            t.device.type, (t.float() * 2).sum().item())


@rt.remote
def _tensor_twice(t):
    return t * 2


KINDS = ["float32", "bfloat16", "view", "scalar"]


class TestTensors:
    @pytest.mark.parametrize("kind", KINDS)
    def test_put_get_bit_for_bit(self, cluster, kind):
        t = _tensor(kind)
        out = rt.get(rt.put(t), timeout=60)
        assert isinstance(out, torch.Tensor) and out.device.type == "cpu"
        assert _same_bits(out, t)
        out.add_(1)  # a private, writable tensor: the stored copy is intact
        assert _same_bits(rt.get(rt.put(t), timeout=60), t)

    @pytest.mark.parametrize("kind", KINDS)
    def test_task_argument_and_return(self, cluster, kind):
        t = _tensor(kind)
        dtype, shape, contiguous, dev, total = rt.get(
            _tensor_stats.remote(t), timeout=60)
        assert (dtype, shape, dev) == (str(t.dtype), tuple(t.shape), "cpu")
        assert contiguous
        assert total == pytest.approx((t.float() * 2).sum().item(),
                                      rel=1e-6)
        assert _same_bits(rt.get(_tensor_twice.remote(t), timeout=60),
                          t * 2)

    def test_tensor_in_a_container_and_grad_detached(self, cluster):
        w = torch.randn(4, 4, requires_grad=True)
        out = rt.get(rt.put({"w": w, "b": [torch.zeros(3)]}), timeout=60)
        assert not out["w"].requires_grad
        assert torch.equal(out["w"], w.detach())
        assert torch.equal(out["b"][0], torch.zeros(3))

    def test_serialization_round_trip_without_the_cluster(self):
        t = _tensor("bfloat16")
        meta, buffers = serialization.serialize(t)
        assert len(buffers) == 1  # the bytes go out of band
        assert _same_bits(serialization.unpack(
            serialization.pack_parts(meta, buffers)), t)
        assert _same_bits(serialization.loads(serialization.dumps(t)), t)
        empty = torch.empty(0, 5, dtype=torch.bfloat16)
        back = serialization.loads(serialization.dumps(empty))
        assert back.shape == (0, 5) and back.dtype == torch.bfloat16


class TestDeviceObjectsHostHalf:
    """The device-object path's host side on CPU tensors: metadata, chunked
    staging reads and assembly (which lands on the CPU in a process that
    sees no card). A CUDA tensor's put and get run in chip_smoke.py."""

    def test_cpu_tensor_is_not_a_device_array(self):
        assert not device_objects.is_device_array(torch.zeros(3))
        assert not device_objects.is_device_array(np.zeros(3))

    @pytest.mark.parametrize("kind", ["bfloat16", "view", "scalar"])
    def test_registry_read_then_assemble(self, kind):
        t = _tensor(kind)
        reg = device_objects.DeviceObjectRegistry()
        meta = reg.put("oid", t)
        assert meta.nbytes == t.numel() * t.element_size()
        (key, nbytes), = meta.shards
        chunk = 1000
        parts = [reg.read("oid", key, off, chunk)
                 for off in range(0, nbytes, chunk)]
        out = device_objects.assemble(meta, {key: b"".join(parts)})
        assert out.device.type == "cpu" and _same_bits(out, t)
        assert reg.drop("oid") and len(reg) == 0


def _as_device_array(value) -> bool:
    # CPU tensors stand in for CUDA ones: the device-object path's
    # bookkeeping is the same, only the card is missing
    return isinstance(value, torch.Tensor)


@rt.remote
class _DeviceReturner:
    """Returns a tensor it keeps and writes afterwards, with its process's
    device-object test switched on (a large return then stays with this
    worker, as a CUDA tensor's does)."""

    def __init__(self):
        device_objects.is_device_array = _as_device_array
        self.t = _tensor("float32")

    def give(self):
        return self.t

    def bump(self):
        self.t.add_(1)
        return True


class TestDeviceObjectSnapshots:
    """A put or returned device tensor is a snapshot: torch tensors can be
    written in place, so a write to the source after ``put`` (or after
    the return), or to the owner's ``get`` result, never reaches the
    object, in this process or in another one that fetches it."""

    def test_snapshot_is_a_private_copy(self):
        t = _tensor("view")
        s = device_objects.snapshot(t)
        assert _same_bits(s, t) and s.data_ptr() != t.data_ptr()
        want = t.clone()
        t.add_(1)
        assert _same_bits(s, want)

    def test_put_then_write_the_source(self, cluster, monkeypatch):
        monkeypatch.setattr(device_objects, "is_device_array",
                            _as_device_array)
        t = _tensor("float32")
        want = t.clone()
        n0 = len(rt_api._core.device_objects)
        ref = rt.put(t)
        assert len(rt_api._core.device_objects) == n0 + 1
        t.add_(1)
        mine = rt.get(ref, timeout=60)
        assert _same_bits(mine, want)
        mine.zero_()  # the owner's result is private too
        assert _same_bits(rt.get(ref, timeout=60), want)
        # another process fetches the owner's copy through the registry
        assert _same_bits(rt.get(_tensor_twice.remote(ref), timeout=60),
                          want * 2)

    def test_large_return_then_write_it(self, cluster):
        a = _DeviceReturner.remote()
        try:
            ref = a.give.remote()
            assert rt.get(a.bump.remote(), timeout=60)
            assert _same_bits(rt.get(ref, timeout=60), _tensor("float32"))
        finally:
            rt.kill(a)


def test_spans_outside_a_session_go_under_the_temp_root(monkeypatch,
                                                       tmp_path):
    """With no session, spans land under this process's temporary
    directory (where sessions live, node.py), never a fixed /tmp path."""
    from ray_tpu_torch.util import tracing

    monkeypatch.delenv("RAY_TPU_TORCH_SESSION_DIR", raising=False)
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    root = str(tmp_path / "ray_tpu_torch")
    assert tracing._spans_path().startswith(root + os.sep)
    with open(tracing._spans_path(), "w") as f:
        f.write('{"name": "probe", "start_s": 0}\n')
    assert [s["name"] for s in tracing.collect_spans()] == ["probe"]


def _daemon_maps(pid: int) -> str:
    with open(f"/proc/{pid}/maps") as f:
        return f.read()


def test_daemons_never_import_torch(cluster):
    """The controller and the supervisor carry tensors' bytes but never
    load torch (the counterpart of "control-plane daemons never import
    jax"), after tensors went through the arena, task arguments and an
    actor's constructor."""
    big = torch.randn(200_000)
    assert _same_bits(rt.get(rt.put(big), timeout=60), big)
    assert _same_bits(rt.get(_tensor_twice.remote(big), timeout=60), big * 2)
    c = Counter.remote(torch.tensor(5.0))
    assert rt.get(c.incr.remote(), timeout=60).item() == 6.0
    node = rt_api._node_handle
    for proc in (node.controller_proc, node.supervisor_proc):
        maps = _daemon_maps(proc.pid)
        assert "libtorch" not in maps and "torch/_C" not in maps, proc.args


def test_no_destroyed_task_warnings():
    """shutdown() drains every pending loop task, so asyncio never reports
    'Task was destroyed but it is pending!'."""
    script = textwrap.dedent("""
        import ray_tpu_torch as rt

        rt.init(num_cpus=4, num_gpus=0, object_store_memory=64 * 1024 * 1024)

        @rt.remote
        def f(x):
            return x * 2

        @rt.remote
        class A:
            def m(self):
                return 1

        a = A.remote()
        assert rt.get(f.remote(21), timeout=60) == 42
        assert rt.get(a.m.remote(), timeout=60) == 1

        @rt.remote
        def gen():
            yield 1
            yield 2

        g = gen.options(num_returns="streaming").remote()
        assert rt.get(next(g), timeout=60) == 1  # stream left half-consumed
        rt.shutdown()
        print("CLEAN_EXIT")
    """)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", script], cwd=root,
                         capture_output=True, text=True, timeout=120)
    combined = out.stdout + out.stderr
    assert "CLEAN_EXIT" in combined, combined[-2000:]
    assert "Task was destroyed" not in combined, combined[-2000:]
