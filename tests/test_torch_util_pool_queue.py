"""The port's ``ray_tpu_torch.util.ActorPool`` and
``ray_tpu_torch.util.queue.Queue`` on a CPU cluster: the twins of
``tests/test_util_pool_queue.py``, plus the same pool and queue
operations run through the JAX package's on a JAX cluster, giving the
same results. The actor classes ship by value, so a worker never imports
this module (and with it JAX)."""

import os
import sys
import threading
import time

import cloudpickle
import pytest

import ray_tpu_torch as rt
from ray_tpu_torch.util import ActorPool
from ray_tpu_torch.util.queue import Empty, Full, Queue
from tests.test_torch_runtime_cluster import (
    retire_leftover_jax_runtime, retire_leftover_jax_runtime_for_later_files)

os.environ.setdefault("RAY_TPU_TORCH_LOG_LEVEL", "WARNING")
cloudpickle.register_pickle_by_value(sys.modules[__name__])

TIMEOUT = 60


class _Worker:
    def __init__(self, tag):
        self.tag = tag

    def work(self, x):
        return x * 2

    def slow(self, x):
        time.sleep(0.4 if x == 0 else 0.05)
        return x


Worker = rt.remote(_Worker)


@pytest.fixture(scope="module", autouse=True)
def _no_leftover_jax_runtime():
    yield
    retire_leftover_jax_runtime_for_later_files()


@pytest.fixture(scope="module")
def cluster():
    retire_leftover_jax_runtime()
    # virtual CPUs: the tests leave their actors up, each holding one
    rt.init(num_cpus=64, num_gpus=0, object_store_memory=64 * 1024 * 1024)
    yield
    rt.shutdown()


class TestActorPool:
    def test_map_ordered(self, cluster):
        pool = ActorPool([Worker.remote(i) for i in range(3)])
        out = list(pool.map(lambda a, v: a.work.remote(v), range(10)))
        assert out == [v * 2 for v in range(10)]

    def test_map_unordered_completion_order(self, cluster):
        pool = ActorPool([Worker.remote(i) for i in range(2)])
        out = list(pool.map_unordered(lambda a, v: a.slow.remote(v),
                                      [0, 1, 2, 3]))
        assert sorted(out) == [0, 1, 2, 3]
        # the slow task (x=0) must NOT block faster completions
        assert out[0] != 0

    def test_submit_get_next(self, cluster):
        pool = ActorPool([Worker.remote(0)])
        pool.submit(lambda a, v: a.work.remote(v), 1)
        pool.submit(lambda a, v: a.work.remote(v), 2)
        assert pool.has_next()
        assert pool.get_next() == 2
        assert pool.get_next() == 4
        assert not pool.has_next()
        with pytest.raises(StopIteration):
            pool.get_next()

    def test_push_pop_idle(self, cluster):
        a, b = Worker.remote(0), Worker.remote(1)
        pool = ActorPool([a])
        assert pool.has_free()
        popped = pool.pop_idle()
        assert popped is not None
        assert not pool.has_free()
        pool.push(b)
        out = list(pool.map(lambda w, v: w.work.remote(v), [5]))
        assert out == [10]

    def test_get_next_timeout_keeps_the_result(self, cluster):
        """A timed-out ``get_next`` consumes nothing: the same result comes
        back on the next call."""
        pool = ActorPool([Worker.remote(0)])
        pool.submit(lambda a, v: a.slow.remote(v), 0)  # sleeps 0.4 s
        with pytest.raises(TimeoutError):
            pool.get_next(timeout=0.01)
        assert pool.has_next()
        assert pool.get_next(timeout=TIMEOUT) == 0
        assert not pool.has_next()

    def test_ordered_after_unordered(self, cluster):
        """``get_next`` after ``map_unordered`` returns the earliest result
        still held (the JAX pool's cursor pointed at one already taken and
        raised ``KeyError``; ROADMAP §C)."""
        pool = ActorPool([Worker.remote(i) for i in range(2)])
        assert sorted(pool.map_unordered(lambda a, v: a.work.remote(v),
                                         range(5))) == [0, 2, 4, 6, 8]
        pool.submit(lambda a, v: a.slow.remote(v), 0)
        pool.submit(lambda a, v: a.work.remote(v), 7)
        assert pool.get_next(timeout=TIMEOUT) == 0
        assert pool.get_next(timeout=TIMEOUT) == 14
        assert not pool.has_next()

    def test_tensors_through_the_pool(self, cluster):
        """The port's values are tensors: each comes back whole."""
        import torch

        pool = ActorPool([Worker.remote(i) for i in range(2)])
        xs = [torch.arange(6, dtype=torch.float32) + i for i in range(4)]
        out = list(pool.map(lambda a, v: a.work.remote(v), xs))
        assert all(torch.equal(o, x * 2) for o, x in zip(out, xs))


class TestQueue:
    def test_fifo_roundtrip(self, cluster):
        q = Queue()
        for i in range(5):
            q.put(i)
        assert q.qsize() == 5
        assert [q.get() for _ in range(5)] == list(range(5))
        assert q.empty()
        q.shutdown()

    def test_nonblocking_and_timeouts(self, cluster):
        q = Queue(maxsize=2)
        q.put(1)
        q.put(2)
        assert q.full()
        with pytest.raises(Full):
            q.put_nowait(3)
        assert q.get(timeout=1) == 1
        q.get()
        with pytest.raises(Empty):
            q.get_nowait()
        t0 = time.monotonic()
        with pytest.raises(Empty):
            q.get(timeout=0.3)
        assert time.monotonic() - t0 < 5
        q.shutdown()

    def test_batch_ops(self, cluster):
        q = Queue()
        assert q.put_nowait_batch(list(range(7))) == 7
        assert q.get_nowait_batch(3) == [0, 1, 2]
        assert q.get_nowait_batch(100) == [3, 4, 5, 6]
        q.shutdown()

    def test_crosses_task_boundary(self, cluster):
        """The queue handle pickles to the same actor (producer task /
        consumer driver see one queue)."""
        q = Queue()

        @rt.remote
        def producer(queue, n):
            for i in range(n):
                queue.put(i * 10)
            return n

        assert rt.get(producer.remote(q, 4), timeout=TIMEOUT) == 4
        got = sorted(q.get() for _ in range(4))
        assert got == [0, 10, 20, 30]
        q.shutdown()

    def test_blocking_get_wakes_on_put(self, cluster):
        q = Queue()
        out = []

        def consumer():
            out.append(q.get(timeout=10))

        t = threading.Thread(target=consumer)
        t.start()
        time.sleep(0.2)
        q.put("wake")
        t.join(timeout=10)
        assert out == ["wake"]
        q.shutdown()

    def test_reexports_the_stdlib_exceptions(self):
        import queue as stdlib_queue

        from ray_tpu.util import queue as jqueue

        assert Empty is stdlib_queue.Empty is jqueue.Empty
        assert Full is stdlib_queue.Full is jqueue.Full


def _script(rt_mod, pool_cls, queue_cls):
    """One run of pool and queue operations, as plain values."""
    W = rt_mod.remote(_Worker)
    actors = [W.remote(i) for i in range(3)]
    pool = pool_cls(actors)
    ordered = list(pool.map(lambda a, v: a.work.remote(v), range(9)))
    pool.submit(lambda a, v: a.work.remote(v), 21)
    nxt = pool.get_next(timeout=TIMEOUT)
    unordered = sorted(pool.map_unordered(lambda a, v: a.work.remote(v),
                                          range(5)))
    q = queue_cls(maxsize=4)
    pushed = q.put_nowait_batch(list(range(6)))
    sizes = (q.qsize(), q.full(), q.empty())
    drained = q.get_nowait_batch(10)
    q.shutdown()
    for a in actors:
        rt_mod.kill(a)
    return ordered, unordered, nxt, pushed, sizes, drained


def test_same_results_as_the_jax_package(cluster):
    """The same operations through JAX's pool and queue on a JAX cluster
    and through the port's on this one give the same values."""
    import ray_tpu
    from ray_tpu.util import ActorPool as JaxActorPool
    from ray_tpu.util.queue import Queue as JaxQueue

    port = _script(rt, ActorPool, Queue)
    retire_leftover_jax_runtime()
    ray_tpu.init(num_cpus=8, object_store_memory=64 * 1024 * 1024)
    try:
        jax_out = _script(ray_tpu, JaxActorPool, JaxQueue)
    finally:
        ray_tpu.shutdown()
    assert port == jax_out
    assert port[0] == [2 * v for v in range(9)] and port[3] == 4
