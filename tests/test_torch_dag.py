"""The port's DAG API (``ray_tpu_torch.dag``: ``.bind`` graphs and
compiled graphs over shared-memory channels) on a CPU cluster.

Twins of ``tests/test_dag_workflow.py``'s DAG cases and
``test_experimental_compile``, of ``tests/test_compiled_dag.py``
(``TestCompiledChain``, the channel-header guards and slot-ring cases,
which the port's tests lacked, ``TestZeroCopyAndCounters`` with zero
control RPCs over steady-state steps, ``TestFailureUnwinding``,
``test_compiled_dag_pipelines_at_depth``) and of
``tests/test_compiled_dag_cluster.py`` (a cross-node edge, a chaos crash
point). Those two build their own clusters and run first, before the
module's cluster starts.

Tensors on channels: a bf16 tensor through a compiled chain comes back to
the driver as a CPU tensor, bit for bit (the port's serialization carries
raw bytes). Parity: a compiled llama_debug float32 train-step actor,
started from JAX's ``init_params`` through ``_private/convert.py``,
returns losses within rtol 1e-5 of JAX's ``make_train_step`` on the same
batches, and equal to the same actor class driven dynamically.

Compiled actors are dedicated: the run loop occupies the actor until
teardown, so each test uses fresh actors and kills them afterwards.
"""

import gc
import os
import struct
import sys
import threading
import time
import types

import cloudpickle
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ray_tpu_torch as rt
from ray_tpu.models import training as jtraining
from ray_tpu_torch._private import channels
from ray_tpu_torch._private.exceptions import ActorDiedError, TaskError
from ray_tpu_torch.dag import (ChannelClosedError, DAGNode, InputNode,
                               MultiOutputNode)
from tests.test_torch_train import MODELS, _np
from tests.test_torch_runtime_cluster import \
    retire_leftover_jax_runtime_for_later_files

os.environ.setdefault("RAY_TPU_TORCH_LOG_LEVEL", "WARNING")
cloudpickle.register_pickle_by_value(sys.modules[__name__])

TIMEOUT = 60
LOSS_RTOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def _no_leftover_jax_runtime():
    """A JAX runtime that an earlier test file left up in this worker (JAX's
    serve router threads restart a shut one) is shut down after this file,
    so the next JAX file in the worker does not meet it (ROADMAP §C)."""
    yield
    retire_leftover_jax_runtime_for_later_files()


@rt.remote
class Stage:
    def __init__(self, k=1):
        self.k = k

    def mul(self, x):
        return x * self.k

    def add(self, a, b):
        return a + b

    def try_mutate(self, arr):
        try:
            arr[0] = 99.0
            return "mutated"
        except (ValueError, TypeError):
            return "readonly"

    def bump(self, t):
        return t + 1


@rt.remote
def _add(a, b):
    return a + b


@rt.remote
def _mul(a, b):
    return a * b


def _alive(*actors):
    rt.get([a.mul.remote(1) for a in actors], timeout=TIMEOUT)


def _store_pins(core):
    stats = core._run(core.clients.get(core.supervisor_addr).call(
        "store_stats"))
    return stats["pins_total"]


# ---------------------------------------- own clusters (run before `cluster`)


@pytest.fixture
def own_cluster():
    from ray_tpu_torch.cluster_utils import Cluster

    assert not rt.is_initialized(), "runs before the module's cluster"
    c = Cluster()
    yield c
    if rt.is_initialized():
        rt.shutdown()
    c.shutdown()


def test_cross_node_edge_chunked_push(own_cluster):
    """A compiled edge between actors on different nodes rides the
    pre-established per-step push (chunked: payload >> chunk size)."""
    own_cluster.add_node(num_cpus=4, resources={"left": 10})
    own_cluster.add_node(num_cpus=4, resources={"right": 10})
    own_cluster.wait_for_nodes(2)
    rt.init(address=own_cluster.address,
            _system_config={"object_transfer_chunk_bytes": 65536})
    left = Stage.options(resources={"left": 1}).remote(2)
    right = Stage.options(resources={"right": 1}).remote(3)
    _alive(left, right)
    with InputNode() as inp:
        dag = right.mul.bind(left.mul.bind(inp))
    compiled = dag.experimental_compile()
    assert compiled.is_channel_backed
    try:
        # ~800 KB payload -> a dozen chunk frames per push
        arr = np.arange(100_000, dtype=np.float64)
        for i in range(4):
            out = rt.get(compiled.execute(arr + i), timeout=TIMEOUT)
            assert np.array_equal(out, (arr + i) * 6)
        # a tensor crosses the node boundary the same way
        t = torch.arange(50_000, dtype=torch.float32)
        assert torch.equal(rt.get(compiled.execute(t), timeout=TIMEOUT),
                           t * 6)
    finally:
        compiled.teardown()


@pytest.mark.chaos
def test_chaos_crash_point_kills_loop_deterministically():
    """The run loop is chaos-injectable: ``worker.channel_step:<n>``
    hard-exits a participant on its n-th iteration, and the graph unwinds
    with ChannelClosedError at the driver."""
    from ray_tpu_torch._private.config import Config
    from ray_tpu_torch.cluster_utils import Cluster

    assert not rt.is_initialized(), "runs before the module's cluster"
    cfg = Config.from_env()
    cfg.chaos_seed = 7  # enables chaos; probabilities stay 0
    cfg.chaos_crash_points = "worker.channel_step:3"
    cluster = Cluster(config=cfg)
    try:
        cluster.add_node(num_cpus=4)
        cluster.wait_for_nodes(1)
        rt.init(address=cluster.address)
        a, b = Stage.remote(2), Stage.remote(3)
        _alive(a, b)
        with InputNode() as inp:
            dag = b.mul.bind(a.mul.bind(inp))
        compiled = dag.experimental_compile()
        with pytest.raises((ChannelClosedError, ActorDiedError, TaskError)):
            for i in range(50):
                rt.get(compiled.execute(i), timeout=30)
        compiled.teardown()
    finally:
        if rt.is_initialized():
            rt.shutdown()
        cluster.shutdown()


# ------------------------------------------------------ the module cluster


@pytest.fixture(scope="module")
def cluster():
    rt.init(num_cpus=32, num_gpus=0, object_store_memory=256 * 1024 * 1024)
    yield
    rt.shutdown()


class TestDAG:
    def test_diamond_dag(self, cluster):
        with InputNode() as inp:
            left = _add.bind(inp, 1)
            right = _mul.bind(inp, 2)
            dag = _add.bind(left, right)
        # x=5: (5+1) + (5*2) = 16
        assert rt.get(dag.execute(5)) == 16
        # the same dag re-executes with fresh inputs
        assert rt.get(dag.execute(10)) == 31

    def test_shared_node_runs_once(self, cluster):
        @rt.remote
        def stamped(x):
            return (x, float(np.random.random()))

        @rt.remote
        def pair(a, b):
            return (a, b)

        with InputNode() as inp:
            shared = stamped.bind(inp)
            dag = MultiOutputNode([pair.bind(shared, shared), shared])
        pair_ref, shared_ref = dag.execute(1)
        a, b = rt.get(pair_ref)
        shared_val = rt.get(shared_ref)
        # all three views observed the SAME single execution
        assert a == b == shared_val
        assert shared_val[0] == 1

    def test_actor_method_dag(self, cluster):
        @rt.remote
        class Acc:
            def __init__(self):
                self.total = 0

            def add(self, x):
                self.total += x
                return self.total

        a = Acc.remote()
        with InputNode() as inp:
            dag = a.add.bind(_add.bind(inp, 1))
        assert rt.get(dag.execute(4)) == 5   # 4+1
        assert rt.get(dag.execute(10)) == 16  # stateful: 5 + 11
        rt.kill(a)

    def test_input_count_validated(self, cluster):
        with InputNode() as inp:
            dag = _add.bind(inp, 1)
        with pytest.raises(ValueError, match="input"):
            dag.execute()

    def test_experimental_compile_of_functions(self, cluster):
        """Function-node graphs freeze the topology once and run
        repeatedly with the same results as eager execute()."""

        @rt.remote
        def double(x):
            return x * 2

        with InputNode() as inp:
            d = double.bind(inp)
            dag = MultiOutputNode([_add.bind(d, inp), double.bind(d)])
        compiled = dag.experimental_compile()
        assert not compiled.is_channel_backed
        for i in range(5):
            assert rt.get(compiled.execute(i)) == [i * 2 + i, i * 4]
        with pytest.raises(ValueError, match="expects 1"):
            compiled.execute(1, 2)
        compiled.teardown()

    def test_compile_rejects_unknown_nodes(self, cluster):
        with pytest.raises(TypeError, match="cannot compile"):
            DAGNode().experimental_compile()


class TestCompiledChain:
    def test_parity_and_multi_step_reuse(self, cluster):
        a, b = Stage.remote(2), Stage.remote(3)
        _alive(a, b)
        with InputNode() as inp:
            dag = b.mul.bind(a.mul.bind(inp))
        # dynamic baseline BEFORE compiling (the loop dedicates the actors)
        assert [rt.get(dag.execute(i)) for i in range(3)] == [0, 6, 12]
        compiled = dag.experimental_compile()
        assert compiled.is_channel_backed
        try:
            for i in range(10):
                assert rt.get(compiled.execute(i)) == i * 6
            arr = np.arange(4096, dtype=np.float64)
            assert np.array_equal(compiled.execute(arr).get(), arr * 6)
        finally:
            compiled.teardown()
        rt.kill(a)
        rt.kill(b)

    def test_bf16_tensor_comes_back_on_the_cpu_bit_for_bit(self, cluster):
        a, b = Stage.remote(2), Stage.remote(1)
        _alive(a, b)
        with InputNode() as inp:
            dag = b.bump.bind(a.mul.bind(inp))
        compiled = dag.experimental_compile()
        try:
            gen = torch.Generator().manual_seed(0)
            x = torch.randn(64, 33, generator=gen).to(torch.bfloat16)
            for _ in range(3):
                out = rt.get(compiled.execute(x), timeout=TIMEOUT)
                assert out.device.type == "cpu"
                assert out.dtype == torch.bfloat16
                assert torch.equal(out.view(torch.int16),
                                   (x * 2 + 1).view(torch.int16))
        finally:
            compiled.teardown()
        rt.kill(a)
        rt.kill(b)

    def test_arity_validated_and_post_teardown_raises(self, cluster):
        a = Stage.remote(2)
        _alive(a)
        with InputNode() as inp:
            dag = a.mul.bind(inp)
        compiled = dag.experimental_compile()
        try:
            with pytest.raises(ValueError, match="expects 1"):
                compiled.execute(1, 2)
            assert rt.get(compiled.execute(4)) == 8
        finally:
            compiled.teardown()
        compiled.teardown()  # idempotent
        with pytest.raises(ChannelClosedError):
            compiled.execute(1)
        rt.kill(a)

    def test_multi_output_shared_edge_and_passthrough(self, cluster):
        """One producer feeding two consumers (two reader slots on one
        channel) plus an InputNode passthrough output."""
        a, b, c = Stage.remote(2), Stage.remote(3), Stage.remote(5)
        _alive(a, b, c)
        with InputNode() as inp:
            mid = a.mul.bind(inp)
            dag = MultiOutputNode([b.mul.bind(mid), c.mul.bind(mid), inp])
        compiled = dag.experimental_compile()
        assert compiled.is_channel_backed
        try:
            for i in range(5):
                assert rt.get(compiled.execute(i)) == [i * 6, i * 10, i]
        finally:
            compiled.teardown()
        for actor in (a, b, c):
            rt.kill(actor)

    def test_constants_and_kwargs(self, cluster):
        a = Stage.remote()
        _alive(a)
        with InputNode() as inp:
            dag = a.add.bind(inp, b=7)
        compiled = dag.experimental_compile()
        try:
            assert rt.get(compiled.execute(3)) == 10
        finally:
            compiled.teardown()
        rt.kill(a)

    def test_get_accepts_lists_with_compiled_refs(self, cluster):
        a = Stage.remote(2)
        _alive(a)
        with InputNode() as inp:
            dag = a.mul.bind(inp)
        compiled = dag.experimental_compile()
        try:
            r1 = compiled.execute(1)
            r2 = compiled.execute(2)
            obj = rt.put(41)
            assert rt.get([r1, obj, r2]) == [2, 41, 4]
        finally:
            compiled.teardown()
        rt.kill(a)

    def test_wide_fanout_falls_back_to_dynamic(self, cluster):
        """More same-node consumers than the header's ack slots: dynamic
        execution, never silently lost flow control."""
        producer = Stage.remote(2)
        consumers = [Stage.remote(k) for k in range(channels.MAX_READERS + 1)]
        _alive(producer, *consumers)
        with InputNode() as inp:
            mid = producer.mul.bind(inp)
            dag = MultiOutputNode([c.mul.bind(mid) for c in consumers])
        compiled = dag.experimental_compile()
        assert not compiled.is_channel_backed
        assert rt.get(compiled.execute(1)) == \
            [2 * k for k in range(channels.MAX_READERS + 1)]
        compiled.teardown()
        for actor in (producer, *consumers):
            rt.kill(actor)

    def test_teardown_drops_actor_subscriptions(self, cluster):
        from ray_tpu_torch._private import api

        core = api._core
        a = Stage.remote(2)
        _alive(a)
        hexid = a._actor_id.hex()
        baseline = len(core._pub_handlers.get("actor:" + hexid, []))
        for i in range(3):
            with InputNode() as inp:
                dag = a.mul.bind(inp)
            compiled = dag.experimental_compile()
            assert rt.get(compiled.execute(i)) == i * 2
            compiled.teardown()
        assert len(core._pub_handlers.get("actor:" + hexid, [])) == baseline
        rt.kill(a)

    def test_zero_input_graph_stays_dynamic(self, cluster):
        a = Stage.remote(2)
        _alive(a)
        compiled = a.mul.bind(3).experimental_compile()
        assert not compiled.is_channel_backed
        assert rt.get(compiled.execute()) == 6
        compiled.teardown()
        rt.kill(a)

    def test_function_dags_fall_back_to_dynamic(self, cluster):
        with InputNode() as inp:
            dag = _mul.bind(inp, 2)
        compiled = dag.experimental_compile()
        assert not compiled.is_channel_backed
        assert rt.get(compiled.execute(5)) == 10
        compiled.teardown()


# --------------------------------------------------- channel header cases


class _FakeArena:
    """Just enough of ArenaFile for header-level unit tests."""

    def __init__(self, size):
        self._buf = memoryview(bytearray(size))

    def view(self, offset, size):
        return self._buf[offset:offset + size]

    def write(self, offset, data):
        self._buf[offset:offset + len(data)] = data


class TestChannelHeaderGuards:
    def test_init_header_rejects_reader_overflow(self):
        arena = _FakeArena(channels.total_size(64))
        with pytest.raises(ValueError, match="reader slots"):
            channels.init_header(arena, 0, channels.MAX_READERS + 1)
        channels.init_header(arena, 0, channels.MAX_READERS)  # boundary

    def test_ack_slot_out_of_range_raises(self):
        arena = _FakeArena(channels.total_size(64))
        channels.init_header(arena, 0, 2)
        spec = channels.ChannelSpec(
            channel_id=b"\x01" * 16, node_addr=("h", 1), offset=0,
            size=channels.total_size(64), n_readers=2)
        ch = channels.LocalChannel(arena, spec)
        with pytest.raises(ValueError, match="out of range"):
            ch.ack(channels.MAX_READERS, 2)


class TestMultiSlotChannels:
    def _make(self, depth, n_readers=1, buf=64):
        size = channels.total_size(buf, depth)
        arena = _FakeArena(size)
        channels.init_header(arena, 0, n_readers, depth=depth)
        spec = channels.ChannelSpec(
            channel_id=b"\x07" * 16, node_addr=("h", 1), offset=0,
            size=size, n_readers=n_readers, depth=depth)
        return arena, spec, channels.LocalChannel(arena, spec)

    def test_depth1_header_is_byte_identical(self):
        arena, spec, ch = self._make(1)
        hdr = bytes(arena.view(0, channels.HEADER_SIZE))
        assert struct.unpack_from("<Q", hdr, 104)[0] == 0  # depth word
        assert ch.depth == 1 and ch.capacity == 64
        ch.write(b"abc", 2, timeout=1)
        hdr = bytes(arena.view(0, channels.HEADER_SIZE))
        assert struct.unpack_from("<Q", hdr, 16)[0] == 2   # version
        assert struct.unpack_from("<Q", hdr, 24)[0] == 3   # length
        assert bytes(arena.view(channels.HEADER_SIZE, 3)) == b"abc"

    def test_writer_blocks_only_when_all_slots_unacked(self):
        _, _, ch = self._make(3)
        for n in (2, 4, 6):
            ch.write(b"x%d" % n, n, timeout=1)
        with pytest.raises(TimeoutError):
            ch.write(b"x8", 8, timeout=0.1)
        ch.ack(0, 2)  # frees v2's slot only
        ch.write(b"x8", 8, timeout=1)
        with pytest.raises(TimeoutError):
            ch.write(b"x10", 10, timeout=0.1)

    def test_committed_slots_stay_readable_while_writer_runs_ahead(self):
        _, _, ch = self._make(4)
        for n in range(1, 5):
            ch.write(f"v{n}".encode(), 2 * n, timeout=1)
        for n in range(1, 5):
            assert bytes(ch.read(2 * n, timeout=1)) == f"v{n}".encode()
            ch.ack(0, 2 * n)
        ch.write(b"v5", 10, timeout=1)
        assert bytes(ch.read(10, timeout=1)) == b"v5"

    @pytest.mark.parametrize("depth", [1, 2, 4])
    def test_close_mid_wait_raises_at_every_depth(self, depth):
        _, _, ch = self._make(depth)
        for n in range(1, depth + 1):
            ch.write(b"p", 2 * n, timeout=1)
        errs = []

        def blocked_writer():
            try:
                ch.write(b"q", 2 * (depth + 1), timeout=10)
            except ChannelClosedError:
                errs.append("writer")

        def blocked_reader():
            try:
                ch.read(2 * (depth + 5), timeout=10)
            except ChannelClosedError:
                errs.append("reader")

        ts = [threading.Thread(target=blocked_writer),
              threading.Thread(target=blocked_reader)]
        for t in ts:
            t.start()
        time.sleep(0.1)
        ch.close()
        for t in ts:
            t.join(timeout=5)
        assert not any(t.is_alive() for t in ts)
        assert sorted(errs) == ["reader", "writer"]

    def test_mirror_push_dup_converges_per_slot(self):
        depth, buf = 2, 16
        size = channels.total_size(buf, depth)
        arena = _FakeArena(size)
        channels.init_header(arena, 0, 1, depth=depth)
        spec = channels.ChannelSpec(
            channel_id=b"\x08" * 16, node_addr=("h", 1), offset=0,
            size=size, n_readers=1, depth=depth)
        reader = channels.LocalChannel(arena, spec)
        assert channels.readers_ready(arena, 0, 2)
        channels.host_write_commit(arena, 0, size, b"push2", 2)
        assert channels.readers_ready(arena, 0, 4)  # second slot free
        channels.host_write_commit(arena, 0, size, b"push4", 4)
        assert not channels.readers_ready(arena, 0, 6)  # v2's slot, unacked
        _, committed, _ = channels.read_header(arena, 0)
        assert committed == 4 >= 2  # a duplicate v2 is dropped by dedup
        assert bytes(reader.read(2, timeout=1)) == b"push2"
        reader.ack(0, 2)
        assert bytes(reader.read(4, timeout=1)) == b"push4"
        reader.ack(0, 4)
        assert channels.readers_ready(arena, 0, 6)
        channels.host_write_chunk(arena, 0, size, 6, 0, b"chu")
        channels.host_write_chunk(arena, 0, size, 6, 3, b"nk6")
        channels.host_commit(arena, 0, size, 6, 6)
        assert bytes(reader.read(6, timeout=1)) == b"chunk6"

    def test_mirror_push_rejects_oversized_payload(self):
        size = channels.total_size(16, 2)
        spec = channels.ChannelSpec(
            channel_id=b"\x09" * 16, node_addr=("far", 1), offset=0,
            size=size, n_readers=1, depth=2)
        core = types.SimpleNamespace(config=types.SimpleNamespace(
            object_transfer_chunk_bytes=4, object_transfer_window=2,
            channel_remote_timeout_s=1.0))
        mw = channels.MirrorWriter(core, spec)
        assert mw.capacity == 16
        with pytest.raises(ValueError, match="exceeds"):
            mw.push(b"x" * 17, 2)

    def test_compiled_dag_pipelines_at_depth(self, cluster):
        """experimental_compile(depth=k) lets the driver run k steps
        ahead of the matching get()s, results ordered and correct."""
        a, b = Stage.remote(2), Stage.remote(3)
        _alive(a, b)
        with InputNode() as inp:
            dag = b.mul.bind(a.mul.bind(inp))
        compiled = dag.experimental_compile(depth=3)
        try:
            assert compiled.is_channel_backed
            assert compiled.channel_depth == 3
            refs = [compiled.execute(i) for i in range(3)]
            assert [r.get(timeout=30) for r in refs] == [0, 6, 12]
            refs = [compiled.execute(i) for i in range(10, 13)]
            assert rt.get(refs, timeout=30) == [60, 66, 72]
        finally:
            compiled.teardown()
        rt.kill(a)
        rt.kill(b)


# --------------------------------------------- zero copy, counters, failure


class TestZeroCopyAndCounters:
    def test_read_only_view_enforcement(self, cluster):
        a, b = Stage.remote(1), Stage.remote(1)
        _alive(a, b)
        with InputNode() as inp:
            dag = b.try_mutate.bind(a.mul.bind(inp))
        compiled = dag.experimental_compile()
        try:
            out = rt.get(compiled.execute(np.arange(100, dtype=np.float64)))
            assert out == "readonly"
        finally:
            compiled.teardown()
        rt.kill(a)
        rt.kill(b)

    @pytest.mark.perf
    def test_steady_state_step_is_zero_control_rpcs(self, cluster):
        """Once compiled, a step costs channel writes and reads, not RPCs:
        the driver's outbound-RPC counter stays put over a window of
        steps while the channel counters advance step for step."""
        from ray_tpu_torch._private.rpc import _m_client_calls

        a, b = Stage.remote(2), Stage.remote(3)
        _alive(a, b)
        with InputNode() as inp:
            dag = b.mul.bind(a.mul.bind(inp))
        compiled = dag.experimental_compile()
        try:
            for i in range(3):  # warm: loops installed, pins taken
                assert rt.get(compiled.execute(i)) == i * 6
            gc.collect()
            time.sleep(0.5)
            rpc_before = _m_client_calls.total()
            writes0 = channels._m_writes.total()
            reads0 = channels._m_reads.total()
            steps0 = channels._m_steps.total()
            n = 15
            for i in range(n):
                assert rt.get(compiled.execute(i)) == i * 6
            assert _m_client_calls.total() == rpc_before, (
                "steady-state compiled steps issued control-plane RPCs")
            assert channels._m_steps.total() == steps0 + n
            assert channels._m_writes.total() == writes0 + n
            assert channels._m_reads.total() == reads0 + n
        finally:
            compiled.teardown()
        rt.kill(a)
        rt.kill(b)

    def test_teardown_releases_pins(self, cluster):
        from ray_tpu_torch._private import api
        from ray_tpu_torch._private.core_worker import _m_pins

        core = api._core
        gc.collect()
        time.sleep(0.3)
        pins_before = _store_pins(core)
        gauge_before = _m_pins.value()
        a, b = Stage.remote(2), Stage.remote(3)
        _alive(a, b)
        with InputNode() as inp:
            dag = b.mul.bind(a.mul.bind(inp))
        compiled = dag.experimental_compile()
        for i in range(3):
            assert rt.get(compiled.execute(i)) == i * 6
        assert _store_pins(core) > pins_before  # channels are pinned
        compiled.teardown()
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline:
            if (_store_pins(core) == pins_before
                    and _m_pins.value() == gauge_before):
                break
            time.sleep(0.2)
        assert _store_pins(core) == pins_before, "store pins leaked"
        assert _m_pins.value() == gauge_before, "driver pin gauge leaked"
        rt.kill(a)
        rt.kill(b)


@pytest.mark.chaos
class TestFailureUnwinding:
    def test_participant_death_closes_all_peers(self, cluster):
        from ray_tpu_torch._private import api

        core = api._core
        gc.collect()
        time.sleep(0.3)
        pins_before = _store_pins(core)
        a, b = Stage.remote(2), Stage.remote(3)
        _alive(a, b)
        with InputNode() as inp:
            dag = b.mul.bind(a.mul.bind(inp))
        compiled = dag.experimental_compile()
        assert rt.get(compiled.execute(1)) == 6

        rt.kill(b)  # participant dies mid-loop

        with pytest.raises((ChannelClosedError, ActorDiedError)):
            deadline = time.monotonic() + 30
            i = 2
            while time.monotonic() < deadline:
                rt.get(compiled.execute(i), timeout=10)
                i += 1
        # the surviving peer's loop observed the close and exited cleanly
        surviving = compiled._graph._loop_refs[0]
        out = rt.get(surviving, timeout=30)
        assert isinstance(out, dict) and out["steps"] >= 1
        compiled.teardown()
        deadline = time.monotonic() + 15
        while time.monotonic() < deadline:
            if _store_pins(core) == pins_before:
                break
            time.sleep(0.2)
        assert _store_pins(core) == pins_before, (
            "pins leaked after participant death + teardown")
        rt.kill(a)


# ---------------------------------------------------------------- parity


@rt.remote
class Learner:
    """llama_debug's train step in an actor: the state converted from
    JAX's, AdamW, one step per call; returns the step's loss (taken
    before its update) and grad norm."""

    def __init__(self, cfg, ocfg, state_np):
        from ray_tpu_torch._private import convert
        from ray_tpu_torch.models import training

        self.state = convert.train_state_from_jax(state_np, device="cpu")
        self.step_fn = training.make_train_step(
            cfg, training.make_optimizer(ocfg))

    def step(self, tokens):
        self.state, m = self.step_fn(self.state, {"tokens": tokens})
        return [float(m["loss"]), float(m["grad_norm"])]


def test_compiled_llama_debug_train_step_parity_with_jax(cluster):
    from ray_tpu_torch.models import training

    jcfg_fn, cfg_fn = MODELS["llama_debug"]
    jcfg, cfg = jcfg_fn(ce_chunk=8), cfg_fn(ce_chunk=8)
    jocfg = jtraining.OptimizerConfig(learning_rate=1e-2, warmup_steps=2,
                                      decay_steps=8)
    jstate, jtx = jtraining.init_train_state(jcfg, jocfg,
                                             jax.random.PRNGKey(0))
    ocfg = training.OptimizerConfig(**jocfg.__dict__)
    rng = np.random.default_rng(9)
    batches = [torch.tensor(rng.integers(0, cfg.vocab_size, (2, 12)))
               for _ in range(5)]
    jstep = jtraining.make_train_step(jcfg, jtx, donate=False)
    want, s = [], jstate
    for b in batches:
        s, m = jstep(s, {"tokens": jnp.asarray(b.numpy())})
        want.append([float(m["loss"]), float(m["grad_norm"])])

    dyn, comp = (Learner.remote(cfg, ocfg, _np(jstate)) for _ in range(2))
    with InputNode() as inp:
        dag = dyn.step.bind(inp)
    dynamic = [rt.get(dag.execute(b), timeout=TIMEOUT) for b in batches]
    with InputNode() as inp:
        compiled = comp.step.bind(inp).experimental_compile()
    assert compiled.is_channel_backed
    try:
        got = [rt.get(compiled.execute(b), timeout=TIMEOUT) for b in batches]
    finally:
        compiled.teardown()
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL)
    assert got == dynamic  # the same process math, bit for bit
    rt.kill(dyn)
    rt.kill(comp)
