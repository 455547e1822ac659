"""Lazy task DAGs: build with `.bind()`, run with `.execute()`.

Analog of `ray.dag` (`python/ray/dag/dag_node.py`, function nodes
`function_node.py`, input `input_node.py`): `fn.bind(...)` records a node
instead of submitting; nodes compose into a graph whose edges become
ObjectRef data dependencies at execution time — upstream results stream
to downstream tasks through the object layer without materializing on
the driver. `InputNode` marks runtime inputs; `MultiOutputNode` bundles
several leaves.

`experimental_compile()` provisions REAL compiled execution for
all-actor-method graphs (≈ the reference's accelerated DAG,
`compiled_dag_node.py:279`): every edge becomes a mutable shared-memory
channel allocated ONCE in the node arenas (`_private/channels.py`), and
each participating actor runs a per-actor execution loop (read input
channels -> run method -> write output channel). A steady-state
`execute()` is then one input-channel write plus one output-channel read
— ZERO control-plane RPCs, which is the per-step overhead the dynamic
path pays in lease/push/report rounds (~ms per hop). Cross-node edges
ride a pre-established per-step push over the chunked-transfer window.

Graphs containing plain function nodes (no resident actor to loop on)
keep the earlier behavior: compilation freezes/validates the topology
and `execute()` submits through the normal task path.

Failure semantics: tearing down the graph — or the death of any
participant actor/node — closes every channel; peers blocked on a
channel raise `ChannelClosedError` instead of hanging, and the channels'
arena pins are released through the per-client pin accounting.

Counterpart: ``ray_tpu/dag/__init__.py``. A tensor on a channel (an
input, a stage's return) goes through the port's serialization, which
copies a CUDA tensor to the host and rebuilds it on the CPU: a stage that
computes on its card moves what it reads onto its own device, and what
the driver reads back is a CPU tensor.
"""

from __future__ import annotations

import collections
import logging
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

from ray_tpu_torch._private import channels as _channels
from ray_tpu_torch._private import serialization
from ray_tpu_torch._private.exceptions import ChannelClosedError

__all__ = ["CompiledDAG", "CompiledDAGRef", "ChannelClosedError", "DAGNode",
           "FunctionNode", "InputNode", "MultiOutputNode"]

logger = logging.getLogger(__name__)

_DRIVER = "__driver__"  # consumer marker for driver-read channels


class DAGNode:
    """Base: anything executable in a DAG."""

    def execute(self, *input_values) -> Any:
        """Run the graph; returns ObjectRef(s) for this node's output."""
        cache: Dict[int, Any] = {}
        n = _count_inputs(self)
        if n and len(input_values) != n:
            raise ValueError(
                f"DAG expects {n} input(s), got {len(input_values)}")
        return _resolve(self, list(input_values), cache)

    def experimental_compile(
            self, buffer_size_bytes: Optional[int] = None,
            depth: Optional[int] = None) -> "CompiledDAG":
        """≈ `ray.dag.DAGNode.experimental_compile` (compiled_dag_node.py:279).

        All-actor-method graphs compile to mutable shared-memory channels
        plus per-actor run loops (see module docstring); ``buffer_size_bytes``
        overrides the per-channel payload capacity
        (``Config.channel_buffer_bytes``) and ``depth`` the slot-ring
        capacity (``Config.channel_depth`` / ``RAY_TPU_TORCH_CHANNEL_DEPTH``;
        at depth k the driver may run k ``execute()`` calls ahead of the
        matching ``get()``s before blocking). Graphs with plain function
        nodes freeze/validate the topology and execute dynamically."""
        return CompiledDAG(self, buffer_size_bytes=buffer_size_bytes,
                           depth=depth)


class CompiledDAG:
    """A compiled DAG: channel-backed for all-actor graphs, frozen
    topology otherwise. Call ``execute(*inputs)`` repeatedly; call
    ``teardown()`` to release channels and stop the actor loops."""

    def __init__(self, root: DAGNode,
                 buffer_size_bytes: Optional[int] = None,
                 depth: Optional[int] = None):
        # validate the EXPLICIT knob here, before the channel-compile
        # try/except: inside it, a bad value would demote to the dynamic
        # path with only a warning instead of telling the caller
        if depth is not None and int(depth) < 1:
            raise ValueError(f"channel depth must be >= 1 (got {depth})")
        self._root = root
        # walk once: compute input arity AND reject unsupported node types
        # now, not at the first execute()
        known = (InputNode, MultiOutputNode, FunctionNode, ClassMethodNode)
        stack, seen = [root], set()
        nodes: List[DAGNode] = []
        while stack:
            node = stack.pop()
            if id(node) in seen:
                continue
            seen.add(id(node))
            if not isinstance(node, known):
                raise TypeError(
                    f"cannot compile DAG containing {type(node).__name__}")
            nodes.append(node)
            stack.extend(_children(node))
        self._n_inputs = _count_inputs(root)
        self._graph: Optional[_ChannelGraph] = None
        # zero-InputNode graphs stay dynamic: a channel run loop with no
        # input channel to block on would free-run its (possibly
        # side-effecting) methods ahead of execute()/get() instead of
        # once per execute()
        if self._n_inputs > 0 and _channel_eligible(root, nodes):
            try:
                self._graph = _ChannelGraph(
                    root, self._n_inputs, buffer_size_bytes, depth)
            except ChannelClosedError:
                raise
            except Exception as e:  # noqa: BLE001 — degrade, don't break
                logger.warning(
                    "channel compilation unavailable (%r); falling back "
                    "to dynamic execution", e)
                self._graph = None

    @property
    def is_channel_backed(self) -> bool:
        return self._graph is not None

    @property
    def channel_depth(self) -> int:
        """Slot-ring depth of the compiled channels (0 when dynamic)."""
        return self._graph._depth if self._graph is not None else 0

    def execute(self, *input_values) -> Any:
        if self._n_inputs and len(input_values) != self._n_inputs:
            raise ValueError(
                f"compiled DAG expects {self._n_inputs} input(s), got "
                f"{len(input_values)}")
        if self._graph is not None:
            # no CompiledDAG-level lock here: execute can block on the
            # channel backpressure, and a concurrent teardown (whose
            # close is what would unblock it) must never wait behind it
            return self._graph.execute(input_values)
        return _resolve(self._root, list(input_values), {})

    def teardown(self) -> None:
        """Close every channel, stop the actor loops, release the pins.
        No-op for topology-only compilations and on repeat calls."""
        if self._graph is not None:
            self._graph.teardown()

    def __del__(self):
        try:
            self.teardown()
        except Exception:
            pass


class CompiledDAGRef:
    """Future for one compiled-graph step (≈ ray.CompiledDAGRef): resolve
    with ``.get()`` or ``ray_tpu_torch.get()``. Steps resolve in order — getting
    step N first consumes (and caches) any earlier unconsumed steps."""

    _is_compiled_dag_ref = True

    __slots__ = ("_graph", "_step", "_value", "_has_value")

    def __init__(self, graph: "_ChannelGraph", step: int):
        self._graph = graph
        self._step = step
        self._value = None
        self._has_value = False

    def get(self, timeout: Optional[float] = None) -> Any:
        if not self._has_value:
            self._value = self._graph.consume(self._step, timeout)
            self._has_value = True
        return self._value

    def __repr__(self) -> str:
        return f"CompiledDAGRef(step={self._step})"

    def __del__(self):
        if not self._has_value:
            try:
                self._graph.abandon(self._step)
            except Exception:
                pass


class InputNode(DAGNode):
    """Placeholder bound at execute() time (≈ ray.dag.InputNode).

    Supports the context-manager style of the reference:
        with InputNode() as inp:
            dag = f.bind(inp)
    """

    def __init__(self, index: int = 0):
        self.index = index

    def __enter__(self) -> "InputNode":
        return self

    def __exit__(self, *exc) -> None:
        return None


class FunctionNode(DAGNode):
    """One remote-function invocation with possibly-lazy arguments."""

    def __init__(self, remote_fn, args: Tuple, kwargs: Dict[str, Any]):
        self._fn = remote_fn
        self._args = args
        self._kwargs = kwargs


class ClassMethodNode(DAGNode):
    """One actor-method invocation with possibly-lazy arguments."""

    def __init__(self, actor_method, args: Tuple, kwargs: Dict[str, Any]):
        self._method = actor_method
        self._args = args
        self._kwargs = kwargs


class MultiOutputNode(DAGNode):
    """Bundle several DAG leaves; execute() returns a list of refs."""

    def __init__(self, outputs: List[DAGNode]):
        self._outputs = list(outputs)


def _children(node: DAGNode):
    if isinstance(node, (FunctionNode, ClassMethodNode)):
        for a in list(node._args) + list(node._kwargs.values()):
            if isinstance(a, DAGNode):
                yield a
    elif isinstance(node, MultiOutputNode):
        yield from node._outputs


def _count_inputs(node: DAGNode, seen=None) -> int:
    seen = seen if seen is not None else set()
    if id(node) in seen:
        return 0
    seen.add(id(node))
    best = node.index + 1 if isinstance(node, InputNode) else 0
    for c in _children(node):
        best = max(best, _count_inputs(c, seen))
    return best


def _resolve(node: DAGNode, inputs: List[Any], cache: Dict[int, Any]):
    if id(node) in cache:
        return cache[id(node)]
    if isinstance(node, InputNode):
        out = inputs[node.index]
    elif isinstance(node, MultiOutputNode):
        out = [_resolve(c, inputs, cache) for c in node._outputs]
    elif isinstance(node, (FunctionNode, ClassMethodNode)):
        args = tuple(
            _resolve(a, inputs, cache) if isinstance(a, DAGNode) else a
            for a in node._args)
        kwargs = {
            k: _resolve(v, inputs, cache) if isinstance(v, DAGNode) else v
            for k, v in node._kwargs.items()}
        target = node._fn if isinstance(node, FunctionNode) else node._method
        out = target.remote(*args, **kwargs)
    else:
        raise TypeError(f"not a DAG node: {node!r}")
    cache[id(node)] = out
    return out


# --------------------------------------------------- channel-backed compile


def _channel_eligible(root: DAGNode, nodes: List[DAGNode]) -> bool:
    """Channel compilation needs resident actors for the run loops (plain
    functions have no process to park a loop in) and a driver attached to
    a node arena. The root must be a method node or a bundle of
    method/input nodes."""
    from ray_tpu_torch._private import api

    if api._core is None or api._core.arena is None \
            or api._core.supervisor_addr is None:
        return False
    if isinstance(root, MultiOutputNode):
        if not root._outputs or not all(
                isinstance(o, (ClassMethodNode, InputNode))
                for o in root._outputs):
            return False
    elif not isinstance(root, ClassMethodNode):
        return False
    has_stage = False
    for n in nodes:
        if isinstance(n, FunctionNode):
            return False
        if isinstance(n, ClassMethodNode):
            has_stage = True
    return has_stage


class _ChannelGraph:
    """Driver-side state of one channel-compiled DAG: the allocated
    channels, the per-actor loop tasks, and the step cursors."""

    def __init__(self, root: DAGNode, n_inputs: int,
                 buffer_size_bytes: Optional[int],
                 depth: Optional[int] = None):
        from ray_tpu_torch._private import api
        from ray_tpu_torch._private.core_worker import _m_pins

        core = api._require_core()
        self._core = core
        self._m_pins = _m_pins
        self._buffer = int(buffer_size_bytes
                           or core.config.channel_buffer_bytes)
        self._depth = int(depth if depth is not None
                          else (core.config.channel_depth or 1))
        if self._depth < 1:
            raise ValueError(f"channel depth must be >= 1 "
                             f"(got {self._depth})")
        self._n_inputs = n_inputs
        self._multi_output = isinstance(root, MultiOutputNode)
        self._outputs = root._outputs if self._multi_output else [root]
        self._driver_node = tuple(core.supervisor_addr)

        # ---- stages in topological order (postorder DFS)
        stages: List[ClassMethodNode] = []
        seen: set = set()

        def visit(node: DAGNode) -> None:
            if id(node) in seen:
                return
            seen.add(id(node))
            for c in _children(node):
                visit(c)
            if isinstance(node, ClassMethodNode):
                stages.append(node)

        visit(root)
        self._stages = stages

        # ---- consumers per producer (stage or input), deduped
        def pkey(node: DAGNode):
            return ("in", node.index) if isinstance(node, InputNode) \
                else ("st", id(node))

        consumers: Dict[tuple, List[Any]] = {}
        for idx in range(n_inputs):
            consumers[("in", idx)] = []
        for st in stages:
            consumers.setdefault(("st", id(st)), [])
        for st in stages:
            for a in list(st._args) + list(st._kwargs.values()):
                if isinstance(a, DAGNode):
                    if isinstance(a, MultiOutputNode):
                        raise TypeError(
                            "MultiOutputNode is only valid at the DAG root")
                    key = pkey(a)
                    if st not in consumers[key]:
                        consumers[key].append(st)
        for out in self._outputs:
            if isinstance(out, ClassMethodNode):
                key = pkey(out)
                if _DRIVER not in consumers[key]:
                    consumers[key].append(_DRIVER)

        # ---- resolve participating actors (node + worker identity)
        self._actor_info: Dict[str, dict] = {}
        for st in stages:
            hexid = st._method._handle._actor_id.hex()
            if hexid not in self._actor_info:
                self._actor_info[hexid] = self._resolve_actor(
                    st._method._handle._actor_id)

        def stage_node(st: ClassMethodNode) -> Tuple[str, int]:
            return self._actor_info[
                st._method._handle._actor_id.hex()]["node_addr"]

        # ---- per-node fan-out is bounded by the header's ack-slot array;
        # reject BEFORE allocating anything so a too-wide graph degrades
        # to dynamic execution instead of silently losing flow control
        # (or leaking pins from a partially built graph)
        for key, cons in consumers.items():
            per_node: Dict[tuple, int] = {}
            for c in cons:
                node = self._driver_node if c is _DRIVER else stage_node(c)
                per_node[node] = per_node.get(node, 0) + 1
            wide = max(per_node.values(), default=0)
            if wide > _channels.MAX_READERS:
                raise ValueError(
                    f"compiled-graph fan-out of {wide} same-node consumers "
                    f"exceeds the channel reader limit "
                    f"({_channels.MAX_READERS})")

        # ---- teardown-able state FIRST: any failure past this point
        # (an allocation RPC, a loop submit, a const materialization)
        # unwinds through teardown() so no channel stays pinned and no
        # actor stays dedicated to a half-installed loop — the dynamic
        # fallback would otherwise queue behind that loop forever
        self._all_specs: List[_channels.ChannelSpec] = []
        self._local_channels: Dict[bytes, _channels.LocalChannel] = {}
        self._loop_refs: List[Any] = []
        self._dead = False
        self._step = 0
        self._consumed = 0
        self._results: Dict[int, Any] = {}
        self._abandoned: set = set()
        self._pending_abandon: collections.deque = collections.deque()
        self._inputs_by_step: Dict[int, tuple] = {}
        # separate locks: an execute() blocked on channel backpressure
        # must not deadlock the get() (or teardown) that would unblock it
        self._exec_lock = threading.RLock()
        self._consume_lock = threading.RLock()
        self._teardown_lock = threading.Lock()
        try:
            self._build(core, consumers, stages, stage_node, pkey)
        except BaseException:
            try:
                self.teardown()
            except Exception:
                logger.debug("partial-compile unwind failed",
                             exc_info=True)
            raise

    def _build(self, core, consumers, stages, stage_node, pkey) -> None:
        from ray_tpu_torch._private import api

        n_inputs = self._n_inputs
        # ---- allocate channels: one per (producer, node-with-readers),
        # plus the producer's own node (its loop/driver writes there)
        # (producer key, consumer ident) -> (spec, slot)
        chan_of: Dict[tuple, Tuple[_channels.ChannelSpec, int]] = {}
        out_channels: Dict[tuple, _channels.ChannelSpec] = {}
        out_mirrors: Dict[tuple, List[_channels.ChannelSpec]] = {}

        for key, cons in consumers.items():
            if key[0] == "st":
                st = next(s for s in stages if id(s) == key[1])
                p_node = stage_node(st)
                p_info = self._actor_info[
                    st._method._handle._actor_id.hex()]
            else:
                p_node, p_info = self._driver_node, None
            readers_by_node: Dict[tuple, List[Any]] = {}
            for c in cons:
                node = self._driver_node if c is _DRIVER else stage_node(c)
                readers_by_node.setdefault(node, []).append(c)
            # no channel on the producer's own node unless someone reads
            # there: mirrors push the payload directly, so a reader-less
            # local channel would only burn a pinned arena range and a
            # per-step memcpy
            mirrors: List[_channels.ChannelSpec] = []
            for node, readers in readers_by_node.items():
                participants = {core._store_client_id}
                if p_info is not None:
                    participants.add(
                        p_info["worker_id_hex"] if node == p_node
                        else f"node:{p_info['node_id_hex']}")
                for c in readers:
                    if c is not _DRIVER:
                        participants.add(self._actor_info[
                            c._method._handle._actor_id.hex()
                        ]["worker_id_hex"])
                spec = self._create_channel(
                    node, len(readers), participants)
                self._all_specs.append(spec)
                for slot, c in enumerate(readers):
                    ident = _DRIVER if c is _DRIVER else id(c)
                    chan_of[(key, ident)] = (spec, slot)
                if node == p_node:
                    out_channels[key] = spec
                else:
                    mirrors.append(spec)
                if node == self._driver_node:
                    self._local_channels[spec.key()] = \
                        _channels.LocalChannel(core.arena, spec)
            out_mirrors[key] = mirrors

        # ---- driver-side input writers and output readers
        self._input_writers: List[Tuple] = []
        for idx in range(n_inputs):
            key = ("in", idx)
            spec = out_channels.get(key)  # None: no same-node readers
            local = self._local_channels[spec.key()] if spec else None
            mirrors = [_channels.MirrorWriter(core, m)
                       for m in out_mirrors[key]]
            self._input_writers.append((local, mirrors))

        self._output_reads: List[tuple] = []
        for out in self._outputs:
            if isinstance(out, InputNode):
                self._output_reads.append(("input", out.index))
            else:
                spec, slot = chan_of[(pkey(out), _DRIVER)]
                self._output_reads.append(
                    ("chan", self._local_channels[spec.key()], slot))
        self._need_inputs_kept = any(
            e[0] == "input" for e in self._output_reads)

        # ---- per-actor loop plans, submitted as long-running actor tasks
        by_actor: Dict[str, List[_channels.StagePlan]] = {}
        for st in stages:
            hexid = st._method._handle._actor_id.hex()

            def template(a):
                if isinstance(a, DAGNode):
                    spec, slot = chan_of[(pkey(a), id(st))]
                    return ("chan", spec, slot)
                value = a
                if getattr(a, "_object_id", None) is not None and \
                        hasattr(a, "_owner_addr"):
                    # ObjectRef constants are materialized at compile time
                    # (the steady-state loop must not resolve refs)
                    value = api.get(a)
                return ("const", value)

            by_actor.setdefault(hexid, []).append(_channels.StagePlan(
                method_name=st._method._name,
                args=[template(a) for a in st._args],
                kwargs={k: template(v) for k, v in st._kwargs.items()},
                out_channel=out_channels.get(("st", id(st))),
                out_mirrors=out_mirrors[("st", id(st))],
            ))

        from ray_tpu_torch._private.api import ObjectRef

        for hexid, plans in by_actor.items():
            info = self._actor_info[hexid]
            plan = _channels.ActorLoopPlan(
                node_addr=info["node_addr"], stages=plans)
            out = core.submit_actor_task(
                info["actor_id"], _channels.CHANNEL_LOOP_METHOD,
                (plan,), {})
            self._loop_refs.append(ObjectRef(out[0], core.address))

        # participant death -> close everything so nobody hangs
        for hexid in self._actor_info:
            core.subscribe("actor:" + hexid, self._on_actor_update)

    # -- compile-time helpers

    def _resolve_actor(self, actor_id) -> dict:
        return _channels.resolve_actor_placement(self._core, actor_id)

    def _create_channel(self, node_addr, n_readers,
                        participants) -> _channels.ChannelSpec:
        return _channels.create_channel(
            self._core, node_addr, self._buffer, self._depth, n_readers,
            participants)

    # -- failure fan-out

    def _on_actor_update(self, message) -> None:
        if self._dead or not isinstance(message, dict):
            return
        if message.get("state") in ("DEAD", "RESTARTING"):
            # runs on the core IO loop: flip local flags immediately
            # (unblocks any thread parked in read/write), fan the close
            # out to every hosting node without blocking the handler
            _channels.close_channels_nowait(
                self._core, self._local_channels.values(),
                self._all_specs)

    def _close_for_failure(self) -> None:
        """A step failed partway through its input writes: some peers
        will deliver this version while others never see it, and a
        remote mirror that committed it drops a rewrite — the step
        cannot be retried. Close the whole graph (same lightweight
        fan-out as actor death); pins still release via teardown()."""
        self._dead = True
        _channels.close_channels_nowait(
            self._core, self._local_channels.values(), self._all_specs)

    def _surface_failure(self, closed: ChannelClosedError):
        _channels.surface_loop_failure(self._core, self._loop_refs, closed)

    # -- the steady-state step path (no control-plane RPCs)

    def execute(self, input_values: tuple) -> CompiledDAGRef:
        if self._dead:
            raise ChannelClosedError("compiled DAG was torn down")
        with self._exec_lock:
            step = self._step + 1
            version = 2 * step
            wrote = False
            try:
                for idx, (local, mirrors) in \
                        enumerate(self._input_writers):
                    payload = serialization.pack(input_values[idx])
                    if local is not None:
                        local.write(payload, version)
                        wrote = True
                    for mirror in mirrors:
                        mirror.push(payload, version)
                        wrote = True
            except ChannelClosedError as e:
                self._close_for_failure()
                self._surface_failure(e)
            except BaseException:
                if wrote:
                    # some channels carry this version, others never
                    # will — a retried execute() would deliver mixed
                    # steps to consumers
                    self._close_for_failure()
                raise
            self._step = step
            if self._need_inputs_kept:
                self._inputs_by_step[step] = tuple(input_values)
            _channels._m_steps.inc()
            return CompiledDAGRef(self, step)

    def abandon(self, step: int) -> None:
        """A CompiledDAGRef died un-got: drop (or pre-mark to skip
        caching) its step's result so sample-latest callers don't
        accumulate one value per skipped step. Runs from __del__, so it
        must never block: if another thread is inside consume(), defer
        to a queue that consume() drains under the lock (an unlocked
        mutation here could race consume() between caching a result and
        advancing _consumed, stranding the value forever)."""
        if self._consume_lock.acquire(blocking=False):
            try:
                self._abandon_locked(step)
            finally:
                self._consume_lock.release()
        else:
            self._pending_abandon.append(step)

    _MISSING = object()

    def _abandon_locked(self, step: int) -> None:
        if (self._results.pop(step, self._MISSING) is self._MISSING
                and step > self._consumed):
            self._abandoned.add(step)

    def consume(self, step: int, timeout: Optional[float]) -> Any:
        if step in self._results:
            return self._results.pop(step)
        if self._dead:
            # the channel ranges may already be freed (and recycled to a
            # newer graph) — reading them would return garbage
            raise ChannelClosedError("compiled DAG was torn down")
        # one deadline spans every channel read of every pending step —
        # timeout=T must bound the whole call, not each read
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._consume_lock:
            while self._pending_abandon:
                self._abandon_locked(self._pending_abandon.popleft())
            while self._consumed < step:
                s = self._consumed + 1
                version = 2 * s
                outs: List[Any] = []
                seen_values: Dict[bytes, Any] = {}
                acks: List[tuple] = []
                try:
                    for entry in self._output_reads:
                        if entry[0] == "input":
                            outs.append(
                                self._inputs_by_step[s][entry[1]])
                            continue
                        _, ch, slot = entry
                        key = ch.spec.key()
                        if key in seen_values:
                            outs.append(seen_values[key])
                            continue
                        remaining = None if deadline is None else \
                            max(0.0, deadline - time.monotonic())
                        view = ch.read(version, remaining)
                        # copy out: the returned value outlives the ack,
                        # after which the writer may overwrite the range
                        data = bytes(view)
                        del view
                        value = serialization.unpack(data)
                        acks.append((ch, slot))
                        seen_values[key] = value
                        outs.append(value)
                except ChannelClosedError as e:
                    self._surface_failure(e)
                # ack only after EVERY output channel of this step was
                # read: an early ack lets that writer commit step s+1, and
                # a retry after a later channel's timeout would then read
                # the NEWER version as step s's value (silent wrong data)
                for ch, slot in acks:
                    ch.ack(slot, version)
                if s == step or s not in self._abandoned:
                    self._results[s] = outs if self._multi_output \
                        else outs[0]
                else:
                    # its CompiledDAGRef was GC'd un-got: consuming (to
                    # advance the channel cursor) is still required, but
                    # caching the value would grow without bound for
                    # sample-latest callers
                    self._abandoned.discard(s)
                self._inputs_by_step.pop(s, None)
                self._consumed = s
        return self._results.pop(step)

    # -- teardown

    def teardown(self) -> None:
        self._dead = True
        # only the FIRST call may touch the arena: after it releases the
        # channel ranges they can be recycled to a NEWER graph, and a
        # repeat close (e.g. __del__ firing after an explicit teardown)
        # would stamp the closed flag into that graph's live channels.
        # The lock is only ever held for this flag check — never by a
        # thread parked in execute()/consume() — so the close below still
        # runs promptly to unblock them
        with self._teardown_lock:
            if getattr(self, "_torn", False):
                return
            self._torn = True
        for ch in self._local_channels.values():
            try:
                ch.close()
            except Exception:
                pass
        core = self._core
        # drop the actor-death handlers: a driver that compiles/tears
        # down in a loop must not accumulate dead graphs in the pubsub
        # handler lists
        for hexid in self._actor_info:
            core.unsubscribe("actor:" + hexid, self._on_actor_update)

        async def close_all():
            for spec in self._all_specs:
                try:
                    await core.clients.get(tuple(spec.node_addr)).call(
                        "channel_close",
                        {"channel_id": spec.channel_id}, timeout=10)
                except Exception:
                    logger.debug("channel_close failed", exc_info=True)

        try:
            core._run(close_all(), timeout=30)
        except Exception:
            logger.debug("channel close fan-out failed", exc_info=True)
        # let the loops observe the close and exit (their pins release
        # through the standard unpin batcher)
        for ref in self._loop_refs:
            try:
                core.get([ref], timeout=10)
            except Exception:
                pass

        async def release_all():
            for spec in self._all_specs:
                client = core.clients.get(tuple(spec.node_addr))
                try:
                    # free first so the deferred free fires when the LAST
                    # pin (ours or a straggling loop's) is released
                    await client.call(
                        "store_free",
                        {"object_ids": [spec.channel_id]}, timeout=10)
                    await client.call(
                        "store_unpin",
                        {"object_id": spec.channel_id,
                         "client": core._store_client_id}, timeout=10)
                    self._m_pins.dec()
                except Exception:
                    logger.debug("channel pin release failed (reclaimed "
                                 "by the supervisor's dead-client sweep)",
                                 exc_info=True)

        try:
            core._run(release_all(), timeout=60)
        except Exception:
            logger.debug("channel release fan-out failed", exc_info=True)
        self._results.clear()
        self._inputs_by_step.clear()


from ray_tpu_torch._private.usage import record_library_usage as _rlu

_rlu("dag")
del _rlu
