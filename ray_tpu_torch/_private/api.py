"""Public user API: init / remote / get / put / wait / actors.

Analog of the reference's Ray Core Python surface
(`python/ray/_private/worker.py:1214,2537,2655,2720,3113`,
`python/ray/remote_function.py:266`, `python/ray/actor.py:854,1364`).
"""

from __future__ import annotations

import functools
import hashlib
import inspect
import logging
import os
import threading
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

from ray_tpu_torch._private import serialization
from ray_tpu_torch._private.config import Config
from ray_tpu_torch._private.core_worker import CoreWorker
from ray_tpu_torch._private.ids import ActorID, JobID, ObjectID
from ray_tpu_torch._private.task_spec import (
    NodeAffinityStrategy,
    SchedulingStrategy,
    SpreadStrategy,
)

logger = logging.getLogger(__name__)

_global_lock = threading.RLock()
_core: Optional[CoreWorker] = None
_node_handle = None  # local cluster bootstrap (driver-started head)
_namespace = "default"


# --------------------------------------------------------------------- refs


class ObjectRef:
    """A future for a task return or put object (≈ ray.ObjectRef)."""

    __slots__ = ("_object_id", "_owner_addr", "_skip_rc", "__weakref__")

    def __init__(
        self,
        object_id: ObjectID,
        owner_addr: Tuple[str, int],
        skip_ref_counting: bool = False,
    ):
        self._object_id = object_id
        self._owner_addr = tuple(owner_addr)
        self._skip_rc = skip_ref_counting
        if not skip_ref_counting and _core is not None:
            _core.add_local_ref(object_id, self._owner_addr)

    def hex(self) -> str:
        return self._object_id.hex()

    def __repr__(self) -> str:
        return f"ObjectRef({self._object_id.hex()[:16]})"

    def __eq__(self, other) -> bool:
        return isinstance(other, ObjectRef) and other._object_id == self._object_id

    def __hash__(self) -> int:
        return hash(self._object_id)

    def __del__(self):
        if not self._skip_rc and _core is not None:
            try:
                _core.remove_local_ref(self._object_id, self._owner_addr)
            except Exception:
                pass

    def __reduce__(self):
        return (_deserialize_ref, (self._object_id.binary(), self._owner_addr))

    def __await__(self):
        """Awaitable inside async actors / asyncio code (ray parity:
        ObjectRefs are awaitable)."""
        import asyncio

        return asyncio.wrap_future(self.future()).__await__()

    def future(self):
        """concurrent.futures.Future resolving to the value.

        Driven by the core worker's own event loop (no per-ref helper
        thread: N awaited refs cost zero extra threads, and cancelling the
        future cancels the underlying coroutine instead of stranding a
        blocked thread)."""
        import asyncio

        core = _require_core()
        return asyncio.run_coroutine_threadsafe(
            core._async_get_one(self._object_id, self._owner_addr, None),
            core.loop,
        )


class ObjectRefGenerator:
    """Iterator over a streaming generator task's yielded items
    (≈ ray.ObjectRefGenerator, `python/ray/_raylet.pyx:273`). Each
    ``next()`` blocks until the executor reports the next item and yields
    an ordinary ObjectRef (pass it to get/wait/tasks as usual). Iteration
    raises the task's error after the last successfully yielded item, and
    StopIteration at exhaustion. Usable from async code via ``async for``.

    Not serializable: the stream state lives in the owner process (the
    reference has the same restriction for the plain generator type)."""

    def __init__(self, task_id, owner_addr):
        self._task_id = task_id
        self._owner_addr = tuple(owner_addr)
        self._cursor = 0
        self._released = False

    def __iter__(self):
        return self

    def __next__(self) -> ObjectRef:
        return self._next(timeout=None)

    def _next(self, timeout: Optional[float] = None) -> ObjectRef:
        core = _require_core()
        oid = core.stream_next(self._task_id, self._cursor, timeout)
        self._cursor += 1
        return ObjectRef(oid, self._owner_addr)

    next = _next  # explicit-timeout spelling: gen.next(timeout=...)

    def __aiter__(self):
        return self

    async def __anext__(self) -> ObjectRef:
        from ray_tpu_torch._private.async_utils import END_OF_ITERATION, step_off_loop

        out = await step_off_loop(self.__next__)
        if out is END_OF_ITERATION:
            raise StopAsyncIteration
        return out

    def completed(self) -> bool:
        core = _require_core()
        stream = core._streams.get(self._task_id)
        return stream is None or (stream.finished
                                  and self._cursor >= len(stream.items))

    def task_id(self):
        return self._task_id

    def __reduce__(self):
        raise TypeError("ObjectRefGenerator is not serializable; consume it "
                        "in the owner process and pass the yielded "
                        "ObjectRefs instead")

    def __del__(self):
        if not self._released and _core is not None:
            try:
                _core.stream_released(self._task_id)
            except Exception:
                pass
            self._released = True


def _deserialize_ref(raw: bytes, owner) -> ObjectRef:
    ref = ObjectRef(ObjectID(raw), tuple(owner))
    # register as borrower with the owner (best-effort distributed refcount)
    if _core is not None and tuple(owner) != tuple(_core.address or ()):
        try:
            import asyncio

            asyncio.run_coroutine_threadsafe(
                _core.clients.get(tuple(owner)).notify(
                    "add_borrow", {"object_id": raw}
                ),
                _core.loop,
            )
        except Exception:
            pass
    return ref


# --------------------------------------------------------------------- init


def init(
    address: Optional[str] = None,
    *,
    num_cpus: Optional[float] = None,
    num_gpus: Optional[int] = None,
    resources: Optional[Dict[str, float]] = None,
    object_store_memory: Optional[int] = None,
    namespace: str = "default",
    log_to_driver: bool = True,
    _system_config: Optional[Dict[str, Any]] = None,
    ignore_reinit_error: bool = False,
) -> Dict[str, Any]:
    """Connect to (or start) a cluster. ≈ ray.init (worker.py:1214).

    A local cluster counts its GPUs from ``CUDA_VISIBLE_DEVICES`` or
    ``nvidia-smi -L`` unless ``num_gpus`` says otherwise; its session
    lives under ``<tmp>/ray_tpu_torch`` and every environment variable it
    reads or sets starts with ``RAY_TPU_TORCH_``."""
    global _core, _node_handle, _namespace
    with _global_lock:
        if _core is not None:
            if ignore_reinit_error:
                return {"address": f"{_core.controller_addr[0]}:{_core.controller_addr[1]}"}
            raise RuntimeError("ray_tpu_torch.init() called twice; use shutdown() first")
        if address and address.startswith("client://"):
            raise NotImplementedError(
                "client mode (client:// addresses) is not ported yet "
                "(ROADMAP A8, moved from A4)")
        config = Config.from_env(_system_config)
        if object_store_memory:
            config.object_store_memory_bytes = object_store_memory
        _namespace = namespace

        if address in (None, "local"):
            from ray_tpu_torch._private.node import NodeHandle

            _node_handle = NodeHandle.start_head(
                config,
                num_cpus=num_cpus,
                num_gpus=num_gpus,
                resources=resources,
            )
            controller_addr = _node_handle.controller_addr
            supervisor_addr = _node_handle.supervisor_addr
        else:
            if address == "auto":
                address = os.environ.get("RAY_TPU_TORCH_ADDRESS", "")
                if not address:
                    raise ConnectionError("address='auto' but RAY_TPU_TORCH_ADDRESS unset")
            host, port = address.rsplit(":", 1)
            controller_addr = (host, int(port))
            supervisor_addr = _find_local_supervisor(config, controller_addr)

        core = CoreWorker(
            config,
            controller_addr,
            supervisor_addr,
            _new_job_id(controller_addr),
            role="driver",
        )
        core.start()
        _core = core
        core._run(
            core.clients.get(controller_addr).call(
                "job_register",
                {"job_id_hex": core.job_id.hex(), "driver_address": core.address},
            )
        )
        if log_to_driver:
            # worker stdout/stderr stream to this process (supervisors
            # tail the files and publish; ≈ the reference's log monitor)
            my_job_hex = core.job_id.hex()

            def _print_worker_logs(msg):
                import sys as _sys

                # only THIS driver's workers (messages carry the job that
                # spawned the worker; untagged = pre-tagging pooled worker)
                job = msg.get("job_id_hex", "")
                if job and job != my_job_hex:
                    return
                stream = (_sys.stderr if msg.get("stream") == "stderr"
                          else _sys.stdout)
                tag = f"({msg.get('node', '?')} pid={msg.get('pid', '?')})"
                for line in msg.get("lines", []):
                    print(f"{tag} {line}", file=stream)

            core.subscribe("worker_logs", _print_worker_logs)
        session_dir = getattr(_node_handle, "session_dir", "")
        if session_dir:
            os.environ["RAY_TPU_TORCH_SESSION_DIR"] = session_dir
        return {
            "address": f"{controller_addr[0]}:{controller_addr[1]}",
            "node_id": core.node_id_hex,
            "session_dir": session_dir,
        }


def _new_job_id(controller_addr) -> JobID:
    """Controller-issued job number (cluster-unique across drivers)."""
    import asyncio

    from ray_tpu_torch._private.config import global_config
    from ray_tpu_torch._private.rpc import RpcClient, retry_call

    async def ask():
        client = RpcClient(controller_addr)
        try:
            # job_new is replay-cached server-side, so retrying across a
            # controller hiccup can never mint two numbers for this driver
            return await retry_call(
                client, "job_new", timeout=30, per_call_timeout=10,
                base_interval_s=global_config().rpc_retry_interval_ms / 1000.0)
        finally:
            await client.close()

    return JobID.from_int(asyncio.run(ask()))


def _find_local_supervisor(config, controller_addr):
    import asyncio

    from ray_tpu_torch._private.rpc import RpcClient

    async def find():
        client = RpcClient(controller_addr)
        try:
            views = await client.call("node_views")
        finally:
            await client.close()
        alive = [v for v in views if v["alive"]]
        if not alive:
            return None
        # prefer a supervisor on this host
        import socket

        local_names = {"127.0.0.1", "localhost", socket.gethostname()}
        try:
            local_names.add(socket.gethostbyname(socket.gethostname()))
        except OSError:
            pass
        for v in alive:
            if v["address"][0] in local_names:
                return tuple(v["address"])
        return tuple(alive[0]["address"])

    return asyncio.run(find())


def _connect_existing(core: CoreWorker) -> None:
    """Install an already-started CoreWorker as this process's runtime
    (used by worker processes)."""
    global _core
    _core = core


def shutdown() -> None:
    global _core, _node_handle
    with _global_lock:
        if _node_handle is not None:
            # local usage report (usage.py; collector POST is opt-in)
            try:
                from ray_tpu_torch._private import usage

                usage.write_report(_node_handle.session_dir)
            except Exception:
                pass
        if _core is not None:
            try:
                _core._run(
                    _core.clients.get(_core.controller_addr).call(
                        "job_finish", {"job_id_hex": _core.job_id.hex()}, timeout=2
                    ),
                    timeout=3,
                )
            except Exception:
                pass
            _core.shutdown()
            _core = None
        if _node_handle is not None:
            _node_handle.stop()
            _node_handle = None


def is_initialized() -> bool:
    return _core is not None


def _require_core() -> CoreWorker:
    if _core is None:
        init()
    return _core


# --------------------------------------------------------------------- core ops


def put(value: Any) -> ObjectRef:
    core = _require_core()
    oid, owner = core.put(value)
    return ObjectRef(oid, owner)


def get(
    refs: Union[ObjectRef, Sequence[ObjectRef]], *, timeout: Optional[float] = None
) -> Any:
    if getattr(refs, "_is_compiled_dag_ref", False):
        # compiled-graph step: resolves by reading the output channel(s)
        # directly — no object layer, no RPCs (ray.get parity for
        # CompiledDAGRef)
        return refs.get(timeout=timeout)
    core = _require_core()
    single = isinstance(refs, ObjectRef)
    batch = [refs] if single else list(refs)
    for r in batch:
        if not isinstance(r, ObjectRef) and \
                not getattr(r, "_is_compiled_dag_ref", False):
            raise TypeError(f"get() expects ObjectRef(s), got {type(r).__name__}")
    if not single and any(
            getattr(r, "_is_compiled_dag_ref", False) for r in batch):
        # a list mixing compiled-graph steps with ordinary refs: batch
        # the ObjectRefs through the object layer, read the compiled
        # steps from their channels, preserve order. One deadline covers
        # every resolve — not timeout-per-item
        import time as _time

        deadline = None if timeout is None \
            else _time.monotonic() + timeout

        def remaining() -> Optional[float]:
            return None if deadline is None \
                else max(0.001, deadline - _time.monotonic())

        obj_idx = [i for i, r in enumerate(batch)
                   if isinstance(r, ObjectRef)]
        obj_vals = core.get([batch[i] for i in obj_idx],
                            timeout=remaining()) if obj_idx else []
        out: list = [None] * len(batch)
        for i, v in zip(obj_idx, obj_vals):
            out[i] = v
        for i, r in enumerate(batch):
            if not isinstance(r, ObjectRef):
                out[i] = r.get(timeout=remaining())
        return out
    values = core.get(batch, timeout=timeout)
    return values[0] if single else values


def wait(
    refs: Sequence[ObjectRef],
    *,
    num_returns: int = 1,
    timeout: Optional[float] = None,
) -> Tuple[List[ObjectRef], List[ObjectRef]]:
    if num_returns > len(refs):
        raise ValueError("num_returns exceeds the number of refs")
    core = _require_core()
    return core.wait(list(refs), num_returns=num_returns, timeout=timeout)


def kill(actor: "ActorHandle", *, no_restart: bool = True) -> None:
    _require_core().kill_actor(actor._actor_id, no_restart=no_restart)


def cancel(ref, *, force: bool = False) -> None:
    """Best-effort cancellation of a queued task (ObjectRef or
    ObjectRefGenerator — cancelling a generator stops the stream between
    yields; items already yielded stay consumable)."""
    core = _require_core()
    if isinstance(ref, ObjectRefGenerator):
        task_id = ref._task_id
    else:
        task_id = ref._object_id.task_id()
    task = core._inflight_tasks.get(task_id)
    if task is None:
        return
    addr = None
    if task.lease is not None:
        addr = task.lease.worker_addr
    elif task.spec.actor_id is not None:
        # actor tasks ride the handle's push channel, not a lease
        state = core._actor_states.get(task.spec.actor_id.hex())
        addr = state.address if state is not None else None
    if addr is not None:
        import asyncio

        asyncio.run_coroutine_threadsafe(
            core.clients.get(tuple(addr)).call(
                "cancel", {"task_id": task_id.binary()}
            ),
            core.loop,
        )


def nodes() -> List[Dict[str, Any]]:
    core = _require_core()
    return core._run(core.clients.get(core.controller_addr).call("node_views"))


def cluster_resources() -> Dict[str, float]:
    core = _require_core()
    status = core._run(core.clients.get(core.controller_addr).call("cluster_status"))
    return status["total_resources"]


def available_resources() -> Dict[str, float]:
    core = _require_core()
    status = core._run(core.clients.get(core.controller_addr).call("cluster_status"))
    return status["available_resources"]


class RuntimeContext:
    def __init__(self, core: CoreWorker):
        self._core = core

    @property
    def job_id(self) -> str:
        return self._core.job_id.hex()

    @property
    def node_id(self) -> str:
        return self._core.node_id_hex

    @property
    def worker_id(self) -> str:
        return self._core.worker_id.hex()

    @property
    def actor_id(self) -> Optional[str]:
        return self._core.actor_id.hex() if self._core.actor_id else None

    def get_gpu_ids(self) -> List[str]:
        """The cards this worker was given (its CUDA_VISIBLE_DEVICES)."""
        raw = os.environ.get("CUDA_VISIBLE_DEVICES", "")
        return [c.strip() for c in raw.split(",") if c.strip()]

    # getter-style aliases matching the reference's RuntimeContext
    # (`python/ray/runtime_context.py` get_node_id/get_job_id/...)
    def get_node_id(self) -> str:
        return self.node_id

    def get_job_id(self) -> str:
        return self.job_id

    def get_worker_id(self) -> str:
        return self.worker_id

    def get_actor_id(self) -> Optional[str]:
        return self.actor_id


def get_runtime_context() -> RuntimeContext:
    return RuntimeContext(_require_core())


# --------------------------------------------------------------------- remote


class RemoteFunction:
    """≈ ray.remote_function.RemoteFunction (remote_function.py:40)."""

    def __init__(self, fn, options: Dict[str, Any]):
        self._fn = fn
        self._options = options
        self._blob: Optional[bytes] = None
        self._key: Optional[str] = None
        functools.update_wrapper(self, fn)

    def _materialize(self):
        if self._key is None:
            self._blob = serialization.dumps(self._fn)
            self._key = hashlib.sha256(self._blob).hexdigest()
        return self._key, self._blob

    def options(self, **overrides) -> "RemoteFunction":
        new = dict(self._options)
        new.update(overrides)
        rf = RemoteFunction(self._fn, new)
        rf._key, rf._blob = self._key, self._blob
        return rf

    def remote(self, *args, **kwargs):
        core = _require_core()
        opts = self._options
        key, blob = self._materialize()
        resources = _resources_from_options(opts)
        num_returns = _norm_num_returns(opts.get("num_returns", 1))
        out = core.submit_task(
            None,
            args,
            kwargs,
            name=opts.get("name") or self._fn.__qualname__,
            num_returns=num_returns,
            resources=resources,
            strategy=_strategy_from_options(opts),
            max_retries=opts.get("max_retries", -1),
            retry_exceptions=bool(opts.get("retry_exceptions", False)),
            runtime_env=_resolve_runtime_env(opts.get("runtime_env"), core),
            function_key=key,
            function_blob=blob,
            backpressure=_backpressure_from_options(opts),
        )
        if num_returns < 0:
            return ObjectRefGenerator(out, core.address)
        refs = [ObjectRef(oid, core.address) for oid in out]
        return refs[0] if num_returns == 1 else refs

    def bind(self, *args, **kwargs):
        """A lazy DAG node (ray.dag analog): not ported yet."""
        raise NotImplementedError(
            "the DAG API (.bind) is not ported yet "
            "(ROADMAP A8, moved from A4)")

    def __call__(self, *args, **kwargs):
        raise TypeError(
            f"remote function {self._fn.__name__}() cannot be called directly; "
            f"use .remote()"
        )


def _resolve_runtime_env(env, core):
    """Package local working_dir/py_modules paths into content-addressed
    URIs uploaded to the cluster KV (see _private/runtime_env.py)."""
    if not env:
        return env
    from ray_tpu_torch._private.runtime_env import resolve_runtime_env

    return resolve_runtime_env(env, core)


def _norm_num_returns(v) -> int:
    """"streaming"/"dynamic" -> -1 (generator task); ints pass through."""
    if v in ("streaming", "dynamic"):
        return -1
    return int(v)


def _backpressure_from_options(opts: Dict[str, Any]) -> int:
    """Generator backpressure window; accepts our name and the
    reference's `_generator_backpressure_num_objects`."""
    v = opts.get("generator_backpressure",
                 opts.get("_generator_backpressure_num_objects", 0))
    return max(0, int(v or 0))


def _resources_from_options(opts: Dict[str, Any]) -> Optional[Dict[str, float]]:
    """None = unspecified (framework default); explicit zeros are preserved."""
    specified = False
    resources: Dict[str, float] = {}
    if opts.get("resources") is not None:
        resources.update({k: float(v) for k, v in opts["resources"].items()})
        specified = True
    if opts.get("num_cpus") is not None:
        resources["CPU"] = float(opts["num_cpus"])
        specified = True
    if opts.get("num_gpus") is not None:
        n = float(opts["num_gpus"])
        if n != int(n) or n < 0:
            # a worker's cards are fixed in CUDA_VISIBLE_DEVICES at spawn
            raise ValueError(
                f"num_gpus={opts['num_gpus']!r}: only whole GPUs can be "
                "assigned")
        resources["GPU"] = n
        specified = True
    if opts.get("memory") is not None:
        resources["memory"] = float(opts["memory"])
        specified = True
    return resources if specified else None


def _strategy_from_options(opts: Dict[str, Any]) -> SchedulingStrategy:
    strat = opts.get("scheduling_strategy")
    if isinstance(strat, SchedulingStrategy):
        return strat
    if strat == "SPREAD":
        return SpreadStrategy()
    if strat == "RANDOM":
        from ray_tpu_torch._private.task_spec import RandomStrategy

        return RandomStrategy()
    if isinstance(strat, str) and strat not in ("DEFAULT", ""):
        raise ValueError(
            f"unknown scheduling_strategy string {strat!r}; use 'SPREAD', "
            "'RANDOM', 'DEFAULT', or a strategy object from "
            "ray_tpu_torch._private.task_spec")
    if opts.get("placement_group") is not None:
        raise NotImplementedError(
            "placement groups are not ported yet (ROADMAP A8)")
    return SchedulingStrategy()


class ActorMethod:
    def __init__(self, handle: "ActorHandle", name: str, num_returns=1,
                 backpressure: int = 0):
        self._handle = handle
        self._name = name
        self._num_returns = _norm_num_returns(num_returns)
        self._backpressure = backpressure

    def options(self, num_returns=None, **kw) -> "ActorMethod":
        # unspecified fields inherit the current values so chained
        # .options(num_returns="streaming").options(backpressure=2)
        # composes (mirrors DeploymentHandle.options)
        return ActorMethod(
            self._handle, self._name,
            self._num_returns if num_returns is None else num_returns,
            backpressure=(_backpressure_from_options(kw)
                          if ("generator_backpressure" in kw or
                              "_generator_backpressure_num_objects" in kw)
                          else self._backpressure))

    def bind(self, *args, **kwargs):
        """A lazy DAG node for this actor method: not ported yet."""
        raise NotImplementedError(
            "the DAG API (.bind) is not ported yet "
            "(ROADMAP A8, moved from A4)")

    def remote(self, *args, **kwargs):
        core = _require_core()
        out = core.submit_actor_task(
            self._handle._actor_id,
            self._name,
            args,
            kwargs,
            num_returns=self._num_returns,
            max_task_retries=self._handle._max_task_retries,
            backpressure=self._backpressure,
        )
        if self._num_returns < 0:
            return ObjectRefGenerator(out, core.address)
        refs = [ObjectRef(oid, core.address) for oid in out]
        return refs[0] if self._num_returns == 1 else refs

    def __call__(self, *a, **k):
        raise TypeError(f"actor method {self._name}() must be invoked via .remote()")


class ActorHandle:
    """≈ ray.actor.ActorHandle (actor.py:1226)."""

    def __init__(self, actor_id: ActorID, max_task_retries: int = 0, class_name: str = ""):
        self._actor_id = actor_id
        self._max_task_retries = max_task_retries
        self._class_name = class_name

    def __getattr__(self, name: str) -> ActorMethod:
        if name.startswith("_"):
            raise AttributeError(name)
        return ActorMethod(self, name)

    def __repr__(self) -> str:
        return f"ActorHandle({self._class_name}, {self._actor_id.hex()[:12]})"

    def __reduce__(self):
        return (
            ActorHandle,
            (self._actor_id, self._max_task_retries, self._class_name),
        )


class ActorClass:
    """≈ ray.actor.ActorClass (actor.py:566)."""

    def __init__(self, cls, options: Dict[str, Any]):
        self._cls = cls
        self._options = options

    def options(self, **overrides) -> "ActorClass":
        new = dict(self._options)
        new.update(overrides)
        return ActorClass(self._cls, new)

    def remote(self, *args, **kwargs) -> ActorHandle:
        core = _require_core()
        opts = self._options
        resources = _resources_from_options(opts)
        is_async = any(
            inspect.iscoroutinefunction(m) or inspect.isasyncgenfunction(m)
            for _, m in inspect.getmembers(self._cls, inspect.isfunction)
        )
        actor_id, _ = core.create_actor(
            self._cls,
            args,
            kwargs,
            name=opts.get("name", ""),
            namespace=opts.get("namespace", _namespace),
            resources=resources,
            strategy=_strategy_from_options(opts),
            max_restarts=opts.get("max_restarts", 0),
            max_task_retries=opts.get("max_task_retries", 0),
            max_concurrency=opts.get("max_concurrency", 1),
            is_async=is_async,
            runtime_env=_resolve_runtime_env(opts.get("runtime_env"), core),
            detached=opts.get("lifetime") == "detached",
            class_name=self._cls.__name__,
        )
        return ActorHandle(
            actor_id,
            max_task_retries=opts.get("max_task_retries", 0),
            class_name=self._cls.__name__,
        )

    def __call__(self, *a, **k):
        raise TypeError(
            f"actor class {self._cls.__name__} must be instantiated via .remote()"
        )


def remote(*args, **kwargs):
    """``@remote`` / ``@remote(num_cpus=..., num_gpus=..., ...)``
    ≈ ray.remote (worker.py:3113)."""

    def decorate(target):
        if inspect.isclass(target):
            return ActorClass(target, kwargs)
        return RemoteFunction(target, kwargs)

    if len(args) == 1 and callable(args[0]) and not kwargs:
        return decorate(args[0])
    if args:
        raise TypeError("@remote takes keyword options only")
    return decorate


def method(**opts):
    """Per-method options decorator (num_returns), ≈ ray.method."""

    def wrap(fn):
        fn._method_options = opts
        return fn

    return wrap


def get_actor(name: str, namespace: Optional[str] = None) -> ActorHandle:
    core = _require_core()
    rec = core._run(
        core.clients.get(core.controller_addr).call(
            "actor_by_name",
            {"name": name, "namespace": namespace or _namespace},
        )
    )
    if rec is None or rec["state"] == "DEAD":
        raise ValueError(f"actor {name!r} not found in namespace {namespace or _namespace!r}")
    return ActorHandle(
        ActorID.from_hex(rec["actor_id_hex"]), class_name=rec.get("class_name", "")
    )
