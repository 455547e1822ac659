"""Client-side stand-ins for ObjectRef/ActorHandle plus the persistent-id
pickle bridge used on both ends of the client protocol.

Analog of the reference's Ray Client data layer
(`python/ray/util/client/common.py` ClientObjectRef/ClientActorHandle): refs
and handles cross the wire as persistent ids, so they survive arbitrary
nesting (containers, closures) without a deep-walk of the payload.

Counterpart: ``ray_tpu/util/client/common.py``. The pickler is the port's
serialization's: a torch tensor goes as its raw bytes, dtype and shape
(a CUDA tensor copied to the host first) and is rebuilt on the CPU, so
bf16 round-trips bit for bit and unpickling never touches a card.
"""

from __future__ import annotations

import io
import pickle
from typing import Any, Callable, Optional

from ray_tpu_torch._private.serialization import _TensorPickler


class ClientObjectRef:
    """A driver-side stub for an object living in the remote cluster.

    Holds only the object-id hex; the paired server session pins the real
    ObjectRef until this stub is garbage-collected (the context batches
    release notifications)."""

    __slots__ = ("_hex", "_ctx", "__weakref__")

    def __init__(self, hex_id: str, ctx=None):
        self._hex = hex_id
        self._ctx = ctx

    def hex(self) -> str:
        return self._hex

    def __repr__(self) -> str:
        return f"ClientObjectRef({self._hex[:16]})"

    def __eq__(self, other) -> bool:
        return isinstance(other, ClientObjectRef) and other._hex == self._hex

    def __hash__(self) -> int:
        return hash(self._hex)

    def future(self):
        import concurrent.futures

        fut: concurrent.futures.Future = concurrent.futures.Future()

        def _resolve():
            try:
                fut.set_result(self._ctx.get([self], timeout=None)[0])
            except BaseException as e:  # noqa: BLE001
                fut.set_exception(e)

        import threading

        threading.Thread(target=_resolve, daemon=True).start()
        return fut

    def __del__(self):
        ctx = self._ctx
        if ctx is not None:
            try:
                ctx._release(self._hex)
            except Exception:
                pass


class ClientActorMethod:
    __slots__ = ("_handle", "_name", "_num_returns")

    def __init__(self, handle: "ClientActorHandle", name: str,
                 num_returns: int = 1):
        self._handle = handle
        self._name = name
        self._num_returns = num_returns

    def options(self, num_returns: int = 1) -> "ClientActorMethod":
        return ClientActorMethod(self._handle, self._name, num_returns)

    def remote(self, *args, **kwargs):
        return self._handle._ctx.actor_call(
            self._handle, self._name, args, kwargs,
            num_returns=self._num_returns)

    def __call__(self, *a, **k):
        raise TypeError(
            f"actor method {self._name}() cannot be called directly; "
            f"use .remote()")


class ClientActorHandle:
    """Driver-side stub for a remote actor; methods proxy through the
    client context."""

    def __init__(self, actor_hex: str, ctx=None, class_name: str = ""):
        self._hex = actor_hex
        self._ctx = ctx
        self._class_name = class_name

    @property
    def _actor_id(self):  # parity helper for code that inspects handles
        from ray_tpu_torch._private.ids import ActorID

        return ActorID.from_hex(self._hex)

    def __getattr__(self, name: str) -> ClientActorMethod:
        if name.startswith("_"):
            raise AttributeError(name)
        return ClientActorMethod(self, name)

    def __repr__(self) -> str:
        return f"ClientActorHandle({self._class_name}, {self._hex[:16]})"


# --------------------------------------------------------------------- pickle

REF_PID = "ref"
ACTOR_PID = "actor"


class _Pickler(_TensorPickler):
    """The port's tensor-aware cloudpickle with a persistent_id hook:
    `id_for(obj)` returns a (kind, hex) tuple for refs/handles, or None to
    pickle normally."""

    def __init__(self, file, id_for: Callable[[Any], Optional[tuple]]):
        super().__init__(file, protocol=pickle.HIGHEST_PROTOCOL)
        self._id_for = id_for

    def persistent_id(self, obj):
        return self._id_for(obj)


class _Unpickler(pickle.Unpickler):
    def __init__(self, file, load_pid: Callable[[tuple], Any]):
        super().__init__(file)
        self._load_pid = load_pid

    def persistent_load(self, pid):
        return self._load_pid(pid)


def dumps_with_ids(obj: Any, id_for: Callable[[Any], Optional[tuple]]) -> bytes:
    buf = io.BytesIO()
    _Pickler(buf, id_for).dump(obj)
    return buf.getvalue()


def loads_with_ids(blob: bytes, load_pid: Callable[[tuple], Any]) -> Any:
    return _Unpickler(io.BytesIO(blob), load_pid).load()
