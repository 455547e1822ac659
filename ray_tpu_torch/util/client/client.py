"""Client context: drives a remote cluster through a client server.

Analog of the reference's Ray Client data client
(`python/ray/util/client/dataclient.py` + `worker.py`): a background event
loop owns one RpcClient; the public methods are synchronous and mirror the
driver API surface (`put/get/wait/remote/actor/...`). Installed into
`ray_tpu_torch._private.api` as the module-level backend when
``ray_tpu_torch.init(address="client://host:port")`` is used.

Counterpart: ``ray_tpu/util/client/client.py``.
"""

from __future__ import annotations

import asyncio
import threading
import uuid
from typing import Any, Dict, List, Optional, Sequence

from ray_tpu_torch.util.client.common import (ACTOR_PID, REF_PID, ClientActorHandle,
                                        ClientObjectRef, dumps_with_ids,
                                        loads_with_ids)


class ClientContext:
    def __init__(self, address: str, *, namespace: str = "default",
                 request_timeout_s: float = 300.0):
        self._address = address
        self._namespace = namespace
        self._session = uuid.uuid4().hex
        self._dead_refs: List[str] = []
        self._dead_lock = threading.Lock()
        self._loop = asyncio.new_event_loop()
        self._thread = threading.Thread(
            target=self._loop.run_forever, name="client-io", daemon=True)
        self._thread.start()
        try:
            self._client = self._run(self._make_client(request_timeout_s))
            info = self._call("cl_ping", {"namespace": namespace})
        except BaseException:
            # connection failed: don't leak the io thread/loop
            self._loop.call_soon_threadsafe(self._loop.stop)
            self._thread.join(timeout=2)
            raise
        self._server_namespace = info.get("namespace", namespace)

    async def _make_client(self, request_timeout_s):
        from ray_tpu_torch._private.rpc import RpcClient

        return RpcClient(self._address, request_timeout_s=request_timeout_s)

    # ----------------------------------------------------------------- plumbing

    def _run(self, coro, timeout=None):
        return asyncio.run_coroutine_threadsafe(
            coro, self._loop).result(timeout)

    def _call(self, method: str, body: Dict[str, Any],
              timeout: Optional[float] = None) -> Any:
        body = dict(body)
        body["session"] = self._session
        body.setdefault("namespace", self._namespace)
        with self._dead_lock:
            rel, self._dead_refs = self._dead_refs, []
        if rel:
            self._run(self._client.notify(
                "cl_release", {"session": self._session, "refs": rel}))
        reply = self._run(self._client.call(method, body, timeout=timeout))
        if isinstance(reply, dict) and "exc" in reply:
            raise self._loads(reply["exc"])
        if isinstance(reply, dict) and "ok" in reply:
            return self._loads(reply["ok"])
        return reply

    def _release(self, hex_id: str) -> None:
        with self._dead_lock:
            self._dead_refs.append(hex_id)

    def _id_for(self, obj):
        if isinstance(obj, ClientObjectRef):
            return (REF_PID, obj._hex)
        if isinstance(obj, ClientActorHandle):
            return (ACTOR_PID, obj._hex)
        return None

    def _load_pid(self, pid):
        kind, hex_id = pid[0], pid[1]
        if kind == REF_PID:
            return ClientObjectRef(hex_id, self)
        if kind == ACTOR_PID:
            cls_name = pid[2] if len(pid) > 2 else ""
            return ClientActorHandle(hex_id, self, class_name=cls_name)
        raise ValueError(f"unknown persistent id {pid!r}")

    def _dumps(self, obj) -> bytes:
        return dumps_with_ids(obj, self._id_for)

    def _loads(self, blob: bytes):
        return loads_with_ids(blob, self._load_pid)

    # ------------------------------------------------------------------- api

    def put(self, value: Any) -> ClientObjectRef:
        return self._call("cl_put", {"value": self._dumps(value)})

    # timeout=None on get/wait means block-forever (driver semantics): use an
    # effectively-unbounded wire timeout so the RPC layer's default request
    # timeout can't fire first.
    _FOREVER = 10 * 365 * 24 * 3600.0

    def get(self, refs, *, timeout: Optional[float] = None):
        wire_timeout = self._FOREVER if timeout is None else timeout + 30
        return self._call("cl_get",
                          {"refs": self._dumps(refs), "timeout": timeout},
                          timeout=wire_timeout)

    def wait(self, refs: Sequence[ClientObjectRef], *, num_returns: int = 1,
             timeout: Optional[float] = None):
        wire_timeout = self._FOREVER if timeout is None else timeout + 30
        return self._call(
            "cl_wait",
            {"refs": self._dumps(list(refs)), "num_returns": num_returns,
             "timeout": timeout},
            timeout=wire_timeout)

    def submit_task(self, fn_blob: bytes, fn_name: str, args, kwargs,
                    opts: Dict[str, Any]):
        return self._call("cl_task", {
            "fn": fn_blob, "fn_name": fn_name,
            "args": self._dumps((args, kwargs)),
            "opts": _wire_opts(opts),
        })

    def create_actor(self, cls, args, kwargs, opts: Dict[str, Any]):
        return self._call("cl_actor", {
            "cls": self._dumps(cls),
            "args": self._dumps((args, kwargs)),
            "opts": _wire_opts(opts),
        })

    def actor_call(self, handle: ClientActorHandle, method: str, args, kwargs,
                   *, num_returns: int = 1):
        return self._call("cl_actor_call", {
            "actor": handle._hex, "method": method,
            "args": self._dumps((args, kwargs)),
            "num_returns": num_returns,
        })

    def get_actor(self, name: str, namespace: Optional[str] = None):
        return self._call("cl_named_actor",
                          {"name": name, "namespace": namespace})

    def kill(self, handle: ClientActorHandle, *, no_restart: bool = True):
        self._call("cl_kill", {"actor": handle._hex, "no_restart": no_restart})

    def cancel(self, ref: ClientObjectRef, *, force: bool = False):
        self._call("cl_cancel", {"ref": ref._hex, "force": force})

    def nodes(self):
        return self._call("cl_query", {"kind": "nodes"})

    def cluster_resources(self):
        return self._call("cl_query", {"kind": "cluster_resources"})

    def available_resources(self):
        return self._call("cl_query", {"kind": "available_resources"})

    def disconnect(self):
        try:
            self._call("cl_disconnect", {})
        except Exception:
            pass
        try:
            self._run(self._client.close())
        except Exception:
            pass
        self._loop.call_soon_threadsafe(self._loop.stop)
        self._thread.join(timeout=2)


def _wire_opts(opts: Dict[str, Any]) -> Dict[str, Any]:
    """Only plain-data options cross the wire."""
    out = {}
    for k, v in (opts or {}).items():
        if isinstance(v, (str, int, float, bool, type(None), dict, list, tuple)):
            out[k] = v
    return out
